"""Fused ops: the lowering targets of the transform tier's pattern fusion
(``transform/fusion.py``).

The counterpart of ``paddle_tpu/ops/fused.py``. Each fused op replays its
component ops' registered lowerings in sequence, through synthetic
Operator nodes that share the run's env, so it computes exactly what the
unfused chain computes: the same torch calls on the same tensors, in the
same order, with the same autograd graph. Bitwise identity with the
unfused chain, gradients included, holds by construction; a fused
kernel would break it, so none is used. The Executor sees one op: one
profiler range, one NaN-guard record, one LoD propagation.

Ops:
  fused_matmul_bias_act   anchor (mul/matmul/conv2d/depthwise_conv2d)
                          + elementwise_add bias + optional activation.
                          Inputs X/Y/Bias, output Out; attrs ``mm_type``
                          / ``mm_attrs`` / ``add_attrs`` / ``act_type``
                          / ``act_attrs`` carry the component ops.
  fused_scale_cast        a two-op scale/cast chain; attr ``ops`` =
                          [[type, attrs], [type, attrs]] applied in
                          order.
"""

from ..core.program import Operator
from ..core.registry import lookup, register

# anchor op type -> (lhs slot, rhs slot, output slot). The rhs slot is
# where a weight parameter lives (models/transformer_infer.extract_params
# reads fused ops through this table too).
FUSABLE_ANCHORS = {
    "mul": ("X", "Y", "Out"),
    "matmul": ("X", "Y", "Out"),
    "conv2d": ("Input", "Filter", "Output"),
    "depthwise_conv2d": ("Input", "Filter", "Output"),
}


def fusable_act_types():
    """Single-input pure activation op types a chain may end in: the
    unary activation table plus the softmax head fc() appends."""
    from .activations import _SIMPLE
    return frozenset(_SIMPLE) | {"softmax", "log_softmax"}


def _run_component(ctx, block, op_type, inputs, outputs, attrs):
    """Lower one component op through its registered rule. The synthetic
    Operator shares the fused op's block (some lowerings consult block
    metadata) but is never appended to it."""
    info = lookup(op_type)
    if info is None:
        raise NotImplementedError(
            "fused op delegates to unregistered op %r" % (op_type,))
    syn = Operator(block, op_type, inputs, outputs, dict(attrs or {}))
    info.lower(ctx, syn)


@register("fused_matmul_bias_act")
def _fused_matmul_bias_act(ctx, op):
    mm_type = op.attr("mm_type", "mul")
    lhs_slot, rhs_slot, out_slot = FUSABLE_ANCHORS[mm_type]
    out = ctx.out_name(op, "Out")
    t_mm, t_add = out + "@fused:mm", out + "@fused:add"
    blk = op.block
    _run_component(
        ctx, blk, mm_type,
        {lhs_slot: op.input("X"), rhs_slot: op.input("Y")},
        {out_slot: [t_mm]}, op.attr("mm_attrs"))
    _run_component(
        ctx, blk, "elementwise_add",
        {"X": [t_mm], "Y": op.input("Bias")},
        {"Out": [t_add]}, op.attr("add_attrs"))
    act = op.attr("act_type") or None
    if act:
        _run_component(ctx, blk, act, {"X": [t_add]}, {"Out": [out]},
                       op.attr("act_attrs"))
    else:
        ctx.env[out] = ctx.env[t_add]
    # the temps are the op's own: drop them so the env (and anything
    # that sweeps it: constant folding's declared-output check, the
    # state the step returns) sees only the declared output
    ctx.env.pop(t_mm, None)
    ctx.env.pop(t_add, None)


@register("fused_scale_cast")
def _fused_scale_cast(ctx, op):
    chain = op.attr("ops") or []
    out = ctx.out_name(op, "Out")
    blk = op.block
    src = op.input("X")
    temps = []
    for i, (op_type, attrs) in enumerate(chain):
        dst = out if i == len(chain) - 1 else "%s@fused:%d" % (out, i)
        _run_component(ctx, blk, op_type, {"X": src}, {"Out": [dst]},
                       attrs)
        if dst != out:
            temps.append(dst)
        src = [dst]
    for t in temps:
        ctx.env.pop(t, None)


FUSED_OP_TYPES = ("fused_matmul_bias_act", "fused_scale_cast")
