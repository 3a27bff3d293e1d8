"""Control-flow ops: recurrent, while, conditional_block,
select_rows_by_mask, the tensor arrays, shrink_rnn_memory,
max_sequence_len, lod_rank_table and recompute_block.

The counterpart of ``paddle_tpu/ops/control_flow.py``. The JAX package
traces a sub-block into a step function driven by ``lax.scan``,
``lax.while_loop`` or ``lax.cond``; the port runs the sub-block's
lowerings eagerly:

  * ``recurrent`` (StaticRNN, DynamicRNN) loops over the time axis in
    Python, the carry masked by ``sequence_length`` with ``torch.where``
    on the device (a finished sequence keeps its last state and writes
    zeros), so a CUDA graph holds it and autograd differentiates it;
  * ``while`` and ``conditional_block`` read their condition on the host
    each time, so they run in ``Executor.run`` only: inside a
    ``run_steps`` capture they raise. ``while`` honours ``max_iters``;
    like ``lax.while_loop`` it passes no gradient (its body runs under
    ``torch.no_grad``);
  * the tensor arrays (``write_to_array``, ``read_from_array``,
    ``lod_array_length``) are Python lists in the step's environment,
    indexed by a value read on the host: host ops, which ``run_steps``
    refuses.

``recompute_block`` lowers a region under
``torch.utils.checkpoint(use_reentrant=False,
preserve_rng_state=False)``, where the JAX package uses
``jax.checkpoint``: the non-reentrant form, because the Executor
differentiates with ``torch.autograd.grad``, which the reentrant form
refuses; and without saving the global RNG state, which the region's
draws never read (dropout is keyed by the run's seed and each op's key,
``ops/dropout.py``) and which a CUDA graph capture may not touch. The
recompute therefore replays the forward's masks, and the flash kernels
of a region run twice a step: in the forward and again in the backward.
"""

import torch
from torch.utils import checkpoint as _checkpoint

from ..core.registry import register, sub_blocks
from ..core.scope import torch_dtype
from .tensor_ops import _refuse_in_capture

__all__ = []


def _run_block(ctx, block, env):
    """The sub-block's lowerings over ``env``, in program order."""
    from ..core.executor import _lower_op
    sctx = ctx.sub_context(env, block)
    for op2 in block.ops:
        _lower_op(sctx, op2)
    return env


def _rows(mask, like):
    """A [B] mask shaped to broadcast over ``like``'s rows."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


@register("recurrent")
def _recurrent(ctx, op):
    """Run a sub-block once per step of the time axis.

    inputs: ``inputs`` (sequences, [T, B, ...], or [B, T, ...] without
    ``time_major``), ``initial_states``, optional ``sequence_length``
    [B]; outputs: ``outputs`` (the steps' outputs stacked on the time
    axis) and ``final_states``; attrs: sub_block, inner_input_names,
    inner_state_names, inner_state_out_names, inner_output_names,
    time_major, reverse. With lengths, a row past its length keeps its
    state and outputs zeros (the inputs are end-padded, so the live
    steps are t < length in both directions)."""
    block = op.attr("sub_block")
    inner_inputs = op.attr("inner_input_names") or []
    inner_states = op.attr("inner_state_names") or []
    inner_state_outs = op.attr("inner_state_out_names") or []
    inner_outputs = op.attr("inner_output_names") or []
    time_major = op.attr("time_major", True)
    xs = [ctx.get(n) for n in op.input("inputs")]
    if not time_major:
        xs = [torch.movedim(x, 1, 0) for x in xs]           # [T, B, ...]
    t_len = xs[0].shape[0] if xs else int(op.attr("max_len"))
    carry = [ctx.get(n) for n in op.input("initial_states")]
    lens = None
    if op.input("sequence_length"):
        lens = ctx.get(op.input("sequence_length")[0]).reshape(-1)
    base_env = dict(ctx.env)
    ys = [[None] * t_len for _ in inner_outputs]
    steps = range(t_len - 1, -1, -1) if op.attr("reverse", False) \
        else range(t_len)
    for t in steps:
        env = dict(base_env)
        env.update(zip(inner_states, carry))
        env.update((n, x[t]) for n, x in zip(inner_inputs, xs))
        _run_block(ctx, block, env)
        new = [env[n] for n in inner_state_outs]
        outs = [env[n] for n in inner_outputs]
        if lens is not None:
            alive = t < lens
            new = [torch.where(_rows(alive, nc), nc, c)
                   for nc, c in zip(new, carry)]
            outs = [torch.where(_rows(alive, o), o, torch.zeros_like(o))
                    for o in outs]
        carry = new
        for k, o in enumerate(outs):
            ys[k][t] = o
    for name, y in zip(op.output("outputs"), ys):
        y = torch.stack(y)
        ctx.env[name] = y if time_major else torch.movedim(y, 0, 1)
    for name, s in zip(op.output("final_states"), carry):
        ctx.env[name] = s


def _host_scalar(t):
    return t.reshape(()).item()


@register("while")
def _while(ctx, op):
    """Run the sub-block while the condition var holds (while_op.cc), at
    most ``max_iters`` times when set. The carried vars are the attr
    ``carry_names``; each pass starts from the op's environment with the
    carry's latest values. The condition is read on the host after every
    pass; the body passes no gradient."""
    _refuse_in_capture("the while op")
    block = op.attr("sub_block")
    cond_name = op.input("Condition")[0]
    carry_names = list(op.attr("carry_names") or [])
    max_iters = op.attr("max_iters")
    base_env = dict(ctx.env)
    vals = [ctx.get(n) for n in carry_names]
    cond = ctx.get(cond_name).reshape(())
    dtype = cond.dtype
    it = 0
    with torch.no_grad():
        while bool(_host_scalar(cond)) and not (max_iters and
                                                it >= max_iters):
            env = dict(base_env)
            env.update(zip(carry_names, vals))
            _run_block(ctx, block, env)
            vals = [env[n] for n in carry_names]
            cond = env[cond_name].reshape(()).to(dtype)
            it += 1
    for name, v in zip(carry_names, vals):
        ctx.env[name] = v
    ctx.env[cond_name] = cond


@register("conditional_block")
def _conditional_block(ctx, op):
    """Run the sub-block when the scalar condition holds
    (conditional_block_op.cc), read on the host. The vars it writes must
    have a value before it: the false branch keeps them."""
    _refuse_in_capture("the conditional_block op")
    block = op.attr("sub_block")
    out_names = list(op.attr("written_names") or op.output("Out") or [])
    missing = [n for n in out_names if n not in ctx.env]
    if missing:
        raise ValueError(
            "conditional_block outputs %s have no pre-set value for the "
            "false branch; assign defaults before the block" % missing)
    if bool(_host_scalar(ctx.get(op.input("Condition")[0]))):
        env = _run_block(ctx, block, dict(ctx.env))
        for n in out_names:
            ctx.env[n] = env[n]


@register("select_rows_by_mask")
def _select_rows_by_mask(ctx, op):
    """IfElse's merge: row i of Out is TrueOut's where Mask holds, else
    FalseOut's."""
    mask = ctx.in1(op, "Mask").reshape(-1).to(torch.bool)
    t = ctx.in1(op, "TrueOut")
    ctx.set_out(op, "Out", torch.where(_rows(mask, t), t,
                                       ctx.in1(op, "FalseOut")))


# -- the tensor arrays (tensor_array_read_write.cc, lod_array_length) ------
# A Python list in the step's environment under ``<array>@ARRAY`` (and
# the array's own name), its index read on the host.

def _index(ctx, op):
    return int(_host_scalar(ctx.in1(op, "I")))


@register("write_to_array", host=True)
def _write_to_array(ctx, op):
    """Write X at index I, growing the array with zeros as needed."""
    arr_name = ctx.out_name(op, "Out")
    x = ctx.in1(op, "X")
    lst = list(ctx.env.get(arr_name + "@ARRAY") or [])
    idx = _index(ctx, op)
    while len(lst) <= idx:
        lst.append(torch.zeros_like(x))
    lst[idx] = x
    ctx.env[arr_name + "@ARRAY"] = lst
    ctx.env[arr_name] = lst          # stacked when fetched


@register("read_from_array", host=True)
def _read_from_array(ctx, op):
    arr_name = op.input("X")[0]
    lst = ctx.env.get(arr_name + "@ARRAY")
    if lst is None:
        lst = ctx.get(arr_name)
    ctx.set_out(op, "Out", lst[_index(ctx, op)])


@register("lod_array_length", host=True)
def _lod_array_length(ctx, op):
    arr_name = op.input("X")[0]
    lst = ctx.env.get(arr_name + "@ARRAY")
    n = len(lst) if lst is not None else ctx.get(arr_name).shape[0]
    ctx.set_out(op, "Out", torch.full((1,), n, dtype=torch_dtype("int64"),
                                      device=ctx.device))


@register("shrink_rnn_memory")
def _shrink_rnn_memory(ctx, op):
    """The identity: the masked carry of ``recurrent`` already keeps a
    finished sequence's state."""
    ctx.set_out(op, "Out", ctx.in1(op, "X"))


@register("max_sequence_len")
def _max_sequence_len(ctx, op):
    ctx.set_out(op, "Out", torch.amax(ctx.in1(op, "RankTable")).reshape(1)
                .to(torch_dtype("int64")))


@register("lod_rank_table")
def _lod_rank_table(ctx, op):
    """The rank table as the lengths vector of X's LoD (one sequence of
    all of X without one): the ops that read it sort or reduce it."""
    x_name = op.input("X")[0]
    lens = ctx.maybe_get(x_name + "@LOD")
    if lens is None:
        lens = torch.full((1,), ctx.get(x_name).shape[0], dtype=torch.int32,
                          device=ctx.device)
    ctx.set_out(op, "Out", lens)


def _op_reads(op, seen=None):
    """The names ``op`` reads: its declared inputs and everything read
    inside any sub-block it carries."""
    seen = set() if seen is None else seen
    names = {n for ns in op.inputs.values() for n in ns}
    for b in sub_blocks(op):
        if id(b) not in seen:
            seen.add(id(b))
            for o in b.ops:
                names |= _op_reads(o, seen)
    return names


@register("recompute_block")
def _recompute_block(ctx, op):
    """Rematerialization region: the sub-block's internal activations are
    recomputed in the backward pass instead of stored. Exported from the
    region, as in the JAX package: the sub-block writes that LATER ops of
    the parent block read (looking through their sub-blocks), the
    persistables and anything in the run's fetch list; every other value
    stays inside."""
    from ..core.executor import _lower_op

    block = op.attr("sub_block")
    parent_ops = list(ctx.block.ops) if ctx.block is not None else []
    try:
        my_idx = next(i for i, o in enumerate(parent_ops) if o is op)
    except StopIteration:
        raise RuntimeError(
            "recompute_block op not found in its parent block's op list "
            "— the lowering must run on the block that owns the op")
    later_reads = set()
    for o in parent_ops[my_idx + 1:]:
        later_reads |= _op_reads(o)
    persistable = {v.name for v in ctx.block.vars.values()
                   if getattr(v, "persistable", False)}
    fetches = set(ctx.fetch_names)
    out_names = [n for n in op.output("Out")
                 if n in later_reads or n in persistable or n in fetches]
    in_names = [n for n in op.input("X") if n in ctx.env]
    base_env = dict(ctx.env)

    def region(*vals):
        env = dict(base_env)
        env.update(zip(in_names, vals))
        sctx = ctx.sub_context(env, block)
        for op2 in block.ops:
            _lower_op(sctx, op2)
        return tuple(env[n] for n in out_names)

    vals = tuple(ctx.env[n] for n in in_names)
    if torch.is_grad_enabled() and any(
            isinstance(v, torch.Tensor) and v.requires_grad for v in vals):
        outs = _checkpoint.checkpoint(region, *vals, use_reentrant=False,
                                      preserve_rng_state=False)
    else:
        outs = region(*vals)
    for n, v in zip(out_names, outs):
        ctx.env[n] = v
