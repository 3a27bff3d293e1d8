"""Layer DSL for SP / PP / EP (ops/parallel_ops.py lowerings).

The counterpart of ``paddle_tpu/layers/parallel_layers.py``: the same
layers, parameters, initializers and sharding hints, so the Program JSON
is the JAX package's:

    attn = layers.sequence_parallel_attention(q, k, v, causal=True)
    out, aux = layers.sparse_moe(x, num_experts=8, d_inner=2048)
    y = layers.pipelined_decoder_stack(x, n_layer=8, n_head=8, d_inner=2048)

Each runs the distributed path when ParallelExecutor's mesh has the
matching axis (sp / ep / pp) and an identical-math dense fallback
otherwise, so programs stay testable on one device.
"""

from .layer_helper import LayerHelper
from ..initializer import Normal, Constant
from ..param_attr import ParamAttr

__all__ = ["sequence_parallel_attention", "sparse_moe",
           "pipelined_decoder_stack"]


def sequence_parallel_attention(q, k, v, causal=False, variant="ring",
                                scale=0.0, name=None):
    """q/k/v: [B, H, T, dk] variables (T sharded on the sp mesh axis under
    ParallelExecutor). Returns [B, H, T, dk]."""
    helper = LayerHelper("sp_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
    helper.append_op(
        type="sp_attention", inputs={"Q": [q], "K": [k], "V": [v]},
        outputs={"Out": [out]},
        attrs={"causal": causal, "variant": variant, "scale": scale})
    return out


def sparse_moe(x, num_experts, d_inner, capacity_factor=1.25,
               top_k=1, return_overflow=False, param_attr=None, name=None):
    """MoE FFN over [B, T, D] (or [T, D]) input: Switch top-1 (top_k=1)
    or GShard top-2 with normalized combine weights (top_k=2). Expert
    weights are stacked [E, ...] and sharded on the ep mesh axis. Returns
    (out, aux_loss) — add aux_loss (scaled) to the training cost — plus
    the scalar capacity-overflow fraction (the routing-health metric to
    monitor) when return_overflow=True."""
    helper = LayerHelper("moe_ffn", param_attr=param_attr, name=name)
    d = int(x.shape[-1])
    gate = helper.create_parameter(helper.param_attr, shape=[d, num_experts],
                                   dtype=x.dtype,
                                   default_initializer=Normal(0., 0.02))
    w_up = helper.create_parameter(
        ParamAttr(name=helper.name + ".w_up"),
        shape=[num_experts, d, d_inner], dtype=x.dtype,
        default_initializer=Normal(0., d ** -0.5))
    w_down = helper.create_parameter(
        ParamAttr(name=helper.name + ".w_down"),
        shape=[num_experts, d_inner, d], dtype=x.dtype,
        default_initializer=Normal(0., d_inner ** -0.5))
    # expert dim rides the ep axis
    prog = helper.main_program
    prog._sharding_hints[w_up.name] = ("ep", None, None)
    prog._sharding_hints[w_down.name] = ("ep", None, None)

    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    aux = helper.create_variable_for_type_inference("float32", shape=())
    outputs = {"Out": [out], "AuxLoss": [aux]}
    overflow = None
    if return_overflow:
        overflow = helper.create_variable_for_type_inference(
            "float32", shape=())
        overflow.stop_gradient = True
        outputs["Overflow"] = [overflow]
    helper.append_op(
        type="moe_ffn",
        inputs={"X": [x], "GateW": [gate], "WUp": [w_up],
                "WDown": [w_down]},
        outputs=outputs,
        attrs={"capacity_factor": capacity_factor, "top_k": int(top_k)})
    if return_overflow:
        return out, aux, overflow
    return out, aux


def pipelined_decoder_stack(x, n_layer, n_head, d_inner,
                            num_microbatches=0, recompute=False,
                            schedule="gpipe", virtual_stages=0,
                            tp_shard=False, num_experts=0, moe_top_k=1,
                            moe_capacity_factor=1.25, moe_gate_groups=1,
                            name=None):
    """L identical causal decoder layers with layer-stacked parameters
    ([L, ...], leading dim sharded on the pp mesh axis → pipeline
    schedule under ParallelExecutor; a loop over layers otherwise).
    recompute=True rematerializes each layer's activations in the
    backward pass (a checkpoint per layer).
    schedule: "gpipe" (M >= S regime) or "interleaved" (Megatron
    virtual stages — bubble cut by `virtual_stages` chunks per device;
    requires M <= S). tp_shard=True adds Megatron col/row sharding
    hints for a tp mesh axis (the pp x tp composition — the stage body
    then psums per sublayer; ops/parallel_ops._decoder_layer_apply_tp).

    num_experts > 0 replaces every layer's dense FFN with a routed MoE
    layer (experts' hidden dim = d_inner) — the pp x ep composition:
    expert stacks shard on the ep mesh axis and the dispatch
    all-to-alls inside the stage body. Requires an explicit
    num_microbatches and moe_gate_groups = dp*ep of the target mesh
    (routing is per-microbatch per token-group; the static attrs let
    the dense fallback reproduce it exactly), and the call then
    returns (out, aux_loss) instead of out.

    x: [B, T, D]. Returns [B, T, D]."""
    helper = LayerHelper("pipeline_stack", name=name)
    d = int(x.shape[-1])
    L = int(n_layer)
    # storage-placement hints for the GLOBAL [L, ...] params (the op
    # re-blocks them per schedule); col/row tp tails
    # mirror ops/parallel_ops._TP_SPEC_TAILS
    tp_tails = {
        ".wq": (None, "tp"), ".wk": (None, "tp"), ".wv": (None, "tp"),
        ".wo": ("tp", None), ".w1": (None, "tp"), ".b1": ("tp",),
        ".w2": ("tp", None),
    }

    def p(suffix, shape, init):
        w = helper.create_parameter(ParamAttr(name=helper.name + suffix),
                                    shape=list(shape), dtype=x.dtype,
                                    default_initializer=init)
        tail = tp_tails.get(suffix) if tp_shard else None
        helper.main_program._sharding_hints[w.name] = \
            ("pp",) + (tail or (None,) * (len(shape) - 1))
        return w

    std = d ** -0.5
    params = {
        "WQ": p(".wq", (L, d, d), Normal(0., std)),
        "WK": p(".wk", (L, d, d), Normal(0., std)),
        "WV": p(".wv", (L, d, d), Normal(0., std)),
        "WO": p(".wo", (L, d, d), Normal(0., std)),
        "LN1S": p(".ln1_s", (L, d), Constant(1.0)),
        "LN1B": p(".ln1_b", (L, d), Constant(0.0)),
        "LN2S": p(".ln2_s", (L, d), Constant(1.0)),
        "LN2B": p(".ln2_b", (L, d), Constant(0.0)),
    }
    moe = int(num_experts) > 0
    if moe:
        e = int(num_experts)
        # gate replicated (routing needs every logit); expert stacks
        # shard on ep (storage hints for the GLOBAL [L, E, ...] params)
        gate = helper.create_parameter(
            ParamAttr(name=helper.name + ".gate_w"),
            shape=[L, d, e], dtype=x.dtype,
            default_initializer=Normal(0., 0.02))
        w_up = helper.create_parameter(
            ParamAttr(name=helper.name + ".w_up"),
            shape=[L, e, d, d_inner], dtype=x.dtype,
            default_initializer=Normal(0., std))
        w_down = helper.create_parameter(
            ParamAttr(name=helper.name + ".w_down"),
            shape=[L, e, d_inner, d], dtype=x.dtype,
            default_initializer=Normal(0., d_inner ** -0.5))
        hints = helper.main_program._sharding_hints
        hints[gate.name] = ("pp", None, None)
        hints[w_up.name] = ("pp", "ep", None, None)
        hints[w_down.name] = ("pp", "ep", None, None)
        params.update({"GateW": gate, "WUp": w_up, "WDown": w_down})
    else:
        params.update({
            "W1": p(".w1", (L, d, d_inner), Normal(0., std)),
            "B1": p(".b1", (L, d_inner), Constant(0.0)),
            "W2": p(".w2", (L, d_inner, d), Normal(0., d_inner ** -0.5)),
            "B2": p(".b2", (L, d), Constant(0.0)),
        })
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    outputs = {"Out": [out]}
    aux = None
    if moe:
        aux = helper.create_variable_for_type_inference(
            "float32", shape=())
        outputs["AuxLoss"] = [aux]
    helper.append_op(
        type="pipeline_stack",
        inputs=dict({"X": [x]}, **{s: [w] for s, w in params.items()}),
        outputs=outputs,
        attrs={"n_head": n_head, "num_microbatches": num_microbatches,
               "recompute": bool(recompute), "schedule": str(schedule),
               "virtual_stages": int(virtual_stages),
               "moe_top_k": int(moe_top_k),
               "moe_capacity_factor": float(moe_capacity_factor),
               "moe_gate_groups": int(moe_gate_groups)})
    if moe:
        return out, aux
    return out
