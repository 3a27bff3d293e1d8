"""Framework-level SP / PP / EP ops: ``sp_attention``, ``moe_ffn`` and
``pipeline_stack``.

The counterpart of ``paddle_tpu/ops/parallel_ops.py``. Each lowering
consults ``ctx.mesh`` (set by ``ParallelExecutor``): with the matching
mesh axis present (more than one rank on it) the distributed path runs
(ring or Ulysses attention over ``sp``, the expert FFN over ``ep``, the
GPipe or interleaved pipeline over ``pp``); without it the op takes the
JAX package's dense form (flash attention over the whole sequence, a
loop over layers where the JAX package scans), so the same Program runs
on one device for tests and parity checks.

The kernel wrappers read ``data_ptr()``, so no DTensor reaches a kernel:
under ``ParallelExecutor`` every path enters its computation through
``parallel._shard_map.shard_map``, which hands the body this rank's
local blocks (the batch on ``dp``, the heads on ``tp``, the sequence on
``sp``) and puts the result's blocks back together. The stage weights
of ``pipeline_stack`` and the expert stacks of ``moe_ffn`` arrive as the
blocks this rank holds (``parallel/blocks.py``) and enter as they are;
``sp_attention``'s Q/K/V arrive as each rank's sequence block where
``sp`` is a DTensor axis, and its output leaves as one.
"""

import functools

import torch
from torch.utils import checkpoint as _checkpoint

from ..core.registry import register
from .flash_attention import flash_attention


def _is_dtensor(x):
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _batch_whole(mesh, x, dim=0):
    """A DTensor's dim ``dim`` made whole (its Shard there gathered)
    around a reshape between [B, ...] and the pipeline's [M, B/M, ...]:
    the dp block of the batch is not a block of each microbatch, which
    the pipeline's shard_map takes. A plain tensor passes through."""
    if not _is_dtensor(x):
        return x
    from ..parallel._shard_map import relayout, spec_of
    return relayout(mesh, x, spec_of(mesh, x, drop=dim))


def _batch_like(mesh, out, x):
    """``out`` laid out as ``x`` (the inverse of ``_batch_whole``)."""
    if not _is_dtensor(x):
        return out
    from ..parallel._shard_map import relayout, spec_of
    return relayout(mesh, out, spec_of(mesh, x))


def _mesh_axis(ctx, name):
    mesh = ctx.mesh
    if mesh is not None and name in mesh.axis_names \
            and mesh.shape[name] > 1:
        return mesh
    return None


def _batch_axis(mesh):
    return "dp" if (mesh is not None and "dp" in mesh.axis_names) else None


def _head_axis(mesh, n_head, also=1):
    """``tp`` when the heads split over it (and, for Ulysses, over the
    ``also`` ranks of ``sp`` after it): attention is per head, so the
    heads of a tp-sharded projection stay where they are."""
    if mesh is None or mesh.shape.get("tp", 1) <= 1:
        return None
    return "tp" if n_head % (mesh.shape["tp"] * also) == 0 else None


def _flash(q, k, v, causal, scale):
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, scale=scale)


def _dense_attention(mesh, q, k, v, causal, scale):
    """flash attention over the whole sequence; DTensors (a mesh without
    ``sp``) enter per batch shard and head shard."""
    if not _is_dtensor(q):
        return _flash(q, k, v, causal, scale)
    from ..parallel._shard_map import shard_map
    from ..parallel.mesh import PartitionSpec as P
    spec = P(_batch_axis(mesh), _head_axis(mesh, q.shape[1]), None, None)
    fn = shard_map(functools.partial(_flash, causal=causal, scale=scale),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)


@register("sp_attention")
def _sp_attention(ctx, op):
    """Sequence-parallel attention. Inputs Q/K/V [B, H, T, dk] (T sharded
    on the mesh's sp axis when present); attrs: causal, variant
    ("ring" | "ulysses"), scale (0 means dk**-0.5)."""
    q = ctx.in1(op, "Q")
    k = ctx.in1(op, "K")
    v = ctx.in1(op, "V")
    causal = bool(op.attr("causal", False))
    scale = float(op.attr("scale", 0.0)) or q.shape[-1] ** -0.5
    mesh = _mesh_axis(ctx, "sp")
    if mesh is None:
        out = _dense_attention(ctx.mesh, q, k, v, causal, scale)
    else:
        from ..parallel import ring
        if op.attr("variant", "ring") == "ulysses":
            body = ring._ulysses_sharded
            heads = _head_axis(mesh, q.shape[1], mesh.shape["sp"])
        else:
            body = ring._ring_attention_sharded
            heads = _head_axis(mesh, q.shape[1])
        out = ring._sp_attention(body, q, k, v, mesh, "sp", causal, scale,
                                 _batch_axis(mesh), head_axis=heads)
    ctx.set_out(op, "Out", out)


@register("moe_ffn", stateful_rng=True)
def _moe_ffn(ctx, op):
    """MoE FFN: Switch top-1 (attr top_k=1) or GShard top-2 with
    normalized combine weights (top_k=2). Inputs X [B, T, D] or [T, D],
    GateW [D, E], WUp [E, D, H], WDown [E, H, D]; attrs capacity_factor,
    top_k. Outputs Out (same shape as X), AuxLoss (scalar load-balancing
    loss) and, when wired, Overflow (fraction of token-expert assignments
    dropped by capacity). With an ``ep`` axis (or any DTensor input) the
    routing covers every token and the experts run on their ``ep``
    ranks (parallel/moe.py)."""
    x = ctx.in1(op, "X")
    gate_w = ctx.in1(op, "GateW")
    w_up = ctx.in1(op, "WUp")
    w_down = ctx.in1(op, "WDown")
    cf = float(op.attr("capacity_factor", 1.25))
    top_k = int(op.attr("top_k", 1))
    from ..parallel import moe
    from ..parallel._shard_map import held
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    mesh = ctx.mesh if (_mesh_axis(ctx, "ep") or _is_dtensor(x)) else None
    # expert stacks this rank holds as its ep block (parallel/blocks.py)
    spec = ctx.held_spec(op.input("WUp")[0])
    if spec is not None:
        w_up = held(w_up.view_as(w_up), spec)
    spec = ctx.held_spec(op.input("WDown")[0])
    if spec is not None:
        w_down = held(w_down.view_as(w_down), spec)
    if ctx.held_spec(op.input("GateW")[0]) is not None:
        gate_w = _gathered(ctx.mesh, gate_w,
                           ctx.held_spec(op.input("GateW")[0]))
    out, aux, stats = moe.moe_ffn(
        flat, gate_w, w_up, w_down, capacity_factor=cf, top_k=top_k,
        mesh=mesh, return_stats=True)
    ctx.set_out(op, "Out", out.reshape(shape))
    ctx.set_out(op, "AuxLoss", aux)
    if op.output("Overflow"):
        ctx.set_out(op, "Overflow", stats["overflow"])


def _decoder_layer_apply(p, x, n_head):
    """One post-LN decoder-only layer (models/transformer.py 'dan') from a
    dict of tensors: the tp/sp twin with both axes off."""
    return _decoder_layer_apply_tp(p, x, n_head, None, None)


def _ln_apply(x, scale, bias, eps=1e-5):
    xf = x.float() if x.dtype == torch.bfloat16 else x
    m = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, unbiased=False)
    return ((xf - m) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _decoder_layer_apply_tp(p, x, n_head, tp_axis, sp_axis=None,
                            ep_axis=None, moe_top_k=1, moe_cf=1.25):
    """The Megatron tensor-parallel twin of _decoder_layer_apply, for use
    inside shard_map (the pipeline stage body): p's matrix leaves are the
    local tp shards — wq/wk/wv col-sharded [d, d/tp] (head-split), wo
    row-sharded [d/tp, d], w1 col [d, f/tp] + b1 [f/tp], w2 row [f/tp, d]
    — and each sublayer closes with one psum over tp. LN params and b2
    are replicated; b2 adds after the psum. With sp_axis set,
    activations arrive sequence-sharded [b, t/sp, d] and attention runs
    the ring over that axis.

    MoE FFN (pp x ep): when p carries gate_w/w_up/w_down instead of
    w1..b2 the FFN is a routed expert layer and the call returns (out,
    aux_loss); with ep_axis set the expert stacks are the local shards
    and dispatch rides an all-to-all over ep (moe_ffn_pp_sharded)."""
    from ..parallel import collective as C
    b, t, d = x.shape
    tp = C.axis_size(tp_axis) if tp_axis else 1
    h_local = n_head // tp
    dk = d // n_head

    def heads(z):
        return z.reshape(b, t, h_local, dk).permute(0, 2, 1, 3).contiguous()

    q = heads(x @ p["wq"])
    k = heads(x @ p["wk"])
    v = heads(x @ p["wv"])
    if sp_axis:
        from ..parallel.ring import _ring_attention_sharded
        a = _ring_attention_sharded(q, k, v, sp_axis, True, dk ** -0.5)
    else:
        a = _flash(q, k, v, True, dk ** -0.5)
    part = a.permute(0, 2, 1, 3).reshape(b, t, h_local * dk) @ p["wo"]
    if tp_axis:
        part = C.psum(part, tp_axis)
    x = _ln_apply(x + part, p["ln1_s"], p["ln1_b"])
    if "gate_w" in p:
        from ..parallel import moe as moe_mod
        flat = x.reshape(-1, d)
        if ep_axis:
            f, aux = moe_mod.moe_ffn_pp_sharded(
                flat, p["gate_w"], p["w_up"], p["w_down"], ep_axis,
                top_k=moe_top_k, capacity_factor=moe_cf)
        else:
            f, aux = moe_mod.moe_ffn(
                flat, p["gate_w"], p["w_up"], p["w_down"],
                capacity_factor=moe_cf, top_k=moe_top_k)
        f = f.reshape(b, t, d)
        return _ln_apply(x + f, p["ln2_s"], p["ln2_b"]), aux
    h = torch.relu(x @ p["w1"] + p["b1"])
    f = h @ p["w2"]
    if tp_axis:
        f = C.psum(f, tp_axis)
    f = f + p["b2"]
    return _ln_apply(x + f, p["ln2_s"], p["ln2_b"])


def _recomputed(layer_apply):
    """``jax.checkpoint`` of a layer: a non-reentrant
    ``torch.utils.checkpoint``, as the port's recompute regions run."""
    def run(p, x):
        return _checkpoint.checkpoint(layer_apply, p, x, use_reentrant=False,
                                      preserve_rng_state=False)
    return run


_STACK_SLOTS = ("WQ", "WK", "WV", "WO", "LN1S", "LN1B", "W1", "B1", "W2",
                "B2", "LN2S", "LN2B")
_STACK_KEYS = ("wq", "wk", "wv", "wo", "ln1_s", "ln1_b", "w1", "b1", "w2",
               "b2", "ln2_s", "ln2_b")


def _layer(params, i):
    return {k: v[i] for k, v in params.items()}


def _pipeline_moe_fallback(op, x, params, n_head, gate_groups, moe_top_k,
                           moe_cf):
    """Dense single-device twin of the MoE pipeline: the same M
    microbatches, and within each the layer over the same gate_groups
    contiguous token groups the sharded run splits over dp x ep —
    routing (capacities, drops, aux) is then identical to the pipelined
    run. Returns (out, aux)."""
    m = int(op.attr("num_microbatches", 0))
    if m < 1:
        raise ValueError(
            "pipeline_stack MoE needs an EXPLICIT num_microbatches: "
            "routing is per-microbatch, so the dense fallback can only "
            "reproduce the pipelined model if M is static")
    b = x.shape[0]
    g = max(1, gate_groups)
    if b % m or (b // m) % g:
        raise ValueError(
            "pipeline_stack MoE: batch %d must divide into %d "
            "microbatches x %d gate groups" % (b, m, g))
    layer_apply = functools.partial(
        _decoder_layer_apply_tp, n_head=n_head, tp_axis=None,
        sp_axis=None, ep_axis=None, moe_top_k=moe_top_k, moe_cf=moe_cf)
    if op.attr("recompute"):
        layer_apply = _recomputed(layer_apply)
    n_layer = params["wq"].shape[0]
    mbs = x.reshape((m, b // m) + tuple(x.shape[1:]))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = []
    for i in range(m):
        mb = mbs[i]
        rows = mb.shape[0]
        xg = mb.reshape((g, rows // g) + tuple(mb.shape[1:]))
        aux_mb = torch.zeros((), dtype=torch.float32, device=x.device)
        for li in range(n_layer):
            lp = _layer(params, li)
            res = [layer_apply(lp, xg[j]) for j in range(g)]
            xg = torch.stack([r[0] for r in res])
            aux_mb = aux_mb + torch.mean(
                torch.stack([r[1] for r in res])).float()
        aux_total = aux_total + aux_mb
        outs.append(xg.reshape(mb.shape))
    return torch.stack(outs).reshape(x.shape), aux_total / m


def _pipeline_dense(op, x, params, n_head, moe, gate_groups, moe_top_k,
                    moe_cf):
    """The op without a pp axis: a loop over layers (the JAX package's
    scan), or the MoE fallback. Returns (out, aux or None)."""
    if moe:
        return _pipeline_moe_fallback(op, x, params, n_head, gate_groups,
                                      moe_top_k, moe_cf)
    layer_apply = functools.partial(_decoder_layer_apply, n_head=n_head)
    if op.attr("recompute"):
        layer_apply = _recomputed(layer_apply)
    out = x
    for li in range(params["wq"].shape[0]):
        out = layer_apply(_layer(params, li), out)
    return out, None


# per-leaf spec tails (dims after the leading stage/chunk dims) for
# Megatron tp sharding of the stacked decoder params: in-projections and
# w1 col-sharded, out-projections row-sharded, everything else
# replicated (b2 adds after the psum)
_TP_SPEC_TAILS = {
    "wq": (None, None, "tp"), "wk": (None, None, "tp"),
    "wv": (None, None, "tp"), "wo": (None, "tp", None),
    "w1": (None, None, "tp"), "b1": (None, "tp"),
    "w2": (None, "tp", None), "b2": (None, None),
    "ln1_s": (None, None), "ln1_b": (None, None),
    "ln2_s": (None, None), "ln2_b": (None, None),
}


def _global_shape(ctx, name, value):
    """The Program's shape of ``name`` where the block gives it (a held
    block's global shape), else ``value``'s."""
    var = ctx.block.vars.get(name) if ctx.block is not None else None
    if var is not None and ctx.held_spec(name) is not None:
        return tuple(var.shape)
    return tuple(value.shape)


def _gathered(mesh, value, spec):
    """A held block gathered whole, for a reader that needs the whole."""
    from ..parallel import blocks
    return blocks._Gather.apply(value, mesh, spec)


def _stacked(value, s, per, spec):
    """A [L, ...] stack as the gpipe schedule's [S, per, ...]: a held
    block on ``pp`` ([per, ...], ``spec`` its hint) is this rank's
    [1, per, ...] of it, marked so the pipeline's shard_map takes it as
    it is."""
    if spec is None:
        return value.reshape((s, per) + tuple(value.shape[1:]))
    from ..parallel._shard_map import held
    lead = spec[0] if spec else None
    rows = 1 if lead is not None else s
    return held(value.reshape((rows, per) + tuple(value.shape[1:])),
                (lead, None) + tuple(spec[1:]))


@register("pipeline_stack")
def _pipeline_stack(ctx, op):
    """A stack of L identical causal decoder layers with layer-stacked
    parameters (leading dim L). With a pp mesh axis of size S the stack
    runs as an S-stage pipeline (L/S layers per stage); otherwise as a
    loop over layers. Attrs: n_head, num_microbatches (0 = auto: 2*S for
    gpipe, S for interleaved), recompute (a checkpoint per layer),
    schedule ("gpipe" | "interleaved"), virtual_stages (V chunks per
    device, interleaved only; 0 = auto L/S), and for MoE moe_top_k,
    moe_capacity_factor, moe_gate_groups.

    Composition: a tp axis Megatron-shards every stage's weights with one
    psum per sublayer inside the stage body; an sp axis shards the
    sequence dim and runs ring attention inside the stage; GateW/WUp/
    WDown slots replace W1..B2 with a routed MoE FFN whose experts shard
    on ep and whose dispatch all-to-alls inside the stage body (pp x
    ep), the token groups split over dp x ep at the static granularity
    moe_gate_groups (= dp*ep), so the dense fallback reproduces the
    pipelined routing. MoE adds the AuxLoss output."""
    x = ctx.in1(op, "X")
    n_head = int(op.attr("n_head", 8))
    params = {key: ctx.in1(op, slot)
              for key, slot in zip(_STACK_KEYS, _STACK_SLOTS)
              if op.input(slot)}
    moe = bool(op.input("GateW"))
    moe_top_k = int(op.attr("moe_top_k", 1))
    moe_cf = float(op.attr("moe_capacity_factor", 1.25))
    gate_groups = int(op.attr("moe_gate_groups", 1) or 1)
    slots = dict(zip(_STACK_KEYS, _STACK_SLOTS))
    if moe:
        params["gate_w"] = ctx.in1(op, "GateW")
        params["w_up"] = ctx.in1(op, "WUp")
        params["w_down"] = ctx.in1(op, "WDown")
        slots.update(gate_w="GateW", w_up="WUp", w_down="WDown")
    # the parameters this rank holds as blocks (parallel/blocks.py), and
    # every parameter's global shape
    held = {k: ctx.held_spec(op.input(slots[k])[0]) for k in params}
    held = {k: v for k, v in held.items() if v is not None}
    shapes = {k: _global_shape(ctx, op.input(slots[k])[0], p)
              for k, p in params.items()}
    n_layer = shapes["wq"][0]
    mesh = _mesh_axis(ctx, "pp")
    if mesh is None:
        # the dense loop reads every layer
        for k, spec in held.items():
            params[k] = _gathered(ctx.mesh, params[k], spec)
        held = {}

    if mesh is None:
        dense = functools.partial(_pipeline_dense, op, n_head=n_head,
                                  moe=moe, gate_groups=gate_groups,
                                  moe_top_k=moe_top_k, moe_cf=moe_cf)
        if _is_dtensor(x):
            # a mesh without pp: every rank runs the stack whole
            from ..parallel._shard_map import shard_map
            from ..parallel.mesh import PartitionSpec as P
            out, aux = shard_map(
                lambda x_, p_: dense(x_, p_), mesh=ctx.mesh,
                in_specs=(P(), P()), out_specs=(P(), P()))(x, params)
        else:
            out, aux = dense(x, params)
        ctx.set_out(op, "Out", out)
        if moe and op.output("AuxLoss"):
            ctx.set_out(op, "AuxLoss", aux)
        return

    from ..parallel import pipeline
    tp_axis = "tp" if _mesh_axis(ctx, "tp") else None
    sp_axis = "sp" if _mesh_axis(ctx, "sp") else None
    ep_axis = "ep" if (moe and _mesh_axis(ctx, "ep")) else None
    if moe and sp_axis:
        raise NotImplementedError(
            "pipeline_stack MoE does not compose with sequence "
            "parallelism yet (routing granularity under a sequence "
            "shard is undefined); use pp x ep without sp")
    if moe:
        if int(op.attr("num_microbatches", 0)) < 1:
            raise ValueError(
                "pipeline_stack MoE needs an EXPLICIT num_microbatches: "
                "routing is per-microbatch, so the dense fallback can "
                "only reproduce the pipelined model if M is static")
        dp_size = mesh.shape["dp"] if "dp" in mesh.axis_names else 1
        ep_size = mesh.shape["ep"] if ep_axis else 1
        if gate_groups != dp_size * ep_size:
            raise ValueError(
                "pipeline_stack moe_gate_groups=%d does not match the "
                "mesh's dp*ep=%d*%d: the static routing granularity "
                "must equal the token-split so the dense fallback and "
                "the sharded run gate the same groups"
                % (gate_groups, dp_size, ep_size))
    if tp_axis:
        tp = mesh.shape["tp"]
        d_inner = shapes["w1"][-1] if "w1" in params else 0
        if n_head % tp or d_inner % tp:
            raise ValueError(
                "pipeline_stack tp composition needs n_head (%d) and "
                "d_inner (%d) divisible by tp=%d" % (n_head, d_inner, tp))
    if tp_axis or sp_axis or moe:
        layer_apply = functools.partial(_decoder_layer_apply_tp,
                                        n_head=n_head, tp_axis=tp_axis,
                                        sp_axis=sp_axis, ep_axis=ep_axis,
                                        moe_top_k=moe_top_k,
                                        moe_cf=moe_cf)
    else:
        layer_apply = functools.partial(_decoder_layer_apply,
                                        n_head=n_head)
    if op.attr("recompute"):
        layer_apply = _recomputed(layer_apply)

    if moe:
        def stage_fn(stage_params, mb):
            h = mb
            aux = torch.zeros((), dtype=torch.float32, device=mb.device)
            for li in range(stage_params["wq"].shape[0]):
                h, aux_l = layer_apply(_layer(stage_params, li), h)
                aux = aux + aux_l.float()
            return h, aux
    else:
        def stage_fn(stage_params, mb):
            h = mb
            for li in range(stage_params["wq"].shape[0]):
                h = layer_apply(_layer(stage_params, li), h)
            return h

    x_in, x = x, _batch_whole(ctx.mesh, x)
    s = mesh.shape["pp"]
    schedule = str(op.attr("schedule", "") or "gpipe")
    # per-leaf spec tails: Megatron col/row tp shards for the dense
    # params, expert-dim ep shards for the MoE stacks (gate_w stays
    # replicated — routing needs every expert's logit)
    if tp_axis or ep_axis:
        def _tail(key, p):
            if key in ("w_up", "w_down"):
                return ((None, "ep") + (None,) * (p.dim() - 3)) \
                    if ep_axis else (None,) * (p.dim() - 1)
            if tp_axis and key in _TP_SPEC_TAILS:
                return _TP_SPEC_TAILS[key]
            return (None,) * (p.dim() - 1)

        param_specs = {k: _tail(k, p) for k, p in params.items()}
    else:
        param_specs = None
    # MoE token groups split over dp and ep jointly (each (dp, ep) member
    # routes its own token slice — the moe_gate_groups contract)
    if moe:
        batch_axes = tuple(a for a in ("dp", "ep")
                           if a in mesh.axis_names and mesh.shape[a] > 1)
        batch_axis = batch_axes or None
    else:
        batch_axis = _batch_axis(mesh)
    b = x.shape[0]
    if schedule == "interleaved":
        v_chunks = int(op.attr("virtual_stages", 0)) or n_layer // s
        if v_chunks < 1:
            raise ValueError(
                "pipeline_stack interleaved schedule needs at least one "
                "chunk per device: %d layers < pp=%d stages"
                % (n_layer, s))
        if n_layer % (s * v_chunks):
            raise ValueError(
                "pipeline_stack: %d layers not divisible into %d stages "
                "x %d virtual chunks" % (n_layer, s, v_chunks))
        per = n_layer // (s * v_chunks)
        if v_chunks % s == 0 and len(held) == len(params):
            # each stage's contiguous [L/S, ...] rows, the held blocks as
            # they are; the schedule's one all_to_all over pp gives
            # device d its chunks {d, d+S, ...}
            stacked = {k: _stacked(v, s, n_layer // s, held[k])
                       for k, v in params.items()}
        else:
            # device d holds global chunks {d, d+S, ...}: [L,...] ->
            # [V, S, per, ...] -> [S, V, per, ...], from the whole stack
            stacked = {
                k: _gathered(ctx.mesh, p, held[k]) if k in held else p
                for k, p in params.items()}
            stacked = {
                k: p.reshape((v_chunks, s, per) + tuple(p.shape[1:]))
                .transpose(0, 1)
                for k, p in stacked.items()}
        m = int(op.attr("num_microbatches", 0)) or min(s, b)
        if b % m:
            raise ValueError("pipeline_stack: batch %d not divisible by "
                             "%d microbatches" % (b, m))
        mb = x.reshape((m, b // m) + tuple(x.shape[1:]))
        if moe and (b // m) % gate_groups:
            raise ValueError(
                "pipeline_stack MoE: microbatch rows %d not divisible "
                "by moe_gate_groups=%d" % (b // m, gate_groups))
        out = pipeline.gpipe_interleaved(
            stage_fn, stacked, mb, mesh, v_chunks, axis_name="pp",
            batch_axis=batch_axis, param_specs=param_specs,
            seq_axis=sp_axis, with_aux=moe)
    else:
        if n_layer % s:
            raise ValueError("pipeline_stack: %d layers not divisible by "
                             "pp=%d stages" % (n_layer, s))
        per = n_layer // s
        stacked = {k: _stacked(v, s, per, held.get(k))
                   for k, v in params.items()}
        m = int(op.attr("num_microbatches", 0)) or 2 * s
        if b % m:
            raise ValueError("pipeline_stack: batch %d not divisible by "
                             "%d microbatches" % (b, m))
        mb = x.reshape((m, b // m) + tuple(x.shape[1:]))
        if moe and (b // m) % gate_groups:
            raise ValueError(
                "pipeline_stack MoE: microbatch rows %d not divisible "
                "by moe_gate_groups=%d" % (b // m, gate_groups))
        out = pipeline.gpipe(stage_fn, stacked, mb, mesh, axis_name="pp",
                             batch_axis=batch_axis,
                             param_specs=param_specs, seq_axis=sp_axis,
                             with_aux=moe)
    if moe:
        out, aux = out
        if op.output("AuxLoss"):
            ctx.set_out(op, "AuxLoss", aux)
    out = _batch_whole(ctx.mesh, out, 1).reshape(x.shape)
    ctx.set_out(op, "Out", _batch_like(ctx.mesh, out, x_in))
