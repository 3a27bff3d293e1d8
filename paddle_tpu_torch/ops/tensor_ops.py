"""Tensor manipulation and creation ops.

The counterpart of ``paddle_tpu/ops/tensor_ops.py``, every type of it:
the fills, assign and assign_value, cast, concat, split, reshape,
squeeze, unsqueeze, transpose, expand, stack, unstack, gather, scatter,
one_hot, the random draws (also ``*_batch_size_like``), lookup_table,
pad, pad_constant_like, crop, slice, shape, increment, multiplex,
label_smooth, is_empty, range, linspace, sequence_mask, delete_var and
print.

``shape`` and ``is_empty`` depend only on shapes: like ``assign_value``'s
temporaries, their values are made on the device once per op and shape
and kept by the executor, so a CUDA graph holds no host-to-device copy.
``range`` and ``print`` read the host, and raise inside a CUDA graph
capture (``Executor.run_steps`` on the card).

Random ops (``stateful_rng``) draw counter-keyed Philox words
(``core/philox.py``) from the run's seed and the op's key
(``ctx.draw_key(op)``), so a ``run_steps`` graph draws what K ``run()``
calls draw and the card gives the CPU's words. Index tensors arrive as
int32 (64-bit feeds are narrowed as in the JAX package); torch indexing
wants int64, so lowerings widen them where they index, never in the
scope. Under ``ParallelExecutor`` ``lookup_table`` gathers on each
rank's block of ids through ``parallel._shard_map`` (``parallel/mesh.py``
lists why).
"""

import math

import numpy as np
import torch

from ..core import philox
from ..core.program import runtime_dtype
from ..core.registry import register
from ..core.scope import torch_dtype
from . import common


@register("fill_constant")
def _fill_constant(ctx, op):
    shape = op.attr("shape", [1])
    dtype = torch_dtype(op.attr("dtype", "float32"))
    value = op.attr("value", 0.0)
    ctx.set_out(op, "Out", torch.full(tuple(shape), value, dtype=dtype,
                                      device=ctx.device))


@register("assign_value")
def _assign_value(ctx, op):
    """A constant from the op's ``values``. A temporary (not persistable)
    one is made on the device once per op and kept by the executor for
    its later runs (``Executor.constants``): no lowering writes a tensor
    in place, and a CUDA graph cannot hold the host-to-device copy that
    would make it again every step (the composed attention's causal bias
    is one). A persistable one (an initializer's) is made anew, as the
    scope will own it."""
    shape = op.attr("shape")
    dtype = np.dtype(runtime_dtype(op.attr("dtype", "float32")))
    values = op.attr("values")
    out = ctx.out_name(op, "Out")
    var = ctx.block._find_var_recursive(out) \
        if ctx.block is not None and out is not None else None
    kept = getattr(ctx.executor, "constants", None)
    made = kept.setdefault(op, {}) \
        if kept is not None and var is not None and not var.persistable \
        else {}
    key = (tuple(shape), dtype.str)
    hit = made.get(key)
    if hit is None or hit[0] is not values:
        if isinstance(values, np.ndarray):
            arr = values.astype(dtype)
        else:
            arr = np.array(values, dtype=dtype)
        hit = made[key] = (values, torch.from_numpy(
            np.ascontiguousarray(arr.reshape(shape))).to(ctx.device))
    ctx.set_out(op, "Out", hit[1])


@register("fill_constant_batch_size_like")
def _fill_cbsl(ctx, op):
    ctx.set_out(op, "Out", torch.full(
        _batch_shape(ctx, op), op.attr("value", 0.0),
        dtype=torch_dtype(op.attr("dtype", "float32")), device=ctx.device))


@register("fill_zeros_like")
def _fill_zeros_like(ctx, op):
    ctx.set_out(op, "Out", torch.zeros_like(ctx.in1(op, "X")))


@register("fill_any_like")
def _fill_any_like(ctx, op):
    ctx.set_out(op, "Out", torch.full_like(ctx.in1(op, "X"),
                                           op.attr("value", 0.0)))


@register("assign")
def _assign(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X"))


def kept(ctx, op, key, make):
    """The tensors of ``make()`` (host arrays or tensors) on the device,
    made once per op and ``key`` and kept by the executor
    (``assign_value``'s rule for temporaries): a CUDA graph cannot hold
    the host-to-device copy that would make them again every step."""
    held = getattr(ctx.executor, "constants", None)
    made = held.setdefault(op, {}) if held is not None else {}
    hit = made.get(key)
    if hit is None:
        hit = made[key] = tuple(torch.as_tensor(a).to(ctx.device)
                                for a in make())
    return hit


def _kept(ctx, op, value, dtype):
    """``value`` (host numbers) as a device tensor of ``dtype``, kept
    once per op and value (``kept``)."""
    key = (tuple(np.asarray(value).reshape(-1).tolist()),
           np.shape(value), str(dtype))
    return kept(ctx, op, key, lambda: [
        torch.as_tensor(np.asarray(value), dtype=dtype)])[0]


def _refuse_in_capture(what):
    if torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing():
        raise NotImplementedError(
            "%s reads the host and cannot run inside a CUDA graph "
            "(Executor.run_steps on the card); use run() per step" % what)


@register("cast")
def _cast(ctx, op):
    """X as ``out_dtype`` (64-bit narrowed, as every runtime dtype). A
    uint8 feed stays uint8 up to here (``to_tensor``), as in the JAX
    package; float to integer truncates toward zero in both."""
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Out", x.to(torch_dtype(op.attr("out_dtype"))))


@register("split")
def _split(ctx, op):
    """X cut along ``axis`` into ``sections`` sizes, or ``num`` equal
    parts."""
    x = ctx.in1(op, "X")
    axis = op.attr("axis", 0)
    sections = op.attr("sections")
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        outs = torch.chunk(x, op.attr("num", 0), dim=axis)
    for name, val in zip(op.output("Out"), outs):
        ctx.env[name] = val


@register("reshape")
@register("reshape2")
def _reshape(ctx, op):
    x = ctx.in1(op, "X")
    shape = list(op.attr("shape"))
    # reference: 0 means copy input dim at that position
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    ctx.set_out(op, "Out", common.reshape(x, shape))


@register("transpose")
@register("transpose2")
def _transpose(ctx, op):
    # a strided view: consumers that need contiguous memory copy it
    ctx.set_out(op, "Out", ctx.in1(op, "X").permute(*op.attr("axis")))


@register("expand")
def _expand(ctx, op):
    x = ctx.in1(op, "X")
    times = op.attr("expand_times")
    # jnp.tile semantics: repeat each axis; extra leading times prepend
    ctx.set_out(op, "Out", x.repeat(*times))


@register("one_hot")
def _one_hot(ctx, op):
    """float32 [..., depth] rows (a trailing 1 dim of X dropped), as
    ``jax.nn.one_hot``: an index outside [0, depth) gives a zero row."""
    x = ctx.in1(op, "X")
    depth = op.attr("depth")
    if x.dim() and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    classes = torch.arange(depth, dtype=torch.int64, device=x.device)
    ctx.set_out(op, "Out", (x.long()[..., None] == classes).float())


@register("label_smooth")
def _label_smooth(ctx, op):
    """(1 - eps) X + eps PriorDist, or eps / K without a prior."""
    x = ctx.in1(op, "X")
    eps = op.attr("epsilon", 0.0)
    dist = ctx.in1(op, "PriorDist")
    if dist is not None:
        out = (1 - eps) * x + eps * dist
    else:
        out = (1 - eps) * x + eps / x.shape[-1]
    ctx.set_out(op, "Out", out)


def _batch_shape(ctx, op):
    """The op's ``shape``, with ``output_dim_idx`` taken from the
    ``Input`` reference's ``input_dim_idx`` where there is one (the
    ``*_batch_size_like`` forms)."""
    shape = list(op.attr("shape"))
    ref = ctx.maybe_get(op.input("Input")[0]) if op.input("Input") else None
    if ref is not None:
        shape[op.attr("output_dim_idx", 0)] = \
            ref.shape[op.attr("input_dim_idx", 0)]
    return tuple(shape)


def _draw(ctx, op, n):
    """The n Philox words of random op ``op``'s draw in this run, keyed by
    the run's seed and the op's key (``LowerContext.draw_key``)."""
    seed, key = ctx.draw_key(op)
    return philox.words(n, seed, key, ctx.device)


@register("uniform_random", stateful_rng=True)
@register("uniform_random_batch_size_like", stateful_rng=True)
def _uniform_random(ctx, op):
    """min + (max - min) * u, u the top 24 bits of a word over 2**24, in
    float64 rounded once to float32 (so the CPU and the card agree bit
    for bit)."""
    shape = _batch_shape(ctx, op)
    dtype = torch_dtype(op.attr("dtype", "float32"))
    lo = op.attr("min", -1.0)
    hi = op.attr("max", 1.0)
    u = philox.unit24(_draw(ctx, op, math.prod(shape)))
    out = u.mul_(hi - lo).add_(lo).to(torch.float32).reshape(shape)
    ctx.set_out(op, "Out", out.to(dtype))


@register("gaussian_random", stateful_rng=True)
@register("gaussian_random_batch_size_like", stateful_rng=True)
def _gaussian_random(ctx, op):
    """mean + std * z, z standard normals by Box-Muller over word pairs:
    words 2j and 2j+1 give values 2j (the cosine) and 2j+1 (the sine),
    in float64 rounded once to float32."""
    shape = _batch_shape(ctx, op)
    dtype = torch_dtype(op.attr("dtype", "float32"))
    mean = op.attr("mean", 0.0)
    std = op.attr("std", 1.0)
    n = math.prod(shape)
    u = philox.unit24(_draw(ctx, op, n + n % 2)).reshape(-1, 2)
    # in place where a value is made: the same roundings, fewer buffers
    r = u[:, 0].neg().log1p_().mul_(-2.0).sqrt_()  # log of 1 - u in (0, 1]
    theta = u[:, 1].mul(2.0 * math.pi)
    z = torch.empty_like(u)
    torch.cos(theta, out=z[:, 0])
    torch.sin(theta, out=z[:, 1])
    z = z.mul_(r[:, None]).view(-1)[:n]
    out = z.mul_(std).add_(mean).to(torch.float32).reshape(shape)
    ctx.set_out(op, "Out", out.to(dtype))


@register("truncated_gaussian_random", stateful_rng=True)
def _truncated_gaussian_random(ctx, op):
    """mean + std * a standard normal truncated to [-2, 2] (as
    ``jax.random.truncated_normal(key, -2, 2)``), by the inverse CDF of
    a uniform between the two tails' masses, in float64 rounded once to
    float32."""
    shape = tuple(op.attr("shape"))
    dtype = torch_dtype(op.attr("dtype", "float32"))
    mean = op.attr("mean", 0.0)
    std = op.attr("std", 1.0)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = philox.unit24(_draw(ctx, op, math.prod(shape)))
    u = u.mul_(1.0 - 2.0 * lo).add_(lo)
    z = u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0))
    out = z.clamp_(-2.0, 2.0).mul_(std).add_(mean).to(torch.float32)
    ctx.set_out(op, "Out", out.reshape(shape).to(dtype))


@register("lookup_table")
def _lookup_table(ctx, op):
    """Embedding lookup (operators/lookup_table_op.cc). ids may have a
    trailing 1 dim (reference convention); ids out of range are clipped
    into it, as jnp.take's clip mode does; padding_idx rows read as
    zero."""
    w = ctx.in1(op, "W")
    ids = ctx.in1(op, "Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    padding_idx = op.attr("padding_idx", -1)
    if hasattr(w, "placements") or hasattr(ids, "placements"):
        # DTensors (ParallelExecutor): the gather and its index_put
        # gradient on each rank's block of ids as it is laid out (the
        # batch on dp, the sequence on sp), the table whole
        # (parallel/mesh.py lists why)
        from ..parallel._shard_map import shard_map, spec_of
        from ..parallel.mesh import PartitionSpec as P
        if hasattr(ids, "placements"):
            spec = spec_of(ctx.mesh, ids)
        else:
            spec = P("dp" if "dp" in ctx.mesh.axis_names else None)
        out = shard_map(lambda w_, i_: _rows(w_, i_, padding_idx),
                        mesh=ctx.mesh, in_specs=(P(), spec),
                        out_specs=spec)(w, ids)
    else:
        out = _rows(w, ids, padding_idx)
    ctx.set_out(op, "Out", out)


def _rows(w, ids, padding_idx):
    idx = torch.clamp(ids.long(), 0, w.shape[0] - 1)
    out = w[idx]
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


@register("concat")
def _concat(ctx, op):
    ctx.set_out(op, "Out", torch.cat(ctx.in_list(op, "X"),
                                     dim=op.attr("axis", 0)))


@register("squeeze")
def _squeeze(ctx, op):
    x = ctx.in1(op, "X")
    axes = op.attr("axes", [])
    if axes:
        for a in axes:
            if x.shape[a] != 1:
                raise ValueError(
                    "squeeze: axis %d of a %s input is not 1"
                    % (a, tuple(x.shape)))
        ctx.set_out(op, "Out", torch.squeeze(x, dim=tuple(axes)))
    else:
        ctx.set_out(op, "Out", torch.squeeze(x))


@register("unsqueeze")
def _unsqueeze(ctx, op):
    x = ctx.in1(op, "X")
    for a in sorted(op.attr("axes", [])):
        x = torch.unsqueeze(x, a)
    ctx.set_out(op, "Out", x)


@register("stack")
def _stack(ctx, op):
    ctx.set_out(op, "Y", torch.stack(ctx.in_list(op, "X"),
                                     dim=op.attr("axis", 0)))


@register("unstack")
def _unstack(ctx, op):
    outs = torch.unbind(ctx.in1(op, "X"), dim=op.attr("axis", 0))
    for name, val in zip(op.output("Y"), outs):
        ctx.env[name] = val


@register("gather")
def _gather(ctx, op):
    """Rows of X at Index (axis 0)."""
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Out", x[ctx.in1(op, "Index").long()])


@register("scatter")
def _scatter(ctx, op):
    """X with the rows at Ids set to Updates (``overwrite``) or added
    to them; a new tensor, as ``.at[].set/add``."""
    x = ctx.in1(op, "X")
    idx = ctx.in1(op, "Ids").long()
    upd = ctx.in1(op, "Updates")
    ctx.set_out(op, "Out", x.index_put(
        (idx,), upd, accumulate=not op.attr("overwrite", True)))


@register("pad")
def _pad(ctx, op):
    """X padded by ``paddings`` = [before0, after0, before1, ...] with
    ``pad_value``."""
    x = ctx.in1(op, "X")
    p = op.attr("paddings")
    flat = []
    for i in reversed(range(x.dim())):       # F.pad: last axis first
        flat += [int(p[2 * i]), int(p[2 * i + 1])]
    ctx.set_out(op, "Out", torch.nn.functional.pad(
        x, flat, value=op.attr("pad_value", 0.0)))


@register("pad_constant_like")
def _pad_constant_like(ctx, op):
    """Y padded at the end of each axis to X's shape."""
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    flat = []
    for i in reversed(range(y.dim())):
        flat += [0, int(x.shape[i] - y.shape[i])]
    ctx.set_out(op, "Out", torch.nn.functional.pad(
        y, flat, value=op.attr("pad_value", 0.0)))


@register("crop")
def _crop(ctx, op):
    x = ctx.in1(op, "X")
    slices = tuple(slice(o, o + s) for o, s in
                   zip(op.attr("offsets"), op.attr("shape")))
    ctx.set_out(op, "Out", x[slices])


@register("slice")
def _slice(ctx, op):
    x = ctx.in1(op, "Input")
    slices = [slice(None)] * x.dim()
    for a, s, e in zip(op.attr("axes"), op.attr("starts"), op.attr("ends")):
        slices[a] = slice(s, e)
    ctx.set_out(op, "Out", x[tuple(slices)])


@register("shape")
def _shape(ctx, op):
    x = ctx.in1(op, "Input")
    ctx.set_out(op, "Out", _kept(ctx, op, list(x.shape),
                                 torch_dtype("int64")))


@register("increment")
def _increment(ctx, op):
    """X + step in X's dtype (an integer counter stays integer)."""
    x = ctx.in1(op, "X")
    step = op.attr("step", 1.0)
    ctx.set_out(op, "Out", x + (step if x.is_floating_point()
                                else int(step)))


@register("multiplex")
def _multiplex(ctx, op):
    """Row b of the output is row b of X[Ids[b]]."""
    ids = ctx.in1(op, "Ids").long().reshape(-1)
    xs = torch.stack(ctx.in_list(op, "X"), dim=0)   # [K, B, ...]
    ctx.set_out(op, "Out", xs[ids, torch.arange(xs.shape[1],
                                                device=xs.device)])


@register("is_empty")
def _is_empty(ctx, op):
    ctx.set_out(op, "Out", _kept(ctx, op, ctx.in1(op, "X").numel() == 0,
                                 torch.bool))


@register("range")
def _range(ctx, op):
    """float32 arange(Start, End, Step): the three are read on the host
    (the JAX package needs them as trace-time constants too)."""
    _refuse_in_capture("the range op")
    start, end, step = (float(ctx.in1(op, s).reshape(-1)[0])
                        for s in ("Start", "End", "Step"))
    ctx.set_out(op, "Out", torch.arange(start, end, step,
                                        dtype=torch.float32,
                                        device=ctx.device))


@register("linspace")
def _linspace(ctx, op):
    ctx.set_out(op, "Out", torch.linspace(
        op.attr("start"), op.attr("stop"), op.attr("num"),
        dtype=torch.float32, device=ctx.device))


@register("sequence_mask")
def _sequence_mask(ctx, op):
    """Y[..., j] = j < X[...], for j < ``maxlen`` (or ``static_maxlen``)."""
    x = ctx.in1(op, "X")
    maxlen = op.attr("maxlen", -1)
    if maxlen is None or maxlen < 0:
        maxlen = op.attr("static_maxlen")
    dtype = torch_dtype(op.attr("out_dtype", "float32"))
    mask = (torch.arange(maxlen, device=x.device)[None, :]
            < x.reshape(-1, 1)).to(dtype)
    ctx.set_out(op, "Y", mask.reshape(tuple(x.shape) + (maxlen,)))


@register("delete_var")
def _delete_var(ctx, op):
    for n in op.input("X"):
        ctx.env.pop(n, None)


@register("print")
def _print(ctx, op):
    """Prints ``message`` and In on the host; Out is In."""
    _refuse_in_capture("the print op")
    x = ctx.in1(op, "In")
    print(op.attr("message", "") + " " + str(x.detach().cpu().numpy()))
    ctx.set_out(op, "Out", x)
