"""Tensor manipulation and creation ops.

The counterpart of ``paddle_tpu/ops/tensor_ops.py`` for the types the
flagship LM's, the mnist models' and VGG's programs use: fill_constant,
assign_value, cast, split, reshape, transpose, expand, one_hot,
label_smooth, uniform_random, gaussian_random, truncated_gaussian_random
and lookup_table.

Random ops (``stateful_rng``) draw from the run's ``torch.Generator``
(``ctx.rng()``), in program order. Index tensors arrive as int32 (64-bit feeds are narrowed
as in the JAX package); torch indexing wants int64, so lowerings widen
them where they index, never in the scope.
"""

import math

import numpy as np
import torch

from ..core.program import runtime_dtype
from ..core.registry import register
from ..core.scope import torch_dtype


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
    ctx.set_out(op, "Out", x.reshape(shape))


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


@register("uniform_random", stateful_rng=True)
def _uniform_random(ctx, op):
    shape = tuple(op.attr("shape"))
    dtype = torch_dtype(op.attr("dtype", "float32"))
    lo = op.attr("min", -1.0)
    hi = op.attr("max", 1.0)
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.uniform_(lo, hi, generator=ctx.rng())
    ctx.set_out(op, "Out", out.to(dtype))


@register("gaussian_random", stateful_rng=True)
def _gaussian_random(ctx, op):
    shape = tuple(op.attr("shape"))
    dtype = torch_dtype(op.attr("dtype", "float32"))
    mean = op.attr("mean", 0.0)
    std = op.attr("std", 1.0)
    out = mean + std * torch.randn(shape, generator=ctx.rng(),
                                   dtype=torch.float32, device=ctx.device)
    ctx.set_out(op, "Out", out.to(dtype))


@register("truncated_gaussian_random", stateful_rng=True)
def _truncated_gaussian_random(ctx, op):
    """mean + std * a standard normal truncated to [-2, 2] (as
    ``jax.random.truncated_normal(key, -2, 2)``), by the inverse CDF of
    a uniform drawn between the two tails' masses."""
    shape = tuple(op.attr("shape"))
    dtype = torch_dtype(op.attr("dtype", "float32"))
    mean = op.attr("mean", 0.0)
    std = op.attr("std", 1.0)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    u.uniform_(lo, 1.0 - lo, generator=ctx.rng())
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    out = mean + std * torch.clamp(z, -2.0, 2.0)
    ctx.set_out(op, "Out", out.to(dtype))


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
    idx = torch.clamp(ids.long(), 0, w.shape[0] - 1)
    out = w[idx]
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    ctx.set_out(op, "Out", out)
