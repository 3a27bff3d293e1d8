"""Tensor manipulation and creation ops.

The counterpart of ``paddle_tpu/ops/tensor_ops.py`` for the types the
flagship LM's programs use: fill_constant, assign_value, reshape,
transpose, expand, uniform_random, gaussian_random and lookup_table.

Random ops draw from the run's ``torch.Generator`` (``ctx.rng()``), in
program order. Index tensors arrive as int32 (64-bit feeds are narrowed
as in the JAX package); torch indexing wants int64, so lowerings widen
them where they index, never in the scope.
"""

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
    shape = op.attr("shape")
    dtype = np.dtype(runtime_dtype(op.attr("dtype", "float32")))
    values = op.attr("values")
    if isinstance(values, np.ndarray):
        arr = values.astype(dtype)
    else:
        arr = np.array(values, dtype=dtype)
    ctx.set_out(op, "Out", torch.from_numpy(
        np.ascontiguousarray(arr.reshape(shape))).to(ctx.device))


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


@register("uniform_random")
def _uniform_random(ctx, op):
    shape = tuple(op.attr("shape"))
    dtype = torch_dtype(op.attr("dtype", "float32"))
    lo = op.attr("min", -1.0)
    hi = op.attr("max", 1.0)
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.uniform_(lo, hi, generator=ctx.rng())
    ctx.set_out(op, "Out", out.to(dtype))


@register("gaussian_random")
def _gaussian_random(ctx, op):
    shape = tuple(op.attr("shape"))
    dtype = torch_dtype(op.attr("dtype", "float32"))
    mean = op.attr("mean", 0.0)
    std = op.attr("std", 1.0)
    out = mean + std * torch.randn(shape, generator=ctx.rng(),
                                   dtype=torch.float32, device=ctx.device)
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
