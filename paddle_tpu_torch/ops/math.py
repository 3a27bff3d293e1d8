"""Core math ops: mul, matmul, sum, mean, scale, clip, clip_by_norm,
reduce_sum, top_k.

The counterpart of ``paddle_tpu/ops/math.py`` for the types the flagship
LM and the ResNet models use. The products are plain ``torch.matmul``
(cuBLAS on the card), as the JAX package leaves them to XLA; fp32 stays
fp32 as long as TF32 is off (``torch.backends.cuda.matmul.allow_tf32``,
False by default).
"""

import functools

import torch

from ..core.registry import register
from ..core.scope import torch_dtype


def _flatten2d(x, num_col_dims):
    lead = 1
    for s in x.shape[:num_col_dims]:
        lead *= s
    return x.reshape(lead, -1), tuple(x.shape)


@register("mul")
def _mul(ctx, op):
    """mul_op.cc: X flattened to 2-D at ``x_num_col_dims`` ([B, T, D] ->
    [B*T, D] for the LM's fc layers), Y at ``y_num_col_dims``, and the
    product reshaped back to X's leading dims + Y's trailing dims."""
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    x2, xshape = _flatten2d(x, xn)
    y2 = y.reshape(functools.reduce(lambda a, b: a * b, y.shape[:yn], 1), -1)
    out = torch.matmul(x2, y2)
    ctx.set_out(op, "Out", out.reshape(xshape[:xn] + tuple(y.shape[yn:])))


@register("matmul")
def _matmul(ctx, op):
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    if op.attr("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if op.attr("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = op.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set_out(op, "Out", out)


@register("sum")
def _sum(ctx, op):
    """The elementwise sum of the X list, added left to right."""
    xs = ctx.in_list(op, "X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set_out(op, "Out", out)


@register("mean")
def _mean(ctx, op):
    """Mean over every element (LoD feeds, whose padded rows the JAX
    package masks out here, raise in the Executor)."""
    ctx.set_out(op, "Out", torch.mean(ctx.in1(op, "X")))


@register("scale")
def _scale(ctx, op):
    x = ctx.in1(op, "X")
    scale = op.attr("scale", 1.0)
    bias = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.set_out(op, "Out", out)


@register("clip")
def _clip(ctx, op):
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Out", torch.clamp(x, op.attr("min", -1.0),
                                       op.attr("max", 1.0)))


@register("clip_by_norm")
def _clip_by_norm(ctx, op):
    """X scaled by max_norm / ||X||_2 where its norm exceeds max_norm."""
    x = ctx.in1(op, "X")
    max_norm = op.attr("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    ctx.set_out(op, "Out", torch.where(norm > max_norm,
                                       x * (max_norm / norm), x))


@register("reduce_sum")
def _reduce_sum(ctx, op):
    x = ctx.in1(op, "X")
    if op.attr("reduce_all", False):
        axes = tuple(range(x.dim()))
    else:
        dim = op.attr("dim", [0])
        if isinstance(dim, int):
            dim = [dim]
        axes = tuple(d % x.dim() for d in dim)
    ctx.set_out(op, "Out", torch.sum(x, dim=axes,
                                     keepdim=op.attr("keep_dim", False)))


@register("top_k")
def _top_k(ctx, op):
    """The k largest along the last axis, largest first; indices narrowed
    to int32 as the port holds int64 (``torch_dtype``)."""
    vals, idx = torch.topk(ctx.in1(op, "X"), op.attr("k", 1), dim=-1)
    ctx.set_out(op, "Out", vals)
    ctx.set_out(op, "Indices", idx.to(torch_dtype("int64")))
