"""Core math ops: mul, matmul, sum, mean, scale, clip, clip_by_norm, the
reductions (sum, mean, max, min, prod), cumsum, the norms and distances,
cos_sim, bilinear_tensor_product, top_k, arg_max, arg_min, minus and
conv_shift.

The counterpart of ``paddle_tpu/ops/math.py``. The products are plain ``torch.matmul``
(cuBLAS on the card), as the JAX package leaves them to XLA; fp32 stays
fp32 as long as TF32 is off (``torch.backends.cuda.matmul.allow_tf32``,
False by default).
"""

import functools

import torch

from ..core.registry import register
from ..core.scope import torch_dtype
from .common import lod_valid_mask, reshape


def _flatten2d(x, num_col_dims):
    lead = 1
    for s in x.shape[:num_col_dims]:
        lead *= s
    return reshape(x, (lead, -1)), tuple(x.shape)


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
    ctx.set_out(op, "Out", reshape(out, xshape[:xn] + tuple(y.shape[yn:])))


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
    """Mean over every element; over a bucketed LoD input, over the
    real rows only."""
    x = ctx.in1(op, "X")
    out = _masked_mean(ctx, op, x, None, False)
    ctx.set_out(op, "Out", torch.mean(x) if out is None else out)


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


def _axes(op, x):
    """The reduced axes of a reduce op (None: all of them)."""
    if op.attr("reduce_all", False):
        return None
    dim = op.attr("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    return tuple(d % x.dim() for d in dim)


def _prod(x, dim=None, keepdim=False):
    """torch.prod over several axes, one at a time from the last."""
    if dim is None:
        out = torch.prod(x)
        return out.reshape((1,) * x.dim()) if keepdim else out
    for a in sorted(dim, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


def _all_axes(fn):
    """``fn`` over ``dim``, or over every axis when it is None."""
    def reduce(x, dim=None, keepdim=False):
        return fn(x, dim=tuple(range(x.dim())) if dim is None else dim,
                  keepdim=keepdim)
    return reduce


def _mean(x, dim, keepdim):
    """jnp.mean: an integer input averages as float32."""
    return torch.mean(x if x.is_floating_point() else x.float(), dim=dim,
                      keepdim=keepdim)


def _row_mask(valid, x):
    return valid.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def _fill_value(fill, dtype):
    """The neutral element of a reduction in ``dtype``: 'min' and 'max'
    are the dtype's extremes (-inf / inf for floats), so an integer
    reduction stays integer."""
    if fill in ("min", "max"):
        if dtype.is_floating_point:
            return float("-inf") if fill == "min" else float("inf")
        info = torch.iinfo(dtype)
        return info.min if fill == "min" else info.max
    return fill


def _masked_rows(ctx, op, x, fill=0):
    """x with the bucket's pad rows replaced by the neutral ``fill`` (x
    itself when the input carries no LoD)."""
    valid, _ = lod_valid_mask(ctx, op)
    if valid is None:
        return x
    return torch.where(_row_mask(valid, x), x, _fill_value(fill, x.dtype))


def _masked_mean(ctx, op, x, axes, keep):
    """The mean over the REAL rows of a bucketed LoD input (None when
    the input carries no LoD and the plain mean applies)."""
    valid, n_valid = lod_valid_mask(ctx, op)
    if valid is None:
        return None
    red = tuple(range(x.dim())) if axes is None else axes
    other = 1
    for a in red:
        if a != 0:
            other *= x.shape[a]
    s = torch.sum(torch.where(_row_mask(valid, x), x, torch.zeros_like(x)),
                  dim=red, keepdim=keep)
    acc = x.dtype if x.is_floating_point() else torch.float32
    return s / (n_valid.to(acc) * other)


def _reduce(fn, fill=None):
    """A reduce op over ``dim`` (or every axis with ``reduce_all``),
    keeping the reduced axes with ``keep_dim``, in X's dtype (the mean
    of integers is float32). Over a bucketed LoD input, a reduction of
    the row axis neutralizes the pad rows first (sum: 0, max/min: the
    dtype's extremes, prod: 1; the mean divides by the real rows)."""
    def lower(ctx, op):
        x = ctx.in1(op, "X")
        axes = _axes(op, x)
        keep = op.attr("keep_dim", False)
        if axes is None or 0 in axes:
            if fill is None:
                out = _masked_mean(ctx, op, x, axes, keep)
                if out is not None:
                    ctx.set_out(op, "Out", out)
                    return
            else:
                x = _masked_rows(ctx, op, x, fill)
        out = fn(x, dim=axes, keepdim=keep)
        if out.is_floating_point() == x.is_floating_point():
            out = out.to(x.dtype)        # an integer sum stays int32
        ctx.set_out(op, "Out", out)
    return lower


register("reduce_sum", _reduce(_all_axes(torch.sum), fill=0))
register("reduce_mean", _reduce(_all_axes(_mean)))
register("reduce_max", _reduce(_all_axes(torch.amax), fill="min"))
register("reduce_min", _reduce(_all_axes(torch.amin), fill="max"))
register("reduce_prod", _reduce(_prod, fill=1))


@register("cumsum")
def _cumsum(ctx, op):
    """Inclusive prefix sums along ``axis``; ``reverse`` sums from the
    end; ``exclusive`` then takes X off (the JAX package's order)."""
    x = ctx.in1(op, "X")
    axis = op.attr("axis", -1)
    if op.attr("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(x, dim=axis)
    if op.attr("exclusive", False):
        out = out - x
    ctx.set_out(op, "Out", out)


@register("l1_norm")
def _l1_norm(ctx, op):
    x = _masked_rows(ctx, op, ctx.in1(op, "X"))
    ctx.set_out(op, "Out", torch.sum(torch.abs(x)))


@register("squared_l2_norm")
def _squared_l2_norm(ctx, op):
    x = _masked_rows(ctx, op, ctx.in1(op, "X"))
    ctx.set_out(op, "Out", torch.sum(torch.square(x)))


@register("squared_l2_distance")
def _squared_l2_distance(ctx, op):
    d = ctx.in1(op, "X") - ctx.in1(op, "Y")
    ctx.set_out(op, "sub_result", d)
    ctx.set_out(op, "Out", torch.sum(torch.square(d), dim=-1, keepdim=True))


@register("norm")
def _norm(ctx, op):
    """X over its L2 norm along ``axis``, eps inside the square root."""
    x = ctx.in1(op, "X")
    norm = torch.sqrt(torch.sum(torch.square(x), dim=op.attr("axis", 1),
                                keepdim=True) + op.attr("epsilon", 1e-10))
    ctx.set_out(op, "Norm", norm)
    ctx.set_out(op, "Out", x / norm)


@register("cos_sim")
def _cos_sim(ctx, op):
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + 1e-12)
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "XNorm", xn)
    ctx.set_out(op, "YNorm", yn)


@register("bilinear_tensor_product")
def _bilinear(ctx, op):
    """out[b, o] = x[b] W[o] y[b] (+ Bias)."""
    x = ctx.in1(op, "X")          # [B, M]
    y = ctx.in1(op, "Y")          # [B, N]
    w = ctx.in1(op, "Weight")     # [O, M, N]
    out = torch.einsum("bm,omn,bn->bo", x, w, y)
    b = ctx.in1(op, "Bias")
    if b is not None:
        out = out + b
    ctx.set_out(op, "Out", out)


@register("top_k")
def _top_k(ctx, op):
    """The k largest along the last axis, largest first; indices narrowed
    to int32 as the port holds int64 (``torch_dtype``)."""
    vals, idx = torch.topk(ctx.in1(op, "X"), op.attr("k", 1), dim=-1)
    ctx.set_out(op, "Out", vals)
    ctx.set_out(op, "Indices", idx.to(torch_dtype("int64")))


def _arg(fn):
    """arg_max / arg_min along ``axis``: the first index on a tie (as
    jnp.argmax and torch.argmax), int64 narrowed to int32."""
    def lower(ctx, op):
        ctx.set_out(op, "Out", fn(ctx.in1(op, "X"),
                                  dim=op.attr("axis", -1)).to(
            torch_dtype("int64")))
    return lower


register("arg_max", _arg(torch.argmax))
register("arg_min", _arg(torch.argmin))


@register("minus")
def _minus(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X") - ctx.in1(op, "Y"))


@register("conv_shift")
def _conv_shift(ctx, op):
    """Circular correlation (operators/conv_shift_op.cc): out[b, m] =
    sum_n x[b, (m + n - N//2) mod M] y[b, n]."""
    x = ctx.in1(op, "X")          # [B, M]
    y = ctx.in1(op, "Y")          # [B, N], N odd, N <= M
    m = x.shape[1]
    half = y.shape[1] // 2
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(-half, half + 1, device=x.device)[None, :]) % m
    ctx.set_out(op, "Out", torch.einsum("bmn,bn->bm", x[:, idx], y))
