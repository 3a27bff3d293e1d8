"""NN ops: dropout, softmax, log_softmax, sequence_softmax, batch_norm,
layer_norm, lrn, maxout and im2sequence (the counterpart of
``paddle_tpu/ops/nn.py``)."""

import torch
import torch.nn.functional as F

from ..core.registry import register
from . import dropout as _dropout_kernel
from .sequence_ops import segment_sum, segments, take_rows


@register("dropout", stateful_rng=True)
def _dropout(ctx, op):
    """operators/dropout_op.cc, as the JAX package lowers it: with
    ``is_test`` (or p = 0) Out is x, times 1 - p for
    ``downgrade_in_infer``; in training Out = x * mask, times the f32
    reciprocal of 1 - p for ``upscale_in_train``. The mask is the port's counter-keyed draw
    (``ops/dropout.py``: the CUDA kernel on the card), keyed by the run's
    seed and the op's key; Mask is made only when something reads it."""
    x = ctx.in1(op, "X")
    p = op.attr("dropout_prob", 0.5)
    is_test = op.attr("is_test", False) or ctx.is_test
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    mask_name = ctx.out_name(op, "Mask")
    if is_test or p == 0.0:
        # downgrade_in_infer scales at inference time (reference default)
        out = x * (1.0 - p) if (impl == "downgrade_in_infer" and p > 0.0) \
            else x
        ctx.set_out(op, "Out", out)
        if ctx.is_read(mask_name):
            ctx.set(mask_name, torch.ones_like(x))
        return
    seed, key = ctx.draw_key(op)
    out, mask = _dropout_kernel.dropout(
        x, seed, key, p, scale=impl == "upscale_in_train",
        want_mask=ctx.is_read(mask_name))
    ctx.set_out(op, "Out", out)
    if mask is not None:
        ctx.set(mask_name, mask)


@register("batch_norm")
def _batch_norm(ctx, op):
    """Batch norm over every axis but the channel's, in train mode (batch
    statistics, running statistics updated) or with ``is_test`` (running
    statistics). Train mode takes the shifted one-pass sums centred on
    the running mean c (var = E[(x-c)^2] - (E[x-c])^2, exact for any c and
    stable with c near the true mean), either from a producing 1x1 conv's
    ``@BNSTATS`` stash (ops/conv.py, popped so no later run sees it) or
    from its own f32 pass over x. The running statistics are written
    detached under MeanOut/VarianceOut and the Mean/Variance names; the
    normalisation is one per-channel FMA in x's dtype."""
    x = ctx.in1(op, "X")
    scale = ctx.in1(op, "Scale")
    bias = ctx.in1(op, "Bias")
    mean_in = ctx.in1(op, "Mean")
    var_in = ctx.in1(op, "Variance")
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    layout = op.attr("data_layout", "NCHW")
    is_test = op.attr("is_test", False) or ctx.is_test

    ch_axis = 1 if layout == "NCHW" and x.dim() > 1 else x.dim() - 1
    reduce_axes = tuple(i for i in range(x.dim()) if i != ch_axis)
    bshape = [1] * x.dim()
    bshape[ch_axis] = x.shape[ch_axis]

    if is_test:
        mean, var = mean_in, var_in
    else:
        n = 1
        for a in reduce_axes:
            n *= x.shape[a]
        stash = ctx.env.pop(op.input("X")[0] + "@BNSTATS", None)
        if stash is not None:
            s1, s2 = stash
        else:
            xc = x.float() - mean_in.detach().reshape(bshape).float()
            s1 = torch.sum(xc, dim=reduce_axes)
            s2 = torch.sum(xc * xc, dim=reduce_axes)
        d1 = s1 / n
        mean = mean_in + d1
        var = torch.clamp_min(s2 / n - d1 * d1, 0.0)
        new_mean = (momentum * mean_in + (1 - momentum) * mean).detach()
        new_var = (momentum * var_in + (1 - momentum) * var).detach()
        ctx.set_out(op, "MeanOut", new_mean)
        ctx.set_out(op, "VarianceOut", new_var)
        ctx.set_out(op, "SavedMean", mean)
        ctx.set_out(op, "SavedVariance", 1.0 / torch.sqrt(var + eps))
        # MeanOut/VarianceOut alias Mean/Variance in the reference; keep
        # the state var updated under its own name too
        for slot, value in (("Mean", new_mean), ("Variance", new_var)):
            names = op.input(slot)
            if names:
                ctx.env[names[0]] = value

    inv = torch.rsqrt(var + eps)
    a = (scale * inv).to(x.dtype)
    b = (bias - mean * scale * inv).to(x.dtype)
    ctx.set_out(op, "Y", x * a.reshape(bshape) + b.reshape(bshape))


@register("softmax")
def _softmax(ctx, op):
    x = ctx.in1(op, "X")
    # exponentials and normalization in fp32, result back to input dtype
    xf = x.float() if x.dtype == torch.bfloat16 else x
    ctx.set_out(op, "Out", torch.softmax(xf, dim=-1).to(x.dtype))


@register("layer_norm")
def _layer_norm(ctx, op):
    """Normalization over the dims from ``begin_norm_axis`` on, with the
    population variance (correction=0), as ``jnp.var``."""
    x = ctx.in1(op, "X")
    scale = ctx.in1(op, "Scale")
    bias = ctx.in1(op, "Bias")
    eps = op.attr("epsilon", 1e-5)
    begin = op.attr("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    xf = x.float() if x.dtype == torch.bfloat16 else x
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.var(xf, dim=axes, keepdim=True, correction=0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    pshape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        out = out * scale.reshape(pshape)
    if bias is not None:
        out = out + bias.reshape(pshape)
    ctx.set_out(op, "Y", out.to(x.dtype))
    ctx.set_out(op, "Mean", mean.reshape(x.shape[:begin]))
    ctx.set_out(op, "Variance", var.reshape(x.shape[:begin]))


@register("log_softmax")
def _log_softmax(ctx, op):
    ctx.set_out(op, "Out", torch.log_softmax(ctx.in1(op, "X"), dim=-1))


@register("lrn")
def _lrn(ctx, op):
    """Local response normalization across channels (NCHW): MidOut = k +
    alpha * (the sum of x^2 over the n channels centred on each), with
    alpha NOT divided by n (the JAX package's rule), and Out = x /
    MidOut^beta."""
    x = ctx.in1(op, "X")
    n = op.attr("n", 5)
    half = n // 2
    sq = torch.nn.functional.pad(torch.square(x),
                                 (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = sq[:, 0:c]
    for i in range(1, n):
        acc = acc + sq[:, i:i + c]
    mid = op.attr("k", 2.0) + op.attr("alpha", 1e-4) * acc
    ctx.set_out(op, "MidOut", mid)
    ctx.set_out(op, "Out", x / torch.pow(mid, op.attr("beta", 0.75)))


@register("maxout")
def _maxout(ctx, op):
    """The max over each run of ``groups`` consecutive channels."""
    x = ctx.in1(op, "X")                 # [N, C, H, W]
    groups = op.attr("groups")
    n, c, h, w = x.shape
    ctx.set_out(op, "Out", torch.amax(
        x.reshape(n, c // groups, groups, h, w), dim=2))


@register("sequence_softmax")
def _sequence_softmax(ctx, op):
    """Softmax over each sequence of a [T, 1] LoD input (over all of X
    without a LoD). The segment max that steadies the exponent is a
    constant to the gradient (softmax does not depend on it). A pad row
    divides by the last sequence's sum, as in the JAX package, without
    a gradient through it."""
    x = ctx.in1(op, "X")
    lengths = ctx.maybe_get(op.input("X")[0] + "@LOD")
    if lengths is None:
        ctx.set_out(op, "Out", torch.softmax(x.reshape(-1), 0)
                    .reshape(x.shape))
        return
    n = lengths.shape[0]
    seg = segments(lengths, x.shape[0])
    flat = x.reshape(x.shape[0])
    m = torch.full((n + 1,), float("-inf"), dtype=x.dtype,
                   device=x.device).scatter_reduce(
                       0, seg, flat.detach(), "amax")[:n]
    e = torch.exp(flat - take_rows(m, seg))
    s = segment_sum(e, seg, n)
    ctx.set_out(op, "Out", (e / take_rows(s, seg)).reshape(x.shape))


@register("im2sequence")
def _im2sequence(ctx, op):
    """Image -> sequence of flattened patches (im2sequence_op.cc): X
    [N, C, H, W] padded by ``paddings`` (top, left, bottom, right), each
    kernels-sized patch at ``strides`` one row of C * kh * kw values,
    image after image, patches in row-major order."""
    x = ctx.in1(op, "X")
    kh, kw = op.attr("kernels", [1, 1])
    sh, sw = op.attr("strides", [1, 1])
    pads = op.attr("paddings", [0, 0, 0, 0])
    x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    n, c = x.shape[:2]
    patches = F.unfold(x, (kh, kw), stride=(sh, sw))    # [N, C*kh*kw, L]
    ctx.set_out(op, "Out", patches.transpose(1, 2).reshape(-1, c * kh * kw))
