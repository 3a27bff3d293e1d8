"""NN ops: softmax, batch_norm, layer_norm (the counterpart of
``paddle_tpu/ops/nn.py`` for the flagship LM and the ResNet models)."""

import torch

from ..core.registry import register


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
