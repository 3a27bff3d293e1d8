"""NN ops: softmax, layer_norm (the counterpart of ``paddle_tpu/ops/nn.py``
for the flagship LM)."""

import torch

from ..core.registry import register


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
