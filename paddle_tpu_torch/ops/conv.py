"""Convolution and pooling ops: conv2d, pool2d.

The counterpart of ``paddle_tpu/ops/conv.py`` for the ResNet zoo models.
``conv2d`` is ``torch.nn.functional.conv2d`` (cuDNN on the card; fp32
stays fp32 because ``Executor.run`` holds cuDNN's TF32 off for the step),
on NCHW or NHWC activations with an [O, I/groups, kh, kw] filter, with
strides, paddings, dilations and groups. With the flag ``fuse_conv_bn``
on, a 1x1 convolution whose output feeds a train-mode ``batch_norm``
runs as ``matmul_stats.matmul_colstats`` (the CUDA kernel on the card)
and hands BN its statistics through ``ctx.env[<out> + "@BNSTATS"]``.
``pool2d`` is max or avg pooling with the JAX package's edge rules
(padded cells never win a max; ``ceil_mode`` pads the right edge so the
last partial window counts; ``exclusive`` divides by the real cells).

Not ported yet (no lowering is registered, so running one raises
NotImplementedError naming ROADMAP.md; adaptive pool2d raises here):
adaptive pooling, conv3d, depthwise_conv2d, conv2d_transpose,
conv3d_transpose, pool3d, max_pool2d_with_index, unpool, spp, roi_pool
and row_conv.
"""

import torch
import torch.nn.functional as F

from .. import flags
from ..core.registry import register
from . import matmul_stats


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _find_train_bn_consumer(ctx, out_name):
    """The batch_norm op (train mode) consuming `out_name`, if any —
    the conv+BN stat-fusion pattern (matmul_stats.py). The map from each
    train-mode BN's input to the op is built once per run (the lowering
    runs every step; the JAX package's runs once, at trace time)."""
    block = getattr(ctx, "block", None)
    if block is None or getattr(ctx, "is_test", False):
        return None
    consumers = getattr(ctx, "_train_bn_consumers", None)
    if consumers is None:
        consumers = {}
        for o in block.ops:
            if o.type == "batch_norm" and not o.attr("is_test", False):
                xs = o.input("X")
                if len(xs) == 1:
                    consumers.setdefault(xs[0], o)
        ctx._train_bn_consumers = consumers
    return consumers.get(out_name)


@register("conv2d")
def _conv2d(ctx, op):
    x = ctx.in1(op, "Input")
    w = ctx.in1(op, "Filter")
    strides = _pair(op.attr("strides", [1, 1]))
    paddings = _pair(op.attr("paddings", [0, 0]))
    dilations = _pair(op.attr("dilations", [1, 1]))
    groups = int(op.attr("groups", 1) or 1)
    layout = op.attr("data_format", op.attr("data_layout", "NCHW"))
    layout = "NHWC" if layout in ("NHWC", "NDHWC") else "NCHW"
    if _maybe_conv1x1_bn_fused(ctx, op, x, w, strides, paddings, dilations,
                               groups, layout):
        return
    if layout == "NHWC":
        x = x.permute(0, 3, 1, 2)
    out = F.conv2d(x, w, stride=strides, padding=paddings,
                   dilation=dilations, groups=groups)
    if layout == "NHWC":
        out = out.permute(0, 2, 3, 1)
    ctx.set_out(op, "Output", out)


def _maybe_conv1x1_bn_fused(ctx, op, x, w, strides, paddings, dilations,
                            groups, layout):
    """1x1-conv + train-BN stat fusion: the conv runs as a matmul whose
    epilogue accumulates the per-channel shifted stats BN needs
    (matmul_colstats), so BN skips its own read of the conv output. The
    stats ride to the consumer BN via a ctx.env stash, which it pops.
    Returns True when it handled the op."""
    if not flags.get_flag("fuse_conv_bn"):
        return False
    if (groups != 1 or layout != "NCHW" or tuple(w.shape[2:]) != (1, 1)
            or any(p != 0 for p in paddings)
            or any(d != 1 for d in dilations)):
        return False
    out_name = op.output("Output")[0]
    bn = _find_train_bn_consumer(ctx, out_name)
    if bn is None:
        return False
    mean_names = bn.input("Mean")
    if not mean_names or ctx.env.get(mean_names[0]) is None:
        return False
    co, ci = int(w.shape[0]), int(w.shape[1])
    sh, sw = strides
    if sh != 1 or sw != 1:
        x = x[:, :, ::sh, ::sw]        # 1x1 stride = spatial subsample
    n, _, hh, ww = x.shape
    c = ctx.env[mean_names[0]].detach().float().reshape(co)
    # NHWC rows: [N*H*W, Ci]; the filter's [Co, Ci] storage is handed over
    # as its [Ci, Co] transpose, without a copy
    xt = x.permute(0, 2, 3, 1).reshape(-1, ci).contiguous()
    y2, s1, s2 = matmul_stats.matmul_colstats(xt, w.reshape(co, ci).t(), c)
    out = y2.reshape(n, hh, ww, co).permute(0, 3, 1, 2)
    ctx.env[out_name + "@BNSTATS"] = (s1, s2)
    ctx.set_out(op, "Output", out)
    return True


# --------------------------------------------------------------------------
# pooling
# --------------------------------------------------------------------------

def _pool_out(x, ksize, strides, paddings, pooling_type, ceil_mode,
              exclusive, global_pooling):
    """pool2d on NCHW ``x`` with the JAX package's ``_pool_out`` rules."""
    sp_shape = tuple(x.shape[2:])
    if global_pooling:
        ksize = sp_shape
        paddings = (0, 0)
        strides = sp_shape
    # (before, after) padding per spatial axis; with ceil_mode the right
    # edge grows so the last partial window is included
    pads = []
    for i in range(2):
        extra = 0
        if ceil_mode:
            span = sp_shape[i] + 2 * paddings[i] - ksize[i]
            rem = span % strides[i]
            extra = (strides[i] - rem) % strides[i] if rem else 0
        pads.append((paddings[i], paddings[i] + extra))
    padded = any(p[0] or p[1] for p in pads)
    flat = (pads[1][0], pads[1][1], pads[0][0], pads[0][1])   # F.pad order
    if pooling_type == "max":
        # padded cells are -inf, so they never win a max
        xp = F.pad(x, flat, value=float("-inf")) if padded else x
        return F.max_pool2d(xp, ksize, strides)
    xf = x.float()
    xp = F.pad(xf, flat) if padded else xf
    s = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
    if exclusive or padded:
        ones = torch.ones((1, 1) + sp_shape, dtype=torch.float32,
                          device=x.device)
        cnt = F.avg_pool2d(F.pad(ones, flat), ksize, strides,
                           divisor_override=1)
        if not exclusive:
            cnt = cnt.clamp_min(float(ksize[0] * ksize[1]))
        out = s / cnt.clamp_min(1.0)
    else:
        out = s / float(ksize[0] * ksize[1])
    return out.to(x.dtype)


@register("pool2d")
def _pool2d(ctx, op):
    x = ctx.in1(op, "X")
    if op.attr("adaptive", False):
        raise NotImplementedError(
            "adaptive pool2d is not ported to paddle_tpu_torch yet "
            "(ROADMAP.md, queue 1)")
    out = _pool_out(x, _pair(op.attr("ksize", [1, 1])),
                    _pair(op.attr("strides", [1, 1])),
                    _pair(op.attr("paddings", [0, 0])),
                    op.attr("pooling_type", "max"),
                    op.attr("ceil_mode", False),
                    op.attr("exclusive", True),
                    op.attr("global_pooling", False))
    ctx.set_out(op, "Out", out)
