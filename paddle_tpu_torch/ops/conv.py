"""Convolution and pooling ops: conv2d, conv3d, depthwise_conv2d,
conv2d_transpose, conv3d_transpose, pool2d, pool3d,
max_pool2d_with_index, unpool, spp, roi_pool and row_conv.

The counterpart of ``paddle_tpu/ops/conv.py``. The convolutions are
``torch.nn.functional``'s (cuDNN on the card; fp32 stays fp32 because
the Executor holds cuDNN's TF32 off for the step), on NC[D]HW or
N[D]HWC activations with an [O, I/groups, k...] filter, with strides,
paddings, dilations and groups; the transposed ones take the reference's
[I, O/groups, k...] filter, which is PyTorch's layout too. With the flag ``fuse_conv_bn``
on, a 1x1 convolution whose output feeds a train-mode ``batch_norm``
runs as ``matmul_stats.matmul_colstats`` (the CUDA kernel on the card)
and hands BN its statistics through ``ctx.env[<out> + "@BNSTATS"]``.
``pool2d`` and ``pool3d`` are max or avg pooling with the JAX package's
edge rules (padded cells never win a max; ``ceil_mode`` pads the right
edge so the last partial window counts; ``exclusive`` divides by the
real cells; adaptive bins span [floor(i S / o), ceil((i + 1) S / o))).
``row_conv`` over LoD sequences convolves each sequence on its own.
"""

import torch
import torch.nn.functional as F

from .. import flags
from ..amp import amp_out, maybe_bf16
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


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _channels_first(x, layout):
    """An N...C input as NC... (a view), when ``layout`` says so."""
    if layout == "NHWC":
        return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))
    return x


def _channels_last(out, layout):
    if layout == "NHWC":
        return out.permute(0, *range(2, out.dim()), 1)
    return out


def _layout(op):
    layout = op.attr("data_format", op.attr("data_layout", "NCHW"))
    return "NHWC" if layout in ("NHWC", "NDHWC") else "NCHW"


def _conv_nd(ctx, op, nsp, groups=None):
    x = ctx.in1(op, "Input")
    w = ctx.in1(op, "Filter")
    out_dtype = x.dtype
    x, w = maybe_bf16(x, w)
    strides = _pair(op.attr("strides", [1] * nsp), nsp)
    paddings = _pair(op.attr("paddings", [0] * nsp), nsp)
    dilations = _pair(op.attr("dilations", [1] * nsp), nsp)
    groups = groups or int(op.attr("groups", 1) or 1)
    layout = _layout(op)
    if nsp == 2 and _maybe_conv1x1_bn_fused(
            ctx, op, x, w, strides, paddings, dilations, groups, layout,
            out_dtype):
        return
    out = _CONV[nsp](_channels_first(x, layout), w, stride=strides,
                     padding=paddings, dilation=dilations, groups=groups)
    ctx.set_out(op, "Output", amp_out(_channels_last(out, layout),
                                      out_dtype))


@register("conv2d")
def _conv2d(ctx, op):
    _conv_nd(ctx, op, 2)


@register("conv3d")
def _conv3d(ctx, op):
    _conv_nd(ctx, op, 3)


@register("depthwise_conv2d")
def _depthwise_conv2d(ctx, op):
    """A [C * mult, 1, kh, kw] filter over C groups (conv_op.cc's
    depthwise path); the JAX package sets ``groups`` to dim 1 of the
    input the same way."""
    _conv_nd(ctx, op, 2, groups=int(ctx.in1(op, "Input").shape[1]))


def _conv_transpose_nd(ctx, op, nsp):
    """The gradient of a convolution: output (S - 1) s - 2 p + d (k - 1)
    + 1 per axis; ``output_size`` then slices it or pads its end with
    zeros (the JAX package's rule; PyTorch's ``output_padding`` would
    compute the extra rows instead)."""
    x = ctx.in1(op, "Input")
    w = ctx.in1(op, "Filter")
    out_dtype = x.dtype
    x, w = maybe_bf16(x, w)
    strides = _pair(op.attr("strides", [1] * nsp), nsp)
    paddings = _pair(op.attr("paddings", [0] * nsp), nsp)
    dilations = _pair(op.attr("dilations", [1] * nsp), nsp)
    groups = int(op.attr("groups", 1) or 1)
    out = _CONV_T[nsp](x, w, stride=strides, padding=paddings,
                       dilation=dilations, groups=groups)
    out_size = op.attr("output_size")
    if out_size:
        out = out[(Ellipsis,) + tuple(slice(0, int(v)) for v in out_size)]
        flat = []
        for i in reversed(range(nsp)):
            flat += [0, max(0, int(out_size[i]) - out.shape[2 + i])]
        if any(flat):
            out = F.pad(out, flat)
    ctx.set_out(op, "Output", amp_out(out, out_dtype))


@register("conv2d_transpose")
def _conv2d_transpose(ctx, op):
    _conv_transpose_nd(ctx, op, 2)


@register("conv3d_transpose")
def _conv3d_transpose(ctx, op):
    _conv_transpose_nd(ctx, op, 3)


def _maybe_conv1x1_bn_fused(ctx, op, x, w, strides, paddings, dilations,
                            groups, layout, out_dtype):
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
    ctx.set_out(op, "Output", amp_out(out, out_dtype))
    return True


# --------------------------------------------------------------------------
# pooling
# --------------------------------------------------------------------------

_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_out(x, ksize, strides, paddings, pooling_type, ceil_mode,
              exclusive, global_pooling):
    """pool2d / pool3d on NC... ``x`` with the JAX package's
    ``_pool_out`` rules."""
    nsp = x.dim() - 2
    sp_shape = tuple(x.shape[2:])
    if global_pooling:
        ksize = sp_shape
        paddings = (0,) * nsp
        strides = sp_shape
    # (before, after) padding per spatial axis; with ceil_mode the right
    # edge grows so the last partial window is included
    pads = []
    for i in range(nsp):
        extra = 0
        if ceil_mode:
            span = sp_shape[i] + 2 * paddings[i] - ksize[i]
            rem = span % strides[i]
            extra = (strides[i] - rem) % strides[i] if rem else 0
        pads.append((paddings[i], paddings[i] + extra))
    padded = any(p[0] or p[1] for p in pads)
    flat = [v for p in reversed(pads) for v in p]       # F.pad order
    if pooling_type == "max":
        # padded cells are -inf, so they never win a max
        xp = F.pad(x, flat, value=float("-inf")) if padded else x
        return _MAX_POOL[nsp](xp, ksize, strides)
    window = 1
    for k in ksize:
        window *= k
    xf = x.float()
    xp = F.pad(xf, flat) if padded else xf
    s = _AVG_POOL[nsp](xp, ksize, strides, divisor_override=1)
    if exclusive or padded:
        ones = torch.ones((1, 1) + sp_shape, dtype=torch.float32,
                          device=x.device)
        cnt = _AVG_POOL[nsp](F.pad(ones, flat), ksize, strides,
                             divisor_override=1)
        if not exclusive:
            cnt = cnt.clamp_min(float(window))
        out = s / cnt.clamp_min(1.0)
    else:
        out = s / float(window)
    return out.to(x.dtype)


def _adaptive_pool(x, out_sz, pooling_type):
    """Adaptive pooling with Paddle's bin rule: bin i spans
    [floor(i S / o), ceil((i + 1) S / o)) (pool_op.cc), as per-axis
    mask reductions, as the JAX package lowers it."""
    out = x
    for ax, (size, o) in enumerate(zip(x.shape[2:], out_sz)):
        i = torch.arange(o, device=x.device)
        starts = (i * size) // o
        ends = -((-(i + 1) * size) // o)
        pos = torch.arange(size, device=x.device)
        mask = (pos[None, :] >= starts[:, None]) & \
            (pos[None, :] < ends[:, None])                  # [o, S]
        moved = torch.movedim(out, 2 + ax, -1)[..., None, :]  # [..., 1, S]
        if pooling_type == "max":
            red = torch.amax(torch.where(mask, moved, float("-inf")),
                             dim=-1)
        else:
            red = torch.sum(torch.where(mask, moved, 0.0), dim=-1) / \
                (ends - starts).to(out.dtype)
        out = torch.movedim(red, -1, 2 + ax)
    return out.to(x.dtype)


def _pool_nd(ctx, op, nsp):
    x = ctx.in1(op, "X")
    ksize = _pair(op.attr("ksize", [1] * nsp), nsp)
    if op.attr("adaptive", False):
        out = _adaptive_pool(x, ksize, op.attr("pooling_type", "max"))
    else:
        out = _pool_out(x, ksize, _pair(op.attr("strides", [1] * nsp), nsp),
                        _pair(op.attr("paddings", [0] * nsp), nsp),
                        op.attr("pooling_type", "max"),
                        op.attr("ceil_mode", False),
                        op.attr("exclusive", True),
                        op.attr("global_pooling", False))
    ctx.set_out(op, "Out", out)


@register("pool2d")
def _pool2d(ctx, op):
    _pool_nd(ctx, op, 2)


@register("pool3d")
def _pool3d(ctx, op):
    _pool_nd(ctx, op, 3)


@register("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, op):
    """Max pooling and, as Mask, the flat index h * W + w (within each
    H x W map) of the cell that won: the first in the window's row-major
    order on a tie; padded cells hold the dtype's lowest finite value
    and index -1 (pool_with_index_op.cc, as the JAX package lowers
    it)."""
    x = ctx.in1(op, "X")
    ksize = _pair(op.attr("ksize", [2, 2]))
    strides = _pair(op.attr("strides", [2, 2]))
    paddings = _pair(op.attr("paddings", [0, 0]))
    n, c, h, w = x.shape
    if op.attr("global_pooling", False):
        ksize, strides, paddings = (h, w), (h, w), (0, 0)
    (kh, kw), (sh, sw), (ph, pw) = ksize, strides, paddings
    lowest = torch.finfo(x.dtype).min if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    xp = F.pad(x, (pw, pw, ph, ph), value=lowest)
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    patches = F.unfold(xp, (kh, kw), stride=(sh, sw)).reshape(
        n, c, kh * kw, ho, wo)
    dev = x.device
    iy = (torch.arange(ho, device=dev)[:, None, None, None] * sh - ph
          + torch.arange(kh, device=dev)[None, None, :, None])
    ix = (torch.arange(wo, device=dev)[None, :, None, None] * sw - pw
          + torch.arange(kw, device=dev)[None, None, None, :])
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = torch.where(valid, iy * w + ix, -1)        # [Ho, Wo, kh, kw]
    ipatch = flat.reshape(ho, wo, kh * kw).permute(2, 0, 1)
    amax = torch.argmax(patches, dim=2)               # [N, C, Ho, Wo]
    idx = torch.gather(ipatch.expand(n, c, -1, -1, -1), 2,
                       amax[:, :, None])[:, :, 0]
    ctx.set_out(op, "Out", torch.amax(patches, dim=2))
    ctx.set_out(op, "Mask", idx.to(torch.int32))


@register("unpool")
def _unpool(ctx, op):
    """X scattered to its Indices (flat within each map) in a zero map
    of (H_in - 1) stride - 2 pad + ksize per axis (unpool_op.cc)."""
    x = ctx.in1(op, "X")
    mask = ctx.in1(op, "Indices")
    n, c, ho, wo = x.shape
    ksize = _pair(op.attr("ksize", [2, 2]))
    strides = _pair(op.attr("strides", ksize))
    paddings = _pair(op.attr("paddings", [0, 0]))
    h = (ho - 1) * strides[0] - 2 * paddings[0] + ksize[0]
    w = (wo - 1) * strides[1] - 2 * paddings[1] + ksize[1]
    out = torch.zeros((n, c, h * w), dtype=x.dtype, device=x.device).scatter(
        2, mask.reshape(n, c, ho * wo).long(), x.reshape(n, c, ho * wo))
    ctx.set_out(op, "Out", out.reshape(n, c, h, w))


@register("spp")
def _spp(ctx, op):
    """Spatial pyramid pooling (spp_op.cc): level l pools into 2^l x 2^l
    bins of ceil(S / 2^l) cells, padded by (bins k - S + 1) // 2 (the
    JAX package's edges, not exclusive), flattened and concatenated."""
    x = ctx.in1(op, "X")
    ptype = op.attr("pooling_type", "max")
    n, _, h, w = x.shape
    outs = []
    for lvl in range(int(op.attr("pyramid_height", 1))):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)
        ph = max(0, (bins * kh - h + 1) // 2)
        pw = max(0, (bins * kw - w + 1) // 2)
        pooled = _pool_out(x, (kh, kw), (kh, kw), (ph, pw), ptype,
                           False, False, False)
        outs.append(pooled.reshape(n, -1))
    ctx.set_out(op, "Out", torch.cat(outs, dim=1))


@register("roi_pool")
def _roi_pool(ctx, op):
    """Max pooling of each ROI (x1, y1, x2, y2, scaled by
    ``spatial_scale`` and rounded half to even) into pooled_h x
    pooled_w bins; bin i spans [floor(y1 + i h / ph), ceil(y1 + (i + 1)
    h / ph)), at least one cell; an empty bin reads 0 (roi_pool_op.cc,
    as the JAX package lowers it). ROIs with a LoD read image i for the
    i-th sequence of ROIs (pad rows past the lengths read the last
    image); without one, every ROI reads image 0. The max is taken over
    the bin's columns, then its rows."""
    x = ctx.in1(op, "X")
    rois = ctx.in1(op, "ROIs").float()          # [R, 4]
    lod = ctx.maybe_get(op.input("ROIs")[0] + "@LOD")
    ph = int(op.attr("pooled_height", 1))
    pw = int(op.attr("pooled_width", 1))
    scale = float(op.attr("spatial_scale", 1.0))
    _, c, h, w = x.shape
    dev = x.device
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale) for i in range(4))
    rh = torch.clamp_min(y2 - y1 + 1, 1.0)
    rw = torch.clamp_min(x2 - x1 + 1, 1.0)

    def bins(lo, extent, nb, size):
        """[R, nb, size] masks of the cells in each bin along one axis."""
        b = extent / nb
        i = torch.arange(nb, device=dev, dtype=torch.float32)
        s0 = torch.floor(lo[:, None] + i[None, :] * b[:, None])
        s1 = torch.ceil(lo[:, None] + (i[None, :] + 1) * b[:, None])
        pos = torch.arange(size, device=dev, dtype=torch.float32)
        return (pos >= s0[..., None]) & \
            (pos < torch.maximum(s1, s0 + 1)[..., None])

    my = bins(y1, rh, ph, h)                          # [R, ph, H]
    mx = bins(x1, rw, pw, w)                          # [R, pw, W]
    if lod is None:
        img = x[0][None]                              # [1, C, H, W]
    else:
        # jnp.repeat(arange(n), lod, total_repeat_length=R): the rows past
        # sum(lod) repeat the last image
        ends = torch.cumsum(lod, 0)
        idx = torch.searchsorted(ends, torch.arange(rois.shape[0],
                                                    device=dev),
                                 right=True)
        img = x[torch.clamp(idx, max=lod.shape[0] - 1)]   # [R, C, H, W]
    neg = float("-inf")
    cols = torch.amax(torch.where(mx[:, None, None], img[:, :, :, None],
                                  neg), dim=-1)       # [R, C, H, pw]
    out = torch.amax(torch.where(my[:, None, :, :, None],
                                 cols[:, :, None], neg), dim=3)
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    ctx.set_out(op, "Out", out.to(x.dtype))           # [R, C, ph, pw]


@register("row_conv")
def _row_conv(ctx, op):
    """Lookahead convolution over time (row_conv_op.cc): out[t] =
    sum_k x[t + k] w[k], x [T, D], w [future_context + 1, D]; over LoD
    sequences, each cut at its end (a lookahead row of another sequence
    counts as zero)."""
    x = ctx.in1(op, "X")
    w = ctx.in1(op, "Filter")
    k = w.shape[0]
    t = x.shape[0]
    xp = F.pad(x, (0, 0, 0, k - 1))
    stacked = torch.stack([xp[i:i + t] for i in range(k)], dim=0)
    lengths = ctx.maybe_get(op.input("X")[0] + "@LOD")
    if lengths is not None and t:
        seg = torch.searchsorted(torch.cumsum(lengths, 0),
                                 torch.arange(t, device=x.device),
                                 right=True)
        seg_p = torch.cat([seg, (seg[-1] + 1).expand(k - 1)])
        same = torch.stack([seg_p[i:i + t] == seg for i in range(k)])
        stacked = torch.where(same[..., None], stacked,
                              torch.zeros((), dtype=x.dtype,
                                          device=x.device))
    ctx.set_out(op, "Out", torch.einsum("ktd,kd->td", stacked, w))
