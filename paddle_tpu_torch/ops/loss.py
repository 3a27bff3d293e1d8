"""Loss ops: cross_entropy, softmax_with_cross_entropy,
sigmoid_cross_entropy_with_logits, hinge, huber, log, smooth_l1, rank,
margin_rank and modified_huber losses, and nce (the counterpart of
``paddle_tpu/ops/loss.py``, in its numerically stable forms)."""

import math

import torch

from ..core import philox
from ..core.registry import register


@register("cross_entropy")
def _cross_entropy(ctx, op):
    """-log p[label] of probabilities X [N, C] (clipped at 1e-20), zero
    where the label is ``ignore_index``; hard labels ([N, 1] or [N] int,
    widened to int64 where they index) or soft labels (-sum label log p)."""
    x = ctx.in1(op, "X")
    if x.dtype == torch.bfloat16:    # loss math in fp32
        x = x.float()
    label = ctx.in1(op, "Label")
    if x.shape[0] != label.shape[0]:
        raise ValueError(
            "cross_entropy batch mismatch: X has %d rows, Label has %d "
            "(a silent broadcast here would train the class prior)"
            % (x.shape[0], label.shape[0]))
    if op.attr("soft_label", False):
        if label.dim() == x.dim() - 1:
            label = label[..., None]
        loss = -torch.sum(label * torch.log(x.clamp_min(1e-20)), dim=-1,
                          keepdim=True)
    else:
        if label.dim() == x.dim() and label.shape[-1] == 1:
            label = label.reshape(label.shape[:-1])
        valid = label != op.attr("ignore_index", -100)
        safe = torch.where(valid, label, torch.zeros_like(label))
        p = torch.gather(x, -1, safe.long()[..., None])
        loss = -torch.log(p.clamp_min(1e-20)) * valid[..., None].to(x.dtype)
    ctx.set_out(op, "Y", loss)


@register("softmax_with_cross_entropy")
def _softmax_xent(ctx, op):
    """log-softmax over the last dim; hard labels ([..., 1] or [...]
    int, widened to int64 for the gather) pick -log p, soft labels sum
    -label * log p."""
    logits = ctx.in1(op, "Logits")
    if logits.dtype == torch.bfloat16:   # loss math in fp32
        logits = logits.float()
    label = ctx.in1(op, "Label")
    log_sm = torch.log_softmax(logits, dim=-1)
    if op.attr("soft_label", False):
        loss = -torch.sum(label * log_sm, dim=-1, keepdim=True)
    else:
        if label.dim() == log_sm.dim() and label.shape[-1] == 1:
            label = label.reshape(label.shape[:-1])
        loss = -torch.gather(log_sm, -1, label.long()[..., None])
    sm_name = ctx.out_name(op, "Softmax")
    if ctx.is_read(sm_name):
        # eager execution has no dead-code elimination: the [N, C]
        # probabilities are made only when some op or fetch reads them
        ctx.set(sm_name, torch.exp(log_sm))
    ctx.set_out(op, "Loss", loss)


def _bce_with_logits(x, z):
    """max(x, 0) - x z + log(1 + exp(-|x|)): the stable sigmoid cross
    entropy of logits x against labels z."""
    return torch.clamp_min(x, 0) - x * z + \
        torch.log1p(torch.exp(-torch.abs(x)))


@register("sigmoid_cross_entropy_with_logits")
def _sigmoid_xent(ctx, op):
    ctx.set_out(op, "Out", _bce_with_logits(ctx.in1(op, "X"),
                                            ctx.in1(op, "Label")))


@register("hinge_loss")
def _hinge_loss(ctx, op):
    logits = ctx.in1(op, "Logits")
    labels = ctx.in1(op, "Labels")
    ctx.set_out(op, "Loss", torch.relu(1.0 - (2.0 * labels - 1.0) * logits))


@register("huber_loss")
def _huber_loss(ctx, op):
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    delta = op.attr("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    ctx.set_out(op, "Residual", r)
    ctx.set_out(op, "Out", torch.where(ar <= delta, 0.5 * r * r,
                                       delta * (ar - 0.5 * delta)))


@register("log_loss")
def _log_loss(ctx, op):
    p = ctx.in1(op, "Predicted")
    label = ctx.in1(op, "Labels")
    eps = op.attr("epsilon", 1e-4)
    ctx.set_out(op, "Loss", -label * torch.log(p + eps)
                - (1 - label) * torch.log(1 - p + eps))


@register("smooth_l1_loss")
def _smooth_l1(ctx, op):
    """Per row, the sum of 0.5 s^2 d^2 where |d| < 1/s^2, else
    |d| - 0.5/s^2, for d = (X - Y) * InsideWeight, each term times
    OutsideWeight; Out is [N, 1]."""
    x = ctx.in1(op, "X")
    d = x - ctx.in1(op, "Y")
    in_w = ctx.in1(op, "InsideWeight")
    out_w = ctx.in1(op, "OutsideWeight")
    if in_w is not None:
        d = d * in_w
    sigma = op.attr("sigma", 1.0)
    s2 = sigma * sigma
    ad = torch.abs(d)
    elem = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if out_w is not None:
        elem = elem * out_w
    ctx.set_out(op, "Diff", d)
    ctx.set_out(op, "Out", torch.sum(
        elem, dim=tuple(range(1, elem.dim())), keepdim=True).reshape(
        x.shape[0], 1))


@register("rank_loss")
def _rank_loss(ctx, op):
    d = ctx.in1(op, "Left") - ctx.in1(op, "Right")
    ctx.set_out(op, "Out", _bce_with_logits(d, ctx.in1(op, "Label")))


@register("margin_rank_loss")
def _margin_rank_loss(ctx, op):
    x1 = ctx.in1(op, "X1")
    out = torch.relu(-ctx.in1(op, "Label") * (x1 - ctx.in1(op, "X2"))
                     + op.attr("margin", 0.0))
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "Activated", (out > 0).to(x1.dtype))


@register("modified_huber_loss")
def _modified_huber_loss(ctx, op):
    x = ctx.in1(op, "X")
    z = (2.0 * ctx.in1(op, "Y") - 1.0) * x
    ctx.set_out(op, "IntermediateVal", z)
    ctx.set_out(op, "Out", torch.where(
        z < -1.0, -4.0 * z, torch.square(torch.clamp_min(1.0 - z, 0.0))))


@register("nce", stateful_rng=True)   # draws its negatives
def _nce(ctx, op):
    """Noise-contrastive estimation (operators/nce_op.cc), as the JAX
    package lowers it: ``num_neg_samples`` negatives per row drawn
    uniformly, each a counter-keyed Philox word w mapped to ``(w *
    num_total_classes) >> 32`` (``core/philox.py``), logits of the true
    and sampled classes shifted by log(num_total_classes) (the uniform
    noise), and per row the sum of their sigmoid cross entropies, times
    SampleWeight. The draws differ from threefry's; SampleLabels holds
    them."""
    x = ctx.in1(op, "Input")            # [B, D]
    label = ctx.in1(op, "Label")        # [B, T]
    w = ctx.in1(op, "Weight")           # [C, D]
    b = ctx.in1(op, "Bias")             # [C]
    num_neg = op.attr("num_neg_samples", 10)
    num_classes = op.attr("num_total_classes", w.shape[0])
    batch = x.shape[0]
    if label.dim() == 1:
        label = label[:, None]
    num_true = label.shape[1]
    seed, key = ctx.draw_key(op)
    words = philox.words(batch * num_neg, seed, key, ctx.device)
    neg = ((words * int(num_classes)) >> 32).reshape(batch, num_neg)
    samples = torch.cat([label.to(torch.int32), neg.to(torch.int32)], dim=1)
    idx = samples.long()
    logits = torch.einsum("bd,bkd->bk", x, w[idx])
    if b is not None:
        # the layer makes Bias [C, 1]; jnp.take without an axis indexes
        # the flat array
        logits = logits + b.reshape(-1)[idx]
    labels01 = torch.cat([torch.ones((batch, num_true), device=x.device),
                          torch.zeros((batch, num_neg), device=x.device)],
                         dim=1)
    logits = logits - math.log(float(num_classes))
    cost = torch.sum(_bce_with_logits(logits, labels01), dim=1,
                     keepdim=True)
    if op.input("SampleWeight"):
        cost = cost * ctx.in1(op, "SampleWeight").reshape(batch, 1).to(
            cost.dtype)
    ctx.set_out(op, "Cost", cost)
    ctx.set_out(op, "SampleLogits", logits)
    ctx.set_out(op, "SampleLabels", samples)
