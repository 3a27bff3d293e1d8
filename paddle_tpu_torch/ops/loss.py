"""Loss ops: cross_entropy and softmax_with_cross_entropy (the
counterpart of ``paddle_tpu/ops/loss.py`` for the flagship LM and the
ResNet models)."""

import torch

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
