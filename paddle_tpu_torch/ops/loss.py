"""Loss ops: softmax_with_cross_entropy (the counterpart of
``paddle_tpu/ops/loss.py`` for the flagship LM)."""

import torch

from ..core.registry import register


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
