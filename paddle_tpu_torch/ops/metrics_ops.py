"""Metric ops: accuracy (the counterpart of ``paddle_tpu/ops/metrics_ops.py``
for the ResNet models' ``accuracy`` layer; per-batch values)."""

import torch

from ..core.registry import register
from ..core.scope import torch_dtype


@register("accuracy")
def _accuracy(ctx, op):
    """Share of rows whose label is among their top-k ``Indices``; Correct
    and Total as [1] int32 (int64 narrowed, as the port holds it). LoD
    labels, which the JAX package masks, raise in the Executor."""
    indices = ctx.in1(op, "Indices")      # [N, k]
    label = ctx.in1(op, "Label")          # [N, 1] or [N]
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label.reshape(-1)
    hit = torch.any(indices == label[:, None].to(indices.dtype), dim=1)
    i64 = torch_dtype("int64")
    correct = torch.sum(hit).to(i64)
    # made on the device (a fill, no host copy a CUDA graph would refuse)
    total = torch.full((), label.shape[0], dtype=i64, device=indices.device)
    ctx.set_out(op, "Accuracy",
                (correct.float() / total.float()).reshape(1))
    ctx.set_out(op, "Correct", correct.reshape(1))
    ctx.set_out(op, "Total", total.reshape(1))
