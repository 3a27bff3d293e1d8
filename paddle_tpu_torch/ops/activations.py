"""Activation ops: relu (the counterpart of ``paddle_tpu/ops/activations.py``
for the flagship LM's FFN)."""

import torch

from ..core.registry import register


@register("relu")
def _relu(ctx, op):
    ctx.set_out(op, "Out", torch.relu(ctx.in1(op, "X")))
