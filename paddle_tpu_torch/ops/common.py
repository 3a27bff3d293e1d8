"""Shared helpers of the op lowerings: the LoD pad-row mask.

The counterpart of ``paddle_tpu/ops/common.py``'s ``lod_valid_mask``.
"""

import torch


def lod_valid_mask(ctx, op, slot="X"):
    """Row validity of a LoD-carrying input under the flat-total
    bucketing of ``core/executor._normalize_feeds``: rows past
    sum(lengths) are zero padding and must not enter a reduction.
    Returns (valid bool [t], n_valid int scalar tensor), both on the
    device (no host read: a CUDA graph holds them), or (None, None)
    when the input carries no LoD or is a scalar."""
    names = op.input(slot)
    if not names:
        return None, None
    lens = ctx.maybe_get(names[0] + "@LOD")
    if lens is None:
        return None, None
    x = ctx.env.get(names[0])
    if not isinstance(x, torch.Tensor) or x.dim() < 1:
        return None, None
    n_valid = torch.sum(lens)
    valid = torch.arange(x.shape[0], device=x.device) < n_valid
    return valid, n_valid
