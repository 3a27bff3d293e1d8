"""Shared helpers of the op lowerings: the LoD pad-row mask and a
reshape that DTensors survive.

The counterpart of ``paddle_tpu/ops/common.py``'s ``lod_valid_mask``.
"""

import torch


def _contiguous_local(g):
    """A DTensor with the same placements whose local block is
    contiguous (DTensor's stride bookkeeping can call a permuted local
    block contiguous, and its ``view`` then fails)."""
    from torch.distributed.tensor import DTensor
    local = g.to_local().contiguous()
    shape = tuple(g.shape)
    return DTensor.from_local(local, g.device_mesh, g.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


class _DTensorReshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _contiguous_local(g).reshape(ctx.in_shape), None


def reshape(x, shape):
    """``x.reshape(shape)``. A DTensor (``ParallelExecutor``'s global
    view) goes through ``_DTensorReshape``, whose backward makes the
    incoming gradient's local block contiguous before the inverse view:
    after a transpose's backward that block is permuted."""
    if hasattr(x, "device_mesh") and hasattr(x, "placements"):
        return _DTensorReshape.apply(x, tuple(shape))
    return x.reshape(shape)


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
