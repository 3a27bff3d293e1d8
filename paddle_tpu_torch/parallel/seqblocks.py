"""Sequence blocks: the LM's per-position ops on each rank's [B, T]
block, where ``sp`` is a DTensor axis (``parallel/mesh.py``).

Under ``dp`` x ``sp`` the LM's activations are DTensors split on the
batch and the sequence from the embedding lookup to the loss. DTensor
cannot flatten B and T while T is split without gathering it (the H100's
PyTorch 2.11 refuses the view), and once flattened, the rows of each
rank's block are a ``_StridedShard``, which its pointwise and gather
strategies gather whole. So the ops the LM runs there take one rule each
here, dispatched from one hook (``lower``, called for every op of a
``ParallelExecutor`` step through ``parallel/blocks.lower``):

  * ``mul`` with ``x_num_col_dims`` > 1 of an X split inside its leading
    dims and Replicate weights: the op's own lowering on each rank's
    positions, each weight's gradient its rank's addend (Partial);
  * ``reshape``/``reshape2`` of [B, T, ...] split on T to [B*T, ...]:
    each rank's block flattened to rows (``_FlattenRows``);
  * ``softmax_with_cross_entropy`` and the binary ``elementwise_*`` ops
    of inputs laid out alike, one a row or an element of each other: the
    op's own lowering on the blocks, the outputs laid out as the inputs;
  * ``reduce_sum`` with ``reduce_all`` of a flattened block: each
    rank's sum, Partial (``_LocalSum``).

A rule that does not match the layout it meets leaves the op to its
lowering on the DTensors. DTensor's own collectives in such a step stay
all-reduces.
"""

import math

import torch

from . import collective as C

__all__ = ["lower"]


def _is_dtensor(x):
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _is_strided(p):
    from torch.distributed.tensor import placement_types
    kind = getattr(placement_types, "_StridedShard", None)
    return kind is not None and isinstance(p, kind)


def _splits(p):
    """Whether placement ``p`` splits a dim: a Shard, or a
    ``_StridedShard`` (a Shard's subclass in some PyTorch releases, not
    in others)."""
    return p.is_shard() or _is_strided(p)


def _strided(x):
    return any(_is_strided(p) for p in x.placements)


def _run_local(ctx, op, fn, local, like, slots):
    """``fn(ctx, op)`` with the inputs ``local`` ({name: this rank's
    block}) in place of their DTensors; each output of ``slots`` it sets
    becomes a DTensor laid out as DTensor ``like``, its split dims as
    long as ``like``'s."""
    from ._shard_map import _FromLocal
    outs = [n for s in slots for n in op.output(s)]
    before = {n: ctx.env.get(n) for n in outs}
    saved = {n: ctx.env[n] for n in local}
    ctx.env.update(local)
    try:
        fn(ctx, op)
    finally:
        for n, v in saved.items():
            if ctx.env.get(n) is local[n]:
                ctx.env[n] = v
    pl = list(like.placements)
    for n in outs:
        y = ctx.env.get(n)
        if y is before[n] or not isinstance(y, torch.Tensor):
            continue
        shape = list(y.shape)
        for p in pl:
            if _splits(p):
                shape[p.dim] = like.shape[p.dim]
        ctx.env[n] = _FromLocal.apply(y, ctx.mesh, pl, torch.Size(shape))
    return True


def _mul(ctx, op, fn):
    """[B, T, D] split on T (and on B) times Replicate weights, on each
    rank's positions; a weight's gradient is its rank's addend."""
    from torch.distributed.tensor import Partial, Replicate
    xn = op.attr("x_num_col_dims", 1)
    x, y = ctx.in1(op, "X"), ctx.in1(op, "Y")
    if xn < 2 or not _is_dtensor(x) or not _is_dtensor(y):
        return False
    pl = list(x.placements)
    if any(p.is_partial() or (_splits(p) and p.dim >= xn) for p in pl) \
            or not any(_splits(p) and 0 < p.dim < xn for p in pl) \
            or any(not p.is_replicate() for p in y.placements):
        return False
    grad = [Partial() if _splits(p) else Replicate() for p in pl]
    local = {op.input("X")[0]: x.to_local(),
             op.input("Y")[0]: y.to_local(grad_placements=grad)}
    return _run_local(ctx, op, fn, local, x, ("Out",))


def _alike(ctx, op, fn, in_slots, out_slots, strided):
    """The op's inputs of ``in_slots``: DTensors laid out alike, split on
    no last dim (one of them a ``_StridedShard`` where ``strided``),
    each output row reading only the same row of each input: on the
    blocks."""
    xs = [ctx.in1(op, s) for s in in_slots]
    if not all(_is_dtensor(x) for x in xs) or \
            len({n for s in in_slots for n in op.input(s)}) != len(xs):
        return False
    pl = tuple(xs[0].placements)
    if any(tuple(x.placements) != pl or x.dim() != xs[0].dim()
           for x in xs) or (strided and not _strided(xs[0])) or any(
            p.is_partial() or (_splits(p) and p.dim >= xs[0].dim() - 1)
            for p in pl):
        return False
    local = {op.input(s)[0]: x.to_local() for s, x in zip(in_slots, xs)}
    return _run_local(ctx, op, fn, local, xs[0], out_slots)


def _xent(ctx, op, fn):
    """A loss a row, on each rank's rows as they are laid out."""
    return _alike(ctx, op, fn, ("Logits", "Label"), ("Loss", "Softmax"),
                  strided=False)


def _elementwise(ctx, op, fn):
    """An elementwise op of one shape on flattened blocks."""
    x, y = ctx.in1(op, "X"), ctx.in1(op, "Y")
    if not _is_dtensor(x) or not _is_dtensor(y) or x.shape != y.shape:
        return False
    return _alike(ctx, op, fn, ("X", "Y"), ("Out",), strided=True)


class _LocalSum(torch.autograd.Function):
    """The sum of every element of DTensor ``x``: each rank's local sum,
    Partial over the mesh dims ``x`` is split on; the backward hands the
    gradient back laid out as ``x`` (DTensor's own sum would bring it back
    Replicate on a ``_StridedShard`` dim, and its product with a value
    laid out as ``x`` then gathers)."""

    @staticmethod
    def forward(ctx, x, mesh):
        from torch.distributed.tensor import DTensor, Partial
        ctx.mesh, ctx.placements = mesh, list(x.placements)
        ctx.shape, ctx.stride = x.shape, x.stride()
        local = x.to_local()
        ctx.local_shape = local.shape
        out = [Partial() if _splits(p) else p for p in ctx.placements]
        return DTensor.from_local(local.sum(), x.device_mesh, out,
                                  run_check=False, shape=torch.Size(()),
                                  stride=())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate
        dm = ctx.mesh.dtensor_mesh
        g = C.move_local(g.to_local(), list(g.placements),
                         [Replicate()] * dm.ndim, dm)
        g = g.expand(ctx.local_shape).contiguous()
        return DTensor.from_local(g, dm, ctx.placements, run_check=False,
                                  shape=ctx.shape, stride=ctx.stride), None


def _reduce_sum(ctx, op, fn):
    """The sum of every element of a flattened block, on the blocks."""
    from ..ops.common import lod_valid_mask
    x = ctx.in1(op, "X")
    if not _is_dtensor(x) or not _strided(x) or op.attr("keep_dim", False) \
            or not op.attr("reduce_all", False) \
            or lod_valid_mask(ctx, op)[0] is not None:
        return False
    ctx.set_out(op, "Out", _LocalSum.apply(x, ctx.mesh))
    return True


class _FlattenRows(torch.autograd.Function):
    """[B, T, ...] split on T (and on B) -> the [B*T, ...] rows of each
    rank's block, locally: Shard(1) becomes ``_StridedShard(0,
    split_factor=b)`` (b the rows of the local B), Shard(0) stays. The
    backward takes the gradient back the same way."""

    @staticmethod
    def forward(ctx, x, mesh, rest):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.placement_types import _StridedShard
        local = x.to_local()
        ctx.mesh, ctx.placements = mesh, list(x.placements)
        ctx.shape, ctx.local_shape = x.shape, local.shape
        pl = [_StridedShard(0, split_factor=local.shape[0])
              if _splits(p) and p.dim == 1 else p for p in ctx.placements]
        ctx.out_placements = pl
        shape = (x.shape[0] * x.shape[1],) + rest
        out = local.reshape((-1,) + rest)
        return DTensor.from_local(out, x.device_mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        dm = ctx.mesh.dtensor_mesh
        local = C.move_local(g.to_local(), list(g.placements),
                             ctx.out_placements, dm)
        local = local.reshape(ctx.local_shape)
        return DTensor.from_local(local, dm, ctx.placements,
                                  run_check=False, shape=ctx.shape,
                                  stride=torch.empty(
                                      ctx.shape, device="meta").stride()), \
            None, None


def _reshape(ctx, op, fn):
    """[B, T, ...] split on T reshaped to [B*T (or -1), ...] (the
    trailing dims any shape of the same size) on each rank's block."""
    x = ctx.in1(op, "X")
    if not _is_dtensor(x) or x.dim() < 2:
        return False
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(op.attr("shape"))]
    rest = tuple(int(d) for d in shape[1:])
    if not shape or -1 in rest or \
            math.prod(rest) != math.prod(x.shape[2:]) or \
            shape[0] not in (-1, x.shape[0] * x.shape[1]):
        return False
    pl = list(x.placements)
    if any(p.is_partial() or (_splits(p) and p.dim >= 2) for p in pl) \
            or sum(_splits(p) and p.dim == 1 for p in pl) != 1:
        return False
    ctx.set_out(op, "Out", _FlattenRows.apply(x, ctx.mesh, rest))
    return True


RULES = {"mul": _mul, "reshape": _reshape, "reshape2": _reshape,
         "softmax_with_cross_entropy": _xent, "reduce_sum": _reduce_sum}


def lower(ctx, op, fn):
    """Lower ``op`` (``fn(ctx, op)``) by its rule where it has one and
    the layout it meets matches (the module docstring), else by ``fn``."""
    rule = RULES.get(op.type) or (
        _elementwise if op.type.startswith("elementwise_") else None)
    if rule is None or not rule(ctx, op, fn):
        fn(ctx, op)
