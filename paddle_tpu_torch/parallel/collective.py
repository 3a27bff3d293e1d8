"""Collective communication: the Program ops and the functional
collectives of the parallel tier.

The counterpart of ``paddle_tpu/parallel/collective.py``. Two parts:

  * the Program ops ``c_allreduce_sum``, ``c_allreduce_max``,
    ``c_allgather``, ``c_reducescatter``, ``c_broadcast``, ``all_to_all``
    and ``c_sync_comm_stream``. Without a mesh each is the identity, as
    in the JAX package. With one (``ParallelExecutor``'s) they act as the
    reference's NCCL ops do, on each rank's own value over the op's axis
    (attr ``ring_id_axis`` or ``axis_name``, default ``dp``): a DTensor
    value contributes its local shard and the op's output is that rank's
    plain result;
  * the functional collectives the parallel modules call inside a
    ``shard_map`` body (``parallel/_shard_map.py``), by mesh axis name
    as ``lax`` names them: ``psum``, ``pmean``, ``pmax``,
    ``all_gather``, ``psum_scatter``, ``all_to_all``, ``ppermute``,
    ``axis_index``, ``axis_size``. Each is a ``torch.autograd.Function``
    whose backward is its transpose, as JAX derives it: psum's is psum,
    all_gather's psum_scatter and back, all_to_all's the reverse
    all_to_all, ppermute's the inverse permutation. A tuple of tensors
    rides one call (one autograd node), so every rank's backward meets
    the same collectives in the same order.

Transport. An NCCL group takes device tensors as they are. A gloo group
takes CPU tensors; for CUDA tensors under gloo the buffer goes through
pinned host memory and back, and the bytes moved each way are added to
``collective.staged_bytes`` (several ranks sharing one card can only
talk through gloo: NCCL refuses two ranks on one device). Staging moves
buffers only: every product and every attention stays on the card. An
NCCL group never stages. Each collective has one form on either
backend: ``all_reduce``; ``all_gather``'s list form; a reduce-scatter
as an all-reduce and this rank's chunk; point-to-point sends for
ppermute and the all-to-all (gloo has no ``alltoall`` in every
release). Over gloo on an H100 host (PyTorch 2.11) the 4-rank LM steps
ran faster with these than with ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` (PERF.md, the parallel tier).
"""

import contextlib
import threading

import torch
import torch.distributed as dist

from ..core.registry import register

__all__ = ["allreduce", "barrier", "psum", "pmean", "pmax", "all_gather",
           "psum_scatter", "all_to_all", "ppermute", "axis_index",
           "axis_size", "bound_mesh", "global_value", "move_local",
           "staged_bytes"]

# bytes copied device -> host and host -> device for CUDA tensors under a
# gloo group (see the module docstring)
staged_bytes = 0

_local = threading.local()


# -- the mesh a shard_map body runs under ------------------------------------
@contextlib.contextmanager
def bound_mesh(mesh):
    """Bind ``mesh`` so the functional collectives resolve axis names
    against it (``shard_map`` binds its mesh around the body)."""
    stack = _local.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _mesh():
    stack = getattr(_local, "stack", None)
    if not stack:
        raise RuntimeError(
            "a collective over a named mesh axis must run inside a "
            "shard_map body (parallel/_shard_map.py)")
    return stack[-1]


def _axes(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_size(axis):
    """``lax.psum(1, axis)``: the number of ranks along ``axis``."""
    mesh = _mesh()
    n = 1
    for a in _axes(axis):
        n *= mesh.shape.get(a, 1)
    return n


def axis_index(axis):
    """``lax.axis_index``: this rank's coordinate along ``axis`` (a tuple
    of axes counts row-major, the first the major one)."""
    mesh = _mesh()
    idx = 0
    for a in _axes(axis):
        idx = idx * mesh.shape.get(a, 1) + mesh.axis_index(a)
    return idx


# -- transport ----------------------------------------------------------------
def _stages(group, tensors):
    return dist.get_backend(group) == "gloo" and \
        any(t.is_cuda for t in tensors)


def _host(t):
    global staged_bytes
    staged_bytes += t.numel() * t.element_size()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _back(h, like):
    global staged_bytes
    staged_bytes += h.numel() * h.element_size()
    return h.to(like.device, non_blocking=False)


def _pinned_like(t):
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _raw_all_reduce(x, group, op=dist.ReduceOp.SUM):
    if group is None:
        return x.clone()
    if _stages(group, [x]):
        h = _host(x.contiguous())
        dist.all_reduce(h, op=op, group=group)
        return _back(h, x)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _raw_all_gather(x, group, dim):
    """Tiled all-gather: the group's chunks concatenated along ``dim``
    in group-rank order."""
    if group is None:
        return x.clone()
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    stage = _stages(group, [x])
    src = _host(xm) if stage else xm
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    if stage:
        out = _back(out, x)
    return out.movedim(0, dim)


def _raw_psum_scatter(x, group, dim):
    """Tiled reduce-scatter: sum over the group, chunk r of ``dim`` kept
    by group rank r."""
    if group is None:
        return x.clone()
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError("psum_scatter: dim %d of size %d does not split "
                         "over %d ranks" % (dim, xm.shape[0], n))
    shape = (xm.shape[0] // n,) + xm.shape[1:]
    stage = _stages(group, [x])
    src = _host(xm) if stage else xm
    full = src.clone()
    dist.all_reduce(full, group=group)
    r = dist.get_rank(group)
    out = full[r * shape[0]:(r + 1) * shape[0]].contiguous()
    if stage:
        out = _back(out, x)
    return out.movedim(0, dim)


def _raw_all_to_all(x, group, split, concat):
    """Tiled all-to-all: chunk j of ``split`` goes to group rank j, the
    received chunks are concatenated along ``concat`` in rank order."""
    if group is None:
        return x.clone()
    n = dist.get_world_size(group)
    if x.shape[split] % n:
        raise ValueError("all_to_all: dim %d of size %d does not split "
                         "over %d ranks" % (split, x.shape[split], n))
    chunks = [c.contiguous() for c in x.chunk(n, dim=split)]
    stage = _stages(group, [x])
    send = [_host(c) for c in chunks] if stage else chunks
    recv = [_pinned_like(c) if stage else torch.empty_like(c)
            for c in chunks]
    # pairwise sends: not every PyTorch release's gloo has alltoall
    me = dist.get_rank(group)
    recv[me].copy_(send[me])
    ops = []
    for j in range(n):
        if j != me:
            peer = dist.get_global_rank(group, j)
            ops.append(dist.P2POp(dist.isend, send[j], peer, group))
            ops.append(dist.P2POp(dist.irecv, recv[j], peer, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if stage:
        recv = [_back(r, x) for r in recv]
    return torch.cat(recv, dim=concat)


def _raw_ppermute(xs, group, perm):
    """Send each of ``xs`` from src to dst for every (src, dst) pair of
    ``perm`` (group ranks); a rank that receives nothing gets zeros, as
    ``lax.ppermute`` gives."""
    if group is None:
        return [x.clone() if (0, 0) in perm else torch.zeros_like(x)
                for x in xs]
    me = dist.get_rank(group)
    xs = [x.contiguous() for x in xs]
    stage = _stages(group, xs)
    outs = [torch.zeros(x.shape, dtype=x.dtype, device=x.device)
            for x in xs]
    recv_bufs = [_pinned_like(x) if stage else o for x, o in zip(xs, outs)]
    ops, received = [], False
    for src, dst in perm:
        if src == me and dst == me:
            for o, x in zip(outs, xs):
                o.copy_(x)
            continue
        if src == me:
            peer = dist.get_global_rank(group, dst)
            for x in xs:
                buf = _host(x) if stage else x
                ops.append(dist.P2POp(dist.isend, buf, peer, group))
        if dst == me:
            peer = dist.get_global_rank(group, src)
            received = True
            for b in recv_bufs:
                ops.append(dist.P2POp(dist.irecv, b, peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if stage and received:
        outs = [_back(b, x) for b, x in zip(recv_bufs, xs)]
    return outs


# -- DTensor layouts moved by these collectives --------------------------------
def _lines(device_mesh):
    """(group, size, this rank's index) of each dim of a DeviceMesh."""
    return [(device_mesh.get_group(i) if device_mesh.size(i) > 1 else None,
             device_mesh.size(i), device_mesh.get_local_rank(i))
            for i in range(device_mesh.ndim)]


def move_local(local, have, want, device_mesh):
    """A DTensor's local block under placements ``have`` as the block
    under ``want`` (no autograd): sums and gathers over the minor mesh dim
    first, then slices, as DTensor orders a dim split over two mesh
    dims. DTensor's own redistribution calls its functional collectives,
    which crash on gloo with CUDA tensors in some PyTorch releases."""
    from torch.distributed.tensor import Partial, Shard
    lines = _lines(device_mesh)
    for (group, n, _), p, t in reversed(list(zip(lines, have, want))):
        if n <= 1 or p == t:
            continue
        if isinstance(p, Partial):
            local = _raw_all_reduce(local, group)
        elif isinstance(p, Shard):
            local = _raw_all_gather(local, group, p.dim)
    for (_, n, idx), p, t in zip(lines, have, want):
        if n > 1 and isinstance(t, Shard) and p != t:
            if local.shape[t.dim] % n:
                raise ValueError(
                    "dim %d of size %d does not split over %d ranks"
                    % (t.dim, local.shape[t.dim], n))
            c = local.shape[t.dim] // n
            local = local.narrow(t.dim, idx * c, c)
    return local.contiguous()


def global_value(v):
    """The whole value of DTensor ``v`` on every rank (``full_tensor``
    through these collectives; every rank of its mesh must call it)."""
    from torch.distributed.tensor import Replicate
    with torch.no_grad():
        return move_local(v.to_local(), list(v.placements),
                          [Replicate()] * v.device_mesh.ndim,
                          v.device_mesh)


# -- the differentiable collectives -------------------------------------------
def _group(axis):
    return _mesh().group(axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _raw_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _raw_all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_psum_scatter(g, ctx.group, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _raw_psum_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, split, concat, *xs):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return tuple(_raw_all_to_all(x, group, split, concat) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None) + tuple(
            None if g is None else
            _raw_all_to_all(g, ctx.group, ctx.concat, ctx.split)
            for g in gs)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, perm, *xs):
        ctx.group, ctx.perm = group, perm
        return tuple(_raw_ppermute(list(xs), group, perm))

    @staticmethod
    def backward(ctx, *gs):
        inv = [(d, s) for s, d in ctx.perm]
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None, None) + tuple(_raw_ppermute(gs, ctx.group, inv))


def psum(x, axis):
    """``lax.psum`` over one axis or a tuple of axes."""
    for a in _axes(axis):
        if axis_size(a) > 1:
            x = _Psum.apply(x, _group(a))
    return x


def pmean(x, axis):
    return psum(x, axis) / axis_size(axis)


def pmax(x, axis):
    """``lax.pmax`` (not differentiated)."""
    for a in _axes(axis):
        if axis_size(a) > 1:
            x = _raw_all_reduce(x.detach(), _group(a), dist.ReduceOp.MAX)
    return x


def all_gather(x, axis, dim=0, tiled=True):
    """``lax.all_gather(..., tiled=True)`` along ``dim``; over a tuple of
    axes the minor axis gathers first, so chunks land row-major."""
    if not tiled:
        x = x.unsqueeze(dim)
    for a in reversed(_axes(axis)):
        if axis_size(a) > 1:
            x = _AllGather.apply(x, _group(a), dim)
    return x


def psum_scatter(x, axis, dim=0, tiled=True):
    """``lax.psum_scatter(..., tiled=True)`` along ``dim``."""
    for a in _axes(axis):
        if axis_size(a) > 1:
            x = _PsumScatter.apply(x, _group(a), dim)
    return x


def all_to_all(x, axis, split_axis, concat_axis, tiled=True):
    """``lax.all_to_all(..., tiled=True)``; ``x`` a tensor or a tuple of
    tensors (one autograd node for all of them)."""
    many = isinstance(x, (tuple, list))
    xs = tuple(x) if many else (x,)
    if axis_size(axis) > 1:
        xs = _AllToAll.apply(_group(axis), split_axis, concat_axis, *xs)
    return tuple(xs) if many else xs[0]


def ppermute(x, axis, perm):
    """``lax.ppermute``: ``perm`` is a list of (source, destination) axis
    coordinates; ``x`` a tensor or a tuple of tensors (one autograd
    node for all of them)."""
    many = isinstance(x, (tuple, list))
    xs = tuple(x) if many else (x,)
    perm = [(int(s), int(d)) for s, d in perm]
    if axis_size(axis) > 1:
        xs = _PPermute.apply(_group(axis), perm, *xs)
    elif (0, 0) not in perm:
        xs = tuple(torch.zeros_like(t) for t in xs)
    return tuple(xs) if many else xs[0]


def allreduce(x, axis_name="dp"):
    """Functional helper for shard_map bodies."""
    return psum(x, axis_name)


def barrier(mesh):
    """Host-side barrier over every rank of ``mesh`` (send_barrier
    parity)."""
    if mesh.size > 1:
        dist.barrier()


# -- the Program ops ------------------------------------------------------------
def _axis(op, default="dp"):
    return op.attr("ring_id_axis", op.attr("axis_name", default))


def _op_collective(ctx, op, fn):
    """A collective op on this rank's own value: the identity without a
    mesh (or over an axis of one rank)."""
    x = ctx.in1(op, "X")
    axis = _axis(op)
    mesh = ctx.mesh
    if mesh is not None and mesh.shape.get(axis, 1) > 1:
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            x = x.to_local()
        with bound_mesh(mesh):
            x = fn(x, axis)
    ctx.set_out(op, "Out", x)


@register("c_allreduce_sum")
def _c_allreduce_sum(ctx, op):
    _op_collective(ctx, op, psum)


@register("c_allreduce_max")
def _c_allreduce_max(ctx, op):
    _op_collective(ctx, op, pmax)


@register("c_allgather")
def _c_allgather(ctx, op):
    _op_collective(ctx, op, lambda x, a: all_gather(x, a, 0))


@register("c_reducescatter")
def _c_reducescatter(ctx, op):
    _op_collective(ctx, op, lambda x, a: psum_scatter(x, a, 0))


@register("c_broadcast")
def _c_broadcast(ctx, op):
    # root's value everywhere; in the global view the value is already
    # consistent, so this is an identity (parity with ncclBcast of
    # params, parallel_executor.cc:115)
    ctx.set_out(op, "Out", ctx.in1(op, "X"))


@register("all_to_all")
def _all_to_all(ctx, op):
    split_axis = int(op.attr("split_axis", 0))
    concat_axis = int(op.attr("concat_axis", 0))
    _op_collective(ctx, op, lambda x, a: all_to_all(x, a, split_axis,
                                                    concat_axis))


@register("c_sync_comm_stream")
def _c_sync(ctx, op):
    # the collectives above complete before they return; nothing waits
    for name, out in zip(op.input("X"), op.output("Out")):
        ctx.env[out] = ctx.get(name)
