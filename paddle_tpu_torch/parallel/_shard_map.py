"""``shard_map`` for one process a rank.

The counterpart of ``paddle_tpu/parallel/_shard_map.py`` (which imports
``jax.shard_map``). ``shard_map(fn, mesh, in_specs, out_specs)`` runs
``fn`` on this rank's blocks, with ``mesh`` bound so the body's
collectives (``collective.psum(x, "sp")`` ...) resolve axis names, and
puts the blocks of the result back together.

A value enters as a DTensor (``ParallelExecutor``'s global view over
the DTensor sub-mesh, ``parallel/mesh.py``: its local block is moved to
the spec's placements there by the port's collectives, then sliced by
hand along the manual axes it is split on; a block already laid out as
the spec wants moves nothing), as a held block (a plain tensor marked
by ``held``: this rank's block of a value placed by its hint, taken as
it is on every dim where the spec names the same axes, gathered or
sliced on the others), or as a plain tensor, which every rank holds
whole (its block is a slice). A plain result is gathered whole again;
a DTensor result is this rank's block, placed as the out spec says (no
gather over the DTensor axes). Gradients follow JAX's rule for
``check_vma=False``, which keeps every composition exact: an input's
gradient is summed over the mesh axes its spec leaves out (each rank's
body may use a replicated value for part of the work), and an output's
incoming gradient is divided by the sizes of the axes its spec leaves
out (every rank holds the same replicated cotangent); inside the body
each collective's backward is its plain transpose
(``parallel/collective.py``).
"""

import torch

from . import collective as C
from .mesh import PartitionSpec, spec_axes

__all__ = ["shard_map", "relayout", "held", "spec_of"]


def _is_dtensor(x):
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _tree_map(fn, tree, specs):
    """Map ``fn(leaf, spec)`` over the tensors of ``tree``. ``specs`` is
    a PartitionSpec (for every leaf below it) or the tree's structure."""
    if isinstance(specs, PartitionSpec) or specs is None:
        spec = specs if specs is not None else PartitionSpec()
        if isinstance(tree, dict):
            return {k: _tree_map(fn, v, spec) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_tree_map(fn, v, spec) for v in tree)
        return fn(tree, spec) if isinstance(tree, torch.Tensor) else tree
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs) if isinstance(tree, torch.Tensor) else tree


def _any_dtensor(tree):
    if isinstance(tree, dict):
        return any(_any_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_any_dtensor(v) for v in tree)
    return _is_dtensor(tree)


def _layout(mesh, spec, ndim):
    """(dims: [(dim, axes)] of the mentioned axes of size > 1, the
    unmentioned axes of size > 1)."""
    dims, used = [], set()
    for dim, entry in enumerate(tuple(spec)[:ndim]):
        axes = tuple(a for a in spec_axes(entry)
                     if mesh.shape.get(a, 1) > 1)
        if axes:
            dims.append((dim, axes))
            used.update(axes)
    free = tuple(a for a in mesh.axis_names
                 if a not in used and mesh.shape[a] > 1)
    return dims, free


def _size(mesh, axes):
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _block(mesh, x, dims):
    for dim, axes in dims:
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.axis_index(a)
        c = x.shape[dim] // _size(mesh, axes)
        x = x.narrow(dim, idx * c, c)
    return x


def _gather(mesh, x, dims):
    """The whole tensor from the blocks (no autograd): over a dim split
    on several axes the minor one gathers first."""
    for dim, axes in dims:
        for a in reversed(axes):
            x = C._raw_all_gather(x, mesh.group(a), dim)
    return x


class _EnterPlain(torch.autograd.Function):
    """A plain tensor, split on the dims of ``have`` (a held block's;
    whole on the others) -> this rank's block on the dims of ``dims``:
    a dim split the same way stays as it is, the others are gathered,
    then sliced. The backward takes the block's gradient back the same
    way, summed over the unmentioned axes ``free`` (a held dim the spec
    does not name is one: its gradient is summed, then sliced)."""

    @staticmethod
    def forward(ctx, x, mesh, have, dims, free):
        regather = [d for d in have if d not in dims]
        recut = [d for d in dims if d not in have]
        ctx.mesh, ctx.regather, ctx.recut, ctx.free = (mesh, regather,
                                                       recut, free)
        if not regather and not recut:
            return x.view_as(x)
        return _block(mesh, _gather(mesh, x.contiguous(), regather),
                      recut).clone()

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = _gather(mesh, g.contiguous(), ctx.recut)
        for a in ctx.free:
            g = C._raw_all_reduce(g, mesh.group(a))
        g = _block(mesh, g, ctx.regather)
        return g, None, None, None, None


class _ExitPlain(torch.autograd.Function):
    """This rank's block -> the whole tensor; backward takes the block of
    the (replicated) cotangent, divided by the unmentioned axes' sizes."""

    @staticmethod
    def forward(ctx, y, mesh, dims, free):
        ctx.mesh, ctx.dims, ctx.free = mesh, dims, free
        return _gather(mesh, y.contiguous(), dims)

    @staticmethod
    def backward(ctx, g):
        g = _block(ctx.mesh, g, ctx.dims)
        scale = _size(ctx.mesh, ctx.free)
        return (g / scale if scale > 1 else g.clone()), None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale):
        ctx.scale = scale
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _split(mesh, layout):
    """A (dims, free) layout split into its ``dtensor_mesh`` part and the
    part worked by hand (the module docstring). Over a dim split on both
    kinds of axes the DTensor axes must be the major ones."""
    daxes = mesh.dtensor_axes
    dims, free = layout
    d_dims, m_dims = [], []
    for dim, axes in dims:
        d = tuple(a for a in axes if a in daxes)
        m = tuple(a for a in axes if a not in daxes)
        if d and m and axes != d + m:
            raise ValueError("a dim split over %s must name %s first"
                             % (axes, d))
        if d:
            d_dims.append((dim, d))
        if m:
            m_dims.append((dim, m))
    return ((d_dims, tuple(a for a in free if a in daxes)),
            (m_dims, tuple(a for a in free if a not in daxes)))


def _placements(mesh, dims):
    """Placements over ``dtensor_mesh``: Shard on the mentioned axes,
    Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    daxes = mesh.dtensor_axes
    out = [Replicate() for _ in daxes]
    for dim, axes in dims:
        for a in axes:
            out[daxes.index(a)] = Shard(dim)
    return out


def _dtensor_local(mesh, x, d_dims):
    """This rank's block of DTensor ``x`` laid out Shard on ``d_dims``'
    axes and Replicate elsewhere, moved by the port's collectives
    (``DTensor.redistribute`` calls gloo's own, and gloo crashes on an
    all-gather of CUDA tensors in some PyTorch releases). Gathers and
    sums go minor axis first, slices major first, as DTensor orders a
    dim split over two mesh dims. The local block's gradient is the
    shard's own (a Shard placement, gathered back by the all-gather's
    transpose), each rank's addend (Partial, from a Replicate one) or
    the whole (Replicate, from a Partial one)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    daxes = mesh.dtensor_axes
    want = _placements(mesh, d_dims)
    have = list(x.placements)
    grad = [p if isinstance(p, Shard) else
            Replicate() if isinstance(p, Partial) or mesh.shape[a] <= 1
            else Partial() for a, p in zip(daxes, have)]
    local = x.to_local(grad_placements=grad)
    for a, p, t in reversed(list(zip(daxes, have, want))):
        if mesh.shape[a] <= 1 or p == t:
            continue
        if isinstance(p, Partial):
            local = C.psum(local, a)
        elif isinstance(p, Shard):
            local = C.all_gather(local, a, p.dim)
    for a, p, t in zip(daxes, have, want):
        if mesh.shape[a] > 1 and isinstance(t, Shard) and p != t:
            c = local.shape[t.dim] // mesh.shape[a]
            local = local.narrow(t.dim, mesh.axis_index(a) * c, c)
    return local


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose backward brings the incoming
    gradient to this block's placements with the port's collectives
    (``DTensor.from_local``'s own backward would redistribute it through
    gloo's)."""

    @staticmethod
    def forward(ctx, y, mesh, placements, shape):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.placements = mesh, placements
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(y, mesh.dtensor_mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=stride)

    @staticmethod
    def backward(ctx, g):
        if not _is_dtensor(g):
            return g, None, None, None
        return (C.move_local(g.to_local(), list(g.placements),
                             ctx.placements, g.device_mesh),
                None, None, None)


def relayout(mesh, x, spec):
    """DTensor ``x`` laid out as ``spec`` over ``mesh.dtensor_mesh``
    (Shard on the named axes, Replicate elsewhere), moved by the port's
    collectives; a plain tensor passes through."""
    if not _is_dtensor(x):
        return x
    with C.bound_mesh(mesh):
        return _exit(mesh, _enter(mesh, x, spec), spec, True)


def held(x, spec):
    """Mark plain tensor ``x`` as this rank's block of a value placed by
    hint ``spec`` (``parallel/blocks.py``): a region takes it as it is
    where its in spec names the same axes. Returns ``x``."""
    x._ptpu_held = tuple(spec)
    return x


def spec_of(mesh, x, drop=None):
    """The PartitionSpec of DTensor ``x``'s placements (the mesh axes
    that shard each dim, in mesh order), without a Shard(``drop``)."""
    from torch.distributed.tensor import Shard
    dims = [[] for _ in range(x.dim())]
    for a, p in zip(mesh.dtensor_axes, x.placements):
        if isinstance(p, Shard) and p.dim != drop:
            dims[p.dim].append(a)
    return PartitionSpec(*[tuple(d) if len(d) > 1 else (d[0] if d else None)
                           for d in dims])


def _enter(mesh, x, spec):
    (d_dims, _), (dims, free) = _split(mesh, _layout(mesh, spec, x.dim()))
    have = []
    if _is_dtensor(x):
        x = _dtensor_local(mesh, x, d_dims)
    else:
        dims, free = _layout(mesh, spec, x.dim())
        mark = getattr(x, "_ptpu_held", None)
        if mark is not None:
            have = _layout(mesh, mark, x.dim())[0]
    if not dims and not free and not have:
        return x
    return _EnterPlain.apply(x, mesh, have, dims, free)


def _exit(mesh, y, spec, as_dtensor):
    (d_dims, d_free), (dims, free) = _split(mesh,
                                            _layout(mesh, spec, y.dim()))
    if not as_dtensor:
        dims, free = _layout(mesh, spec, y.dim())
    if dims or free:
        y = _ExitPlain.apply(y, mesh, dims, free)
    if not as_dtensor:
        return y
    if d_free:
        y = _ScaleGrad.apply(y, 1.0 / _size(mesh, d_free))
    shape = list(y.shape)
    for dim, axes in d_dims:
        shape[dim] *= _size(mesh, axes)
    return _FromLocal.apply(y, mesh, _placements(mesh, d_dims),
                            torch.Size(shape))


def shard_map(fn, mesh, in_specs, out_specs, check_vma=False):
    """``fn`` over this rank's blocks of its arguments (see the module
    docstring). ``in_specs``: one spec (or spec tree) a positional
    argument; ``out_specs``: a spec or a tree of them."""
    del check_vma   # the gradient rule is always JAX's check_vma=False

    def run(*args):
        with C.bound_mesh(mesh):
            if mesh.size <= 1:
                return fn(*args)
            as_dtensor = _any_dtensor(args)
            local = tuple(_tree_map(lambda x, s: _enter(mesh, x, s), a, s)
                          for a, s in zip(args, in_specs))
            out = fn(*local)
            return _tree_map(lambda y, s: _exit(mesh, y, s, as_dtensor),
                             out, out_specs)

    return run
