"""Held blocks: each rank's block of a persistable placed on the manual
mesh axes.

The JAX package places a stage weight on ``pp`` and an expert weight on
``ep`` by its hint (``layers/parallel_layers.py``), and GSPMD keeps each
device's shard between steps. The port does the same outside DTensor
(``parallel/mesh.py`` says which axes are manual): ``ParallelExecutor``
keeps such a persistable as a plain tensor holding this rank's block on
every axis its hint names (``mesh.block_slices``), and the scope holds
it between steps as a ``Held`` tensor, which knows its hint and its
global shape. Adam's moments and the other accumulators of such a
parameter (the inputs of its optimizer op of the parameter's shape)
follow it (``held_specs``).

Inside a step a held value is the plain block. Who reads it how
(``lower``):

  * the regions that take it as it is: ``pipeline_stack`` and
    ``moe_ffn`` mark it (``_shard_map.held``) and their shard_map takes
    the block without a slice, its gradient the block's own, summed over
    the axes its spec leaves out;
  * an optimizer op of a held parameter (an op with a ``Param`` input)
    updates the blocks: its replicated inputs (the learning rate, the
    beta powers) enter as their local values, and a whole input of the
    parameter's shape (a gradient a consumer made whole) as its block;
  * any other op gets the value gathered whole (``_Gather``: the
    block's gradient is its block of the whole's; a Replicate DTensor
    where the op has DTensor inputs), as a fetch and a save do
    (``collective.global_value``).

No step re-slices a gathered copy: the blocks persist in the scope from
one ``run`` to the next, ``run_steps``' K calls included. ``lower`` is
the one hook a ``ParallelExecutor`` step's lowerings pass through: it
hands every op on to its sequence-block rule where it has one
(``parallel/seqblocks.py``).
"""

import torch

from . import collective as C
from .mesh import block_slices, spec_axes

__all__ = ["Held", "held_specs", "block_of", "whole", "lower"]

# the ops that take their held inputs as they are (their lowerings read
# ``ctx.held_spec``)
REGION_OPS = ("pipeline_stack", "moe_ffn")


class Held(torch.Tensor):
    """A scope value that is this rank's block: ``spec`` (its hint),
    ``mesh``, ``global_shape``. Ops on it give plain tensors; its whole
    value is ``full_tensor()``, a gather every rank of the mesh makes,
    as a DTensor's."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, block, spec, mesh, global_shape):
        t = torch.Tensor._make_subclass(cls, block.detach(), False)
        t.spec = tuple(spec)
        t.mesh = mesh
        t.global_shape = tuple(global_shape)
        return t

    def local(self):
        """The block as a plain tensor (the same storage)."""
        return self.as_subclass(torch.Tensor)

    def full_tensor(self):
        return whole(self.mesh, self.spec, self.local())


def held_specs(program, mesh):
    """``{name: spec}`` of the persistables this rank holds as blocks:
    those whose hint names a manual axis of ``mesh``, and the other
    persistable inputs of such a parameter's optimizer op that have its
    shape (its accumulators)."""
    manual = set(mesh.manual_axes)
    if not manual:
        return {}
    block = program.global_block()
    pers = {v.name: v for v in block.vars.values() if v.persistable}
    out = {}
    for name, spec in program._sharding_hints.items():
        if name in pers and any(a in manual for e in spec
                                for a in spec_axes(e)):
            out[name] = tuple(spec)
    for op in block.ops:
        params = op.input("Param")
        if not params or params[0] not in out:
            continue
        shape = tuple(pers[params[0]].shape)
        for n in op.input_names:
            v = pers.get(n)
            if v is not None and n not in out and tuple(v.shape) == shape:
                out[n] = out[params[0]]
    return out


def block_of(mesh, spec, t):
    """This rank's block of the whole tensor ``t`` (a copy: the whole
    can be freed)."""
    _, cuts = block_slices(mesh, spec, tuple(t.shape))
    for dim, start, size in cuts:
        t = t.narrow(dim, start, size)
    return t.clone() if cuts else t


def _cut_axes(mesh, spec, ndim):
    """[(dim, axes)] of each dim ``spec`` splits over mesh axes of more
    than one rank."""
    out = []
    for dim, entry in enumerate(tuple(spec or ())[:ndim]):
        axes = tuple(a for a in spec_axes(entry) if mesh.shape.get(a, 1) > 1)
        if axes:
            out.append((dim, axes))
    return out


def whole(mesh, spec, t):
    """The whole value from every rank's block (no autograd): a dim split
    over several axes gathers its minor axis first."""
    for dim, axes in _cut_axes(mesh, spec, t.dim()):
        for a in reversed(axes):
            t = C._raw_all_gather(t.contiguous(), mesh.group(a), dim)
    return t


class _Gather(torch.autograd.Function):
    """A held block gathered whole for a reader that needs the whole; the
    block's gradient is its block of the whole's (every rank of the
    block's axes reads the same whole value)."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return whole(mesh, spec, x)

    @staticmethod
    def backward(ctx, g):
        return block_of(ctx.mesh, ctx.spec, g), None, None


def _is_dtensor(x):
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _swapped(ctx, op, make):
    """Run ``op`` with some inputs replaced (``make(name, value)`` ->
    the replacement or None), putting back those the op did not
    overwrite."""
    swaps = {}
    for n in set(op.input_names):
        v = ctx.env.get(n)
        if isinstance(v, torch.Tensor):
            new = make(n, v)
            if new is not None:
                swaps[n] = (v, new)
                ctx.env[n] = new
    return swaps


def _restore(ctx, swaps):
    for n, (old, new) in swaps.items():
        if ctx.env.get(n) is new:
            ctx.env[n] = old


def lower(ctx, op, fn):
    """Lower ``op`` (``fn(ctx, op)``) in a ``ParallelExecutor`` step:
    with its held inputs read as the module docstring says, and by its
    sequence-block rule where it has one (``parallel/seqblocks.py``)."""
    from . import seqblocks
    mesh = ctx.mesh
    held = {n: ctx.held_spec(n) for n in set(op.input_names)} \
        if ctx.held else {}
    held = {n: s for n, s in held.items() if s is not None}
    if not held or op.type in REGION_OPS:
        return seqblocks.lower(ctx, op, fn)
    params = op.input("Param")
    if params and params[0] in held:
        spec = held[params[0]]
        var = ctx.block.vars.get(params[0]) if ctx.block is not None \
            else None
        shape = tuple(var.shape) if var is not None else None

        def local(n, v):
            if n in held:
                return None
            out = C.global_value(v) if _is_dtensor(v) else v
            if shape is not None and tuple(out.shape) == shape:
                out = block_of(mesh, spec, out)
            return None if out is v else out
        swaps = _swapped(ctx, op, local)
    else:
        # beside DTensor inputs the whole value is a Replicate DTensor
        # (DTensor ops take no plain tensor but a scalar)
        dt = any(_is_dtensor(ctx.env.get(n)) for n in op.input_names)

        def whole_of(n, v):
            if n not in held:
                return None
            w = _Gather.apply(v, mesh, held[n])
            if dt:
                from torch.distributed.tensor import Replicate
                from ._shard_map import _FromLocal
                w = _FromLocal.apply(w, mesh, [Replicate()] * len(
                    mesh.dtensor_axes), w.shape)
            return w
        swaps = _swapped(ctx, op, whole_of)
    try:
        return seqblocks.lower(ctx, op, fn)
    finally:
        _restore(ctx, swaps)
