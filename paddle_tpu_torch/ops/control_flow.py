"""Control-flow ops: ``recompute_block``.

The counterpart of ``paddle_tpu/ops/control_flow.py``'s
``_recompute_block``. The JAX package lowers a region under
``jax.checkpoint``; the port runs it under
``torch.utils.checkpoint(use_reentrant=False,
preserve_rng_state=False)``: the non-reentrant form, because the
Executor differentiates with ``torch.autograd.grad``, which the
reentrant form refuses; and without saving the global RNG state, which
the region's draws never read (dropout is keyed by the run's seed and
each op's key, ``ops/dropout.py``) and which a CUDA graph capture may
not touch. The recompute therefore replays the forward's masks, and the
flash kernels of a region run twice a step: in the forward and again in
the backward.
"""

import torch
from torch.utils import checkpoint as _checkpoint

from ..core.registry import register, sub_blocks

__all__ = []


def _op_reads(op, seen=None):
    """The names ``op`` reads: its declared inputs and everything read
    inside any sub-block it carries."""
    seen = set() if seen is None else seen
    names = {n for ns in op.inputs.values() for n in ns}
    for b in sub_blocks(op):
        if id(b) not in seen:
            seen.add(id(b))
            for o in b.ops:
                names |= _op_reads(o, seen)
    return names


@register("recompute_block")
def _recompute_block(ctx, op):
    """Rematerialization region: the sub-block's internal activations are
    recomputed in the backward pass instead of stored. Exported from the
    region, as in the JAX package: the sub-block writes that LATER ops of
    the parent block read (looking through their sub-blocks), the
    persistables and anything in the run's fetch list; every other value
    stays inside."""
    from ..core.executor import _lower_op

    block = op.attr("sub_block")
    parent_ops = list(ctx.block.ops) if ctx.block is not None else []
    try:
        my_idx = next(i for i, o in enumerate(parent_ops) if o is op)
    except StopIteration:
        raise RuntimeError(
            "recompute_block op not found in its parent block's op list "
            "— the lowering must run on the block that owns the op")
    later_reads = set()
    for o in parent_ops[my_idx + 1:]:
        later_reads |= _op_reads(o)
    persistable = {v.name for v in ctx.block.vars.values()
                   if getattr(v, "persistable", False)}
    fetches = set(ctx.fetch_names)
    out_names = [n for n in op.output("Out")
                 if n in later_reads or n in persistable or n in fetches]
    in_names = [n for n in op.input("X") if n in ctx.env]
    base_env = dict(ctx.env)

    def region(*vals):
        env = dict(base_env)
        env.update(zip(in_names, vals))
        sctx = ctx.sub_context(env, block)
        for op2 in block.ops:
            _lower_op(sctx, op2)
        return tuple(env[n] for n in out_names)

    vals = tuple(ctx.env[n] for n in in_names)
    if torch.is_grad_enabled() and any(
            isinstance(v, torch.Tensor) and v.requires_grad for v in vals):
        outs = _checkpoint.checkpoint(region, *vals, use_reentrant=False,
                                      preserve_rng_state=False)
    else:
        outs = region(*vals)
    for n, v in zip(out_names, outs):
        ctx.env[n] = v
