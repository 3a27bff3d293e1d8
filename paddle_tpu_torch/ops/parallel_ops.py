"""The ``sp_attention`` op's local path.

The counterpart of ``paddle_tpu/ops/parallel_ops.py:39-66``: without a
mesh, ``sp_attention`` is flash attention over the whole sequence — the
hand-written CUDA kernels for CUDA tensors, the plain PyTorch version
for CPU tensors (ops/flash_attention.py). The sequence-parallel paths
(ring, Ulysses) come with the parallel tier; with a mesh the op raises.
"""

from ..core.registry import register
from .flash_attention import flash_attention


@register("sp_attention")
def _sp_attention(ctx, op):
    """Inputs Q/K/V [B, H, T, dk]; attrs causal, variant, scale (0 means
    dk**-0.5). The split-heads transpose upstream leaves strided views;
    the kernel takes contiguous [B, H, T, dk], so they are made so
    here."""
    if ctx.mesh is not None:
        raise NotImplementedError(
            "sp_attention over a device mesh (ring / Ulysses) is not "
            "ported to paddle_tpu_torch yet (ROADMAP.md, queue 1 item 9)")
    q = ctx.in1(op, "Q").contiguous()
    k = ctx.in1(op, "K").contiguous()
    v = ctx.in1(op, "V").contiguous()
    causal = bool(op.attr("causal", False))
    scale = float(op.attr("scale", 0.0)) or q.shape[-1] ** -0.5
    ctx.set_out(op, "Out", flash_attention(q, k, v, causal=causal,
                                           scale=scale))
