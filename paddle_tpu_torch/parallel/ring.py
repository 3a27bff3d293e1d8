"""Ring attention and Ulysses attention: sequence parallelism over the
``sp`` mesh axis.

The counterpart of ``paddle_tpu/parallel/ring.py``. The sequence axis
is sharded over ``sp``; each rank holds a Q shard and passes its K/V
shard around the ring with ``ppermute`` (``batch_isend_irecv``), merging
flash-attention-style partial results (per-shard output + log-sum-exp
rows), so the full [T, T] score matrix never materializes.

Each ring step runs the port's ``flash_attention_lse`` on the shard it
holds: the hand-written CUDA kernels on the card, the plain PyTorch
version on the CPU. Its backward carries a real dLSE through the merge
(``ops/flash_attention._FlashLSE``). Causally the shards collapse to
three cases, as in the JAX package: the diagonal shard is causal, shards
before it are unmasked, shards after it are skipped with no launch. The
ring is one autograd node (``_Ring``), whose backward sends each step's
dK/dV home, so ranks whose local graphs differ (a causal skip) still
meet their collectives in one order. The ring does not rotate after its
last step (the JAX loop does, and drops the result).

Ulysses swaps the sharded axis from sequence to heads with one
all-to-all, runs ``flash_attention`` on the whole sequence of its heads
and swaps back.
"""

import functools

import torch

from . import collective as C
from ._shard_map import shard_map
from .mesh import PartitionSpec as P

_NEG_BIG = -1e30   # finite "-inf": keeps exp()==0 without inf-inf NaNs


def _ring_attention_sharded(q, k, v, axis_name, causal, scale):
    """Per-shard body (inside shard_map). q/k/v: [B, H, T_local, D]."""
    group = C._mesh().group(axis_name)
    return _Ring.apply(q, k, v, group, C.axis_size(axis_name),
                       C.axis_index(axis_name), bool(causal), scale)


class _Ring(torch.autograd.Function):
    """The ring as one autograd node. The forward runs the steps under
    autograd on detached leaves (q, and each step's K/V shard as
    received), so the backward is one ``torch.autograd.grad`` through
    the merge and each step's ``_FlashLSE`` (a real dLSE), after which
    each step's dK/dV goes back to the rank that owns the shard, in the
    same order on every rank. A rank that skipped a shard (causal) has
    a different local graph from its neighbours; hidden in one node, it
    cannot change the order in which the ranks meet their collectives."""

    @staticmethod
    def forward(ctx, q, k, v, group, n, me, causal, scale):
        from ..ops.flash_attention import flash_attention_lse
        grad = any(ctx.needs_input_grad[:3])
        b, h, t_local, d = q.shape
        perm = [(j, (j + 1) % n) for j in range(n)]
        k_cur, v_cur = k.contiguous(), v.contiguous()
        steps = []
        with torch.set_grad_enabled(grad):
            ql = q.detach().contiguous().requires_grad_(grad)
            # deferred-normalization carry (one divide after the loop):
            # num = sum_seen o_j e^{lse_j - m_run}, s = sum_seen
            # e^{lse_j - m_run}
            num = torch.zeros((b, h, t_local, d), dtype=torch.float32,
                              device=q.device)
            s = torch.zeros((b, h, t_local), dtype=torch.float32,
                            device=q.device)
            m_run = torch.full((b, h, t_local), _NEG_BIG,
                               dtype=torch.float32, device=q.device)
            for i in range(n):
                src = (me - i) % n           # whose K/V shard we hold
                if causal and src > me:      # after me: fully masked
                    steps.append(None)
                else:                        # diagonal causal, else full
                    kl = k_cur.detach().requires_grad_(grad)
                    vl = v_cur.detach().requires_grad_(grad)
                    steps.append((kl, vl))
                    o_i, lse_i = flash_attention_lse(
                        ql, kl, vl, causal=bool(causal and src == me),
                        scale=scale)
                    lse_i = lse_i.float()
                    m_new = torch.maximum(m_run, lse_i)
                    alpha = torch.exp(m_run - m_new)  # rescales the old
                    w_i = torch.exp(lse_i - m_new)    # this shard's weight
                    num = num * alpha[..., None] \
                        + o_i.float() * w_i[..., None]
                    s = s * alpha + w_i
                    m_run = m_new
                if i < n - 1:
                    k_cur, v_cur = C._raw_ppermute([k_cur, v_cur], group,
                                                   perm)
            out = (num / torch.clamp(s, min=1e-30)[..., None]).to(q.dtype)
        ctx.group, ctx.n, ctx.me = group, n, me
        ctx.ql, ctx.steps, ctx.out = ql, steps, out
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        n, group = ctx.n, ctx.group
        live = [st for st in ctx.steps if st is not None]
        wrt = [ctx.ql] + [t for st in live for t in st]
        grads = list(torch.autograd.grad(ctx.out, wrt, g,
                                         allow_unused=True))
        dq = grads.pop(0)
        dk = dv = None
        for i, st in enumerate(ctx.steps):
            if st is None:
                dk_i = torch.zeros_like(ctx.ql)
                dv_i = torch.zeros_like(ctx.ql)
            else:
                dk_i, dv_i = grads.pop(0), grads.pop(0)
                dk_i = torch.zeros_like(st[0]) if dk_i is None else dk_i
                dv_i = torch.zeros_like(st[1]) if dv_i is None else dv_i
            if i:
                # step i held the shard of rank (me - i): send it home
                back = [(j, (j - i) % n) for j in range(n)]
                dk_i, dv_i = C._raw_ppermute([dk_i, dv_i], group, back)
            dk = dk_i if dk is None else dk + dk_i
            dv = dv_i if dv is None else dv + dv_i
        ctx.steps = ctx.out = ctx.ql = None
        return dq, dk, dv, None, None, None, None, None


def _ulysses_sharded(q, k, v, axis_name, causal, scale):
    """Per-shard body: [B, H, T/s, D] -> a2a -> [B, H/s, T, D], flash
    attention, and back."""
    from ..ops.flash_attention import flash_attention
    q2, k2, v2 = C.all_to_all((q, k, v), axis_name, 1, 2)
    o = flash_attention(q2.contiguous(), k2.contiguous(), v2.contiguous(),
                        causal=causal, scale=scale)
    return C.all_to_all(o, axis_name, 2, 1)


def _sp_attention(body, q, k, v, mesh, axis_name, causal, scale,
                  batch_axis, head_axis=None):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    spec = P(batch_axis, head_axis, axis_name, None)
    fn = shard_map(functools.partial(body, axis_name=axis_name,
                                     causal=causal, scale=scale),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False, scale=None,
                   batch_axis=None):
    """q,k,v: [B, H, T, D] with T sharded on `axis_name`. Returns [B,H,T,D]
    with the same sharding. Pass batch_axis="dp" when the mesh also data-
    parallelizes the batch dim, so it stays sharded."""
    return _sp_attention(_ring_attention_sharded, q, k, v, mesh, axis_name,
                         causal, scale, batch_axis)


def ulysses_attention(q, k, v, mesh, axis_name="sp", causal=False,
                      scale=None, batch_axis=None):
    """DeepSpeed-Ulysses style sequence parallelism: all-to-all swaps the
    sharded axis from sequence to heads, runs full local attention (the
    flash kernels on the card), then swaps back. Better when H >=
    axis_size and T is moderate."""
    return _sp_attention(_ulysses_sharded, q, k, v, mesh, axis_name,
                         causal, scale, batch_axis)
