"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis.

The counterpart of ``paddle_tpu/parallel/moe.py``: top-k gating with
capacity, dispatch/combine as einsums against a one-hot dispatch tensor,
expert weights stacked [E, ...] and sharded on ``ep``. Routing is the JAX
package's exactly: the expert choice (ties break at the first index, as
``argmax`` and ``lax.top_k`` break them: ``_top_k`` takes the arg-max k
times rather than ``torch.topk``, whose tie order is unspecified), the
position in capacity, the drops, the normalized top-k combine, the aux
loss and the overflow fraction.

With a mesh whose ``ep`` axis has more than one rank, ``moe_ffn`` runs as
GSPMD runs the JAX one: routing over all tokens (every rank gates the
whole token set), each ``ep`` rank runs the FFN of its own experts, and
an all-gather over ``ep`` brings the expert outputs together for the
combine. ``moe_ffn_pp_sharded`` is the per-rank MoE of the pipeline's
stage body: local routing, the dispatched queues ride an all-to-all to
their experts' owners and back.

``noise_std`` draws come from the counter-keyed Philox route
(``core/philox.py``): ``rng`` is a (seed, key) pair, the seed an int64
device scalar and the key a host int, never a ``torch.Generator``.
"""

import torch

from . import collective as C


def _normal(shape, rng, device):
    """Standard normals from the Philox words of ``rng`` = (seed, key),
    by Box-Muller as ``gaussian_random`` draws them."""
    from ..core import philox
    seed, key = rng
    n = 1
    for s in shape:
        n *= int(s)
    u = philox.unit24(philox.words(n + n % 2, seed, key, device))
    u = u.reshape(-1, 2)
    r = u[:, 0].neg().log1p().mul(-2.0).sqrt()
    theta = u[:, 1] * (2.0 * 3.141592653589793)
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], 1)
    return z.reshape(-1)[:n].reshape(shape).float()


def _one_hot(idx, n):
    """float32 one-hot of ``idx`` over ``n`` classes, by scatter:
    ``F.one_hot`` checks its indices on the host, which a CUDA graph
    cannot hold."""
    idx = idx.long()
    out = torch.zeros(tuple(idx.shape) + (n,), dtype=torch.float32,
                      device=idx.device)
    return out.scatter_(-1, idx[..., None], 1.0)


def _top_k(x, k):
    """(values, indices) of the k largest entries of the last dim, ties
    at the first index (``lax.top_k``'s order)."""
    vals, idxs = [], []
    masked = x
    for _ in range(k):
        i = torch.argmax(masked, dim=-1)
        vals.append(torch.gather(x, -1, i[..., None])[..., 0])
        idxs.append(i)
        masked = masked.scatter(-1, i[..., None], float("-inf"))
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def top1_gating(logits, capacity, rng=None, noise_std=0.0):
    """logits [T, E] -> (dispatch [T, E, C] one-hot, combine [T, E, C],
    aux_loss). Tokens beyond an expert's capacity are dropped (Switch
    transformer)."""
    t, e = logits.shape
    if noise_std and rng is not None:
        logits = logits + noise_std * _normal(logits.shape, rng,
                                              logits.device)
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)                  # [T]
    expert_mask = _one_hot(expert_idx, e)                     # [T, E]
    # position of each token within its expert's queue
    pos_in_expert = (torch.cumsum(expert_mask, dim=0) - 1.0) * expert_mask
    keep = (pos_in_expert < capacity).float() * expert_mask   # [T, E]
    pos = torch.sum(pos_in_expert * keep, dim=-1)             # [T]
    pos_oh = _one_hot(pos.long(), capacity)                   # [T, C]
    dispatch = keep[:, :, None] * pos_oh[:, None, :]          # [T, E, C]
    gate_prob = torch.sum(probs * expert_mask, dim=-1)        # [T]
    combine = dispatch * gate_prob[:, None, None]
    # load-balancing aux loss (GShard eq. 4 / Switch aux)
    density = torch.mean(expert_mask, dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_proxy) * (e ** 2) / e
    return dispatch, combine, aux


def topk_gating(logits, capacity, k=2, rng=None, noise_std=0.0):
    """GShard-style top-k gating. Combine weights are the k selected gate
    probabilities normalized to sum to 1 per token; rank-0 choices claim
    queue slots before rank-1 choices; an overflowing branch is dropped
    (no renormalization after dropping, per the paper).

    logits [T, E] -> (dispatch [T, E, C], combine [T, E, C], aux_loss,
    overflow_frac) where overflow_frac = dropped assignments / (T*k)."""
    t, e = logits.shape
    if noise_std and rng is not None:
        logits = logits + noise_std * _normal(logits.shape, rng,
                                              logits.device)
    # slot bookkeeping in float32 always (a bf16 cumsum loses integers)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, idxs = _top_k(probs, k)                        # [T, k]
    weights = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)

    counts = torch.zeros((e,), dtype=torch.float32, device=logits.device)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    kept_total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for r in range(k):
        mask = _one_hot(idxs[:, r], e)                        # [T, E]
        pos = (torch.cumsum(mask, dim=0) - 1.0) * mask + counts * mask
        keep = (pos < capacity).float() * mask                # [T, E]
        pos_tok = torch.sum(pos * keep, dim=-1)               # [T]
        pos_oh = _one_hot(pos_tok.long(), capacity)
        slot = keep[:, :, None] * pos_oh[:, None, :]          # [T, E, C]
        dispatch = dispatch + slot
        combine = combine + slot * weights[:, r][:, None, None]
        counts = counts + torch.sum(keep, dim=0)
        kept_total = kept_total + torch.sum(keep)
    overflow = torch.clamp(1.0 - kept_total / (t * k), 0.0, 1.0)
    # load-balancing aux loss on the rank-0 assignment (GShard eq. 4)
    density = torch.mean(_one_hot(idxs[:, 0], e), dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_proxy) * (e ** 2) / e
    dtype = logits.dtype
    return dispatch.to(dtype), combine.to(dtype), aux, overflow


def _route(x, gate_w, capacity, top_k, rng=None):
    logits = x @ gate_w
    if top_k > 1:
        dispatch, combine, aux, overflow = topk_gating(logits, capacity,
                                                       k=top_k, rng=rng)
    else:
        dispatch, combine, aux = top1_gating(logits, capacity, rng)
        overflow = torch.clamp(1.0 - torch.sum(dispatch) / x.shape[0],
                               0.0, 1.0)
    return dispatch, combine, aux, overflow


def _experts(expert_in, w_up, w_down):
    h = torch.relu(torch.einsum("ecd,edh->ech", expert_in, w_up))
    return torch.einsum("ech,ehd->ecd", h, w_down)


def _moe_ffn_sharded(x, gate_w, w_up_local, w_down_local, capacity,
                     top_k, ep_axis):
    """The mesh body of moe_ffn: global routing on every rank, the FFN of
    this rank's experts, their outputs all-gathered over ``ep``."""
    dispatch, combine, aux, overflow = _route(x, gate_w, capacity, top_k)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)      # [E, C, D]
    e_loc = w_up_local.shape[0]
    me = C.axis_index(ep_axis)
    local_in = expert_in[me * e_loc:(me + 1) * e_loc]
    expert_out = C.all_gather(_experts(local_in, w_up_local, w_down_local),
                              ep_axis, 0)
    out = torch.einsum("tec,ecd->td", combine, expert_out)
    return out, aux, overflow


def moe_ffn(x, gate_w, w_up, w_down, capacity_factor=1.25, rng=None,
            mesh=None, ep_axis="ep", top_k=1, return_stats=False):
    """Switch-style (top_k=1) or GShard-style (top_k=2) MoE FFN.

    x       [T, D] tokens
    gate_w  [D, E]
    w_up    [E, D, H] stacked expert weights (shard on ep), or over a
            mesh with ep ranks this rank's [E / ep, D, H] block of them
    w_down  [E, H, D], or its [E / ep, H, D] block
    Returns ([T, D], aux_loss), plus a stats dict ({"overflow": frac of
    dropped token-expert assignments}) when return_stats=True."""
    t, d = x.shape
    e = gate_w.shape[1]
    capacity = max(1, int(capacity_factor * top_k * t / e))
    if mesh is not None and mesh.size > 1:
        from ._shard_map import held, shard_map
        from .mesh import PartitionSpec as P
        ep = ep_axis if ep_axis in mesh.axis_names else None
        n_ep = mesh.shape[ep] if ep else 1
        if n_ep > 1:
            # expert stacks of E / ep experts: this rank's ep block, held
            # (the pipeline's lowering marks them itself)
            w_up, w_down = [
                held(w.view_as(w), (ep,)) if w.shape[0] * n_ep == e
                and getattr(w, "_ptpu_held", None) is None else w
                for w in (w_up, w_down)]
        fn = shard_map(
            lambda x_, g_, u_, w_: _moe_ffn_sharded(
                x_, g_, u_, w_, capacity, top_k, ep),
            mesh=mesh, in_specs=(P(), P(), P(ep), P(ep)),
            out_specs=(P(), P(), P()))
        out, aux, overflow = fn(x, gate_w, w_up, w_down)
    else:
        dispatch, combine, aux, overflow = _route(x, gate_w, capacity,
                                                  top_k, rng)
        # dispatch tokens to experts: [E, C, D]
        expert_in = torch.einsum("tec,td->ecd", dispatch, x)
        expert_out = _experts(expert_in, w_up, w_down)
        out = torch.einsum("tec,ecd->td", combine, expert_out)
    if return_stats:
        return out, aux, {"overflow": overflow}
    return out, aux


def moe_ffn_pp_sharded(x, gate_w, w_up_local, w_down_local, ep_axis,
                       top_k=1, capacity_factor=1.25):
    """Per-rank MoE FFN for use inside shard_map: the pp x ep
    composition (the MoE all-to-all nested in the pipeline stage body).

    x             [T_loc, D]: this member's token slice
    gate_w        [D, E] replicated (routing needs every expert's logit)
    w_up_local    [E/n_ep, D, H]: this member's expert shard (expert e's
                  owner is e // e_loc)
    w_down_local  [E/n_ep, H, D]

    Routing is local (each member gates its own tokens with capacity
    cf*k*T_loc/E); the dispatched queues ride one tiled all_to_all to
    the expert owners ([E, C, D] -> [E/n, n*C, D]), the expert FFN runs
    on the local expert shard, and a second all_to_all brings the
    outputs back. The math per member is moe_ffn(mesh=None) on its token
    group. Returns ([T_loc, D], aux_loss_local)."""
    t, d = x.shape
    n_ep = C.axis_size(ep_axis)
    e_loc = w_up_local.shape[0]
    e = e_loc * n_ep
    capacity = max(1, int(capacity_factor * top_k * t / e))
    dispatch, combine, aux, _ = _route(x, gate_w, capacity, top_k)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)      # [E, C, D]
    expert_in = C.all_to_all(expert_in, ep_axis, 0, 1)
    expert_out = _experts(expert_in, w_up_local, w_down_local)
    expert_out = C.all_to_all(expert_out, ep_axis, 1, 0)
    out = torch.einsum("tec,ecd->td", combine, expert_out)
    return out, aux
