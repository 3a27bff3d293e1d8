"""Whole-loop sequence generation: greedy and beam search.

The counterpart of ``paddle_tpu/models/decoding.py``. The JAX package
runs a decode as one ``lax.scan`` with static ``[batch * beam]`` shapes:
dead beams are masked, not pruned, and every one of the ``max_len`` steps
runs. The loops here keep that contract: every step runs, with static
shapes and no read of a device value on the host (no early exit when
every row is done), so a CUDA graph can hold the whole decode
(``TransformerInfer`` captures one per shape on the card,
``_DecodeGraphs``); on the CPU the same loops run eagerly.

Any step function ``logits_fn(tokens, state, t) -> (logits, state)``
works: tokens [rows] int, state a dict whose tensors with ``rows``
leading rows follow their beam (KV caches), logits [rows, vocab]; ``t``
is a host int, so each step's cache position is its own.
"""

import torch

from ..ops.beam_search import beam_search_decode, beam_search_step

__all__ = ["greedy_search", "beam_search"]


def greedy_search(logits_fn, init_state, bos_id, end_id, max_len, batch):
    """Greedy decode of ``batch`` rows, the argmax at each step. Returns
    (tokens [batch, max_len] int32, scores [batch] f32: the sum of the
    chosen tokens' log-probs up to and including the first end_id)."""
    dev = _device(init_state)
    tok = torch.full((batch,), bos_id, dtype=torch.int32, device=dev)
    score = torch.zeros(batch, dtype=torch.float32, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    state, toks = init_state, []
    for t in range(max_len):
        logits, state = logits_fn(tok, state, t)
        logp = torch.log_softmax(logits.float(), dim=-1)
        # argmax takes the first of equal maxima, as jnp.argmax
        nxt = torch.argmax(logp, dim=-1).to(torch.int32)
        tok_logp = torch.gather(logp, 1, nxt[:, None].long())[:, 0]
        nxt = torch.where(done, end_id, nxt)
        score = score + torch.where(done, 0.0, tok_logp)
        done = done | (nxt == end_id)
        tok = nxt
        toks.append(nxt)
    return torch.stack(toks, dim=1), score


def _reorder_state(state, parent_idx):
    """Every tensor of the state dict whose leading dim is the row count,
    gathered by ``parent_idx``: each beam takes its parent's KV caches.
    Other entries pass through."""
    idx = parent_idx.long()
    return {k: v[idx] if isinstance(v, torch.Tensor) and v.dim() >= 1
            and v.shape[0] == idx.shape[0] else v
            for k, v in state.items()}


def beam_search(logits_fn, init_state, bos_id, end_id, max_len, batch,
                beam_size, length_penalty=0.0):
    """Beam-search decode over ``batch * beam_size`` rows (the caller
    tiles the encoder state ``beam_size`` times along dim 0). Returns
    (sentences [batch, beam, max_len] int32, best beam first, scores
    [batch, beam] f32, sorted descending; with ``length_penalty`` each
    score is divided by (its length + 1) ** length_penalty first)."""
    rows = batch * beam_size
    dev = _device(init_state)
    tok = torch.full((rows,), bos_id, dtype=torch.int32, device=dev)
    score = torch.zeros(rows, dtype=torch.float32, device=dev)
    state, ids, parents = init_state, [], []
    for t in range(max_len):
        logits, state = logits_fn(tok, state, t)
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok, score, parent = beam_search_step(
            tok, score, logp, beam_size, end_id, first_step=t == 0)
        state = _reorder_state(state, parent)
        ids.append(tok)
        parents.append(parent)
    sentences, scores = beam_search_decode(
        torch.stack(ids), torch.stack(parents), score, beam_size, end_id)
    if length_penalty:
        lengths = (sentences != end_id).float().sum(-1) + 1
        scores = scores / lengths ** length_penalty
    # stable, so equal scores keep their beam order (jnp.argsort's)
    order = torch.argsort(-scores, dim=-1, stable=True)
    sentences = torch.gather(
        sentences, 1, order[..., None].expand_as(sentences))
    return sentences, torch.gather(scores, 1, order)


def _device(state):
    """The device of the state's tensors (the CPU for an empty state)."""
    for v in state.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")
