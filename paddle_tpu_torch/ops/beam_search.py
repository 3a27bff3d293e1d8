"""Beam search: the dense step, the backtrack, and their op lowerings.

The counterpart of ``paddle_tpu/ops/beam_search.py``, with its dense,
static-shaped semantics:

* every source sentence always owns exactly ``beam_size`` rows; a dead
  beam (one whose last token is ``end_id``) stays in the tensor, scores
  ``NEG_INF`` on every extension and re-emits ``end_id`` with its score
  frozen;
* selection is one top-k over each source's flattened ``beam_size x V``
  candidate table, no data-dependent shape;
* the backtrack walks the recorded parent rows in reverse and pads every
  token after a sentence's first ``end_id`` with ``end_id``.

Tie order is the JAX package's: ``lax.top_k`` puts the lower index first
among equal values, and ``torch.topk`` promises no order (nor the same
one on the CPU and the card). So the top-k here is a stable descending
sort of the table cut to its first ``beam_size`` columns, which breaks
every tie (the ``NEG_INF`` of dead and first-step beams among them)
toward the lower index on both devices. Nothing reads a value back to
the host, so a CUDA graph can hold a whole decode (``models/decoding``).
"""

import torch

from ..core.registry import register

NEG_INF = -1e9


def top_k(x, k):
    """(values, indices) of the ``k`` largest entries of each row of
    ``x``, largest first, a tie going to the lower index (``lax.top_k``'s
    order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def beam_search_step(pre_ids, pre_scores, scores, beam_size, end_id,
                     first_step=False):
    """One dense beam-search step.

    pre_ids [B*W] int (the token each beam chose last), pre_scores [B*W]
    f32 (each beam's accumulated log-prob), scores [B*W, V] f32 (the local
    log-probs of the next token); ``first_step``: only beam 0 of each
    source is live (all beams hold the same state at t = 0).

    Returns (selected_ids [B*W] int32, selected_scores [B*W] f32,
    parent_idx [B*W] int32, each an index into the previous B*W rows).
    """
    bw, vocab = scores.shape
    batch = bw // beam_size
    finished = pre_ids == end_id
    # alive beams extend by every token; a finished beam offers one
    # frozen candidate at end_id
    acc = pre_scores[:, None] + scores
    acc = torch.where(finished[:, None], NEG_INF, acc)
    frozen = torch.full_like(acc, NEG_INF)
    frozen[:, end_id] = torch.where(finished, pre_scores, NEG_INF)
    cand = torch.maximum(acc, frozen)
    if first_step:
        beam_pos = torch.arange(bw, device=cand.device) % beam_size
        cand = torch.where((beam_pos > 0)[:, None], NEG_INF, cand)

    top_scores, top_idx = top_k(cand.reshape(batch, beam_size * vocab),
                                beam_size)                  # [B, W]
    parent_in_src = torch.div(top_idx, vocab, rounding_mode="floor")
    token = top_idx % vocab
    src_base = torch.arange(batch, device=cand.device)[:, None] * beam_size
    parent_idx = (src_base + parent_in_src).reshape(-1)
    return (token.reshape(-1).to(torch.int32), top_scores.reshape(-1),
            parent_idx.to(torch.int32))


def beam_search_decode(step_ids, step_parents, final_scores, beam_size,
                       end_id):
    """Backtrack recorded steps into sentences.

    step_ids [T, B*W] int (the token each row chose at each step),
    step_parents [T, B*W] int (each row's parent row), final_scores [B*W]
    f32. Returns (sentences [B, W, T] int32, padded with ``end_id`` after
    the first ``end_id``, scores [B, W])."""
    steps, bw = step_ids.shape
    batch = bw // beam_size
    row = torch.arange(bw, device=step_ids.device)
    toks = [None] * steps
    for t in range(steps - 1, -1, -1):
        toks[t] = step_ids[t][row]
        row = step_parents[t][row].long()
    sentences = torch.stack(toks, dim=1).to(torch.int32)   # [B*W, T]
    seen_end = torch.cumsum((sentences == end_id).to(torch.int32), dim=1)
    after_end = torch.cat(
        [torch.zeros_like(seen_end[:, :1]), seen_end[:, :-1]], dim=1) > 0
    sentences = torch.where(after_end, end_id, sentences)
    return (sentences.reshape(batch, beam_size, steps),
            final_scores.reshape(batch, beam_size))


# --------------------------------------------------------------------------
# Program-IR op lowerings

@register("beam_search")
def _beam_search(ctx, op):
    """Dense per-step op (beam_search_op.cc): pre_ids [B*W, 1],
    pre_scores [B*W, 1], scores [B*W, V]; attrs beam_size, end_id,
    is_first_step. The reference's ``ids`` slot is not read: scores
    covers the whole vocabulary."""
    sel, sc, par = beam_search_step(
        ctx.in1(op, "pre_ids").reshape(-1),
        ctx.in1(op, "pre_scores").reshape(-1).float(),
        ctx.in1(op, "scores"),
        int(op.attr("beam_size", 4)), int(op.attr("end_id", 0)),
        bool(op.attr("is_first_step", False)))
    ctx.set_out(op, "selected_ids", sel[:, None])
    ctx.set_out(op, "selected_scores", sc[:, None])
    ctx.set_out(op, "parent_idx", par)


def _steps(value, what):
    """A list of per-step [B*W, 1] tensors (a tensor array) or a stacked
    [T, ...] tensor, as [T, B*W] int32."""
    if value is None:
        raise ValueError("beam_search_decode needs its %s input" % what)
    if isinstance(value, (list, tuple)):
        value = torch.stack([v.reshape(-1) for v in value])
    return value.reshape(value.shape[0], -1).to(torch.int32)


@register("beam_search_decode")
def _beam_search_decode(ctx, op):
    """Backtracking decode (beam_search_decode_op.cc): Ids and Parents as
    tensor arrays or stacked [T, B*W] tensors, Scores [B*W, 1]
    accumulated; outputs SentenceIds [B, W, T], SentenceScores [B, W]."""
    sent, sc = beam_search_decode(
        _steps(ctx.in1(op, "Ids"), "Ids"),
        _steps(ctx.in1(op, "Parents"), "Parents"),
        ctx.in1(op, "Scores").reshape(-1).float(),
        int(op.attr("beam_size", 4)), int(op.attr("end_id", 0)))
    ctx.set_out(op, "SentenceIds", sent)
    ctx.set_out(op, "SentenceScores", sc)
