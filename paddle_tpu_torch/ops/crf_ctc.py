"""Structured-prediction ops: linear-chain CRF, CTC, chunk evaluation.

The counterpart of ``paddle_tpu/ops/crf_ctc.py`` (operators/
{linear_chain_crf,crf_decoding,warpctc,ctc_align,chunk_eval}_op.cc).
The JAX package runs the CRF forward recursion, Viterbi and the CTC alpha
recursion as ``lax.scan`` over padded batches; the port runs the same
recursions as Python loops over the ``@MAXLEN`` steps of the time-major
padded batch (``rnn_ops._pad_from_lod``), masked with ``torch.where`` on
the device lengths, so a CUDA graph holds them. The losses are
differentiable through autograd, as the JAX ones are through ``jax.grad``.

A dead (sequence, step) slot of the padded batch holds zero here, as in
the JAX package (``_live``): a sequence of length 0 still reads step 0,
and the unpadded outputs carry the dead slots past the live rows.

The bucket's pad rows (past sum(lengths)) take segment id n, one past the
last sequence: JAX clamps a gather at n to n - 1, which the port does
explicitly (``_clamped``), and drops a segment sum there
(``sequence_ops.segment_sum`` runs over n + 1 segments).
"""

import torch

from ..core.registry import register
from ..core.scope import torch_dtype
from .rnn_ops import _pad_from_lod, _unpad_to_lod
from .sequence_ops import (_lengths, _one_sequence, _segment_reduce,
                           segment_sum, segments, starts)

NEG_INF = -1e30      # warpctc's "minus infinity": impossible stays finite


def _live(ctx, op, slot):
    """(time-major padded [maxlen, n, ...] with dead slots zeroed, live
    mask [maxlen, n], lengths int32 [n], flat total)."""
    x, lens, total, maxlen = _pad_from_lod(ctx, op, slot)
    alive = torch.arange(maxlen, device=x.device)[:, None] < lens[None, :]
    mask = alive.reshape(alive.shape + (1,) * (x.dim() - 2))
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device)), \
        alive, lens, total


def _clamped(idx, n):
    """``idx`` with the pad rows' segment id n read as n - 1 (JAX's
    clamped gather)."""
    return torch.clamp(idx, max=n - 1)


def _split_transition(trans):
    """Transition [D+2, D]: row 0 the start weights, row 1 the end
    weights, rows 2.. the transition matrix."""
    return trans[0], trans[1], trans[2:]


@register("linear_chain_crf")
def _linear_chain_crf(ctx, op):
    """Negative log-likelihood of a linear-chain CRF [n, 1]
    (linear_chain_crf_op.cc): the log partition by the forward logsumexp
    recursion, less the gold path's score."""
    emission, alive, lens, total = _live(ctx, op, "Emission")  # [T, n, D]
    label, _, _, _ = _live(ctx, op, "Label")
    lbl = label.reshape(label.shape[0], label.shape[1]).to(torch.int64)
    trans = ctx.in1(op, "Transition")
    w_start, w_end, w = _split_transition(trans)
    tmax = emission.shape[0]

    alpha = w_start[None, :] + emission[0]                     # [n, D]
    for t in range(1, tmax):
        scores = alpha[:, :, None] + w[None, :, :] + emission[t][:, None, :]
        alpha = torch.where(alive[t][:, None],
                            torch.logsumexp(scores, dim=1), alpha)
    log_z = torch.logsumexp(alpha + w_end[None, :], dim=1)

    zero = torch.zeros((), dtype=emission.dtype, device=emission.device)
    em_sc = torch.gather(emission, 2, lbl[:, :, None])[:, :, 0]  # [T, n]
    em_score = torch.sum(torch.where(alive, em_sc, zero), dim=0)
    tr_sc = w[lbl[:-1], lbl[1:]]                                # [T-1, n]
    tr_score = torch.sum(torch.where(alive[1:], tr_sc, zero), dim=0)
    last = torch.clamp(lens - 1, min=0).to(torch.int64)
    start_score = w_start[lbl[0]]
    end_score = w_end[torch.gather(lbl, 0, last[None, :])[0]]
    gold = em_score + tr_score + start_score + end_score
    ctx.set_out(op, "LogLikelihood", (log_z - gold)[:, None])
    if ctx.is_read(ctx.out_name(op, "Alpha")):
        ctx.set_out(op, "Alpha", _unpad_to_lod(torch.zeros_like(emission),
                                               lens, total))
    if ctx.is_read(ctx.out_name(op, "EmissionExps")):
        ctx.set_out(op, "EmissionExps", _unpad_to_lod(torch.exp(emission),
                                                      lens, total))
    if ctx.is_read(ctx.out_name(op, "TransitionExps")):
        ctx.set_out(op, "TransitionExps", torch.exp(trans))


@register("crf_decoding")
def _crf_decoding(ctx, op):
    """Viterbi decode (crf_decoding_op.cc): the best tag of each live
    step; past a sequence's end the back-pointers are -1 and the
    backtrack keeps its tag. ``Label`` is accepted and not read, as in
    the JAX lowering."""
    emission, alive, lens, total = _live(ctx, op, "Emission")
    w_start, w_end, w = _split_transition(ctx.in1(op, "Transition"))
    tmax = emission.shape[0]
    delta = w_start[None, :] + emission[0]
    frozen = torch.full((), -1, dtype=torch.int64, device=emission.device)
    backptrs = []
    for t in range(1, tmax):
        scores = delta[:, :, None] + w[None, :, :] + emission[t][:, None, :]
        best, best_prev = torch.max(scores, dim=1)
        # torch.max's index is the first maximum, as jnp.argmax's
        live = alive[t][:, None]
        delta = torch.where(live, best, delta)
        backptrs.append(torch.where(live, best_prev, frozen))
    tag = torch.argmax(delta + w_end[None, :], dim=1)           # [n]
    path = [tag]
    for bp in reversed(backptrs):
        prev = torch.gather(bp, 1, tag[:, None])[:, 0]
        tag = torch.where(prev >= 0, prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1])                              # [T, n]
    ctx.set_out(op, "ViterbiPath", _unpad_to_lod(
        path[:, :, None], lens, total).to(torch_dtype("int64")))


@register("warpctc")
def _warpctc(ctx, op):
    """CTC loss [n, 1] (warpctc_op.cc) by the log-domain alpha recursion
    over the extended label sequence (blank l1 blank l2 ... blank), with
    NEG_INF as minus infinity; ``norm_by_times`` divides by the input
    length. WarpCTCGrad is zeros of the padded [n, maxlen, C], as in the
    JAX lowering."""
    logits, alive, in_lens, _ = _live(ctx, op, "Logits")       # [T, n, C]
    labels, _, lab_lens, _ = _live(ctx, op, "Label")
    labels = labels.reshape(labels.shape[0], labels.shape[1]).t()  # [n, L]
    blank = int(op.attr("blank", 0))
    log_probs = torch.log_softmax(logits, dim=-1)
    tmax, b, c = log_probs.shape
    dev = logits.device
    ext = torch.full((b, 2 * labels.shape[1] + 1), blank, dtype=torch.int64,
                     device=dev)
    ext[:, 1::2] = labels.to(torch.int64)
    neg = torch.full((b, 1), NEG_INF, dtype=log_probs.dtype, device=dev)
    first_lab = torch.gather(log_probs[0], 1, ext[:, 1:2])
    alpha = torch.cat([log_probs[0][:, blank:blank + 1],
                       torch.where((lab_lens > 0)[:, None], first_lab, neg),
                       neg.expand(b, ext.shape[1] - 2)], dim=1)
    same_as_prev2 = torch.cat(
        [torch.ones((b, 2), dtype=torch.bool, device=dev),
         ext[:, 2:] == ext[:, :-2]], dim=1)
    for t in range(1, tmax):
        p = torch.gather(log_probs[t], 1, ext)                 # [n, S]
        a_shift1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a_shift2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        a_shift2 = torch.where(same_as_prev2, neg, a_shift2)
        merged = torch.logaddexp(torch.logaddexp(alpha, a_shift1), a_shift2)
        alpha = torch.where(alive[t][:, None], merged + p, alpha)
    end_idx = (2 * lab_lens).to(torch.int64)
    a_last = torch.gather(alpha, 1, end_idx[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(end_idx - 1, min=0)[:, None]
                          )[:, 0]
    loss = -torch.logaddexp(a_last, a_prev)
    if op.attr("norm_by_times", False):
        loss = loss / torch.clamp(in_lens, min=1)
    ctx.set_out(op, "Loss", loss[:, None])
    if ctx.is_read(ctx.out_name(op, "WarpCTCGrad")):
        ctx.set_out(op, "WarpCTCGrad", torch.zeros(
            (b, tmax, c), dtype=logits.dtype, device=dev))


def _lod_or_one(ctx, op, slot, x):
    """The lengths of LoD input ``slot``, or one sequence of x's rows."""
    lens = _lengths(ctx, op, slot)
    return _one_sequence(x) if lens is None else lens


def _positions(lens, t):
    """(segment id, position in its sequence) of each of t flat rows;
    a pad row's position counts from the last sequence's start."""
    seg = segments(lens, t)
    pos = torch.arange(t, device=lens.device) - \
        starts(lens)[_clamped(seg, lens.shape[0])]
    return seg, pos


@register("ctc_align")
def _ctc_align(ctx, op):
    """CTC greedy post-process (ctc_align_op.cc): merge repeats, strip
    blanks. The output keeps the input's rows, the kept tokens first and
    -1 after them, with ``@LOD`` the decoded lengths."""
    x = ctx.in1(op, "Input")
    flat = x.reshape(-1).to(torch.int32)
    t = flat.shape[0]
    lens = _lod_or_one(ctx, op, "Input", flat)
    blank = int(op.attr("blank", 0))
    seg, pos = _positions(lens, t)
    prev = torch.where(pos > 0, torch.roll(flat, 1), -1)
    keep = flat != blank
    if op.attr("merge_repeated", True):
        keep = keep & (flat != prev)
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    out = torch.where(torch.arange(t, device=x.device) < torch.sum(keep),
                      flat[order], -1)
    name = ctx.out_name(op, "Output")
    ctx.env[name] = out[:, None].to(torch_dtype("int64"))
    ctx.env[name + "@LOD"] = segment_sum(keep.to(torch.int32), seg,
                                         lens.shape[0])


@register("chunk_eval")
def _chunk_eval(ctx, op):
    """Chunk detection metrics (chunk_eval_op.cc) for the IOB scheme
    (tag = type * 2 for B, type * 2 + 1 for I) or the plain one (tag =
    type); excluded types count as no chunk. A label chunk is correct
    when an inference chunk has the same start, end and type. The
    bucket's pad rows take an out-of-range tag, so they start no
    chunk."""
    inf = ctx.in1(op, "Inference").reshape(-1).to(torch.int32)
    lab = ctx.in1(op, "Label").reshape(-1).to(torch.int32)
    t = inf.shape[0]
    dev = inf.device
    lens = _lod_or_one(ctx, op, "Inference", inf)
    num_types = int(op.attr("num_chunk_types", 1))
    scheme = op.attr("chunk_scheme", "IOB")
    excluded = [int(e) for e in (op.attr("excluded_chunk_types") or [])]
    _, pos = _positions(lens, t)
    valid = torch.arange(t, device=dev) < torch.sum(lens)
    sentinel = 2 * num_types + 7
    inf = torch.where(valid, inf, sentinel)
    lab = torch.where(valid, lab, sentinel)

    def chunk_starts(tags):
        if scheme == "plain":
            typ = tags
            prev = torch.where(pos > 0, torch.roll(tags, 1), -1)
            start = (typ >= 0) & (typ < num_types) & (typ != prev)
        else:
            in_range = tags < 2 * num_types
            is_b = (tags % 2 == 0) & in_range
            is_i = (tags % 2 == 1) & in_range
            typ = torch.where(is_b | is_i, tags // 2, -1)
            prev_typ = torch.where(pos > 0, torch.roll(typ, 1), -2)
            start = is_b | (is_i & (typ != prev_typ))
        for et in excluded:
            start = start & (typ != et)
            typ = torch.where(typ == et, -1, typ)
        in_chunk = typ >= 0
        cid = torch.cumsum(start.to(torch.int32), 0) * in_chunk
        return start, typ, cid, in_chunk

    s_i, t_i, _, in_i = chunk_starts(inf)
    s_l, t_l, c_l, in_l = chunk_starts(lab)
    num_inf = torch.sum(s_i)
    num_lab = torch.sum(s_l)
    ok = (in_i == in_l) & (s_i == s_l) & torch.where(in_l, t_i == t_l, True)
    cum_bad = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                         torch.cumsum((~ok).to(torch.int64), 0)])
    pos_arr = torch.arange(t, device=dev)
    start_pos = _segment_reduce(torch.where(in_l, pos_arr, t), c_l, t + 1,
                                "amin", t)
    end_pos = _segment_reduce(torch.where(in_l, pos_arr, -1), c_l, t + 1,
                              "amax", -1)
    sp = torch.clamp(start_pos, 0, t - 1)
    ep = torch.clamp(end_pos, 0, t - 1)
    bad_in_span = cum_bad[ep + 1] - cum_bad[sp]
    # the inference chunk must end with the label chunk: the next row
    # must not continue an inference chunk
    cont = torch.cat([in_i & ~s_i,
                      torch.zeros((1,), dtype=torch.bool, device=dev)])
    correct_chunk = (end_pos >= 0) & (bad_in_span == 0) & ~cont[ep + 1]
    correct = torch.sum(correct_chunk[1:].to(torch.int32))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    precision = torch.where(num_inf > 0, correct / num_inf, zero)
    recall = torch.where(num_lab > 0, correct / num_lab, zero)
    f1 = torch.where(correct > 0,
                     2 * precision * recall / (precision + recall), zero)
    i64 = torch_dtype("int64")
    ctx.set_out(op, "Precision", precision.reshape(1))
    ctx.set_out(op, "Recall", recall.reshape(1))
    ctx.set_out(op, "F1-Score", f1.reshape(1))
    ctx.set_out(op, "NumInferChunks", num_inf.reshape(1).to(i64))
    ctx.set_out(op, "NumLabelChunks", num_lab.reshape(1).to(i64))
    ctx.set_out(op, "NumCorrectChunks", correct.reshape(1).to(i64))
