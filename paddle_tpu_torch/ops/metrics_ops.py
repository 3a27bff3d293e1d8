"""Metric ops: accuracy, auc, precision_recall, positive_negative_pair
and edit_distance (the counterpart of ``paddle_tpu/ops/metrics_ops.py``;
per-batch values, as the JAX package computes them inside the step)."""

import torch

from ..core.registry import register
from ..core.scope import torch_dtype
from .common import lod_valid_mask


@register("accuracy")
def _accuracy(ctx, op):
    """Share of rows whose label is among their top-k ``Indices``; Correct
    and Total as [1] int32 (int64 narrowed, as the port holds it). Over a
    bucketed LoD label (or LoD indices), pad rows are neither hits nor
    part of the total."""
    indices = ctx.in1(op, "Indices")      # [N, k]
    label = ctx.in1(op, "Label")          # [N, 1] or [N]
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label.reshape(-1)
    hit = torch.any(indices == label[:, None].to(indices.dtype), dim=1)
    i64 = torch_dtype("int64")
    valid, n_valid = lod_valid_mask(ctx, op, slot="Label")
    if valid is None:
        valid, n_valid = lod_valid_mask(ctx, op, slot="Indices")
    if valid is not None:
        hit = hit & valid
        total = n_valid.to(i64)
    else:
        # made on the device (a fill, no host copy a CUDA graph refuses)
        total = torch.full((), label.shape[0], dtype=i64,
                           device=indices.device)
    correct = torch.sum(hit).to(i64)
    ctx.set_out(op, "Accuracy",
                (correct.float() / total.float()).reshape(1))
    ctx.set_out(op, "Correct", correct.reshape(1))
    ctx.set_out(op, "Total", total.reshape(1))


@register("auc")
def _auc(ctx, op):
    """Batch AUC by threshold bucketing (operators/auc_op.cc, as the JAX
    package lowers it): true and false positive rates at
    ``num_thresholds`` evenly spaced thresholds in [0, 1] (a score above
    the threshold is a positive), integrated by the trapezoid rule."""
    preds = ctx.in1(op, "Out")            # [N, 2] probs or [N]
    if preds.dim() == 2 and preds.shape[1] >= 2:
        pos_score = preds[:, 1]
    else:
        pos_score = preds.reshape(-1)
    label = ctx.in1(op, "Label").reshape(-1).float()
    thresholds = torch.linspace(0.0, 1.0, op.attr("num_thresholds", 200),
                                device=pos_score.device)
    pred_pos = (pos_score[None, :] > thresholds[:, None]).float()  # [T, N]
    tp = torch.sum(pred_pos * label[None, :], dim=1)
    fp = torch.sum(pred_pos * (1 - label[None, :]), dim=1)
    pos = torch.sum(label)
    neg = label.shape[0] - pos
    tpr = tp / torch.clamp_min(pos, 1.0)
    fpr = fp / torch.clamp_min(neg, 1.0)
    ctx.set_out(op, "AUC", (-torch.trapezoid(tpr, fpr)).reshape(1))


@register("precision_recall")
def _precision_recall(ctx, op):
    """BatchMetrics = [macro precision, recall, F1, micro precision,
    recall, F1] over ``class_number`` classes; AccumStatesInfo = per
    class [TP, FP, FN]."""
    cls = op.attr("class_number")
    pred = ctx.in1(op, "Indices").reshape(-1).long()
    label = ctx.in1(op, "Labels").reshape(-1).long()
    eye = torch.eye(cls, dtype=torch.float32, device=pred.device)
    oh_pred = eye[pred]
    oh_lab = eye[label]
    tp = torch.sum(oh_pred * oh_lab, dim=0)
    fp = torch.sum(oh_pred * (1 - oh_lab), dim=0)
    fn = torch.sum((1 - oh_pred) * oh_lab, dim=0)

    def prf(tp, fp, fn):
        p = tp / torch.clamp_min(tp + fp, 1.0)
        r = tp / torch.clamp_min(tp + fn, 1.0)
        return p, r, 2 * p * r / torch.clamp_min(p + r, 1e-6)

    precision, recall, f1 = prf(tp, fp, fn)
    macro = torch.stack([torch.mean(precision), torch.mean(recall),
                         torch.mean(f1)])
    micro = torch.stack(prf(torch.sum(tp), torch.sum(fp), torch.sum(fn)))
    ctx.set_out(op, "BatchMetrics", torch.cat([macro, micro]))
    ctx.set_out(op, "AccumStatesInfo", torch.stack([tp, fp, fn], dim=1))


@register("positive_negative_pair")
def _positive_negative_pair(ctx, op):
    """Ranking-pair counts (operators/positive_negative_pair_op.h, as the
    JAX package lowers it): within each query, a pair with label_i >
    label_j is positive when score_i > score_j, negative when <, neutral
    when ==; a pair weighs (w_i + w_j) / 2. The optional accumulator
    inputs are added. Pairs are counted in blocks of 2048 rows against
    all rows, bounding the pairwise memory at [2048, N]."""
    s2 = ctx.in1(op, "Score")
    score = s2.reshape(-1)
    if s2.dim() == 2 and s2.shape[1] > 1:
        score = s2[:, int(op.attr("column", -1))]
    label = ctx.in1(op, "Label").reshape(-1)
    qid = ctx.in1(op, "QueryID").reshape(-1)
    w = ctx.in1(op, "Weight")
    w = torch.ones_like(score) if w is None else w.reshape(-1)
    total = torch.zeros(3, dtype=score.dtype, device=score.device)
    chunk = 2048
    for lo in range(0, score.shape[0], chunk):
        rows = slice(lo, lo + chunk)
        pair_w = (w[rows][:, None] + w[None, :]) * 0.5
        considered = (qid[rows][:, None] == qid[None, :]) & \
            (label[rows][:, None] > label[None, :])
        sc_d = score[rows][:, None] - score[None, :]
        zero = torch.zeros((), dtype=pair_w.dtype, device=pair_w.device)
        total = total + torch.stack([
            torch.sum(torch.where(considered & (sc_d > 0), pair_w, zero)),
            torch.sum(torch.where(considered & (sc_d < 0), pair_w, zero)),
            torch.sum(torch.where(considered & (sc_d == 0), pair_w, zero))])
    for i, (slot, acc) in enumerate((
            ("PositivePair", "AccumulatePositivePair"),
            ("NegativePair", "AccumulateNegativePair"),
            ("NeutralPair", "AccumulateNeutralPair"))):
        out = total[i].reshape(1)
        a = ctx.in1(op, acc)
        ctx.set_out(op, slot, out + (0.0 if a is None else a.reshape(1)))


@register("edit_distance")
def _edit_distance(ctx, op):
    """Levenshtein distance between int sequences (edit_distance_op.cc),
    row b of Hyps against row b of Refs, each cut at its length (the LoD
    lengths, else the row's width); divided by the reference's length
    with ``normalized``. A [T, 1] LoD input is one row of T. The DP runs
    row by row over the table, each row one pass of tensor ops."""
    hyp = ctx.in1(op, "Hyps")
    ref = ctx.in1(op, "Refs")
    hyp_lod = ctx.maybe_get(op.input("Hyps")[0] + "@LOD")
    ref_lod = ctx.maybe_get(op.input("Refs")[0] + "@LOD")
    if hyp.dim() == 2 and hyp.shape[-1] == 1:
        hyp = hyp[:, 0][None, :] if hyp_lod is None else hyp[:, 0]
    if ref.dim() == 2 and ref.shape[-1] == 1:
        ref = ref[:, 0][None, :] if ref_lod is None else ref[:, 0]
    if hyp.dim() == 1:
        hyp = hyp[None, :]
    if ref.dim() == 1:
        ref = ref[None, :]
    dev = hyp.device
    b, m = hyp.shape
    n = ref.shape[1]
    hls = hyp_lod if hyp_lod is not None else \
        torch.full((b,), m, dtype=torch.int32, device=dev)
    rls = ref_lod if ref_lod is not None else \
        torch.full((ref.shape[0],), n, dtype=torch.int32, device=dev)
    if not (b == ref.shape[0] == hls.shape[0] == rls.shape[0]):
        raise ValueError(
            "edit_distance pairs row b of Hyps with row b of Refs: got "
            "%d hypothesis rows, %d reference rows and %d / %d lengths"
            % (b, ref.shape[0], hls.shape[0], rls.shape[0]))
    cols = torch.arange(n, device=dev)
    prev = torch.arange(n + 1, dtype=torch.float32,
                        device=dev).expand(b, n + 1)
    for i in range(m):
        # the row's first cell, then left to right: min(up + 1, left + 1,
        # diag + cost); past the reference's length a cell copies left
        cost = (hyp[:, i:i + 1] != ref).float()             # [b, n]
        left = prev[:, 0] + 1
        row = [left]
        for j in range(n):
            val = torch.minimum(torch.minimum(prev[:, j + 1] + 1, left + 1),
                                prev[:, j] + cost[:, j])
            left = torch.where(cols[j] < rls, val, left)
            row.append(left)
        row = torch.stack(row, 1)
        prev = torch.where((i < hls)[:, None], row, prev)
    dists = torch.gather(prev, 1, rls.to(torch.int64)[:, None])[:, 0]
    if op.attr("normalized", True):
        dists = dists / torch.clamp_min(rls.float(), 1.0)
    ctx.set_out(op, "Out", dists.reshape(-1, 1))
    ctx.set_out(op, "SequenceNum",
                torch.full((1,), b, dtype=torch_dtype("int64"), device=dev))
