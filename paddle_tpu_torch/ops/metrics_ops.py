"""Metric ops: accuracy, auc, precision_recall and positive_negative_pair
(the counterpart of ``paddle_tpu/ops/metrics_ops.py``; per-batch values,
as the JAX package computes them inside the step). edit_distance, over
LoD sequences, waits for ROADMAP.md queue 1 item 7."""

import torch

from ..core.registry import register
from ..core.scope import torch_dtype


@register("accuracy")
def _accuracy(ctx, op):
    """Share of rows whose label is among their top-k ``Indices``; Correct
    and Total as [1] int32 (int64 narrowed, as the port holds it). LoD
    labels, which the JAX package masks, raise in the Executor."""
    indices = ctx.in1(op, "Indices")      # [N, k]
    label = ctx.in1(op, "Label")          # [N, 1] or [N]
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label.reshape(-1)
    hit = torch.any(indices == label[:, None].to(indices.dtype), dim=1)
    i64 = torch_dtype("int64")
    correct = torch.sum(hit).to(i64)
    # made on the device (a fill, no host copy a CUDA graph would refuse)
    total = torch.full((), label.shape[0], dtype=i64, device=indices.device)
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
