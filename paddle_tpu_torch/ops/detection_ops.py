"""Detection ops (the SSD pipeline).

The counterpart of ``paddle_tpu/ops/detection_ops.py`` (operators/
{prior_box,box_coder,iou_similarity,bipartite_match,target_assign,
mine_hard_examples,multiclass_nms,detection_map}_op.cc and the fused
``ssd_loss``). Every output has a static shape: NMS keeps a fixed
``keep_top_k`` budget padded with -1, matching is a greedy loop of
argmax eliminations.

The JAX package's ``fori_loop``s become Python loops whose trip counts
come from shapes, each round run once for the whole batch (every image,
every class) with a shared loop index where the JAX package ``vmap``s:
no lowering reads a device value on the host, so a CUDA graph holds
them. Orders follow the JAX package's tie rules: ``jnp.argsort`` is
stable (``stable=True`` here), ``lax.top_k`` sends a tie to the lower
index (a stable descending sort here), ``argmax`` takes the first
maximum (``torch.argmax`` does too, over the row-major flattened
matrix where the JAX package flattens).
"""

import numpy as np
import torch

from ..core.registry import register
from ..core.scope import torch_dtype
from .tensor_ops import kept


def _prior_boxes(h, w, ih, iw, op):
    """The host's prior boxes and variances [h, w, P, 4] of a feature
    map (prior_box_op.cc), as the JAX lowering builds them."""
    min_sizes = [float(s) for s in op.attr("min_sizes", [])]
    max_sizes = [float(s) for s in op.attr("max_sizes", [])]
    ratios = [float(r) for r in op.attr("aspect_ratios", [1.0])]
    flip = op.attr("flip", False)
    offset = float(op.attr("offset", 0.5))
    variances = [float(v) for v in op.attr("variances",
                                           [0.1, 0.1, 0.2, 0.2])]
    sw = float(op.attr("step_w", 0.0)) or iw / w
    sh = float(op.attr("step_h", 0.0)) or ih / h
    ars = [1.0]
    for r in ratios:
        if all(abs(r - a) > 1e-6 for a in ars):
            ars.append(r)
            if flip:
                ars.append(1.0 / r)
    wh = []
    for k, ms in enumerate(min_sizes):
        for a in ars:
            wh.append((ms * np.sqrt(a), ms / np.sqrt(a)))
            if a == 1.0 and k < len(max_sizes):
                big = np.sqrt(ms * max_sizes[k])
                wh.append((big, big))
    wh = np.asarray(wh, np.float32)                  # [P, 2]
    cxg, cyg = np.meshgrid((np.arange(w) + offset) * sw,
                           (np.arange(h) + offset) * sh)
    boxes = np.zeros((h, w, wh.shape[0], 4), np.float32)
    boxes[..., 0] = (cxg[:, :, None] - wh[None, None, :, 0] / 2) / iw
    boxes[..., 1] = (cyg[:, :, None] - wh[None, None, :, 1] / 2) / ih
    boxes[..., 2] = (cxg[:, :, None] + wh[None, None, :, 0] / 2) / iw
    boxes[..., 3] = (cyg[:, :, None] + wh[None, None, :, 1] / 2) / ih
    if op.attr("clip", False):
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variances, np.float32), boxes.shape)
    return boxes, np.ascontiguousarray(var)


@register("prior_box")
def _prior_box(ctx, op):
    """SSD prior boxes of a feature map [N, C, H, W] over an image
    [N, 3, IH, IW]: constants of the shapes and attributes, built on the
    host once per op and shape (``tensor_ops.kept``)."""
    feat = ctx.in1(op, "Input")
    img = ctx.in1(op, "Image")
    key = (feat.shape[2], feat.shape[3], img.shape[2], img.shape[3])
    boxes, var = kept(ctx, op, key, lambda: _prior_boxes(*key, op))
    ctx.set_out(op, "Boxes", boxes)
    ctx.set_out(op, "Variances", var)


def _iou_matrix(a, b, offset=0.0):
    """a [..., N, 4], b [..., M, 4] -> [..., N, M] IoU of (xmin, ymin,
    xmax, ymax) boxes; offset 1.0 for pixel boxes (widths count both
    edges)."""
    area_a = torch.clamp(a[..., 2] - a[..., 0] + offset, min=0) * \
        torch.clamp(a[..., 3] - a[..., 1] + offset, min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0] + offset, min=0) * \
        torch.clamp(b[..., 3] - b[..., 1] + offset, min=0)
    ix0 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy0 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix1 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy1 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(ix1 - ix0 + offset, min=0) * \
        torch.clamp(iy1 - iy0 + offset, min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union,
                       torch.zeros((), dtype=inter.dtype,
                                   device=inter.device))


@register("iou_similarity")
def _iou_similarity(ctx, op):
    ctx.set_out(op, "Out", _iou_matrix(ctx.in1(op, "X"), ctx.in1(op, "Y")))


def _centers(box):
    """(width, height, center x, center y) of [..., 4] boxes."""
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    return w, h, box[..., 0] + w / 2, box[..., 1] + h / 2


@register("box_coder")
def _box_coder(ctx, op):
    """Encode target boxes [N, 4] against priors [M, 4] to [N, M, 4]
    offsets, or decode offsets [N, M, 4] (or [M, 4]) to boxes
    (box_coder_op.cc, center-size)."""
    prior = ctx.in1(op, "PriorBox")
    var = ctx.in1(op, "PriorBoxVar")
    tb = ctx.in1(op, "TargetBox")
    pw, ph, pcx, pcy = _centers(prior)
    if var is None:
        var = torch.ones_like(prior)
    if "encode" in op.attr("code_type", "encode_center_size"):
        tw, th, tcx, tcy = _centers(tb)
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :] / var[None, :, 0],
            (tcy[:, None] - pcy[None, :]) / ph[None, :] / var[None, :, 1],
            torch.log(torch.clamp(tw[:, None] / pw[None, :], min=1e-10))
            / var[None, :, 2],
            torch.log(torch.clamp(th[:, None] / ph[None, :], min=1e-10))
            / var[None, :, 3]], dim=-1)
    else:
        if tb.dim() == 2:
            tb = tb[None]
        dcx = tb[..., 0] * var[None, :, 0] * pw[None, :] + pcx[None, :]
        dcy = tb[..., 1] * var[None, :, 1] * ph[None, :] + pcy[None, :]
        dw = torch.exp(tb[..., 2] * var[None, :, 2]) * pw[None, :]
        dh = torch.exp(tb[..., 3] * var[None, :, 3]) * ph[None, :]
        out = torch.stack([dcx - dw / 2, dcy - dh / 2,
                           dcx + dw / 2, dcy + dh / 2], dim=-1)
    ctx.set_out(op, "OutputBox", out)


def _greedy_bipartite(dist):
    """dist [B, G, M] -> col_match [B, M] int64: for each batch entry,
    min(G, M) rounds of taking the largest entry of the row-major
    flattened matrix (the first on a tie), matching its column to its
    row when it is above 0 and striking both (bipartite_match_op.cc)."""
    b, g, m = dist.shape
    dev = dist.device
    rows = torch.arange(g, device=dev)[None, :, None]
    cols = torch.arange(m, device=dev)[None, None, :]
    col_match = torch.full((b, m), -1, dtype=torch.int64, device=dev)
    d = dist
    for _ in range(min(g, m)):
        flat = torch.argmax(d.reshape(b, g * m), dim=1)        # [B]
        best = torch.gather(d.reshape(b, g * m), 1, flat[:, None])[:, 0]
        i, j = flat // m, flat % m
        valid = (best > 0)[:, None]
        col_match = torch.where(valid & (cols[:, 0] == j[:, None]),
                                i[:, None], col_match)
        hit = valid[:, :, None] & ((rows == i[:, None, None])
                                   | (cols == j[:, None, None]))
        d = torch.where(hit, -1.0, d)
    return col_match


def _per_prediction(dist, col_match, thresh):
    """A column left unmatched takes its best row where that overlap is
    at least ``thresh`` (match_type "per_prediction"); also returns each
    column's best overlap."""
    best_val, best_row = torch.max(dist, dim=-2)
    extra = (col_match < 0) & (best_val >= thresh)
    return torch.where(extra, best_row, col_match), best_val


@register("bipartite_match")
def _bipartite_match(ctx, op):
    """Greedy bipartite matching of DistMat [N gt rows, M priors]
    (bipartite_match_op.cc), then "per_prediction"'s extra matches."""
    dist = ctx.in1(op, "DistMat")
    m = dist.shape[1]
    col_match = _greedy_bipartite(dist[None])[0]
    if op.attr("match_type", "bipartite") == "per_prediction":
        col_match, _ = _per_prediction(
            dist, col_match, float(op.attr("dist_threshold", 0.5)))
    dist_out = torch.where(
        col_match >= 0,
        dist[torch.clamp(col_match, min=0), torch.arange(m,
                                                         device=dist.device)],
        torch.zeros((), dtype=dist.dtype, device=dist.device))
    ctx.set_out(op, "ColToRowMatchIndices",
                col_match[None, :].to(torch.int32))
    ctx.set_out(op, "ColToRowMatchDist", dist_out[None, :])


@register("target_assign")
def _target_assign(ctx, op):
    """Each prior's target row of X [N_gt, K] (or [N_gt, 1, K]) by its
    match index, ``mismatch_value`` where unmatched; OutWeight 1 where
    matched (target_assign_op.cc)."""
    x = ctx.in1(op, "X")
    match = ctx.in1(op, "MatchIndices").reshape(-1)
    if x.dim() == 3:
        x = x[:, 0, :]
    out = x[torch.clamp(match, 0, x.shape[0] - 1).to(torch.int64)]
    neg = (match < 0)[:, None]
    out = torch.where(neg, torch.full((), op.attr("mismatch_value", 0),
                                      dtype=x.dtype, device=x.device), out)
    wt = torch.where(neg[:, 0], 0.0, 1.0)
    ctx.set_out(op, "Out", out[None])
    ctx.set_out(op, "OutWeight", wt[None, :, None])


def _hard_negatives(loss, count):
    """[N, M] mask of each row's ``count`` largest ``loss`` entries, ties
    to the lower index (the JAX package's stable argsort of -loss, then
    the rank of each entry)."""
    order = torch.argsort(-loss, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return rank < count[:, None]


@register("mine_hard_examples")
def _mine_hard_examples(ctx, op):
    """Hard negatives by classification loss, ``neg_pos_ratio`` per
    positive (mine_hard_examples_op.cc, max_negative). NegIndices is an
    [N, M] list of the mined columns, descending, -1 padded."""
    cls_loss = ctx.in1(op, "ClsLoss")
    match = ctx.in1(op, "MatchIndices")
    ratio = float(op.attr("neg_pos_ratio", 3.0))
    m = cls_loss.shape[1]
    is_pos = match >= 0
    num_pos = torch.sum(is_pos, dim=1, dtype=torch.int32)
    num_neg = torch.minimum((num_pos * ratio).to(torch.int32), m - num_pos)
    neg_mask = _hard_negatives(
        torch.where(is_pos, float("-inf"), cls_loss), num_neg)
    cols = torch.arange(m, dtype=match.dtype, device=match.device)
    neg_idx = torch.where(neg_mask, cols[None, :], -1)
    ctx.set_out(op, "NegIndices", torch.flip(torch.sort(neg_idx, dim=1)[0],
                                             [1]))
    ctx.set_out(op, "UpdatedMatchIndices", torch.where(neg_mask, -1, match))


def nms_keep(boxes, scores, score_thresh, nms_thresh, top_k, offset=0.0,
             eta=1.0):
    """Greedy NMS of every image and class at once: boxes [N, M, 4],
    scores [N, C, M] -> keep mask [N, C, M]. One round a candidate in
    score order, the same round for every (image, class): a valid
    candidate is kept unless it overlaps an already kept box above the
    threshold. With ``eta`` < 1 (adaptive NMS) the threshold decays by
    eta after each kept box while it stays above 0.5. Rounds:
    min(M, top_k), or M when top_k < 0."""
    n, c, m = scores.shape
    valid = scores > score_thresh
    order = torch.argsort(-torch.where(valid, scores, float("-inf")),
                          dim=-1, stable=True)                 # [N, C, M]
    iou = _iou_matrix(boxes, boxes, offset)                    # [N, M, M]
    keep = torch.zeros((n, c, m), dtype=torch.bool, device=scores.device)
    th = torch.full((n, c), nms_thresh, dtype=torch.float32,
                    device=scores.device)
    for i in range(m if top_k < 0 else min(m, top_k)):
        cand = order[:, :, i]                                  # [N, C]
        ok = torch.gather(valid, 2, cand[:, :, None])[:, :, 0]
        over = torch.gather(iou, 1, cand[:, :, None].expand(n, c, m))
        sup = torch.any(keep & (over > th[:, :, None]), dim=2)
        kept_now = ok & ~sup
        keep = keep.scatter(2, cand[:, :, None], kept_now[:, :, None])
        if eta < 1.0:
            th = torch.where(kept_now & (th > 0.5), th * eta, th)
    return keep


@register("multiclass_nms")
def _multiclass_nms(ctx, op):
    """Per-class NMS, then the cross-class ``keep_top_k`` by score
    (multiclass_nms_op.cc): Out [N, keep_top_k, 6] rows of (label,
    score, x1, y1, x2, y2), -1 rows past the kept ones. BBoxes
    [N, M, 4], Scores [N, C, M]."""
    boxes = ctx.in1(op, "BBoxes")
    scores = ctx.in1(op, "Scores")
    score_thresh = float(op.attr("score_threshold", 0.0))
    background = int(op.attr("background_label", 0))
    n, c, m = scores.shape
    classes = [k for k in range(c) if k != background]
    cls_idx, labels = kept(ctx, op, ("classes", c, m), lambda: (
        np.asarray(classes, np.int64),
        np.repeat(np.asarray(classes, np.float32), m)))
    s = torch.index_select(scores, 1, cls_idx)                 # [N, C', M]
    keep = nms_keep(boxes, s, score_thresh,
                    float(op.attr("nms_threshold", 0.3)),
                    int(op.attr("nms_top_k", -1)),
                    0.0 if op.attr("normalized", True) else 1.0,
                    float(op.attr("nms_eta", 1.0) or 1.0))
    cp = len(classes)
    sc = torch.where(keep, s, -1.0).reshape(n, cp * m)
    allr = torch.cat([labels[None, :, None].expand(n, cp * m, 1),
                      sc[:, :, None],
                      boxes[:, None].expand(n, cp, m, 4).reshape(
                          n, cp * m, 4)], dim=2)               # [N, C'M, 6]
    k = min(int(op.attr("keep_top_k", 100)), cp * m)
    top = torch.sort(sc, dim=1, descending=True, stable=True)[1][:, :k]
    rows = torch.gather(allr, 1, top[:, :, None].expand(n, k, 6))
    ctx.set_out(op, "Out", torch.where(rows[:, :, 1:2] > score_thresh,
                                       rows, -1.0))


@register("detection_map")
def _detection_map(ctx, op):
    """mAP of one batch (detection_map_op.cc) over DetectRes [K, 6]
    (label, score, box) and Label [G, 6] (label, ..., box): detections
    in score order each claim at most one unclaimed ground truth of
    their class above ``overlap_threshold``; a detection matching only
    difficult ground truth (with ``evaluate_difficult`` off) is
    ignored. AP "11point" (interpolated) or "integral"; with
    ``class_num`` the mean over classes that have ground truth and a
    counted detection, else one class-pooled list."""
    det = ctx.in1(op, "DetectRes")
    gt_label = ctx.in1(op, "Label")
    overlap_t = float(op.attr("overlap_threshold", 0.5))
    ap_version = str(op.attr("ap_version", "11point") or "11point")
    dev = det.device
    det_valid = det[:, 1] > 0
    gt_cls = gt_label[:, 0]
    g = gt_label.shape[0]
    iou = _iou_matrix(det[:, 2:6], gt_label[:, -4:])
    matched = (iou > overlap_t) & (det[:, 0:1] == gt_cls[None, :])
    if not bool(op.attr("evaluate_difficult", True)) and \
            op.input("Difficult"):
        difficult = ctx.in1(op, "Difficult").reshape(-1) > 0
    else:
        difficult = torch.zeros((g,), dtype=torch.bool, device=dev)
    n_gt = torch.clamp(torch.sum(~difficult), min=1)

    order = torch.argsort(-det[:, 1], stable=True)
    matched_s = matched[order]
    iou_s = iou[order]
    valid_s = det_valid[order]
    gts = torch.arange(g, device=dev)
    used = torch.zeros((g,), dtype=torch.bool, device=dev)
    tp, ign = [], []
    for i in range(det.shape[0]):
        cand = matched_s[i] & ~used & ~difficult
        hit = torch.any(cand) & valid_s[i]
        j = torch.argmax(torch.where(cand, iou_s[i], -1.0))
        used = used | (hit & (gts == j))
        tp.append(hit)
        ign.append(valid_s[i] & ~hit & torch.any(matched_s[i] & difficult))
    tp_sorted = torch.stack(tp)
    counted = valid_s & ~torch.stack(ign)
    cls_sorted = det[order, 0]

    def ap_over(mask, n_gt_cls):
        """AP of the detections where ``mask`` ([..., K], score order),
        against ``n_gt_cls`` ground truths ([...])."""
        tp_m = tp_sorted & mask
        cum_tp = torch.cumsum(tp_m, dim=-1)
        total = torch.clamp(torch.cumsum(counted & mask, dim=-1), min=1)
        denom = torch.clamp(n_gt_cls, min=1)
        precision = cum_tp / total
        zero = torch.zeros((), dtype=precision.dtype, device=dev)
        if ap_version == "integral":
            return torch.sum(torch.where(tp_m, precision, zero),
                             dim=-1) / denom
        recall = cum_tp / denom[..., None]
        ap = 0.0
        for r in np.arange(0.0, 1.1, 0.1):
            p = torch.amax(torch.where((recall >= r) & mask, precision,
                                       zero), dim=-1)
            ap = ap + p / 11.0
        return ap

    class_num = int(op.attr("class_num", 0) or 0)
    if class_num > 0:
        background = int(op.attr("background_label", 0))
        cls_ids, = kept(ctx, op, ("classes", class_num), lambda: (
            np.asarray([k for k in range(class_num) if k != background],
                       np.float32),))
        masks = cls_sorted[None, :] == cls_ids[:, None]        # [C', K]
        gt_counts = torch.sum((gt_cls[None, :] == cls_ids[:, None])
                              & ~difficult[None, :], dim=1)
        has = ((gt_counts > 0) & torch.any(masks & counted[None, :], dim=1)
               ).to(torch.float32)
        ap = torch.sum(ap_over(masks, gt_counts) * has) / \
            torch.clamp(torch.sum(has), min=1.0)
    else:
        ap = ap_over(torch.ones_like(counted), n_gt)
    ctx.set_out(op, "MAP", ap.reshape(1))
    ctx.set_out(op, "AccumPosCount", torch.full(
        (1,), det.shape[0], dtype=torch_dtype("int64"), device=dev))


def _padded_ground_truth(gt_box, gt_label, lengths, gmax, background):
    """Flat ground truth [G, 4] / [G] with per-image lengths -> padded
    [N, gmax, 4] boxes (zeros past an image's count), [N, gmax] labels
    (``background`` there) and the valid mask, gathered with each index
    clamped to the flat rows (the JAX package scatters, dropping the
    bucket's pad rows; the gather reads only live rows)."""
    dev = gt_box.device
    lengths = lengths.to(torch.int64)
    slot = torch.arange(gmax, device=dev)[None, :]
    valid = slot < lengths[:, None]                            # [N, gmax]
    idx = torch.clamp((torch.cumsum(lengths, 0) - lengths)[:, None] + slot,
                      max=gt_box.shape[0] - 1)
    box = torch.where(valid[:, :, None], gt_box[idx],
                      torch.zeros((), dtype=gt_box.dtype, device=dev))
    lab = torch.where(valid, gt_label[idx], background)
    return box, lab, valid


@register("ssd_loss")
def _ssd_loss(ctx, op):
    """The fused SSD multibox loss (the reference's layers/detection.py
    ssd_loss composition): per-image IoU matching (greedy bipartite,
    then per_prediction), softmax cross-entropy against the matched
    labels, hard negatives mined by that loss among the priors whose
    best overlap is under ``neg_overlap``, smooth-L1 on the encoded
    offsets of the positives. Loc [N, M, 4], Conf [N, M, C], GTBox flat
    [G, 4] with ``@LOD`` lengths, GTLabel flat [G, 1], PriorBox and
    PriorBoxVar [M, 4] -> Loss [N, 1], divided by the matched count
    when ``normalize``.

    The JAX package pads the ground truth to [N, G] (G the flat total);
    the port pads to the ground truth's ``@MAXLEN`` where it has one (no
    image holds more), which gives the same matches: the rows it leaves
    out are invalid, of zero overlap, and the JAX package's extra
    matching rounds over them change nothing."""
    loc = ctx.in1(op, "Loc")
    conf = ctx.in1(op, "Conf")
    gt_box = ctx.in1(op, "GTBox")
    prior = ctx.in1(op, "PriorBox")
    pvar = ctx.in1(op, "PriorBoxVar")
    if pvar is None:
        pvar = torch.ones_like(prior)
    background = int(op.attr("background_label", 0))
    n, m, c = conf.shape
    g_total = gt_box.shape[0]
    if g_total == 0:
        ctx.set_out(op, "Loss", torch.zeros((n, 1), dtype=torch.float32,
                                            device=conf.device))
        return
    gt_label = ctx.in1(op, "GTLabel").reshape(-1).to(torch.int64)
    name = op.input("GTBox")[0]
    lengths = ctx.maybe_get(name + "@LOD")
    if lengths is None:
        if n != 1:
            raise ValueError("ssd_loss: GTBox without a LoD holds one "
                             "image's ground truth, but Conf has %d" % n)
        lengths = torch.full((1,), g_total, dtype=torch.int32,
                             device=gt_box.device)
    gmax = min(g_total, int(ctx.static_info.get(name + "@MAXLEN", g_total)))
    pad_box, pad_lab, gt_valid = _padded_ground_truth(
        gt_box, gt_label, lengths, gmax, background)

    iou = torch.where(gt_valid[:, :, None], _iou_matrix(pad_box, prior),
                      torch.zeros((), dtype=gt_box.dtype,
                                  device=gt_box.device))        # [N, G, M]
    col_match = _greedy_bipartite(iou)
    if op.attr("match_type", "per_prediction") == "per_prediction":
        col_match, best_iou = _per_prediction(
            iou, col_match, float(op.attr("overlap_threshold", 0.5)))
    else:
        best_iou = torch.amax(iou, dim=1)
    is_pos = col_match >= 0
    midx = torch.clamp(col_match, min=0)
    tgt_label = torch.where(is_pos, torch.gather(pad_lab, 1, midx),
                            background)
    logp = torch.log_softmax(conf.to(torch.float32), dim=-1)
    ce = -torch.gather(logp, 2, tgt_label[:, :, None])[:, :, 0]  # [N, M]

    # unmatched priors whose best overlap reaches neg_overlap straddle an
    # object: they leave the negative pool (mine_hard_examples_op.cc)
    neg_cand = ~is_pos & (best_iou < float(op.attr("neg_overlap", 0.5)))
    num_pos = torch.sum(is_pos, dim=1, dtype=torch.int32)
    num_neg = torch.minimum(
        (num_pos * float(op.attr("neg_pos_ratio", 3.0))).to(torch.int32),
        torch.sum(neg_cand, dim=1, dtype=torch.int32))
    is_neg = _hard_negatives(
        torch.where(neg_cand, ce.detach(), float("-inf")), num_neg)
    conf_loss = ce * (is_pos | is_neg).to(torch.float32)

    pw, ph, pcx, pcy = _centers(prior)
    mbox = torch.gather(pad_box, 1, midx[:, :, None].expand(n, m, 4))
    tw, th, tcx, tcy = _centers(mbox)
    enc = torch.stack([
        (tcx - pcx) / pw / pvar[:, 0],
        (tcy - pcy) / ph / pvar[:, 1],
        torch.log(torch.clamp(tw / pw, min=1e-10)) / pvar[:, 2],
        torch.log(torch.clamp(th / ph, min=1e-10)) / pvar[:, 3]], dim=-1)
    diff = loc.to(torch.float32) - enc
    ad = torch.abs(diff)
    smooth = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5)
    loc_loss = torch.sum(smooth, dim=-1) * is_pos.to(torch.float32)

    loss = float(op.attr("conf_loss_weight", 1.0)) * conf_loss + \
        float(op.attr("loc_loss_weight", 1.0)) * loc_loss
    per_img = torch.sum(loss, dim=1, keepdim=True)
    if bool(op.attr("normalize", True)):
        per_img = per_img / torch.clamp(
            torch.sum(num_pos).to(torch.float32), min=1.0)
    ctx.set_out(op, "Loss", per_img)
