"""The detection ops of the PyTorch port (``ops/detection_ops.py``)
against the JAX package, on the CPU.

* ``prior_box``, ``iou_similarity``, ``box_coder`` (encode and decode),
  ``bipartite_match`` (and ``per_prediction``), ``target_assign``,
  ``mine_hard_examples``, ``multiclass_nms`` (``nms_eta`` < 1, another
  background label, pixel boxes), ``detection_map`` (both AP versions,
  difficult ground truth, per-class) and ``ssd_loss`` (an image with no
  ground truth, a batch with none, ``neg_overlap``, the bipartite-only
  match) as one-op
  Programs through both Executors (``tools/op_sweep.detection_cases``,
  the card sweep's cases): forward at rtol 1e-5 / atol 1e-6, the
  ``calc_gradient`` of box_coder's targets and of ssd_loss's Loc and
  Conf against ``jax.grad`` at rtol 1e-4 / atol 1e-5. The scores and
  distances are rounded to quarters, so the sorts, the top-k and the
  argmaxes meet ties; the ground truth's LoD totals are no power of
  two;
* tests/test_detection_crf_ctc.py's and tests/test_evaluator_average.py's
  worked examples through the port;
* the detection builders emit the JAX package's Program JSON, and the
  port's ``metrics`` and ``evaluator`` are the JAX package's.
"""

import inspect

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.tools import op_sweep

from torch_op_harness import check

OPS = ("prior_box", "iou_similarity", "box_coder", "bipartite_match",
       "target_assign", "mine_hard_examples", "multiclass_nms",
       "detection_map", "ssd_loss")
CASES = [c for c in op_sweep.detection_cases() if c[0] in OPS]


@pytest.mark.parametrize("case", CASES, ids=[
    "%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_op_matches_jax(case):
    op_type, inputs, attrs, outs, wrt = case
    got = check(op_type, inputs, attrs, outs, wrt)
    first = next(iter(got.values()))
    if op_type == "ssd_loss" and not sum(inputs["GTBox"].lengths):
        np.testing.assert_array_equal(first, 0.0)   # nothing to match
    elif op_type in ("multiclass_nms", "detection_map", "ssd_loss"):
        assert np.abs(first).max() > 0, "a case that holds nothing"


def test_cases_cover_every_op():
    assert {c[0] for c in CASES} == set(OPS)


def _run(op_type, inputs, attrs, outs):
    prog, feed, fetch = op_sweep.one_op_program(tfluid, op_type, inputs,
                                                attrs, outs)
    return tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=tfluid.Scope())


def test_worked_examples():
    x = np.array([[0, 0, 2, 2], [1, 1, 3, 3]], np.float32)
    y = np.array([[0, 0, 2, 2], [2, 2, 4, 4]], np.float32)
    iou, = _run("iou_similarity", {"X": x, "Y": y}, {}, ["Out"])
    np.testing.assert_allclose(iou, [[1, 0], [1 / 7, 1 / 7]], rtol=1e-5,
                               atol=1e-6)
    dist = np.array([[0.9, 0.1, 0.3], [0.8, 0.7, 0.2]], np.float32)
    idx, d = _run("bipartite_match", {"DistMat": dist}, {},
                  ["ColToRowMatchIndices", "ColToRowMatchDist"])
    np.testing.assert_array_equal(idx[0], [0, 1, -1])
    np.testing.assert_allclose(d[0], [0.9, 0.7, 0.0], rtol=1e-6)
    boxes = np.array([[[0, 0, 1, 1], [0, 0.3, 1, 1.42], [2, 2, 3, 3]]],
                     np.float32)
    scores = np.zeros((1, 2, 3), np.float32)
    scores[0, 1] = [0.9, 0.8, 0.7]

    def nms(eta):
        out, = _run("multiclass_nms", {"BBoxes": boxes, "Scores": scores},
                    {"score_threshold": 0.1, "nms_threshold": 0.6,
                     "keep_top_k": 3, "background_label": 0,
                     "nms_eta": eta}, ["Out"])
        return out[0][out[0][:, 1] > 0]

    assert nms(1.0).shape[0] == 3       # IoU(A, B) ~0.52 < 0.6
    kept = nms(0.8)                     # the threshold decays to 0.48
    np.testing.assert_allclose(sorted(kept[:, 1]), [0.7, 0.9], rtol=1e-6)
    b, v = _run("prior_box", {"Input": np.zeros((1, 8, 4, 4), np.float32),
                              "Image": np.zeros((1, 3, 64, 64),
                                                np.float32)},
                {"min_sizes": [10.0], "max_sizes": [20.0],
                 "aspect_ratios": [2.0], "flip": True, "clip": True},
                ["Boxes", "Variances"])
    assert b.shape == v.shape == (4, 4, 4, 4)
    assert (b >= 0).all() and (b <= 1).all()


def test_box_coder_round_trip():
    rng = np.random.RandomState(0)
    prior = np.sort(rng.rand(5, 4).astype(np.float32), axis=1)
    var = np.full((5, 4), 0.1, np.float32)
    target = np.sort(rng.rand(3, 4).astype(np.float32), axis=1)
    enc, = _run("box_coder", {"PriorBox": prior, "PriorBoxVar": var,
                              "TargetBox": target},
                {"code_type": "encode_center_size"}, ["OutputBox"])
    dec, = _run("box_coder", {"PriorBox": prior, "PriorBoxVar": var,
                              "TargetBox": enc},
                {"code_type": "decode_center_size"}, ["OutputBox"])
    np.testing.assert_allclose(dec, np.broadcast_to(target[:, None],
                                                    (3, 5, 4)),
                               rtol=1e-3, atol=1e-4)


def test_detection_map_evaluator():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        det = tfluid.layers.data("det", [6])
        gt = tfluid.layers.data("gt", [5])
        diff = tfluid.layers.data("diff", [1])
        m = tfluid.evaluator.DetectionMAP(det, gt)
        m_nd = tfluid.evaluator.DetectionMAP(
            det, gt, gt_difficult=diff, evaluate_difficult=False,
            ap_version="integral")
    exe = tfluid.Executor(tfluid.CPUPlace())
    dv = np.array([[0, 0.9, 0, 0, 10, 10], [1, 0.8, 20, 20, 30, 30]],
                  np.float32)
    gv = np.array([[0, 0, 0, 10, 10], [1, 20, 20, 30, 30],
                   [1, 40, 40, 50, 50]], np.float32)
    for _ in range(3):
        mv, nd = exe.run(main, feed={"det": dv, "gt": gv, "diff": np.array(
            [[0], [0], [1]], np.float32)}, fetch_list=[m.metrics[0],
                                                     m_nd.metrics[0]],
            scope=tfluid.Scope())
        m.update(mv)
    # pooled 11-point over 3 GT: recall 1/3, 2/3 at precision 1
    np.testing.assert_allclose(m.eval(), [7 / 11], rtol=1e-5)
    np.testing.assert_allclose(nd, [1.0], rtol=1e-5)   # the third: difficult
    m.reset()
    with pytest.raises(ValueError):
        m.eval()


def _builders(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        img = L.data("img", [3, 32, 32])
        f1 = L.conv2d(img, num_filters=8, filter_size=3, stride=4,
                      padding=1)
        f2 = L.conv2d(f1, num_filters=8, filter_size=3, stride=2,
                      padding=1)
        locs, confs, boxes, vars_ = L.multi_box_head(
            inputs=[f1, f2], image=img, base_size=32, num_classes=5,
            aspect_ratios=[[2.0], [2.0, 3.0]], min_sizes=[4.0, 8.0],
            max_sizes=[8.0, 16.0])
        gt = L.data("gt", [4], lod_level=1)
        lab = L.data("lab", [1], dtype="int64", lod_level=1)
        loss = L.ssd_loss(locs, confs, gt, lab, boxes, vars_,
                          neg_overlap=0.4)
        dets = L.detection_output(locs, confs, boxes, vars_, nms_eta=0.9)
        dist = L.data("dist", [6], append_batch_size=False)
        idx, mdist = L.bipartite_match(dist, match_type="per_prediction",
                                       dist_threshold=0.4)
        out, w = L.target_assign(gt, idx, mismatch_value=1.0)
        pb, pv = L.prior_box(f2, img, [4.0], [8.0], [2.0], flip=True)
        enc = L.box_coder(pb, pv, gt)
        nms = L.multiclass_nms(enc, confs, nms_top_k=10, keep_top_k=4)
        det = L.data("det", [6])
        gtl = L.data("gtl", [6])
        mp = L.detection_map(det, gtl, class_num=5, ap_version="integral")
    return main, startup, [loss, dets, idx, mdist, out, w, nms, mp]


def test_builders_emit_jax_json():
    jmain, jstart, _ = _builders(jfluid)
    tmain, tstart, _ = _builders(tfluid)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    assert {op.type for op in tmain.global_block().ops} >= set(OPS) - {
        "iou_similarity", "mine_hard_examples"}


def test_metrics_and_evaluator_are_the_jax_ones():
    for jmod, tmod in ((jfluid.metrics, tfluid.metrics),
                       (jfluid.evaluator, tfluid.evaluator)):
        assert tmod.__all__ == jmod.__all__
        for name in tmod.__all__:
            assert inspect.getsource(getattr(tmod, name)) == \
                inspect.getsource(getattr(jmod, name)), name
    ce = tfluid.metrics.ChunkEvaluator()
    ce.update(4, 5, 3)
    ce.update(2, 1, 1)
    p, r, f = ce.eval()
    assert (p, r) == (4 / 6, 4 / 6) and abs(f - 4 / 6) < 1e-12
