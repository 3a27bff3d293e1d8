"""Op sweep of the PyTorch port, part 2: the tensor ops, the losses,
log_softmax / lrn / maxout and the metric ops, each through both
Executors against the JAX package (tests/torch_op_harness.py: forward at
rtol 1e-5, gradients where tests/test_ops_sweep.py checks one). The
random ops are held by distribution and by the port's own determinism,
``nce`` by its Cost recomputed from its own SampleLabels; ``range``,
whose inputs the JAX package needs as trace-time constants, is held
against the JAX lowering called on concrete values."""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jregistry

from torch_op_harness import build, check, rand, run


# --------------------------------------------------------------------------
# tensor ops
def test_fills_and_assign():
    ref = rand(40, 5, 2)
    check("fill_constant_batch_size_like", {"Input": ref},
          {"shape": [3, 4], "value": 0.5}, ["Out"])
    check("fill_constant_batch_size_like", {"Input": ref},
          {"shape": [2, 3], "value": 7, "dtype": "int32",
           "input_dim_idx": 1, "output_dim_idx": 1}, ["Out"])
    x = rand(41, 2, 3)
    check("fill_zeros_like", {"X": x}, {}, ["Out"])
    check("fill_any_like", {"X": x}, {"value": 2.5}, ["Out"])
    check("assign", {"X": x}, {}, ["Out"], wrt=["X"])


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_concat(axis):
    xs = [rand(42 + s, 2, 3, s + 1) if axis == -1 else
          (rand(42 + s, s + 1, 3) if axis == 0 else rand(42 + s, 2, s + 1))
          for s in range(3)]
    check("concat", {"X": xs}, {"axis": axis}, ["Out"], wrt=["X"])


def test_squeeze_unsqueeze():
    check("squeeze", {"X": rand(46, 2, 1, 3, 1)}, {"axes": [1]}, ["Out"],
          wrt=["X"])
    check("squeeze", {"X": rand(47, 2, 1, 3, 1)}, {}, ["Out"])
    check("squeeze", {"X": rand(48, 2, 1, 3, 1)}, {"axes": [-1, 1]},
          ["Out"])
    check("unsqueeze", {"X": rand(49, 2, 3)}, {"axes": [1]}, ["Out"],
          wrt=["X"])
    check("unsqueeze", {"X": rand(50, 2, 3)}, {"axes": [3, 0]}, ["Out"])


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_stack_unstack(axis):
    xs = [rand(51 + i, 2, 3) for i in range(3)]
    check("stack", {"X": xs}, {"axis": axis}, ["Y"], wrt=["X"])
    x = rand(54, 3, 3, 3)
    check("unstack", {"X": x}, {"axis": axis}, [("Y", 3)])


def test_gather_scatter():
    x = rand(55, 5, 3)
    check("gather", {"X": x, "Index": np.array([0, 3, 1, 3], np.int32)}, {},
          ["Out"], wrt=["X"])
    check("gather", {"X": x, "Index": np.array([4, 2], np.int64)}, {},
          ["Out"])
    upd = rand(56, 2, 3)
    ids = np.array([1, 4], np.int32)
    for overwrite in (True, False):
        check("scatter", {"X": x, "Ids": ids, "Updates": upd},
              {"overwrite": overwrite}, ["Out"], wrt=["X"])
    # repeated ids add up when not overwriting
    check("scatter", {"X": x, "Ids": np.array([2, 2, 0], np.int32),
                      "Updates": rand(57, 3, 3)}, {"overwrite": False},
          ["Out"])


def test_pad_crop_slice():
    x = rand(58, 2, 3)
    check("pad", {"X": x}, {"paddings": [1, 0, 0, 2], "pad_value": 9.0},
          ["Out"], wrt=["X"])
    check("pad", {"X": rand(59, 2, 3, 4)}, {"paddings": [0, 1, 2, 0, 1, 1]},
          ["Out"])
    check("pad_constant_like", {"X": rand(60, 4, 5), "Y": rand(61, 2, 3)},
          {"pad_value": 0.5}, ["Out"])
    big = rand(62, 4, 5)
    check("crop", {"X": big}, {"offsets": [1, 2], "shape": [2, 2]},
          ["Out"], wrt=["X"])
    check("slice", {"Input": big},
          {"axes": [0, 1], "starts": [1, 0], "ends": [3, 4]}, ["Out"],
          wrt=["Input"])
    check("slice", {"Input": big},
          {"axes": [1], "starts": [-3], "ends": [1000]}, ["Out"])
    check("slice", {"Input": rand(63, 3, 4, 5)},
          {"axes": [0, 2], "starts": [0, 1], "ends": [-1, -1]}, ["Out"])


def test_shape_increment_multiplex():
    check("shape", {"Input": rand(64, 3, 7)}, {}, ["Out"])
    check("increment", {"X": np.array([3], np.int32)}, {"step": 2.0},
          ["Out"])
    check("increment", {"X": np.array([1.5], np.float32)}, {"step": 0.25},
          ["Out"])
    check("increment", {"X": np.array([3], np.int64)}, {}, ["Out"])
    xs = [rand(65 + i, 3, 4) for i in range(3)]
    check("multiplex", {"X": xs, "Ids": np.array([[1], [0], [2]],
                                                 np.int32)}, {}, ["Out"])


def test_is_empty_linspace_sequence_mask():
    check("is_empty", {"X": np.zeros((0, 3), np.float32)}, {}, ["Out"])
    check("is_empty", {"X": np.zeros((2, 3), np.float32)}, {}, ["Out"])
    check("linspace", {}, {"start": 0.0, "stop": 1.0, "num": 5}, ["Out"])
    check("linspace", {}, {"start": -2.5, "stop": 3.0, "num": 12}, ["Out"])
    x = np.array([2, 4, 1, 0], np.int32)
    check("sequence_mask", {"X": x}, {"maxlen": 5}, ["Y"])
    check("sequence_mask", {"X": x.reshape(2, 2)},
          {"maxlen": 4, "out_dtype": "int32"}, ["Y"])


def test_range_matches_jax_lowering():
    """The JAX package's range lowering on concrete values (it refuses
    traced ones) against the port's, through its Executor."""
    vals = {"Start": np.array([1.5], np.float32),
            "End": np.array([6.0], np.float32),
            "Step": np.array([0.75], np.float32)}
    jprog, feed, fetch, _ = build(jfluid, "range", vals, {}, ["Out"])
    op = jprog.global_block().ops[0]
    env = {n: feed[n] for n in feed}
    ctx = jregistry.LowerContext(env, None)
    jregistry.lookup("range").lower(ctx, op)
    want = np.asarray(env[fetch[0]])
    tprog, _, _, _ = build(tfluid, "range", vals, {}, ["Out"])
    got, = run(tfluid, tprog, feed, fetch)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, np.arange(1.5, 6.0, 0.75), rtol=1e-6)


def test_print_and_delete_var(capsys):
    x = rand(68, 2, 2)
    check("print", {"In": x}, {"message": "sweep"}, ["Out"])
    assert "sweep" in capsys.readouterr().out
    # delete_var drops its input from the step: fetching it raises in
    # both packages, the rest runs
    for pkg in (jfluid, tfluid):
        prog, feed, fetch, _ = build(pkg, "assign", {"X": x}, {}, ["Out"])
        blk = prog.global_block()
        blk.append_op("delete_var", {"X": ["x_0"]}, {}, {})
        out, = run(pkg, prog, feed, fetch)
        np.testing.assert_array_equal(out, x)
        with pytest.raises(Exception, match="x_0"):
            run(pkg, prog, feed, ["x_0"])


@pytest.mark.parametrize("op", ["uniform_random_batch_size_like",
                                "gaussian_random_batch_size_like"])
def test_random_batch_size_like(op):
    """Shape from the reference input; the values by distribution and by
    the port's determinism (one seed, one run counter, one draw)."""
    ref = rand(69, 3000, 2)
    attrs = {"shape": [7, 5], "input_dim_idx": 0, "output_dim_idx": 0}
    attrs.update({"min": -2.0, "max": 2.0} if op.startswith("uniform")
                 else {"mean": 1.0, "std": 2.0})
    prog, feed, fetch, _ = build(tfluid, op, {"Input": ref}, attrs,
                                 ["Out"])
    prog.random_seed = 11
    outs = []
    for _ in range(2):
        exe = tfluid.Executor(tfluid.CPUPlace())
        outs.append(exe.run(prog, feed=feed, fetch_list=fetch,
                            scope=tfluid.Scope())[0])
    np.testing.assert_array_equal(outs[0], outs[1])
    v = outs[0].astype(np.float64)
    assert v.shape == (3000, 5) and outs[0].dtype == np.float32
    if op.startswith("uniform"):
        assert v.min() >= -2.0 and v.max() < 2.0
        assert abs(v.mean()) < 0.05 and abs(v.std() - 4 / 12 ** 0.5) < 0.05
    else:
        assert abs(v.mean() - 1.0) < 0.1 and abs(v.std() - 2.0) < 0.05
    jprog, _, _, _ = build(jfluid, op, {"Input": ref}, attrs, ["Out"])
    want, = run(jfluid, jprog, feed, fetch)
    assert want.shape == v.shape and want.dtype == outs[0].dtype


def test_nce_by_its_own_samples():
    """Shapes and dtypes as the JAX package's; Cost recomputed in numpy
    from the port's SampleLabels (the true labels first, then the
    negatives in [0, num_total_classes)); a fixed seed draws the same
    samples twice."""
    x = rand(70, 4, 3)
    label = np.array([[1], [0], [2], [1]], np.int64)
    w, b = rand(71, 5, 3), rand(72, 5)
    sw = rand(73, 4, 1, lo=0.5, hi=1.5)
    inputs = {"Input": x, "Label": label, "Weight": w, "Bias": b,
              "SampleWeight": sw}
    attrs = {"num_total_classes": 5, "num_neg_samples": 3}
    outs = ["Cost", "SampleLogits", "SampleLabels"]
    jprog, feed, fetch, _ = build(jfluid, "nce", inputs, attrs, outs)
    want = run(jfluid, jprog, feed, fetch)
    tprog, _, _, _ = build(tfluid, "nce", inputs, attrs, outs)
    tprog.random_seed = 3
    got = run(tfluid, tprog, feed, fetch)
    again = run(tfluid, tprog, feed, fetch)
    for g, a, wv in zip(got, again, want):
        assert g.shape == wv.shape and g.dtype == wv.dtype
        np.testing.assert_array_equal(g, a)
    cost, logits, samples = got
    np.testing.assert_array_equal(samples[:, :1], label.astype(np.int32))
    assert samples.min() >= 0 and samples.max() < 5
    ref_logits = np.einsum("bd,bkd->bk", x, w[samples]) + b[samples] \
        - np.log(5.0)
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-5, atol=1e-6)
    y = np.concatenate([np.ones((4, 1)), np.zeros((4, 3))], axis=1)
    per = np.maximum(ref_logits, 0) - ref_logits * y + \
        np.log1p(np.exp(-np.abs(ref_logits)))
    np.testing.assert_allclose(cost, per.sum(1, keepdims=True) * sw,
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# losses
def test_sigmoid_cross_entropy_with_logits():
    check("sigmoid_cross_entropy_with_logits",
          {"X": rand(74, 3, 4, lo=-3, hi=3), "Label": rand(75, 3, 4,
                                                          lo=0, hi=1)},
          {}, ["Out"], wrt=["X"])


def test_margin_and_pair_losses():
    labels = (rand(76, 4, 1, lo=0, hi=1) > 0.5).astype(np.float32)
    check("hinge_loss", {"Logits": rand(77, 4, 1, lo=-2, hi=2),
                         "Labels": labels}, {}, ["Loss"], wrt=["Logits"])
    check("rank_loss", {"Label": labels, "Left": rand(78, 4, 1),
                        "Right": rand(79, 4, 1)}, {}, ["Out"],
          wrt=["Left", "Right"])
    sign = np.array([[1], [-1], [1], [-1]], np.float32)
    check("margin_rank_loss", {"Label": sign, "X1": rand(80, 4, 1),
                               "X2": rand(81, 4, 1)}, {"margin": 0.1},
          ["Out", "Activated"], wrt=["X1", "X2"])
    check("modified_huber_loss", {"X": rand(82, 6, 1, lo=-2, hi=2),
                                  "Y": np.array([[0], [1], [1], [0], [1],
                                                 [0]], np.float32)},
          {}, ["Out", "IntermediateVal"], wrt=["X"])


def test_regression_losses():
    x, y = rand(83, 4, 1), rand(84, 4, 1, lo=0, hi=3)
    check("huber_loss", {"X": x, "Y": y}, {"delta": 1.0},
          ["Out", "Residual"], wrt=["X"])
    check("log_loss", {"Predicted": rand(85, 4, 1, lo=0.1, hi=0.9),
                       "Labels": rand(86, 4, 1, lo=0, hi=1)},
          {"epsilon": 1e-4}, ["Loss"], wrt=["Predicted"])
    a, b = rand(87, 3, 4), rand(88, 3, 4)
    check("smooth_l1_loss", {"X": a, "Y": b}, {"sigma": 1.0},
          ["Out", "Diff"], wrt=["X"])
    check("smooth_l1_loss", {"X": a, "Y": b,
                             "InsideWeight": rand(89, 3, 4, lo=0, hi=2),
                             "OutsideWeight": rand(90, 3, 4, lo=0, hi=2)},
          {"sigma": 2.0}, ["Out", "Diff"], wrt=["X"])


# --------------------------------------------------------------------------
# nn ops
def test_log_softmax_lrn_maxout():
    check("log_softmax", {"X": rand(91, 3, 5, lo=-2, hi=2)}, {}, ["Out"],
          wrt=["X"])
    x = rand(92, 2, 6, 3, 3)
    check("lrn", {"X": x}, {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75},
          ["Out", "MidOut"], wrt=["X"])
    check("lrn", {"X": x}, {"n": 3}, ["Out", "MidOut"])
    check("maxout", {"X": x}, {"groups": 2}, ["Out"], wrt=["X"])
    check("maxout", {"X": x}, {"groups": 3}, ["Out"])


# --------------------------------------------------------------------------
# metrics
def test_auc():
    rng = np.random.RandomState(93)
    p1 = rng.uniform(0, 1, 64).astype(np.float32)
    preds = np.stack([1 - p1, p1], axis=1)
    label = (rng.uniform(0, 1, (64, 1)) < p1[:, None]).astype(np.int64)
    check("auc", {"Out": preds, "Label": label}, {}, ["AUC"])
    check("auc", {"Out": p1.reshape(-1, 1), "Label": label},
          {"num_thresholds": 50}, ["AUC"])


def test_precision_recall():
    rng = np.random.RandomState(94)
    idx = rng.randint(0, 4, (20, 1)).astype(np.int32)
    lab = rng.randint(0, 4, (20, 1)).astype(np.int32)
    check("precision_recall", {"Indices": idx, "Labels": lab},
          {"class_number": 4}, ["BatchMetrics", "AccumStatesInfo"])


def test_positive_negative_pair():
    score = np.array([[0.9], [0.4], [0.3], [0.7], [0.5], [0.5], [0.2],
                      [0.8]], np.float32)
    label = np.array([[2], [1], [2], [1], [0], [1], [0], [2]], np.float32)
    qid = np.array([[0], [0], [1], [1], [1], [1], [2], [2]], np.int64)
    outs = ["PositivePair", "NegativePair", "NeutralPair"]
    check("positive_negative_pair",
          {"Score": score, "Label": label, "QueryID": qid}, {}, outs)
    check("positive_negative_pair",
          {"Score": score, "Label": label, "QueryID": qid,
           "Weight": rand(95, 8, 1, lo=0.5, hi=2),
           "AccumulatePositivePair": np.array([1.0], np.float32),
           "AccumulateNegativePair": np.array([2.0], np.float32),
           "AccumulateNeutralPair": np.array([3.0], np.float32)}, {}, outs)
    two = np.concatenate([score, score[::-1]], axis=1)
    check("positive_negative_pair",
          {"Score": two, "Label": label, "QueryID": qid}, {"column": 0},
          outs)


@pytest.mark.parametrize("op", ["print", "range"])
def test_host_reading_ops_refuse_a_graph_capture(op, monkeypatch):
    """print and range read the host: inside a CUDA graph capture
    (``run_steps`` on the card) they raise instead of recording a copy
    the graph would replay stale. The capture is faked on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    inputs = {"In": rand(102, 2, 2)} if op == "print" else {
        s: np.array([v], np.float32)
        for s, v in (("Start", 0.0), ("End", 3.0), ("Step", 1.0))}
    prog, feed, fetch, _ = build(tfluid, op, inputs, {}, ["Out"])
    with pytest.raises(NotImplementedError, match="CUDA graph"):
        run(tfluid, prog, feed, fetch)
