"""The port's ResNet slice against the JAX package: the vision ops one by
one, the ResNet Programs, and three Momentum steps of two small ResNets
with the 1x1-conv + BN fusion on and off.

Op-level cases run one-op (or, for the fused batch norm, two-op)
Programs through both Executors on the same numpy inputs and compare
every output at rtol 1e-5 / atol 1e-6 (the same fp32 arithmetic summed in
another order). The training cases start both packages from one startup
scope (the JAX package's, copied in with ``load_numpy_state``) and hold
losses at rtol 1e-5 and the weights and BN running statistics at 2e-4
of max(1, max|w|) per tensor, the reference's own
multi-step bound (``__graft_entry__.py:154``), as the LM's SGD/Adam
steps are held in test_torch_executor.py. Everything runs on the CPU;
``chip_smoke.py`` trains ResNet-50 on the card.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import resnet as JR
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.ops import matmul_stats as TMS

RTOL, ATOL = 1e-5, 1e-6


def _program(fluid, ops, arrays, out_names):
    """A Program of ``ops`` [(type, inputs, outputs, attrs)] whose inputs
    are the fed ``arrays`` and whose outputs are float32 vars."""
    prog = fluid.Program()
    blk = prog.global_block()
    for name, arr in arrays.items():
        blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
    for name in out_names:
        blk.create_var(name=name, dtype="float32")
    for op_type, inputs, outputs, attrs in ops:
        blk.append_op(type=op_type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
    return prog


def _run_both(ops, arrays, fetch):
    """(port outputs, JAX outputs) of the same Program on the same feed."""
    jprog = _program(jfluid, ops, arrays, fetch)
    with jfluid.scope_guard(jfluid.Scope()):
        ref = jfluid.Executor(jfluid.CPUPlace()).run(
            jprog, feed=arrays, fetch_list=fetch)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        _program(tfluid, ops, arrays, fetch), feed=arrays,
        fetch_list=fetch, scope=tfluid.Scope())
    return got, [np.asarray(r) for r in ref]


def _assert_same(got, ref, names):
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape, name
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def _one_op(op_type, inputs, outputs, attrs):
    """Run one op whose inputs are {slot: ndarray} and outputs a list of
    slots (each output var named after its slot) in both packages."""
    arrays = {slot.lower(): a for slot, a in inputs.items()}
    ops = [(op_type, {slot: [slot.lower()] for slot in inputs},
            {slot: ["out_" + slot.lower()] for slot in outputs}, attrs)]
    fetch = ["out_" + slot.lower() for slot in outputs]
    got, ref = _run_both(ops, arrays, fetch)
    _assert_same(got, ref, fetch)
    return got


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --------------------------------------------------------------------------
# ops

CONV_CASES = {
    "3x3_s2_p1": ((2, 4, 9, 9), (6, 4, 3, 3),
                  dict(strides=[2, 2], paddings=[1, 1])),
    "groups2_dilation2": ((2, 4, 8, 8), (6, 2, 3, 3),
                          dict(paddings=[2, 2], dilations=[2, 2], groups=2)),
    "1x1_s2": ((2, 4, 8, 8), (6, 4, 1, 1), dict(strides=[2, 2])),
    "7x7_s2_p3_stem": ((2, 3, 16, 16), (8, 3, 7, 7),
                       dict(strides=[2, 2], paddings=[3, 3])),
    "nhwc_3x3": ((2, 8, 8, 4), (6, 4, 3, 3),
                 dict(paddings=[1, 1], data_format="NHWC")),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case):
    xs, ws, attrs = CONV_CASES[case]
    _one_op("conv2d", {"Input": _rand(0, *xs), "Filter": _rand(1, *ws)},
            ["Output"], attrs)


POOL_CASES = {
    "stem_max_3x3_s2_p1": ((2, 3, 9, 9), dict(
        pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[1, 1])),
    "global_avg": ((2, 5, 7, 7), dict(
        pooling_type="avg", ksize=[1, 1], global_pooling=True)),
    "max_ceil": ((2, 3, 8, 8), dict(
        pooling_type="max", ksize=[3, 3], strides=[2, 2], ceil_mode=True)),
    "avg_ceil_exclusive": ((2, 3, 8, 8), dict(
        pooling_type="avg", ksize=[3, 3], strides=[2, 2], ceil_mode=True,
        exclusive=True)),
    "avg_ceil_inclusive": ((2, 3, 8, 8), dict(
        pooling_type="avg", ksize=[3, 3], strides=[2, 2], ceil_mode=True,
        exclusive=False)),
    "avg_p1_exclusive": ((2, 3, 6, 6), dict(
        pooling_type="avg", ksize=[3, 3], strides=[1, 1], paddings=[1, 1],
        exclusive=True)),
    "avg_p1_inclusive": ((2, 3, 6, 6), dict(
        pooling_type="avg", ksize=[3, 3], strides=[1, 1], paddings=[1, 1],
        exclusive=False)),
    "avg_2x2_s2": ((2, 3, 6, 6), dict(
        pooling_type="avg", ksize=[2, 2], strides=[2, 2])),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_jax(case):
    xs, attrs = POOL_CASES[case]
    x = _rand(2, *xs)
    if attrs["pooling_type"] == "max":
        x = np.abs(x)          # padded -inf cells must still never win
        x[:, :, 0, :] = -5.0   # nor beat a negative edge row
    _one_op("pool2d", {"X": x}, ["Out"], attrs)


def test_pool2d_ceil_mode_keeps_the_last_partial_window():
    """The JAX package's ceil rule, not torch's: 8 wide, window 3, stride
    2 gives 4 windows, the last one over columns 6..7 and the padding."""
    x = np.arange(64, dtype=np.float32).reshape(1, 1, 8, 8)
    out, = _one_op("pool2d", {"X": x}, ["Out"], dict(
        pooling_type="max", ksize=[3, 3], strides=[2, 2], ceil_mode=True))
    assert out.shape == (1, 1, 4, 4)
    assert out[0, 0, 3, 3] == 63.0


def _bn_inputs(c, seed):
    rng = np.random.RandomState(seed)
    return {"Scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
            "Bias": (0.1 * rng.randn(c)).astype(np.float32),
            "Mean": (0.5 * rng.randn(c)).astype(np.float32),
            "Variance": (1 + 0.2 * rng.rand(c)).astype(np.float32)}


BN_OUTS = ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "is_test"])
def test_batch_norm_matches_jax(is_test):
    inputs = dict(_bn_inputs(5, 3), X=_rand(4, 3, 5, 4, 4) + 0.7)
    _one_op("batch_norm", inputs, ["Y"] if is_test else BN_OUTS,
            dict(momentum=0.9, epsilon=1e-5, is_test=is_test))


@pytest.mark.parametrize("fuse", ["0", "1"], ids=["composed", "stash"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1x1_batch_norm_matches_jax(monkeypatch, fuse, stride):
    """A 1x1 conv feeding a train-mode BN: with the flag on, BN takes the
    conv's @BNSTATS stash in both packages (and the port's conv runs
    matmul_colstats); with it off, BN makes its own pass."""
    monkeypatch.setenv("PADDLE_TPU_FUSE_CONV_BN", fuse)
    calls = []
    real = TMS.matmul_colstats
    monkeypatch.setattr(TMS, "matmul_colstats",
                        lambda *a: calls.append(1) or real(*a))
    arrays = {n.lower(): a for n, a in _bn_inputs(6, 5).items()}
    arrays["x"] = _rand(6, 2, 4, 8, 8)
    arrays["w"] = _rand(7, 6, 4, 1, 1)
    ops = [("conv2d", {"Input": ["x"], "Filter": ["w"]},
            {"Output": ["conv"]}, {"strides": [stride, stride]}),
           ("batch_norm",
            {"X": ["conv"], "Scale": ["scale"], "Bias": ["bias"],
             "Mean": ["mean"], "Variance": ["variance"]},
            {s: ["out_" + s.lower()] for s in BN_OUTS},
            {"momentum": 0.9, "epsilon": 1e-5, "is_test": False})]
    fetch = ["out_" + s.lower() for s in BN_OUTS]
    got, ref = _run_both(ops, arrays, fetch)
    _assert_same(got, ref, fetch)
    assert len(calls) == (fuse == "1")


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_cross_entropy_matches_jax(soft):
    rng = np.random.RandomState(8)
    logits = rng.randn(6, 5)
    prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
            ).astype(np.float32)
    if soft:
        label = rng.dirichlet(np.ones(5), 6).astype(np.float32)
        attrs = {"soft_label": True}
    else:
        label = rng.randint(0, 5, (6, 1)).astype(np.int64)
        label[2, 0] = -1                      # ignored
        attrs = {"soft_label": False, "ignore_index": -1}
    out, = _one_op("cross_entropy", {"X": prob, "Label": label}, ["Y"],
                   attrs)
    if not soft:
        assert out[2, 0] == 0.0 and (out[np.arange(6) != 2] > 0).all()


def test_mean_matches_jax():
    _one_op("mean", {"X": _rand(9, 3, 4, 5)}, ["Out"], {})


def test_top_k_matches_jax():
    out, idx = _one_op("top_k", {"X": _rand(10, 5, 7)}, ["Out", "Indices"],
                       {"k": 3})
    assert idx.dtype == np.int32


def test_accuracy_matches_jax():
    rng = np.random.RandomState(11)
    idx = np.stack([rng.permutation(6)[:2] for _ in range(8)]).astype(
        np.int64)
    label = rng.randint(0, 6, (8, 1)).astype(np.int64)
    label[0, 0] = idx[0, 1]                 # at least one hit
    acc, correct, total = _one_op(
        "accuracy", {"Out": _rand(12, 8, 2), "Indices": idx, "Label": label},
        ["Accuracy", "Correct", "Total"], {})
    assert total.tolist() == [8] and 0 < correct[0] <= 8
    assert acc[0] == pytest.approx(correct[0] / 8.0)


@pytest.mark.parametrize("nesterov", [False, True],
                         ids=["plain", "nesterov"])
def test_momentum_matches_jax(nesterov):
    _one_op("momentum", {"Param": _rand(13, 4, 3), "Grad": _rand(14, 4, 3),
                         "Velocity": _rand(15, 4, 3),
                         "LearningRate": np.array([0.05], np.float32)},
            ["ParamOut", "VelocityOut"],
            {"mu": 0.9, "use_nesterov": nesterov})


def test_unported_vision_ops_raise():
    """The vision ops of the JAX package not ported yet (box_coder,
    prior_box: ROADMAP.md, queue 1 item 7) raise NotImplementedError
    naming ROADMAP.md. Adaptive pooling, pool3d and im2sequence, which
    raised here before, are ported (tests/test_torch_ops_sweep3.py,
    tests/test_torch_sequence_ops.py)."""
    x = {"X": _rand(16, 1, 2, 4, 4)}
    for op_type, attrs in (("box_coder", {}),
                           ("prior_box", {"min_sizes": [2.0]})):
        prog = _program(tfluid, [(op_type, {"X": ["x"]},
                                  {"Out": ["out"]}, attrs)],
                        {"x": x["X"]}, ["out"])
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tfluid.Executor(tfluid.CPUPlace()).run(
                prog, feed={"x": x["X"]}, fetch_list=["out"],
                scope=tfluid.Scope())
    for op_type, attrs, v in (
            ("pool2d", {"adaptive": True, "ksize": [2, 2]}, x["X"]),
            ("pool3d", {"ksize": [1, 1, 1]}, _rand(17, 1, 2, 3, 4, 4)),
            ("im2sequence", {"kernels": [2, 2]}, x["X"])):
        prog = _program(tfluid, [(op_type, {"X": ["x"]},
                                  {"Out": ["out"]}, attrs)],
                        {"x": v}, ["out"])
        out, = tfluid.Executor(tfluid.CPUPlace()).run(
            prog, feed={"x": v}, fetch_list=["out"], scope=tfluid.Scope())
        assert np.isfinite(out).all()


# --------------------------------------------------------------------------
# programs

def _build(fluid, R, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, avg_cost, acc = R.build_train_net(**kw)
    return main, startup, avg_cost, acc


@pytest.mark.parametrize("kw", [
    dict(model="resnet_imagenet", depth=50, image_shape=(3, 224, 224),
         num_classes=1000),
    dict(model="resnet_cifar10", depth=32)], ids=["resnet50", "cifar32"])
def test_to_json_identical(kw):
    """Built only, never run."""
    jmain, jstart, _, _ = _build(jfluid, JR, **kw)
    tmain, tstart, _, _ = _build(tfluid, TR, **kw)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    ops = [op.type for op in tmain.global_block().ops]
    assert ops.count("conv2d") == ops.count("batch_norm") == (
        53 if kw["model"] == "resnet_imagenet" else 31 + 2)
    assert ops.count("momentum") == len(
        tmain.global_block().all_parameters()) - ops.count("batch_norm") * 2


# --------------------------------------------------------------------------
# three Momentum steps

def _narrow_net(fluid, R):
    """The ImageNet stem at 32x32 and two narrow bottleneck stages (the
    second with stride 2), built from the model module's own functions."""
    layers = fluid.layers
    image = layers.data("data", [3, 32, 32])
    label = layers.data("label", [1], dtype="int64")
    conv1 = R.conv_bn_layer(image, ch_out=8, filter_size=7, stride=2,
                            padding=3)
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2,
                          pool_padding=1)
    res1 = R.layer_warp(R.bottleneck, pool1, 4, 2, 1)
    res2 = R.layer_warp(R.bottleneck, res1, 8, 2, 2)
    pool2 = layers.pool2d(res2, pool_type="avg", global_pooling=True)
    predict = layers.fc(pool2, 10, act="softmax")
    avg_cost = layers.mean(layers.cross_entropy(predict, label))
    acc = layers.accuracy(predict, label)
    fluid.optimizer.Momentum(learning_rate=0.01,
                             momentum=0.9).minimize(avg_cost)
    return avg_cost, acc


def _narrow_feeds(rng):
    return {"data": rng.rand(4, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}


def _steps_program(fluid, R, net):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if net == "narrow":
            avg_cost, acc = _narrow_net(fluid, R)
            feeds = _narrow_feeds
        else:
            build, feeds = R.zoo_spec()
            avg_cost, acc = build()
    return main, startup, avg_cost, acc, feeds


@pytest.mark.parametrize("fuse", ["0", "1"], ids=["composed", "fused"])
@pytest.mark.parametrize("net", ["narrow", "zoo_cifar8"])
def test_three_momentum_steps_match_jax(monkeypatch, net, fuse):
    monkeypatch.setenv("PADDLE_TPU_FUSE_CONV_BN", fuse)
    calls = []
    real = TMS.matmul_colstats
    monkeypatch.setattr(TMS, "matmul_colstats",
                        lambda *a: calls.append(1) or real(*a))
    jmain, jstart, javg, jacc, feeds = _steps_program(jfluid, JR, net)
    tmain, _, tavg, tacc, _ = _steps_program(tfluid, TR, net)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    state = {n: np.asarray(jscope.find_var(n))
             for n in jscope.local_var_names()
             if jscope.find_var(n) is not None}
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    for i in range(3):
        feed = feeds(np.random.RandomState(20 + i))
        with jfluid.scope_guard(jscope):
            ref = jexe.run(jmain, feed=feed, fetch_list=[javg, jacc])
        got = texe.run(tmain, feed=feed, fetch_list=[tavg, tacc],
                       scope=tscope)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    one_by_one = sum(1 for op in tmain.global_block().ops
                     if op.type == "conv2d"
                     and op.input("Filter")[0] in state
                     and state[op.input("Filter")[0]].shape[2:] == (1, 1))
    assert len(calls) == (3 * one_by_one if fuse == "1" else 0)
    # weights and BN running statistics (the block's parameters); the
    # velocities are raw gradient sums, where one ReLU input within
    # rounding of 0 (e.g. -3.9e-7 in one package, +6e-8 in the other)
    # moves a whole element's share, and reach the weights scaled by lr
    params = [p.name for p in tmain.global_block().all_parameters()]
    assert all(op.input(slot)[0] in params
               for op in tmain.global_block().ops if op.type == "batch_norm"
               for slot in ("Mean", "Variance"))
    moved = 0.0
    for n in params:
        jw = np.asarray(jscope.find_var(n))
        tw = tscope.get_numpy(n)
        scale = max(1.0, float(np.abs(jw).max()))
        assert float(np.abs(tw - jw).max()) <= 2e-4 * scale, n
        moved = max(moved, float(np.abs(jw - state[n]).max()) / scale)
    assert moved > 1e-3       # the steps really moved the state
