"""Gradient clips, weight decay and the ops they and label smoothing emit,
in the PyTorch port against the JAX package.

The ops (clip, clip_by_norm on both sides of its norm, one_hot,
label_smooth with and without a prior, sum, the elementwise binary table,
sqrt, square, sign) run as one-op Programs through both Executors on the
same numpy inputs, mirroring tests/test_ops_sweep.py; outputs are held
exactly where both packages compute the same one rounding (one_hot,
label_smooth without a prior, the comparisons and sign) and at rtol
1e-5 / atol 1e-6 elsewhere (the same fp32 arithmetic, reductions summed
in another order). The three gradient clips and L1 / L2 decay each train
a small fc net 3 SGD steps from the JAX startup scope copied in with
``load_numpy_state``: losses and weights at 2e-4 of max(1, max|w|) per
tensor, the reference's multi-step bound (``__graft_entry__.py:154``).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def _r(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


def _program(fluid, op_type, inputs, attrs):
    prog = fluid.Program()
    blk = prog.global_block()
    names = {}
    for slot, arrs in inputs.items():
        names[slot] = []
        for i, arr in enumerate(arrs if isinstance(arrs, list) else [arrs]):
            name = "%s_%d" % (slot.lower(), i)
            blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
            names[slot].append(name)
    blk.create_var(name="out", dtype="float32")
    blk.append_op(type=op_type, inputs=names, outputs={"Out": ["out"]},
                  attrs=attrs)
    return prog


def _one_op(op_type, inputs, attrs=None, exact=False):
    """Out of one op in both packages, compared; returns the port's."""
    attrs = attrs or {}
    feed = {}
    for slot, arrs in inputs.items():
        for i, arr in enumerate(arrs if isinstance(arrs, list) else [arrs]):
            feed["%s_%d" % (slot.lower(), i)] = arr
    with jfluid.scope_guard(jfluid.Scope()):
        ref, = jfluid.Executor(jfluid.CPUPlace()).run(
            _program(jfluid, op_type, inputs, attrs), feed=feed,
            fetch_list=["out"])
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        _program(tfluid, op_type, inputs, attrs), feed=feed,
        fetch_list=["out"], scope=tfluid.Scope())
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    return got


# -- ops ----------------------------------------------------------------------

def test_clip_matches_jax():
    x = _r(26, 3, 4, lo=-3, hi=3)
    out = _one_op("clip", {"X": x}, {"min": -1.0, "max": 1.5})
    np.testing.assert_array_equal(out, np.clip(x, -1, 1.5))


@pytest.mark.parametrize("above", [True, False], ids=["scaled", "kept"])
def test_clip_by_norm_matches_jax(above):
    x = _r(27, 3, 4, lo=1, hi=2)
    norm = float(np.sqrt((x.astype(np.float64) ** 2).sum()))
    out = _one_op("clip_by_norm", {"X": x},
                  {"max_norm": 1.0 if above else norm + 5})
    if above:
        np.testing.assert_allclose(np.sqrt((out ** 2).sum()), 1.0,
                                   rtol=1e-5)
    else:
        np.testing.assert_array_equal(out, x)


@pytest.mark.parametrize("ids", [np.array([0, 2, 1], np.int32),
                                 np.array([[3], [0], [5]], np.int64)],
                         ids=["flat_int32", "trailing1_int64_oob"])
def test_one_hot_matches_jax(ids):
    out = _one_op("one_hot", {"X": ids}, {"depth": 4}, exact=True)
    assert out.dtype == np.float32 and out.shape == (3, 4)


@pytest.mark.parametrize("prior", [False, True])
def test_label_smooth_matches_jax(prior):
    x = np.eye(4, dtype=np.float32)[np.array([0, 2, 3])]
    inputs = {"X": x}
    if prior:
        inputs["PriorDist"] = np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)
    _one_op("label_smooth", inputs, {"epsilon": 0.1}, exact=not prior)


def test_sum_matches_jax():
    xs = [_r(30 + i, 3, 4) for i in range(3)]
    out = _one_op("sum", {"X": xs})
    np.testing.assert_allclose(out, xs[0] + xs[1] + xs[2], rtol=1e-6)


@pytest.mark.parametrize("op_type", [
    "elementwise_sub", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv"])
def test_elementwise_matches_jax(op_type):
    x = _r(40, 3, 4, lo=0.5, hi=3)
    y = _r(41, 4, lo=0.5, hi=2)
    if op_type in ("elementwise_mod", "elementwise_floordiv"):
        x = np.round(x * 3) - 4
        y = np.round(y * 2) + 1
    _one_op(op_type, {"X": x, "Y": y}, {"axis": -1})


@pytest.mark.parametrize("op_type", ["sqrt", "square", "sign"])
def test_unary_matches_jax(op_type):
    x = _r(42, 3, 5, lo=0.0 if op_type == "sqrt" else -2.0, hi=2.0)
    x[0, 0] = 0.0
    _one_op(op_type, {"X": x}, exact=op_type == "sign")


# -- clips and decay over 3 steps ---------------------------------------------

CASES = {
    "clip_by_value": ("clip", lambda f: f.clip.GradientClipByValue(0.01)),
    "clip_by_norm": ("clip", lambda f: f.clip.GradientClipByNorm(0.05)),
    "clip_by_global_norm": (
        "clip", lambda f: f.clip.GradientClipByGlobalNorm(0.1)),
    "l1_decay": ("reg", lambda f: f.regularizer.L1Decay(0.05)),
    "l2_decay": ("reg", lambda f: f.regularizer.L2Decay(0.05)),
}


def _net(fluid, kind, make):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square(pred - y))
        if kind == "clip":
            fluid.clip.set_gradient_clip(make(fluid))
            opt = fluid.optimizer.SGD(0.5)
        else:
            opt = fluid.optimizer.SGD(0.5, regularization=make(fluid))
        opt.minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(case):
    kind, make = CASES[case]
    jmain, jstart, jloss = _net(jfluid, kind, make)
    tmain, _, tloss = _net(tfluid, kind, make)
    assert tmain.to_json() == jmain.to_json()
    op_types = {op.type for op in tmain.global_block().ops}
    want = {"clip_by_value": "clip", "clip_by_norm": "clip_by_norm",
            "clip_by_global_norm": "elementwise_max",
            "l1_decay": "sign", "l2_decay": "scale"}[case]
    assert want in op_types, op_types
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
    rng = np.random.RandomState(8)
    for _ in range(3):
        feed = {"x": rng.randn(16, 8).astype(np.float32),
                "y": rng.randn(16, 1).astype(np.float32)}
        with jfluid.scope_guard(jscope):
            ref, = jexe.run(jmain, feed=feed, fetch_list=[jloss])
        got, = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        assert abs(float(got) - float(ref)) <= 2e-4 * max(1.0, abs(ref))
    moved = False
    for n in state:
        jw = np.asarray(jscope.find_var(n))
        tw = tscope.get_numpy(n)
        assert np.abs(tw - jw).max() <= 2e-4 * max(1.0, np.abs(jw).max()), n
        moved |= not np.array_equal(jw, state[n])
    assert moved
