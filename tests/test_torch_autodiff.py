"""``calc_gradient`` / ``gradients`` and ``TruncatedNormal`` in the PyTorch
port against the JAX package.

``calc_gradient`` emits the JAX package's ``calc_gradient_marker`` (the
Program JSON is identical) and binds ``X@GRAD`` for each input, feeds
included, as d(sum of the targets)/dX: held at rtol 1e-5 / atol 1e-6
against the JAX package on the same inputs and weights (the same fp32
products summed in another order), and exactly on tests/test_executor.py's
constant-weight case. ``TruncatedNormal`` draws from torch, so it is held
by distribution: over 200,000 draws every value lies within 2 sigma of
the mean, and the standard deviation is that of a standard normal cut at
+-2 (0.8796 sigma) to within 1%.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def _build(fluid, constant=False, two_targets=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [3])
        init = fluid.initializer.Constant(2.0) if constant else \
            fluid.initializer.Uniform(-1.0, 1.0)
        h = fluid.layers.fc(x, 4, act="relu", bias_attr=False,
                            param_attr=fluid.ParamAttr(name="wcg",
                                                       initializer=init))
        y = fluid.layers.fc(h, 1, bias_attr=False)
        targets = [y, fluid.layers.square(h)] if two_targets else y
        grads = fluid.gradients(targets, [x, h]) if two_targets else \
            fluid.calc_gradient(y, [x])
    return main, startup, grads


def _jax_state(startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return scope, {n: np.asarray(scope.find_var(n))
                   for n in scope.local_var_names()
                   if scope.find_var(n) is not None}


def test_constant_weight_case_exact():
    """tests/test_executor.py's test_calc_gradient in the port, through
    a hidden ReLU layer: its 4 units' weights 2 and the output weights 1
    make d(sum y)/dx 4 x 2 = 8 per element."""
    main, startup, grads = _build(tfluid, constant=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    w2 = [n for n in scope.local_var_names() if n != "wcg"][0]
    scope.set(w2, scope.find_var(w2) * 0 + 1)
    gx, = exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                  fetch_list=[grads[0]], scope=scope)
    np.testing.assert_array_equal(gx, np.full((2, 3), 8.0, np.float32))


@pytest.mark.parametrize("two_targets", [False, True],
                         ids=["calc_gradient", "gradients_two_targets"])
def test_matches_jax(two_targets):
    jmain, jstart, jgrads = _build(jfluid, two_targets=two_targets)
    tmain, _, tgrads = _build(tfluid, two_targets=two_targets)
    assert tmain.to_json() == jmain.to_json()
    assert [g.name for g in tgrads] == [g.name for g in jgrads]
    jscope, state = _jax_state(jstart)
    feed = {"x": np.random.RandomState(0).randn(5, 3).astype(np.float32)}
    # the JAX package binds gradients for feeds and state only: an
    # intermediate input (h) has no value before the forward runs
    fetch = [tgrads[0].name]
    with jfluid.scope_guard(jscope):
        ref, = jfluid.Executor(jfluid.CPUPlace()).run(
            jmain, feed=feed, fetch_list=fetch)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=fetch, scope=tscope)
    assert got.shape == (5, 3) and np.abs(got).max() > 0
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_truncated_normal_by_distribution():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        w = tfluid.layers.create_global_var([200_000], 0.0, "float32",
                                            persistable=True, name="tn_w")
    startup.global_block().ops.clear()
    tfluid.initializer.TruncatedNormal(loc=1.0, scale=0.5)(
        w, startup.global_block())
    assert [op.type for op in startup.global_block().ops] == [
        "truncated_gaussian_random"]
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    v = scope.get_numpy("tn_w").astype(np.float64)
    assert v.min() >= 1.0 - 2 * 0.5 and v.max() <= 1.0 + 2 * 0.5
    assert abs(v.mean() - 1.0) < 0.01
    assert abs(v.std() / 0.5 - 0.8796) < 0.01 * 0.8796
    assert tfluid.initializer.TruncatedNormal is \
        tfluid.initializer.TruncatedNormalInitializer
