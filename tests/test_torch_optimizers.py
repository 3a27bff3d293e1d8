"""The optimizer family in the PyTorch port against the JAX package.

Each of the nine update rules the port added (adagrad, adamax,
decayed_adagrad, adadelta, rmsprop, ftrl, proximal_gd, proximal_adagrad,
average_accumulates) runs as a one-op Program through both Executors on
the same numpy inputs, mirroring tests/test_ops_sweep2.py; every output
is held at rtol 1e-5 / atol 1e-6 (the same fp32 terms; ftrl's powers and
divisions at rtol 1e-4, as the sweep holds it). Then each optimizer class
trains a small fc net 3 steps from the JAX startup scope copied in with
``load_numpy_state``: losses and weights at 2e-4 of max(1, max|w|) per
tensor, the reference's multi-step bound (``__graft_entry__.py:154``).
``ModelAverage`` averages over its window as the JAX package's does, and
``restore`` puts back the very tensors ``apply`` replaced. Everything runs
on the CPU; ``chip_smoke.py`` runs each rule on the card against this CPU
path.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def _r(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


def _program(fluid, op_type, inputs, outputs, attrs):
    prog = fluid.Program()
    blk = prog.global_block()
    for slot, arr in inputs.items():
        blk.create_var(name=slot.lower(), shape=arr.shape,
                       dtype=str(arr.dtype))
    for slot in outputs:
        blk.create_var(name="out_" + slot.lower(), dtype="float32")
    blk.append_op(type=op_type,
                  inputs={slot: [slot.lower()] for slot in inputs},
                  outputs={slot: ["out_" + slot.lower()] for slot in outputs},
                  attrs=attrs)
    return prog


def _one_op(op_type, inputs, outputs, attrs, rtol=1e-5):
    feed = {slot.lower(): a for slot, a in inputs.items()}
    fetch = ["out_" + slot.lower() for slot in outputs]
    with jfluid.scope_guard(jfluid.Scope()):
        ref = jfluid.Executor(jfluid.CPUPlace()).run(
            _program(jfluid, op_type, inputs, outputs, attrs), feed=feed,
            fetch_list=fetch)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        _program(tfluid, op_type, inputs, outputs, attrs), feed=feed,
        fetch_list=fetch, scope=tfluid.Scope())
    for name, a, b in zip(fetch, got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6, err_msg=name)


P, G, LR = _r(1, 3, 4), _r(2, 3, 4), np.array([0.1], np.float32)

OPS = {
    "adagrad": ({"Param": P, "Grad": G, "Moment": _r(3, 3, 4, lo=0),
                 "LearningRate": LR}, ["ParamOut", "MomentOut"],
                {"epsilon": 1e-6}),
    "adamax": ({"Param": P, "Grad": G, "Moment": _r(4, 3, 4),
                "InfNorm": _r(5, 3, 4, lo=0.1), "LearningRate": LR,
                "Beta1Pow": np.array([0.81], np.float32)},
               ["ParamOut", "MomentOut", "InfNormOut", "Beta1PowOut"],
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                "update_beta_pow": True}),
    "decayed_adagrad": ({"Param": P, "Grad": G,
                         "Moment": _r(6, 3, 4, lo=0), "LearningRate": LR},
                        ["ParamOut", "MomentOut"],
                        {"decay": 0.95, "epsilon": 1e-6}),
    "adadelta": ({"Param": P, "Grad": G,
                  "AvgSquaredGrad": _r(7, 3, 4, lo=0),
                  "AvgSquaredUpdate": _r(8, 3, 4, lo=0)},
                 ["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"],
                 {"rho": 0.95, "epsilon": 1e-6}),
    "rmsprop": ({"Param": P, "Grad": G, "MeanSquare": _r(9, 3, 4, lo=0.1),
                 "Moment": _r(10, 3, 4), "LearningRate": LR},
                ["ParamOut", "MeanSquareOut", "MomentOut"],
                {"decay": 0.9, "epsilon": 1e-10, "momentum": 0.5}),
    "ftrl": ({"Param": P, "Grad": G,
              "SquaredAccumulator": _r(11, 3, 4, lo=0.1),
              "LinearAccumulator": _r(12, 3, 4), "LearningRate": LR},
             ["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
             {"l1": 0.1, "l2": 0.2, "lr_power": -0.5}),
    "proximal_gd": ({"Param": P, "Grad": G, "LearningRate": LR},
                    ["ParamOut"], {"l1": 0.05, "l2": 0.1}),
    "proximal_adagrad": ({"Param": P, "Grad": G,
                          "Moment": _r(13, 3, 4, lo=0.1),
                          "LearningRate": LR}, ["ParamOut", "MomentOut"],
                         {"l1": 0.05, "l2": 0.1}),
}


@pytest.mark.parametrize("op_type", sorted(OPS))
def test_update_rule_matches_jax(op_type):
    inputs, outputs, attrs = OPS[op_type]
    _one_op(op_type, inputs, outputs, attrs,
            rtol=1e-4 if op_type == "ftrl" else 1e-5)


@pytest.mark.parametrize("num_acc, window", [(1, 100), (3, 4)],
                         ids=["accumulate", "roll_over"])
def test_average_accumulates_matches_jax(num_acc, window):
    """Below the window the param accumulates into sum_1; at it, sum_1 +
    sum_2 fold into sum_3 and the counts restart."""
    inputs = {"param": _r(14, 3, 4), "in_sum_1": _r(15, 3, 4),
              "in_sum_2": _r(16, 3, 4), "in_sum_3": _r(17, 3, 4),
              "in_num_accumulates": np.array([num_acc], np.int64),
              "in_old_num_accumulates": np.array([2], np.int64),
              "in_num_updates": np.array([5], np.int64)}
    _one_op("average_accumulates", inputs,
            ["out_sum_1", "out_sum_2", "out_sum_3", "out_num_accumulates",
             "out_old_num_accumulates", "out_num_updates"],
            {"average_window": 0.5, "max_average_window": window,
             "min_average_window": window})


# -- 3 steps of each optimizer class -----------------------------------------

CLASSES = {
    "Adagrad": lambda o: o.Adagrad(0.1),
    "Adamax": lambda o: o.Adamax(0.01),
    "DecayedAdagrad": lambda o: o.DecayedAdagrad(0.05),
    "Adadelta": lambda o: o.Adadelta(1.0),
    "RMSProp": lambda o: o.RMSProp(0.01, momentum=0.5),
    "Ftrl": lambda o: o.Ftrl(0.1, l1=0.01, l2=0.01),
}


def _net(fluid, make_opt, average=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square(pred - y))
        make_opt(fluid.optimizer).minimize(loss)
        avg = fluid.optimizer.ModelAverage(
            0.5, min_average_window=2, max_average_window=3) \
            if average else None
    return main, startup, loss, avg


def _batches(n):
    rng = np.random.RandomState(7)
    return [{"x": rng.randn(16, 8).astype(np.float32),
             "y": rng.randn(16, 1).astype(np.float32)} for _ in range(n)]


def _train_both(make_opt, steps, average=False):
    jmain, jstart, jloss, javg = _net(jfluid, make_opt, average)
    tmain, tstart, tloss, tavg = _net(tfluid, make_opt, average)
    assert tmain.to_json() == jmain.to_json()
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
    for feed in _batches(steps):
        with jfluid.scope_guard(jscope):
            ref, = jexe.run(jmain, feed=feed, fetch_list=[jloss])
        got, = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        assert abs(float(got) - float(ref)) <= 2e-4 * max(1.0, abs(ref))
    return state, jscope, tscope, javg, tavg, jexe, texe


def _assert_close(state, jscope, tscope):
    for n in state:
        jw = np.asarray(jscope.find_var(n)).astype(np.float64)
        tw = tscope.get_numpy(n).astype(np.float64)
        assert np.abs(tw - jw).max() <= 2e-4 * max(1.0, np.abs(jw).max()), n


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_three_steps_match_jax(name):
    state, jscope, tscope, *_ = _train_both(CLASSES[name], 3)
    _assert_close(state, jscope, tscope)


def test_model_average_apply_restore_matches_jax():
    state, jscope, tscope, javg, tavg, jexe, texe = _train_both(
        lambda o: o.SGD(0.1), 5, average=True)
    _assert_close(state, jscope, tscope)
    params = [p.name for p, _ in tavg.params_grads]
    assert params == [p.name for p, _ in javg.params_grads]
    before = {n: tscope.find_var(n) for n in params}
    with jfluid.scope_guard(jscope):
        javg.apply(jexe)
    tavg.apply(texe, scope=tscope)
    assert set(tavg._backup) == set(params)
    _assert_close(params, jscope, tscope)
    assert not any(np.array_equal(tscope.get_numpy(n),
                                  before[n].numpy()) for n in params)
    tavg.restore(texe)
    with jfluid.scope_guard(jscope):
        javg.restore(jexe)
    for n in params:
        assert tscope.find_var(n) is before[n]
    _assert_close(params, jscope, tscope)
