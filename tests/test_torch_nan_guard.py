"""The port's NaN/Inf guards (flag ``check_nan_inf``) against the JAX
package's.

Twins of ``tests/test_enforce.py``'s four guard tests and of
``tests/test_megastep.py::test_nan_guard_names_the_failing_logical_step``:
each builds one net in both packages from one builder, runs it with the
flag through each package's Executor on the same numpy feeds, and holds
the port's error message to the JAX package's, string for string. Then
the port's own contract: a LoD value's bucket pad rows going non-finite
do not trip; a guarded run is bitwise equal to an unguarded one; and a
run reads its guards with one device-to-host copy
(``Executor.stats["guard_reads"]``).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import flags as jflags
from paddle_tpu_torch import flags as tflags


@pytest.fixture
def nan_flag(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CHECK_NAN_INF", "1")


def _programs(pkg, builder, prefix=""):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard(prefix):
        out = builder(pkg)
    return main, startup, out


def _run(pkg, builder, feed, steps=None):
    """The FloatingPointError text of running ``builder``'s net once on
    ``feed`` (or, with ``steps``, ``run_steps`` over that list of
    feeds) in ``pkg``, or None when the run does not raise."""
    main, startup, fetch = _programs(pkg, builder, "ng_")
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(scope):
        exe.run(startup)
        try:
            if steps is None:
                exe.run(main, feed=feed, fetch_list=fetch)
            else:
                exe.run_steps(main, feeds=steps, fetch_list=fetch)
        except FloatingPointError as e:
            return str(e)
    return None


def _same_error(builder, feed=None, steps=None):
    """Both packages raise, with the same message; returns it."""
    want = _run(jfluid, builder, feed, steps)
    got = _run(tfluid, builder, feed, steps)
    assert want is not None
    assert got == want
    return got


def _log_unfetched(pkg):
    x = pkg.layers.data("x", [3])
    pkg.layers.log(x)                    # NaN on a negative input
    return [pkg.layers.scale(x, 2.0)]    # finite; the only fetch


def test_guard_trips_on_unfetched_log(nan_flag):
    """test_nan_guard_catches_internal_nan's twin: the guard names the op
    that produced the NaN though only a finite var is fetched."""
    msg = _same_error(_log_unfetched,
                      feed={"x": -np.ones((2, 3), np.float32)})
    assert msg == ("NaN/Inf detected in output 'ng_ng_log_0.tmp_0' of op "
                   "'log' (PADDLE_TPU_CHECK_NAN_INF)")


def _fc_train(pkg):
    x = pkg.layers.data("x", [3])
    loss = pkg.layers.mean(pkg.layers.fc(x, 2))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss]


def test_guard_passes_finite_train_step(nan_flag):
    """test_nan_guard_passes_finite_program's twin."""
    feed = {"x": np.ones((2, 3), np.float32)}
    assert _run(jfluid, _fc_train, feed) is None
    assert _run(tfluid, _fc_train, feed) is None


def test_flag_zero_means_off(monkeypatch):
    """test_nan_guard_flag_zero_means_off's twin (gflags semantics)."""
    monkeypatch.setenv("PADDLE_TPU_CHECK_NAN_INF", "0")
    assert not tflags.get_flag("check_nan_inf")
    feed = {"x": -np.ones((2, 3), np.float32)}
    assert _run(jfluid, _log_unfetched, feed) is None
    assert _run(tfluid, _log_unfetched, feed) is None


def _log_of_fc_train(pkg):
    x = pkg.layers.data("x", [3])
    y = pkg.layers.fc(x, 2, param_attr=pkg.ParamAttr(
        initializer=pkg.initializer.Constant(1.0)))
    loss = pkg.layers.mean(pkg.layers.log(y))   # y < 0 -> NaN
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss]


def test_forward_op_named_before_optimizer(nan_flag):
    """test_nan_guard_orders_forward_before_optimizer's twin: the index
    runs on past the grad marker, so the forward op is named, not the
    sgd the NaN reaches."""
    msg = _same_error(_log_of_fc_train,
                      feed={"x": -np.ones((4, 3), np.float32) * 10})
    assert "'log'" in msg and "sgd" not in msg


def _mlp(pkg):
    x = pkg.layers.data("x", [8])
    y = pkg.layers.data("y", [1])
    h = pkg.layers.fc(x, 16, act="tanh")
    pred = pkg.layers.fc(h, 1)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss]


def _mlp_feeds(n, batch=8):
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(batch, 8).astype(np.float32),
             "y": rng.rand(batch, 1).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("k,bad", [(3, 1), (5, 3)])
def test_run_steps_names_the_failing_logical_step(k, bad):
    """test_megastep.py::test_nan_guard_names_the_failing_logical_step's
    twin (flag set through both packages' set_flag, as there), at its
    K=3 and at the card's K=5 with the NaN in step 3."""
    feeds = _mlp_feeds(k)
    x = feeds[bad]["x"].copy()
    x[0, 0] = np.nan
    feeds[bad] = dict(feeds[bad], x=x)
    jflags.set_flag("check_nan_inf", True)
    tflags.set_flag("check_nan_inf", True)
    try:
        msg = _same_error(_mlp, steps=feeds)
    finally:
        jflags.set_flag("check_nan_inf", None)
        tflags.set_flag("check_nan_inf", None)
    assert msg.endswith("(at megastep logical step %d of %d; state has "
                        "advanced the full megastep)" % (bad, k))
    assert "of op 'mul'" in msg


def _lod_log(pkg):
    x = pkg.layers.data("x", [1], lod_level=1)
    y = pkg.layers.log(x)        # the zero pad rows give -inf
    return [pkg.layers.sequence_pool(y, "max"), y]


def _lod_feed(pkg, rows):
    return {"x": pkg.create_lod_tensor(
        np.asarray(rows, np.float32).reshape(-1, 1), [[2, 3]],
        pkg.CPUPlace())}


def test_lod_pad_rows_do_not_trip(nan_flag):
    """5 real rows bucket to 8: log of the 3 zero pad rows is -inf, and
    neither package trips; a zero in a real row trips both, alike."""
    rows = [1.0, 2.0, 3.0, 4.0, 5.0]
    assert _run(jfluid, _lod_log, _lod_feed(jfluid, rows)) is None
    assert _run(tfluid, _lod_log, _lod_feed(tfluid, rows)) is None
    rows[3] = 0.0
    want = _run(jfluid, _lod_log, _lod_feed(jfluid, rows))
    got = _run(tfluid, _lod_log, _lod_feed(tfluid, rows))
    assert want is not None and got == want and "'log'" in got


def _train_states(check, k=None):
    """(losses, persistables, guard reads) of the startup run and 4
    steps of the mlp on the port, run() by run() or in run_steps
    dispatches of ``k``, the flag at ``check``."""
    tflags.set_flag("check_nan_inf", check)
    try:
        main, startup, (loss,) = _programs(tfluid, _mlp, "bw_")
        main.random_seed = startup.random_seed = 3
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        feeds = _mlp_feeds(4)
        if k is None:
            losses = [exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0] for f in feeds]
        else:
            losses = [o[0] for i in range(0, 4, k)
                      for o in exe.run_steps(main, feeds=feeds[i:i + k],
                                             fetch_list=[loss],
                                             scope=scope)]
        state = {n: scope.get_numpy(n) for n in scope.local_var_names()}
        return losses, state, exe.stats["guard_reads"]
    finally:
        tflags.set_flag("check_nan_inf", None)


@pytest.mark.parametrize("k", [None, 2], ids=["run", "run_steps"])
def test_guarded_run_is_bitwise_unguarded(k):
    """Guards only read values: with the flag on, every loss and every
    persistable after 4 steps is bitwise the unguarded run's."""
    off_losses, off_state, off_reads = _train_states(False, k)
    on_losses, on_state, _ = _train_states(True, k)
    assert off_reads == 0
    np.testing.assert_array_equal(np.asarray(on_losses),
                                  np.asarray(off_losses))
    assert sorted(on_state) == sorted(off_state)
    for n in off_state:
        np.testing.assert_array_equal(on_state[n], off_state[n], err_msg=n)


def test_one_guard_read_per_run_and_dispatch():
    """The step's guards (some dozen here, one a float output of each
    op) are stacked on the device and read with ONE device-to-host copy
    a run() and one a run_steps dispatch, never one an op."""
    _, _, reads = _train_states(True)
    assert reads == 1 + 4        # the startup run and 4 train runs
    _, _, reads = _train_states(True, k=2)
    assert reads == 1 + 2        # the startup run and 2 dispatches


def test_first_failing_guard_in_program_order_across_dtypes():
    """Guards reduce each output to its (min, max) and are grouped by
    dtype on the device; the failure named is still the first in program
    order, and an empty output or an inf alone trips nothing or trips
    as it should."""
    import torch
    from paddle_tpu_torch.core import executor as E

    class Op:
        def __init__(self, type, out):
            self.type, self.output_names = type, [out]

    g = E._Guards()
    env = {"a": torch.ones(3), "b": torch.tensor([1.0, float("inf")],
                                                 dtype=torch.bfloat16),
           "c": torch.tensor([float("nan")]), "d": torch.zeros(0),
           "e": torch.tensor([1, 2])}
    for name, t in (("a", "relu"), ("b", "cast"), ("c", "log"),
                    ("d", "slice"), ("e", "shape")):
        g.record(Op(t, name), env)
    g.record_fetch("a", env["a"], None)
    names, ok = g.stacked(torch.device("cpu"))
    # the f32 group (a, c, the fetch), then the bf16 one (b)
    assert [n[0] for n in names] == [0, 2, 3, 1]
    assert ok.tolist() == [True, False, True, False]
    with pytest.raises(FloatingPointError, match="'b' of op 'cast'"):
        E._raise_first_nan(names, ok.numpy()[None])
    with pytest.raises(FloatingPointError, match="fetched var 'a'"):
        E._raise_first_nan(names, np.array([[True, True, False, True]]))
    E._raise_first_nan(names, np.ones((2, 4), bool), steps=2)


def _recompute_net(how):
    """A builder: log(fc(x)) under a ``layers.recompute()`` region
    trained by SGD (``how="region"``), or its plain forward differentiated
    by ``append_backward(checkpoint=True)`` (``how="checkpoint"``). A
    negative input makes the log NaN."""
    def build(pkg):
        x = pkg.layers.data("x", [3])
        def attr():
            return pkg.ParamAttr(initializer=pkg.initializer.Constant(0.5))
        if how == "region":
            with pkg.layers.recompute():
                h = pkg.layers.fc(x, 4, act="tanh", param_attr=attr())
                y = pkg.layers.log(pkg.layers.fc(h, 2, param_attr=attr()))
            loss = pkg.layers.mean(y)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            return [loss]
        h = pkg.layers.fc(x, 4, act="tanh", param_attr=attr())
        loss = pkg.layers.mean(pkg.layers.log(pkg.layers.fc(h, 2,
                                                             param_attr=attr())))
        grads = pkg.append_backward(loss, checkpoint=True)
        return [loss] + [g for _, g in grads]
    return build


@pytest.mark.parametrize("how", ["region", "checkpoint"])
def test_guards_under_recompute(how):
    """Guards under a recompute region and under append_backward's
    checkpointed forward: a NaN trips with the JAX package's message, and
    a finite run is bitwise the unguarded one, gradients included (the
    guards save nothing for the backward, so the recomputed forward
    saves what the first one saved)."""
    build = _recompute_net(how)
    tflags.set_flag("check_nan_inf", True)
    jflags.set_flag("check_nan_inf", True)
    try:
        msg = _same_error(build, feed={"x": -np.ones((4, 3), np.float32)})
    finally:
        tflags.set_flag("check_nan_inf", None)
        jflags.set_flag("check_nan_inf", None)
    assert "of op 'log'" in msg

    feeds = [{"x": f["x"][:, :3] + 1.0} for f in _mlp_feeds(3)]

    def fetched(check):
        tflags.set_flag("check_nan_inf", check)
        try:
            main, startup, fetch = _programs(tfluid, build, "rc_")
            scope = tfluid.Scope()
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=scope)
            outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                    for f in feeds]
            return outs, exe.stats["guard_reads"]
        finally:
            tflags.set_flag("check_nan_inf", None)

    off, off_reads = fetched(False)
    on, on_reads = fetched(True)
    assert off_reads == 0 and on_reads == 1 + len(feeds)
    for a, b in zip(on, off):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
