"""The ``debug_nans`` flag and the ParallelExecutor's monitor hooks in
the port.

``debug_nans`` is the JAX package's ``jax_debug_nans`` switch: with it
on, the first op whose forward or backward makes a NaN raises
``FloatingPointError``. The same programs, built by each package, must
raise in both; a clean program runs bitwise equal with the flag on and
off, and ``run_steps`` with the flag on is K plain runs. The
``ParallelExecutor`` at one rank writes ``pexe`` recorder rows and
``pexe.step`` spans, as the JAX package's does.
"""

import importlib

import numpy as np
import pytest
import torch


def _program(pkg, kind):
    """A small fc net whose ``kind`` part makes a NaN: 'fwd' (log of a
    negative activation), 'bwd' (sqrt(relu(h) * 0): a finite forward
    whose backward is 0 * inf) or 'clean' (tanh)."""
    fluid = importlib.import_module(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        h = fluid.layers.fc(x, 4)
        if kind == "fwd":
            y = fluid.layers.log(h)
        elif kind == "bwd":
            y = fluid.layers.sqrt(fluid.layers.relu(h) * 0.0)
        else:
            y = fluid.layers.tanh(h)
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return fluid, main, startup, loss


def _feed():
    return {"x": np.random.RandomState(0).randn(3, 4).astype(np.float32)}


def _run(pkg, kind, on):
    fluid, main, startup, loss = _program(pkg, kind)
    flags = importlib.import_module(pkg + ".flags")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    flags.set_flag("debug_nans", on)
    try:
        return exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    finally:
        flags.set_flag("debug_nans", False)


@pytest.mark.parametrize("kind,op", [("fwd", "'log'"), ("bwd", "'scale'")])
def test_the_same_ops_raise_as_in_the_jax_package(kind, op):
    """A NaN made in the forward (log) or only in the backward (0 * inf
    in the gradient of sqrt(relu(h) * 0)) raises FloatingPointError in
    both packages (the JAX package's forward error comes wrapped in its
    op's EnforceError); the port names the op that made it."""
    from paddle_tpu.core.enforce import EnforceError
    with pytest.raises((FloatingPointError, EnforceError),
                       match="invalid value \\(nan\\)"):
        _run("paddle_tpu", kind, True)
    with pytest.raises(FloatingPointError, match=op):
        _run("paddle_tpu_torch", kind, True)
    # with the flag off neither raises
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        out, = _run(pkg, kind, False)
        assert not np.isfinite(np.asarray(out)).all() or kind == "bwd"


def test_clean_program_bitwise_with_the_flag_on_and_off():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off, = _run("paddle_tpu_torch", "clean", False)
        on, = _run("paddle_tpu_torch", "clean", True)
    finally:
        torch.set_num_threads(threads)
    assert np.array_equal(np.asarray(on), np.asarray(off))


def test_run_steps_with_the_flag_is_k_plain_runs():
    """Under the flag ``run_steps`` runs K plain ``run`` calls: the same
    losses as K runs, the graph machinery untouched, and a NaN in step
    2 raises there."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    feeds = [{"x": np.random.RandomState(i).randn(3, 4).astype(np.float32)}
             for i in range(3)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = []
        for steps in (True, False):
            _, main, startup, loss = _program("paddle_tpu_torch", "clean")
            exe = fluid.Executor(fluid.CPUPlace())
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            flags.set_flag("debug_nans", steps)
            try:
                if steps:
                    out = exe.run_steps(main, feeds=feeds,
                                        fetch_list=[loss], scope=scope)
                    assert exe.stats["graph_captures"] == 0
                else:
                    out = [exe.run(main, feed=f, fetch_list=[loss],
                                   scope=scope) for f in feeds]
            finally:
                flags.set_flag("debug_nans", False)
            res.append([float(np.asarray(o[0])) for o in out])
    finally:
        torch.set_num_threads(threads)
    assert res[0] == res[1]
    _, main, startup, loss = _program("paddle_tpu_torch", "fwd")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    flags.set_flag("debug_nans", True)
    try:
        with pytest.raises(FloatingPointError, match="'log'"):
            exe.run_steps(main, feeds=feeds, fetch_list=[loss], scope=scope)
    finally:
        flags.set_flag("debug_nans", False)


def test_flag_registered_in_both_packages():
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags
    assert flags.get_flag("debug_nans") is False
    assert jflags._FLAGS["debug_nans"].env == flags._FLAGS["debug_nans"].env


def test_parallel_executor_rows_and_spans(tmp_path):
    """At one rank the ParallelExecutor's steps are ``pexe.step`` root
    spans, its first step a ``compile`` row with ``executor: pexe`` and
    every step a ``step`` row with it."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import monitor, parallel
    from paddle_tpu_torch.trace import runtime as trt
    _, main, startup, loss = _program("paddle_tpu_torch", "clean")
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    pexe = fluid.ParallelExecutor(
        loss_name=loss.name, main_program=main, scope=scope,
        mesh=parallel.make_mesh({"dp": 1}, "cpu"))
    log = str(tmp_path / "mon.jsonl")
    spans = str(tmp_path / "spans.jsonl")
    trt.enable(log_path=spans, sample_rate=1.0, proc="pexe")
    try:
        with monitor.session(log_path=log):
            for _ in range(3):
                pexe.run([loss], feed=_feed())
    finally:
        trt.disable()
    rows = [r for r in monitor.read_jsonl(log)
            if r.get("executor") == "pexe"]
    assert [r["ev"] for r in rows] == ["compile", "step", "step", "step"]
    names = [s["name"] for s in monitor.read_jsonl(spans)
             if s["ev"] == "span" and s.get("parent") is None]
    assert names == ["pexe.step"] * 3
