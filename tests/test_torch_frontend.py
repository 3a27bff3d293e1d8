"""The rest of the port's front end against the JAX package: ``debugger``,
``concurrency``, ``average`` and ``transpiler``.

Twins of ``tests/test_debug_concurrency.py`` (without its profiler test,
which ``tests/test_torch_profiler.py`` twins, and its
``init_parallel_env`` test, which waits for the parallel tier), of
``tests/test_evaluator_average.py::test_weighted_average`` and of
``tests/test_io_and_m2.py::test_inference_transpiler_fuses_conv_bn``
(the port's fused output held against the JAX package's at rtol 1e-4,
atol 1e-5), and ``memory_optimize``/``release_memory`` returning their
program unchanged.
"""

import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import debugger as jdebugger
from paddle_tpu_torch import concurrency as csp
from paddle_tpu_torch import debugger


def _fc_train(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4])
        y = pkg.layers.fc(x, 2, act="relu")
        loss = pkg.layers.mean(y)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_graphviz_dump_and_pprint(tmp_path):
    prog, _, _ = _fc_train(tfluid)
    dot = debugger.draw_program(prog, path=str(tmp_path / "g.dot"))
    assert dot.startswith("digraph G {") and dot.rstrip().endswith("}")
    assert "mul" in dot and "relu" in dot
    assert '"x"' in dot or "x\\n" in dot
    assert (tmp_path / "g.dot").read_text() == dot
    # parameters shaded differently from activations
    assert "#b3d9ff" in dot

    code = debugger.pprint_program_codes(prog)
    assert "// block 0" in code
    assert "mul(" in code and "sgd(" in code
    # the same program built by the JAX package dumps the same text
    jprog, _, _ = _fc_train(jfluid)
    assert jdebugger.draw_program(jprog) == dot
    assert jdebugger.pprint_program_codes(jprog) == code


def test_channel_buffered_send_recv_close():
    ch = csp.make_channel(capacity=2)
    assert csp.channel_send(ch, 1)
    assert csp.channel_send(ch, 2)
    v, ok = csp.channel_recv(ch)
    assert (v, ok) == (1, True)
    csp.channel_close(ch)
    v, ok = csp.channel_recv(ch)
    assert (v, ok) == (2, True)     # drain after close
    v, ok = csp.channel_recv(ch)
    assert ok is False
    assert csp.channel_send(ch, 3) is False   # send on closed fails


def test_channel_unbuffered_rendezvous():
    ch = csp.make_channel(capacity=0)
    got = []

    def consumer():
        for v in ch:
            got.append(v)

    t = csp.go(consumer)
    for i in range(5):
        ch.send(i)
    ch.close()
    t.join(timeout=5)
    assert got == [0, 1, 2, 3, 4]


def test_csp_fibonacci_whole_program():
    # channel_test.cc / concurrency_test.cc: producer goroutine feeding a
    # rendezvous channel; quit channel stops it
    c = csp.make_channel(capacity=0)
    quit_ch = csp.make_channel(capacity=0)

    def fib():
        x, y = 0, 1
        while True:
            sent = csp.select([
                csp.case_send(c, x, action=lambda: "sent"),
                csp.case_recv(quit_ch, action=lambda v, ok: "quit"),
            ])
            if sent == "quit":
                return
            x, y = y, x + y

    csp.go(fib)
    out = [c.recv()[0] for _ in range(10)]
    quit_ch.send(None)
    assert out == [0, 1, 1, 2, 3, 5, 8, 13, 21, 34]


def test_select_first_ready():
    a = csp.make_channel(capacity=1)
    b = csp.make_channel(capacity=1)
    b.send("from-b")
    res = csp.select([
        csp.case_recv(a, action=lambda v, ok: ("a", v)),
        csp.case_recv(b, action=lambda v, ok: ("b", v)),
    ], timeout=5)
    assert res == ("b", "from-b")


def test_go_pipeline_feeds_executor():
    """A reader goroutine pumping batches through a channel into the
    port's Executor: the losses are the JAX package's on the same
    batches, from the same startup values (rtol 1e-5)."""
    progs = {}
    for pkg in (jfluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", [4])
            loss = pkg.layers.mean(pkg.layers.fc(x, 1))
        progs[pkg] = (main, startup, loss)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(progs[jfluid][1])
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, {n: np.asarray(jscope.find_var(n))
                                     for n in jscope.local_var_names()},
                            "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    main, _, loss = progs[tfluid]

    ch = csp.make_channel(capacity=4)
    batches = []

    def producer():
        rng = np.random.RandomState(0)
        for _ in range(6):
            b = rng.rand(8, 4).astype(np.float32)
            batches.append(b)
            ch.send(b)
        ch.close()

    csp.go(producer)
    losses = [float(exe.run(main, feed={"x": batch}, fetch_list=[loss],
                            scope=tscope)[0]) for batch in ch]
    assert len(losses) == 6 and all(np.isfinite(v) for v in losses)
    with jfluid.scope_guard(jscope):
        want = [float(jexe.run(progs[jfluid][0], feed={"x": b},
                               fetch_list=[progs[jfluid][2]])[0])
                for b in batches]
    np.testing.assert_allclose(losses, want, rtol=1e-5)


def test_select_does_not_consume_from_losing_cases():
    a = csp.make_channel(capacity=1)
    b = csp.make_channel(capacity=1)
    n0 = threading.active_count()
    a.send("a1")
    r1 = csp.select([
        csp.case_recv(a, action=lambda v, ok: v),
        csp.case_recv(b, action=lambda v, ok: v),
    ], timeout=5)
    assert r1 == "a1"
    # a value sent to b AFTER round 1 must reach round 2 intact (no ghost
    # thread from round 1 may steal it) and no threads may linger
    b.send("b1")
    r2 = csp.select([
        csp.case_recv(a, action=lambda v, ok: v),
        csp.case_recv(b, action=lambda v, ok: v),
    ], timeout=5)
    assert r2 == "b1"
    assert threading.active_count() == n0


def test_select_send_on_closed_channel_raises():
    ch = csp.make_channel(capacity=1)
    ch.close()
    with pytest.raises(csp.ChannelClosed):
        csp.select([csp.case_send(ch, 1, action=lambda: "sent")],
                   timeout=1)


def test_unbuffered_send_rendezvous_blocks_without_receiver():
    ch = csp.make_channel(capacity=0)
    state = {"returned": False}

    def sender():
        ch.send("x")
        state["returned"] = True

    csp.go(sender)
    time.sleep(0.2)
    assert not state["returned"]    # no receiver yet -> send still parked
    v, ok = ch.recv()
    assert (v, ok) == ("x", True)
    time.sleep(0.2)
    assert state["returned"]


def test_weighted_average():
    for pkg in (jfluid, tfluid):
        wa = pkg.average.WeightedAverage()
        wa.add(2.0, 1)
        wa.add(4.0, 3)
        assert abs(wa.eval() - 3.5) < 1e-9
        wa.add(np.array([1.0]), 2)
        assert abs(float(wa.eval()[0]) - 16.0 / 6) < 1e-9
        wa.reset()
        with pytest.raises(ValueError):
            wa.eval()
        with pytest.raises(ValueError):
            wa.add("nope", 1)


def _conv_bn(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data("img", [3, 8, 8])
        conv = pkg.layers.conv2d(img, num_filters=4, filter_size=3,
                                 padding=1, bias_attr=False)
        bn = pkg.layers.batch_norm(conv, act=None)
    return main, startup, bn


def test_inference_transpiler_fuses_conv_bn():
    """The JAX package's startup values and BN statistics go into both
    scopes; after InferenceTranspiler no batch_norm is left in either
    program, the two rewritten programs serialize alike, and the port's
    fused output is the JAX package's (and its own unfused one) at rtol
    1e-4, atol 1e-5."""
    rng = np.random.RandomState(3)
    d = rng.rand(2, 3, 8, 8).astype(np.float32)
    jmain, jstart, jbn = _conv_bn(jfluid)
    tmain, tstart, tbn = _conv_bn(tfluid)
    bn_op = [op for op in jmain.global_block().ops
             if op.type == "batch_norm"][0]
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    jscope.set(bn_op.input("Mean")[0], rng.rand(4).astype(np.float32))
    jscope.set(bn_op.input("Variance")[0],
               (0.5 + rng.rand(4)).astype(np.float32))
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, {n: np.asarray(jscope.find_var(n))
                                     for n in jscope.local_var_names()},
                            "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())

    jinfer = jmain.prune([jbn]).clone(for_test=True)
    tinfer = tmain.prune([tbn]).clone(for_test=True)
    assert tinfer.to_json() == jinfer.to_json()
    tplain, = texe.run(tinfer, feed={"img": d}, fetch_list=[tbn.name],
                       scope=tscope)

    jfluid.InferenceTranspiler().transpile(jinfer, scope=jscope)
    out = tfluid.InferenceTranspiler().transpile(
        tinfer, tfluid.CPUPlace(), scope=tscope)
    assert out is tinfer
    for prog in (jinfer, tinfer):
        assert "batch_norm" not in [op.type for op in
                                    prog.global_block().ops]
    assert tinfer.to_json() == jinfer.to_json()
    filt = [op for op in tinfer.global_block().ops
            if op.type == "conv2d"][0].input("Filter")[0]
    assert tscope.find_var(filt).device.type == "cpu"
    with jfluid.scope_guard(jscope):
        want, = jexe.run(jinfer, feed={"img": d}, fetch_list=[jbn.name])
    got, = texe.run(tinfer, feed={"img": d}, fetch_list=[tbn.name],
                    scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, tplain, rtol=1e-4, atol=1e-5)


def test_memory_optimize_and_release_memory_return_their_program():
    main, _, _ = _fc_train(tfluid)
    before = main.to_json()
    assert tfluid.memory_optimize(main) is main
    assert tfluid.release_memory(main, skip_opt_set={"x"}) is main
    assert main.to_json() == before
    jmain, _, _ = _fc_train(jfluid)
    assert jfluid.memory_optimize(jmain).to_json() == before
