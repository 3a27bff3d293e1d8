"""The control flow of the PyTorch port against the JAX package
(tests/test_control_flow_rnn.py's ground, on the CPU).

* the Programs of ``tools/op_sweep.control_flow_programs`` (a StaticRNN,
  a DynamicRNN over a LoD input, a counting While followed by a
  ConditionalBlock, an IfElse, the tensor arrays, lod_rank_table ->
  max_sequence_len beside shrink_memory and reorder_lod_tensor_by_rank)
  built by each package's layers: the same Program JSON, and the port's
  fetches equal to the JAX package's at rtol 1e-5 / atol 1e-6, integers
  exactly;
* a StaticRNN over an fc (``recurrent`` differentiated through its
  steps) trained 3 Adam steps from the JAX package's startup values:
  losses and weights within 2e-4 of max(1, max|w|) per tensor;
* Switch (a select chain) and While's ``max_iters`` against the JAX
  package;
* while and conditional_block refuse a CUDA graph capture, and
  run_steps refuses the tensor arrays (host ops).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.tools import op_sweep

TOL = 2e-4


def _run_jax(main, startup, feed, fetch):
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        if startup is not None:
            exe.run(startup)
        return [np.asarray(v) for v in exe.run(main, feed=feed,
                                              fetch_list=fetch)], scope


def _same(got, want, what):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape,
                                                          w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=what)


PROGRAMS = [p[0] for p in op_sweep.control_flow_programs(tfluid)]


@pytest.mark.parametrize("name", PROGRAMS)
def test_control_flow_program_matches_jax(name):
    (jm, js, jfeed, jfetch), = [p[1:] for p in op_sweep.control_flow_programs(
        jfluid) if p[0] == name]
    (tm, ts, tfeed, tfetch), = [p[1:] for p in op_sweep.control_flow_programs(
        tfluid) if p[0] == name]
    assert tm.to_json() == jm.to_json()
    want, _ = _run_jax(jm, js, jfeed, jfetch)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    if ts is not None:
        exe.run(ts, scope=scope)
    _same(exe.run(tm, feed=tfeed, fetch_list=tfetch, scope=scope), want,
          name)


def _static_rnn_classifier(P):
    L = P.layers
    x = L.data("x", [6, 8])                       # [B, T, D]
    label = L.data("label", [1], dtype="int64")
    xt = L.transpose(x, perm=[1, 0, 2])            # [T, B, D]
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(xt)
        h_prev = rnn.memory(shape=[-1, 16], batch_ref=x_t, init_value=0.0)
        h = L.fc(L.concat([x_t, h_prev], axis=1), 16, act="tanh")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    last = L.reshape(L.slice(rnn(), axes=[0], starts=[5], ends=[6]),
                     [-1, 16])
    loss = L.mean(L.cross_entropy(L.fc(last, 2, act="softmax"), label))
    P.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return loss


def test_static_rnn_three_adam_steps_match_jax():
    progs = {}
    for pkg in (jfluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            progs[pkg] = (main, startup, _static_rnn_classifier(pkg))
    (jm, js, jl), (tm, ts, tl) = progs[jfluid], progs[tfluid]
    assert tm.to_json() == jm.to_json()
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    names = [v.name for v in jm.list_vars() if v.persistable]
    state = {n: np.asarray(jscope.find_var(n)) for n in names
             if jscope.find_var(n) is not None}
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(4, 6, 8).astype(np.float32),
            "label": np.array([[0], [1], [0], [1]], np.int64)}
    losses = []
    for _ in range(3):
        with jfluid.scope_guard(jscope):
            want, = jexe.run(jm, feed=feed, fetch_list=[jl])
        got, = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL,
                                   atol=TOL)
        losses.append(float(got))
    for n in state:
        want = np.asarray(jscope.find_var(n))
        np.testing.assert_allclose(
            tscope.get_numpy(n), want, rtol=0,
            atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=n)
    assert losses[-1] < losses[0]


def _switch(P, step_value):
    L = P.layers
    step = L.fill_constant([1], "float32", step_value)
    lr = L.create_global_var(shape=[1], value=0.0, dtype="float32",
                             persistable=True, name="sw_lr")
    sw = L.Switch()
    with sw.case(L.less_than(step, L.fill_constant([1], "float32", 5.0))):
        sw.assign(L.fill_constant([1], "float32", 0.1), lr)
    with sw.case(L.less_than(step, L.fill_constant([1], "float32", 9.0))):
        sw.assign(L.fill_constant([1], "float32", 0.05), lr)
    with sw.default():
        sw.assign(L.fill_constant([1], "float32", 0.01), lr)
    sw.finalize()
    return [lr]


@pytest.mark.parametrize("step", [2.0, 7.0, 11.0])
def test_switch_matches_jax(step):
    out = {}
    for pkg in (jfluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = [v.name for v in _switch(pkg, step)]
        out[pkg] = (main, startup, fetch)
    want, _ = _run_jax(*out[jfluid][:2], {}, out[jfluid][2])
    tm, ts, tf = out[tfluid]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(ts, scope=scope)
    got = exe.run(tm, feed={}, fetch_list=tf, scope=scope)
    _same(got, want, "switch")
    assert float(np.ravel(got[0])[0]) == pytest.approx({2.0: 0.1, 7.0: 0.05,
                                                         11.0: 0.01}[step])


def _capped_while(P):
    L = P.layers
    i = L.fill_constant([1], "int64", 0)
    limit = L.fill_constant([1], "int64", 100)
    acc = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, limit)
    w = L.While(cond, loop_vars=[i, acc], max_iters=6)
    with w.block():
        L.assign(acc + 2.0, acc)
        L.increment(i, value=1.0)
        L.less_than(i, limit, cond=cond)
    return [i, acc, cond]


def test_while_honours_max_iters():
    progs = {}
    for pkg in (jfluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            progs[pkg] = (main, [v.name for v in _capped_while(pkg)])
    want, _ = _run_jax(progs[jfluid][0], None, {}, progs[jfluid][1])
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        progs[tfluid][0], feed={}, fetch_list=progs[tfluid][1],
        scope=tfluid.Scope())
    _same(got, want, "while")
    assert int(np.ravel(got[0])[0]) == 6 and float(np.ravel(got[1])[0]) == 12


@pytest.mark.parametrize("name", ["while_conditional_block"])
def test_host_reading_control_flow_refuses_a_graph_capture(name,
                                                           monkeypatch):
    """while and conditional_block read their condition on the host:
    inside a CUDA graph capture (run_steps on the card) they raise. The
    capture is faked on the CPU."""
    (tm, _, feed, fetch), = [p[1:] for p in op_sweep.control_flow_programs(
        tfluid) if p[0] == name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(NotImplementedError, match="CUDA graph"):
        tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=feed,
                                              fetch_list=fetch,
                                              scope=tfluid.Scope())


def test_run_steps_refuses_the_tensor_arrays():
    (tm, _, feed, fetch), = [p[1:] for p in op_sweep.control_flow_programs(
        tfluid) if p[0] == "tensor_arrays"]
    with pytest.raises(NotImplementedError, match="host"):
        tfluid.Executor(tfluid.CPUPlace()).run_steps(
            tm, feeds=[feed, feed], fetch_list=fetch, scope=tfluid.Scope())


def test_dynamic_rnn_is_capture_safe_on_the_cpu_loop():
    """A DynamicRNN program (recurrent with lengths) runs through
    run_steps: two dispatched steps equal two run() calls."""
    (tm, _, feed, fetch), = [p[1:] for p in op_sweep.control_flow_programs(
        tfluid) if p[0] == "dynamic_rnn"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    want = [exe.run(tm, feed=feed, fetch_list=fetch, scope=tfluid.Scope())
            for _ in range(2)]
    got = exe.run_steps(tm, feeds=[feed, feed], fetch_list=fetch,
                        scope=tfluid.Scope())
    for w, g in zip(want, got):
        assert np.array_equal(w[0], g[0])
