"""The port's profiler (``paddle_tpu_torch/profiler.py``) against the JAX
package's.

Twins of ``tests/test_io_and_m2.py::test_profiler_summary`` and
``::test_profiler_memory_column``,
``tests/test_debug_concurrency.py::test_chrome_trace_export`` and the
``_TRACE_CAP`` test of ``tests/test_monitor.py``; then the executor's
hooks: an ``op:<type>`` row for every op of a small train step, the same
set of rows as the JAX package's eager (op by op) path shows for a
forward program, one event a ``run_steps`` dispatch, nothing recorded
with the profiler off, and the device trace's per-op ranges.
"""

import json
import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import profiler as jprof
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import profiler as tprof


@pytest.fixture(autouse=True)
def _clean():
    tprof.reset_profiler()
    jprof.reset_profiler()
    yield
    tprof._enabled = False
    tprof.reset_profiler()
    jprof.reset_profiler()


def _rows(text):
    """The event names of a printed summary table."""
    return [ln.split()[0] for ln in text.strip().splitlines()[1:]]


def test_profiler_summary(capsys, tmp_path):
    """test_profiler_summary's twin: the same table head and rows."""
    tables = []
    for pkg in (jfluid, tfluid):
        with pkg.profiler.profiler("CPU", "total",
                                   str(tmp_path / pkg.__name__)):
            with pkg.profiler.RecordEvent("stepA"):
                pass
        tables.append(capsys.readouterr().out)
    jt, tt = tables
    assert "stepA" in tt
    assert tt.splitlines()[0] == jt.splitlines()[0]
    assert _rows(tt) == _rows(jt) == ["stepA"]
    assert (tmp_path / "paddle_tpu_torch.txt").read_text().strip() \
        == tt.strip()


def _fc_mean(pkg):
    x = pkg.layers.data("x", [64])
    h = pkg.layers.fc(x, 128)
    return pkg.layers.mean(h)


def test_profiler_memory_column(capsys, tmp_path):
    """test_profiler_memory_column's twin: with profile_memory the table
    grows the Live/PeakHBM columns, and the compiled step's row records
    a nonzero peak (on the CPU: the bytes the scope's tensors hold)."""
    main, startup = tfluid.Program(), tfluid.Program()
    scope = tfluid.Scope()
    tflags.set_flag("profile_memory", True)
    try:
        with tfluid.program_guard(main, startup), \
                tfluid.scope_guard(scope):
            loss = _fc_mean(tfluid)
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            with tfluid.profiler.profiler("CPU", "total",
                                          str(tmp_path / "mem")):
                exe.run(main, feed={"x": np.ones((8, 64), np.float32)},
                        fetch_list=[loss])
    finally:
        tflags.set_flag("profile_memory", None)
    outp = capsys.readouterr().out
    assert "PeakHBM(MB)" in outp and "Live(MB)" in outp
    row = [ln for ln in outp.splitlines()
           if ln.startswith("exe.run(compiled)")][0]
    assert float(row.split()[-1]) > 0
    # fc's weight [64, 128] and bias [128] in float32 at least
    assert tprof.device_memory("cpu")[1] >= (64 * 128 + 128) * 4


def test_chrome_trace_export(tmp_path):
    """test_chrome_trace_export's twin, with the JAX package's file
    alongside: the same events, metadata and lane names."""
    datas = []
    for prof in (jprof, tprof):
        prof.reset_profiler()
        prof.start_profiler()
        with prof.RecordEvent("step"):
            with prof.RecordEvent("inner"):
                pass
        prof.stop_profiler(profile_path=str(tmp_path / "p"))
        path = tmp_path / ("trace_%s.json" % prof.__name__)
        n = prof.export_chrome_trace(str(path))
        data = json.loads(path.read_text())
        assert n == len(data["traceEvents"])
        datas.append(data)
    jd, td = datas
    spans = [e for e in td["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"step", "inner"}
    assert all("dur" in e for e in spans)
    metas = {e["name"]: e for e in td["traceEvents"] if e["ph"] == "M"}
    assert metas["process_name"]["args"]["name"] == "paddle_tpu host"
    assert metas["thread_name"]["args"]["name"] \
        == threading.current_thread().name
    assert sorted((e["name"], e["ph"]) for e in td["traceEvents"]) \
        == sorted((e["name"], e["ph"]) for e in jd["traceEvents"])


def test_trace_truncated_marker_past_cap(tmp_path, monkeypatch):
    """The _TRACE_CAP test's twin: 9 events past a cap of 5 leave one
    in-band marker naming the 4 dropped, as the JAX package's does, and
    summary() says the trace is truncated."""
    marks = []
    for prof in (jprof, tprof):
        prof.reset_profiler()
        monkeypatch.setattr(prof, "_TRACE_CAP", 5)
        prof.start_profiler()
        for i in range(9):
            with prof.RecordEvent("ev%d" % i):
                pass
        prof._enabled = False
        path = str(tmp_path / ("trace_%s.json" % prof.__name__))
        prof.export_chrome_trace(path)
        data = json.loads(open(path).read())
        marks.append([e["name"] for e in data["traceEvents"]
                      if e["name"].startswith("TRACE TRUNCATED")])
    assert marks[1] == marks[0]
    assert len(marks[1]) == 1 and "4 spans dropped" in marks[1][0]
    s = tprof.summary()
    assert s["truncated"] and s["trace_dropped"] == 4 and s["spans"] == 5


def _train_step():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [8])
        y = tfluid.layers.data("y", [1])
        h = tfluid.layers.fc(x, 16, act="tanh")
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(
            tfluid.layers.fc(h, 1), y))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(4, 8).astype(np.float32),
            "y": rng.rand(4, 1).astype(np.float32)}
    return exe, main, loss, scope, feed


def test_op_events_cover_a_train_step():
    """Under the profiler a train step is one exe.run(compiled) row and
    one op:<type> row for each op type of the program (all but the grad
    marker, which binds gradients and lowers nothing), counted once an
    op."""
    exe, main, loss, scope, feed = _train_step()
    tprof.start_profiler()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    tprof._enabled = False
    types = [op.type for op in main.global_block().ops
             if op.type != "backward_marker"]
    ev = dict(tprof._events)
    assert ev["exe.run(compiled)"][0] == 1
    assert {n for n in ev if n.startswith("op:")} == \
        {"op:" + t for t in types}
    for t in set(types):
        assert ev["op:" + t][0] == types.count(t), t


def _forward_with_host_op(pkg):
    """A forward program holding a tensor-array write, a host op: the JAX
    package runs such a program op by op (its eager path) and records one
    op:<type> event an op there."""
    x = pkg.layers.data("x", [8])
    h = pkg.layers.fc(x, 4, act="relu")
    s = pkg.layers.softmax(h)
    i = pkg.layers.fill_constant([1], "int64", 0)
    pkg.layers.array_write(s, i)
    return s


def test_op_events_match_jax_eager_path(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SEGMENT_COMPILE", "0")
    feed = {"x": np.random.RandomState(1).rand(3, 8).astype(np.float32)}
    rows = {}
    for pkg, prof in ((jfluid, jprof), (tfluid, tprof)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            s = _forward_with_host_op(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            prof.reset_profiler()
            prof.start_profiler()
            exe.run(main, feed=feed, fetch_list=[s])
            prof._enabled = False
        rows[pkg] = {n: v[0] for n, v in prof._events.items()
                     if n.startswith("op:")}
    assert rows[tfluid] == rows[jfluid]
    assert "op:write_to_array" in rows[tfluid] and "op:mul" in rows[tfluid]


def test_run_steps_dispatch_is_one_event():
    exe, main, loss, scope, feed = _train_step()
    tprof.start_profiler()
    exe.run_steps(main, feeds=[feed] * 3, fetch_list=[loss], scope=scope)
    tprof._enabled = False
    assert tprof._events["exe.run_steps(compiled)"][0] == 1
    assert "exe.run(compiled)" not in tprof._events
    assert tprof._events["op:mul"][0] == 3 * 2      # 2 fc layers a step


def test_profiler_off_records_nothing(monkeypatch):
    """With the profiler off the executor makes no event at all."""
    exe, main, loss, scope, feed = _train_step()

    def boom(*a, **k):
        raise AssertionError("an event was made with the profiler off")
    monkeypatch.setattr(tprof, "RecordEvent", boom)
    monkeypatch.setattr(tprof, "device_range", boom)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe.run_steps(main, feeds=[feed] * 2, fetch_list=[loss], scope=scope)
    assert not tprof._events and not tprof._trace


def test_no_card_no_device_trace(tmp_path):
    """Without a card profiler() opens no device trace (the host table
    still prints) and cuda_profiler raises: it has nothing to trace."""
    assert not torch.cuda.is_available()
    with tfluid.profiler.profiler("All", "total", str(tmp_path / "p")):
        with tprof.RecordEvent("x"):
            pass
    assert tprof.last_device_trace() is None
    assert not (tmp_path / "p" / "device_trace.json").exists()
    with pytest.raises(RuntimeError, match="no"):
        with tfluid.profiler.cuda_profiler(str(tmp_path / "c")):
            pass
    assert tfluid.profiler.tpu_profiler is tfluid.profiler.cuda_profiler


def test_device_trace_holds_the_op_ranges(tmp_path, monkeypatch):
    """The device trace's mechanics, here over the CPU activity alone
    (the card is asked for by patching ``cuda.is_available``, its
    activity left out of the trace): a run under
    profiler("All") leaves a chrome trace at <profile_path>/
    device_trace.json with one ``<type>.<seq>`` range an op, the JAX
    package's per-op scope names."""
    exe, main, loss, scope, feed = _train_step()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tprof, "_ACTIVITIES", ("CPU",))
    with tfluid.profiler.profiler("All", "total", str(tmp_path / "p")):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    path = tmp_path / "p" / "device_trace.json"
    names = {e.get("name") for e in json.loads(
        path.read_text())["traceEvents"]}
    ops = [op.type for op in main.global_block().ops
           if op.type != "backward_marker"]
    for seq, t in enumerate(ops):
        assert "%s.%d" % (t, seq) in names, (t, seq)
    assert tprof.last_device_trace() is not None
    # no kernel was launched, so none can be missing
    assert tprof.last_device_trace_check() == {
        "kernels": {}, "unmatched_launches": 0, "unmatched_at_ms": [],
        "complete": True}


def test_traced_block_lies_inside_the_padded_window(tmp_path, monkeypatch):
    """The device trace records after a discarded warm-up cycle and pads
    its window: the card idles ``_TRACE_EDGE_S`` after recording starts
    and before it stops, so a window that opens a little late loses no
    leading kernel records (on the CPU route, over the CPU activity: the
    block's first op range starts at least one edge into the window,
    its last ends at least one edge before the window closes). The check's kernel rows equal the
    launch counters' deltas over the block: a packed LM step with
    dropout runs the plain versions here, which count no launch, and the
    trace holds no kernel."""
    from paddle_tpu.models import transformer as JT
    from paddle_tpu_torch.core.graphs import launch_counts
    from paddle_tpu_torch.models import transformer as TT
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        loss, _ = TT.transformer_lm(vocab_size=64, max_len=16, n_layer=1,
                                    n_head=2, d_model=32, d_inner=64,
                                    packed=True, dropout_rate=0.1)
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = JT.make_lm_batch(np.random.RandomState(3), 4, 16, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tprof, "_ACTIVITIES", ("CPU",))
    before = launch_counts()
    with tfluid.profiler.profiler("All", "total", str(tmp_path / "p")):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    after = launch_counts()
    check = tprof.last_device_trace_check()
    launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    assert {k: r["launched"] for k, r in check["kernels"].items()} == \
        launched
    assert all(r["traced"] == r["launched"]
               for r in check["kernels"].values())
    assert check["complete"]
    events = json.loads((tmp_path / "p" / "device_trace.json")
                        .read_text())["traceEvents"]
    window = next(e for e in events if e.get("cat") == "Trace")
    ops = [e for e in events if e.get("cat") == "user_annotation"
           and "." in str(e.get("name"))
           and str(e["name"]).rsplit(".", 1)[1].isdigit()]
    assert ops
    edge_us = tprof._TRACE_EDGE_S * 1e6
    first = min(e["ts"] for e in ops)
    last = max(e["ts"] + e["dur"] for e in ops)
    assert first - window["ts"] >= 0.9 * edge_us
    assert window["ts"] + window["dur"] - last >= 0.9 * edge_us


def _trace_file(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _launch(ts, corr, name="cudaLaunchKernel", tid=1):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(ts, corr, name):
    return {"cat": "kernel", "name": name, "ts": ts,
            "args": {"correlation": corr}}


@pytest.mark.parametrize("lost", [None, "record", "launch"])
def test_trace_check_finds_missing_kernels(tmp_path, lost):
    """A device trace is held against the launch counters and against
    its own runtime launches: three flash_fwd launches counted, each with
    its runtime call and its kernel record, is complete; a kernel record
    lost (its launch left unmatched) or a launch lost altogether (the
    counter ahead of the trace) is not, and says what is missing.
    Launches inside a graph capture record no kernel, and count as no
    loss."""
    events = [{"cat": "cpu_op", "name": "aten::mm", "ts": 100}]
    for i in range(3):
        if lost == "launch" and i == 1:
            continue
        events.append(_launch(200 + 10 * i, i))
        if not (lost == "record" and i == 1):
            events.append(_kernel(205 + 10 * i, i, "void flash_fwd_kernel"
                                  "<64>(float const*)"))
    events += [_launch(300, 7, "cudaStreamBeginCapture"),
               _launch(310, 8), _launch(320, 9, "cudaStreamEndCapture"),
               _kernel(400, 10, "void dropout_kernel<float>()")]
    got = tprof._check_trace(_trace_file(tmp_path, events),
                             {"flash_fwd": 3, "dropout": 1, "lstm_cell": 0})
    traced = 2 if lost else 3
    assert got["kernels"] == {"flash_fwd": {"launched": 3,
                                            "traced": traced},
                              "dropout": {"launched": 1, "traced": 1}}
    assert got["unmatched_launches"] == (lost == "record")
    assert got["unmatched_at_ms"] == ([0.11, 0.11] if lost == "record"
                                      else [])
    assert got["complete"] is (lost is None)


def test_incomplete_trace_warns(tmp_path, monkeypatch):
    """A device trace that holds fewer launches of a port kernel than its
    counter says warns when it closes, naming the kernel, and
    last_device_trace_check() keeps the reading."""
    from paddle_tpu_torch.ops import dropout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tprof, "_ACTIVITIES", ("CPU",))
    monkeypatch.setattr(dropout.dropout, "launches",
                        dropout.dropout.launches)   # restored after
    with pytest.warns(RuntimeWarning, match="incomplete.*'dropout'"):
        with tfluid.profiler.cuda_profiler(str(tmp_path / "p")):
            dropout.dropout.launches += 2     # counted, never run
    check = tprof.last_device_trace_check()
    assert check["kernels"] == {"dropout": {"launched": 2, "traced": 0}}
    assert not check["complete"]


def test_trace_retakes_an_incomplete_trace(tmp_path, monkeypatch):
    """``profiler.trace`` calls its block again while the trace's check
    finds it incomplete, at most ``_TRACE_TRIES`` calls: a block whose
    first two calls count a launch that never ran is traced three times,
    its last trace complete and no warning given; a block that always
    falls short is traced ``_TRACE_TRIES`` times and warns once."""
    from paddle_tpu_torch.ops import dropout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tprof, "_ACTIVITIES", ("CPU",))
    monkeypatch.setattr(dropout.dropout, "launches",
                        dropout.dropout.launches)   # restored after
    calls = []

    def block(short_for):
        calls.append(None)
        if len(calls) <= short_for:
            dropout.dropout.launches += 1     # counted, never run
        return len(calls)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert tfluid.profiler.trace(lambda: block(2),
                                     str(tmp_path / "a")) == 3
    assert not [w for w in caught if "incomplete" in str(w.message)]
    check = tprof.last_device_trace_check()
    assert check["complete"] and check["passes"] == 3
    assert check["kernels"] == {}
    calls.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tfluid.profiler.trace(lambda: block(99), str(tmp_path / "b"))
    assert len(calls) == tprof._TRACE_TRIES == 3
    assert len([w for w in caught if issubclass(w.category, RuntimeWarning)
                and "incomplete" in str(w.message)]) == 1
    check = tprof.last_device_trace_check()
    assert not check["complete"] and check["passes"] == 3
    assert check["kernels"] == {"dropout": {"launched": 1, "traced": 0}}


def test_trace_needs_a_card(monkeypatch):
    """``profiler.trace``, like ``cuda_profiler``, raises without a card
    and never calls its block."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tfluid.profiler.trace(lambda: pytest.fail("called"), "unused")
