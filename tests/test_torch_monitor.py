"""paddle_tpu_torch.monitor unit tests: registry semantics, flight-recorder
schema + bounding, watchdog stall detection, recompile classification,
CLI summary, and the profiler trace-cap marker."""

import json
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import monitor
from paddle_tpu_torch.monitor import metrics as mm


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """Fresh default programs, scope and names of the port for every
    test (tests/conftest.py resets the JAX package's)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), \
            fluid.scope_guard(fluid.Scope()), fluid.unique_name.guard():
        yield


@pytest.fixture(autouse=True)
def _fresh_monitor():
    monitor.reset_for_tests()
    yield
    monitor.reset_for_tests()


# -- registry semantics ----------------------------------------------------

def test_registry_get_or_create_returns_same_object():
    reg = mm.Registry()
    a = reg.counter("c", "help", ("op",))
    b = reg.counter("c", "other help", ("op",))
    assert a is b
    # conflicting type or labels for an existing name is an error
    with pytest.raises(ValueError):
        reg.gauge("c")
    with pytest.raises(ValueError):
        reg.counter("c", label_names=("other",))


def test_counter_gauge_histogram_behavior():
    reg = mm.Registry()
    c = reg.counter("reqs", "requests", ("op",))
    c.inc(op="GET")
    c.inc(3, op="GET")
    c.inc(op="PUT")
    assert c.value(op="GET") == 4
    assert c.value(op="PUT") == 1
    with pytest.raises(ValueError):
        c.inc(-1, op="GET")          # counters are monotonic
    with pytest.raises(ValueError):
        c.inc(kind="GET")            # undeclared label name

    g = reg.gauge("temp")
    g.set(3.5)
    g.inc(0.5)
    assert g.value() == 4.0

    h = reg.histogram("lat", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5):
        h.observe(v)
    assert h.count() == 4
    assert h.sum() == pytest.approx(0.605)
    p50 = h.percentile(0.5)
    assert 0.01 <= p50 <= 0.1        # both middle samples sit there
    assert h.percentile(0.99) <= 1.0


def test_prometheus_render_and_snapshot():
    reg = mm.Registry()
    reg.counter("a_total", "a", ("k",)).inc(2, k='v"q')
    reg.gauge("b").set(1.5)
    reg.histogram("h", buckets=(1.0,)).observe(0.5)
    text = reg.render_prometheus()
    assert '# TYPE a_total counter' in text
    assert 'a_total{k="v\\"q"} 2' in text      # label escaping
    assert '# TYPE h histogram' in text
    assert 'h_bucket{le="+Inf"} 1' in text
    assert 'h_count 1' in text
    snap = reg.snapshot()
    assert snap["b"]["series"][""] == 1.5
    json.dumps(snap)                           # snapshot is JSON-able


def test_registry_thread_safety():
    reg = mm.Registry()
    c = reg.counter("n")

    def worker():
        for _ in range(1000):
            c.inc()

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value() == 8000


# -- flight recorder -------------------------------------------------------

def test_flight_recorder_schema_and_bounding(tmp_path):
    path = str(tmp_path / "fr.jsonl")
    rec = monitor.FlightRecorder(path, max_bytes=400)
    assert rec.record("run_meta", pid=1)
    n_ok = 0
    for i in range(50):
        if rec.record("step", n=i, dt=0.001):
            n_ok += 1
    rec.close()
    events = monitor.read_jsonl(path)      # every line parses, ts+ev set
    assert events[0]["ev"] == "run_meta"
    assert all("ts" in e for e in events)
    # the cap produced an in-band truncated marker, not a corrupt tail
    assert any(e["ev"] == "truncated" for e in events)
    assert rec.dropped == 50 - n_ok > 0
    # non-JSON-able values degrade to repr instead of raising
    rec2 = monitor.FlightRecorder(str(tmp_path / "fr2.jsonl"))
    assert rec2.record("note", obj=object())
    rec2.close()
    evs = monitor.read_jsonl(str(tmp_path / "fr2.jsonl"))
    assert "object object" in evs[0]["obj"]


def test_flight_recorder_budget_survives_reopen(tmp_path):
    # append mode must count pre-existing bytes toward max_bytes, or
    # every re-enable() hands the same file a fresh budget
    path = str(tmp_path / "re.jsonl")
    rec = monitor.FlightRecorder(path, max_bytes=300)
    for i in range(20):
        rec.record("step", n=i)
    rec.close()
    # a NEW instance over the full file has no budget left: payload
    # events are refused immediately (only its own in-band truncated
    # marker may be appended), instead of a fresh 300-byte allowance
    rec2 = monitor.FlightRecorder(path, max_bytes=300)
    assert rec2.record("step", n=99) is False
    assert rec2.dropped == 1
    rec2.close()
    events = monitor.read_jsonl(path)      # file stays parseable
    assert not any(e["ev"] == "step" and e.get("n") == 99
                   for e in events)


def test_histogram_bucket_conflict_raises():
    reg = mm.Registry()
    reg.histogram("h", buckets=(0.1, 1.0))
    assert reg.histogram("h", buckets=(0.1, 1.0)) is reg.get("h")
    with pytest.raises(ValueError, match="buckets"):
        reg.histogram("h", buckets=(0.001, 0.01))


def test_read_jsonl_rejects_malformed(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"ts": 1, "ev": "ok"}\nnot json\n')
    with pytest.raises(ValueError, match="line 2"):
        monitor.read_jsonl(str(p))


# -- watchdog --------------------------------------------------------------

def test_watchdog_fires_on_stall_and_rearms():
    fired = []
    dog = monitor.Watchdog(0.2, lambda idle, stacks: fired.append(
        (idle, stacks)), check_interval=0.05).start()
    try:
        # UNARMED until the first touch: setup time is not a stall
        time.sleep(0.5)
        assert not fired
        dog.touch()                       # first step/compile arms it
        time.sleep(0.6)
        assert len(fired) == 1            # fires ONCE per stall, no spam
        idle, stacks = fired[0]
        assert idle >= 0.2
        assert any("MainThread" in k for k in stacks)
        dog.touch()                       # stepping resumed -> re-armed
        time.sleep(0.5)
        assert len(fired) == 2
    finally:
        dog.stop()


def test_watchdog_via_enable_records_stall_event(tmp_path):
    log = str(tmp_path / "stall.jsonl")
    monitor.enable(log_path=log, stall_timeout=0.2)
    # one real step arms the watchdog; then the "training" stalls
    loss = _tiny_program()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    time.sleep(0.7)
    monitor.disable()
    evs = monitor.read_jsonl(log)
    stalls = [e for e in evs if e["ev"] == "stall"]
    # >= 1, not == 1: "fires once per stall" is pinned deterministically
    # by test_watchdog_fires_on_stall_and_rearms above — here, under CPU
    # load, a LATE async XLA compile-phase event may land mid-sleep and
    # legitimately re-arm the dog (compiles count as liveness), making a
    # second stall correct behavior rather than spam
    assert stalls
    assert stalls[0]["idle_seconds"] >= 0.2
    assert stalls[0]["stacks"]
    assert "ptpu_stalls_total" in stalls[0]["metrics"]


# -- recompile counter -----------------------------------------------------

def _tiny_program():
    x = fluid.layers.data("x", [8])
    y = fluid.layers.fc(x, 4)
    return fluid.layers.mean(y)


def test_recompile_counter_fires_on_feed_shape_change(tmp_path):
    log = str(tmp_path / "rc.jsonl")
    monitor.enable(log_path=log)
    loss = _tiny_program()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    rec0 = monitor.registry().get("ptpu_recompiles_total").value()
    xv = np.random.rand(4, 8).astype(np.float32)
    exe.run(feed={"x": xv}, fetch_list=[loss])
    assert monitor.registry().get("ptpu_recompiles_total").value() == rec0
    exe.run(feed={"x": xv}, fetch_list=[loss])           # cache hit
    assert monitor.registry().get(
        "ptpu_compile_cache_hits_total").value() >= 1
    # forced feed-SIGNATURE change: same program, new shape -> recompile
    exe.run(feed={"x": np.random.rand(6, 8).astype(np.float32)},
            fetch_list=[loss])
    assert monitor.registry().get(
        "ptpu_recompiles_total").value() == rec0 + 1
    monitor.disable()
    comps = [e for e in monitor.read_jsonl(log) if e["ev"] == "compile"]
    recomp = [c for c in comps if c["recompile"]]
    assert len(recomp) == 1
    assert recomp[0]["reason"] == "feed_signature"
    # no step is priced until the cost model is ported (ROADMAP.md
    # queue 1 item 11): the compile rows carry no flops
    assert not any(c.get("flops") for c in comps)


# -- step telemetry + CLI --------------------------------------------------

def test_step_events_and_cli_summary(tmp_path, capsys):
    log = str(tmp_path / "run.jsonl")
    monitor.enable(log_path=log, peak_flops=1e12)
    loss = _tiny_program()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    xv = np.random.rand(4, 8).astype(np.float32)
    for _ in range(3):
        exe.run(feed={"x": xv}, fetch_list=[loss])
    monitor.disable()

    steps = [e for e in monitor.read_jsonl(log) if e["ev"] == "step"]
    assert len(steps) == 4               # startup + 3 train steps
    assert all(e["dt"] > 0 for e in steps)
    assert steps[-1]["feed_bytes"] == xv.nbytes
    # the MFU gauge stays unset even with peak_flops given: no cost
    # function reaches on_compile until the cost model is ported
    # (ROADMAP.md queue 1 item 11)
    assert all(e["mfu"] is None for e in steps)
    assert monitor.registry().get("ptpu_mfu").value() is None
    # the summary the monitor CLI prints reads the same
    s = monitor.summary()
    assert s["steps"] == 4 and s["p50_s"] > 0 and s["mfu"] is None


def test_summary_and_prometheus_text():
    monitor.enable()
    loss = _tiny_program()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    exe.run(feed={"x": np.random.rand(4, 8).astype(np.float32)},
            fetch_list=[loss])
    s = monitor.summary()
    assert s["steps"] == 2 and s["compiles"] == 2
    assert s["p50_s"] is not None
    text = monitor.prometheus_text()
    assert "ptpu_steps_total" in text
    assert "ptpu_step_seconds_bucket" in text
    monitor.disable()


def test_sync_every_amortization(tmp_path):
    from paddle_tpu_torch import flags
    log = str(tmp_path / "amort.jsonl")
    monitor.enable(log_path=log)
    flags.set_flag("monitor_sync_every", 4)
    try:
        loss = _tiny_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())   # synced step 1 of 4?
        xv = np.random.rand(4, 8).astype(np.float32)
        for _ in range(8):
            exe.run(feed={"x": xv}, fetch_list=[loss])
    finally:
        flags.set_flag("monitor_sync_every", 1)
        monitor.disable()
    reg = monitor.registry()
    # every step counts; only the per-window synced ones hit the
    # latency histogram (9 steps -> 2 completed windows of 4)
    assert reg.get("ptpu_steps_total").value(executor="exe") == 9
    assert reg.get("ptpu_step_seconds").count(executor="exe") == 2
    steps = [e for e in monitor.read_jsonl(log) if e["ev"] == "step"]
    assert sum(1 for e in steps if e["synced"]) == 2
    assert sum(1 for e in steps if not e["synced"]) == 7
    # percentiles ignore the unsynced dispatch-time samples
    s = monitor.summary()
    assert s["steps"] == 9 and s["p50_s"] > 0


def test_flight_recorder_stops_after_truncated_marker(tmp_path):
    path = str(tmp_path / "latch.jsonl")
    rec = monitor.FlightRecorder(path, max_bytes=250)
    rec.record("run_meta", pid=1)
    assert rec.record("stall", big="x" * 500) is False  # overflows
    # smaller events must NOT slip in after the final marker
    assert rec.record("step", n=1) is False
    rec.close()
    evs = monitor.read_jsonl(path)
    assert [e["ev"] for e in evs if e["ev"] != "note"] \
        == ["run_meta", "truncated"]


def test_session_deltas_and_ambient_reuse(tmp_path):
    # ambient session armed; session() must reuse it (no re-enable, no
    # registry reset) and report only the block's own counts
    monitor.enable(log_path=str(tmp_path / "amb.jsonl"))
    loss = _tiny_program()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    xv = np.random.rand(4, 8).astype(np.float32)
    exe.run(feed={"x": xv}, fetch_list=[loss])        # 2 ambient steps
    with monitor.session(log_path=str(tmp_path / "ignored.jsonl")) as s:
        exe.run(feed={"x": xv}, fetch_list=[loss])
        exe.run(feed={"x": xv}, fetch_list=[loss])
    assert monitor.enabled()                  # ambient session survives
    assert s.summary()["steps"] == 2          # delta, not cumulative 4
    assert monitor.summary()["steps"] == 4    # global counters intact
    monitor.disable()
    # own-session mode: arms and disarms around the block
    with monitor.session() as s2:
        assert monitor.enabled()
        exe.run(feed={"x": xv}, fetch_list=[loss])
    assert not monitor.enabled()
    assert s2.summary()["steps"] == 1


def test_tokens_heuristic_and_override():
    feeds = {"src": np.zeros((4, 16), np.int64),
             "x": np.zeros((32, 8), np.float32)}
    assert monitor.tokens_in_feeds(feeds) == 64     # largest int feed
    assert monitor.tokens_in_feeds(
        {"x": np.zeros((32, 8), np.float32)}) == 32  # leading dim
    monitor.set_tokens_per_step(999)
    assert monitor.tokens_in_feeds(feeds) == 999
    monitor.set_tokens_per_step(None)


# -- profiler satellites ---------------------------------------------------

def test_trace_truncated_marker_past_cap(tmp_path, monkeypatch):
    from paddle_tpu_torch import profiler
    profiler.reset_profiler()
    monkeypatch.setattr(profiler, "_TRACE_CAP", 5)
    profiler.start_profiler()
    for i in range(9):
        with profiler.RecordEvent("ev%d" % i):
            pass
    profiler._enabled = False
    path = str(tmp_path / "trace.json")
    profiler.export_chrome_trace(path)
    data = json.loads(open(path).read())
    marks = [e for e in data["traceEvents"]
             if e["name"].startswith("TRACE TRUNCATED")]
    assert len(marks) == 1
    assert "4 spans dropped" in marks[0]["name"]
    profiler.reset_profiler()


def test_monitor_step_spans_route_into_profiler_trace(tmp_path):
    from paddle_tpu_torch import profiler
    profiler.reset_profiler()
    monitor.enable()
    loss = _tiny_program()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    profiler.start_profiler()
    exe.run(feed={"x": np.random.rand(4, 8).astype(np.float32)},
            fetch_list=[loss])
    profiler._enabled = False
    monitor.disable()
    names = [t[0] for t in profiler._trace]
    assert "monitor.step" in names
    path = str(tmp_path / "trace.json")
    profiler.export_chrome_trace(path)
    data = json.loads(open(path).read())
    lanes = [e for e in data["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"]
    assert lanes and all(e["args"]["name"] for e in lanes)
    profiler.reset_profiler()


# -- the port against the JAX package ---------------------------------------

# metric names the JAX package registers and the port does not: none
# since the serving fleet (serving/fleet.py) is ported. No name is XLA's
# alone: the port reports its step-plan build and CUDA graph capture
# under ptpu_xla_compile_seconds, the JAX package's name
JAX_ONLY_METRICS = set()
XLA_ONLY_METRICS = set()
# recorder keys that name the runtime: jax's version there, torch's here
RUNTIME_KEY = {"jax": "torch"}


def _monitored_rows(pkg, mon, log, nan_at=None):
    """A tiny training program through ``pkg``'s Executor on the CPU
    under ``mon`` (3 steps, one feed-shape change), its recorder rows."""
    import paddle_tpu_torch
    main, startup = pkg.Program(), pkg.Program()
    scope = pkg.Scope()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8])
        loss = pkg.layers.mean(pkg.layers.fc(x, 4))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    mon.enable(log_path=log)
    try:
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        for b in (4, 4, 6):
            exe.run(main, feed={"x": rng.rand(b, 8).astype(np.float32)},
                    fetch_list=[loss], scope=scope)
    finally:
        mon.disable()
    assert pkg is paddle_tpu_torch or "paddle_tpu" in pkg.__name__
    return mon.read_jsonl(log)


def _keys_by_kind(rows):
    out = {}
    for r in rows:
        keys = {RUNTIME_KEY.get(k, k) for k in r if k != "ts"}
        out.setdefault(r["ev"], set()).update(keys)
    return out


def test_recorder_rows_match_the_jax_package(tmp_path):
    import paddle_tpu as jfluid
    from paddle_tpu import monitor as jmon
    jmon.reset_for_tests()
    try:
        want = _keys_by_kind(_monitored_rows(
            jfluid, jmon, str(tmp_path / "j.jsonl")))
    finally:
        jmon.reset_for_tests()
    got = _keys_by_kind(_monitored_rows(fluid, monitor,
                                        str(tmp_path / "t.jsonl")))
    # an xla_compile row lands for a compile phase of 10 ms or more, in
    # either package: its presence is timing, its keys are not
    for kinds in (got, want):
        kinds.pop("xla_compile", None)
    assert set(got) == set(want) == {"run_meta", "devices", "compile",
                                     "step"}
    for kind in want:
        assert got[kind] == want[kind], kind


def test_compile_classification_matches_the_jax_package(tmp_path):
    import paddle_tpu as jfluid
    from paddle_tpu import monitor as jmon
    jmon.reset_for_tests()
    try:
        want = [(r["reason"], r["recompile"]) for r in _monitored_rows(
            jfluid, jmon, str(tmp_path / "j.jsonl")) if r["ev"] == "compile"]
    finally:
        jmon.reset_for_tests()
    got = [(r["reason"], r["recompile"]) for r in _monitored_rows(
        fluid, monitor, str(tmp_path / "t.jsonl")) if r["ev"] == "compile"]
    assert got == want
    assert ("feed_signature", True) in got


_NAMES_SCRIPT = r"""
import json, re, sys
sys.path.insert(0, %r)
import paddle_tpu
import paddle_tpu.distributed.master, paddle_tpu.distributed.membership
import paddle_tpu_torch
import paddle_tpu_torch.distributed.master
from paddle_tpu import monitor as jmon
from paddle_tpu_torch import monitor as tmon
names = lambda text: sorted(set(re.findall(r"^# TYPE (\S+)", text, re.M)))
print(json.dumps([names(jmon.prometheus_text()),
                  names(tmon.prometheus_text())]))
"""


def test_prometheus_names_match_the_jax_package():
    """Each package imported whole in a fresh interpreter (a test
    process's registry also holds what other tests' modules declared):
    the port's metric names are the JAX package's, less the listed
    ones."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _NAMES_SCRIPT % root], capture_output=True,
        text=True, timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    want, got = map(set, json.loads(proc.stdout.strip().splitlines()[-1]))
    assert got <= want, sorted(got - want)
    assert want - got == JAX_ONLY_METRICS | XLA_ONLY_METRICS, sorted(
        (want - got) ^ (JAX_ONLY_METRICS | XLA_ONLY_METRICS))


def _nan_trips(pkg, mon, log, poison):
    """The NaN guard's trip row when ``poison`` feeds an Inf through a
    guarded run (flag check_nan_inf on)."""
    main, startup = pkg.Program(), pkg.Program()
    scope = pkg.Scope()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4])
        h = pkg.layers.fc(x, 2, param_attr=pkg.ParamAttr(name="w_nan"),
                          bias_attr=False)
        out = pkg.layers.mean(pkg.layers.log(h))
    pkg.flags.set_flag("check_nan_inf", True)
    mon.enable(log_path=log)
    try:
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        with pytest.raises(FloatingPointError):
            exe.run(main, feed={"x": poison}, fetch_list=[out],
                    scope=scope)
    finally:
        mon.disable()
        pkg.flags.set_flag("check_nan_inf", None)
    return [(r["where"], r["detail"]) for r in mon.read_jsonl(log)
            if r["ev"] == "nan_guard"]


@pytest.mark.parametrize("poison", [np.full((2, 4), np.inf, np.float32),
                                    np.full((2, 4), np.nan, np.float32)])
def test_nan_trip_details_match_the_jax_package(tmp_path, poison):
    import paddle_tpu as jfluid
    from paddle_tpu import monitor as jmon
    jmon.reset_for_tests()
    try:
        want = _nan_trips(jfluid, jmon, str(tmp_path / "j.jsonl"), poison)
    finally:
        jmon.reset_for_tests()
    got = _nan_trips(fluid, monitor, str(tmp_path / "t.jsonl"), poison)
    assert got == want and len(got) == 1
    assert got[0][0] == "guard" and "/" in got[0][1]


def test_monitored_run_harness_on_the_cpu(tmp_path):
    """``models.harness.monitored_run`` (place given: the CPU) counts its
    own steps and compiles as the JAX package's harness does."""
    from paddle_tpu_torch.models import harness

    def build():
        x = fluid.layers.data("x", [8])
        loss = fluid.layers.mean(fluid.layers.fc(x, 4))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss

    s = harness.monitored_run(
        build, lambda rng: {"x": rng.rand(4, 8).astype(np.float32)},
        steps=3, log_path=str(tmp_path / "h.jsonl"),
        place=fluid.CPUPlace())
    assert s["steps"] == 4                 # startup + 3 steps
    assert s["compiles"] == 2 and s["cache_hits"] == 2
    assert s["mfu"] is None


def _megastep_rows(pkg, mon, log):
    main, startup = pkg.Program(), pkg.Program()
    scope = pkg.Scope()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8])
        loss = pkg.layers.mean(pkg.layers.fc(x, 4))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    feeds = [{"x": rng.rand(4, 8).astype(np.float32)} for _ in range(3)]
    mon.enable(log_path=log)
    try:
        exe.run_steps(main, feeds=feeds, fetch_list=[loss], scope=scope)
        exe.run_steps(main, feeds=feeds, fetch_list=[loss], scope=scope)
    finally:
        mon.disable()
    reg = mon.registry()
    return (mon.read_jsonl(log),
            reg.get("ptpu_megastep_steps_total").value(executor="exe"),
            reg.get("ptpu_megastep_dispatches_total").value(executor="exe"))


def test_megastep_rows_match_the_jax_package(tmp_path):
    """``run_steps`` reports one ``step`` row a dispatch (``k``, the
    per-step ``dt``, ``megastep_dt``), K logical steps and one compile
    then a cache hit, as the JAX package's does."""
    import paddle_tpu as jfluid
    from paddle_tpu import monitor as jmon
    jmon.reset_for_tests()
    try:
        jrows, jsteps, jdisp = _megastep_rows(jfluid, jmon,
                                              str(tmp_path / "j.jsonl"))
    finally:
        jmon.reset_for_tests()
    rows, steps, disp = _megastep_rows(fluid, monitor,
                                       str(tmp_path / "t.jsonl"))
    assert (steps, disp) == (jsteps, jdisp) == (6, 2)

    def shape(rs):
        step = [r for r in rs if r["ev"] == "step"]
        comp = [r for r in rs if r["ev"] == "compile"]
        return (len(step), [r["k"] for r in step], len(comp),
                sorted(set(step[0]) - {"ts"}))

    assert shape(rows) == shape(jrows)
    assert monitor.summary()["cache_hits"] == 1
