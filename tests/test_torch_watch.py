"""paddle_tpu_torch.monitor.watch against the JAX package's watch.

The same recorder JSONL and metric snapshots go through both packages'
dashboards: the rendered frames (a fixed ``now``, so no line depends on
the clock) and the fleet lines of a merged snapshot must be the JAX
package's, line for line, the header's package name apart. The logs are
a serving engine's (from the goodput and SLO fixtures), a chaos timeline
with alerts, a sparse scoring engine's, an elastic fleet's and a canary
rollout's rows.
"""

import importlib
import io
import json
import os

import pytest

twatch = importlib.import_module("paddle_tpu_torch.monitor.watch")

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
NOW = 1_000_100.0


def _rows():
    """Serving, sparse-cache, elastic and rollout rows, timestamped
    before ``NOW``."""
    t0 = NOW - 60
    rows = []
    for i in range(30):
        rows.append({"ts": t0 + i, "ev": "serving_step", "engine": "e0",
                     "dt": 0.004 + 0.0001 * i, "active": 3, "slots": 4,
                     "queue_depth": i % 5, "emitted": 3, "admitted": 1,
                     "retired": 1, "k": 1, "kv_used": 10 + i,
                     "kv_total": 64, "kv_bytes_used": 4096 * (10 + i),
                     "kv_bytes_total": 4096 * 64, "prefix_hits": i,
                     "prefix_misses": 30 - i, "spec_drafted": 4 * i,
                     "spec_accepted": 3 * i, "spec_emitted": 5 * i,
                     "spec_dispatches": i})
        rows.append({"ts": t0 + i + 0.5, "ev": "serving_request",
                     "engine": "e0", "ttft": 0.02 + 0.001 * i,
                     "tpot": 0.003, "queue_wait": 0.001, "tokens": 8,
                     "version": "v1" if i < 20 else "v2",
                     **({"error": "RuntimeError('x')"} if i == 7
                        else {})})
        rows.append({"ts": t0 + i + 0.6, "ev": "serving_step",
                     "engine": "scoring", "dt": 0.002, "active": 8,
                     "slots": 8, "queue_depth": 0, "emitted": 8,
                     "cache_hits": 10 * i, "cache_misses": 30 - i,
                     "cache_stale": i // 3, "cache_evictions": i // 5})
    rows.append({"ts": t0 + 40, "ev": "scale_event", "direction": "up",
                 "desired": 3, "live": 2, "reason": "burst"})
    rows.append({"ts": t0 + 41, "ev": "drain", "slot": 1,
                 "endpoint": "127.0.0.1:1", "version": "v1"})
    rows.append({"ts": t0 + 42, "ev": "roll", "from_version": "v1",
                 "to_version": "v2", "convergence_s": 3.5, "replaced": 2,
                 "shed_during": 0, "aborted": False})
    for ph in ("shadow", "canary", "promoted"):
        rows.append({"ts": t0 + 43, "ev": "rollout", "phase": ph,
                     "version": "v2", "version_mix": {"v1": 1, "v2": 1}})
    rows.append({"ts": t0 + 44, "ev": "verdict", "phase": "shadow",
                 "version": "v2", "verdict": "PASS", "pairs": 8})
    return rows


@pytest.fixture(autouse=True)
def _no_last_bundle(monkeypatch):
    """The incidents line names the last forensic bundle this process
    assembled: an earlier test's in either package must not show."""
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        fx = importlib.import_module(pkg + ".monitor.forensics")
        monkeypatch.setattr(fx, "_LAST_BUNDLE", None)


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _frames(path, pkg_watch, slo_spec=None):
    st = pkg_watch.WatchState()
    with open(path) as f:
        for line in f:
            st.feed_event(json.loads(line))
    return pkg_watch.render_frame(st, path, now=NOW).replace(
        "paddle_tpu_torch", "paddle_tpu")


@pytest.mark.parametrize("log", ["serving_requests.jsonl",
                                 "goodput_chaos.jsonl", "synthetic"])
def test_frames_equal_the_jax_package(log, tmp_path):
    jwatch = importlib.import_module("paddle_tpu.monitor.watch")
    path = (_write(tmp_path / "run.jsonl", _rows()) if log == "synthetic"
            else os.path.join(FIX, log))
    want, got = _frames(path, jwatch), _frames(path, twatch)
    assert got == want
    assert got.strip()


def test_watch_once_with_an_slo_spec_equals_the_jax_package(tmp_path,
                                                            monkeypatch):
    """``watch(..., once=True, slo_spec=...)``: the verdict and the
    active-alerts lines come out as the JAX package's (the live clock
    pinned for both)."""
    import time as _time
    jwatch = importlib.import_module("paddle_tpu.monitor.watch")
    monkeypatch.setattr(_time, "time", lambda: NOW)
    path = _write(tmp_path / "run.jsonl", _rows())
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"name": "t", "objectives": [
        {"metric": "ttft", "percentile": 0.95, "max_seconds": 0.04},
        {"metric": "error_rate", "target": 0.99,
         "windows": [{"short_s": 5, "long_s": 30, "burn_rate": 2.0,
                      "severity": "page"}]}]}))
    frames = []
    for mod in (jwatch, twatch):
        buf = io.StringIO()
        frames.append(mod.watch(path, once=True, out=buf,
                                slo_spec=str(spec)).replace(
                                    "paddle_tpu_torch", "paddle_tpu"))
    assert frames[1] == frames[0]
    assert "alerts" in frames[1]


def test_fleet_lines_equal_the_jax_package():
    """The fleet lines of one merged snapshot (the collector's schema:
    counters, gauges, histograms and the fleet ``__meta__``)."""
    jwatch = importlib.import_module("paddle_tpu.monitor.watch")
    from paddle_tpu_torch.monitor import metrics as mm
    reg = mm.Registry()
    reg.counter("ptpu_serving_tokens_total", "", ("engine",)).inc(
        123, engine="e0")
    reg.counter("ptpu_steps_total", "", ("executor",)).inc(10,
                                                           executor="exe")
    reg.gauge("ptpu_serving_queue_depth", "", ("engine",)).set(
        4, engine="e0")
    reg.gauge("ptpu_serving_slot_occupancy", "", ("engine",)).set(
        0.5, engine="e0")
    h = reg.histogram("ptpu_serving_ttft_seconds", "", ("engine",))
    for v in (0.01, 0.02, 0.05, 0.2):
        h.observe(v, engine="e0")
    snap = reg.snapshot()
    snap["__meta__"] = {"fleet": True, "processes": 2, "scrapes": 3,
                        "events_lost": 0, "ts": NOW, "endpoints": [
                            {"endpoint": "127.0.0.1:1", "role": "replica",
                             "incarnation": "a", "uptime_s": 5.0,
                             "ok": True, "error": None, "age_s": 0.5,
                             "last_event_age_s": 1.0},
                            {"endpoint": "127.0.0.1:2", "role": "ps",
                             "incarnation": "b", "uptime_s": 9.0,
                             "ok": False, "error": "refused",
                             "age_s": 30.0, "last_event_age_s": None}]}
    st_j, st_t = jwatch.WatchState(), twatch.WatchState()
    for r in _rows():
        st_j.feed_event(r)
        st_t.feed_event(r)
    want = jwatch.fleet_lines(snap, now=NOW, state=st_j)
    got = twatch.fleet_lines(snap, now=NOW, state=st_t)
    assert got == want
    assert any("serving tokens 123" in ln for ln in got)
    assert twatch.rollout_line(st_t) == jwatch.rollout_line(st_j)
    assert twatch.staleness_lines({"a": NOW - 2, "b": NOW - 60},
                                  now=NOW) == \
        jwatch.staleness_lines({"a": NOW - 2, "b": NOW - 60}, now=NOW)


def test_watch_cli_once_equals_the_jax_package(tmp_path, capsys,
                                               monkeypatch):
    import time as _time
    from torch_fleet_harness import run_main_both
    monkeypatch.setattr(_time, "time", lambda: NOW)
    path = _write(tmp_path / "run.jsonl", _rows())
    want, got = run_main_both("monitor.__main__",
                              ["watch", path, "--once"], capsys)
    assert got == want
    assert want[0] == 0
