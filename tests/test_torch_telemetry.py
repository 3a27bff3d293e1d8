"""The port's twin of tests/test_telemetry.py, and the serving engine's
telemetry held against the JAX engine's.

Fleet telemetry plane: METR/HLTH scrape verbs, the
collector's exact-sum merge + restart detection, the shared histogram
merge primitive, watch --fleet, and per-log staleness.

The tier-1 smoke at the bottom runs a REAL 3-process mini-fleet
(master+pserver subprocess, telemetry-armed trainer subprocess, and
this process hosting the KV registry + a replica-role endpoint),
scraped live by the collector.

The engine's telemetry: one engine run in each package on the same
weights and requests, under the monitor and the tracer, gives the same
recorder rows, metric names and span names, apart from times.
"""

import io
import json
import os
import subprocess
import sys
import time

import pytest

from paddle_tpu_torch.monitor import metrics as mm
from paddle_tpu_torch.monitor.collector import (
    Collector, TelemetryClient, TelemetryServer, render_prometheus_snapshot)
from paddle_tpu_torch.monitor.recorder import FlightRecorder
from paddle_tpu_torch.monitor.watch import (WatchState, staleness_lines,
                                            watch, watch_fleet)


# -- satellite: Histogram.merge / merge_snapshots / snapshot meta ----------

def test_histogram_merge_bucketwise():
    a = mm.Histogram("h", buckets=(0.1, 1.0, 10.0))
    b = mm.Histogram("h", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0):
        a.observe(v)
    for v in (0.5, 50.0):
        b.observe(v)
    a.merge(b)
    snap = a.snapshot()[()]
    assert snap["counts"] == [1, 3, 1, 1]   # bucket-wise exact sum
    assert snap["count"] == 6
    assert abs(snap["sum"] - (0.05 + 0.5 * 3 + 5.0 + 50.0)) < 1e-9


def test_histogram_merge_boundary_mismatch_is_loud():
    a = mm.Histogram("h", buckets=(0.1, 1.0))
    b = mm.Histogram("h", buckets=(0.2, 1.0))
    b.observe(0.5)
    with pytest.raises(ValueError, match="boundaries differ"):
        a.merge(b)


def test_merge_snapshots_counters_gauges_histograms():
    r1, r2 = mm.Registry(), mm.Registry()
    r1.counter("c", "", ("op",)).inc(5, op="GET")
    r2.counter("c", "", ("op",)).inc(7, op="GET")
    r2.counter("c", "", ("op",)).inc(3, op="PUT")
    r1.gauge("g").set(1.5)
    r2.gauge("g").set(2.5)
    r1.histogram("h", buckets=(1.0,)).observe(0.5)
    r2.histogram("h", buckets=(1.0,)).observe(2.0)
    merged = mm.merge_snapshots(r1.snapshot(), r2.snapshot())
    assert merged["c"]["series"] == {"GET": 12, "PUT": 3}
    assert merged["g"]["series"][""] == 4.0
    assert merged["h"]["series"][""]["counts"] == [1, 1]
    # src meta ignored; into keeps its own
    assert merged[mm.META_KEY]["incarnation"] == r1.incarnation


def test_merge_snapshots_mismatches_are_loud():
    r1, r2 = mm.Registry(), mm.Registry()
    r1.counter("x").inc()
    r2.gauge("x").set(1)
    with pytest.raises(ValueError, match="kind mismatch"):
        mm.merge_snapshots(r1.snapshot(), r2.snapshot())
    r3, r4 = mm.Registry(), mm.Registry()
    r3.histogram("h", buckets=(1.0,)).observe(0.5)
    r4.histogram("h", buckets=(2.0,)).observe(0.5)
    with pytest.raises(ValueError, match="boundaries differ"):
        mm.merge_snapshots(r3.snapshot(), r4.snapshot())


def test_prometheus_render_label_value_with_comma():
    reg = mm.Registry()
    reg.counter("t_total", "", ("shape",)).inc(1, shape="(8, 128)")
    reg.counter("u_total", "", ("a", "b")).inc(2, a="x,y", b="z")
    reg.gauge("g_val", "", ("lbl",)).set(5.0, lbl="")
    text = render_prometheus_snapshot(reg.snapshot())
    # comma-bearing values survive whole in ANY label position (the
    # series key uses a lossless separator, not ",")
    assert 't_total{shape="(8, 128)"} 1' in text
    assert 'u_total{a="x,y",b="z"} 2' in text
    # an EMPTY single label value still renders its label — it must
    # not collide with an unlabeled series of the same name
    assert 'g_val{lbl=""} 5.0' in text


def test_registry_snapshot_carries_incarnation_and_uptime():
    reg = mm.Registry()
    t0 = reg.uptime_s()
    meta = reg.snapshot()[mm.META_KEY]
    assert meta["incarnation"] == reg.incarnation
    assert meta["uptime_s"] >= t0
    inc0 = reg.incarnation
    reg.reset()          # a reset IS a restart to any scraper
    assert reg.incarnation != inc0
    json.dumps(reg.snapshot())               # stays JSON-able


def test_recorder_ring_events_since(tmp_path):
    rec = FlightRecorder(str(tmp_path / "r.jsonl"), ring=4)
    for i in range(3):
        rec.record("note", i=i)
    cur, rows, lost = rec.events_since(None)
    assert [r["i"] for r in rows] == [0, 1, 2] and lost == 0
    rec.record("note", i=3)
    cur2, rows2, lost2 = rec.events_since(cur)
    assert [r["i"] for r in rows2] == [3] and lost2 == 0
    for i in range(4, 10):                   # overflow the ring of 4
        rec.record("note", i=i)
    cur3, rows3, lost3 = rec.events_since(cur2)
    assert [r["i"] for r in rows3] == [6, 7, 8, 9]
    assert lost3 == 2                        # i=4,5 aged out
    rec.close()


# -- collector: golden scrape -> merge over 3 fake processes ---------------

def _fake_proc_registry(get_count, step_count, hist_vals,
                        queue_depth):
    reg = mm.Registry()
    reg.counter("ptpu_rpc_requests_total", "", ("op",)).inc(
        get_count, op="GET")
    reg.counter("ptpu_steps_total", "", ("executor",)).inc(
        step_count, executor="exe")
    h = reg.histogram("ptpu_serving_ttft_seconds", "", ("engine",),
                      buckets=(0.01, 0.1, 1.0))
    for v in hist_vals:
        h.observe(v, engine="e")
    reg.gauge("ptpu_serving_queue_depth").set(queue_depth)
    return reg


def test_collector_three_process_scrape_merge_golden():
    regs = [_fake_proc_registry(5, 100, (0.005, 0.05), 2),
            _fake_proc_registry(7, 200, (0.05, 0.5), 3),
            _fake_proc_registry(11, 300, (0.5, 0.5, 2.0), 4)]
    servers = [TelemetryServer(registry=r, role="trainer").start()
               for r in regs]
    col = Collector(static=[("trainer", s.endpoint) for s in servers])
    try:
        col.scrape_once()
        snap = col.fleet_snapshot()
        # counters: exact sum across the three processes
        assert snap["ptpu_rpc_requests_total"]["series"]["GET"] == 23
        assert snap["ptpu_steps_total"]["series"]["exe"] == 600
        # gauges: sum over live processes
        assert snap["ptpu_serving_queue_depth"]["series"][""] == 9.0
        # histogram: bucket-wise merged counts, hand-computed
        h = snap["ptpu_serving_ttft_seconds"]
        assert h["buckets"] == [0.01, 0.1, 1.0]
        # per-process counts [1,1,0,0]+[0,1,1,0]+[0,0,2,1], summed
        assert h["series"]["e"]["counts"] == [1, 2, 3, 1]
        assert h["series"]["e"]["count"] == 7
        # merged percentile vs hand computation: target 3.5 of 7,
        # cumulative [1,3,6,7] -> bucket (0.1, 1.0], frac (3.5-3)/3
        p50 = col.fleet_percentile("ptpu_serving_ttft_seconds", 0.5)
        assert abs(p50 - (0.1 + 0.9 * (0.5 / 3.0))) < 1e-9
        meta = snap[mm.META_KEY]
        assert meta["fleet"] and meta["processes"] == 3
        # second scrape with no progress adds nothing (delta = 0)
        col.scrape_once()
        snap2 = col.fleet_snapshot()
        assert snap2["ptpu_rpc_requests_total"]["series"]["GET"] == 23
        # progress on one process lands as its exact delta
        regs[0].counter("ptpu_rpc_requests_total", "",
                        ("op",)).inc(4, op="GET")
        col.scrape_once()
        snap3 = col.fleet_snapshot()
        assert snap3["ptpu_rpc_requests_total"]["series"]["GET"] == 27
        # prometheus re-export carries the merged series
        text = render_prometheus_snapshot(snap3)
        assert 'ptpu_rpc_requests_total{op="GET"} 27' in text
        assert '# TYPE ptpu_serving_ttft_seconds histogram' in text
    finally:
        col.close()
        for s in servers:
            s.stop()


def test_collector_restart_detection_no_negative_deltas():
    reg = _fake_proc_registry(50, 10, (), 1)
    srv = TelemetryServer(registry=reg, role="trainer").start()
    col = Collector(static=[("trainer", srv.endpoint)])
    try:
        col.scrape_once()
        s = col.fleet_snapshot()
        assert s["ptpu_rpc_requests_total"]["series"]["GET"] == 50
        # process "restarts": fresh registry, counters back near zero
        srv.registry = _fake_proc_registry(3, 2, (), 1)
        col.scrape_once()
        s2 = col.fleet_snapshot()
        # monotonic: 50 (dead incarnation's contribution) + 3 fresh
        assert s2["ptpu_rpc_requests_total"]["series"]["GET"] == 53
        srv.registry.counter("ptpu_rpc_requests_total", "",
                             ("op",)).inc(2, op="GET")
        col.scrape_once()
        s3 = col.fleet_snapshot()
        assert s3["ptpu_rpc_requests_total"]["series"]["GET"] == 55
    finally:
        col.close()
        srv.stop()


def test_collector_dedupes_same_process_endpoints():
    reg = _fake_proc_registry(9, 4, (), 0)
    s1 = TelemetryServer(registry=reg, role="a").start()
    s2 = TelemetryServer(registry=reg, role="b").start()
    col = Collector(static=[("a", s1.endpoint), ("b", s2.endpoint)])
    try:
        col.scrape_once()
        snap = col.fleet_snapshot()
        # one registry behind two ports: counted ONCE, not twice
        assert snap["ptpu_rpc_requests_total"]["series"]["GET"] == 9
        assert snap[mm.META_KEY]["processes"] == 1
        assert len(snap[mm.META_KEY]["endpoints"]) == 2
    finally:
        col.close()
        s1.stop()
        s2.stop()


def test_metr_hlth_served_by_dispatch_loops():
    """Every tier that hosts a dispatch loop answers the scrape verbs
    (pserver / master / KV), with its role stamped."""
    from paddle_tpu_torch.distributed.master import MasterServer, TaskQueue
    from paddle_tpu_torch.distributed.membership import KVServer
    from paddle_tpu_torch.distributed.rpc import VariableServer
    ps = VariableServer(fan_in=1).start()
    ms = MasterServer(TaskQueue(payloads=[1])).start()
    kv = KVServer().start()
    try:
        for srv, port, role in ((ps, ps.port, "pserver"),
                                (ms, ms.port, "master"),
                                (kv, kv.port, "kv")):
            with TelemetryClient("127.0.0.1:%d" % port) as tc:
                h = tc.hlth()
                assert h["role"] == role and h["alive"]
                m = tc.metr()
                assert m["role"] == role
                assert m["incarnation"] == h["incarnation"]
                assert "ptpu_rpc_requests_total" in m["snapshot"]
    finally:
        ps.stop()
        ms.stop()
        kv.stop()


# -- watch: per-log staleness + fleet frame --------------------------------

def test_staleness_lines_relative_and_flagged():
    lines = staleness_lines({"a.jsonl": 100.0, "b.jsonl": 90.0,
                             "c.jsonl": None})
    text = "\n".join(lines)
    assert "a.jsonl" in text and "last row   0.0s ago" in text
    assert "10.0s ago   [STALE]" in text
    assert "no rows yet" in text
    # single log: no staleness block (nothing to compare against)
    assert staleness_lines({"a.jsonl": 100.0}) == []


def test_watch_once_multi_log_staleness(tmp_path):
    t = time.time()
    live = tmp_path / "live.jsonl"
    dead = tmp_path / "dead.jsonl"
    live.write_text(json.dumps(
        {"ts": t, "ev": "step", "dt": 0.01}) + "\n")
    dead.write_text(json.dumps(
        {"ts": t - 42.0, "ev": "step", "dt": 0.01}) + "\n")
    buf = io.StringIO()
    frame = watch([str(live), str(dead)], once=True, out=buf)
    assert "dead.jsonl" in frame
    assert "[STALE]" in frame          # 42s behind the newest row
    assert "live.jsonl" in frame and "0.0s ago" in frame


def test_watch_fleet_once_renders_scraped_dashboard():
    reg = _fake_proc_registry(5, 10, (), 2)
    reg.counter("ptpu_serving_tokens_total").inc(123)
    srv = TelemetryServer(registry=reg, role="replica").start()
    col = Collector(static=[("replica", srv.endpoint)])
    try:
        buf = io.StringIO()
        frame = watch_fleet(collector=col, once=True, out=buf)
        assert "fleet" in frame
        assert "replica" in frame and srv.endpoint in frame
        assert "serving tokens 123" in frame
        assert "steps 10" in frame
    finally:
        col.close()
        srv.stop()


def test_collector_survives_recorder_replacement(tmp_path):
    """monitor.enable() mid-process replaces the flight recorder (a
    fresh ring, sequence restarted) WITHOUT a registry restart: the
    collector's old cursor must not silently filter every new row —
    the ring id in the METR reply restarts the delta."""
    from paddle_tpu_torch import monitor
    srv = TelemetryServer(role="trainer").start()   # global registry
    col = Collector(static=[("trainer", srv.endpoint)])
    try:
        monitor.enable(log_path=str(tmp_path / "a.jsonl"))
        monitor.recorder().record("note", run=1)
        ev1 = [e for e in col.scrape_once() if e.get("ev") == "note"]
        assert [e["run"] for e in ev1] == [1]
        # second enable: new recorder, new ring, seq restarts at 1
        monitor.enable(log_path=str(tmp_path / "b.jsonl"))
        monitor.recorder().record("note", run=2)
        ev2 = [e for e in col.scrape_once() if e.get("ev") == "note"]
        assert [e["run"] for e in ev2] == [2]
        # disable -> scrape (reply carries NO ring) -> re-enable: the
        # saved cursor must be dropped, or the fresh ring's rows would
        # be silently filtered against it
        monitor.disable()
        col.scrape_once()
        monitor.enable(log_path=str(tmp_path / "c.jsonl"))
        monitor.recorder().record("note", run=3)
        ev3 = [e for e in col.scrape_once() if e.get("ev") == "note"]
        assert [e["run"] for e in ev3] == [3]
    finally:
        monitor.disable()
        col.close()
        srv.stop()


def test_collector_registry_flap_does_not_replay_ring(tmp_path):
    """An endpoint that vanishes from discovery for a round (lease
    hiccup) keeps its endpoint->incarnation link for a grace window:
    the next scrape continues from the saved ring cursor instead of
    replaying the whole ring as 'new' events."""
    from paddle_tpu_torch import monitor
    srv = TelemetryServer(role="trainer").start()
    col = Collector(static=[("trainer", srv.endpoint)])
    try:
        monitor.enable(log_path=str(tmp_path / "f.jsonl"))
        monitor.recorder().record("note", i=1)
        assert len([e for e in col.scrape_once()
                    if e.get("ev") == "note"]) == 1
        # a LONG registry outage (many rounds past the retention
        # bound) while the endpoint keeps answering: successful
        # scrapes reset the missing counter, so the cursor link
        # survives arbitrarily long KV downtime
        real = col._discover
        col._discover = lambda: []
        for _ in range(Collector._MISSING_ROUNDS_MAX + 5):
            assert col.scrape_once() == []
        col._discover = real
        monitor.recorder().record("note", i=2)
        notes = [e for e in col.scrape_once()
                 if e.get("ev") == "note"]
        assert [e["i"] for e in notes] == [2]   # no i=1 replay
    finally:
        monitor.disable()
        col.close()
        srv.stop()


def test_watch_goodput_rolls_up_per_source():
    """The watch surfaces' goodput_fraction comes from per-SOURCE
    raw-event windows (training rows included), rolled up per
    process — not from the serving-only deques, and never over a
    union timeline."""
    state = WatchState(window=64)
    # source A: one fully-productive second of training
    state.feed_event({"ts": 10.0, "ev": "run_meta"}, source="a")
    state.feed_event({"ts": 11.0, "ev": "step", "dt": 1.0},
                     source="a")
    # source B: a 1 s window that is ALL idle
    state.feed_event({"ts": 10.0, "ev": "run_meta"}, source="b")
    state.feed_event({"ts": 11.0, "ev": "note"}, source="b")
    samples = state.request_samples()
    g = samples["goodput"]
    # union timeline would claim 100% productive; per-process rollup
    # reports 1 productive second of 2 wall seconds
    assert g["wall_s"] == pytest.approx(2.0)
    assert g["goodput_fraction"] == pytest.approx(0.5)
    # and a TRAINING log alone yields a verdict (no serving rows)
    from paddle_tpu_torch import slo as _slo
    v = _slo.evaluate({"objectives": [
        {"metric": "goodput_fraction", "min_ratio": 0.4}]}, samples)
    assert v["pass"]


def test_watch_fleet_once_nothing_reachable_exits_nonzero(tmp_path):
    srv = TelemetryServer(role="x")          # never started
    srv.stop()                               # port closed
    col = Collector(static=[("x", srv.endpoint)])
    try:
        buf = io.StringIO()
        frame = watch_fleet(collector=col, once=True, out=buf)
        assert frame is None                 # CLI maps this to exit 1
        assert "no endpoint answered" in buf.getvalue()
    finally:
        col.close()


# -- tier-1 e2e smoke: 3-process mini-fleet scraped live -------------------

_MASTER_PS_PROC = '''\
import os, sys, time
sys.path.insert(0, %(repo)r)
import paddle_tpu_torch
from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed.master import MasterServer, TaskQueue
from paddle_tpu_torch.distributed.rpc import VariableServer

monitor.enable(log_path=%(mon_log)r)
monitor.recorder().record("note", who="serverproc", n=1)
ps = VariableServer(fan_in=1, port_file=%(ps_port_file)r).start()
master = MasterServer(TaskQueue(payloads=list(range(%(n_tasks)d))),
                      port_file=%(master_port_file)r).start()
deadline = time.time() + 120
while not os.path.exists(%(stop_file)r) and time.time() < deadline:
    time.sleep(0.05)
master.stop()
ps.stop()
'''

_TRAINER_PROC = '''\
import os, sys, time
sys.path.insert(0, %(repo)r)
import paddle_tpu_torch               # telemetry armed via env flags
from paddle_tpu_torch.monitor import metrics
from paddle_tpu_torch.monitor.collector import _ARMED
assert _ARMED is not None, "telemetry flag did not arm"
metrics.registry().counter(
    "ptpu_steps_total", "", ("executor",)).inc(37, executor="exe")
open(%(ready_file)r, "w").write("up")
deadline = time.time() + 120
while not os.path.exists(%(stop_file)r) and time.time() < deadline:
    time.sleep(0.05)
'''


class _FakeEngine:
    """Just enough engine for a ReplicaServer to front: the smoke
    scrapes METR/HLTH/STAT, it never SUBMs."""

    slots = 4
    stats = {"steps": 0, "tokens": 0, "admissions": 0}
    on_retire = None


def _wait_file(path, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path) and open(path).read().strip():
            return open(path).read().strip()
        time.sleep(0.05)
    raise TimeoutError("no %s" % path)


def test_fleet_scrape_smoke_three_processes(tmp_path):
    """ acceptance: master + pserver (one real subprocess),
    a telemetry-armed trainer (second real subprocess), and this
    process's replica-role endpoint + KV registry, scraped by ONE
    collector: fleet counters are exact sums, the recorder event
    delta streams over METR, and watch --fleet renders it."""
    import numpy as np
    from paddle_tpu_torch.distributed.master import MasterClient
    from paddle_tpu_torch.distributed.membership import (KVServer, KVClient,
                                                         register_endpoint)
    from paddle_tpu_torch.distributed.rpc import RPCClient
    from paddle_tpu_torch.serving.fleet import ReplicaServer
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    stop_file = str(tmp_path / "stop")
    ps_port_file = str(tmp_path / "ps.port")
    master_port_file = str(tmp_path / "master.port")
    ready_file = str(tmp_path / "trainer.ready")
    mon_log = str(tmp_path / "server_mon.jsonl")
    n_tasks = 3

    kv_srv = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kv_srv.endpoint)

    script_a = tmp_path / "server_proc.py"
    script_a.write_text(_MASTER_PS_PROC % {
        "repo": repo, "ps_port_file": ps_port_file,
        "master_port_file": master_port_file,
        "stop_file": stop_file, "n_tasks": n_tasks,
        "mon_log": mon_log})
    script_b = tmp_path / "trainer_proc.py"
    script_b.write_text(_TRAINER_PROC % {
        "repo": repo, "ready_file": ready_file,
        "stop_file": stop_file})
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu"})
    for k in ("PADDLE_TPU_MONITOR", "PADDLE_TPU_TRACE",
              "PADDLE_TPU_TELEMETRY"):
        env.pop(k, None)
    env_b = dict(env)
    env_b.update({"PADDLE_TPU_TELEMETRY": "1",
                  "PADDLE_TPU_TELEMETRY_KV": kv_srv.endpoint})
    procs = [subprocess.Popen([sys.executable, str(script_a)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True),
             subprocess.Popen([sys.executable, str(script_b)],
                              env=env_b, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    rep_srv = None
    col = None
    try:
        ps_port = int(_wait_file(ps_port_file))
        master_port = int(_wait_file(master_port_file))
        _wait_file(ready_file)

        # replica-role endpoint in THIS process, lease-registered
        rep_srv = ReplicaServer(_FakeEngine()).start()
        _, lease = register_endpoint(kv, "replica", 2,
                                     rep_srv.endpoint, ttl=1.0)

        # deterministic traffic whose server-side counters we can sum
        cli = RPCClient("127.0.0.1:%d" % ps_port)
        cli.put_var("w", np.ones((4,), np.float32))
        for _ in range(3):
            cli.get_var("w")
        mcli = MasterClient("127.0.0.1:%d" % master_port)
        done = 0
        while done < n_tasks:
            tid, payload = mcli.get_task()
            if tid is None:
                time.sleep(0.02)
                continue
            mcli.task_done(tid)
            done += 1

        col = Collector(
            kv_endpoint=kv_srv.endpoint,
            roles=("replica", "telemetry"),
            static=[("pserver", "127.0.0.1:%d" % ps_port),
                    ("master", "127.0.0.1:%d" % master_port)])
        events = col.scrape_once()
        snap = col.fleet_snapshot()

        # the TEST process's registry (served by the kv + replica
        # endpoints) carries whatever earlier tests in this pytest
        # process did — subtract it so the sums stay exact under any
        # suite ordering. Nothing in this test bumps these locally.
        def _local(name, **labels):
            m = mm.registry().get(name)
            try:
                return (m.value(**labels) or 0) if m is not None \
                    else 0
            except ValueError:
                return 0

        loc_get = _local("ptpu_rpc_requests_total", op="GET")
        loc_put = _local("ptpu_rpc_requests_total", op="PUT")
        loc_done = _local("ptpu_master_tasks_total", state="done")
        loc_exe = _local("ptpu_steps_total", executor="exe")
        meta = snap[mm.META_KEY]
        # 3 OS processes: server subprocess (one incarnation behind
        # two endpoints), trainer subprocess, this test process (KV +
        # replica share its registry)
        assert meta["processes"] >= 3
        roles = {e["role"] for e in meta["endpoints"]}
        assert {"pserver", "master", "kv", "replica",
                "telemetry"} <= roles
        # exact sums: pserver counters from the REAL subprocess
        reqs = snap["ptpu_rpc_requests_total"]["series"]
        assert reqs["PUT"] == 1 + loc_put
        assert reqs["GET"] == 3 + loc_get
        tasks = snap["ptpu_master_tasks_total"]["series"]
        assert tasks["done"] == n_tasks + loc_done
        # the trainer's hand-bumped steps ride the telemetry role
        assert snap["ptpu_steps_total"]["series"]["exe"] == \
            37 + loc_exe
        # recorder event delta streamed over METR from subprocess A
        notes = [e for e in events if e.get("ev") == "note"]
        assert notes and notes[0]["who"] == "serverproc"
        assert notes[0]["proc"].split("@")[0] in ("pserver", "master")
        # scrape again: counters must not double (delta accumulation)
        col.scrape_once()
        snap2 = col.fleet_snapshot()
        assert snap2["ptpu_rpc_requests_total"]["series"]["PUT"] == \
            1 + loc_put
        assert snap2["ptpu_steps_total"]["series"]["exe"] == \
            37 + loc_exe
        # the live scraped dashboard renders the merged view
        buf = io.StringIO()
        frame = watch_fleet(collector=col, once=True, out=buf)
        assert "pserver" in frame and "telemetry" in frame
        assert "replica" in frame
        # one spec gates the whole fleet from the scraped snapshot
        from paddle_tpu_torch import slo as _slo
        fleet_json = str(tmp_path / "fleet.json")
        col.dump_json(fleet_json)
        verdict = _slo.evaluate(
            {"name": "fleet", "objectives": [
                {"metric": "error_rate", "max_ratio": 0.5}]},
            _slo.samples_from_metrics(fleet_json))
        # what matters: the fleet snapshot IS a valid --metrics
        # surface (request totals may carry earlier suite traffic
        # through this process's shared registry — no exact bound)
        assert isinstance(verdict["pass"], bool)
        assert verdict["objectives"][0]["metric"] == "error_rate"
        assert verdict["source"].startswith("metrics snapshot")
        cli.close()
        mcli.close()
        lease.revoke()
    finally:
        open(stop_file, "w").write("stop")
        if col is not None:
            col.close()
        if rep_srv is not None:
            rep_srv.stop()
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out)
        kv.shutdown_server()
        kv.close()
    assert procs[0].returncode == 0, outs[0][-3000:]
    assert procs[1].returncode == 0, outs[1][-3000:]


# -- the engine's telemetry against the JAX engine ---------------------------

# fields that carry times, clocks or process identity
_TIMES = {"ts", "dt", "queue_wait", "ttft", "tpot", "megastep_dt",
          "trace_id", "pid", "uptime_s", "incarnation", "t0", "dur",
          "trace", "span", "parent", "admit_step", "step_span", "tid"}


def _engine_run(pkg, model, reqs, tmp_path, **kw):
    """One engine run of package ``pkg`` under its monitor and tracer:
    (recorder rows, metric names, spans), times left out."""
    import importlib
    mon = importlib.import_module(pkg + ".monitor")
    trt = importlib.import_module(pkg + ".trace.runtime")
    eng_mod = importlib.import_module(pkg + ".serving")
    log = str(tmp_path / (pkg + "-mon.jsonl"))
    spans = str(tmp_path / (pkg + "-spans.jsonl"))
    trt.enable(log_path=spans, sample_rate=1.0, proc="engine")
    try:
        with mon.session(log_path=log):
            with eng_mod.Engine(model, name="e", **kw) as eng:
                # every request is queued before the loop's first
                # admission: holding the engine's (re-entrant) condition
                # keeps its loop from waking on the first submit, so the
                # rows do not depend on how the threads interleave
                with eng._cv:
                    hs = [eng.submit(p, m, request_id="r%d" % i)
                          for i, (p, m) in enumerate(reqs)]
                out = [h.result(timeout=120) for h in hs]
            names = sorted(n for n in mon.registry().snapshot()
                           if n.startswith(("ptpu_serving", "ptpu_kv",
                                            "ptpu_prefix", "ptpu_spec")))
    finally:
        trt.disable()
    rows = [{k: v for k, v in r.items() if k not in _TIMES}
            for r in mon.read_jsonl(log)
            if r["ev"] in ("serving_step", "serving_request")]
    sp = [(s["name"], sorted(k for k in (s.get("attrs") or {})
                             if k not in _TIMES))
          for s in mon.read_jsonl(spans) if s["ev"] == "span"]
    return out, rows, names, sp


@pytest.mark.parametrize("kw", [
    dict(slots=2, prefill_chunk=4),
    dict(slots=3, prefill_chunk=4, megastep=4),
    dict(slots=2, prefill_chunk=4, speculative=True, spec_gamma=2),
    dict(slots=2, prefill_chunk=4, num_blocks=7, block_size=8)])
def test_engine_rows_metrics_and_spans_equal_the_jax_engine(kw, tmp_path):
    """The port's recorder rows (serving_step and serving_request, in
    order), metric names and span names with their attribute keys equal
    the JAX engine's on the same requests: plain, megastep, speculative
    and a small pool that preempts."""
    import numpy as np
    from torch_fleet_harness import assert_same_tokens, lm_pair, requests
    jlm, tlm = lm_pair()
    reqs = requests(np.random.RandomState(5), 7, min_new=6, max_new=14)
    want = _engine_run("paddle_tpu", jlm, reqs, tmp_path, **kw)
    got = _engine_run("paddle_tpu_torch", tlm, reqs, tmp_path,
                      device="cpu", **kw)
    assert_same_tokens(want[0], got[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert any(r["ev"] == "serving_request" for r in got[1])
