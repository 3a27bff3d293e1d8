"""Incident forensics plane (): tail-based trace retention,
fleet black-box DUMP capture, and the ``monitor bundle`` CLI.

Tiers:

  * Tail-retention units (no sockets, sub-second): error/slow root
    promotion persists the WHOLE buffered trace, clean sampled-out
    traces never reach the log, ``retain_trace`` is idempotent and
    marks a trace so spans closing AFTER the decision persist too,
    ring LRU + per-trace span-cap bounds.
  * DUMP verb conformance + per-role reply units against live servers
    (pserver / membership KV / telemetry).
  * A golden bundle: hand-built incident + local capture ->
    CRC-manifested bundle, the CLI renders the offender-centered
    timeline (exit 0), a corrupted part fails verification (exit 1),
    a missing bundle is a usage error (exit 2).
  * THE CHAOS GATE (tier-1 smoke + ``-m slow`` soak, seeded like
    test_fleet.py): 3 replicas behind a Router, head sampling
    effectively OFF (every span sampled out at emission), one replica
    KILLED mid-traffic -> its in-flight requests retire with
    attributed error rows; a burn-rule replay opens the incident
    autonomously, the attached capture hook assembles a CRC-verified
    bundle from the surviving fleet, and the render shows the
    offender's complete cross-process span tree recovered ENTIRELY by
    tail retention + ring capture.
"""

import json
import os
import socket
import time

import pytest

from paddle_tpu_torch import monitor, trace
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.distributed.membership import KVServer, KVClient
from paddle_tpu_torch.distributed.rpc import VariableServer
from paddle_tpu_torch.monitor import forensics as fx
from paddle_tpu_torch.monitor import metrics as mm
from paddle_tpu_torch.monitor import signals as sg
from paddle_tpu_torch.monitor.__main__ import main as mon_main
from paddle_tpu_torch.monitor.collector import TelemetryServer
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.fleet import Router
from paddle_tpu_torch.trace import runtime as trt

from torch_fleet_harness import VOCAB, engines_on_the_cpu, lm_pair


@pytest.fixture(autouse=True)
def _cpu_engines(monkeypatch):
    engines_on_the_cpu(monkeypatch)


@pytest.fixture(autouse=True)
def _teardown():
    yield
    trace.disable()
    faults.disarm()
    monitor.disable()


@pytest.fixture(scope="module")
def lm():
    """The port's decode model over a JAX-initialized LM's weights."""
    return lm_pair()[1]


def _spans(log):
    rows = [json.loads(line) for line in open(log)]
    return [r for r in rows if r.get("ev") == "span"]


# -- tail-based retention (units) -------------------------------------------

def test_tail_error_root_promotes_whole_trace(tmp_path):
    """The tentpole policy: a sampled-out trace whose ROOT closes with
    an error is retroactively promoted — every buffered span (children
    included, full fidelity) lands in the log; a clean sampled-out
    trace never does."""
    log = str(tmp_path / "t.jsonl")
    trace.enable(log_path=log, sample_rate=1e-9, tail_window=64)
    before = mm.registry().get(
        "ptpu_trace_retained_total").value(reason="error")
    with trace.span("clean.root"):
        with trace.span("clean.child"):
            pass
    with trace.span("bad.root") as root:
        bad_tid = trace.active_trace_id()
        with trace.span("bad.child", step=3):
            pass
        root.annotate(error="RuntimeError('boom')")
    spans = _spans(log)
    assert {s["name"] for s in spans} == {"bad.root", "bad.child"}
    assert all(s["trace"] == bad_tid for s in spans)
    child = next(s for s in spans if s["name"] == "bad.child")
    assert child["attrs"]["step"] == 3       # full fidelity, not a stub
    after = mm.registry().get(
        "ptpu_trace_retained_total").value(reason="error")
    assert after == before + 1


def test_tail_slow_root_promotes(tmp_path):
    log = str(tmp_path / "t.jsonl")
    trace.enable(log_path=log, sample_rate=1e-9, tail_window=64,
                 tail_slow_ms=5.0)
    with trace.span("fast.root"):
        pass
    with trace.span("slow.root"):
        slow_tid = trace.active_trace_id()
        time.sleep(0.02)
    spans = _spans(log)
    assert [s["name"] for s in spans] == ["slow.root"]
    assert spans[0]["trace"] == slow_tid


def test_retain_trace_idempotent_and_late_spans(tmp_path):
    """The incident path: ``retain_trace`` promotes a finished
    sampled-out trace exactly once, and marking a STILL-OPEN trace
    retained routes its later spans straight to the log."""
    log = str(tmp_path / "t.jsonl")
    trace.enable(log_path=log, sample_rate=1e-9, tail_window=64)
    with trace.span("req"):
        tid = trace.active_trace_id()
        with trace.span("step"):
            pass
    assert _spans(log) == []
    assert trace.retain_trace(tid, "offender") is True
    assert len(_spans(log)) == 2
    assert trace.retain_trace(tid, "offender") is False   # idempotent
    assert len(_spans(log)) == 2
    # decision arrives while the trace is still open: the spans that
    # close afterwards persist without re-buffering
    with trace.span("req2"):
        tid2 = trace.active_trace_id()
        assert trace.retain_trace(tid2) is True
        with trace.span("late.child"):
            pass
    names = [s["name"] for s in _spans(log)]
    assert "late.child" in names and "req2" in names
    # ring off -> the whole surface degrades to a no-op
    trace.enable(log_path=str(tmp_path / "t2.jsonl"),
                 sample_rate=1e-9, tail_window=0)
    with trace.span("r3"):
        t3 = trace.active_trace_id()
    assert trace.tail_armed() is False
    assert trace.retain_trace(t3) is False
    assert [r for r in trace.tail_dump() if r["ev"] == "span"] == []


def test_tail_ring_lru_and_span_cap():
    ring = trt._TailRing(2, span_cap=3)
    for tid in ("a", "b", "c"):
        ring.append(tid, {"trace": tid}, False)
    assert len(ring) == 2
    assert ring.pop("a") is None             # LRU-evicted by c
    for _ in range(5):
        ring.append("c", {"trace": "c"}, False)
    ent = ring.pop("c")
    assert len(ent["rows"]) == 3 and ent["dropped"] == 3
    # a sampled span marks the whole trace head-sampled: promotion of
    # an already-persisted trace must be a no-op
    ring.append("d", {"trace": "d"}, False)
    ring.append("d", {"trace": "d"}, True)
    assert ring.pop("d")["sampled"] is True


def test_tail_dump_rows_are_merge_consumable(tmp_path):
    """Every DUMP row carries ``ev`` AND ``ts`` (the tolerant JSONL
    reader drops rows lacking either) and spans survive promotion:
    a trace retained moments before the capture must still appear."""
    trace.enable(log_path=str(tmp_path / "t.jsonl"),
                 sample_rate=1e-9, tail_window=64)
    with trace.span("victim"):
        tid = trace.active_trace_id()
    trace.retain_trace(tid, "offender")      # pops the ring...
    rows = trace.tail_dump()
    assert all("ev" in r and "ts" in r for r in rows)
    spans = [r for r in rows if r["ev"] == "span"]
    assert any(s["trace"] == tid for s in spans)   # ...but still dumped
    assert rows[0]["ev"] == "proc_meta"


# -- DUMP verb + per-role replies -------------------------------------------

def test_dump_verb_conformance():
    """Satellite: DUMP is a first-class fleet verb — fault-injectable
    and classified idempotent for the retry policy. Every verb of the
    autoscaler's control server (serving.autoscale, ) must be
    classed the same way — the RT02 verb-conformance lint holds its
    dispatch loop to the fleet contract."""
    from paddle_tpu_torch.resilience import retry
    assert "DUMP" in faults._DEFAULT_OPS
    assert retry.VERB_CLASSES["DUMP"] == "idempotent"
    for op in ("METR", "HLTH", "DUMP", "CLKS"):
        assert op in faults._DEFAULT_OPS, op
        assert retry.VERB_CLASSES[op] == "idempotent", op
    assert retry.VERB_CLASSES["EXIT"] == "admin"
    # the rollout controller's verdict read (serving.rollout) joins
    # the same contract: fault-injectable + idempotent
    assert "VERD" in faults._DEFAULT_OPS
    assert retry.VERB_CLASSES["VERD"] == "idempotent"


def _dump(endpoint, body=b"{}"):
    host, port = endpoint.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=5)
    try:
        rpc._send_msg(s, "DUMP", "", body)
        op, _name, payload = rpc._recv_msg(s)
        assert op == "VAL", op
        return json.loads(bytes(payload).decode())
    finally:
        s.close()


def test_dump_reply_pserver_kv_telemetry(tmp_path):
    monitor.enable(log_path=str(tmp_path / "m.jsonl"))
    trace.enable(log_path=str(tmp_path / "t.jsonl"),
                 sample_rate=1e-9, tail_window=64)
    with trace.span("warm"):
        pass
    srv = VariableServer(fan_in=1)
    srv.start()
    kvs = KVServer(sweep_interval=0.05).start()
    tel = TelemetryServer(role="replica").start()
    kv = KVClient(kvs.endpoint)
    try:
        kv.put("k1", "v1")
        out = _dump("127.0.0.1:%d" % srv.port)
        assert out["role"] == "pserver" and out["pid"] == os.getpid()
        assert "round" in out["state"] and "vars" in out["state"]
        assert any(r.get("ev") == "span" for r in out["spans"])
        assert "snapshot" in out and "flags" in out
        out = _dump(kvs.endpoint)
        assert out["role"] == "kv"
        assert out["state"]["keys"] >= 1
        assert out["state"]["registry"].get("k1") == "v1"
        out = _dump(tel.endpoint, body=b'{"spans_max": 1}')
        assert out["role"] == "replica"
        assert len([r for r in out["spans"]
                    if r.get("ev") == "span"]) <= 1
        # the autoscaler's control loop is a fleet citizen too: its
        # DUMP carries the controller state snapshot
        from paddle_tpu_torch.serving.autoscale import ControlServer
        ctl = ControlServer(lambda: {"desired": 2, "live": 2,
                                     "phase": "steady"}).start()
        try:
            out = _dump(ctl.endpoint)
            assert out["role"] == "autoscaler"
            assert out["state"]["desired"] == 2
            assert out["state"]["phase"] == "steady"
        finally:
            ctl.stop()
        # ...and so is the rollout controller (serving.rollout): DUMP
        # carries its state, VERD its per-phase verdicts
        from paddle_tpu_torch.serving.rollout import (RolloutServer,
                                                      fetch_verdicts)
        rctl = RolloutServer(
            lambda: {"phase": "shadow", "version": "v2"},
            lambda: {"phase": "shadow", "version": "v2",
                     "verdicts": {}}).start()
        try:
            out = _dump(rctl.endpoint)
            assert out["role"] == "rollout"
            assert out["state"]["phase"] == "shadow"
            assert out["state"]["version"] == "v2"
            verd = fetch_verdicts(rctl.endpoint)
            assert verd["phase"] == "shadow"
            assert verd["verdicts"] == {}
        finally:
            rctl.stop()
    finally:
        kv.shutdown_server()
        kv.close()
        tel.stop()
        srv.stop()


# -- the golden bundle + CLI exit codes -------------------------------------

def _golden_bundle(tmp_path):
    """Local-capture bundle around a hand-built incident: a sampled-out
    client dispatch trace joined (by rid) to a separate sampled-out
    erroring request root — exactly the two-root shape the fleet
    produces."""
    trace.enable(log_path=str(tmp_path / "t.jsonl"),
                 sample_rate=1e-9, tail_window=64, proc="coord")
    with trace.span("router.dispatch", rid="r-7",
                    endpoint="127.0.0.1:9"):
        tid_client = trace.active_trace_id()
    with trace.span("serving.request", rid="r-7") as sp:
        sp.annotate(error="RuntimeError('boom')")
    incident = {"rule": "burn:error_rate:2s/8s", "severity": "page",
                "state": "FIRING", "ts": time.time(),
                "figures": {"short": 0.2, "long": 0.11},
                "offenders": [{"trace": tid_client, "proc": "router",
                               "why": "error"}]}
    path = fx.capture(incident=incident, endpoints=[],
                      out_dir=str(tmp_path / "bundles"))
    return path, tid_client


def test_golden_bundle_verify_and_render(tmp_path, capsys):
    before = mm.registry().get(
        "ptpu_forensics_bundles_total").value()
    path, tid = _golden_bundle(tmp_path)
    assert fx.last_bundle() == path
    assert mm.registry().get(
        "ptpu_forensics_bundles_total").value() == before + 1
    man = fx.load_manifest(path)
    assert man["offenders"] == [tid]
    assert man["missing"] == []
    assert any(e["role"] == "coordinator" for e in man["parts"])
    assert fx.verify(path) == []
    assert mon_main(["bundle", path]) == 0
    out = capsys.readouterr().out
    assert "manifest verified" in out
    assert "incident: burn:error_rate:2s/8s" in out
    assert "offender timeline" in out
    # the rid join pulled BOTH roots into the offender tree, with the
    # error annotated
    assert "router.dispatch" in out and "serving.request" in out
    assert "rid=r-7" in out and "ERROR" in out


def test_bundle_cli_exit_codes(tmp_path, capsys):
    path, _tid = _golden_bundle(tmp_path)
    part = next(e["file"] for e in fx.load_manifest(path)["parts"])
    with open(os.path.join(path, part), "ab") as f:
        f.write(b"bitrot")
    assert fx.verify(path) != []
    assert mon_main(["bundle", path]) == 1
    assert "CORRUPT" in capsys.readouterr().out
    # missing / not-a-bundle directories are usage errors
    assert mon_main(["bundle", str(tmp_path / "nope")]) == 2
    notb = tmp_path / "notb"
    notb.mkdir()
    (notb / fx.BUNDLE_MANIFEST).write_text('{"format": "other"}')
    assert mon_main(["bundle", str(notb)]) == 2


def test_capture_records_missing_endpoint(tmp_path):
    """Drop-if-slow/dead semantics: an unreachable endpoint costs the
    bundle one part (a manifest ``missing`` entry + failure counter),
    never the capture."""
    before = mm.registry().get(
        "ptpu_forensics_dump_failures_total").value(role="replica")
    path = fx.capture(endpoints=[("replica", "127.0.0.1:1")],
                      deadline_s=0.5, out_dir=str(tmp_path / "b"))
    man = fx.load_manifest(path)
    assert [m["role"] for m in man["missing"]] == ["replica"]
    assert fx.verify(path) == []
    assert mm.registry().get(
        "ptpu_forensics_dump_failures_total").value(role="replica") \
        == before + 1


def test_watch_incidents_line(tmp_path, monkeypatch):
    """Satellite: the watch dashboards append an incidents line only
    when there is something to show (quiet fleets keep the historical
    frame)."""

    class _Sig:
        _rules = []

        def __init__(self, act):
            self._act = act

        def active(self):
            return self._act

    monkeypatch.setattr(fx, "_LAST_BUNDLE", None)
    assert fx.incidents_line(_Sig({})) is None
    fx._set_last("/tmp/b/bundle-7-1")
    line = fx.incidents_line(_Sig({"burn:error_rate:2s/8s":
                                   {"severity": "page"}}))
    assert "1 active" in line
    assert "burn:error_rate:2s/8s" in line
    assert "bundle /tmp/b/bundle-7-1" in line
    assert "none active" in fx.incidents_line(_Sig({}))
    # render_frame passes it through under the alerts line
    from paddle_tpu_torch.monitor.watch import WatchState, render_frame
    frame = render_frame(WatchState(window=8), "x",
                         incidents_line=line)
    assert frame.splitlines()[-1] == line


def test_flags_registered():
    from paddle_tpu_torch import flags
    assert flags.get_flag("trace_tail_window") == 256
    assert flags.get_flag("trace_tail_slow_ms") == 0.0
    assert flags.get_flag("forensics_dir") == ""


# -- the chaos gate ----------------------------------------------------------

DESIRED = 3


def _requests(rng, n, max_prompt=8, min_new=4, max_new=12):
    reqs = []
    for _ in range(n):
        plen = int(rng.randint(1, max_prompt + 1))
        prompt = [1] + rng.randint(3, VOCAB, plen - 1).tolist()
        reqs.append((prompt, int(rng.randint(min_new, max_new + 1))))
    return reqs


def _run_forensics_chaos(lm, reqs, seed, tmp_path, tag):
    """Stand up KV + 3 replicas + supervisor + router with head
    sampling effectively OFF, kill replica:0 mid-traffic, and prove
    the detect->diagnose loop end to end: attributed error rows ->
    burn incident FIRING -> autonomous capture -> CRC-verified bundle
    whose render shows the offender's cross-process span tree, every
    span of which was sampled out at emission."""
    from paddle_tpu_torch.monitor import runtime as monrt

    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    tlog = str(tmp_path / ("spans-%s.jsonl" % tag))
    bundles = str(tmp_path / ("bundles-%s" % tag))
    monitor.enable(log_path=str(tmp_path / ("mon-%s.jsonl" % tag)))
    trt.enable(log_path=tlog, sample_rate=1e-9, proc="fleet-" + tag,
               tail_window=512)

    def spawn():
        return fleet.Replica(kv, lm, desired=DESIRED, slots=2,
                             prefill_chunk=4, ttl=0.4)

    cells, sup, router = [], None, None
    try:
        cells = [spawn() for _ in range(DESIRED)]
        plan = faults.arm(
            {"kill": [{"target": "replica:0", "after": 3}]}, seed=seed)
        sup = fleet.Supervisor(kv, spawn, desired=DESIRED,
                               interval=0.1).start()
        router = Router(kvs.endpoint, window=3, max_queue=64,
                        stall_timeout=1.0, refresh_interval=0.05,
                        client_timeout=0.8, name="router-" + tag)
        router.wait_for_replicas(DESIRED, timeout=15)
        handles = [router.submit(p, m, session="s%d" % (i % 4))
                   for i, (p, m) in enumerate(reqs)]
        out = [h.result(timeout=120) for h in handles]
        assert len(out) == len(reqs)
        assert any(k == "kill" for k, _ in plan.trips), plan.trips
        assert router.stats["resubmissions"] >= 1, router.stats

        # the crash retired its in-flight requests with ATTRIBUTED
        # error rows: trace ids stamped despite sampled-out contexts
        # (the tail_armed widening), which is what lets the incident
        # name offenders at a 1-in-N sampling rate
        _cur, rows, _lost = monrt.recorder().events_since(None)
        err = [r for r in rows if r.get("ev") == "serving_request"
               and r.get("error") and r.get("trace")]
        assert err, "kill produced no attributed error rows"

        # detect -> diagnose, autonomously: replay the recorded stream
        # through a burn rule with the capture hook attached — the
        # FIRING transition promotes the offender traces and assembles
        # the bundle from the (lease-discovered) surviving fleet
        sig = sg.Signals(spec={"objectives": [
            {"metric": "error_rate", "target": 0.98,
             "windows": [{"short_s": 2.0, "long_s": 8.0,
                          "burn_rate": 2.0, "severity": "page"}]}]})
        fx.attach(sig, kv_endpoint=kvs.endpoint, deadline_s=2.0,
                  out_dir=bundles)
        transitions = sig.replay(rows)
        firing = [t for t in transitions if t["state"] == "FIRING"
                  and t.get("offenders")]
        assert firing, transitions
        off_traces = {o["trace"] for t in firing
                      for o in t["offenders"] if o.get("trace")}
        assert off_traces & {r["trace"] for r in err}

        # tail retention really ran: the erroring roots were promoted
        # (head sampling could not have persisted them at 1e-9)
        assert mm.registry().get("ptpu_trace_retained_total").value(
            reason="error") >= 1

        # the bundle: CRC-intact, fleet parts captured over DUMP, and
        # the render reconstructs the offender's cross-process tree
        bundle = fx.last_bundle()
        assert bundle and bundle.startswith(bundles)
        assert fx.verify(bundle) == []
        man = fx.load_manifest(bundle)
        roles = [e["role"] for e in man["parts"]]
        assert "coordinator" in roles
        assert roles.count("replica") >= 2, (roles, man["missing"])
        lines = []
        assert fx.render(bundle, out=lines.append) == 0
        text = "\n".join(lines)
        assert "offender timeline" in text, text
        assert "serving.request" in text
        assert "router.dispatch" in text
        assert "ERROR" in text
        # the incidents line points at the bundle (and names the rule
        # while the incident is still active — the replay may have
        # already resolved it once the post-crash rounds ran clean)
        line = fx.incidents_line(sig)
        assert line.startswith("incident") and bundle in line
        if sig.active():
            assert "error_rate" in line
        return plan
    finally:
        faults.disarm()
        if router is not None:
            router.close()
        if sup is not None:
            sup.stop()
        for c in cells + (sup.cells if sup is not None else []):
            try:
                c.shutdown()
            except Exception:
                pass
        trt.disable()
        monitor.disable()
        try:
            kv.shutdown_server()
            kv.close()
        except OSError:
            pass


def test_forensics_fleet_chaos_smoke(rng, lm, tmp_path):
    """Tier-1 gate: seeded kill mid-traffic -> incident OPEN
    autonomously produces a CRC-verified bundle whose render shows the
    offender's complete cross-process span tree, with every span
    sampled out at emission."""
    reqs = _requests(rng, 18, min_new=6, max_new=14)
    _run_forensics_chaos(lm, reqs, seed=1301, tmp_path=tmp_path,
                         tag="smoke")


@pytest.mark.slow
def test_forensics_chaos_soak_three_runs(rng, lm, tmp_path):
    """Acceptance soak: the seeded scenario passes 3 consecutive times
    (fresh fleet, fresh bundle each time)."""
    reqs = _requests(rng, 18, min_new=6, max_new=14)
    for attempt in range(3):
        _run_forensics_chaos(lm, reqs, seed=1301, tmp_path=tmp_path,
                             tag="soak%d" % attempt)


# -- the port against the JAX package ---------------------------------------

# manifest fields that carry times, clocks, process identity or paths
_MAN_TIMES = {"ts", "created", "created_ts", "t", "pid", "path", "dir",
              "incarnation", "uptime_s", "bytes", "crc32", "crc",
              "sha256", "size", "elapsed_s", "capture_s", "endpoint",
              "spans_crc32", "incident_crc32"}


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in _MAN_TIMES}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _bundle_with(pkg, tmp_path):
    """The golden incident captured by package ``pkg``'s tracer and
    forensics; returns (manifest, rendered CLI output)."""
    import importlib
    tr = importlib.import_module(pkg + ".trace")
    fxm = importlib.import_module(pkg + ".monitor.forensics")
    base = tmp_path / pkg
    base.mkdir()
    tr.enable(log_path=str(base / "t.jsonl"), sample_rate=1e-9,
              tail_window=64, proc="coord")
    try:
        with tr.span("router.dispatch", rid="r-7", endpoint="127.0.0.1:9"):
            tid = tr.active_trace_id()
        with tr.span("serving.request", rid="r-7") as sp:
            sp.annotate(error="RuntimeError('boom')")
        incident = {"rule": "burn:error_rate:2s/8s", "severity": "page",
                    "state": "FIRING", "ts": 1_000_000.0,
                    "figures": {"short": 0.2, "long": 0.11},
                    "offenders": [{"trace": tid, "proc": "router",
                                   "why": "error"}]}
        path = fxm.capture(incident=incident, endpoints=[],
                           out_dir=str(base / "bundles"))
    finally:
        tr.disable()
    man = fxm.load_manifest(path)
    assert fxm.verify(path) == []
    man["offenders"] = ["<trace>" for _ in man["offenders"]]
    return man, path


def test_bundle_manifest_equals_the_jax_package(tmp_path):
    """The same incident captured by each package: the bundle manifests
    agree in every field but times, clocks, sizes and checksums, and
    each package's bundle verifies under the other's ``verify``."""
    from paddle_tpu.monitor import forensics as jfx
    want, jpath = _bundle_with("paddle_tpu", tmp_path)
    got, tpath = _bundle_with("paddle_tpu_torch", tmp_path)
    assert _strip(got) == _strip(want)
    assert sorted(want) == sorted(got)
    assert jfx.verify(tpath) == []
    assert fx.verify(jpath) == []
