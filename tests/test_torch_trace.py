"""paddle_tpu_torch.trace: cross-process distributed tracing.

Covers: SpanContext inject/extract
through a LIVE loopback RPC pair, old-frame (headerless) compatibility
in both directions, the NTP-midpoint clock-offset estimator on
synthetic skew, a merge-CLI golden fixture where nesting only holds
AFTER skew correction, retry attempts as children of one logical client
span, executor root spans + monitor trace-id stamping, the satellite
CLI/profiler behaviors, and the tier-1 smoke: a zoo-MLP trainer against
a live master+pserver in a SECOND real process, each writing its own
span log, merged into one Perfetto timeline where the server GET span
nests inside its client span.
"""

import itertools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import monitor, trace
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.distributed.master import MasterClient
from paddle_tpu_torch.distributed.rpc import RPCClient, VariableServer
from paddle_tpu_torch.models.mlp import mlp
from paddle_tpu_torch.resilience import Policy, faults
from paddle_tpu_torch.trace import clock as tclock
from paddle_tpu_torch.trace import merge as tmerge
from paddle_tpu_torch.trace import runtime as trt
from paddle_tpu_torch.trace.__main__ import main as trace_cli


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """Fresh default programs, scope and names of the port for every
    test (tests/conftest.py resets the JAX package's)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), \
            fluid.scope_guard(fluid.Scope()), fluid.unique_name.guard():
        yield


@pytest.fixture(autouse=True)
def _trace_teardown():
    yield
    trace.disable()
    faults.disarm()
    monitor.disable()


def _spans(log):
    rows = [json.loads(line) for line in open(log)]
    return [r for r in rows if r.get("ev") == "span"]


# -- wire format -----------------------------------------------------------

def test_wire_header_roundtrip_and_headerless(tmp_path):
    a, b = socket.socketpair()
    try:
        # old (headerless) frame parses with and without want_ctx
        rpc._send_msg(a, "GET", "w")
        op, name, payload, ctx = rpc._recv_msg(b, want_ctx=True)
        assert (op, name, ctx) == ("GET", "w", None)

        trace.enable(log_path=str(tmp_path / "t.jsonl"))
        # armed + ambient sampled span -> context block round-trips
        with trace.span("root"):
            sent = trace.current_span().ctx.span_id
            rpc._send_msg(a, "GET", "w")
        op, name, payload, ctx = rpc._recv_msg(b, want_ctx=True)
        assert (op, name) == ("GET", "w") and ctx is not None
        sc = trace.extract(ctx)
        assert sc is not None and sc.span_id == sent and sc.sampled

        # a receiver NOT asking for context still consumes the block
        # (the reply direction / a tracing-disarmed process)
        with trace.span("root2"):
            rpc._send_msg(a, "OK", "", b"payload")
        assert rpc._recv_msg(b) == ("OK", "", bytearray(b"payload"))

        # armed but NO ambient span -> byte-identical old frames
        rpc._send_msg(a, "GET", "w")
        raw = rpc._recv_exact(b, 12)
        assert bytes(raw[:4]) == b"GET "
        rpc._recv_exact(b, 1)                       # drain the name

        # sampled-out root with the tail ring armed (the default) ->
        # the context block still travels, flagged sampled=0, so a
        # downstream retention promotion can recover the whole trace
        trace.enable(log_path=str(tmp_path / "t2.jsonl"),
                     sample_rate=1e-12)
        with trace.span("root3"):
            tid = trace.active_trace_id()
            rpc._send_msg(a, "GET", "w")
        op, name, payload, ctx = rpc._recv_msg(b, want_ctx=True)
        assert (op, name) == ("GET", "w") and ctx is not None
        sc = trace.extract(ctx)
        assert sc is not None and sc.trace_id == tid and not sc.sampled

        # sampled-out root with the ring OFF -> headerless, exactly
        # the historical frames (old peers stay safe at any sampling
        # rate when tail retention is disabled)
        trace.enable(log_path=str(tmp_path / "t3.jsonl"),
                     sample_rate=1e-12, tail_window=0)
        with trace.span("root4"):
            rpc._send_msg(a, "GET", "w")
        raw = rpc._recv_exact(b, 12)
        assert bytes(raw[:4]) == b"GET "
        rpc._recv_exact(b, 1)
    finally:
        a.close()
        b.close()


def test_extract_never_raises():
    assert trace.extract(None) is None
    assert trace.extract(b"garbage") is None
    assert trace.extract(b"\xff\xfe:oops") is None
    assert trace.extract(b"::0") is None
    sc = trace.extract(b"aa:bb:0")
    assert sc.trace_id == "aa" and not sc.sampled


# -- live loopback RPC pair ------------------------------------------------

def test_span_propagation_through_live_rpc(tmp_path):
    log = str(tmp_path / "t.jsonl")
    trace.enable(log_path=log, proc="both", clock_interval=0.0)
    srv = VariableServer(fan_in=1)
    srv.start()
    cli = RPCClient("127.0.0.1:%d" % srv.port)
    try:
        cli.put_var("w", np.ones((4, 4), np.float32))
        with trace.span("round", step=0):
            cli.get_var("w")
    finally:
        cli.close()
        srv.stop()
    trace.disable()
    spans = _spans(log)
    server = next(s for s in spans if s["name"] == "pserver.GET")
    client = next(s for s in spans if s["name"] == "rpc.get")
    root = next(s for s in spans if s["name"] == "round")
    # the injected context linked server -> client verb -> root
    assert server["parent"] == client["span"]
    assert client["parent"] == root["span"]
    assert server["trace"] == client["trace"] == root["trace"]
    # clock probes landed (interval 0 = every opportunity) and map to
    # the registered server port
    rows = [json.loads(l) for l in open(log)]
    clocks = [r for r in rows if r["ev"] == "clock"]
    ports = {r["port"] for r in rows if r["ev"] == "server_port"}
    assert clocks and srv.port in ports
    assert all(abs(c["offset"]) <= max(c["rtt"], 0.5) for c in clocks)


def test_disarmed_client_against_armed_server(tmp_path):
    # "old client" direction: frames WITHOUT the header dispatch
    # correctly on a process whose tracing is armed
    trace.enable(log_path=str(tmp_path / "t.jsonl"), proc="server")
    srv = VariableServer(fan_in=1)
    srv.start()
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    try:
        import struct
        payload = rpc.serialize_var(np.arange(6, dtype=np.float32))
        name = b"w"
        sock.sendall(struct.pack("<4sII", b"PUT ", len(name),
                                 len(payload)) + name + payload)
        head = rpc._recv_exact(sock, 12)
        assert bytes(head[:4]) == b"OK  "   # reply is headerless too
    finally:
        sock.close()
        srv.stop()


# -- clock offset ----------------------------------------------------------

def test_clock_midpoint_on_synthetic_skew():
    # server clock 5s AHEAD, symmetric 200ms round trip
    off, rtt = tclock.midpoint_offset(100.0, 105.1, 100.2)
    assert abs(off - 5.0) < 1e-9
    assert abs(rtt - 0.2) < 1e-9
    # behind works too
    off, _ = tclock.midpoint_offset(100.0, 96.9, 100.2)
    assert abs(off + 3.2) < 1e-9


def test_clock_probe_records_and_rate_limits(tmp_path):
    log = str(tmp_path / "t.jsonl")
    t = trace.enable(log_path=log, clock_interval=3600.0)
    off = tclock.probe(t, "peer:1", lambda: time.time() + 5.0)
    assert off is not None and abs(off - 5.0) < 0.5
    # rate-limited: the second probe within the interval is skipped
    assert tclock.probe(t, "peer:1", lambda: time.time()) is None
    trace.disable()
    rows = [json.loads(l) for l in open(log) if '"clock"' in l]
    assert len(rows) == 1 and abs(rows[0]["offset"] - 5.0) < 0.5


# -- merge golden fixture --------------------------------------------------

_T, _A, _B, _S = "t" * 16, "a" * 16, "b" * 16, "c" * 16


def _write_skew_fixture(tmp_path):
    client = tmp_path / "trainer.jsonl"
    server = tmp_path / "ps.jsonl"
    crows = [
        {"ts": 1.0, "ev": "proc_meta", "pid": 111, "proc": "trainer"},
        {"ts": 1.0, "ev": "span", "trace": _T, "span": _A,
         "parent": None, "name": "round", "t0": 1000.0, "dur": 0.1,
         "pid": 111, "proc": "trainer", "tid": 1},
        {"ts": 1.0, "ev": "span", "trace": _T, "span": _B,
         "parent": _A, "name": "rpc.get", "t0": 1000.01, "dur": 0.05,
         "pid": 111, "proc": "trainer", "tid": 1,
         "attrs": {"endpoint": "127.0.0.1:9999"}},
        {"ts": 1.0, "ev": "clock", "peer": "127.0.0.1:9999",
         "offset": 5.0, "rtt": 0.001, "pid": 111, "proc": "trainer"},
    ]
    # the server's clock runs 5s AHEAD: raw t0 lies OUTSIDE the client
    # span; only skew correction nests it
    srows = [
        {"ts": 1.0, "ev": "server_port", "port": 9999, "pid": 222,
         "proc": "pserver"},
        {"ts": 1.0, "ev": "span", "trace": _T, "span": _S,
         "parent": _B, "name": "pserver.GET", "t0": 1005.02,
         "dur": 0.02, "pid": 222, "proc": "pserver", "tid": 9},
    ]
    client.write_text("\n".join(json.dumps(r) for r in crows) + "\n")
    server.write_text("\n".join(json.dumps(r) for r in srows) + "\n"
                      + '{"ts": 2.0, "ev": "sp')   # torn tail
    return str(client), str(server)


def test_merge_golden_fixture_skew_corrected_nesting(tmp_path):
    client, server = _write_skew_fixture(tmp_path)
    out = str(tmp_path / "timeline.json")
    assert trace_cli(["merge", client, server, "-o", out]) == 0
    merged = json.load(open(out))
    info = merged["otherData"]["paddle_tpu_torch.trace"]
    assert info["reference_pid"] == 111
    assert abs(info["clock_offsets"]["222"
               if "222" in info["clock_offsets"] else 222] - 5.0) < 1e-9
    assert info["skipped_lines"] == 1          # tolerated the torn tail
    events = merged["traceEvents"]
    lanes = {e["pid"]: e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert "trainer (pid 111)" in lanes.values()
    assert "pserver (pid 222)" in lanes.values()
    get = next(e for e in events if e.get("ph") == "X"
               and e["name"] == "rpc.get")
    ps = next(e for e in events if e.get("ph") == "X"
              and e["name"] == "pserver.GET")
    # CORRECTED nesting: server handling inside the client verb span
    assert get["ts"] <= ps["ts"]
    assert ps["ts"] + ps["dur"] <= get["ts"] + get["dur"]
    # without correction it would NOT nest (5s of skew >> 50ms span)
    raw_gap = (1005.02 - 1000.01) * 1e6
    assert raw_gap > get["dur"]
    # parent linkage survived into args
    assert ps["args"]["parent"] == get["args"]["span"] == _B
    # cross-process flow arrow present
    assert any(e.get("ph") == "s" for e in events)
    assert any(e.get("ph") == "f" for e in events)


def test_stats_cli_on_fixture(tmp_path, capsys):
    client, server = _write_skew_fixture(tmp_path)
    assert trace_cli(["stats", client, server, "--json"]) == 0
    s = json.loads(capsys.readouterr().out)
    verbs = {v["name"]: v for v in s["verbs"]}
    assert verbs["rpc.get"]["count"] == 1
    assert abs(verbs["rpc.get"]["p50_s"] - 0.05) < 1e-9
    assert s["rounds"]["count"] == 1
    assert abs(s["rounds"]["mean_by_verb_s"]["rpc.get"] - 0.05) < 1e-9
    # rpc.get dominated the only round
    assert s["stragglers"][0]["who"].startswith("rpc.get@")
    # text renderer too
    assert trace_cli(["stats", client, server]) == 0
    out = capsys.readouterr().out
    assert "rpc.get" in out and "straggler" in out


def test_merge_port_collision_resolved_by_endpoint_or_dropped(tmp_path):
    """Two hosts reusing port 7000: an exact endpoint match resolves
    the clock sample; a bare-port match against a COLLIDING port is
    dropped with a warning, never silently credited to the wrong
    process."""
    def w(name, rows):
        p = tmp_path / name
        p.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
        return str(p)

    span = {"ts": 1.0, "ev": "span", "trace": _T, "parent": None,
            "dur": 0.1, "tid": 1}
    a = w("ps0.jsonl", [
        {"ts": 1.0, "ev": "server_port", "port": 7000, "pid": 1,
         "proc": "ps0", "endpoint": "hostA:7000"},
        dict(span, span="e" * 16, name="x", t0=10.0, pid=1,
             proc="ps0")])
    b = w("ps1.jsonl", [
        {"ts": 1.0, "ev": "server_port", "port": 7000, "pid": 2,
         "proc": "ps1", "endpoint": "hostB:7000"},
        dict(span, span="f" * 16, name="x", t0=10.0, pid=2,
             proc="ps1")])
    c = w("tr.jsonl", [
        dict(span, span="g" * 16, name="round", t0=10.0, pid=3,
             proc="tr"),
        dict(span, span="h" * 16, name="round", t0=10.2, pid=3,
             proc="tr"),
        {"ts": 1.0, "ev": "clock", "peer": "hostB:7000",
         "offset": 2.0, "rtt": 0.001, "pid": 3, "proc": "tr"},
        {"ts": 1.0, "ev": "clock", "peer": "hostC:7000",
         "offset": 9.0, "rtt": 0.001, "pid": 3, "proc": "tr"}])
    offsets, ref, warnings = tmerge.clock_offsets(
        tmerge.load_logs([a, b, c]))
    assert ref == 3                     # the trainer drives the run
    assert offsets[2] == 2.0            # exact endpoint match
    assert offsets[1] == 0.0            # unreachable, left uncorrected
    assert any("port 7000" in w for w in warnings)      # collision
    assert any("pid 1" in w for w in warnings)          # no clock path


# -- retries as attempt children ------------------------------------------

def test_retry_attempts_are_children_of_one_client_span(tmp_path):
    log = str(tmp_path / "t.jsonl")
    trace.enable(log_path=log, proc="trainer", clock_interval=-1.0)
    srv = VariableServer(fan_in=1)
    srv.start()
    plan = faults.arm({"rpc": {"drop": 1.0, "max": 2, "ops": ["GET"],
                               "ports": [srv.port]}}, seed=7)
    pol = Policy(max_attempts=8, base_delay=0.01, max_delay=0.05,
                 deadline=10.0, seed=3)
    cli = RPCClient("127.0.0.1:%d" % srv.port, retry=pol)
    try:
        cli.put_var("w", np.ones((2,), np.float32))
        with trace.span("round"):
            cli.get_var("w")
    finally:
        faults.disarm()
        cli.close()
        srv.stop()
    trace.disable()
    assert [k for k, _ in plan.trips].count("drop") == 2
    spans = _spans(log)
    verb = next(s for s in spans if s["name"] == "rpc.get")
    attempts = [s for s in spans if s["name"] == "rpc.get.attempt"]
    # one LOGICAL client span; every try one attempt child under it
    assert len(attempts) == 3
    assert all(a["parent"] == verb["span"] for a in attempts)
    assert sorted(a["attrs"]["attempt"] for a in attempts) == [1, 2, 3]
    failed = [a for a in attempts if "error" in a["attrs"]]
    assert len(failed) == 2
    # reconnects annotated the attempts that re-dialed
    assert any(a["attrs"].get("reconnected") for a in attempts)
    assert verb["attrs"]["retries"] == 2
    # the server span nests under the SUCCESSFUL attempt
    server = next(s for s in spans if s["name"] == "pserver.GET")
    winner = next(a for a in attempts if a["attrs"]["attempt"] == 3)
    assert server["parent"] == winner["span"]


# -- executor + monitor integration ----------------------------------------

def test_executor_root_span_and_monitor_trace_id(tmp_path):
    tlog = str(tmp_path / "t.jsonl")
    mlog = str(tmp_path / "m.jsonl")
    trace.enable(log_path=tlog, proc="trainer")
    monitor.enable(log_path=mlog)
    x = fluid.layers.data("x", [4])
    y = fluid.layers.fc(x, 2)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    exe.run(feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[y])
    monitor.disable()
    trace.disable()
    steps = [s for s in _spans(tlog) if s["name"] == "exe.step"]
    assert len(steps) >= 2           # startup + main step, each a root
    assert all(s["parent"] is None for s in steps)
    # monitor flight-recorder step rows joined the fleet timeline
    mrows = monitor.read_jsonl(mlog)
    traced = [e for e in mrows if e["ev"] == "step" and e.get("trace")]
    assert traced
    assert {e["trace"] for e in traced} <= {s["trace"] for s in steps}
    # the new counters registered and ticked
    from paddle_tpu_torch.monitor import runtime as mrt
    assert sum(mrt.TRACE_SPANS.snapshot().values()) >= len(steps)


def test_trace_disarmed_is_inert():
    assert not trace.enabled()
    # null span is reusable and annotate is a no-op
    with trace.span("nothing") as s:
        s.annotate(a=1)
        trace.annotate(b=2)
    assert trace.current_span() is None
    assert trace.active_trace_id() is None


def test_flag_rate_parsing():
    assert trt._parse_rate("") is None
    assert trt._parse_rate("0") is None
    assert trt._parse_rate("off") is None
    assert trt._parse_rate("1") == 1.0
    assert trt._parse_rate("true") == 1.0
    assert trt._parse_rate("0.25") == 0.25
    assert trt._parse_rate("7") == 1.0        # clipped
    assert trt._parse_rate("nonsense") is None


def test_maybe_enable_from_flags(tmp_path):
    from paddle_tpu_torch import flags
    log = str(tmp_path / "flag-{pid}.jsonl")
    flags.set_flag("trace", "0.5")
    flags.set_flag("trace_log", log)
    flags.set_flag("trace_proc", "flagged")
    try:
        t = trt.maybe_enable_from_flags()
        assert t is not None and t.sample_rate == 0.5
        assert t.proc == "flagged"
        assert os.path.exists(log.replace("{pid}", str(os.getpid())))
    finally:
        flags.set_flag("trace", "")
        flags.set_flag("trace_log", "")
        flags.set_flag("trace_proc", "")
        trace.disable()


# -- satellite: the recorder's torn-tail tolerance -------------------------

def test_monitor_cli_tolerates_torn_trailing_line(tmp_path, capsys):
    """The tolerant reader the monitor CLI summarizes with skips a torn
    last line."""
    p = str(tmp_path / "m.jsonl")
    rec = monitor.FlightRecorder(p)
    rec.record("run_meta", pid=1)
    rec.record("step", executor="exe", n=1, dt=0.01, synced=True)
    rec.close()
    with open(p, "a") as f:
        f.write('{"ts": 123.0, "ev": "st')     # writer killed mid-line
    rows, skipped = monitor.read_jsonl_tolerant(p)
    assert [r["ev"] for r in rows] == ["run_meta", "step"]
    assert skipped == 1
    # the strict reader's schema contract is unchanged
    with pytest.raises(ValueError):
        monitor.read_jsonl(p)


# -- satellite: profiler cap visibility ------------------------------------

def test_profiler_capped_trace_reports_dropped(tmp_path, monkeypatch):
    from paddle_tpu_torch import profiler
    profiler.reset_profiler()
    monkeypatch.setattr(profiler, "_TRACE_CAP", 3)
    profiler.start_profiler()
    for i in range(7):
        with profiler.RecordEvent("ev%d" % i):
            pass
    profiler.stop_profiler(profile_path=str(tmp_path / "prof"))
    s = profiler.summary()
    assert s["trace_dropped"] == 4 and s["truncated"]
    assert s["spans"] == 3
    path = str(tmp_path / "c.json")
    profiler.export_chrome_trace(path)
    events = json.load(open(path))["traceEvents"]
    md = [e for e in events
          if e.get("ph") == "M" and e["name"] == "trace_dropped"]
    assert md and md[0]["args"]["trace_dropped"] == 4
    profiler.reset_profiler()
    assert profiler.summary()["trace_dropped"] == 0


# -- tier-1 e2e smoke: two real processes ----------------------------------

_SERVER_PROC = '''\
import os, sys, time
sys.path.insert(0, %(repo)r)
import numpy as np
import paddle_tpu_torch  # PADDLE_TPU_TRACE env arms tracing at import
from paddle_tpu_torch.distributed.master import MasterServer, TaskQueue
from paddle_tpu_torch.distributed.rpc import VariableServer

LR = 0.15

def sgd(store, grads):
    for k, g in grads.items():
        p = k.replace("@GRAD", "")
        if p in store:
            store[p] = store[p] - LR * np.asarray(g)

srv = VariableServer(fan_in=1, optimize_fn=sgd, sync=True,
                     port_file=%(ps_port_file)r)
srv.start()
master = MasterServer(TaskQueue(payloads=list(range(%(n_tasks)d))),
                      port_file=%(master_port_file)r)
master.start()
deadline = time.time() + 120
while not os.path.exists(%(stop_file)r) and time.time() < deadline:
    time.sleep(0.05)
master.stop()
srv.stop()
import paddle_tpu_torch.trace as trace
trace.disable()          # close the span log cleanly
'''


def _wait_for_file(path, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path) and open(path).read().strip():
            return open(path).read().strip()
        time.sleep(0.05)
    raise TimeoutError("no %s after %ss" % (path, timeout))


def test_two_process_merged_timeline(tmp_path):
    """Trainer + pserver as two REAL processes over
    live sockets, each writing its own span log; the merged timeline
    nests the server-side GET dispatch span inside its client RPC span
    (same trace, parent linkage, skew-corrected timestamps)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    n_tasks = 5
    ps_port_file = str(tmp_path / "ps.port")
    master_port_file = str(tmp_path / "master.port")
    stop_file = str(tmp_path / "stop")
    server_log = str(tmp_path / "pserver.jsonl")
    client_log = str(tmp_path / "trainer.jsonl")
    script = tmp_path / "server_proc.py"
    script.write_text(_SERVER_PROC % {
        "repo": repo, "ps_port_file": ps_port_file,
        "master_port_file": master_port_file, "stop_file": stop_file,
        "n_tasks": n_tasks})
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "PADDLE_TPU_TRACE": "1",
                "PADDLE_TPU_TRACE_LOG": server_log,
                "PADDLE_TPU_TRACE_PROC": "pserver",
                "PADDLE_TPU_TRACE_CLOCK_INTERVAL": "0"})
    env.pop("PADDLE_TPU_MONITOR", None)
    proc = subprocess.Popen([sys.executable, str(script)], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        ps_port = int(_wait_for_file(ps_port_file))
        master_port = int(_wait_for_file(master_port_file))
        trace.enable(log_path=client_log, proc="trainer",
                     clock_interval=0.0)

        rng = np.random.RandomState(0)
        proj = rng.randn(16, 4).astype(np.float32)
        main, startup = fluid.Program(), fluid.Program()
        scope = fluid.Scope()
        with fluid.program_guard(main, startup), \
                fluid.scope_guard(scope):
            img = fluid.layers.data("img", [16])
            label = fluid.layers.data("label", [1], dtype="int64")
            _, avg_cost, _ = mlp(img, label, hidden_sizes=(8,),
                                 num_classes=4)
            pgs = fluid.backward.append_backward(avg_cost)
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            params = [p.name for p, _ in pgs]
            grads = [g.name for _, g in pgs]
            cli = RPCClient("127.0.0.1:%d" % ps_port,
                            retry=Policy(deadline=20.0, seed=2))
            mcli = MasterClient("127.0.0.1:%d" % master_port,
                                retry=Policy(deadline=20.0, seed=2))
            for p in params:
                cli.put_var(p, scope.get_numpy(p))
            inc = "%016x" % time.time_ns() + "feedc0de"
            seq = itertools.count()
            done = 0
            while done < n_tasks:
                tid, payload = mcli.get_task()
                if tid is None:
                    if payload == "done":
                        break
                    time.sleep(0.02)
                    continue
                x = rng.rand(8, 16).astype(np.float32)
                y = np.argmax(x @ proj, axis=1).astype(
                    np.int64)[:, None]
                with trace.span("round", step=done):
                    outs = exe.run(main, feed={"img": x, "label": y},
                                   fetch_list=[avg_cost.name] + grads)
                    tag = "t0:i%s:s%d" % (inc, next(seq))
                    for g, gv in zip(grads, outs[1:]):
                        cli.send_var(g, np.asarray(gv), tag=tag)
                    cli.barrier(tag=tag)
                    for p in params:
                        scope.set(p, cli.get_var(p))
                mcli.task_done(tid)
                done += 1
            assert done == n_tasks
            cli.close()
            mcli.close()
        trace.disable()
    finally:
        open(stop_file, "w").write("stop")
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode == 0, out[-3000:]

    # merge the two logs -> one Perfetto timeline
    out_json = str(tmp_path / "timeline.json")
    assert trace_cli(["merge", client_log, server_log,
                      "-o", out_json]) == 0
    merged = json.load(open(out_json))
    info = merged["otherData"]["paddle_tpu_torch.trace"]
    assert info["processes"] >= 2 and not info["warnings"]
    events = merged["traceEvents"]
    lanes = [e["args"]["name"] for e in events
             if e.get("name") == "process_name"]
    assert any("trainer" in n for n in lanes)
    assert any("pserver" in n for n in lanes)

    cspans = {s["span"]: s for s in _spans(client_log)}
    sspans = _spans(server_log)
    server_pid = sspans[0]["pid"]
    client_pid = next(iter(cspans.values()))["pid"]
    off = info["clock_offsets"]
    off = {int(k): v for k, v in off.items()} \
        if isinstance(off, dict) else off
    gets = [s for s in sspans if s["name"] == "pserver.GET"]
    assert gets, [s["name"] for s in sspans]
    # the merge corrects the server's clock by its minimum-RTT probe
    # sample for this process pair, so the corrected offset is wrong by
    # less than that RTT
    data = tmerge.load_logs([client_log, server_log])
    rtts = [float(c["rtt"]) for c in data["clocks"]
            if c.get("pid") == client_pid
            and tmerge._peer_pid(c.get("peer"), data, set()) == server_pid]
    assert rtts, "no clock probe between the two processes"
    eps = min(rtts)
    nested = 0
    for g in gets:
        parent = cspans.get(g["parent"])
        if parent is None:
            continue
        assert parent["name"] in ("rpc.get", "rpc.get.attempt")
        assert parent["pid"] == client_pid
        assert g["trace"] == parent["trace"]
        # skew-corrected causal nesting: the server span starts after
        # the client span sent the request and before it took the
        # reply. (Its end is stamped after the reply is written, so on
        # a loaded host it may close after the client span does.)
        g0 = g["t0"] - off[server_pid]
        p0 = parent["t0"] - off[client_pid]
        if p0 - eps <= g0 <= p0 + parent["dur"] + eps:
            nested += 1
    assert nested == len(gets), (nested, len(gets), eps)
    # the trainer's rounds reached the fleet timeline as traces with
    # cross-process children
    rounds = [s for s in cspans.values() if s["name"] == "round"]
    assert len(rounds) == n_tasks
    # every round (send+barrier+get) reached the server under its trace
    server_traces = {s["trace"] for s in sspans}
    assert {r["trace"] for r in rounds} <= server_traces
    # the JAX package merges these two real logs into the same timeline
    _assert_same_timeline([client_log, server_log])


# -- the port against the JAX package ---------------------------------------

def _assert_same_timeline(paths):
    """``paths`` merged by the port and by the JAX package: the same
    events, and the same merge facts under each package's key."""
    from paddle_tpu.trace import merge as jmerge
    got, want = tmerge.merge_files(paths)[0], jmerge.merge_files(paths)[0]
    assert got["traceEvents"] == want["traceEvents"]
    assert got["otherData"]["paddle_tpu_torch.trace"] == \
        want["otherData"]["paddle_tpu.trace"]
    return got


def test_merge_gives_the_jax_package_timeline(tmp_path):
    """Two processes' span logs (the skew fixture: a trainer and a
    pserver 5 s apart) merge into the JAX package's timeline, event for
    event; the live two-process run above checks the same on logs the
    port's processes wrote."""
    client, server = _write_skew_fixture(tmp_path)
    merged = _assert_same_timeline([client, server])
    assert any(e.get("name") == "pserver.GET"
               for e in merged["traceEvents"])
