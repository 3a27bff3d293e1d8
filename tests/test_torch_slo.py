"""paddle_tpu_torch.slo + monitor watch: the request-level SLO gate tier.

Golden-fixture contract (): `tests/fixtures/serving_requests.jsonl`
is a checked-in flight-recorder log (20 retired requests with exact
hand-computable percentiles + 1 failed request + 40 serving_step rows);
`slo_pass.json` / `slo_fail.json` are spec fixtures that must evaluate
to PASS (exit 0) and FAIL (exit 1) against it — the CI/chaos gate
primitive ROADMAP direction 2 builds on. Everything here is pure host
JSON work: milliseconds, no jax.
"""

import io
import json
import os

import pytest

from paddle_tpu_torch import slo

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "fixtures")
LOG = os.path.join(FIX, "serving_requests.jsonl")
PASS_SPEC = os.path.join(FIX, "slo_pass.json")
FAIL_SPEC = os.path.join(FIX, "slo_fail.json")


# -- sample extraction + evaluation against the golden log -----------------

def test_monitor_log_samples_exact():
    s = slo.samples_from_monitor_log(LOG)
    assert s["requests"] == 21 and s["errors"] == 1
    assert len(s["ttft"]) == 20 and len(s["tpot"]) == 20
    # the errored request carries queue_wait=0.0004 in its row, but a
    # failed request is the error budget's business ONLY — its
    # failure-time latencies must not enter percentile samples
    assert len(s["queue_wait"]) == 20
    assert 0.0004 not in s["queue_wait"]
    assert len(s["step_latency"]) == 40
    assert s["skipped"] == 0


def test_evaluate_golden_pass_measured_percentiles():
    v = slo.evaluate(json.load(open(PASS_SPEC)),
                     slo.samples_from_monitor_log(LOG))
    assert v["pass"] is True
    by = {r["metric"]: r for r in v["objectives"]}
    # nearest-rank over the fixture's arithmetic series — exact values
    assert by["ttft"]["measured"] == pytest.approx(0.046)
    assert by["tpot"]["measured"] == pytest.approx(0.0029)
    assert by["queue_wait"]["measured"] == pytest.approx(0.009)
    assert by["step_latency"]["measured"] == pytest.approx(0.00285)
    assert by["error_rate"]["measured"] == pytest.approx(1 / 21)
    assert all(r["pass"] for r in v["objectives"])
    assert not any(r["approximate"] for r in v["objectives"])


def test_evaluate_golden_fail():
    v = slo.evaluate(json.load(open(FAIL_SPEC)),
                     slo.samples_from_monitor_log(LOG))
    assert v["pass"] is False
    by = {r["metric"]: r for r in v["objectives"]}
    assert by["ttft"]["pass"] is False          # 46ms > 20ms
    assert by["tpot"]["pass"] is True
    assert by["error_rate"]["pass"] is False    # 4.76% > 1%


def test_no_samples_objective_fails():
    v = slo.evaluate(
        {"objectives": [{"metric": "ttft", "percentile": 0.5,
                         "max_seconds": 1.0}]},
        slo.samples_from_monitor_log(os.devnull))
    assert v["pass"] is False
    assert v["objectives"][0]["reason"] == "no samples observed"


def test_spec_validation_is_loud():
    with pytest.raises(ValueError, match="unknown metric"):
        slo.load_spec({"objectives": [{"metric": "latency",
                                       "max_seconds": 1}]})
    with pytest.raises(ValueError, match="max_seconds"):
        slo.load_spec({"objectives": [{"metric": "ttft"}]})
    with pytest.raises(ValueError, match="percentile"):
        slo.load_spec({"objectives": [{"metric": "ttft",
                                       "percentile": 1.5,
                                       "max_seconds": 1}]})
    with pytest.raises(ValueError, match="objectives"):
        slo.load_spec({})


# -- the tier-1 gate: CLI exit codes on the checked-in fixtures ------------

def test_slo_cli_gate_pass_and_fail_exit_codes(capsys):
    """THE gate smoke: `python -m paddle_tpu_torch.slo` returns 0 on the
    golden pass spec and 1 on the fail spec, with a machine-readable
    verdict under --json."""
    assert slo.main([PASS_SPEC, "--log", LOG]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "serving-golden-pass" in out
    assert slo.main([FAIL_SPEC, "--log", LOG]) == 1
    assert "FAIL" in capsys.readouterr().out
    assert slo.main([PASS_SPEC, "--log", LOG, "--json"]) == 0
    v = json.loads(capsys.readouterr().out)
    assert v["pass"] is True and len(v["objectives"]) == 5
    assert v["requests"] == 21


def test_slo_cli_bad_spec_exits_2(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text('{"objectives": []}')
    assert slo.main([str(bad), "--log", LOG]) == 2
    with pytest.raises(SystemExit) as ei:     # no source given
        slo.main([PASS_SPEC])
    assert ei.value.code == 2


def test_slo_in_analysis_import_check():
    """The port's slo module imports neither jax nor paddle_tpu."""
    from torch_fleet_harness import assert_isolated
    assert_isolated("paddle_tpu_torch.slo")


# -- the other two evaluation surfaces -------------------------------------

def test_span_log_source(tmp_path):
    """serving.request spans (close-time attrs) + engine.step durations
    are a full evaluation surface — the merged-fleet-timeline path."""
    log = tmp_path / "spans.jsonl"
    rows = []
    for i in range(10):
        rows.append({"ts": 1.0 + i, "ev": "span", "trace": "t%d" % i,
                     "span": "s%d" % i, "parent": None,
                     "name": "serving.request", "t0": 1.0 + i,
                     "dur": 0.5, "pid": 1, "proc": "eng", "tid": 1,
                     "attrs": {"ttft": 0.01 * (i + 1),
                               "tpot": 0.001, "queue_wait": 0.002}})
        rows.append({"ts": 1.0 + i, "ev": "span", "trace": "t%d" % i,
                     "span": "e%d" % i, "parent": None,
                     "name": "engine.step", "t0": 1.0 + i,
                     "dur": 0.004, "pid": 1, "proc": "eng", "tid": 1})
    rows.append({"ts": 20.0, "ev": "span", "trace": "tx", "span": "sx",
                 "parent": None, "name": "serving.request", "t0": 20.0,
                 "dur": 0.1, "pid": 1, "proc": "eng", "tid": 1,
                 "attrs": {"error": "RuntimeError('boom')"}})
    log.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    s = slo.samples_from_span_logs([str(log)])
    assert s["requests"] == 11 and s["errors"] == 1
    assert len(s["step_latency"]) == 10
    v = slo.evaluate(
        {"objectives": [
            {"metric": "ttft", "percentile": 0.95, "max_seconds": 0.2},
            {"metric": "step_latency", "percentile": 0.95,
             "max_seconds": 0.005},
            {"metric": "error_rate", "max_ratio": 0.5}]}, s)
    assert v["pass"] is True


def test_metrics_snapshot_source(tmp_path):
    """A registry snapshot (dump_metrics .json shape, now carrying
    histogram bucket boundaries) evaluates with bucket-interpolated
    percentiles flagged approximate."""
    from paddle_tpu_torch.monitor.metrics import Registry
    reg = Registry()
    h = reg.histogram("ptpu_serving_ttft_seconds", "t", ("engine",))
    hs = reg.histogram("ptpu_serving_step_seconds", "s", ("engine",))
    for _ in range(100):
        h.observe(0.03, engine="e")       # inside the (0.025, 0.05]
        hs.observe(0.002, engine="e")     # inside the (0.001, 0.0025]
    fails = reg.counter("ptpu_serving_request_failures_total", "f")
    rets = reg.counter("ptpu_serving_retirements_total", "r")
    rets.inc(99)
    fails.inc(1)
    snap = tmp_path / "metrics.json"
    reg.dump_json(str(snap))
    s = slo.samples_from_metrics(str(snap))
    assert s["requests"] == 100 and s["errors"] == 1
    # step_latency reads the SERVING engine-iteration histogram — the
    # same quantity the --log and --spans surfaces measure
    assert "step_latency" in s["histograms"]
    v = slo.evaluate(
        {"objectives": [
            {"metric": "ttft", "percentile": 0.95, "max_seconds": 0.05},
            {"metric": "step_latency", "percentile": 0.95,
             "max_seconds": 0.0025},
            {"metric": "error_rate", "max_ratio": 0.05}]}, s)
    by = {r["metric"]: r for r in v["objectives"]}
    assert v["pass"] is True
    assert by["ttft"]["approximate"] is True
    assert 0.025 < by["ttft"]["measured"] <= 0.05
    # tighter than the bucket floor must fail — approx never flatters
    v2 = slo.evaluate(
        {"objectives": [{"metric": "ttft", "percentile": 0.95,
                         "max_seconds": 0.02}]}, s)
    assert v2["pass"] is False


# -- fleet: union across per-replica logs ( satellite) --------------

def _replica_log(path, n, ttft0, errors=0):
    rows = []
    for i in range(n):
        rows.append({"ts": 1.0 + i, "ev": "serving_request",
                     "engine": os.path.basename(str(path)),
                     "queue_wait": 0.001, "ttft": ttft0 + 0.001 * i,
                     "tpot": 0.002, "tokens": 8, "prefill_chunks": 1,
                     "prompt_len": 4})
        rows.append({"ts": 1.0 + i, "ev": "serving_step", "active": 2,
                     "slots": 2, "queue_depth": 0, "emitted": 2,
                     "admitted": 0, "retired": 0, "dt": 0.003})
    for _ in range(errors):
        rows.append({"ts": 99.0, "ev": "serving_request",
                     "engine": os.path.basename(str(path)),
                     "error": "Overloaded(...)", "tokens": 0})
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")


def test_slo_log_union_across_replica_logs(tmp_path, capsys):
    """Fleet-wide percentiles come from the UNION of per-replica logs,
    not a single process's view: the p95 over both replicas' TTFT
    samples differs from either log alone, and the error budget counts
    every replica's failures."""
    a, b = str(tmp_path / "rep0.jsonl"), str(tmp_path / "rep1.jsonl")
    _replica_log(a, 10, ttft0=0.010)            # 10..19 ms
    _replica_log(b, 10, ttft0=0.050, errors=1)  # 50..59 ms + 1 error
    sa = slo.samples_from_monitor_log(a)
    su = slo.samples_from_monitor_log([a, b])
    assert sa["requests"] == 10 and su["requests"] == 21
    assert su["errors"] == 1
    assert len(su["ttft"]) == 20 and len(su["step_latency"]) == 20
    spec = {"objectives": [
        {"metric": "ttft", "percentile": 0.95, "max_seconds": 0.030},
        {"metric": "error_rate", "max_ratio": 0.10}]}
    # replica 0 alone passes 30ms; the union must NOT (p95 ~59ms) —
    # a single-log verdict would flatter the fleet
    assert slo.evaluate(spec, sa)["pass"] is True
    vu = slo.evaluate(spec, su)
    assert vu["pass"] is False
    by = {r["metric"]: r for r in vu["objectives"]}
    assert by["ttft"]["measured"] == pytest.approx(0.058)
    assert by["error_rate"]["measured"] == pytest.approx(1 / 21)
    # the CLI takes several --log paths
    s = json.dumps(spec)
    assert slo.main([s, "--log", a]) == 0
    capsys.readouterr()
    assert slo.main([s, "--log", a, b]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_watch_once_over_multiple_replica_logs(tmp_path):
    from paddle_tpu_torch.monitor.watch import watch
    a, b = str(tmp_path / "rep0.jsonl"), str(tmp_path / "rep1.jsonl")
    _replica_log(a, 5, ttft0=0.010)
    _replica_log(b, 7, ttft0=0.020, errors=1)
    buf = io.StringIO()
    frame = watch([a, b], once=True, out=buf)
    assert frame is not None
    assert "n 13" in frame          # 5 + 7 + 1 failed, unioned
    assert "errors 1" in frame
    assert "steps 12" in frame      # serving_step rows across both
    from paddle_tpu_torch.monitor.__main__ import main as mon_main
    assert mon_main(["watch", a, b, "--once"]) == 0


# -- the live dashboard -----------------------------------------------------

def test_watch_renders_once_on_static_log():
    from paddle_tpu_torch.monitor.watch import watch
    buf = io.StringIO()
    frame = watch(LOG, once=True, out=buf, slo_spec=PASS_SPEC)
    assert frame is not None and frame in buf.getvalue()
    assert "serving" in frame and "requests" in frame
    assert "TTFT" in frame and "TPOT" in frame
    assert "queue_wait" in frame
    assert "slo" in frame and "PASS" in frame
    # totals from the fixture: 40 engine steps, 21 requests, 1 error
    assert "steps 40" in frame
    assert "n 21" in frame
    assert "errors 1" in frame


def test_watch_cli_once(capsys):
    from paddle_tpu_torch.monitor.__main__ import main as mon_main
    assert mon_main(["watch", LOG, "--once"]) == 0
    out = capsys.readouterr().out
    assert "TTFT" in out and "tokens/s" in out
    # --once on a not-yet-created log: clean exit 1, no traceback (the
    # LIVE loop would instead wait for the file to appear)
    assert mon_main(["watch", "/tmp/ptpu_no_such_log.jsonl",
                     "--once"]) == 1
    assert "does not exist" in capsys.readouterr().out
    # a typo'd --slo spec: clean exit 2 like the slo CLI
    assert mon_main(["watch", LOG, "--once",
                     "--slo", "/tmp/ptpu_no_such_spec.json"]) == 2


def test_monitor_cli_summarizes_serving_rows(capsys):
    """ satellite: one command reports BOTH workloads — the
    summary now carries a serving block with step latency, occupancy
    and TTFT/TPOT percentiles."""
    from paddle_tpu_torch.monitor.__main__ import main as mon_main
    from paddle_tpu_torch.monitor.__main__ import summarize_log
    s = summarize_log(LOG)
    sv = s["serving"]
    assert sv["steps"] == 40 and sv["requests"] == 21
    assert sv["errors"] == 1
    assert sv["ttft_p95_s"] == pytest.approx(0.046)
    assert sv["tpot_p95_s"] is not None
    assert sv["step_p95_s"] == pytest.approx(0.00285)
    assert sv["max_queue_depth"] == 12
    assert 0.0 < sv["mean_occupancy"] <= 1.0
    assert mon_main([LOG]) == 0
    out = capsys.readouterr().out
    assert "serving" in out and "TTFT" in out and "ERRORS 1" in out
    # a pure training log keeps serving == None (shape unchanged)
    assert mon_main([LOG, "--json"]) == 0
    j = json.loads(capsys.readouterr().out)
    assert j["serving"]["requests"] == 21


# -- the port against the JAX package ---------------------------------------

@pytest.mark.parametrize("argv", [
    [PASS_SPEC, "--log", LOG], [FAIL_SPEC, "--log", LOG],
    [PASS_SPEC, "--log", LOG, "--json"], [FAIL_SPEC, "--log", LOG, "--json"],
    [PASS_SPEC], ["/no/such/spec.json", "--log", LOG]])
def test_slo_reports_equal_the_jax_package(argv, capsys):
    """``slo.main`` of both packages on the same spec and log: the
    same exit code and the same report."""
    from torch_fleet_harness import run_main_both
    want, got = run_main_both("slo", argv, capsys)
    assert got == want


def test_slo_evaluate_equals_the_jax_package():
    """``evaluate`` over the fixture log's samples gives the JAX
    package's report, objective for objective."""
    import json as _json
    from paddle_tpu import slo as jslo
    for spec_path in (PASS_SPEC, FAIL_SPEC):
        spec = _json.load(open(spec_path))
        want = jslo.evaluate(spec, jslo.samples_from_monitor_log(LOG))
        got = slo.evaluate(spec, slo.samples_from_monitor_log(LOG))
        assert got == want


@pytest.mark.parametrize("argv", [[LOG], [LOG, "--json"]])
def test_monitor_summary_equals_the_jax_package(argv, capsys):
    from torch_fleet_harness import run_main_both
    want, got = run_main_both("monitor.__main__", argv, capsys)
    assert got == want
