"""SLO burn-rate alerting + the autoscaling signal plane ():
hand-computed window math goldens, exactly-once FIRING/RESOLVED
transitions under flapping input and under a replica incarnation swap,
the error-budget SLO form's CLI contract, the watch dashboards' ACTIVE
ALERTS line, the alerts/incident CLI, and a tier-1 live smoke over a
REAL scraped mini-fleet (injected error burst + queue pressure ->
page-severity alert within 2 scrape rounds, correlated trace id +
offender endpoint, scale_hint consumed by a stand-in supervisor)."""

import io
import json
import os

import pytest

from paddle_tpu_torch import monitor, slo
from paddle_tpu_torch.monitor import metrics as mm
from paddle_tpu_torch.monitor import signals as sg
from paddle_tpu_torch.monitor.__main__ import main as mon_main
from paddle_tpu_torch.monitor.collector import Collector, TelemetryServer

T0 = 1_000_000.0

BURN_OBJ = {"metric": "error_rate", "target": 0.9,
            "windows": [{"short_s": 60.0, "long_s": 600.0,
                         "burn_rate": 2.0, "severity": "page"}]}


# -- window math goldens (hand-computable, exact) --------------------------

def test_series_window_delta_math():
    w = sg.SeriesWindow()
    for i, v in ((0, 10.0), (10, 25.0), (20, 45.0), (30, 100.0)):
        w.add(T0 + i, v)
    now = T0 + 30
    # full window: base = NEWEST point with ts <= now - W
    assert w.delta(now, 20.0) == 75.0       # base t+10 (25) -> 100
    assert w.delta(now, 10.0) == 55.0       # base t+20 (45)
    # partial window: series younger than W -> base = oldest point
    assert w.delta(now, 500.0) == 90.0
    assert w.span(now, 500.0) == 30.0
    # a reset counter (raw feed) clamps, never a negative spike
    w.add(now + 1, 3.0)
    assert w.delta(now + 1, 10.0) == 0.0
    # fewer than two points = no delta
    assert sg.SeriesWindow().delta(now, 10.0) is None


def test_burn_pairs_golden_hand_computed():
    """target 0.9 -> budget 0.1. Short window (60 s): 10 requests, 3
    errors -> ratio 0.3, burn 3.0. Long window (600 s): 50 requests,
    7 errors -> ratio 0.14, burn 1.4 < 2.0 -> NOT fired (the long
    window gates); push the long ratio over and it fires."""
    now = T0 + 1000
    rows = [(now - 590 + i, i < 4, {}) for i in range(40)]
    rows += [(now - 50 + i, i < 3, {}) for i in range(10)]
    p = sg.burn_pairs(BURN_OBJ, rows, now)[0]
    assert p["ratio_short"] == pytest.approx(0.3)
    assert p["burn_short"] == pytest.approx(3.0)
    assert p["n_short"] == 10 and p["n_long"] == 50
    assert p["ratio_long"] == pytest.approx(7 / 50)
    assert p["burn_long"] == pytest.approx(1.4)
    assert p["fired"] is False
    # 18 more long-window errors -> long ratio 25/68, burn ~3.68
    rows += [(now - 300 + i, True, {}) for i in range(18)]
    p2 = sg.burn_pairs(BURN_OBJ, rows, now)[0]
    assert p2["burn_long"] == pytest.approx((25 / 68) / 0.1)
    assert p2["fired"] is True


def test_burn_pairs_latency_metric_counts_threshold_breaches():
    obj = {"metric": "ttft", "target": 0.9, "max_seconds": 0.5,
           "windows": [{"short_s": 60.0, "long_s": 600.0,
                        "burn_rate": 2.0}]}
    now = T0
    # 8 good + 2 slow in the short window; failed rows are excluded
    rows = [(now - 10 - i, False, {"ttft": 0.1}) for i in range(8)]
    rows += [(now - 5, False, {"ttft": 0.9}),
             (now - 6, False, {"ttft": 2.0}),
             (now - 7, True, {"ttft": 50.0})]     # error: excluded
    p = sg.burn_pairs(obj, rows, now)[0]
    assert p["n_short"] == 10
    assert p["ratio_short"] == pytest.approx(0.2)
    assert p["burn_short"] == pytest.approx(2.0)


def test_budget_objective_validation_loud():
    ok = {"metric": "error_rate", "target": 0.99,
          "windows": [{"short_s": 60, "long_s": 600,
                       "burn_rate": 14.4, "severity": "page"}]}
    sg.validate_budget_objective(ok)
    with pytest.raises(ValueError, match="short_s"):
        sg.validate_budget_objective(
            {"metric": "error_rate", "target": 0.99,
             "windows": [{"short_s": 600, "long_s": 60,
                          "burn_rate": 1.0}]})
    with pytest.raises(ValueError, match="target"):
        sg.validate_budget_objective(
            {"metric": "error_rate", "target": 1.5,
             "windows": [{"short_s": 60, "long_s": 600,
                          "burn_rate": 1.0}]})
    with pytest.raises(ValueError, match="severity"):
        sg.validate_budget_objective(
            {"metric": "error_rate", "target": 0.9,
             "windows": [{"short_s": 60, "long_s": 600,
                          "burn_rate": 1.0, "severity": "sms"}]})
    with pytest.raises(ValueError, match="max_seconds"):
        sg.validate_budget_objective(
            {"metric": "ttft", "target": 0.9,
             "windows": [{"short_s": 60, "long_s": 600,
                          "burn_rate": 1.0}]},
            known_metrics=("error_rate", "ttft"))
    # the slo spec loader routes budget-form objectives here (the
    # exit-2 surface) and still accepts the classic forms alongside
    with pytest.raises(ValueError, match="short_s"):
        slo.load_spec({"objectives": [
            {"metric": "error_rate", "target": 0.99,
             "windows": [{"short_s": 60, "long_s": 60,
                          "burn_rate": 1.0}]}]})
    slo.load_spec({"objectives": [
        ok, {"metric": "ttft", "percentile": 0.95, "max_seconds": 1}]})


# -- exactly-once transitions ----------------------------------------------

def _err_rows(t, n_err, n_ok=0):
    rows = [{"ts": t + 0.01 * i, "ev": "serving_request",
             "error": "boom", "trace": "tr%d" % i}
            for i in range(n_err)]
    rows += [{"ts": t + 0.5 + 0.01 * i, "ev": "serving_request",
              "ttft": 0.01} for i in range(n_ok)]
    return rows


def test_burn_fire_and_clear_exactly_once():
    s = sg.Signals(spec={"objectives": [
        {"metric": "error_rate", "target": 0.9,
         "windows": [{"short_s": 5.0, "long_s": 20.0,
                      "burn_rate": 2.0, "severity": "page"}]}]})
    name = "burn:error_rate:5s/20s"
    edges = []
    # clean round, then a sustained burst: exactly ONE FIRING even
    # though the condition stays true for many rounds
    edges += s.observe(events=_err_rows(T0, 0, 10), now=T0 + 1)
    for r in range(2, 8):
        edges += s.observe(events=_err_rows(T0 + r, 5), now=T0 + r)
    firing = [e for e in edges if e["rule"] == name]
    assert [e["state"] for e in firing] == ["FIRING"]
    assert firing[0]["severity"] == "page"
    assert name in s.active()
    # recovery: clean short windows -> exactly ONE RESOLVED
    # (clear_hold 2 -> second clean round resolves)
    edges2 = []
    for r in range(8, 14):
        edges2 += s.observe(events=_err_rows(T0 + r, 0, 10),
                            now=T0 + r)
    resolved = [e for e in edges2 if e["rule"] == name]
    assert [e["state"] for e in resolved] == ["RESOLVED"]
    assert name not in s.active()


def test_flap_suppression_one_pair_not_a_storm():
    """A metric flapping across the hysteresis band yields ONE
    FIRING->RESOLVED pair: values between clear (8) and fire (32)
    hold the current state, and the hold rounds stop single-round
    spikes from firing at all."""
    rule = sg.Rule("queue_depth", kind="gauge", series="queue_depth",
                   fire=32.0, clear=8.0, hold=2, clear_hold=2,
                   severity="ticket")
    s = sg.Signals(rules=[rule])
    edges = []

    def rnd(r, q):
        s.feed_sample("queue_depth", q, now=T0 + r)
        edges.extend(s.evaluate(now=T0 + r))

    # spike-flap: 40, 5, 40, 5 — never 2 consecutive -> NO transition
    for r, q in enumerate((40, 5, 40, 5)):
        rnd(r, q)
    assert edges == []
    # sustained high -> one FIRING
    rnd(4, 40)
    rnd(5, 40)
    assert [e["state"] for e in edges] == ["FIRING"]
    # mid-band flapping (between clear and fire) holds FIRING
    for r, q in enumerate((20, 12, 31, 20), start=6):
        rnd(r, q)
    assert len(edges) == 1
    # sustained low -> one RESOLVED; later mid-band values stay quiet
    rnd(10, 5)
    rnd(11, 5)
    for r, q in enumerate((20, 20, 20), start=12):
        rnd(r, q)
    assert [e["state"] for e in edges] == ["FIRING", "RESOLVED"]


def test_respawn_no_burn_spike_via_collector():
    """Acceptance: a replica incarnation swap must not
    fabricate a burn spike — the collector's incarnation-aware merge
    re-bases the respawned process's counters, so the signals engine
    sees monotonic totals and a flat error delta."""
    reg = mm.Registry()
    reg.counter("ptpu_serving_retirements_total", "").inc(500)
    reg.counter("ptpu_serving_request_failures_total", "").inc(2)
    srv = TelemetryServer(registry=reg, role="replica").start()
    col = Collector(static=[("replica", srv.endpoint)])
    s = sg.Signals(spec={"objectives": [
        {"metric": "error_rate", "target": 0.9,
         "windows": [{"short_s": 3.0, "long_s": 12.0,
                      "burn_rate": 1.0, "severity": "page"}]}]})
    try:
        edges = []
        for r in range(3):
            col.scrape_once()
            edges += s.observe(snapshot=col.fleet_snapshot(),
                               now=T0 + r)
        # respawn: fresh registry, totals back near zero. A NAIVE
        # evaluator diffing raw per-process totals would see errors
        # "move" (or clamp requests to 0 while errors grow next
        # round); through the collector the fleet totals stay
        # monotonic and the deltas stay flat.
        reg2 = mm.Registry()
        reg2.counter("ptpu_serving_retirements_total", "").inc(40)
        reg2.counter("ptpu_serving_request_failures_total", "").inc(1)
        srv.registry = reg2
        for r in range(3, 8):
            col.scrape_once()
            edges += s.observe(snapshot=col.fleet_snapshot(),
                               now=T0 + r)
        assert edges == []
        # sanity: the same evaluator DOES fire on a real burst
        reg2.counter("ptpu_serving_request_failures_total", "").inc(50)
        reg2.counter("ptpu_serving_retirements_total", "").inc(1)
        col.scrape_once()
        trs = s.observe(snapshot=col.fleet_snapshot(), now=T0 + 8)
        assert any(t["state"] == "FIRING" for t in trs)
    finally:
        col.close()
        srv.stop()


def test_counter_mode_burn_figures_hand_computed():
    """Snapshot-fed burn math golden: deltas against the NEWEST point
    at or before now - W, exactly as documented."""
    s = sg.Signals(spec={"objectives": [
        {"metric": "error_rate", "target": 0.9,
         "windows": [{"short_s": 2.0, "long_s": 8.0,
                      "burn_rate": 2.0, "severity": "page"}]}]})

    def snap(reqs, errs):
        return {"ptpu_serving_retirements_total":
                {"kind": "counter", "series": {"": reqs - errs}},
                "ptpu_serving_request_failures_total":
                {"kind": "counter", "series": {"": errs}}}

    for r, (reqs, errs) in enumerate(
            ((100, 0), (120, 0), (140, 0), (160, 10), (180, 20))):
        trs = s.observe(snapshot=snap(reqs, errs), now=T0 + r)
    # at now=T0+4: short base = point T0+2 (140 reqs, 0 errs) ->
    # ratio 20/40 = 0.5, burn 5.0; long base = oldest (100, 0) ->
    # ratio 20/80 = 0.25, burn 2.5 -> both >= 2 -> FIRING
    assert [t["state"] for t in trs] == ["FIRING"]
    figs = trs[0]["figures"]
    assert figs["source"] == "counters"
    assert figs["ratio_short"] == pytest.approx(0.5)
    assert figs["burn_short"] == pytest.approx(5.0)
    assert figs["ratio_long"] == pytest.approx(0.25)
    assert figs["burn_long"] == pytest.approx(2.5)


def test_rule_overrides_and_validation():
    spec = {"objectives": [],
            "rules": {"queue_depth": {"fire": 16.0, "clear": 4.0,
                                      "hold": 1},
                      "shed_rate": False}}
    rules = {r.name: r for r in sg.build_rules(spec)}
    assert rules["queue_depth"].fire == 16.0
    assert "shed_rate" not in rules
    assert "spec_accept_collapse" in rules       # defaults survive
    with pytest.raises(ValueError, match="unknown rule"):
        sg.build_rules({"rules": {"nope": {"fire": 1}}})
    with pytest.raises(ValueError, match="unknown field"):
        sg.build_rules({"rules": {"queue_depth": {"fire_at": 1}}})
    # hysteresis must sit on the correct side of fire
    with pytest.raises(ValueError, match="clear"):
        sg.Rule("r", kind="gauge", series="s", fire=10, clear=20)
    with pytest.raises(ValueError, match="clear"):
        sg.Rule("r", kind="gauge", series="s", fire=10, clear=5,
                direction="below")
    # ... and a malformed 'rules' object fails at the ONE spec choke
    # point (slo.load_spec), so every consumer — watch's alerts line
    # included — gets the documented clean exit 2, not a traceback
    # out of its render loop
    with pytest.raises(ValueError, match="clear"):
        slo.load_spec({"objectives": [
            {"metric": "ttft", "percentile": 0.95, "max_seconds": 1}],
            "rules": {"queue_depth": {"fire": 1.0, "clear": 5.0}}})


def test_scale_hints_up_hold_down():
    s = sg.Signals(spec={"objectives": []}, down_hold=3)
    # queue pressure -> up (hold 2 rounds at fire 32)
    for r in range(2):
        s.feed_sample("queue_depth", 80.0, now=T0 + r)
        s.feed_sample("occupancy", 1.0, now=T0 + r)
        s.evaluate(now=T0 + r)
    hint = s.scale_hint()
    assert hint.direction == "up"
    assert hint.magnitude == 2           # queue >= 2x the fire bar
    assert "queue_depth" in hint.reason
    # recover -> hold while idle streak builds, then down
    for r in range(2, 4):
        s.feed_sample("queue_depth", 0.0, now=T0 + r)
        s.feed_sample("occupancy", 0.1, now=T0 + r)
        s.evaluate(now=T0 + r)
    assert s.scale_hint().direction == "hold"   # queue alert cleared,
    for r in range(4, 8):                       # idle not sustained yet
        s.feed_sample("queue_depth", 0.0, now=T0 + r)
        s.feed_sample("occupancy", 0.1, now=T0 + r)
        s.evaluate(now=T0 + r)
    down = s.scale_hint()
    assert down.direction == "down" and down.magnitude == 1


def test_stale_gauge_resolves_instead_of_pinning():
    """A dead source's final gauge point must not pin an alert (and
    its scale-up hint) forever: past ``stale_s`` the figure stops
    counting, and sustained absence counts toward the clear hold."""
    rule = sg.Rule("queue_depth", kind="gauge", series="queue_depth",
                   fire=32.0, clear=8.0, hold=2, clear_hold=2,
                   severity="ticket", stale_s=10.0)
    s = sg.Signals(rules=[rule])
    edges = []
    for r in range(2):                    # engine wedges at queue 50
        s.feed_sample("queue_depth", 50.0, now=T0 + r)
        edges += s.evaluate(now=T0 + r)
    assert [e["state"] for e in edges] == ["FIRING"]
    # the source goes silent; evaluations keep running on the live
    # clock — within stale_s the alert HOLDS, past it it resolves
    edges += s.evaluate(now=T0 + 5)
    assert [e["state"] for e in edges] == ["FIRING"]   # still fresh
    edges += s.evaluate(now=T0 + 20)
    edges += s.evaluate(now=T0 + 21)
    assert [e["state"] for e in edges] == ["FIRING", "RESOLVED"]
    assert s.scale_hint().direction != "up"


def test_occupancy_is_mean_not_sum_for_scale_down():
    """3 replicas idling at 10% each must read occupancy 0.1 (mean),
    not 0.3 (sum) — otherwise the multi-replica fleet can never
    reach the scale-down threshold (ROADMAP direction 2's scale-in
    case)."""
    s = sg.Signals(spec={"objectives": []}, down_hold=2)
    for r in range(4):
        rows = [{"ts": T0 + r + 0.1 * i, "ev": "serving_step",
                 "dt": 0.01, "active": 0 if i else 1, "slots": 10,
                 "queue_depth": 0, "engine": "e%d" % i}
                for i in range(3)]
        s.feed_events(rows)
        s.evaluate(now=T0 + r)
    occ = s._series_latest("occupancy")
    assert occ is not None and occ[1] == pytest.approx(1 / 30)
    assert s.scale_hint().direction == "down"


def test_slo_staleness_burn_over_sparse_rows(tmp_path):
    """A staleness_s error-budget spec evaluates over sparse_staleness
    rows on the batch surface (previously only ttft/tpot/queue_wait
    carried burn samples — a healthy system failed 'no samples')."""
    log = str(tmp_path / "sparse.jsonl")
    t0 = T0
    _write_log(log, [{"ts": t0 + i, "ev": "sparse_staleness",
                      "value": 0.5, "table": "emb"}
                     for i in range(20)])
    spec = {"objectives": [
        {"metric": "staleness_s", "target": 0.9, "max_seconds": 30,
         "windows": [{"short_s": 5, "long_s": 20, "burn_rate": 2.0,
                      "severity": "ticket"}]}]}
    v = slo.evaluate(spec, slo.samples_from_monitor_log(log))
    assert v["pass"] is True
    assert v["objectives"][0]["measured"] == 0.0     # nothing stale
    # and the same spec FAILS when the samples breach the bound
    _write_log(log, [{"ts": t0 + i, "ev": "sparse_staleness",
                      "value": 90.0, "table": "emb"}
                     for i in range(20)])
    v2 = slo.evaluate(spec, slo.samples_from_monitor_log(log))
    assert v2["pass"] is False


def test_burn_verdict_line_never_contradicts_itself():
    """measured/threshold pair on the verdict line: measured is the
    displayed pair's min(burn_short, burn_long) — the figure the
    fire condition gates — so PASS ⟺ measured < threshold by
    construction even when a short burst fired one window of a
    pair."""
    rows = [(T0 + i, False, {}) for i in range(100)]
    # 100%-error burst confined to the short window
    rows += [(T0 + 100 + i, True, {}) for i in range(5)]
    samples = dict(slo.samples_from_events([], source="x"),
                   request_rows=rows)
    v = slo.evaluate({"objectives": [
        {"metric": "error_rate", "target": 0.9,
         "windows": [{"short_s": 10, "long_s": 104,
                      "burn_rate": 2.0, "severity": "page"}]}]},
        samples)
    ent = v["objectives"][0]
    assert ent["pass"] == (ent["measured"] < ent["threshold"])


# -- surfaces: slo CLI, watch line, alerts CLI, recorder row ---------------

def _write_log(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _burst_log(tmp_path, n_ok=20, n_err=15):
    import time as _time
    t0 = _time.time() - 100
    rows = [{"ts": t0 + i, "ev": "serving_request", "ttft": 0.01,
             "tpot": 0.001, "queue_wait": 0.0} for i in range(n_ok)]
    rows += [{"ts": t0 + n_ok + i, "ev": "serving_request",
              "error": "RuntimeError('boom')", "trace": "t%02d" % i,
              "engine": "e0"} for i in range(n_err)]
    log = str(tmp_path / "run.jsonl")
    _write_log(log, rows)
    return log


def test_slo_cli_burn_exit_codes(tmp_path, capsys):
    log = _burst_log(tmp_path)
    fail_spec = str(tmp_path / "fail.json")
    json.dump({"name": "burn", "objectives": [
        {"metric": "error_rate", "target": 0.95,
         "windows": [{"short_s": 5, "long_s": 20, "burn_rate": 2.0,
                      "severity": "page"}]}]}, open(fail_spec, "w"))
    assert slo.main([fail_spec, "--log", log]) == 1
    out = capsys.readouterr().out
    assert "error_rate burn" in out and "FAIL" in out
    # generous budget: the same burst passes
    pass_spec = str(tmp_path / "pass.json")
    json.dump({"name": "burn", "objectives": [
        {"metric": "error_rate", "target": 0.2,
         "windows": [{"short_s": 5, "long_s": 20, "burn_rate": 3.0,
                      "severity": "page"}]}]}, open(pass_spec, "w"))
    assert slo.main([pass_spec, "--log", log]) == 0
    # malformed window pair = exit 2 at spec load
    bad = str(tmp_path / "bad.json")
    json.dump({"objectives": [
        {"metric": "error_rate", "target": 0.95,
         "windows": [{"short_s": 20, "long_s": 5,
                      "burn_rate": 2.0}]}]}, open(bad, "w"))
    assert slo.main([bad, "--log", log]) == 2
    # span surface carries no timestamped rows -> burn objective
    # fails loudly instead of passing hollow
    spans = str(tmp_path / "spans.jsonl")
    _write_log(spans, [{"ts": 1.0, "ev": "span", "name": "x",
                        "dur": 0.1}])
    assert slo.main([fail_spec, "--spans", spans]) == 1


def test_watch_once_renders_active_alerts_line(tmp_path):
    """Satellite: file-mode watch renders the same ACTIVE ALERTS line
    from a local signals evaluation over the tailed rows."""
    from paddle_tpu_torch.monitor.watch import watch
    log = _burst_log(tmp_path)
    spec = str(tmp_path / "spec.json")
    json.dump({"name": "t", "objectives": [
        {"metric": "error_rate", "target": 0.95,
         "windows": [{"short_s": 5, "long_s": 20, "burn_rate": 2.0,
                      "severity": "page"}]}]}, open(spec, "w"))
    buf = io.StringIO()
    frame = watch(log, once=True, out=buf, slo_spec=spec)
    assert "ACTIVE ALERTS" in frame
    assert "[page] burn:error_rate:5s/20s" in frame
    # without a spec the default sustained rules still arm (and a
    # HEALTHY log — productive steps, good goodput, quiet queue —
    # renders the quiet line)
    clean = str(tmp_path / "clean.jsonl")
    rows = [{"ts": 1000.0 + i, "ev": "serving_step", "dt": 0.9,
             "active": 2, "slots": 4, "queue_depth": 0, "emitted": 4}
            for i in range(6)]
    rows += [{"ts": 1000.5 + i, "ev": "serving_request",
              "ttft": 0.01} for i in range(5)]
    _write_log(clean, rows)
    frame2 = watch(clean, once=True, out=io.StringIO())
    assert "alerts    none active" in frame2


def test_alerts_cli_replay_json_and_incident(tmp_path, capsys):
    log = _burst_log(tmp_path)
    spec = str(tmp_path / "spec.json")
    json.dump({"objectives": [
        {"metric": "error_rate", "target": 0.95,
         "windows": [{"short_s": 5, "long_s": 20, "burn_rate": 2.0,
                      "severity": "page"}]}]}, open(spec, "w"))
    assert mon_main(["alerts", log, "--spec", spec, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    states = [(t["rule"], t["state"]) for t in rep["transitions"]]
    assert ("burn:error_rate:5s/20s", "FIRING") in states
    assert rep["scale_hint"][0] == "up"
    burn = next(t for t in rep["transitions"]
                if t["rule"].startswith("burn:"))
    assert burn["offenders"][0]["trace"].startswith("t")
    # human render
    assert mon_main(["alerts", log, "--spec", spec]) == 0
    out = capsys.readouterr().out
    assert "FIRING" in out and "scale hint: up" in out
    # bad spec -> 2; missing inputs -> argparse exit 2
    badspec = str(tmp_path / "bad.json")
    json.dump({"objectives": [{"metric": "error_rate",
                               "target": 2.0, "windows": [
                                   {"short_s": 1, "long_s": 2,
                                    "burn_rate": 1}]}]},
              open(badspec, "w"))
    assert mon_main(["alerts", log, "--spec", badspec]) == 2
    with pytest.raises(SystemExit):
        mon_main(["alerts"])


def test_alert_row_counters_and_incident_timeline(tmp_path, capsys):
    """An armed evaluation lands exactly-once `alert` rows (trace of
    the first offender + the logical transition time), ticks the
    transition counter, and the --incident CLI splices them with the
    goodput ledger's badput intervals."""
    from paddle_tpu_torch.monitor.runtime import ALERT_TRANSITIONS
    log = _burst_log(tmp_path)
    # add attested badput + a recovery marker to the same timeline
    events, _ = monitor.read_jsonl_tolerant(log)
    t_last = events[-1]["ts"]
    with open(log, "a") as f:
        f.write(json.dumps({"ts": t_last + 1, "ev": "stall",
                            "idle_seconds": 2.0}) + "\n")
        f.write(json.dumps({"ts": t_last + 2, "ev": "retry",
                            "what": "GET", "attempt": 1}) + "\n")
    alog = str(tmp_path / "alerts.jsonl")
    before = ALERT_TRANSITIONS.value(
        rule="burn:error_rate:5s/20s", severity="page",
        state="FIRING")
    monitor.enable(log_path=alog)
    try:
        s = sg.Signals(spec={"objectives": [
            {"metric": "error_rate", "target": 0.95,
             "windows": [{"short_s": 5, "long_s": 20,
                          "burn_rate": 2.0, "severity": "page"}]}]})
        events, _ = monitor.read_jsonl_tolerant(log)
        trs = s.replay(events)
    finally:
        monitor.disable()
    firing = [t for t in trs if t["state"] == "FIRING"
              and t["rule"].startswith("burn:")]
    assert len(firing) == 1
    rows, _ = monitor.read_jsonl_tolerant(alog)
    arows = [r for r in rows if r["ev"] == "alert"]
    burn_rows = [r for r in arows if r["rule"].startswith("burn:")]
    assert len(burn_rows) == 1                   # exactly-once row
    assert burn_rows[0]["trace"] == firing[0]["offenders"][0]["trace"]
    assert burn_rows[0]["at"] == firing[0]["ts"]  # logical time
    assert ALERT_TRANSITIONS.value(
        rule="burn:error_rate:5s/20s", severity="page",
        state="FIRING") == before + 1
    # the incident timeline names the stall badput, the recovery
    # marker, and the alert transition in one chronological listing
    assert mon_main(["alerts", "--incident", log, alog]) == 0
    out = capsys.readouterr().out
    assert "incident timeline" in out
    assert "badput  stall" in out
    assert "marker  fault_recovery" in out
    assert "FIRING" in out and "burn:error_rate:5s/20s" in out


def test_signals_in_analysis_import_check():
    """The port's signals module imports neither jax nor paddle_tpu."""
    from torch_fleet_harness import assert_isolated
    assert_isolated("paddle_tpu_torch.monitor.signals")


def test_fleet_queue_depth_gauge_tracks_router_queue():
    """Satellite: the router's standing queue depth is a GAUGE now
    (the signal plane's queue-pressure input was counters-only)."""
    from paddle_tpu_torch.serving.fleet import FLEET_QUEUE_DEPTH
    import paddle_tpu_torch.serving.fleet as fleet_mod
    assert FLEET_QUEUE_DEPTH.kind == "gauge"
    assert mm.registry().get("ptpu_fleet_queue_depth") \
        is FLEET_QUEUE_DEPTH
    # set/read contract on the router label (full Router wiring is
    # exercised by the fleet chaos tests; here we pin the series
    # shape the collector scrapes and signals sums)
    FLEET_QUEUE_DEPTH.set(7, router="t-router")
    assert FLEET_QUEUE_DEPTH.value(router="t-router") == 7.0
    s = sg.Signals(spec={"objectives": []})
    s.feed_snapshot(mm.registry().snapshot(), now=T0)
    q = s._series_latest("queue_depth")
    assert q is not None and q[1] >= 7.0
    FLEET_QUEUE_DEPTH.set(0, router="t-router")


# -- tier-1 live smoke: scraped mini-fleet ---------------------------------

def test_live_smoke_injected_violation_on_scraped_minifleet(tmp_path):
    """ acceptance: a REAL scraped mini-fleet (this process's
    global registry + recorder ring behind a TelemetryServer, scraped
    by a Collector over RPC) with an injected SLO violation (error
    burst + queue pressure) produces a page-severity FIRING alert
    within 2 scrape rounds of the burst; the alert row carries the
    correlated trace id + offender endpoint; scale_hint() returns a
    scale-up a stand-in supervisor consumes."""
    from paddle_tpu_torch.monitor import runtime as monrt
    alog = str(tmp_path / "smoke.jsonl")
    monitor.enable(log_path=alog)
    srv = TelemetryServer(role="replica").start()
    col = Collector(static=[("replica", srv.endpoint)])
    try:
        sig = sg.Signals(spec={
            "objectives": [
                {"metric": "error_rate", "target": 0.95,
                 "windows": [{"short_s": 2.0, "long_s": 8.0,
                              "burn_rate": 2.0, "severity": "page"}]}],
            "rules": {"queue_depth": {"fire": 32.0, "clear": 8.0,
                                      "hold": 2}}})
        # clean rounds: healthy decode traffic, empty queue (real
        # wall clock — the production live-loop shape; the burn
        # windows comfortably contain the whole sub-second smoke)
        for r in range(4):
            monrt.on_serving_step(active=2, slots=4, queue_depth=0,
                                  emitted=8, retired=5,
                                  engine="smoke", dt=0.01)
            events = col.scrape_once()
            trs = sig.observe(snapshot=col.fleet_snapshot(),
                              events=events)
            assert trs == [], trs
        # injected violation: every request fails + the queue backs up
        fired, detect_rounds = [], None
        for r in range(3):
            for i in range(10):
                monrt.on_serving_request(
                    engine="smoke", tokens=0,
                    error="RuntimeError('injected')",
                    trace_id="smoketrace%d%d" % (r, i))
            monrt.on_serving_step(active=4, slots=4, queue_depth=50,
                                  emitted=0, engine="smoke", dt=0.01)
            events = col.scrape_once()
            fired += [t for t in sig.observe(
                snapshot=col.fleet_snapshot(), events=events)
                if t["state"] == "FIRING"]
            if any(t["severity"] == "page" for t in fired):
                detect_rounds = r + 1
                break
        page = [t for t in fired if t["severity"] == "page"]
        assert page, "no page alert within the burst rounds"
        # within 2 scrape rounds of the injected burst
        assert detect_rounds <= 2
        # correlated offender: the injected trace id, attributed to
        # the scraped replica endpoint (incarnation from the fleet
        # snapshot's endpoint meta)
        off = page[0]["offenders"][0]
        assert off["trace"].startswith("smoketrace")
        assert off["endpoint"] == srv.endpoint
        assert off["incarnation"] == mm.registry().incarnation
        # the alert ROW in this process's armed recorder carries the
        # same trace id
        rows, _ = monitor.read_jsonl_tolerant(alog)
        arows = [e for e in rows if e["ev"] == "alert"
                 and e["state"] == "FIRING"
                 and e["severity"] == "page"]
        assert arows and arows[0]["trace"].startswith("smoketrace")
        # keep pressure one more round so the queue rule (hold 2)
        # joins, then the hint compounds to magnitude 2
        monrt.on_serving_step(active=4, slots=4, queue_depth=50,
                              emitted=0, engine="smoke", dt=0.01)
        events = col.scrape_once()
        sig.observe(snapshot=col.fleet_snapshot(), events=events)
        hint = sig.scale_hint()
        assert hint.direction == "up" and hint.magnitude >= 1
        # the direction-2 stand-in supervisor consumes the hint
        desired = 2
        if hint.direction == "up":
            desired += hint.magnitude
        elif hint.direction == "down":
            desired -= hint.magnitude
        assert desired >= 3, (hint, desired)
    finally:
        # leave the process-global gauges quiet for later tests
        from paddle_tpu_torch.monitor import runtime as _rt
        _rt.SERVING_QUEUE_DEPTH.set(0)
        col.close()
        srv.stop()
        monitor.disable()


# -- the port against the JAX package ---------------------------------------

def _hint_scenario(sgm):
    """The scale-hint scenario above, in either package: every
    evaluation's edges and hint."""
    s = sgm.Signals(spec={"objectives": [BURN_OBJ]}, down_hold=3)
    out = []
    for r in range(12):
        q = 80.0 if r < 3 else 0.0
        s.feed_sample("queue_depth", q, now=T0 + r)
        s.feed_sample("occupancy", 1.0 if r < 3 else 0.1, now=T0 + r)
        s.feed_events([{"ts": T0 + r, "ev": "serving_request",
                        "ttft": 0.01, "engine": "e0",
                        **({"error": "boom"} if r % 3 == 0 else {})}])
        edges = s.evaluate(now=T0 + r)
        h = s.scale_hint()
        out.append(([{k: e[k] for k in ("rule", "state")}
                     for e in edges],
                    (h.direction, h.magnitude, h.reason)))
    return out


def test_signal_verdicts_and_hints_equal_the_jax_package():
    from paddle_tpu.monitor import signals as jsg
    assert _hint_scenario(sg) == _hint_scenario(jsg)


@pytest.mark.parametrize("mode", ["json", "text", "incident", "slo"])
def test_alerts_and_slo_cli_equal_the_jax_package(mode, tmp_path, capsys):
    from torch_fleet_harness import run_main_both
    log = _burst_log(tmp_path)
    spec = str(tmp_path / "spec.json")
    json.dump({"objectives": [
        {"metric": "error_rate", "target": 0.95,
         "windows": [{"short_s": 5, "long_s": 20, "burn_rate": 2.0,
                      "severity": "page"}]}]}, open(spec, "w"))
    if mode == "slo":
        want, got = run_main_both("slo", [spec, "--log", log], capsys)
    else:
        argv = {"json": ["alerts", log, "--spec", spec, "--json"],
                "text": ["alerts", log, "--spec", spec],
                "incident": ["alerts", "--incident", log]}[mode]
        want, got = run_main_both("monitor.__main__", argv, capsys)
    assert got == want
