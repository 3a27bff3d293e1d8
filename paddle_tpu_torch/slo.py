"""Declarative serving-SLO evaluation: spec in, verdict out.

The port's copy of ``paddle_tpu/slo.py`` (pure Python).

The gate primitive of ROADMAP direction 2 ("latency SLOs measured from
merged trace timelines"): a JSON spec declares objectives over the
request-level figures the serving engine attributes per request
(queue_wait, TTFT, TPOT — serving/engine.py lifecycle stamps), plus
engine step latency and an error budget, and this module evaluates the
spec against any of the three observability surfaces the runtime
already produces:

  * monitor flight-recorder JSONL(s) (``serving_request`` /
    ``serving_step`` rows — EXACT per-request samples; pass one log
    per replica and the verdict covers the fleet-wide union),
  * trace span logs (``serving.request`` spans whose close-time attrs
    carry the same figures — the merged-fleet-timeline source: pass
    every process's span log and the verdict covers the fleet),
  * a metrics snapshot (``monitor.dump_metrics(...json)`` registry
    dump — ``ptpu_serving_*_seconds`` histogram buckets, APPROXIMATE
    bucket-interpolated percentiles).

Spec schema (JSON)::

    {
      "name": "chat-serving",
      "objectives": [
        {"metric": "ttft",        "percentile": 0.95, "max_seconds": 0.5},
        {"metric": "tpot",        "percentile": 0.99, "max_seconds": 0.05},
        {"metric": "queue_wait",  "percentile": 0.95, "max_seconds": 0.25},
        {"metric": "step_latency","percentile": 0.95, "max_seconds": 0.1},
        {"metric": "kv_used_blocks", "max_value": 56},
        {"metric": "staleness_s", "percentile": 0.95, "max_seconds": 6},
        {"metric": "goodput_fraction", "min_ratio": 0.7},
        {"metric": "error_rate",  "max_ratio": 0.001}
      ]
    }

``staleness_s`` gates the sparse serving tier's measured
read-your-writes staleness (online update landed -> first serve
reflecting it): exact samples from ``sparse_staleness`` recorder rows
on the --log surface, bucket-interpolated from the
``ptpu_sparse_staleness_seconds`` histogram on --metrics.

``kv_used_blocks`` gates paged-KV pool pressure from the
``serving_step`` rows' per-iteration occupancy (threshold is a plain
block count via ``max_value``; percentile defaults to 1.0 = the
window's max). Only the row surfaces carry it (--log / watch); a
metrics snapshot has no per-step series to gate.

``version_convergence_s`` / ``roll_shed`` gate the elastic
fleet's rolling weight updates from ``roll`` recorder rows
(serving.autoscale): time from roll start to 100% of replicas serving
the new artifact version (completed rolls only — metrics surface reads
the ``ptpu_fleet_version_convergence_seconds`` histogram), and
requests shed while a roll was in flight (``max_value: 0`` declares
"a roll must not shed"; row surfaces only, like kv_used_blocks).

``goodput_fraction`` gates the monitor.goodput wall-time
attribution — productive seconds over measured wall — computed from
the same recorder rows (a HIGHER-is-better objective: ``min_ratio``
is the floor). Row surfaces only, like kv_used_blocks.

Error-budget form: any objective over ``error_rate`` or a
latency metric may instead declare a target fraction plus multi-window
burn-rate pairs (the SRE-Workbook ch. 5 shape the streaming alerting
tier in ``monitor/signals.py`` evaluates live)::

    {"metric": "error_rate", "target": 0.999, "windows": [
        {"short_s": 300,  "long_s": 3600,  "burn_rate": 14.4,
         "severity": "page"},
        {"short_s": 1800, "long_s": 21600, "burn_rate": 6.0,
         "severity": "ticket"}]}

Latency metrics add ``max_seconds`` (what counts as a good event).
The burn rate over a window is ``bad_fraction / (1 - target)``; the
objective FAILS when any pair exceeds its ``burn_rate`` in BOTH
windows at the newest recorded timestamp. Window pairs are validated
at spec load (short_s < long_s, positive rates — exit 2 on
violation). Row surfaces only: the batch verdict needs timestamped
request rows, which --spans/--metrics do not carry.

An objective with NO samples fails (a run that measured nothing cannot
claim an SLO was met) and says so in its reason. CLI::

    python -m paddle_tpu_torch.slo spec.json --log run.jsonl [--json]
    python -m paddle_tpu_torch.slo spec.json --log rep0.jsonl rep1.jsonl ...
                                  # fleet: union across replica logs
    python -m paddle_tpu_torch.slo spec.json --spans *.jsonl
    python -m paddle_tpu_torch.slo spec.json --metrics metrics.json

Exit code 0 = every objective passed, 1 = any failed (the CI/chaos
gate contract), 2 = usage or spec error.
"""

import argparse
import json
import os
import sys

from .monitor.metrics import bucket_percentile as _hist_percentile
from .monitor.recorder import percentile_sorted as _pct
from .monitor.recorder import read_jsonl_tolerant

__all__ = [
    "load_spec", "evaluate", "samples_from_events",
    "samples_from_monitor_log", "samples_from_span_logs",
    "samples_from_metrics", "render", "main", "LATENCY_METRICS",
    "GAUGE_METRICS", "DELTA_LATENCY_METRICS", "validate_delta_spec",
    "delta_samples_from_events", "evaluate_delta",
]

# objective metric -> metrics-snapshot histogram. step_latency is the
# ENGINE iteration time on every surface (serving_step dt rows,
# engine.step span durations, ptpu_serving_step_seconds buckets) — the
# training executor's ptpu_step_seconds is a different quantity and is
# deliberately not consulted.
LATENCY_METRICS = {
    "ttft": "ptpu_serving_ttft_seconds",
    "tpot": "ptpu_serving_tpot_seconds",
    "queue_wait": "ptpu_serving_queue_wait_seconds",
    "step_latency": "ptpu_serving_step_seconds",
    # read-your-writes staleness of the sparse serving tier :
    # an online update landing on the pservers -> the first
    # serve reflecting it, measured end-to-end by
    # serving.sparse.measure_staleness (sparse_staleness recorder
    # rows / the ptpu_sparse_staleness_seconds histogram)
    "staleness_s": "ptpu_sparse_staleness_seconds",
    # rolling-weight-update convergence: start of a roll ->
    # 100% of the fleet serving the new artifact version, stamped by
    # serving.autoscale into `roll` recorder rows and the
    # ptpu_fleet_version_convergence_seconds histogram (aborted rolls
    # contribute NO sample — they never converged)
    "version_convergence_s": "ptpu_fleet_version_convergence_seconds",
}

# gauge-valued objectives (thresholds are plain values, not seconds):
# kv_used_blocks gates paged-KV pool pressure from the serving_step
# rows' kv_used_blocks field — an operator bounds "how full
# may the pool run" the same way they bound a latency percentile
GAUGE_METRICS = ("kv_used_blocks", "roll_shed")


def _signals():
    # lazy: the burn math lives with the streaming alerting tier
    # (monitor/signals.py) so the batch verdict here and the live
    # evaluator can never drift
    from .monitor import signals
    return signals


def load_spec(source):
    """Parse + validate a spec (path, JSON string, or dict). Raises
    ValueError on schema violations — a malformed gate spec must fail
    LOUDLY (exit 2), never evaluate to a hollow pass."""
    if isinstance(source, dict):
        spec = source
    else:
        text = source
        if not str(source).lstrip().startswith("{"):
            with open(source) as f:
                text = f.read()
        spec = json.loads(text)
    objectives = spec.get("objectives")
    if not isinstance(objectives, list) or not objectives:
        raise ValueError("SLO spec needs a non-empty 'objectives' list")
    if spec.get("rules") is not None:
        # the signals rule overrides validate HERE, the one spec
        # choke point — every consumer (watch's alerts line, the
        # alerts CLI, a supervisor embedding Signals) gets the same
        # loud load-time failure instead of a traceback out of its
        # own loop
        _signals().build_rules({"rules": spec["rules"],
                                "objectives": []})
    if spec.get("delta") is not None:
        # canary delta objectives live in their own block:
        # they gate candidate-vs-incumbent figures no single-version
        # sample set carries, so they never mix into the objectives
        # ladder above
        validate_delta_spec(spec["delta"])
    for i, obj in enumerate(objectives):
        metric = obj.get("metric")
        if _signals().is_budget_objective(obj):
            # error-budget form: target fraction + burn
            # window pairs, validated loudly at load — including
            # short_s < long_s on every pair
            _signals().validate_budget_objective(
                obj, i, known_metrics=("error_rate",)
                + tuple(LATENCY_METRICS))
        elif metric == "error_rate":
            if not isinstance(obj.get("max_ratio"), (int, float)):
                raise ValueError(
                    "objective %d (error_rate) needs numeric "
                    "'max_ratio'" % i)
        elif metric in LATENCY_METRICS:
            if not isinstance(obj.get("max_seconds"), (int, float)):
                raise ValueError(
                    "objective %d (%s) needs numeric 'max_seconds'"
                    % (i, metric))
            q = obj.get("percentile", 0.95)
            if not (0.0 < float(q) <= 1.0):
                raise ValueError(
                    "objective %d percentile %r outside (0, 1]"
                    % (i, q))
        elif metric == "goodput_fraction":
            if not isinstance(obj.get("min_ratio"), (int, float)):
                raise ValueError(
                    "objective %d (goodput_fraction) needs numeric "
                    "'min_ratio'" % i)
        elif metric in GAUGE_METRICS:
            if not isinstance(obj.get("max_value"), (int, float)):
                raise ValueError(
                    "objective %d (%s) needs numeric 'max_value'"
                    % (i, metric))
            q = obj.get("percentile", 1.0)
            if not (0.0 < float(q) <= 1.0):
                raise ValueError(
                    "objective %d percentile %r outside (0, 1]"
                    % (i, q))
        else:
            raise ValueError(
                "objective %d names unknown metric %r (known: %s, "
                "error_rate)"
                % (i, metric,
                   ", ".join(sorted(list(LATENCY_METRICS)
                                    + list(GAUGE_METRICS)
                                    + ["goodput_fraction"]))))
    return spec


# -- sample extraction (one function per observability surface) ------------

def _empty_samples(source):
    return {"source": source, "requests": 0, "errors": 0,
            "ttft": [], "tpot": [], "queue_wait": [],
            "step_latency": [], "kv_used_blocks": [],
            "staleness_s": [], "version_convergence_s": [],
            "roll_shed": [], "request_rows": [],
            "timed_samples": {},
            "goodput": None, "histograms": {}, "skipped": 0}


def samples_from_events(events, source="events",
                        compute_goodput=True):
    """Exact per-request samples from an iterable of flight-recorder
    event dicts (``serving_request`` rows + ``serving_step`` dt) — the
    ONE rows->samples extraction, shared by the monitor-log surface
    below and the watch dashboard's rolling-window verdict.

    ``compute_goodput=False`` skips the wall-time ledger: callers
    whose event stream is NOT one process's full timeline (the watch
    rolling window, a multi-log union) must supply their own
    per-process rollup instead — a union-timeline ledger would
    collapse concurrent replicas' intervals."""
    out = _empty_samples(source)
    if compute_goodput:
        # the goodput ledger reads the SAME rows (durations +
        # recovery markers); its wall-time attribution backs the
        # goodput_fraction objective on the row surfaces. Only this
        # double-iteration needs the events materialized — the
        # single-pass callers (watch's per-refresh window) keep
        # streaming.
        from .monitor import goodput as _goodput
        events = list(events)
        out["goodput"] = _goodput.ledger_from_events(events)
    def _timed(metric, ts, v):
        # timestamped per-metric samples back the error-budget burn
        # math for LATENCY metrics (error_rate burns over
        # request_rows) — every metric a budget spec may name gets a
        # window-countable series, matching the live evaluator
        out["timed_samples"].setdefault(metric, []).append(
            (float(ts), float(v)))

    for e in events:
        ev = e.get("ev")
        if e.get("shadow"):
            # mirrored traffic (canary analysis plane):
            # scored, never served — excluded from the incumbent
            # verdict wholesale, the same way failed requests are
            # excluded from latency. The DELTA evaluator below reads
            # these rows instead.
            continue
        if ev == "serving_request":
            out["requests"] += 1
            if e.get("ts") is not None:
                # timestamped row triple for the error-budget burn
                # math (monitor/signals.burn_pairs — the ONE window
                # arithmetic the live evaluator shares)
                out["request_rows"].append(
                    (float(e["ts"]), bool(e.get("error")),
                     {k: e.get(k) for k in ("ttft", "tpot",
                                            "queue_wait")}))
            if e.get("error"):
                # error-budget business only: a failed request's retire
                # stamp is the failure time (kill/wedge gap), and its
                # latencies would fail percentile objectives with
                # shutdown artifacts the error_rate already counts
                out["errors"] += 1
                continue
            for k in ("ttft", "tpot", "queue_wait"):
                if e.get(k) is not None:
                    out[k].append(float(e[k]))
                    if e.get("ts") is not None:
                        _timed(k, e["ts"], e[k])
        elif ev == "serving_step":
            if e.get("dt") is not None:
                out["step_latency"].append(float(e["dt"]))
                if e.get("ts") is not None:
                    _timed("step_latency", e["ts"], e["dt"])
            if e.get("kv_used_blocks") is not None:
                out["kv_used_blocks"].append(
                    float(e["kv_used_blocks"]))
        elif ev == "sparse_staleness":
            if e.get("value") is not None:
                out["staleness_s"].append(float(e["value"]))
                if e.get("ts") is not None:
                    _timed("staleness_s", e["ts"], e["value"])
        elif ev == "roll":
            # serving.autoscale rolling-update rows:
            # convergence only from COMPLETED rolls (an aborted roll
            # never reached 100% new-version), shed-during from every
            # roll — aborted or not, shed requests burned real budget
            if not e.get("aborted") \
                    and e.get("convergence_s") is not None:
                out["version_convergence_s"].append(
                    float(e["convergence_s"]))
                if e.get("ts") is not None:
                    _timed("version_convergence_s", e["ts"],
                           e["convergence_s"])
            if e.get("shed_during") is not None:
                out["roll_shed"].append(float(e["shed_during"]))
    return out


def samples_from_monitor_log(paths):
    """Exact per-request samples from ``serving_request`` rows (+
    ``serving_step`` dt for step_latency) of one flight-recorder log —
    or the UNION of several (one log per replica of a serving fleet:
    fleet-wide percentiles come from every process's rows, not a
    single replica's view). ``paths``: one path or a sequence."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    per_file, events, skipped = [], [], 0
    for path in paths:
        evs, sk = read_jsonl_tolerant(path)
        per_file.append(evs)
        events.extend(evs)
        skipped += sk
    out = samples_from_events(
        events, "monitor log%s %s" % ("s" if len(paths) > 1 else "",
                                      ", ".join(map(str, paths))),
        compute_goodput=len(per_file) == 1)
    if len(per_file) > 1:
        # goodput must attribute each PROCESS's own wall clock: over
        # the union timeline, two replicas' concurrent productive
        # intervals would collapse into one (undercounting the fleet)
        # — roll up per-file ledgers instead (Σ productive / Σ wall)
        from .monitor import goodput as _goodput
        out["goodput"] = _goodput.rollup(
            _goodput.ledger_from_events(evs) for evs in per_file)
    out["skipped"] = skipped
    return out


def samples_from_span_logs(paths):
    """Per-request samples from ``serving.request`` spans (their
    close-time attrs carry queue_wait/ttft/tpot) + ``engine.step`` span
    durations, across every span log of a fleet — the merged-timeline
    evaluation surface."""
    out = _empty_samples("span logs %s" % ", ".join(paths))
    for path in paths:
        events, skipped = read_jsonl_tolerant(path)
        out["skipped"] += skipped
        for e in events:
            if e.get("ev") != "span":
                continue
            attrs = e.get("attrs") or {}
            if e.get("name") == "serving.request":
                out["requests"] += 1
                if attrs.get("error"):
                    out["errors"] += 1   # latencies excluded, as above
                    continue
                for k in ("ttft", "tpot", "queue_wait"):
                    if attrs.get(k) is not None:
                        out[k].append(float(attrs[k]))
            elif e.get("name") == "engine.step":
                # the dt attr is the post-admission step time (same
                # quantity as the serving_step row / histogram); the
                # span DURATION also contains the wait-for-batch idle
                # window and is only the fallback for older logs
                out["step_latency"].append(
                    float(attrs.get("dt", e["dur"])))
    return out


def samples_from_metrics(source):
    """Approximate evaluation surface from a registry snapshot —
    ``monitor.dump_metrics('m.json')`` output (or the dict
    ``registry().snapshot()`` returns live). Histogram series merge
    across labels; percentiles interpolate inside buckets."""
    if isinstance(source, dict):
        snap, label = source, "metrics snapshot"
    else:
        with open(source) as f:
            snap = json.load(f)
        label = "metrics snapshot %s" % source
    out = _empty_samples(label)
    for key, hist_name in LATENCY_METRICS.items():
        ent = snap.get(hist_name)
        if not ent or ent.get("kind") != "histogram" \
                or "buckets" not in ent:
            continue
        buckets = [float(b) for b in ent["buckets"]]
        counts = [0] * (len(buckets) + 1)
        for series in ent["series"].values():
            for i, c in enumerate(series.get("counts", ())):
                if i < len(counts):
                    counts[i] += int(c)
        if sum(counts):
            out["histograms"][key] = (buckets, counts)

    def _counter_total(name):
        ent = snap.get(name) or {}
        series = ent.get("series") or {}
        return sum(int(v) for v in series.values()) \
            if ent.get("kind") == "counter" else 0

    failures = _counter_total("ptpu_serving_request_failures_total")
    out["errors"] = failures
    out["requests"] = \
        _counter_total("ptpu_serving_retirements_total") + failures
    return out


# -- delta objectives (canary analysis plane) --------------------
#
# A candidate model is gated against the INCUMBENT, not against fixed
# thresholds: the spec's optional "delta" block declares
# candidate-vs-incumbent objectives evaluated over a mirrored window —
#
#     "delta": {
#       "window_s": 120, "min_pairs": 8, "min_requests": 8,
#       "objectives": [
#         {"metric": "delta_ttft",       "percentile": 0.95,
#          "max_inflation": 1.5},
#         {"metric": "delta_tpot",       "percentile": 0.95,
#          "max_inflation": 1.5},
#         {"metric": "delta_queue_wait", "percentile": 0.95,
#          "max_inflation": 2.0},
#         {"metric": "delta_error_rate", "max_delta": 0.02},
#         {"metric": "token_agreement",  "min_ratio": 0.98}
#       ]
#     }
#
# delta_* latency metrics measure percentile INFLATION (candidate pN /
# incumbent pN, same nearest-rank _pct); delta_error_rate the error-
# fraction difference; token_agreement the exact-agreement fraction
# over joined mirror_pair rows. Like every objective: no samples on
# either side = FAIL with a reason.

DELTA_LATENCY_METRICS = ("delta_ttft", "delta_tpot",
                         "delta_queue_wait")


def validate_delta_spec(delta):
    """Validate one delta block (raises ValueError — same loud-at-load
    contract as load_spec)."""
    if not isinstance(delta, dict):
        raise ValueError("'delta' must be an object")
    objectives = delta.get("objectives")
    if not isinstance(objectives, list) or not objectives:
        raise ValueError("delta block needs a non-empty 'objectives' "
                         "list")
    for k in ("window_s", "min_pairs", "min_requests"):
        if delta.get(k) is not None \
                and not isinstance(delta[k], (int, float)):
            raise ValueError("delta %r must be numeric" % k)
    for i, obj in enumerate(objectives):
        metric = obj.get("metric")
        if metric in DELTA_LATENCY_METRICS:
            if not isinstance(obj.get("max_inflation"), (int, float)):
                raise ValueError(
                    "delta objective %d (%s) needs numeric "
                    "'max_inflation'" % (i, metric))
            q = obj.get("percentile", 0.95)
            if not (0.0 < float(q) <= 1.0):
                raise ValueError(
                    "delta objective %d percentile %r outside (0, 1]"
                    % (i, q))
            floor = obj.get("min_floor_s")
            if floor is not None and (
                    not isinstance(floor, (int, float))
                    or float(floor) <= 0.0):
                raise ValueError(
                    "delta objective %d (%s) 'min_floor_s' must be "
                    "a positive number" % (i, metric))
        elif metric == "delta_error_rate":
            if not isinstance(obj.get("max_delta"), (int, float)):
                raise ValueError(
                    "delta objective %d (delta_error_rate) needs "
                    "numeric 'max_delta'" % i)
        elif metric == "token_agreement":
            r = obj.get("min_ratio")
            if not isinstance(r, (int, float)) \
                    or not (0.0 < float(r) <= 1.0):
                raise ValueError(
                    "delta objective %d (token_agreement) needs "
                    "'min_ratio' in (0, 1]" % i)
        else:
            raise ValueError(
                "delta objective %d names unknown metric %r (known: "
                "%s, delta_error_rate, token_agreement)"
                % (i, metric, ", ".join(DELTA_LATENCY_METRICS)))
    return delta


def delta_samples_from_events(events, version, window_s=None,
                              now=None):
    """Candidate-vs-incumbent sample split from flight-recorder rows.

    ``serving_request`` rows are classified CANDIDATE when stamped
    with the candidate ``version`` (mirrored or canary-served for
    real), INCUMBENT otherwise — except ``shadow`` rows from a foreign
    version (another rollout, warm-up priming), which count on neither
    side. The same rows samples_from_events reads, split instead of
    filtered. ``mirror_pair`` rows for the
    version feed the token-agreement score. ``window_s``/``now`` bound
    the mirrored window by row timestamp."""
    version = str(version)

    def _bucket():
        return {"requests": 0, "errors": 0, "ttft": [], "tpot": [],
                "queue_wait": []}

    out = {"version": version, "pairs": 0, "agree": 0, "match": [],
           "cand": _bucket(), "inc": _bucket()}
    for e in events:
        ev = e.get("ev")
        if window_s is not None and now is not None \
                and e.get("ts") is not None \
                and now - float(e["ts"]) > float(window_s):
            continue
        if ev == "serving_request":
            cand = str(e.get("version")) == version
            if bool(e.get("shadow")) and not cand:
                # mirrored row from a FOREIGN version (another
                # rollout's shadow, or a candidate's warm-up priming
                # request stamped "__prime__"): the exclusion already keeps it
                # off the incumbent surface, and it is not evidence
                # about THIS candidate either — neither side
                continue
            b = out["cand" if cand else "inc"]
            b["requests"] += 1
            if e.get("error"):
                b["errors"] += 1
                continue               # failed-request exclusion, per side
            for k in ("ttft", "tpot", "queue_wait"):
                if e.get(k) is not None:
                    b[k].append(float(e[k]))
        elif ev == "mirror_pair" \
                and str(e.get("version")) == version:
            out["pairs"] += 1
            if e.get("agree"):
                out["agree"] += 1
            if e.get("match") is not None:
                out["match"].append(float(e["match"]))
    return out


def evaluate_delta(delta, dsamples):
    """-> delta verdict dict: {"pass", "version", "pairs",
    "cand_requests", "inc_requests", "objectives": [{metric, threshold,
    measured, pass, reason?}]}. Pure function of (validated delta
    block, delta_samples_from_events output) — the batch CLI gate and
    the live DeltaRule (monitor/signals.py) share it."""
    delta = validate_delta_spec(delta)
    cand, inc = dsamples["cand"], dsamples["inc"]
    results = []
    for obj in delta["objectives"]:
        metric = obj["metric"]
        if metric in DELTA_LATENCY_METRICS:
            base = metric[len("delta_"):]
            q = float(obj.get("percentile", 0.95))
            ent = {"metric": metric, "percentile": q,
                   "threshold": float(obj["max_inflation"]),
                   "cand_n": len(cand[base]), "inc_n": len(inc[base]),
                   "measured": None}
            if not cand[base] or not inc[base]:
                ent.update({"pass": False,
                            "reason": "no %s samples"
                            % ("candidate" if not cand[base]
                               else "incumbent")})
            else:
                cp = _pct(sorted(cand[base]), q)
                ip = _pct(sorted(inc[base]), q)
                ent["measured"] = cp / max(ip, 1e-9)
                ent["pass"] = ent["measured"] <= ent["threshold"]
                floor = obj.get("min_floor_s")
                if floor is not None:
                    # ratio inflation over a near-zero incumbent
                    # baseline reads single-digit-ms queueing as a
                    # huge regression: an absolute floor says
                    # "candidate latency this small is not a
                    # regression, whatever the ratio"
                    ent["min_floor_s"] = float(floor)
                    if not ent["pass"] and cp <= float(floor):
                        ent["pass"] = True
                        ent["reason"] = ("inflation %.1fx over "
                                         "threshold but candidate "
                                         "p%d %.4fs under the "
                                         "%.4fs floor"
                                         % (ent["measured"],
                                            round(q * 100), cp,
                                            float(floor)))
        elif metric == "delta_error_rate":
            ent = {"metric": metric,
                   "threshold": float(obj["max_delta"]),
                   "cand_n": cand["requests"],
                   "inc_n": inc["requests"], "measured": None}
            if not cand["requests"] or not inc["requests"]:
                ent.update({"pass": False,
                            "reason": "no %s requests"
                            % ("candidate" if not cand["requests"]
                               else "incumbent")})
            else:
                ent["measured"] = (
                    cand["errors"] / cand["requests"]
                    - inc["errors"] / inc["requests"])
                ent["pass"] = ent["measured"] <= ent["threshold"]
        else:                            # token_agreement
            ent = {"metric": metric,
                   "threshold": float(obj["min_ratio"]),
                   "pairs": dsamples["pairs"], "measured": None}
            if not dsamples["pairs"]:
                ent.update({"pass": False,
                            "reason": "no joined mirror pairs"})
            else:
                ent["measured"] = (dsamples["agree"]
                                   / dsamples["pairs"])
                ent["pass"] = ent["measured"] >= ent["threshold"]
        if obj.get("name"):
            ent["name"] = obj["name"]
        results.append(ent)
    return {"pass": all(r["pass"] for r in results),
            "version": dsamples.get("version"),
            "pairs": dsamples.get("pairs", 0),
            "cand_requests": cand["requests"],
            "inc_requests": inc["requests"],
            "objectives": results}


# -- evaluation ------------------------------------------------------------

def evaluate(spec, samples):
    """-> verdict dict: {"name", "pass", "source", "requests",
    "errors", "objectives": [{metric, percentile?, threshold,
    measured, count, approximate, pass, reason?}]}. Pure function of
    (validated spec, samples) — the CLI and any CI/chaos gate share
    it."""
    spec = load_spec(spec)
    results = []
    for obj in spec["objectives"]:
        metric = obj["metric"]
        if _signals().is_budget_objective(obj):
            # error-budget burn verdict at the newest recorded
            # timestamp — the batch twin of the live alerting tier,
            # sharing its exact row-window math
            if metric == "error_rate":
                rows = samples.get("request_rows") or []
            else:
                # latency burn: good/bad over the metric's own
                # timestamped samples (the shape the live evaluator's
                # row mode uses), so staleness_s / step_latency budget
                # specs evaluate instead of failing "no samples"
                rows = [(ts, False, {metric: v}) for ts, v in
                        (samples.get("timed_samples") or {})
                        .get(metric, ())]
            now = max((r[0] for r in rows), default=None)
            ent = {"metric": metric, "burn": True,
                   "threshold": min(float(w["burn_rate"])
                                    for w in obj["windows"]),
                   "approximate": False}
            if now is None:
                ent.update({"measured": None, "count": 0,
                            "pass": False,
                            "reason": "no timestamped request rows "
                                      "on this surface"})
            else:
                pairs = _signals().burn_pairs(obj, rows, now)
                fired = [p for p in pairs if p["fired"]]
                # measured = the worst pair's min(burn_short,
                # burn_long) against ITS OWN rate — the figure the
                # fire condition actually gates (both windows must
                # exceed), so measured < threshold on a PASS line and
                # measured >= threshold on a FAIL line by
                # construction; fired pairs win the display
                def _score(p):
                    return min(p["burn_short"], p["burn_long"])
                scored = [p for p in (fired or pairs)
                          if p["burn_short"] is not None
                          and p["burn_long"] is not None]
                worst = max(scored, key=_score) if scored else None
                ent.update({
                    "measured": _score(worst) if worst else None,
                    "threshold": worst["burn_rate"] if worst
                    else ent["threshold"],
                    "count": max(p["n_long"] for p in pairs),
                    "windows": pairs,
                    "pass": not fired})
                if fired:
                    ent["reason"] = "burn >= %s in %s" % (
                        ", ".join("%g" % p["burn_rate"]
                                  for p in fired),
                        ", ".join("%gs/%gs" % (p["short_s"],
                                               p["long_s"])
                                  for p in fired))
                elif ent["measured"] is None:
                    ent.update({"pass": False,
                                "reason": "no samples in any window"})
        elif metric == "error_rate":
            threshold = float(obj["max_ratio"])
            n = samples.get("requests", 0)
            measured = (samples.get("errors", 0) / n) if n else None
            ent = {"metric": metric, "threshold": threshold,
                   "measured": measured, "count": n,
                   "approximate": False}
            if measured is None:
                ent.update({"pass": False,
                            "reason": "no requests observed"})
            else:
                ent["pass"] = measured <= threshold
        elif metric == "goodput_fraction":
            # higher-is-better ratio: the goodput ledger's productive
            # share of measured wall time (monitor/goodput.py), rolled
            # up per process on multi-log sources
            threshold = float(obj["min_ratio"])
            led = samples.get("goodput") or {}
            measured = led.get("goodput_fraction")
            ent = {"metric": metric, "threshold": threshold,
                   "measured": measured,
                   "count": led.get("rows", 0), "approximate": False}
            if measured is None:
                ent.update({"pass": False,
                            "reason": "no timestamped rows observed"})
            else:
                ent["pass"] = measured >= threshold
        else:
            gauge = metric in GAUGE_METRICS
            q = float(obj.get("percentile", 1.0 if gauge else 0.95))
            threshold = float(obj["max_value" if gauge
                                  else "max_seconds"])
            vals = sorted(samples.get(metric) or ())
            approx = False
            if vals:
                measured, count = _pct(vals, q), len(vals)
            else:
                hist = (samples.get("histograms") or {}).get(metric)
                if hist is not None:
                    measured = _hist_percentile(hist[0], hist[1], q)
                    count = sum(hist[1])
                    approx = True
                else:
                    measured, count = None, 0
            ent = {"metric": metric, "percentile": q,
                   "threshold": threshold, "measured": measured,
                   "count": count, "approximate": approx}
            if measured is None:
                ent.update({"pass": False,
                            "reason": "no samples observed"})
            else:
                ent["pass"] = measured <= threshold
        if obj.get("name"):
            ent["name"] = obj["name"]
        results.append(ent)
    return {"name": spec.get("name"),
            "pass": all(r["pass"] for r in results),
            "source": samples.get("source"),
            "requests": samples.get("requests", 0),
            "errors": samples.get("errors", 0),
            "skipped_lines": samples.get("skipped", 0),
            "objectives": results}


def _fmt(metric, v, burn=False):
    if v is None:
        return "n/a"
    if burn:
        return "%.2fx" % v
    if metric in ("error_rate", "goodput_fraction"):
        return "%.2f%%" % (100.0 * v)
    if metric in GAUGE_METRICS:
        return "%g" % v
    return "%.2fms" % (1000.0 * v)


def render(verdict):
    head = "SLO %s: %s  (%s; %d request(s), %d error(s))" % (
        verdict.get("name") or "<unnamed>",
        "PASS" if verdict["pass"] else "FAIL",
        verdict.get("source") or "?", verdict["requests"],
        verdict["errors"])
    lines = [head]
    for r in verdict["objectives"]:
        label = r["metric"]
        if r.get("burn"):
            label += " burn"
        elif "percentile" in r:
            label += " p%g" % (100.0 * r["percentile"])
        cmp_ = ">=" if r["metric"] == "goodput_fraction" else "<"
        if r["metric"] != "goodput_fraction" and not r.get("burn"):
            cmp_ = "<="
        line = "  %-4s %-18s %9s %s %-9s (n=%d%s)" % (
            "PASS" if r["pass"] else "FAIL", label,
            _fmt(r["metric"], r["measured"], r.get("burn")), cmp_,
            _fmt(r["metric"], r["threshold"], r.get("burn")),
            r["count"],
            ", approx" if r.get("approximate") else "")
        if r.get("reason"):
            line += "  [%s]" % r["reason"]
        lines.append(line)
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.slo",
        description="Evaluate a serving SLO spec against recorded "
                    "telemetry; exit 0 = pass, 1 = fail")
    p.add_argument("spec", nargs="?", default=None,
                   help="SLO spec JSON path (default: the "
                        "PADDLE_TPU_SLO_SPEC flag)")
    p.add_argument("--log", nargs="+",
                   help="monitor flight-recorder .jsonl file(s) — "
                        "pass one per replica and the verdict covers "
                        "the fleet-wide union")
    p.add_argument("--spans", nargs="+",
                   help="trace span-log .jsonl file(s) — the merged "
                        "fleet-timeline surface")
    p.add_argument("--metrics",
                   help="metrics snapshot .json "
                        "(monitor.dump_metrics output; approximate)")
    p.add_argument("--json", action="store_true",
                   help="emit the verdict as one JSON object")
    args = p.parse_args(argv)

    spec_path = args.spec
    if not spec_path:
        from . import flags
        spec_path = flags.get_flag("slo_spec")
    if not spec_path:
        p.error("no spec: pass one or set PADDLE_TPU_SLO_SPEC")
    sources = [s for s in (args.log, args.spans, args.metrics)
               if s is not None]
    if len(sources) != 1:
        p.error("exactly one of --log / --spans / --metrics required")

    try:
        spec = load_spec(spec_path)
    except (OSError, ValueError) as e:
        print("paddle_tpu_torch.slo: bad spec %s: %s" % (spec_path, e),
              file=sys.stderr)
        return 2
    try:
        if args.log:
            samples = samples_from_monitor_log(args.log)
        elif args.spans:
            samples = samples_from_span_logs(args.spans)
        else:
            samples = samples_from_metrics(args.metrics)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print("paddle_tpu_torch.slo: unreadable telemetry: %s" % e,
              file=sys.stderr)
        return 2
    verdict = evaluate(spec, samples)
    print(json.dumps(verdict) if args.json else render(verdict))
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
