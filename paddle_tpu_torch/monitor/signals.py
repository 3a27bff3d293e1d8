"""SLO burn-rate alerting, anomaly signals, and the autoscaling
signal plane.

The port's copy of ``paddle_tpu/monitor/signals.py`` (pure Python).

The collector gave the fleet a telemetry plane (live METR scrape, merged
snapshots, the goodput ledger); slo.py gave it a declarative SLO engine.
This module is the layer that turns those STREAMS into DECISIONS — the
multi-window multi-burn-rate alerting tier of the Google SRE Workbook
(ch. 5), evaluated Monarch-style against the collector as the rounds
arrive instead of against a query-time database, plus the sustained-
condition rules and the typed ``scale_hint()`` the ROADMAP direction-2
elastic-fleet supervisor consumes.

The pieces:

  * **Burn-rate evaluation.** An SLO objective in error-budget form —
    ``{"metric": "error_rate", "target": 0.999, "windows": [...]}`` —
    declares a target success fraction and short+long window pairs
    (e.g. 5m/1h fast-burn page, 30m/6h slow-burn ticket). The burn
    rate over a window is ``bad_fraction / (1 - target)``; an alert
    fires when BOTH windows of a pair exceed the pair's ``burn_rate``
    (the long window proves it is sustained, the short window proves
    it is still happening) and clears when the SHORT window recovers.
    Error counts come from the merged fleet snapshot's counters when a
    collector feeds this evaluator — the collector's incarnation-aware
    deltas, so a replica respawn re-bases instead of fabricating a burn spike
    — and from exact recorder rows otherwise (the ``python -m
    paddle_tpu_torch.slo`` batch surface uses the same row math).

  * **Sustained-condition rules with hysteresis.** Queue depth, shed
    rate, pool-dry preemption rate, speculative-acceptance collapse,
    sparse-cache staleness, goodput_fraction — each rule carries a
    fire threshold, a clear threshold on the other side of it, and
    minimum-hold rounds, so a flapping metric yields ONE
    FIRING→RESOLVED pair, not a storm. Values between the thresholds
    hold the current state; a round with NO measurable figure counts
    toward the CLEAR hold instead (a gauge whose source went silent
    past ``stale_s``, a ratio under its denominator floor, an empty
    percentile window) — a dead engine's final queue_depth=50 row
    must not pin an alert, and its scale-up hint, forever.

  * **Incident correlation.** Every transition is emitted exactly
    once, stamped with the triggering windows' figures and the worst
    offenders in-window (trace ids, endpoint + incarnation), counted
    into ``ptpu_alert_transitions_total`` and — recorder armed —
    written as a flight-recorder ``alert`` row. ``python -m
    paddle_tpu_torch.monitor alerts --incident log.jsonl`` splices those
    rows with the goodput ledger's badput intervals into one timeline.

  * **The Signals API.** ``Signals.scale_hint()`` returns a typed
    ``ScaleHint(direction, magnitude, reason)`` derived from sustained
    burn + queue pressure — the exact input a direction-2 autoscaling
    supervisor consumes (scale up on pressure, down only when the
    fleet is quiet AND near-idle for ``down_hold`` rounds).

Window math (hand-computable, pinned in tests/test_signals.py):

  * cumulative counters keep one ``(ts, total)`` point per feed round;
    the windowed delta at ``now`` over ``W`` seconds is
    ``total(now) - total(base)`` where ``base`` is the NEWEST point
    with ``ts <= now - W`` (or the oldest point while the series is
    younger than W — a partial window, never a guess), clamped >= 0;
  * row-derived ratios count the exact rows with
    ``now - W < ts <= now`` — bad/total, no interpolation.

Surfaces: ``python -m paddle_tpu_torch.monitor alerts`` (live collector loop,
offline log replay, ``--incident`` timeline), the ACTIVE ALERTS line of
``monitor watch`` (file mode and ``--fleet``), and ``python -m
paddle_tpu_torch.slo`` for batch burn verdicts over recorded logs.
"""

import bisect
import collections
import time

from .recorder import percentile_sorted, read_jsonl_tolerant

__all__ = [
    "ScaleHint", "Signals", "Rule", "BurnRule", "DeltaRule",
    "SeriesWindow",
    "DEFAULT_RULES", "burn_pairs", "window_counts",
    "validate_budget_objective", "is_budget_objective",
    "build_rules", "render_transition", "active_alerts_line",
    "incident_entries", "render_incident",
]

SEVERITIES = ("page", "ticket")

ScaleHint = collections.namedtuple("ScaleHint",
                                   ("direction", "magnitude", "reason"))


# -- window primitives ------------------------------------------------------

class SeriesWindow:
    """Bounded timestamped samples of ONE series (a cumulative counter
    or a point-in-time gauge). The window math is deliberately exact
    over the stored points — no interpolation — so every figure an
    alert stamps is hand-computable from the samples that produced
    it. Timestamps are kept monotonic (an out-of-order feed clamps to
    the previous point's ts) so base lookups are one bisect, not a
    scan — a 6 h window holds ~10k points and the live loops query
    it every round."""

    def __init__(self, max_age_s=86400.0, maxlen=4096):
        self.max_age_s = float(max_age_s)
        self.maxlen = int(maxlen)
        self._ts = []
        self._vs = []

    def add(self, ts, value):
        if value is None:
            return
        ts = float(ts)
        if self._ts and ts < self._ts[-1]:
            ts = self._ts[-1]
        self._ts.append(ts)
        self._vs.append(float(value))
        start = bisect.bisect_left(self._ts, ts - self.max_age_s)
        start = max(start, len(self._ts) - self.maxlen)
        if start > 0:
            del self._ts[:start]
            del self._vs[:start]

    def __len__(self):
        return len(self._ts)

    def latest(self):
        return (self._ts[-1], self._vs[-1]) if self._ts else None

    def at_or_before(self, ts):
        """Newest stored point with ``ts' <= ts`` (None when every
        point is newer)."""
        i = bisect.bisect_right(self._ts, float(ts)) - 1
        return (self._ts[i], self._vs[i]) if i >= 0 else None

    def delta(self, now, window_s):
        """Windowed cumulative-counter delta ending at ``now``:
        latest total minus the total at the window's base point (see
        module docstring). None with fewer than two points; clamped
        >= 0 so a raw (non-collector) feed whose counter reset cannot
        fabricate a negative spike."""
        if len(self._ts) < 2:
            return None
        base = self.at_or_before(float(now) - float(window_s))
        if base is None:
            base = (self._ts[0], self._vs[0])
        if base[0] >= self._ts[-1]:
            return None
        return max(0.0, self._vs[-1] - base[1])

    def span(self, now, window_s):
        """Seconds actually covered by ``delta`` with the same base
        policy (== window_s once the series is old enough)."""
        if len(self._ts) < 2:
            return None
        base = self.at_or_before(float(now) - float(window_s))
        if base is None:
            base = (self._ts[0], self._vs[0])
        span = self._ts[-1] - base[0]
        return span if span > 0 else None


def window_counts(rows, now, window_s, metric=None, threshold=None):
    """Exact (bad, total) counts over the timestamped request rows in
    ``(now - window_s, now]``. ``rows``: iterable of ``(ts, error,
    figures)`` (the ``request_rows`` the SLO sample extraction
    collects). For ``metric=None`` bad = the request failed
    (error_rate); for a latency metric, bad = the request's figure
    exceeded ``threshold`` (failed rows are the error budget's
    business and are excluded, the failed-request policy)."""
    lo = float(now) - float(window_s)
    bad = total = 0
    for ts, err, figs in rows:
        if ts is None or not (lo < ts <= now):
            continue
        if metric is None:
            total += 1
            bad += 1 if err else 0
        else:
            if err:
                continue
            v = (figs or {}).get(metric)
            if v is None:
                continue
            total += 1
            bad += 1 if float(v) > float(threshold) else 0
    return bad, total


def is_budget_objective(obj):
    """An SLO objective in error-budget form (target + window pairs)
    rather than the single-threshold form."""
    return isinstance(obj, dict) and "windows" in obj


def validate_budget_objective(obj, i=0, known_metrics=("error_rate",)):
    """Schema check for the error-budget objective form (shared with
    ``slo.load_spec`` so a malformed gate spec fails LOUDLY at load,
    exit 2 — including short >= long window pairs)."""
    metric = obj.get("metric")
    if metric not in known_metrics:
        raise ValueError(
            "objective %d (burn) names metric %r; error-budget form "
            "supports: %s" % (i, metric, ", ".join(known_metrics)))
    target = obj.get("target")
    if not isinstance(target, (int, float)) or not 0.0 < target < 1.0:
        raise ValueError(
            "objective %d (%s) error-budget 'target' must be a "
            "fraction in (0, 1), got %r" % (i, metric, target))
    if metric != "error_rate" and \
            not isinstance(obj.get("max_seconds"), (int, float)):
        raise ValueError(
            "objective %d (%s) error-budget form needs numeric "
            "'max_seconds' (what counts as a good event)" % (i, metric))
    windows = obj.get("windows")
    if not isinstance(windows, list) or not windows:
        raise ValueError(
            "objective %d (%s) needs a non-empty 'windows' list"
            % (i, metric))
    for j, w in enumerate(windows):
        if not isinstance(w, dict):
            raise ValueError("objective %d window %d is not an object"
                             % (i, j))
        short, long_ = w.get("short_s"), w.get("long_s")
        rate = w.get("burn_rate")
        for key, v in (("short_s", short), ("long_s", long_),
                       ("burn_rate", rate)):
            if not isinstance(v, (int, float)) or v <= 0:
                raise ValueError(
                    "objective %d window %d needs positive numeric "
                    "%r, got %r" % (i, j, key, v))
        if not short < long_:
            raise ValueError(
                "objective %d window %d: short_s %g must be < "
                "long_s %g (the pair is short-confirms-long by "
                "construction)" % (i, j, short, long_))
        sev = w.get("severity", "page")
        if sev not in SEVERITIES:
            raise ValueError(
                "objective %d window %d severity %r not in %s"
                % (i, j, sev, SEVERITIES))


def burn_pairs(objective, rows, now):
    """Evaluate every window pair of an error-budget objective over
    exact request rows at time ``now`` -> list of pair figures::

        {"short_s", "long_s", "burn_rate", "severity",
         "ratio_short", "ratio_long", "burn_short", "burn_long",
         "n_short", "n_long", "fired"}

    THE row-surface burn math — shared verbatim by the streaming
    evaluator's row mode and ``python -m paddle_tpu_torch.slo``'s batch
    verdict, so the two can never drift."""
    metric = objective["metric"]
    threshold = objective.get("max_seconds")
    m = None if metric == "error_rate" else metric
    budget = 1.0 - float(objective["target"])
    out = []
    for w in objective["windows"]:
        bs, ns = window_counts(rows, now, w["short_s"], m, threshold)
        bl, nl = window_counts(rows, now, w["long_s"], m, threshold)
        ratio_s = (bs / ns) if ns else None
        ratio_l = (bl / nl) if nl else None
        burn_s = (ratio_s / budget) if ratio_s is not None else None
        burn_l = (ratio_l / budget) if ratio_l is not None else None
        rate = float(w["burn_rate"])
        out.append({
            "short_s": float(w["short_s"]), "long_s": float(w["long_s"]),
            "burn_rate": rate, "severity": w.get("severity", "page"),
            "ratio_short": ratio_s, "ratio_long": ratio_l,
            "burn_short": burn_s, "burn_long": burn_l,
            "n_short": ns, "n_long": nl,
            "fired": (burn_s is not None and burn_l is not None
                      and burn_s >= rate and burn_l >= rate),
        })
    return out


# -- rules ------------------------------------------------------------------

class _StateMachine:
    """Exactly-once FIRING/RESOLVED edges with minimum-hold rounds.
    ``step`` returns the transition this round produced (or None); by
    construction each edge is emitted once — the exactly-once contract
    the tests pin under flapping input."""

    def __init__(self, hold, clear_hold):
        self.firing = False
        self.streak = 0
        self.hold = max(1, int(hold))
        self.clear_hold = max(1, int(clear_hold))
        self.since = None

    def step(self, fire_cond, clear_cond, now):
        if not self.firing:
            self.streak = self.streak + 1 if fire_cond else 0
            if self.streak >= self.hold:
                self.firing, self.streak, self.since = True, 0, now
                return "FIRING"
        else:
            self.streak = self.streak + 1 if clear_cond else 0
            if self.streak >= self.clear_hold:
                self.firing, self.streak, self.since = False, 0, None
                return "RESOLVED"
        return None


class Rule:
    """One sustained-condition rule over a named series. ``kind``:

      gauge   figure = the series' latest point value — IF fresh:
              a point older than ``stale_s`` stops counting (a dead
              engine's final row is not live pressure)
      rate    figure = windowed counter delta / covered seconds
      ratio   figure = delta(num) / delta(den) over the window
              (skipped while delta(den) < min_den — an acceptance
              rate over 3 drafts is noise, not a collapse)
      pctl    figure = q-percentile of the samples in the window

    ``direction`` "above": fires at figure >= fire, clears at
    figure < clear (clear <= fire); "below" mirrors it. A None figure
    (nothing measurable this round) counts toward the CLEAR hold: a
    brief gap shorter than ``clear_hold`` rounds holds a FIRING
    state, sustained absence resolves it — data that stopped is not
    pressure, and an alert must never outlive its source."""

    def __init__(self, name, kind, series, fire, clear,
                 direction="above", window_s=60.0, hold=2,
                 clear_hold=2, severity="ticket", num=None, den=None,
                 min_den=0, q=0.95, stale_s=120.0):
        if severity not in SEVERITIES:
            raise ValueError("rule %r severity %r not in %s"
                             % (name, severity, SEVERITIES))
        if direction not in ("above", "below"):
            raise ValueError("rule %r direction %r" % (name, direction))
        fire, clear = float(fire), float(clear)
        if direction == "above" and clear > fire:
            raise ValueError(
                "rule %r: clear %g must be <= fire %g (direction "
                "'above' hysteresis)" % (name, clear, fire))
        if direction == "below" and clear < fire:
            raise ValueError(
                "rule %r: clear %g must be >= fire %g (direction "
                "'below' hysteresis)" % (name, clear, fire))
        self.name = name
        self.kind = kind
        self.series = series
        self.num, self.den, self.min_den = num, den, float(min_den)
        self.fire, self.clear = fire, clear
        self.direction = direction
        self.window_s = float(window_s)
        self.severity = severity
        self.q = float(q)
        self.stale_s = float(stale_s)
        self.sm = _StateMachine(hold, clear_hold)

    # -- figure -------------------------------------------------------------
    def figure(self, signals, now):
        """-> (value, figures dict) for this round; (None, {}) =
        nothing measurable."""
        if self.kind == "gauge":
            p = signals._series_latest(self.series)
            if p is None or now - p[0] > self.stale_s:
                # the latest point went stale: its source stopped
                # reporting, so it is no longer a live figure
                return None, ({} if p is None else {"stale": True})
            return p[1], {"value": p[1], "ts": p[0]}
        if self.kind == "rate":
            sw = signals._series.get(self.series)
            if sw is None:
                return None, {}
            d = sw.delta(now, self.window_s)
            span = sw.span(now, self.window_s)
            if d is None or not span:
                return None, {}
            return d / span, {"delta": d, "span_s": span,
                              "window_s": self.window_s}
        if self.kind == "ratio":
            num = signals._series.get(self.num)
            den = signals._series.get(self.den)
            if num is None or den is None:
                return None, {}
            dn = num.delta(now, self.window_s)
            dd = den.delta(now, self.window_s)
            if dn is None or dd is None or dd < max(1.0, self.min_den):
                return None, {}
            return dn / dd, {"num_delta": dn, "den_delta": dd,
                             "window_s": self.window_s}
        if self.kind == "pctl":
            vals = sorted(
                v for ts, v in signals._samples.get(self.series, ())
                if now - self.window_s < ts <= now)
            if not vals:
                return None, {}
            v = percentile_sorted(vals, self.q)
            return v, {"q": self.q, "n": len(vals),
                       "window_s": self.window_s}
        raise AssertionError(self.kind)

    def conditions(self, value):
        if value is None:
            # nothing measurable: count toward the clear hold — a
            # transient gap (< clear_hold rounds) holds state, a
            # sustained one resolves the alert instead of pinning it
            return False, True
        if self.direction == "above":
            return value >= self.fire, value < self.clear
        return value <= self.fire, value > self.clear


class BurnRule:
    """One (objective, window pair) burn alert. Fires when BOTH the
    short and long windows burn the error budget at >= ``burn_rate``;
    clears when the SHORT window recovers (the long window decays too
    slowly to gate recovery — SRE Workbook ch. 5) or the long window
    goes completely quiet (no events at all = nothing is burning)."""

    def __init__(self, objective, window, hold=1, clear_hold=2):
        self.objective = objective
        self.window = window
        metric = objective["metric"]
        self.name = "burn:%s:%gs/%gs" % (
            metric, window["short_s"], window["long_s"])
        self.severity = window.get("severity", "page")
        self.rate = float(window["burn_rate"])
        self.metric = metric
        self.sm = _StateMachine(hold, clear_hold)

    def figure(self, signals, now):
        metric = self.metric
        if metric == "error_rate" and signals._counter_mode == \
                "snapshot":
            # counter-derived: the collector's merged totals are
            # incarnation-aware, so a replica respawn re-bases
            # instead of fabricating a burn spike
            pair = self._pair_from_counters(signals, now)
        else:
            rows = signals._rows if metric == "error_rate" else None
            if rows is None:
                rows = [(ts, False, {metric: v})
                        for ts, v in signals._samples.get(metric, ())]
            pair = burn_pairs(
                {"metric": metric, "target": self.objective["target"],
                 "max_seconds": self.objective.get("max_seconds"),
                 "windows": [self.window]}, rows, now)[0]
        return pair["burn_short"], pair

    def _pair_from_counters(self, signals, now):
        budget = 1.0 - float(self.objective["target"])
        errs = signals._series.get("errors")
        reqs = signals._series.get("requests")
        out = {"short_s": float(self.window["short_s"]),
               "long_s": float(self.window["long_s"]),
               "burn_rate": self.rate, "severity": self.severity,
               "source": "counters"}
        for label, w in (("short", out["short_s"]),
                         ("long", out["long_s"])):
            de = errs.delta(now, w) if errs is not None else None
            dr = reqs.delta(now, w) if reqs is not None else None
            ratio = (de / dr) if (de is not None and dr) else None
            out["n_" + label] = dr or 0
            out["ratio_" + label] = ratio
            out["burn_" + label] = (ratio / budget) \
                if ratio is not None else None
        out["fired"] = (out["burn_short"] is not None
                        and out["burn_long"] is not None
                        and out["burn_short"] >= self.rate
                        and out["burn_long"] >= self.rate)
        return out

    def conditions(self, pair):
        if pair is None:
            return False, False
        fire = pair["fired"]
        # clear: the short window recovered below the threshold — or
        # went completely quiet (zero events in the short window is a
        # burn rate of ZERO, not unknown: budget burns with bad
        # events, and traffic absence is a different alert's job)
        clear = (pair["burn_short"] is not None
                 and pair["burn_short"] < self.rate) \
            or not pair["n_short"]
        return fire, clear


class DeltaRule:
    """Candidate-vs-incumbent delta verdict over a mirrored window
   . ``Signals.feed_events`` forwards serving_request and
    mirror_pair recorder rows to ``observe_row``; ``figure`` stays
    pending (value None) until ``min_pairs`` joined shadow pairs AND
    ``min_requests`` per side have landed inside ``window_s``, then
    decides EXACTLY ONCE via ``slo.evaluate_delta`` and emits the
    verdict row through ``monitor.runtime.on_verdict``. A FAIL verdict
    fires through the normal Signals edge machinery — offender
    correlation, tail-trace retention, forensics capture — at
    severity "page"; a PASS verdict never fires and the rule goes
    inert (a verdict is a decision, not a pressure level, so the
    state machine's clear hold is effectively infinite).
    ``force("FAIL", reason)`` decides immediately without waiting for
    the gates — the rollout controller's forced-rollback path."""

    kind = "delta"

    def __init__(self, delta, version, phase="shadow", name=None,
                 severity="page"):
        from .. import slo as _slo
        self.delta = _slo.validate_delta_spec(delta)
        self.version = str(version)
        self.phase = str(phase)
        self.name = name or "delta:%s:%s" % (self.phase, self.version)
        if severity not in SEVERITIES:
            raise ValueError("rule %r severity %r not in %s"
                             % (self.name, severity, SEVERITIES))
        self.severity = severity
        self.window_s = float(self.delta.get("window_s", 120.0))
        self.min_pairs = int(self.delta.get("min_pairs", 8))
        self.min_requests = int(self.delta.get("min_requests", 8))
        self.sm = _StateMachine(1, 10 ** 9)
        self._events = collections.deque(maxlen=65536)
        self.verdict = None        # None until decided: "PASS"/"FAIL"
        self.report = None         # evaluate_delta dict (or forced)
        self._forced = None

    # -- feeding ------------------------------------------------------------
    def observe_row(self, e, ts):
        if self.verdict is not None:
            return                 # decided: stop buffering
        ev = e.get("ev")
        if ev == "serving_request":
            if self.phase != "shadow" and e.get("shadow"):
                # a CANARY verdict judges canary-SERVED traffic: a
                # late mirror copy draining out of the shadow phase
                # is not evidence about the split (and counting it
                # could satisfy the request gate before a single
                # canary request was sampled)
                return
        elif not (ev == "mirror_pair"
                  and str(e.get("version")) == self.version):
            return
        if e.get("ts") is None:
            e = dict(e, ts=ts)
        self._events.append(e)

    def force(self, verdict, reason="forced"):
        """Decide immediately (rollout controller override); the next
        evaluate() round emits the exactly-once verdict edge."""
        if self.verdict is None and self._forced is None:
            self._forced = (str(verdict).upper(), str(reason))

    # -- figure -------------------------------------------------------------
    def _decide(self, verdict, report):
        from . import runtime as _monrt
        self.verdict = verdict
        self.report = report
        self._events.clear()
        _monrt.on_verdict(
            self.phase, self.version, verdict,
            figures=report.get("objectives"),
            pairs=report.get("pairs"),
            requests=report.get("cand_requests"),
            reason=report.get("reason"), rule=self.name)

    def figure(self, signals, now):
        if self.verdict is None and self._forced is not None:
            v, why = self._forced
            self._decide(v, {"pass": v == "PASS", "forced": True,
                             "reason": why, "version": self.version,
                             "pairs": 0, "cand_requests": 0,
                             "inc_requests": 0, "objectives": []})
        if self.verdict is not None:
            figs = {"verdict": self.verdict, "version": self.version,
                    "phase": self.phase}
            if isinstance(self.report, dict):
                figs["report"] = self.report
            return (1.0 if self.verdict == "FAIL" else 0.0), figs
        from .. import slo as _slo
        ds = _slo.delta_samples_from_events(
            self._events, self.version, window_s=self.window_s,
            now=now)
        pend = {"pending": True, "pairs": ds["pairs"],
                "cand_requests": ds["cand"]["requests"],
                "inc_requests": ds["inc"]["requests"],
                "min_pairs": self.min_pairs,
                "min_requests": self.min_requests}
        if (ds["pairs"] < self.min_pairs
                or ds["cand"]["requests"] < self.min_requests
                or ds["inc"]["requests"] < self.min_requests):
            return None, pend
        rep = _slo.evaluate_delta(self.delta, ds)
        self._decide("PASS" if rep["pass"] else "FAIL", rep)
        return (0.0 if rep["pass"] else 1.0), {
            "verdict": self.verdict, "version": self.version,
            "phase": self.phase, "report": rep}

    def conditions(self, value):
        if value is None:
            return False, False    # pending: hold, never auto-clear
        return value >= 1.0, False


# rule-name -> constructor kwargs. Thresholds are serving-shaped
# defaults; a spec's "rules" object overrides any field (or disables a
# rule with false). The windows are short on purpose — these are
# liveness rules evaluated per scrape round, not capacity planning.
DEFAULT_RULES = {
    # router + engine queue pressure (ptpu_serving_queue_depth +
    # ptpu_fleet_queue_depth, summed): the direction-2 scale-up signal
    "queue_depth": dict(kind="gauge", series="queue_depth",
                        direction="above", fire=32.0, clear=8.0,
                        hold=2, clear_hold=2, severity="ticket",
                        stale_s=120.0),
    # typed Overloaded sheds per second (counter-derived rate): the
    # router is REFUSING work — page, and scale up
    "shed_rate": dict(kind="rate", series="shed", window_s=30.0,
                      direction="above", fire=0.5, clear=0.05,
                      hold=2, clear_hold=2, severity="page"),
    # pool-dry preemptions per second (pressure ladder's
    # last rung): sustained re-prefill churn burns goodput
    "preemption_rate": dict(kind="rate", series="preemptions",
                            window_s=60.0, direction="above",
                            fire=0.5, clear=0.05, hold=2,
                            clear_hold=2, severity="ticket"),
    # speculative acceptance collapse: drafts are burning
    # scoring compute they no longer repay
    "spec_accept_collapse": dict(kind="ratio", series=None,
                                 num="spec_accepted",
                                 den="spec_drafted", min_den=20,
                                 window_s=60.0, direction="below",
                                 fire=0.15, clear=0.3, hold=3,
                                 clear_hold=2, severity="ticket"),
    # sparse read-your-writes staleness p95 (rows)
    "sparse_staleness": dict(kind="pctl", series="staleness_s",
                             window_s=120.0, q=0.95,
                             direction="above", fire=30.0, clear=10.0,
                             hold=2, clear_hold=2, severity="ticket"),
    # rolling goodput fraction (fed by the watch/alerts loops from
    # the per-process ledger rollup)
    "goodput_fraction": dict(kind="gauge", series="goodput_fraction",
                             direction="below", fire=0.5, clear=0.7,
                             hold=3, clear_hold=2, severity="ticket",
                             stale_s=300.0),
}


def build_rules(spec=None):
    """Rule set from an SLO/signals spec dict: the DEFAULT_RULES
    sustained conditions (overridden / disabled per name by the
    spec's ``"rules"`` object) plus one BurnRule per (error-budget
    objective, window pair). ``spec`` None = defaults only."""
    overrides = dict((spec or {}).get("rules") or {})
    rules = []
    for name, base in DEFAULT_RULES.items():
        ov = overrides.pop(name, None)
        if ov is False or (isinstance(ov, dict)
                           and ov.get("enabled") is False):
            continue
        kw = dict(base)
        if isinstance(ov, dict):
            bad = set(ov) - set(base) - {"enabled"}
            if bad:
                raise ValueError(
                    "rule %r override names unknown field(s) %s"
                    % (name, sorted(bad)))
            kw.update({k: v for k, v in ov.items()
                       if k != "enabled"})
        rules.append(Rule(name, **kw))
    if overrides:
        raise ValueError("spec 'rules' names unknown rule(s) %s "
                         "(known: %s)" % (sorted(overrides),
                                          sorted(DEFAULT_RULES)))
    for obj in (spec or {}).get("objectives") or ():
        if is_budget_objective(obj):
            for w in obj["windows"]:
                rules.append(BurnRule(obj, w))
    return rules


# -- the streaming evaluator ------------------------------------------------

# snapshot counter name -> internal series (summed across label series)
_SNAP_COUNTERS = {
    "errors": ("ptpu_serving_request_failures_total",),
    "requests": ("ptpu_serving_retirements_total",
                 "ptpu_serving_request_failures_total"),
    "shed": ("ptpu_fleet_shed_total",),
    "preemptions": ("ptpu_serving_preemptions_total",),
    "spec_drafted": ("ptpu_spec_drafted_tokens_total",),
    "spec_accepted": ("ptpu_spec_accepted_tokens_total",),
}
_SNAP_GAUGES = {
    "queue_depth": ("ptpu_serving_queue_depth",
                    "ptpu_fleet_queue_depth"),
    "occupancy": ("ptpu_serving_slot_occupancy",),
}


def _snap_sum(snap, names):
    """Summed value across every label series of the named metrics;
    None when ALL are absent (absent != zero — a fleet without a
    router must not start a shed series at 0)."""
    total, seen = 0.0, False
    for name in names:
        ent = snap.get(name)
        if not isinstance(ent, dict) or "series" not in ent:
            continue
        seen = True
        for v in ent["series"].values():
            total += float(v)
    return total if seen else None


class Signals:
    """The streaming evaluator: feed it merged fleet snapshots and/or
    recorder rows, call ``evaluate()`` once per round, read the typed
    transitions / ``active()`` set / ``scale_hint()``.

    One evaluator serves both deployment shapes:

      * collector mode (``feed_snapshot`` called): counter series come
        from the merged fleet snapshot — incarnation-aware by the collector
        construction — and rows are used for latency samples and
        offender correlation only;
      * file/row mode (rows only): cumulative series are derived from
        the rows themselves (running totals), so a single-process run
        gets the same alerting without a collector.

    Deterministic: every feed/evaluate takes an explicit ``now``
    (tests drive synthetic clocks); omitted, the newest fed timestamp
    (then wall time) is used."""

    def __init__(self, spec=None, rules=None, max_age_s=None,
                 down_occupancy=0.25, down_hold=5, up_queue_factor=2.0):
        self._rules = list(rules) if rules is not None \
            else build_rules(spec)
        if max_age_s is None:
            max_age_s = 600.0
            for r in self._rules:
                if isinstance(r, BurnRule):
                    max_age_s = max(max_age_s,
                                    2.0 * r.window["long_s"])
                elif r.kind != "gauge":
                    max_age_s = max(max_age_s, 2.0 * r.window_s)
        # point caps SCALE with the configured windows (one counter
        # point lands per feed round, one sample per row): a 6 h long
        # window at a 2 s scrape interval needs ~10.8k points, and a
        # cap below that would silently move the window base forward
        # — the "newest point at or before now - W, never a guess"
        # contract would quietly become a guess. Row/sample deques get
        # extra headroom for bursty traffic; fleets whose row RATE
        # outruns it should gate burn on the counter surface (the
        # collector path), which is bounded by rounds, not requests.
        self._pts_cap = max(4096, int(max_age_s))
        self._series = {}                 # name -> SeriesWindow
        self._samples = collections.defaultdict(
            lambda: collections.deque(maxlen=4 * self._pts_cap))
        self._rows = collections.deque(maxlen=4 * self._pts_cap)
        self._offenders = collections.deque(maxlen=256)
        self._max_age_s = float(max_age_s)
        self._counter_mode = None         # "snapshot" | "rows" | None
        self._row_totals = collections.Counter()
        # engine -> last serving_step row. LRU-bounded AND age-gated
        # when summed (_engine_rows): under respawn churn every new
        # engine label is a fresh key, and a dead engine's final row
        # (queue_depth 50 as it wedged) must not vote in the summed
        # gauges forever — the WatchState.goodput_events discipline
        self._engine_last = collections.OrderedDict()
        self._endpoint_meta = {}          # endpoint -> {role, inc}
        self._active = {}                 # rule -> active-alert dict
        self._idle_streak = 0
        self._last_ts = None
        self.down_occupancy = float(down_occupancy)
        self.down_hold = int(down_hold)
        self.up_queue_factor = float(up_queue_factor)
        self.rounds = 0
        self.transitions = []             # bounded history
        self.spec = spec
        # forensics: called with each FIRING transition dict (monitor.
        # forensics.attach installs the black-box capture coordinator
        # here); exceptions are swallowed — detection must never die
        # because a capture did
        self.capture_hook = None
        # autoscaling: called with the round's ScaleHint after every
        # evaluate() (serving.autoscale installs its controller here —
        # same discipline as capture_hook: exceptions are swallowed,
        # detection must never die because a scaler did)
        self.scale_hook = None

    # -- feeding -----------------------------------------------------------
    def _sw(self, name):
        sw = self._series.get(name)
        if sw is None:
            sw = self._series[name] = SeriesWindow(
                self._max_age_s, maxlen=self._pts_cap)
        return sw

    def _series_latest(self, name):
        sw = self._series.get(name)
        return sw.latest() if sw is not None else None

    def _note_ts(self, ts):
        if ts is not None and (self._last_ts is None
                               or ts > self._last_ts):
            self._last_ts = ts

    def feed_snapshot(self, snap, now=None):
        """One merged fleet snapshot (``Collector.fleet_snapshot()``
        schema; a single ``Registry.snapshot()`` works too). Switches
        the error counters to snapshot mode — rows stop counting so
        the same request is never counted twice."""
        from .metrics import META_KEY
        now = time.time() if now is None else float(now)
        self._note_ts(now)
        self._counter_mode = "snapshot"
        for series, names in _SNAP_COUNTERS.items():
            self._sw(series).add(now, _snap_sum(snap, names))
        self._sw("queue_depth").add(
            now, _snap_sum(snap, _SNAP_GAUGES["queue_depth"]))
        occ = _snap_sum(snap, _SNAP_GAUGES["occupancy"])
        if occ is not None:
            # the collector SUMS gauges over processes, but occupancy
            # is a 0..1 per-process fraction — store the mean so the
            # scale-down threshold keeps its meaning on an N-replica
            # fleet (approximate: engine-less processes in the count
            # dilute it downward, which only errs toward an easier
            # scale-down that the queue==0 + no-alerts gates still
            # guard)
            procs = (snap.get(META_KEY) or {}).get("processes") or 1
            self._sw("occupancy").add(now, occ / max(1, procs))
        for ep in (snap.get(META_KEY) or {}).get("endpoints") or ():
            if isinstance(ep, dict) and ep.get("endpoint"):
                self._endpoint_meta[ep["endpoint"]] = {
                    "role": ep.get("role"),
                    "incarnation": ep.get("incarnation")}

    def feed_events(self, events, now=None):
        """Flight-recorder rows (scraped deltas or tailed lines).
        Always the source of latency samples, staleness samples, and
        offender correlation; additionally the source of cumulative
        counters and queue/occupancy gauges when no snapshot feeds
        this evaluator (file mode)."""
        row_mode = self._counter_mode != "snapshot"
        if row_mode:
            self._counter_mode = "rows"
        delta_rules = [r for r in self._rules
                       if hasattr(r, "observe_row")]
        for e in events:
            ts = e.get("ts")
            if ts is None:
                ts = time.time() if now is None else float(now)
            self._note_ts(ts)
            ev = e.get("ev")
            if delta_rules and ev in ("serving_request",
                                      "mirror_pair"):
                for r in delta_rules:
                    r.observe_row(e, ts)
            if ev == "serving_request":
                if e.get("shadow"):
                    # mirrored copy: scored, never served — it must
                    # not move the incumbent's SLO samples, counters,
                    # or gauges (the failed-request exclusion discipline, now
                    # applied to a whole request class). An ERRORED
                    # shadow row still lands in the offender ring so
                    # a FAIL delta verdict can name its traces.
                    if e.get("error"):
                        self._offenders.append({
                            "ts": ts, "trace": e.get("trace"),
                            "proc": e.get("proc"),
                            "engine": e.get("engine"),
                            "why": str(e.get("error"))[:120]})
                    continue
                err = e.get("error")
                self._rows.append((ts, bool(err), {
                    k: e.get(k) for k in ("ttft", "tpot",
                                          "queue_wait")}))
                if err:
                    self._offenders.append({
                        "ts": ts, "trace": e.get("trace"),
                        "proc": e.get("proc"),
                        "engine": e.get("engine"),
                        "why": str(err)[:120]})
                else:
                    for k in ("ttft", "tpot", "queue_wait"):
                        if e.get(k) is not None:
                            self._samples[k].append((ts, float(e[k])))
                if row_mode:
                    self._row_totals["requests"] += 1
                    if err:
                        self._row_totals["errors"] += 1
                        if "Overloaded" in str(err):
                            # the router's typed shed lands as an
                            # error row under its label; in
                            # file mode that row IS the shed signal
                            self._row_totals["shed"] += 1
                    self._sw("requests").add(
                        ts, self._row_totals["requests"])
                    self._sw("errors").add(
                        ts, self._row_totals["errors"])
                    self._sw("shed").add(ts, self._row_totals["shed"])
            elif ev == "serving_step":
                if e.get("shadow"):
                    # candidate engine scoring mirrored work: its
                    # queue depth / occupancy must not vote in the
                    # summed gauges scale_hint() and the pressure
                    # rules read — shadow load is not live pressure
                    continue
                if e.get("dt") is not None:
                    # per-logical-step engine latency: the sample a
                    # step_latency burn rule windows over
                    self._samples["step_latency"].append(
                        (ts, float(e["dt"])))
                eng = e.get("engine") or "engine"
                self._engine_last[eng] = e
                self._engine_last.move_to_end(eng)
                while len(self._engine_last) > self._ENGINES_MAX:
                    self._engine_last.popitem(last=False)
                if row_mode:
                    if e.get("preempted"):
                        self._row_totals["preemptions"] += \
                            int(e["preempted"])
                    self._sw("preemptions").add(
                        ts, self._row_totals["preemptions"])
                    rows = self._engine_rows(ts)
                    if e.get("queue_depth") is not None:
                        self._sw("queue_depth").add(
                            ts, sum(float(r.get("queue_depth") or 0)
                                    for r in rows))
                    if e.get("slots"):
                        # MEAN across live engines (occupancy is a
                        # per-engine 0..1 fraction; a sum would make
                        # the scale-down threshold unreachable on a
                        # multi-engine fleet)
                        occs = [(r.get("active") or 0) / r["slots"]
                                for r in rows if r.get("slots")]
                        if occs:
                            self._sw("occupancy").add(
                                ts, sum(occs) / len(occs))
                    if e.get("spec_dispatches") is not None:
                        # spec_* row fields are CUMULATIVE per engine
                        # (last-row arithmetic, the spec-counter discipline)
                        self._sw("spec_drafted").add(
                            ts, sum(float(r.get("spec_drafted") or 0)
                                    for r in rows))
                        self._sw("spec_accepted").add(
                            ts, sum(float(r.get("spec_accepted") or 0)
                                    for r in rows))
            elif ev == "sparse_staleness":
                if e.get("value") is not None:
                    self._samples["staleness_s"].append(
                        (ts, float(e["value"])))

    # per-engine last-row retention: LRU key bound + the age horizon
    # a silent engine's final row keeps voting in the summed gauges
    _ENGINES_MAX = 64
    _ENGINE_STALE_S = 120.0

    def _engine_rows(self, now):
        """Live engines' last serving_step rows: rows older than the
        staleness horizon stop voting (a dead engine's cumulative
        spec_* totals dropping out makes the summed series DIP — the
        window delta clamps at 0 and resumes, which beats a dead
        replica's queue_depth=50 pinning an alert forever)."""
        return [r for r in self._engine_last.values()
                if (r.get("ts") or now) > now - self._ENGINE_STALE_S]

    def feed_sample(self, name, value, now=None):
        """Externally computed point sample (the watch/alerts loops
        feed the rolling goodput_fraction rollup here)."""
        if value is None:
            return
        now = time.time() if now is None else float(now)
        self._note_ts(now)
        self._sw(name).add(now, float(value))

    # -- evaluation --------------------------------------------------------
    def evaluate(self, now=None):
        """One evaluation round over every rule -> the list of typed
        transitions this round produced (exactly-once edges). Each
        transition also ticks ``ptpu_alert_transitions_total``, sets
        ``ptpu_alerts_active``, and — recorder armed — lands an
        ``alert`` flight-recorder row stamped with the window figures
        and the worst offenders in-window."""
        if now is None:
            now = self._last_ts if self._last_ts is not None \
                else time.time()
        now = float(now)
        transitions = []
        for rule in self._rules:
            value, figures = rule.figure(self, now)
            if isinstance(rule, BurnRule):
                fire_cond, clear_cond = rule.conditions(figures or None)
            else:
                fire_cond, clear_cond = rule.conditions(value)
            edge = rule.sm.step(fire_cond, clear_cond, now)
            if rule.sm.firing and rule.name in self._active:
                self._active[rule.name].update(value=value,
                                               figures=figures)
            if edge is None:
                continue
            tr = {"rule": rule.name, "severity": rule.severity,
                  "state": edge, "ts": now, "value": value,
                  "figures": figures}
            if edge == "FIRING":
                tr["offenders"] = self.offenders(now)
                self._active[rule.name] = {
                    "severity": rule.severity, "since": now,
                    "value": value, "figures": figures}
                # tail retention: the incident NAMES its offender
                # traces — promote them now, before the span ring
                # rotates past the onset (sampled-out spans included)
                try:
                    from ..trace import runtime as _trc
                    for o in tr["offenders"]:
                        if o.get("trace"):
                            _trc.retain_trace(o["trace"], "offender")
                except Exception:
                    pass
                hook = self.capture_hook
                if hook is not None:
                    try:
                        hook(tr)
                    except Exception:
                        pass
            else:
                self._active.pop(rule.name, None)
            transitions.append(tr)
        self._update_idle(now)
        self.rounds += 1
        shook = self.scale_hook
        if shook is not None:
            try:
                shook(self.scale_hint())
            except Exception:
                pass
        if transitions:
            from . import runtime as _rt
            for tr in transitions:
                _rt.on_alert(tr["rule"], tr["severity"], tr["state"],
                             value=tr["value"],
                             figures=tr.get("figures"),
                             offenders=tr.get("offenders"),
                             active=len(self._active),
                             at=tr["ts"])
            self.transitions.extend(transitions)
            del self.transitions[:-1024]
        return transitions

    def observe(self, snapshot=None, events=(), now=None):
        """Convenience round: feed (snapshot first, so counters land
        in snapshot mode before the same round's rows) + evaluate."""
        if snapshot is not None:
            self.feed_snapshot(snapshot, now=now)
        if events:
            self.feed_events(events, now=now)
        return self.evaluate(now=now)

    def replay(self, events, round_s=1.0, goodput=False):
        """Offline evaluation of a recorded row stream: rows are
        grouped into ``round_s`` buckets of ROW time and each bucket
        is one feed+evaluate round (the log's own clock, so a replay
        is deterministic). Returns every transition, in order.

        ``goodput=True`` additionally feeds the goodput_fraction rule
        a rolling-ledger sample per round (bounded recent-event
        window). Only valid when the stream is ONE process's timeline
        — a multi-log union would collapse concurrent processes'
        intervals (the monitor.goodput rollup discipline); callers
        with several sources feed per-source rollups themselves."""
        events = sorted((e for e in events
                         if e.get("ts") is not None),
                        key=lambda e: e["ts"])
        recent = collections.deque(maxlen=2048) if goodput else None
        out = []

        def close_round(group):
            self.feed_events(group)
            now = group[-1]["ts"]
            if recent is not None:
                recent.extend(group)
                from . import goodput as _gp
                gf = _gp.ledger_from_events(recent)["goodput_fraction"]
                if gf is not None:
                    self.feed_sample("goodput_fraction", gf, now=now)
            out.extend(self.evaluate(now=now))

        group, edge = [], None
        for e in events:
            if edge is None:
                edge = e["ts"] + float(round_s)
            if e["ts"] >= edge:
                close_round(group)
                group, edge = [], e["ts"] + float(round_s)
            group.append(e)
        if group:
            close_round(group)
        return out

    def _update_idle(self, now):
        # idle needs FRESH evidence — a stale last point (dead
        # source) is unknown, not idle, and must not creep toward a
        # scale-down
        def fresh(p):
            return p is not None and now - p[0] <= 120.0
        q = self._series_latest("queue_depth")
        occ = self._series_latest("occupancy")
        idle = (not self._active
                and fresh(q) and q[1] == 0
                and fresh(occ) and occ[1] <= self.down_occupancy)
        self._idle_streak = self._idle_streak + 1 if idle else 0

    # -- the API surface ---------------------------------------------------
    def active(self):
        """{rule: {"severity", "since", "value", "figures"}} of alerts
        currently FIRING."""
        return {k: dict(v) for k, v in self._active.items()}

    def offenders(self, now, window_s=600.0, limit=3):
        """Worst offenders in-window, newest first: trace ids +
        endpoint incarnations of the failing requests the alert
        correlates to (the 'what do I look at' stamp)."""
        out = []
        for o in reversed(self._offenders):
            if o["ts"] <= now - window_s or o["ts"] > now:
                continue
            ent = dict(o)
            proc = o.get("proc") or ""
            ep = proc.split("@", 1)[1] if "@" in proc else None
            meta = self._endpoint_meta.get(ep) if ep else None
            if meta:
                ent["endpoint"] = ep
                ent["incarnation"] = meta.get("incarnation")
            out.append(ent)
            if len(out) >= limit:
                break
        return out

    def scale_hint(self):
        """Typed autoscaling input (ROADMAP direction 2): ``("up", n,
        reason)`` under sustained burn / shed / queue pressure,
        ``("down", 1, reason)`` only when nothing is firing AND the
        fleet has sat near-idle for ``down_hold`` rounds, else
        ``("hold", 0, reason)``. ``magnitude`` is a suggested replica
        delta (1, or 2 under compounded pressure)."""
        pressure = sorted(
            n for n, a in self._active.items()
            if a["severity"] == "page"
            or n in ("queue_depth", "shed_rate"))
        if pressure:
            mag = 1
            q = self._series_latest("queue_depth")
            qrule = next((r for r in self._rules
                          if getattr(r, "name", "") == "queue_depth"),
                         None)
            if len(pressure) > 1 or (
                    q is not None and qrule is not None
                    and q[1] >= self.up_queue_factor * qrule.fire):
                mag = 2
            figs = "; ".join(
                "%s=%s" % (n, _fmt_value(self._active[n]["value"]))
                for n in pressure)
            return ScaleHint("up", mag,
                             "sustained pressure: %s" % figs)
        if not self._active and self._idle_streak >= self.down_hold:
            return ScaleHint(
                "down", 1,
                "no active alerts; queue empty and occupancy <= %g "
                "for %d round(s)" % (self.down_occupancy,
                                     self._idle_streak))
        if self._active:
            return ScaleHint("hold", 0, "alerts active without scale "
                             "pressure: %s" % ", ".join(
                                 sorted(self._active)))
        return ScaleHint("hold", 0, "no sustained pressure")


# -- rendering --------------------------------------------------------------

def _fmt_value(v):
    if v is None:
        return "n/a"
    return "%.4g" % v


def render_transition(tr):
    """One CLI line for a transition (the ``monitor alerts`` print
    shape)."""
    figs = tr.get("figures") or {}
    detail = ""
    if "burn_short" in figs:
        detail = "  burn short %s / long %s (>= %gx)" % (
            _fmt_value(figs.get("burn_short")),
            _fmt_value(figs.get("burn_long")), figs.get("burn_rate"))
    elif figs:
        detail = "  " + " ".join(
            "%s=%s" % (k, _fmt_value(v) if isinstance(
                v, (int, float)) else v)
            for k, v in sorted(figs.items()) if k != "ts")
    offs = tr.get("offenders") or ()
    off = ""
    if offs:
        o = offs[0]
        bits = [b for b in (
            ("trace=%s" % o["trace"]) if o.get("trace") else None,
            ("endpoint=%s" % o["endpoint"])
            if o.get("endpoint") else None,
            ("proc=%s" % o["proc"])
            if o.get("proc") and not o.get("endpoint") else None)
            if b]
        if bits:
            off = "  offender " + " ".join(bits) + \
                ("  (+%d more)" % (len(offs) - 1)
                 if len(offs) > 1 else "")
    return "%s  [%s] %-8s %s  value %s%s%s" % (
        _ts_hms(tr["ts"]), tr["severity"], tr["state"], tr["rule"],
        _fmt_value(tr.get("value")), detail, off)


def active_alerts_line(signals):
    """The one-line ACTIVE ALERTS summary the watch dashboards render
    (file mode and --fleet read the SAME evaluation shape)."""
    act = signals.active()
    if not act:
        return "alerts    none active (%d rule(s) armed)" \
            % len(signals._rules)
    parts = []
    for name in sorted(act, key=lambda n: (act[n]["severity"] != "page",
                                           n)):
        a = act[name]
        parts.append("[%s] %s=%s" % (a["severity"], name,
                                     _fmt_value(a["value"])))
    return "alerts    ACTIVE ALERTS  " + "   ".join(parts)


def _ts_hms(ts):
    lt = time.localtime(ts)
    return "%02d:%02d:%06.3f" % (lt.tm_hour, lt.tm_min,
                                 lt.tm_sec + (ts - int(ts)))


# -- incident timeline ------------------------------------------------------

def incident_entries(paths):
    """Chronological incident entries across flight-recorder log(s):
    every ``alert`` transition row, every attested badput interval
    (stall / compile durations), and the recovery markers (fault /
    retry / preemption / checkpoint ... grouped per second per
    process) — the splice that answers 'what happened at 14:32' in
    one listing. Returns (entries, per-process goodput ledgers)."""
    from . import goodput as gp
    entries, ledgers = [], {}
    for path in paths:
        events, _ = read_jsonl_tolerant(path)
        ledgers[str(path)] = gp.ledger_from_events(events)
        intervals, markers, _, _, _ = gp._intervals_and_markers(events)
        for a, b, cat in intervals:
            if cat in ("stall", "compile"):
                entries.append({"ts": a, "kind": "badput", "cat": cat,
                                "dur_s": b - a, "proc": str(path)})
        grouped = collections.Counter(
            (int(ts), cat) for ts, cat in markers)
        for (sec, cat), n in grouped.items():
            entries.append({"ts": float(sec), "kind": "marker",
                            "cat": cat, "count": n,
                            "proc": str(path)})
        for e in events:
            if e.get("ev") == "alert":
                # order on the transition's LOGICAL time when the row
                # carries it (an offline replay writes rows at replay
                # time, not when the condition held)
                ent = {"ts": e.get("at") or e["ts"], "kind": "alert",
                       "proc": str(path)}
                ent.update({k: e.get(k) for k in
                            ("rule", "severity", "state", "value",
                             "figures", "offenders")})
                entries.append(ent)
    entries.sort(key=lambda e: e["ts"])
    return entries, ledgers


def render_incident(entries, ledgers, limit=200):
    """Terminal render of an incident timeline."""
    from . import goodput as gp
    lines = ["incident timeline — %d process(es), %d alert "
             "transition(s), %d entr(ies)"
             % (len(ledgers),
                sum(1 for e in entries if e["kind"] == "alert"),
                len(entries))]
    fleet = gp.rollup(ledgers.values())
    gf = fleet["goodput_fraction"]
    lines.append("  fleet goodput %s over %.2fs wall  (%s)"
                 % ("n/a" if gf is None else "%.1f%%" % (100 * gf),
                    fleet["wall_s"],
                    "  ".join("%s %.2fs" % (c, fleet["categories"][c])
                              for c in gp.CATEGORIES
                              if fleet["categories"][c])))
    shown = entries[:limit]
    for e in shown:
        t = _ts_hms(e["ts"])
        if e["kind"] == "alert":
            tr = dict(e)
            lines.append("  " + render_transition(tr))
        elif e["kind"] == "badput":
            lines.append("  %s  badput  %-8s %.2fs  (%s)"
                         % (t, e["cat"], e["dur_s"], e["proc"]))
        else:
            lines.append("  %s  marker  %-8s x%d  (%s)"
                         % (t, e["cat"], e["count"], e["proc"]))
    if len(entries) > limit:
        lines.append("  ... %d more entr(ies) truncated"
                     % (len(entries) - limit))
    return "\n".join(lines)
