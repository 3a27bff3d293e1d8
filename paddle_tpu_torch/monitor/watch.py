"""Live terminal dashboard: tail a flight-recorder JSONL and render a
refreshing one-screen view of the run — the operator's glass for a
serving engine (tokens/s, occupancy, queue depth, rolling TTFT/TPOT
percentiles) and for training (step p50/p95, tokens/s, MFU), with
stall / NaN / truncation indicators and an optional live SLO verdict.

The port's copy of ``paddle_tpu/monitor/watch.py`` (pure Python).

    python -m paddle_tpu_torch.monitor watch run.jsonl
    python -m paddle_tpu_torch.monitor watch run.jsonl --slo slo.json
    python -m paddle_tpu_torch.monitor watch run.jsonl --once   # one frame
    python -m paddle_tpu_torch.monitor watch rep0.jsonl rep1.jsonl ...
                       # serving fleet: one log per replica, the
                       # dashboard (and --slo verdict) covers the union
    python -m paddle_tpu_torch.monitor watch --fleet <kv-endpoint>
                       # LIVE fleet scrape: discover every process
                       # from the membership lease registry, scrape
                       # metrics + recorder deltas over RPC (METR),
                       # and render the merged dashboard — no files

The tail is incremental (only new bytes are parsed per refresh) and
tolerant: a torn trailing line — the writer is LIVE — is retried on
the next refresh, never fatal. Rolling figures cover the last
``--window`` rows of each kind; totals (steps, requests, stalls) cover
the whole log. Multi-log mode prints a per-log staleness line —
seconds since each file's last row — so a dead replica's SILENCE is
visible instead of silently aging out of the rolling window.
"""

import collections
import json
import sys
import time

from .recorder import percentile_sorted as _pct

__all__ = ["watch", "watch_fleet", "WatchState", "render_frame",
           "staleness_lines", "fleet_lines", "rollout_line"]


class _Tail:
    """Incremental reader: each poll() returns the complete lines that
    arrived since the last poll, holding a torn trailing fragment back
    for the next round. Opens lazily — a live tail may be started
    BEFORE the run creates its log; poll() returns None until the file
    exists."""

    def __init__(self, path):
        self.path = path
        self._f = None
        self._buf = ""

    def poll(self):
        if self._f is None:
            try:
                self._f = open(self.path, "r")
            except (FileNotFoundError, PermissionError):
                return None             # not created yet: retry later
        chunk = self._f.read()
        if not chunk:
            return []
        self._buf += chunk
        lines = self._buf.split("\n")
        self._buf = lines.pop()         # "" on a complete final line
        return [ln for ln in lines if ln.strip()]

    def close(self):
        if self._f is not None:
            self._f.close()


class WatchState:
    """Rolling aggregation over flight-recorder rows."""

    def __init__(self, window=256):
        self.window = int(window)
        self.serving_steps = collections.deque(maxlen=self.window)
        self.requests = collections.deque(maxlen=self.window)
        self.train_steps = collections.deque(maxlen=self.window)
        # rolling RAW-event window per source (one per log file /
        # scraped process): the goodput ledger must attribute each
        # process's own wall clock, never a union timeline, and needs
        # every timestamped row kind (steps, compiles, stalls,
        # markers), not just the serving deques above. LRU-bounded:
        # under supervisor respawn churn every new replica endpoint is
        # a fresh source key, and a dashboard must not grow (or keep
        # verdict-voting dead processes' last windows) forever.
        self.goodput_events = collections.OrderedDict()
        self.max_sources = 64
        self.events = 0
        self.skipped = 0
        self.total_serving_steps = 0
        self.total_requests = 0
        self.total_errors = 0
        self.total_preemptions = 0
        self.total_train_steps = 0
        self.stalls = 0
        self.nan_trips = 0
        self.truncated = False
        self.platform = None
        self.last_ts = None
        # elastic-fleet rows (serving.autoscale): the newest
        # scale_event / roll row feed the dashboard's autoscale line
        self.last_scale_event = None
        self.last_roll = None
        # canary-rollout rows (serving.rollout): newest
        # phase-transition row + per-phase delta verdicts feed the
        # rollout status line — same recorder rows the collector
        # already ships, no parallel machinery
        self.last_rollout = None
        self.verdicts = {}         # phase -> newest verdict row

    def feed_line(self, line, source=""):
        e = self.parse_line(line)
        if e is not None:
            self.feed_event(e, source=source)

    def parse_line(self, line):
        """One JSONL line -> event dict, or None (counted skipped)."""
        try:
            e = json.loads(line)
        except json.JSONDecodeError:
            self.skipped += 1
            return None
        if not isinstance(e, dict) or "ev" not in e:
            self.skipped += 1
            return None
        return e

    def feed_event(self, e, source=""):
        self.events += 1
        if e.get("ts") is not None:
            self.last_ts = e["ts"]
            key = source or ""
            dq = self.goodput_events.get(key)
            if dq is None:
                dq = self.goodput_events[key] = collections.deque(
                    maxlen=self.window)
            dq.append(e)
            self.goodput_events.move_to_end(key)
            while len(self.goodput_events) > self.max_sources:
                self.goodput_events.popitem(last=False)
        ev = e["ev"]
        if ev == "serving_step":
            # a fused megastep row advances k logical steps (dt stays
            # per-logical-step) — weight so totals are K-comparable
            self.total_serving_steps += int(e.get("k") or 1)
            self.total_preemptions += int(e.get("preempted") or 0)
            self.serving_steps.append(e)
        elif ev == "serving_request":
            self.total_requests += 1
            if e.get("error"):
                self.total_errors += 1
            self.requests.append(e)
        elif ev == "step":
            self.total_train_steps += int(e.get("k") or 1)
            self.train_steps.append(e)
        elif ev == "stall":
            self.stalls += 1
        elif ev == "nan_guard":
            self.nan_trips += 1
        elif ev == "truncated":
            self.truncated = True
        elif ev == "devices":
            self.platform = e.get("platform")
        elif ev == "scale_event":
            self.last_scale_event = e
        elif ev == "roll":
            self.last_roll = e
        elif ev == "rollout":
            self.last_rollout = e
        elif ev == "verdict":
            self.verdicts[e.get("phase") or "?"] = e

    def goodput_rollup(self):
        """Per-SOURCE rolling ledgers rolled up per process — NEVER a
        union timeline (two replicas' concurrent productive intervals
        would collapse into one). The ONE rollup idiom shared by the
        SLO samples below, the file-mode watch loop, and the fleet
        loop. None when no timestamped rows have arrived."""
        if not self.goodput_events:
            return None
        from . import goodput as _goodput
        return _goodput.rollup(
            _goodput.ledger_from_events(evs)
            for evs in self.goodput_events.values())

    def request_samples(self):
        """SLO-engine-shaped samples over the rolling request window
        (what --slo evaluates live) — delegates to the slo module's
        one rows->samples extraction. goodput comes from
        ``goodput_rollup`` (the request/serving deques alone would
        misattribute a training log and collapse a fleet's concurrent
        timelines)."""
        import itertools
        from .. import slo as _slo
        out = _slo.samples_from_events(
            itertools.chain(self.requests, self.serving_steps),
            source="watch window", compute_goodput=False)
        out["goodput"] = self.goodput_rollup()
        return out


def _ms(v):
    return "n/a" if v is None else "%.1fms" % (1000.0 * v)


def _p(vals, q):
    return _pct(sorted(vals), q) if vals else None


def staleness_lines(last_ts, now=None, stale_after=5.0):
    """Per-log staleness indicator for multi-log mode: one line per
    file with seconds since ITS last row, so a dead replica's silence
    is visible instead of quietly aging out of the rolling window.
    ``last_ts``: {path: newest row ts or None}. With ``now`` (live
    loop) ages are absolute; without it (--once, deterministic) they
    are relative to the newest row across all logs."""
    if len(last_ts) < 2:
        return []
    base = now
    if base is None:
        known = [t for t in last_ts.values() if t is not None]
        if not known:
            return []
        base = max(known)
    out = []
    for path in sorted(last_ts):
        t = last_ts[path]
        if t is None:
            out.append("  %-40s no rows yet" % path)
            continue
        age = max(0.0, base - t)
        flag = "   [STALE]" if age >= stale_after else ""
        out.append("  %-40s last row %5.1fs ago%s" % (path, age, flag))
    return ["logs"] + out


def _fleet_counter(snap, name):
    """Summed counter value, or None when the metric is ABSENT — a
    present-but-zero counter must not read as missing (the requests
    line falls back to admissions only when no router counted at
    all)."""
    ent = snap.get(name) or {}
    if ent.get("kind") != "counter":
        return None
    return sum(ent.get("series", {}).values())


def _fleet_gauge_series(snap, name):
    """Gauge series dict (label key -> value), or None when the metric
    is ABSENT — same absent-vs-zero discipline as _fleet_counter (the
    autoscale line only renders when an autoscaler actually exports)."""
    ent = snap.get(name) or {}
    if ent.get("kind") != "gauge":
        return None
    return ent.get("series") or {}


def fleet_lines(fleet_snap, now=None, state=None):
    """Fleet header for the scraped dashboard: one line per endpoint
    (role, liveness, uptime, scrape staleness) plus the merged fleet
    counters — the collector's exact-sum view. ``state`` (a WatchState,
    optional) contributes the newest scale_event / roll recorder rows
    to the autoscale line."""
    from .metrics import META_KEY
    meta = fleet_snap.get(META_KEY) or {}
    eps = meta.get("endpoints") or []
    lines = ["fleet     %d process(es), %d endpoint(s), %d scrape(s)%s"
             % (meta.get("processes", 0), len(eps),
                meta.get("scrapes", 0),
                "   [%d event(s) LOST to ring overflow]"
                % meta["events_lost"] if meta.get("events_lost")
                else "")]
    for ep in eps:
        status = "up" if ep.get("ok") else "DOWN"
        up = ep.get("uptime_s")
        age = ep.get("age_s")
        lines.append(
            "  %-8s %-22s %-4s uptime %-8s scraped %s"
            % (ep.get("role", "?"), ep.get("endpoint", "?"), status,
               "n/a" if up is None else "%.0fs" % up,
               "n/a" if age is None else "%.1fs ago" % age))
    steps = _fleet_counter(fleet_snap, "ptpu_steps_total")
    tokens = _fleet_counter(fleet_snap, "ptpu_serving_tokens_total")
    reqs = _fleet_counter(fleet_snap, "ptpu_fleet_requests_total")
    if reqs is None:          # no router in the fleet: engine-level
        reqs = _fleet_counter(fleet_snap,
                              "ptpu_serving_admissions_total")
    errs = _fleet_counter(fleet_snap,
                          "ptpu_serving_request_failures_total")
    rounds = _fleet_counter(fleet_snap, "ptpu_ps_rounds_total")
    lines.append(
        "  totals   steps %d   serving tokens %d   requests %d   "
        "errors %d   ps rounds %d" % (steps or 0, tokens or 0,
                                      reqs or 0, errs or 0,
                                      rounds or 0))
    sp_h = _fleet_counter(fleet_snap, "ptpu_sparse_cache_hits_total")
    sp_m = _fleet_counter(fleet_snap, "ptpu_sparse_cache_misses_total")
    if sp_h is not None or sp_m is not None:
        # sparse serving tier present (serving.sparse): the merged
        # hot-ID cache view — exact sums across every scraped process
        sp_h, sp_m = sp_h or 0, sp_m or 0
        sp_s = _fleet_counter(
            fleet_snap, "ptpu_sparse_cache_stale_total") or 0
        sp_r = _fleet_counter(
            fleet_snap, "ptpu_sparse_prefetch_rows_total") or 0
        rate = "n/a" if sp_h + sp_m == 0 \
            else "%.0f%%" % (100.0 * sp_h / (sp_h + sp_m))
        lines.append(
            "  sparse   cache hits %d misses %d stale %d (hit rate "
            "%s)   prefetch rows %d" % (sp_h, sp_m, sp_s, rate, sp_r))
    spd = _fleet_counter(fleet_snap, "ptpu_spec_drafted_tokens_total")
    spa = _fleet_counter(fleet_snap,
                         "ptpu_spec_accepted_tokens_total")
    spn = _fleet_counter(fleet_snap, "ptpu_spec_dispatches_total")
    if spn:
        # speculative tier present: merged accept rate over
        # every scraped engine — exact counter sums, like the sparse
        # line above
        spd, spa = spd or 0, spa or 0
        rate = "n/a" if not spd else "%.0f%%" % (100.0 * spa / spd)
        lines.append(
            "  spec     drafted %d accepted %d (accept rate %s)   "
            "dispatches %d" % (spd, spa, rate, spn))
    des = _fleet_gauge_series(fleet_snap, "ptpu_fleet_desired_replicas")
    if des:
        # elastic fleet present (serving.autoscale): live vs
        # desired replica count, per-version mix (the roll's
        # convergence renders as this mix shifting to one version),
        # and the scale/drain/roll totals the collector merges
        # incarnation-correctly like every other counter
        desired = int(max(des.values()))
        live_g = _fleet_gauge_series(fleet_snap,
                                     "ptpu_fleet_replicas") or {}
        live = "%d" % int(max(live_g.values())) if live_g else "?"
        mix_g = _fleet_gauge_series(
            fleet_snap, "ptpu_fleet_version_replicas") or {}
        mix = " ".join("%s:%d" % (k, int(v))
                       for k, v in sorted(mix_g.items())
                       if int(v)) or "n/a"
        scl = _fleet_counter(fleet_snap,
                             "ptpu_fleet_scale_events_total") or 0
        drn = _fleet_counter(fleet_snap, "ptpu_fleet_drains_total") or 0
        rol = _fleet_counter(fleet_snap, "ptpu_fleet_rolls_total") or 0
        line = ("  autoscale replicas %s/%d   versions %s   "
                "scale events %d   drains %d   rolls %d"
                % (live, desired, mix, scl, drn, rol))
        last = getattr(state, "last_scale_event", None)
        if last is not None:
            line += "   last %s->%s (%s)" % (
                last.get("direction", "?"), last.get("desired", "?"),
                last.get("reason", "?"))
        lines.append(line)
        lr = getattr(state, "last_roll", None)
        if lr is not None:
            dt = lr.get("convergence_s")
            lines.append(
                "  roll     %s -> %s   %s   replaced %d   shed %d%s"
                % (lr.get("from_version", "?"),
                   lr.get("to_version", "?"),
                   "ABORTED: %s" % lr.get("reason")
                   if lr.get("aborted") else "converged",
                   int(lr.get("replaced") or 0),
                   int(lr.get("shed_during") or 0),
                   "" if dt is None else "   %.1fs" % dt))
    return lines


def rollout_line(state):
    """The canary-rollout status line: live phase, version
    mix, per-phase delta verdicts, and — once promoted — the
    version-convergence time. Rendered from the newest ``rollout`` /
    ``verdict`` recorder rows (file mode tails them, fleet mode ships
    them through the collector — one source either way). None while
    no rollout has ever run (quiet fleets keep byte-identical
    frames)."""
    ro = state.last_rollout
    if ro is None:
        return None
    line = "  rollout  %s   phase %s" % (ro.get("version", "?"),
                                         ro.get("phase", "?"))
    if state.verdicts:
        vs = " ".join(
            "%s:%s" % (p, v.get("verdict", "?"))
            for p, v in sorted(state.verdicts.items()))
        line += "   verdicts %s" % vs
    mix = ro.get("version_mix")
    if mix:
        line += "   versions %s" % " ".join(
            "%s:%d" % (k, int(n)) for k, n in sorted(mix.items())
            if int(n))
    if ro.get("detail"):
        line += "   (%s)" % ro["detail"]
    if ro.get("convergence_s") is not None:
        line += "   convergence %.1fs" % float(ro["convergence_s"])
    return line


def render_frame(state, path, slo_verdict=None, now=None,
                 staleness=None, fleet=None, alerts_line=None,
                 incidents_line=None):
    """One frame of the dashboard as a string (the ``--once`` / test
    surface; the live loop wraps it in an ANSI clear). ``staleness``:
    {path: last row ts} for the multi-log per-file indicator;
    ``fleet``: a collector fleet snapshot for the scraped-dashboard
    header; ``alerts_line``: the signals evaluator's ACTIVE ALERTS
    summary (monitor/signals.py — file mode and --fleet render the
    same line from the same evaluation shape); ``incidents_line``:
    the forensics incidents summary (active incident names + most
    recent bundle path, monitor/forensics.py)."""
    lines = ["paddle_tpu_torch monitor watch — %s   %d events (%s)"
             % (path, state.events, state.platform or "?")]
    if state.last_ts is not None and now is not None:
        age = max(0.0, now - state.last_ts)
        lines[0] += "   last event %.1fs ago" % age
    if fleet is not None:
        lines.extend(fleet_lines(fleet, now=now, state=state))
    ro_line = rollout_line(state)
    if ro_line is not None:
        lines.append(ro_line)
    if staleness:
        lines.extend(staleness_lines(staleness, now=now))

    if state.serving_steps:
        dts = [s["dt"] for s in state.serving_steps
               if s.get("dt") is not None]
        last = state.serving_steps[-1]
        occ = (last["active"] / last["slots"]) if last.get("slots") \
            else 0.0
        tps = None
        ts = [s["ts"] for s in state.serving_steps
              if s.get("ts") is not None]
        if len(ts) >= 2 and ts[-1] > ts[0]:
            tok = sum(s.get("emitted") or 0
                      for s in state.serving_steps)
            tps = tok / (ts[-1] - ts[0])
        lines.append(
            "serving   steps %-7d tokens/s %-8s occupancy %-5.2f "
            "queue %-4d step p50 %s p95 %s"
            % (state.total_serving_steps,
               "n/a" if tps is None else "%.0f" % tps, occ,
               last.get("queue_depth", 0),
               _ms(_p(dts, 0.50)), _ms(_p(dts, 0.95))))
    kv_last = {}
    for s in state.serving_steps:
        if s.get("kv_used_blocks") is not None:
            # LAST row PER ENGINE: a fleet writes one log per replica,
            # and reading only the globally-last row would render one
            # arbitrary replica's pool as the fleet's (the
            # single-replica-flatters-the-fleet distortion the
            # multi-log union exists to avoid)
            kv_last[s.get("engine") or "engine"] = s
    if kv_last:
        # occupancy sums the per-engine gauges; hit rate sums the
        # cumulative counters each engine's rows carry (last-row
        # arithmetic per engine, never a window sum)
        rows = list(kv_last.values())
        used = sum(r["kv_used_blocks"] for r in rows)
        total = sum(r["kv_total_blocks"] for r in rows)
        h = sum(r.get("prefix_hits") or 0 for r in rows)
        m = sum(r.get("prefix_misses") or 0 for r in rows)
        rate = "n/a" if h + m == 0 else "%.0f%%" % (100.0 * h / (h + m))
        # real HBM, not block counts: engines stamp
        # quantization-aware byte figures, so an int8 pool's line
        # shows its actual (smaller) footprint
        bu = sum(r.get("kv_bytes_used") or 0 for r in rows)
        bt = sum(r.get("kv_bytes_total") or 0 for r in rows)
        hbm = "" if not bt else "   hbm %.1f/%.1f MiB" % (
            bu / 2**20, bt / 2**20)
        lines.append(
            "kv        blocks %d/%d (%.0f%%)%s   prefix hits %d "
            "misses %d (hit rate %s)   preemptions %d"
            % (used, total, 100.0 * used / total if total else 0.0,
               hbm, h, m, rate, state.total_preemptions))
    spec_last = {}
    for s in state.serving_steps:
        if s.get("spec_dispatches") is not None:
            # speculative-decode counters are CUMULATIVE per engine
            # row — last row per engine, same discipline
            # as the kv line above
            spec_last[s.get("engine") or "engine"] = s
    if spec_last:
        rows = list(spec_last.values())
        dr = sum(r.get("spec_drafted") or 0 for r in rows)
        ac = sum(r.get("spec_accepted") or 0 for r in rows)
        em = sum(r.get("spec_emitted") or 0 for r in rows)
        di = sum(r.get("spec_dispatches") or 0 for r in rows)
        rate = "n/a" if not dr else "%.0f%%" % (100.0 * ac / dr)
        lines.append(
            "spec      drafted %d accepted %d (accept rate %s)   "
            "dispatches %d (%s tok/dispatch)"
            % (dr, ac, rate, di,
               "n/a" if not di else "%.2f" % (em / di)))
    sparse_last = {}
    for s in state.serving_steps:
        if s.get("cache_hits") is not None:
            # hot-ID cache counters are CUMULATIVE per engine row
            # (serving.sparse scoring engines) — last row per engine,
            # same discipline as the kv line above
            sparse_last[s.get("engine") or "engine"] = s
    if sparse_last:
        rows = list(sparse_last.values())
        h = sum(r.get("cache_hits") or 0 for r in rows)
        m = sum(r.get("cache_misses") or 0 for r in rows)
        st = sum(r.get("cache_stale") or 0 for r in rows)
        ev = sum(r.get("cache_evictions") or 0 for r in rows)
        rate = "n/a" if h + m == 0 else "%.0f%%" % (100.0 * h / (h + m))
        lines.append(
            "sparse    cache hits %d misses %d stale %d evictions %d "
            "(hit rate %s)" % (h, m, st, ev, rate))
    if state.requests:
        # failed rows are error-budget-only (same policy as the SLO
        # engine — this line and the verdict line below must agree)
        ok = [r for r in state.requests if not r.get("error")]
        ttft = [r["ttft"] for r in ok if r.get("ttft") is not None]
        tpot = [r["tpot"] for r in ok if r.get("tpot") is not None]
        qw = [r["queue_wait"] for r in ok
              if r.get("queue_wait") is not None]
        lines.append(
            "requests  n %-9d TTFT p50 %s p95 %s   TPOT p50 %s "
            "p95 %s   queue_wait p95 %s"
            % (state.total_requests,
               _ms(_p(ttft, 0.50)), _ms(_p(ttft, 0.95)),
               _ms(_p(tpot, 0.50)), _ms(_p(tpot, 0.95)),
               _ms(_p(qw, 0.95))))
    if state.train_steps:
        dts = [s["dt"] for s in state.train_steps
               if s.get("dt") is not None and s.get("synced", True)]
        last = state.train_steps[-1]
        extra = ""
        if last.get("tokens_per_sec"):
            extra += "   tok/s %.0f" % last["tokens_per_sec"]
        if last.get("mfu"):
            extra += "   mfu %.1f%%" % (100 * last["mfu"])
        lines.append("train     steps %-7d p50 %s p95 %s%s"
                     % (state.total_train_steps, _ms(_p(dts, 0.50)),
                        _ms(_p(dts, 0.95)), extra))
    health = "health    stalls %d   nan trips %d   errors %d" % (
        state.stalls, state.nan_trips, state.total_errors)
    if state.truncated:
        health += "   [LOG TRUNCATED AT CAP]"
    if state.skipped:
        # complete-but-unparseable lines: permanently skipped (a TORN
        # trailing line never reaches here — _Tail holds it back and
        # retries it next refresh)
        health += "   (%d corrupt line(s) skipped)" % state.skipped
    lines.append(health)
    if alerts_line is not None:
        lines.append(alerts_line)
    if incidents_line is not None:
        lines.append(incidents_line)
    if slo_verdict is not None:
        status = " ".join(
            "%s %s%s" % ("PASS" if r["pass"] else "FAIL",
                         r["metric"] + (" burn" if r.get("burn")
                                        else ""),
                         ("=" + _ms(r["measured"]))
                         if r["measured"] is not None
                         and not r.get("burn")
                         and r["metric"] not in ("error_rate",
                                                 "goodput_fraction")
                         else "")
            for r in slo_verdict["objectives"])
        lines.append("slo       %s   %s"
                     % ("PASS" if slo_verdict["pass"] else "FAIL",
                        status))
    return "\n".join(lines)


def watch(path, interval=2.0, window=256, once=False, out=None,
          slo_spec=None, max_frames=None):
    """Tail ``path`` — one flight-recorder log, or a LIST of them (a
    serving fleet writes one per replica; the dashboard and the live
    SLO verdict aggregate the union) — and render the dashboard every
    ``interval`` seconds until interrupted. ``once`` reads what is
    there now, renders ONE frame without clearing the screen, and
    returns it (tests and scripts). ``slo_spec`` (path/dict) adds a
    live verdict line evaluated over the rolling request window.
    ``max_frames`` bounds the live loop (None = until Ctrl-C)."""
    paths = [path] if isinstance(path, str) else list(path)
    label = ", ".join(paths)
    if out is None:
        out = sys.stdout
    spec = None
    if slo_spec:
        from .. import slo as _slo
        spec = _slo.load_spec(slo_spec)
    # the ACTIVE ALERTS line: a local signals evaluation
    # over the tailed rows — single-process runs get alerting without
    # a collector. Burn rules arm when the spec carries error-budget
    # objectives; the sustained-condition defaults always arm.
    from . import signals as _signals
    sig = _signals.Signals(spec=spec)
    state = WatchState(window=window)
    tails = [_Tail(p) for p in paths]
    last_ts = {p: None for p in paths}   # per-log staleness indicator
    frames = 0
    try:
        while True:
            polls = [t.poll() for t in tails]
            if all(p is None for p in polls):   # no log created yet
                if once:
                    out.write("watch: %s does not exist (yet)\n"
                              % label)
                    return None
                out.write("\x1b[2J\x1b[Hwatch: waiting for %s ...\n"
                          % label)
                out.flush()
                time.sleep(interval)
                continue
            # merge this poll round's rows ACROSS logs by timestamp
            # before feeding the rolling window: fed file-by-file, the
            # last log's rows would evict every other replica's from
            # the window — exactly the single-replica view a fleet
            # dashboard exists to avoid. Stable sort keeps each file's
            # own order for ts-less rows.
            events = []
            for t, lines in zip(tails, polls):
                for line in lines or ():
                    e = state.parse_line(line)
                    if e is not None:
                        events.append((e, t.path))
                        if e.get("ts") is not None:
                            last_ts[t.path] = max(
                                last_ts[t.path] or 0.0, e["ts"])
            events.sort(key=lambda pair: (pair[0].get("ts") is None,
                                          pair[0].get("ts") or 0.0))
            for e, src in events:
                state.feed_event(e, source=src)
            verdict = None
            if spec is not None:
                from .. import slo as _slo
                verdict = _slo.evaluate(spec, state.request_samples())
            led = state.goodput_rollup()
            if led is not None and led["goodput_fraction"] is not None:
                # the per-source rollup feeds the goodput_fraction
                # rule — spec or no spec, the alerts line gets it
                sig.feed_sample("goodput_fraction",
                                led["goodput_fraction"],
                                now=state.last_ts)
            if once:
                # deterministic offline evaluation on the log's own
                # clock: rows grouped into 1 s rounds, so alerts the
                # history SHOULD have fired are active in the frame
                sig.replay([e for e, _ in events])
            else:
                sig.feed_events([e for e, _ in events])
                sig.evaluate(now=time.time())
            from . import forensics as _forensics
            frame = render_frame(state, label, slo_verdict=verdict,
                                 now=None if once else time.time(),
                                 staleness=last_ts
                                 if len(paths) > 1 else None,
                                 alerts_line=_signals
                                 .active_alerts_line(sig),
                                 incidents_line=_forensics
                                 .incidents_line(sig))
            if once:
                out.write(frame + "\n")
                return frame
            out.write("\x1b[2J\x1b[H" + frame + "\n")
            out.flush()
            frames += 1
            if max_frames is not None and frames >= max_frames:
                return frame
            time.sleep(interval)
    except KeyboardInterrupt:
        return None
    finally:
        for t in tails:
            t.close()


def watch_fleet(kv_endpoint=None, static=(), interval=2.0, window=256,
                once=False, out=None, slo_spec=None, max_frames=None,
                collector=None):
    """The LIVE scraped dashboard (``watch --fleet``): a
    ``monitor.collector.Collector`` discovers the fleet from the
    membership lease registry (plus ``static`` (role, endpoint)
    pairs), scrapes every process's registry + flight-recorder delta
    over RPC each ``interval``, and renders the merged frame —
    replacing the pattern of tailing one JSONL per replica.
    The SLO verdict line evaluates ``slo_spec`` against the rolling
    scraped request rows when any process streams recorder events,
    falling back to the merged fleet METRICS snapshot (approximate,
    bucket-interpolated) when none does — one spec gates the whole
    fleet either way."""
    from .collector import Collector
    if out is None:
        out = sys.stdout
    spec = None
    if slo_spec:
        from .. import slo as _slo
        spec = _slo.load_spec(slo_spec)
    col = collector if collector is not None else Collector(
        kv_endpoint=kv_endpoint, static=static)
    own_col = collector is None
    from . import signals as _signals
    sig = _signals.Signals(spec=spec)
    state = WatchState(window=window)
    label = kv_endpoint or ", ".join(ep for _, ep in static) \
        or "scrape"
    frames = 0
    try:
        while True:
            round_events = col.scrape_once()
            for e in round_events:
                # scraped rows carry proc = "role@endpoint": the
                # per-process key the rolling goodput rollup needs
                state.feed_event(e, source=e.get("proc") or "")
            snap = col.fleet_snapshot()
            # signals round: the merged snapshot feeds the counter
            # series (incarnation-aware), the scraped rows feed
            # samples + offender correlation, then one evaluation
            sig.feed_snapshot(snap)
            sig.feed_events(round_events)
            verdict = None
            if spec is not None:
                from .. import slo as _slo
                samples = state.request_samples()
                if not any(samples.get(k) for k in
                           ("ttft", "tpot", "queue_wait",
                            "step_latency")):
                    # no per-request rows scraped: latency objectives
                    # fall back to the merged fleet histograms — but
                    # the row-derived goodput ledger (training fleets
                    # stream step rows without serving rows) must
                    # survive the swap
                    fallback = _slo.samples_from_metrics(snap)
                    fallback["goodput"] = samples.get("goodput")
                    samples = fallback
                verdict = _slo.evaluate(spec, samples)
            led = state.goodput_rollup()
            if led is not None and led["goodput_fraction"] is not None:
                # same per-source rollup discipline as file mode —
                # the goodput rule is armed with or without a spec
                sig.feed_sample("goodput_fraction",
                                led["goodput_fraction"])
            sig.evaluate()
            from . import forensics as _forensics
            frame = render_frame(state, "fleet %s" % label,
                                 slo_verdict=verdict,
                                 now=None if once else time.time(),
                                 fleet=snap,
                                 alerts_line=_signals
                                 .active_alerts_line(sig),
                                 incidents_line=_forensics
                                 .incidents_line(sig))
            if once:
                from .metrics import META_KEY
                eps = (snap.get(META_KEY) or {}).get("endpoints") or []
                if not any(e.get("ok") for e in eps):
                    # exit-code parity with file mode (--once on a
                    # missing log returns None -> exit 1): a fleet
                    # where NOTHING answered must not read as healthy
                    out.write(frame + "\nwatch: no endpoint "
                              "answered the scrape\n")
                    return None
                out.write(frame + "\n")
                return frame
            out.write("\x1b[2J\x1b[H" + frame + "\n")
            out.flush()
            frames += 1
            if max_frames is not None and frames >= max_frames:
                return frame
            time.sleep(interval)
    except KeyboardInterrupt:
        return None
    finally:
        if own_col:
            col.close()
