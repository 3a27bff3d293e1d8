"""Goodput / badput ledger: wall-time attribution from recorder rows.

The port's copy of ``paddle_tpu/monitor/goodput.py`` (pure Python).

The fleet's judging metric (ROADMAP: elastic fleet and chaos work are
judged by goodput): fold the flight-recorder event stream the stack
already emits — ``step`` / ``serving_step`` (with durations),
``xla_compile`` / ``stall`` (with durations), and the duration-less
markers ``retry`` / ``reconnect`` / ``fault`` / ``rollback`` /
``resume`` / ``checkpoint`` / preemptions — into an EXACT attribution
of the run's wall clock:

    productive      device compute advancing real work (train steps +
                    serving decode/prefill iterations)
    compile         compile wall time (the Executor's plan builds and
                    CUDA-graph captures)
    stall           watchdog-attested dead time (idle_seconds)
    fault_recovery  gaps explained by retry/reconnect/rollback/
                    resume/fault markers (the badput chaos injects)
    checkpoint      gaps explained by checkpoint markers
    preemption      gaps explained by pool-dry preemption markers
    idle            everything else (queue empty, host between steps)

Attribution is a priority sweep over the timeline — overlapping
intervals (a first step's dt CONTAINS its compile) never double count
(stall > compile > productive), every interval is clipped to the
run's [first row, last row] window, and uncovered gaps are attributed
by the markers that fall inside them — so the categories sum to the
measured wall time EXACTLY, and ``goodput_fraction`` =
productive / wall is well-defined.

Surfaces::

    python -m paddle_tpu_torch.monitor goodput run.jsonl [rep1.jsonl ...]
                                  # per-process breakdown + fleet
                                  # rollup (one log per process)
    {"metric": "goodput_fraction", "min_ratio": 0.7}
                                  # SLO objective over the same rows
                                  # (python -m paddle_tpu_torch.slo --log)
"""

from .recorder import read_jsonl_tolerant

__all__ = ["ledger_from_events", "ledger", "rollup", "render",
           "CATEGORIES"]

CATEGORIES = ("productive", "compile", "stall", "fault_recovery",
              "preemption", "checkpoint", "idle")

# covered-interval priorities: when a step's wall time contains a
# compile (the first run() call does), the compile wins that span —
# the step keeps only the remainder. Stall reports trump both: the
# watchdog attested nothing completed.
_PRI = {"stall": 3, "compile": 2, "productive": 1}

# duration-less marker events -> gap category (priority order: a gap
# holding both a retry and a checkpoint is fault recovery — the
# checkpoint was incidental, the retry explains the dead time)
_MARKERS = {"retry": "fault_recovery", "reconnect": "fault_recovery",
            "fault": "fault_recovery", "rollback": "fault_recovery",
            "resume": "fault_recovery", "preemption": "preemption",
            "checkpoint": "checkpoint"}
_GAP_ORDER = ("fault_recovery", "preemption", "checkpoint")


def _intervals_and_markers(events):
    """-> (intervals [(start, end, category)], markers [(ts, cat)],
    t0, t1, counts). Durations come only from rows that carry them;
    marker rows are points."""
    intervals, markers = [], []
    ts_all = [e["ts"] for e in events if e.get("ts") is not None]
    counts = {"steps": 0, "serving_steps": 0, "tokens": 0,
              "requests": 0, "preemptions": 0}
    if not ts_all:
        return [], [], None, None, counts
    t0, t1 = min(ts_all), max(ts_all)
    for e in events:
        ts = e.get("ts")
        if ts is None:
            continue
        ev = e.get("ev")
        if ev == "step":
            k = int(e.get("k") or 1)
            counts["steps"] += k
            dur = e.get("megastep_dt")
            if dur is None and e.get("dt") is not None:
                dur = float(e["dt"]) * k
            if dur:
                intervals.append((ts - float(dur), ts, "productive"))
        elif ev == "serving_step":
            k = int(e.get("k") or 1)
            counts["serving_steps"] += k
            counts["tokens"] += int(e.get("emitted") or 0)
            pre = int(e.get("preempted") or 0)
            if pre:
                counts["preemptions"] += pre
                markers.append((ts, "preemption"))
            dur = e.get("megastep_dt")
            if dur is None and e.get("dt") is not None:
                dur = float(e["dt"]) * k
            if dur:
                intervals.append((ts - float(dur), ts, "productive"))
        elif ev == "xla_compile":
            dur = float(e.get("seconds") or 0.0)
            if dur:
                intervals.append((ts - dur, ts, "compile"))
        elif ev == "stall":
            dur = float(e.get("idle_seconds") or 0.0)
            if dur:
                intervals.append((ts - dur, ts, "stall"))
        elif ev == "serving_request":
            counts["requests"] += 1
        elif ev in _MARKERS:
            markers.append((ts, _MARKERS[ev]))
    return intervals, markers, t0, t1, counts


def ledger_from_events(events):
    """One process's attribution: {"wall_s", "categories": {cat: s},
    "goodput_fraction", "counts", "rows"}. Categories sum to wall_s
    exactly (priority sweep + gap attribution — see module
    docstring); empty/ts-less event lists report wall 0 and a None
    fraction."""
    intervals, markers, t0, t1, counts = _intervals_and_markers(events)
    out = {"rows": len(events), "counts": counts,
           "categories": {c: 0.0 for c in CATEGORIES},
           "wall_s": 0.0, "goodput_fraction": None}
    if t0 is None or t1 <= t0:
        return out
    wall = t1 - t0
    # clip to the observed window (a first step's interval may start
    # before the first row's ts — its duration contains enable-time)
    clipped = []
    for a, b, cat in intervals:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            clipped.append((a, b, cat))
    # priority sweep (O(n log n)): active-interval counts per
    # priority; each elementary segment goes to the highest active
    # priority, or to the gap list when nothing covers it
    points = []
    for a, b, cat in clipped:
        p = _PRI[cat]
        points.append((a, 0, +1, p))     # opens sort before closes
        points.append((b, 1, -1, p))
    points.sort(key=lambda x: (x[0], x[1]))
    inv = {v: k for k, v in _PRI.items()}
    cats = out["categories"]
    gaps = []
    active = [0, 0, 0, 0]                # index by priority
    prev = t0
    i = 0
    while i < len(points):
        t = points[i][0]
        if t > prev:
            top = max((p for p in (3, 2, 1) if active[p]), default=0)
            if top:
                cats[inv[top]] += t - prev
            else:
                gaps.append((prev, t))
            prev = t
        while i < len(points) and points[i][0] == t:
            active[points[i][3]] += points[i][2]
            i += 1
    if t1 > prev:
        gaps.append((prev, t1))
    # gap attribution by markers: a gap holding a recovery marker is
    # badput with a NAME, not idle (gaps are disjoint, so the bisect
    # ranges sum to O(markers) total)
    import bisect
    markers.sort()
    m_ts = [ts for ts, _ in markers]
    for a, b in gaps:
        lo = bisect.bisect_left(m_ts, a)
        hi = bisect.bisect_right(m_ts, b)
        inside = {markers[j][1] for j in range(lo, hi)}
        for cat in _GAP_ORDER:
            if cat in inside:
                cats[cat] += b - a
                break
        else:
            cats["idle"] += b - a
    out["wall_s"] = wall
    out["goodput_fraction"] = cats["productive"] / wall
    return out


def rollup(ledgers):
    """Fleet rollup over per-PROCESS ledgers: category seconds sum,
    fleet goodput_fraction = Σ productive / Σ wall. Per process, not
    over a union timeline — two replicas' concurrent productive
    intervals would collapse into one there. Shared by the CLI,
    the SLO multi-log surface, and the watch dashboards."""
    ledgers = list(ledgers)
    fleet = {"wall_s": sum(l["wall_s"] for l in ledgers),
             "categories": {c: sum(l["categories"][c]
                                   for l in ledgers)
                            for c in CATEGORIES},
             "counts": {k: sum(l["counts"][k] for l in ledgers)
                        for k in ("steps", "serving_steps", "tokens",
                                  "requests", "preemptions")},
             "rows": sum(l["rows"] for l in ledgers),
             "goodput_fraction": None}
    if fleet["wall_s"] > 0:
        fleet["goodput_fraction"] = \
            fleet["categories"]["productive"] / fleet["wall_s"]
    return fleet


def ledger(paths):
    """Per-process ledgers (one flight-recorder JSONL per process) +
    the fleet rollup. Torn lines are skipped and counted, like every
    log consumer here."""
    procs = {}
    skipped = 0
    for path in paths:
        events, sk = read_jsonl_tolerant(path)
        skipped += sk
        procs[str(path)] = ledger_from_events(events)
    return {"processes": procs, "fleet": rollup(procs.values()),
            "skipped_lines": skipped}


def _fmt_row(label, led):
    wall = led["wall_s"]
    cats = led["categories"]
    gf = led["goodput_fraction"]
    parts = []
    for c in CATEGORIES:
        v = cats[c]
        if v or c in ("productive", "idle"):
            pct = (100.0 * v / wall) if wall else 0.0
            parts.append("%s %.2fs (%.0f%%)" % (c, v, pct))
    return "  %-28s wall %7.2fs  goodput %s\n    %s" % (
        label, wall,
        "n/a" if gf is None else "%.1f%%" % (100.0 * gf),
        "  ".join(parts))


def render(report):
    lines = ["goodput ledger — %d process(es)"
             % len(report["processes"])]
    for path in sorted(report["processes"]):
        lines.append(_fmt_row(path, report["processes"][path]))
    if len(report["processes"]) > 1:
        lines.append(_fmt_row("FLEET", report["fleet"]))
    if report.get("skipped_lines"):
        lines.append("  (%d torn/corrupt line(s) skipped)"
                     % report["skipped_lines"])
    return "\n".join(lines)
