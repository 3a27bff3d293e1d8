"""Merge per-process span logs into one skew-corrected fleet timeline.

The port's copy of ``paddle_tpu/trace/merge.py`` (pure Python).

Every process of a traced run wrote its own bounded JSONL span log;
this module stitches them into a single Perfetto/Chrome JSON with one
lane (pid) per process, the reference device_tracer's
many-sources-one-timeline move lifted to the fleet level:

  1. ``clock`` rows give per-(client, server) offset samples (midpoint
     method, trace/clock.py); per edge the minimum-RTT sample wins
     (tightest uncertainty bound).
  2. ``server_port`` rows map a sample's peer endpoint to the server's
     pid, turning samples into edges of a clock graph over processes.
  3. BFS from a reference process (the one with the most root spans —
     the trainer driving the steps) chains offsets, so a master that
     only ever talked to the trainer still lands on the pserver's
     corrected axis. Unreachable processes keep offset 0 and are named
     in ``info["warnings"]`` — never silently mis-corrected.
  4. Span timestamps are rebased: t_ref = t0 - offset(pid). A server
     span then NESTS inside the client span that caused it (same
     trace, parent linkage), which is the acceptance check for the
     whole subsystem.

``stats()`` answers the "why was step N slow" question numerically:
per-verb latency percentiles, per-round (root span) critical-path
breakdown, and straggler attribution (which verb@endpoint dominated
each round).
"""

import json
import sys

from ..monitor.recorder import percentile_sorted as _pct
from ..monitor.recorder import read_jsonl_tolerant

__all__ = ["load_logs", "clock_offsets", "merge_files", "stats_files",
           "render_stats"]


def load_logs(paths):
    """Parse span logs (tolerant of torn trailing lines — a live run's
    writer may have been killed mid-record)."""
    spans, clocks, ports, endpoints, procs = [], [], {}, {}, {}
    skipped = 0
    for path in paths:
        events, skip = read_jsonl_tolerant(path)
        skipped += skip
        for e in events:
            ev = e.get("ev")
            pid = e.get("pid")
            if pid is not None and e.get("proc"):
                procs.setdefault(pid, e["proc"])
            if ev == "span":
                spans.append(e)
            elif ev == "clock":
                clocks.append(e)
            elif ev == "server_port":
                # port -> set of pids: a port number REUSED across
                # hosts must be detected, never silently mis-credited
                ports.setdefault(int(e["port"]), set()).add(pid)
                if e.get("endpoint"):
                    endpoints[e["endpoint"]] = pid
    return {"spans": spans, "clocks": clocks, "ports": ports,
            "endpoints": endpoints, "procs": procs, "skipped": skipped}


def _peer_pid(peer, data, ambiguous):
    """Clock-sample peer endpoint -> server pid. Exact endpoint match
    first (disambiguates equal ports on different hosts); the bare-port
    fallback only resolves UNAMBIGUOUS ports — a collision drops the
    sample and is reported instead of skew-correcting with the wrong
    process's offset."""
    peer = str(peer)
    pid = data["endpoints"].get(peer)
    if pid is not None:
        return pid
    try:
        port = int(peer.rsplit(":", 1)[1])
    except (ValueError, IndexError):
        return None
    pids = data["ports"].get(port)
    if not pids:
        return None
    if len(pids) > 1:
        ambiguous.add(port)
        return None
    return next(iter(pids))


def clock_offsets(data):
    """({pid: seconds-ahead-of-reference}, ref_pid, warnings)."""
    spans = data["spans"]
    pids = sorted({s["pid"] for s in spans}
                  | set(data["procs"])
                  | {c["pid"] for c in data["clocks"]})
    if not pids:
        return {}, None, []
    # reference: the process driving the run (most root spans)
    roots = {}
    for s in spans:
        if s.get("parent") is None:
            roots[s["pid"]] = roots.get(s["pid"], 0) + 1
    ref = max(pids, key=lambda p: (roots.get(p, 0), -p))
    # best (min-rtt) sample per undirected edge
    edges = {}                   # (client_pid, server_pid) -> (rtt, off)
    ambiguous = set()
    for c in data["clocks"]:
        spid = _peer_pid(c.get("peer"), data, ambiguous)
        cpid = c.get("pid")
        if spid is None or cpid is None or spid == cpid:
            continue
        key = (cpid, spid)
        rtt = float(c.get("rtt", 0.0))
        if key not in edges or rtt < edges[key][0]:
            edges[key] = (rtt, float(c["offset"]))
    adj = {}                     # pid -> [(other, offset_other_minus_pid)]
    for (cpid, spid), (_, off) in edges.items():
        adj.setdefault(cpid, []).append((spid, off))
        adj.setdefault(spid, []).append((cpid, -off))
    offsets = {ref: 0.0}
    queue = [ref]
    while queue:
        cur = queue.pop(0)
        for other, off in adj.get(cur, ()):
            if other not in offsets:
                offsets[other] = offsets[cur] + off
                queue.append(other)
    warnings = []
    for port in sorted(ambiguous):
        warnings.append(
            "port %d is registered by multiple processes (%s) and the "
            "clock samples name no exact endpoint — those samples were "
            "dropped" % (port, sorted(data["ports"][port])))
    for p in pids:
        if p not in offsets:
            offsets[p] = 0.0
            warnings.append(
                "pid %d (%s) has no clock path to the reference pid %d "
                "— timestamps left uncorrected" %
                (p, data["procs"].get(p, "?"), ref))
    return offsets, ref, warnings


def _corrected(span, offsets):
    return float(span["t0"]) - offsets.get(span["pid"], 0.0)


def merge_files(paths):
    """-> (chrome_trace_dict, info). The trace dict is Perfetto-loadable
    JSON: per-process lanes ('M' process_name metadata), one 'X' event
    per span carrying trace/span/parent ids in args, and flow arrows
    for cross-process parent links."""
    data = load_logs(paths)
    offsets, ref, warnings = clock_offsets(data)
    spans = data["spans"]
    base = min((_corrected(s, offsets) for s in spans), default=0.0)
    events = []
    for pid in sorted({s["pid"] for s in spans} | set(data["procs"])):
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "%s (pid %d)"
                     % (data["procs"].get(pid, "proc"), pid)}})
    by_id = {s["span"]: s for s in spans}
    flow_serial = 0
    for s in spans:
        ts = (_corrected(s, offsets) - base) * 1e6
        args = {"trace": s["trace"], "span": s["span"],
                "parent": s.get("parent")}
        args.update(s.get("attrs") or {})
        events.append({"name": s["name"], "ph": "X", "cat": "trace",
                       "pid": s["pid"], "tid": s.get("tid", 0),
                       "ts": ts, "dur": float(s["dur"]) * 1e6,
                       "args": args})
        parent = by_id.get(s.get("parent"))
        if parent is not None and parent["pid"] != s["pid"]:
            # cross-process causality arrow (client verb -> server span)
            flow_serial += 1
            pts = (_corrected(parent, offsets) - base) * 1e6
            common = {"name": "rpc", "cat": "trace", "id": flow_serial}
            events.append(dict(common, ph="s", pid=parent["pid"],
                               tid=parent.get("tid", 0), ts=pts))
            events.append(dict(common, ph="f", bp="e", pid=s["pid"],
                               tid=s.get("tid", 0), ts=ts))
    info = {"spans": len(spans), "processes": len(offsets),
            "reference_pid": ref, "clock_offsets": offsets,
            "skipped_lines": data["skipped"], "warnings": warnings}
    return ({"traceEvents": events, "displayTimeUnit": "ms",
             "otherData": {"paddle_tpu_torch.trace": info}}, info)


# -- stats -----------------------------------------------------------------

def stats_files(paths, root_name=None):
    """Per-verb latency, per-round critical path, straggler attribution.
    A "round" is a root span (optionally filtered to ``root_name``);
    its direct children partition the round into RPC verbs vs local
    compute (the gap). All figures are LOCAL durations — no clock
    correction needed (or computed), unlike the merge."""
    data = load_logs(paths)
    spans = data["spans"]
    verbs = {}
    for s in spans:
        verbs.setdefault(s["name"], []).append(float(s["dur"]))
    verb_rows = []
    for name in sorted(verbs):
        ds = sorted(verbs[name])
        verb_rows.append({"name": name, "count": len(ds),
                          "p50_s": _pct(ds, 0.50), "p95_s": _pct(ds, 0.95),
                          "max_s": ds[-1]})
    children = {}
    for s in spans:
        if s.get("parent") is not None:
            children.setdefault(s["parent"], []).append(s)
    roots = [s for s in spans if s.get("parent") is None
             and (root_name is None or s["name"] == root_name)]
    rounds = []
    strag = {}
    for r in roots:
        kids = children.get(r["span"], [])
        by_verb = {}
        for k in kids:
            by_verb[k["name"]] = by_verb.get(k["name"], 0.0) \
                + float(k["dur"])
        total = float(r["dur"])
        rpc_total = sum(by_verb.values())
        entry = {"trace": r["trace"], "name": r["name"], "dur_s": total,
                 "by_verb_s": by_verb,
                 "local_s": max(0.0, total - rpc_total)}
        if kids:
            worst = max(kids, key=lambda k: float(k["dur"]))
            who = "%s@%s" % (worst["name"],
                             (worst.get("attrs") or {}).get("endpoint",
                                                            "local"))
            entry["straggler"] = who
            entry["straggler_share"] = (float(worst["dur"]) / total
                                        if total > 0 else 0.0)
            st = strag.setdefault(who, {"rounds": 0, "share_sum": 0.0})
            st["rounds"] += 1
            st["share_sum"] += entry["straggler_share"]
        rounds.append(entry)
    agg_verbs = {}
    for r in rounds:
        for v, d in r["by_verb_s"].items():
            agg_verbs[v] = agg_verbs.get(v, 0.0) + d
    n = len(rounds)
    durs = sorted(r["dur_s"] for r in rounds)
    return {
        "files": list(paths), "spans": len(spans),
        "skipped_lines": data["skipped"], "warnings": [],
        "verbs": verb_rows,
        "rounds": {
            "count": n,
            "p50_s": _pct(durs, 0.50), "p95_s": _pct(durs, 0.95),
            "mean_by_verb_s": {v: d / n for v, d in agg_verbs.items()}
            if n else {},
            "mean_local_s": (sum(r["local_s"] for r in rounds) / n)
            if n else None,
        },
        "stragglers": sorted(
            ({"who": who, "rounds": st["rounds"],
              "mean_share": st["share_sum"] / st["rounds"]}
             for who, st in strag.items()),
            key=lambda e: -e["rounds"]),
    }


def _ms(v):
    return "n/a" if v is None else "%.2fms" % (1000.0 * v)


def render_stats(s):
    lines = ["%d spans from %d file(s)%s" % (
        s["spans"], len(s["files"]),
        " (%d torn line(s) skipped)" % s["skipped_lines"]
        if s["skipped_lines"] else "")]
    for w in s["warnings"]:
        lines.append("  WARNING: " + w)
    lines.append("per-verb latency:")
    for row in s["verbs"]:
        lines.append("  %-24s n=%-5d p50 %-9s p95 %-9s max %s" % (
            row["name"], row["count"], _ms(row["p50_s"]),
            _ms(row["p95_s"]), _ms(row["max_s"])))
    r = s["rounds"]
    if r["count"]:
        lines.append("rounds (root spans): %d  p50 %s  p95 %s" % (
            r["count"], _ms(r["p50_s"]), _ms(r["p95_s"])))
        lines.append("  mean critical path: " + "  ".join(
            ["%s %s" % (v, _ms(d))
             for v, d in sorted(r["mean_by_verb_s"].items(),
                                key=lambda kv: -kv[1])]
            + ["local(compute) %s" % _ms(r["mean_local_s"])]))
    for e in s["stragglers"][:5]:
        lines.append("  straggler %-40s dominated %d round(s), mean "
                     "%.0f%% of the round"
                     % (e["who"], e["rounds"], 100 * e["mean_share"]))
    return "\n".join(lines)


def write_timeline(paths, out_path):
    merged, info = merge_files(paths)
    with open(out_path, "w") as f:
        json.dump(merged, f)
    for w in info["warnings"]:
        print("paddle_tpu_torch.trace: " + w, file=sys.stderr)
    return info
