"""Incident forensics: fleet black-box capture + bundle assembly.

The port's copy of ``paddle_tpu/monitor/forensics.py`` (pure Python;
bundles are written through the port's ``io.write_atomic_blob`` /
``write_json_atomic``).

The detect half of the loop exists (signals burn-rate incidents with
offender trace ids); this module is the diagnose half. When an
incident transitions OPEN (``attach()`` installs ``capture()`` as the
Signals capture hook) — or on demand from the CLI — a coordinator fans
the ``DUMP`` verb out across the lease registry and assembles every
process's black box into one CRC-manifested bundle directory:

    <dir>/
      __manifest__.json            completeness marker + per-file CRCs
      incident.json                the FIRING transition (rule, window
                                   figures, offender trace ids)
      part-<role>-<pid>.json       one DUMP reply: metrics snapshot,
                                   non-default flags, recorder ring
                                   tail, role state (engine slots /
                                   queue counts / registry view)
      part-<role>-<pid>.spans.jsonl   the process's tail span ring +
                                   server ports, 'ev'-tagged exactly
                                   like a span log so trace.merge
                                   consumes it unchanged
      part-coordinator-<pid>...    the capturing process itself (its
                                   ring holds the client/router spans)
                                   plus the capture-time clock-offset
                                   samples that skew-correct the rest

Capture must never stall serving: each endpoint gets a bounded
deadline and the fan-out DROPS slow or dead processes (recorded in the
manifest as ``missing`` — who failed to answer is itself forensic
signal). ``verify()`` re-hashes every part against the manifest;
``render()`` (the ``monitor bundle`` CLI) draws the skew-corrected
cross-process span tree centered on the offender traces.
"""

import json
import os
import socket
import threading
import time

from . import metrics as _metrics

__all__ = ["capture", "verify", "render", "attach", "last_bundle",
           "BUNDLE_MANIFEST"]

_REG = _metrics.registry()

BUNDLES = _REG.counter(
    "ptpu_forensics_bundles_total",
    "incident bundles assembled (autonomous capture-on-FIRING + CLI "
    "--capture)")
DUMP_FAILURES = _REG.counter(
    "ptpu_forensics_dump_failures_total",
    "DUMP captures dropped by the per-process deadline or a dead "
    "endpoint — the bundle records them as missing", ("role",))

BUNDLE_MANIFEST = "__manifest__.json"
BUNDLE_FORMAT = "ptpu-forensics-1"

_LAST_BUNDLE = None
_LAST_LOCK = threading.Lock()


def last_bundle():
    """Path of the most recent bundle this process assembled, or None
    — the pointer the watch dashboard's incidents line shows."""
    with _LAST_LOCK:
        return _LAST_BUNDLE


def _set_last(path):
    global _LAST_BUNDLE
    with _LAST_LOCK:
        _LAST_BUNDLE = path


# -- capture ---------------------------------------------------------------

def _capture_one(role, ep, timeout, clock_probes=3):
    """One endpoint's black box: a few CLKS round trips (midpoint
    clock-offset samples — the merge needs an edge from the
    coordinator to every captured process) then one DUMP. Raises on
    any failure; the fan-out turns that into a ``missing`` entry."""
    from ..distributed.rpc import _send_msg, _recv_msg
    from ..trace import clock as _clock
    host, port = ep.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=timeout)
    s.settimeout(timeout)
    try:
        clocks = []
        for _ in range(max(1, int(clock_probes))):
            t0 = time.time()
            _send_msg(s, "CLKS", "", b"")
            rop, _name, payload = _recv_msg(s)
            t3 = time.time()
            if rop != "OK":
                break
            server_t = float(json.loads(bytes(payload).decode())["t"])
            off, rtt = _clock.midpoint_offset(t0, server_t, t3)
            clocks.append({"ev": "clock", "ts": t3, "peer": ep,
                           "offset": off, "rtt": rtt,
                           "pid": os.getpid(), "proc": "forensics"})
        _send_msg(s, "DUMP", "", b"{}")
        rop, _name, payload = _recv_msg(s)
        if rop != "VAL":
            raise ConnectionError("DUMP reply %s from %s" % (rop, ep))
        part = json.loads(bytes(payload).decode())
        part["endpoint"] = ep
        part["discovered_role"] = role
        part["capture_clocks"] = clocks
        return part
    finally:
        try:
            s.close()
        except OSError:
            pass


def _discover(kv_endpoint, static, roles):
    """(role, endpoint) pairs: the collector's discovery (lease
    registry + statics), reused so capture sees exactly the fleet the
    dashboard sees."""
    from .collector import Collector, TELEMETRY_ROLE
    if roles is None:
        roles = ("ps", "replica", TELEMETRY_ROLE)
    c = Collector(kv_endpoint=kv_endpoint, roles=roles,
                  static=tuple(static or ()))
    try:
        return c._discover()
    finally:
        if c._kv is not None:
            c._kv.close()


def _local_part():
    """The coordinator's own black box — no RPC round trip (we ARE the
    process): tail span ring, recorder tail, metrics, flags. In an
    in-process fleet this part carries the client and router spans of
    the offender requests."""
    from . import runtime as _monrt
    part = {"role": "coordinator", "pid": os.getpid(),
            "t": time.time()}
    try:
        reg = _metrics.registry()
        part["incarnation"] = reg.incarnation
        part["uptime_s"] = reg.uptime_s()
        part["snapshot"] = reg.snapshot()
    except Exception:
        pass
    try:
        from .. import flags as _flags
        part["flags"] = _flags.overrides()
    except Exception:
        pass
    try:
        from ..trace import runtime as _trc
        part["spans"] = _trc.tail_dump()
    except Exception:
        pass
    rec = _monrt.recorder()
    if rec is not None:
        try:
            _cur, rows, lost = rec.events_since(None)
            part["events"] = rows[-1024:]
            part["events_lost"] = lost
            part["ring"] = rec.ring_id
        except Exception:
            pass
    return part


def _fan_out(targets, deadline_s):
    """DUMP every target concurrently with drop-if-slow semantics:
    each endpoint gets ``deadline_s``; a thread still running at the
    overall deadline is abandoned (daemon) and its target recorded as
    missing — a wedged replica must cost the bundle one part, not
    stall the capture (or the serving path behind it)."""
    parts, missing, lock = [], [], threading.Lock()
    done = set()

    def work(idx, role, ep):
        try:
            part = _capture_one(role, ep, timeout=deadline_s)
        except Exception as e:
            with lock:
                done.add(idx)
                missing.append({"role": role, "endpoint": ep,
                                "error": repr(e)})
            DUMP_FAILURES.inc(role=role)
            return
        with lock:
            done.add(idx)
            parts.append(part)

    threads = []
    for idx, (role, ep) in enumerate(targets):
        th = threading.Thread(target=work, args=(idx, role, ep),
                              daemon=True,
                              name="forensics-dump-%s" % ep)
        th.start()
        threads.append(th)
    deadline = time.monotonic() + deadline_s + 0.5
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()))
    with lock:
        for idx, (role, ep) in enumerate(targets):
            if idx not in done:
                done.add(idx)
                missing.append({"role": role, "endpoint": ep,
                                "error": "deadline exceeded (%.1fs)"
                                         % deadline_s})
                DUMP_FAILURES.inc(role=role)
        return list(parts), list(missing)


def _bundle_dir(base):
    if not base:
        from .. import flags as _flags
        base = _flags.get_flag("forensics_dir") or "forensics_bundles"
    name = "bundle-%d-%d" % (int(time.time() * 1000), os.getpid())
    path = os.path.join(base, name)
    os.makedirs(path, exist_ok=True)
    return path


def capture(incident=None, kv_endpoint=None, static=(), endpoints=None,
            roles=None, deadline_s=2.0, out_dir=None):
    """Assemble one incident bundle; returns its directory path.

    ``incident`` is a Signals FIRING transition dict (or None for an
    on-demand CLI capture). Targets come from ``endpoints`` ([(role,
    "host:port")]) when given, else lease-registry discovery via
    ``kv_endpoint`` + ``static``. Never raises past assembly errors a
    caller could do nothing about: a completely unreachable fleet
    still yields a bundle holding the coordinator part + the incident
    — partial forensics beat none."""
    from ..io import write_atomic_blob, write_json_atomic
    targets = list(endpoints) if endpoints is not None else \
        _discover(kv_endpoint, static, roles)
    parts, missing = _fan_out(targets, float(deadline_s)) \
        if targets else ([], [])
    parts.append(_local_part())
    path = _bundle_dir(out_dir)
    manifest = {"format": BUNDLE_FORMAT, "t": time.time(),
                "coordinator_pid": os.getpid(),
                "deadline_s": float(deadline_s),
                "parts": [], "missing": missing}
    if incident is not None:
        data = json.dumps(incident, default=repr).encode()
        manifest["incident_file"] = "incident.json"
        manifest["incident_crc32"] = write_atomic_blob(
            path, "incident.json", data)
        manifest["rule"] = incident.get("rule")
        manifest["offenders"] = [o.get("trace") for o in
                                 incident.get("offenders") or ()
                                 if o.get("trace")]
    used = set()
    for part in parts:
        spans = part.pop("spans", None)
        role = str(part.get("role", "proc"))
        pid = part.get("pid", 0)
        stem = "part-%s-%s" % (role.replace(os.sep, "_"), pid)
        # an in-process fleet shares one pid across roles: uniquify so
        # no part silently overwrites another's blob (the CRCs in the
        # manifest would then convict the survivor)
        n = 1
        while stem in used:
            n += 1
            stem = "part-%s-%s-%d" % (role.replace(os.sep, "_"),
                                      pid, n)
        used.add(stem)
        ent = {"file": stem + ".json", "role": role, "pid": pid,
               "endpoint": part.get("endpoint")}
        # capture-time clock samples ride in the SPANS file: they are
        # merge rows (coordinator pid -> endpoint edges), not state
        clocks = part.pop("capture_clocks", None) or []
        rows = list(clocks) + list(spans or [])
        ent["crc32"] = write_atomic_blob(
            path, ent["file"], json.dumps(part, default=repr).encode())
        if rows:
            blob = "\n".join(json.dumps(r, default=repr)
                             for r in rows).encode() + b"\n"
            ent["spans_file"] = stem + ".spans.jsonl"
            ent["spans_crc32"] = write_atomic_blob(
                path, ent["spans_file"], blob)
        manifest["parts"].append(ent)
    # the manifest lands LAST (atomic rename): its presence IS the
    # bundle's completeness marker, same contract as io checkpoints
    write_json_atomic(os.path.join(path, BUNDLE_MANIFEST), manifest)
    BUNDLES.inc()
    _set_last(path)
    return path


def attach(sig, **capture_kwargs):
    """Install autonomous capture-on-FIRING on a Signals evaluator:
    every incident OPEN transition assembles a bundle (offender traces
    are promoted by signals itself before the hook runs). Returns the
    hook so tests can call it directly."""

    def hook(tr):
        capture(incident=tr, **capture_kwargs)

    sig.capture_hook = hook
    return hook


def incidents_line(signals):
    """The one-line incidents summary the watch dashboards render
    under the alerts line: active incident count + rule names from the
    signals state, plus the most recent bundle this process assembled.
    Returns None when there is nothing to show (the frame stays
    byte-identical to pre-forensics output for quiet fleets)."""
    act = signals.active()
    bundle = last_bundle()
    if not act and bundle is None:
        return None
    if act:
        names = " ".join(sorted(act))
        line = "incident  %d active (%s)" % (len(act), names)
    else:
        line = "incident  none active"
    if bundle is not None:
        line += "   bundle %s" % bundle
    return line


# -- verify ----------------------------------------------------------------

def load_manifest(path):
    """The bundle manifest dict. Raises OSError/ValueError on a
    missing or unreadable manifest (CLI: usage error, exit 2)."""
    with open(os.path.join(path, BUNDLE_MANIFEST)) as f:
        m = json.load(f)
    if not isinstance(m, dict) or m.get("format") != BUNDLE_FORMAT:
        raise ValueError("not a forensics bundle (format %r)"
                         % (m.get("format") if isinstance(m, dict)
                            else None))
    return m


def verify(path, manifest=None):
    """Re-hash every manifested file. Returns a list of problem
    strings — empty means the bundle is intact."""
    import zlib
    if manifest is None:
        manifest = load_manifest(path)
    problems = []

    def check(fname, want):
        full = os.path.join(path, fname)
        try:
            with open(full, "rb") as f:
                data = f.read()
        except OSError as e:
            problems.append("%s: missing/unreadable (%s)" % (fname, e))
            return
        if zlib.crc32(data) != want:
            problems.append("%s: CRC mismatch (truncated or bit-"
                            "flipped write?)" % fname)

    if manifest.get("incident_file"):
        check(manifest["incident_file"], manifest["incident_crc32"])
    for ent in manifest.get("parts", ()):
        check(ent["file"], ent["crc32"])
        if ent.get("spans_file"):
            check(ent["spans_file"], ent["spans_crc32"])
    return problems


# -- render (the `monitor bundle` CLI body) --------------------------------

def _offender_traces(data, seeds):
    """Expand the offender trace-id set across the request-id join:
    the serving request span is a separate ROOT in the replica process
    (engine threads are unreachable from an ambient RPC stack), linked
    to the router/client spans by the ``rid`` attr. offender traces ->
    their rids -> every trace touching those rids."""
    seeds = {t for t in seeds if t}
    rids = set()
    for s in data["spans"]:
        if s.get("trace") in seeds:
            rid = (s.get("attrs") or {}).get("rid")
            if rid:
                rids.add(rid)
    traces = set(seeds)
    if rids:
        for s in data["spans"]:
            if (s.get("attrs") or {}).get("rid") in rids:
                traces.add(s.get("trace"))
    return traces, rids


def _render_tree(spans, offsets, procs, emit):
    """One skew-corrected span tree: children indented under parents,
    cross-process spans labeled with their lane."""
    from ..trace.merge import _corrected
    by_parent = {}
    by_id = {s["span"]: s for s in spans}
    roots = []
    for s in spans:
        p = s.get("parent")
        if p is not None and p in by_id:
            by_parent.setdefault(p, []).append(s)
        else:
            roots.append(s)
    base = min((_corrected(s, offsets) for s in spans), default=0.0)

    def walk(s, depth):
        t = _corrected(s, offsets) - base
        attrs = s.get("attrs") or {}
        extra = ""
        if attrs.get("error"):
            extra = "  ERROR %s" % attrs["error"]
        elif attrs.get("rid"):
            extra = "  rid=%s" % attrs["rid"]
        emit("    %s%-28s +%7.1fms %8.1fms  [%s]%s" % (
            "  " * depth, s["name"], t * 1000.0,
            float(s["dur"]) * 1000.0,
            procs.get(s["pid"], "pid%s" % s["pid"]), extra))
        for c in sorted(by_parent.get(s["span"], ()),
                        key=lambda c: _corrected(c, offsets)):
            walk(c, depth + 1)

    for r in sorted(roots, key=lambda s: _corrected(s, offsets)):
        walk(r, 0)


def render(path, out=None, lookback_s=600.0):
    """Verify + render a bundle to ``out`` (a line sink; default
    print). Returns an exit code on the analysis/slo convention:
    0 = rendered, bundle intact; 1 = CRC verification failed;
    the caller maps missing/unreadable bundles to 2."""
    from ..trace import merge as _merge
    emit = out if out is not None else print
    manifest = load_manifest(path)
    problems = verify(path, manifest)
    emit("forensics bundle %s" % path)
    emit("  captured %s  coordinator pid %s  deadline %.1fs" % (
        time.strftime("%Y-%m-%d %H:%M:%S",
                      time.localtime(manifest.get("t", 0))),
        manifest.get("coordinator_pid"), manifest.get("deadline_s", 0)))
    if problems:
        for p in problems:
            emit("  CORRUPT %s" % p)
        return 1
    emit("  manifest verified: %d part(s), %d missing, CRC ok" % (
        len(manifest.get("parts", ())),
        len(manifest.get("missing", ()))))
    for miss in manifest.get("missing", ()):
        emit("  MISSING %s %s: %s" % (miss.get("role"),
                                      miss.get("endpoint"),
                                      miss.get("error")))
    # -- incident summary
    incident, offender_ids = None, list(manifest.get("offenders") or ())
    if manifest.get("incident_file"):
        with open(os.path.join(path, manifest["incident_file"])) as f:
            incident = json.load(f)
        emit("incident: %s  severity=%s  state=%s  at %s" % (
            incident.get("rule"), incident.get("severity"),
            incident.get("state"),
            time.strftime("%H:%M:%S",
                          time.localtime(incident.get("ts", 0)))))
        figs = incident.get("figures") or {}
        if figs:
            # the burn-rate window that tripped, verbatim figures
            emit("  window: " + "  ".join(
                "%s=%s" % (k, _fig(v)) for k, v in sorted(figs.items())))
        for o in incident.get("offenders") or ():
            emit("  offender trace=%s proc=%s why=%s" % (
                o.get("trace"), o.get("proc"), o.get("why")))
    # -- per-process parts + metric deltas over the lookback
    span_files = []
    incident_ts = (incident or {}).get("ts") or manifest.get("t", 0)
    for ent in manifest.get("parts", ()):
        with open(os.path.join(path, ent["file"])) as f:
            part = json.load(f)
        if ent.get("spans_file"):
            span_files.append(os.path.join(path, ent["spans_file"]))
        errs = reqs = 0
        for e in part.get("events") or ():
            if e.get("ev") == "serving_request" and \
                    (e.get("ts") or 0) >= incident_ts - lookback_s:
                reqs += 1
                if e.get("error"):
                    errs += 1
        state = part.get("state") or {}
        emit("  part %-10s pid=%-7s %s%s" % (
            ent["role"], ent["pid"],
            "requests=%d errors=%d " % (reqs, errs)
            if reqs or errs else "",
            " ".join("%s=%s" % (k, _fig(state[k]))
                     for k in sorted(state)[:6])))
    # -- the offender-centered cross-process timeline
    if span_files:
        data = _merge.load_logs(span_files)
        offsets, ref, warnings = _merge.clock_offsets(data)
        for w in warnings:
            emit("  WARNING: %s" % w)
        traces, rids = _offender_traces(data, offender_ids)
        picked = [s for s in data["spans"] if s.get("trace") in traces]
        if picked:
            emit("offender timeline (%d spans, %d trace(s), rid %s; "
                 "skew-corrected to pid %s):" % (
                     len(picked), len(traces),
                     ",".join(sorted(rids)) or "-", ref))
            _render_tree(picked, offsets, data["procs"], emit)
        elif offender_ids:
            emit("offender traces %s: no spans captured (ring rotated "
                 "past the onset?)" % ",".join(offender_ids))
        else:
            emit("no offender traces named; bundle holds %d span(s) "
                 "across %d process(es)" % (len(data["spans"]),
                                            len(data["procs"])))
    return 0


def _fig(v):
    if isinstance(v, float):
        return "%.4g" % v
    return str(v)
