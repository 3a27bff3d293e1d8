"""Fleet telemetry plane: live metrics scrape over RPC.

The port's copy of ``paddle_tpu/monitor/collector.py`` (pure Python).

PRs 2/4/6 made each *process* observable — a metrics registry, a
flight recorder, request SLOs — but the multi-replica fleet of PRs
8–10 was only observable by hand-collecting per-process JSONL files
after the fact. This module is the central half the survey's legacy
stack built a master runtime for (the pserver/master tier *tracks*
fleet state centrally): a ``Collector`` discovers every serving
process from the membership lease registry, scrapes each one's
metrics registry + flight-recorder delta over the shared RPC frame
protocol (the new ``METR`` / ``HLTH`` verbs every dispatch loop
serves), and re-exports ONE fleet registry — Prometheus text or a
JSON snapshot the SLO engine evaluates directly.

Merge semantics (the part a naive scraper gets wrong):

  * counters merge by EXACT SUM across processes,
  * histograms merge bucket-wise (every snapshot embeds its bucket
    boundaries; mismatched boundaries raise loudly),
  * gauges sum across the processes live at the last scrape,
  * a process RESTART (new incarnation, uptime reset) re-bases that
    process's contribution instead of producing a negative delta —
    fleet counters stay monotonic across respawns,
  * two endpoints served by the SAME process (a master + pserver
    hosted in one process share one registry) are deduped by
    incarnation — the registry is counted once, not once per port.

``TelemetryServer`` is the lightweight scrape-only endpoint for
processes that do not already host a dispatch loop (a trainer, a
bare engine): arm it with ``PADDLE_TPU_TELEMETRY=1`` (and
``PADDLE_TPU_TELEMETRY_KV=<host:port>`` to self-register in the
lease registry so collectors find it).

CLI surfaces: ``python -m paddle_tpu_torch.monitor watch --fleet
<kv-endpoint>`` renders the live scraped dashboard (in place of
multi-file log tailing), and ``python -m paddle_tpu_torch.slo spec.json
--metrics fleet.json`` gates the whole fleet with one spec.
"""

import copy
import json
import socket
import socketserver
import threading
import time

from . import metrics as _metrics
from .metrics import (META_KEY, bucket_percentile, merge_snapshots,
                      render_prometheus_snapshot)

__all__ = ["TelemetryServer", "TelemetryClient", "Collector",
           "render_prometheus_snapshot", "maybe_arm_from_flags",
           "TELEMETRY_ROLE", "AUTOSCALER_ROLE", "ROLLOUT_ROLE"]

TELEMETRY_ROLE = "telemetry"
# the serving.autoscale control loop lease-registers under this role so
# collectors scrape its fleet metrics (desired replicas, scale events,
# rolls) without configuration — string lives here so the monitor tier
# needs no import of the serving tier
AUTOSCALER_ROLE = "autoscaler"
# serving.rollout's canary-analysis controller: same
# contract — lease-registered, scrapeable, black-box-dumpable
ROLLOUT_ROLE = "rollout"


def _valid_endpoint(ep):
    """Scrapeable 'host:port'? Registry slots may carry arbitrary
    values and operators typo statics — a malformed one is skipped,
    never allowed to crash the scrape loop with a parse error."""
    if not isinstance(ep, str):
        return False
    host, _, port = ep.rpartition(":")
    return bool(host) and port.isdigit()



class TelemetryServer:
    """Scrape-only endpoint (METR / HLTH / DUMP / CLKS / EXIT on the shared
    frame protocol) for processes without a dispatch loop of their
    own. Serves the process-wide registry by default; tests may pin a
    private ``Registry`` (and swap it to model a restart)."""

    def __init__(self, host="127.0.0.1", port=0, role=TELEMETRY_ROLE,
                 registry=None, port_file=None):
        # late imports: monitor must stay importable before the
        # distributed tier exists (paddle_tpu/__init__ import order)
        from ..distributed.rpc import (_recv_msg, _send_msg,
                                       _clock_reply, _metr_reply,
                                       _hlth_reply, _dump_reply)
        from ..trace import runtime as _trace
        self.role = role
        self.registry = registry         # None -> global at call time
        outer = self

        def _serve(request, op, payload):
            if op == "METR":
                _metr_reply(request, payload, role=outer.role,
                            registry=outer.registry)
            elif op == "HLTH":
                _hlth_reply(request, role=outer.role,
                            registry=outer.registry)
            elif op == "DUMP":
                _dump_reply(request, payload, role=outer.role,
                            registry=outer.registry)
            elif op == "CLKS":
                _clock_reply(request)
            elif op == "EXIT":
                _send_msg(request, "OK")
                outer.stop()
                return False
            else:
                _send_msg(request, "ERR", "unknown op %s" % op)
            return True

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # same trace-header path as every other dispatch loop
                # (master/kv/replica): a traced scrape nests under the
                # collector's client span
                try:
                    while True:
                        op, name, payload, tctx = _recv_msg(
                            self.request, want_ctx=True)
                        trc = _trace._TRACER
                        if trc is not None and tctx is not None \
                                and op != "CLKS":
                            with trc.server_span("telemetry." + op,
                                                 tctx, op=op):
                                cont = _serve(self.request, op,
                                              payload)
                        else:
                            cont = _serve(self.request, op, payload)
                        if not cont:
                            break
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self.endpoint = "%s:%d" % (host, self.port)
        if port_file:
            with open(port_file, "w") as f:
                f.write(str(self.port))
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="ptpu-telemetry")

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()


class TelemetryClient:
    """One scrape connection (collector side). Verbs are pure reads —
    safe to re-issue; a failed scrape drops the connection and the
    next call reconnects lazily."""

    def __init__(self, endpoint, timeout=2.0):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = float(timeout)
        self._sock = None

    def _call(self, op, body=None):
        from ..distributed.rpc import _recv_msg, _send_msg
        if self._sock is None:
            s = socket.create_connection(self._addr,
                                         timeout=self._timeout)
            s.settimeout(self._timeout)
            self._sock = s
        try:
            _send_msg(self._sock, op, "",
                      json.dumps(body).encode() if body is not None
                      else b"")
            rop, _, payload = _recv_msg(self._sock)
        except (ConnectionError, OSError):
            self.close()
            raise
        if rop != "VAL":
            self.close()
            raise ConnectionError("%s reply %s" % (op, rop))
        return json.loads(bytes(payload).decode())

    def metr(self, cursor=None, events=True, ring=None):
        return self._call("METR", {"cursor": cursor, "events": events,
                                   "ring": ring})

    def hlth(self):
        return self._call("HLTH")

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _zeroed(ent):
    """Deep-copied snapshot entry with every series zeroed — the
    accumulator skeleton for a metric first seen on a restart base."""
    out = copy.deepcopy(ent)
    out["series"] = {}
    return out


def _delta_snapshot(cur, prev):
    """cur - prev for the CUMULATIVE kinds (counters, histograms) of
    two snapshots of the SAME registry incarnation; gauges are
    point-in-time and excluded (the collector reads them live). prev
    None = everything is new (first scrape / fresh incarnation)."""
    out = {}
    for name, ent in cur.items():
        if name == META_KEY or ent.get("kind") not in ("counter",
                                                       "histogram"):
            continue
        pent = (prev or {}).get(name)
        if pent is None or pent.get("kind") != ent.get("kind"):
            out[name] = copy.deepcopy(ent)
            continue
        d = _zeroed(ent)
        if ent["kind"] == "counter":
            for key, v in ent["series"].items():
                pv = pent["series"].get(key, 0)
                # a shrinking counter under one incarnation is a
                # registry reset the meta missed — re-base, never
                # emit a negative delta
                d["series"][key] = v - pv if v >= pv else v
        else:
            if list(ent.get("buckets", ())) != \
                    list(pent.get("buckets", ())):
                raise ValueError(
                    "histogram %r changed bucket boundaries "
                    "mid-incarnation" % name)
            for key, s in ent["series"].items():
                ps = pent["series"].get(
                    key, {"counts": [0] * len(s["counts"]),
                          "sum": 0.0, "count": 0})
                if s["count"] >= ps["count"]:
                    d["series"][key] = {
                        "counts": [c - pc for c, pc in
                                   zip(s["counts"], ps["counts"])],
                        "sum": s["sum"] - ps["sum"],
                        "count": s["count"] - ps["count"]}
                else:
                    d["series"][key] = copy.deepcopy(s)
        # drop all-zero series so the accumulator stays sparse
        if ent["kind"] == "counter":
            d["series"] = {k: v for k, v in d["series"].items() if v}
        else:
            d["series"] = {k: v for k, v in d["series"].items()
                           if v["count"]}
        if d["series"]:
            out[name] = d
    return out


class Collector:
    """Scrape-and-merge loop over a fleet's METR endpoints.

    Discovery: the membership lease registry (``kv_endpoint``) is
    listed for every role in ``roles`` — serving replicas, pservers,
    flag-armed telemetry endpoints — plus any ``static`` endpoints
    passed as ``(role, "host:port")`` pairs (the KV server and master
    are not themselves lease-registered). A slot whose lease expired
    simply stops appearing; its already-accumulated counter
    contributions remain (fleet counters are monotonic).

    ``scrape_once()`` performs one round and returns the merged NEW
    flight-recorder events (ts-sorted across processes — the live
    feed ``watch --fleet`` renders); ``fleet_snapshot()`` returns the
    merged registry snapshot (same schema as ``Registry.snapshot``,
    so ``python -m paddle_tpu_torch.slo --metrics`` gates it unchanged);
    ``render_prometheus()`` the text exposition of the same."""

    def __init__(self, kv_endpoint=None, roles=("ps", "replica",
                                                TELEMETRY_ROLE,
                                                AUTOSCALER_ROLE,
                                                ROLLOUT_ROLE),
                 static=(), timeout=2.0):
        self._kv_endpoint = kv_endpoint
        self._roles = tuple(roles)
        self._static = []
        for r, ep in static:
            if _valid_endpoint(ep):
                self._static.append((r, ep))
            else:
                import sys
                print("monitor.collector: ignoring malformed static "
                      "endpoint %s=%r (want host:port)" % (r, ep),
                      file=sys.stderr)
        self._timeout = float(timeout)
        self._kv = None
        self._lock = threading.Lock()
        # per-endpoint scrape state: {"role", "client", "incarnation",
        #  "uptime_s", "ok", "error", "last_ok_ts", "last_event_ts"}
        self._endpoints = {}
        # per-incarnation merge state: {"base": last snapshot,
        #  "gauges": last snapshot (for live gauge read), "cursor",
        #  "primary": endpoint, "last_seen": ts, "role"}
        self._incarnations = {}
        # the fleet accumulator: cumulative counter/histogram deltas
        self._acc = {}
        self.scrapes = 0
        self.events_lost = 0

    # -- discovery ---------------------------------------------------------
    def _discover(self):
        found = list(self._static)
        if self._kv_endpoint:
            if not _valid_endpoint(self._kv_endpoint):
                # same courtesy the statics get: a typo'd --fleet
                # value must degrade loudly, not traceback the loop
                import sys
                print("monitor.collector: malformed KV endpoint %r "
                      "(want host:port) — registry discovery "
                      "disabled" % self._kv_endpoint, file=sys.stderr)
                self._kv_endpoint = None
                return found
            from ..distributed import membership as _membership
            if self._kv is None:
                try:
                    # KVClient connects eagerly: a registry that is
                    # down (or not up YET — a dashboard may start
                    # first) must degrade to the static endpoints,
                    # not crash the scrape loop
                    self._kv = _membership.KVClient(
                        self._kv_endpoint, timeout=self._timeout)
                except (ConnectionError, OSError):
                    return found
            # the KV server itself serves METR too
            found.append(("kv", self._kv_endpoint))
            for role in self._roles:
                try:
                    live = _membership.live_endpoints(self._kv, role)
                except (ConnectionError, OSError):
                    # the KV server may have RESTARTED (its socket is
                    # dead but the registry will be healthy again):
                    # drop the client so next round reconnects —
                    # otherwise discovery silently degrades to the
                    # statics for the dashboard's whole life
                    self._kv.close()
                    self._kv = None
                    break
                for slot, ep in sorted(live.items()):
                    # a tombstoned slot (fleet eviction) is registry
                    # bookkeeping, not a process; any other
                    # non-endpoint value a registry slot may carry
                    # (live_endpoints: readers filter) is skipped —
                    # one garbage value must not poison the scrape
                    if ep.startswith(_membership.EVICTED_PREFIX):
                        continue
                    if ep.startswith(_membership.DRAINING_PREFIX):
                        # a gracefully draining replica is alive and
                        # MUST stay scrapeable — the drain itself is
                        # the telemetry story; strip the mark to
                        # recover the endpoint
                        ep = ep[len(_membership.DRAINING_PREFIX):]
                    if not _valid_endpoint(ep):
                        continue
                    found.append((role, ep))
        return found

    # -- scrape ------------------------------------------------------------
    def scrape_once(self):
        """One scrape round over every discovered endpoint. Returns
        the list of NEW flight-recorder events across the fleet,
        ts-sorted (each row gains ``proc`` = the serving role/endpoint
        so downstream consumers can attribute per process).

        One scraper drives a Collector (the watch loop shape) — the
        lock protects exporters (``fleet_snapshot`` / renderers)
        reading concurrently, and the network I/O runs OUTSIDE it so
        a dead endpoint's connect timeout never blocks an export for
        the whole round."""
        found = self._discover()
        now = time.time()
        new_events = []
        with self._lock:
            known = set(self._endpoints)
            for role, ep in found:
                st = self._endpoints.get(ep)
                if st is None:
                    st = self._endpoints[ep] = {
                        "role": role,
                        "client": TelemetryClient(
                            ep, timeout=self._timeout),
                        "incarnation": None, "uptime_s": None,
                        "ok": False, "error": None, "missing": 0,
                        "last_ok_ts": None, "last_event_ts": None}
                st["role"] = role
                st["missing"] = 0
                known.discard(ep)
            # endpoints that vanished from the registry: RETAIN their
            # state for a grace window instead of dropping it — a
            # transient registry flap (lease hiccup, KV error) would
            # otherwise destroy the endpoint->incarnation link, and
            # the next round's cursor-less scrape would replay the
            # whole recorder ring as "new" events (double-counted
            # totals/verdicts). Accumulated contributions always
            # survive either way.
            for ep in known:
                st = self._endpoints[ep]
                st["missing"] += 1
                if st["missing"] > self._MISSING_ROUNDS_MAX:
                    self._endpoints.pop(ep)["client"].close()
            round_eps = [(ep, st) for ep, st in
                         sorted(self._endpoints.items())]
        seen_incs = set()

        def scrape_endpoint(ep, st):
            with self._lock:
                inc_state = self._incarnations.get(st["incarnation"])
                pep = inc_state.get("primary") if inc_state else None
                # this endpoint fetches the event delta when it IS
                # the primary — or when the primary is gone OR its
                # last scrape failed (a dead-but-still-listed primary
                # must not freeze the process's event stream; the
                # apply phase reassigns and dedups, so a transition
                # round can never double-deliver)
                primary = (inc_state is None or pep in (None, ep)
                           or pep not in self._endpoints
                           or not self._endpoints[pep]["ok"])
                cursor = inc_state["cursor"] if (primary and inc_state)\
                    else None
                ring = inc_state.get("ring") if (primary and inc_state)\
                    else None
            try:
                rep = st["client"].metr(cursor=cursor, events=primary,
                                        ring=ring)
            except (ConnectionError, OSError, ValueError) as e:
                with self._lock:
                    st["ok"] = False
                    st["error"] = repr(e)
                return
            inc = rep.get("incarnation")
            # a RESPAWNED process (new incarnation) needs no special
            # event handling here: a stored cursor always travels
            # with its ring id, and the fresh recorder's ring id
            # mismatches — _metr_reply already restarted the delta
            # from the beginning server-side
            with self._lock:
                st["ok"] = True
                st["error"] = None
                # an answering process IS alive: registry absence
                # alone (KV down for minutes while replicas stay
                # healthy) must never age out its ring-cursor link —
                # only absence AND scrape failure does
                st["missing"] = 0
                st["last_ok_ts"] = now
                st["incarnation"] = inc
                st["uptime_s"] = rep.get("uptime_s")
                ist = self._incarnations.get(inc)
                if ist is None:
                    ist = self._incarnations[inc] = {
                        "base": None, "gauges": None, "cursor": None,
                        "ring": None, "primary": ep, "last_seen": None,
                        "role": st["role"]}
                if ist["primary"] not in self._endpoints or \
                        not self._endpoints[ist["primary"]]["ok"]:
                    # failover: first healthy endpoint of the
                    # incarnation to apply this round takes over the
                    # ring cursor (this one just answered, so its own
                    # ok is already True)
                    ist["primary"] = ep
                snap = rep.get("snapshot") or {}
                if inc not in seen_incs:
                    # merge once per PROCESS per round, however many
                    # of its ports we scraped. A schema violation
                    # (mixed-version fleet: same metric, different
                    # kind/buckets) marks THIS endpoint bad and skips
                    # its merge — merge_snapshots validates before
                    # mutating, so the accumulator stays consistent
                    # and the dashboard keeps rendering the rest.
                    seen_incs.add(inc)
                    try:
                        merge_snapshots(
                            self._acc,
                            _delta_snapshot(snap, ist["base"]))
                    except ValueError as e:
                        st["ok"] = False
                        st["error"] = repr(e)
                        return
                    ist["base"] = snap
                    ist["gauges"] = snap
                    ist["last_seen"] = now
                if ist["primary"] == ep:
                    rows = rep.get("events") or []
                    for r in rows:
                        r = dict(r)
                        r.setdefault("proc", "%s@%s"
                                     % (st["role"], ep))
                        new_events.append(r)
                    if rows:
                        st["last_event_ts"] = max(
                            [r.get("ts") or 0 for r in rows]
                            + [st["last_event_ts"] or 0])
                    if rep.get("ring") is not None:
                        ist["cursor"] = rep.get("cursor")
                        ist["ring"] = rep.get("ring")
                        self.events_lost += int(rep.get("lost") or 0)
                    else:
                        # recorder DISARMED (no ring in the reply):
                        # drop the saved cursor — a later re-arm is a
                        # fresh ring whose rows a stale cursor would
                        # silently filter out, the exact loss ring_id
                        # exists to prevent
                        ist["cursor"] = None
                        ist["ring"] = None

        # scrape CONCURRENTLY (bounded pool): a round over a fleet
        # with several wedged-but-leased replicas must cost ~one
        # timeout, not one per wedge — the lock-phased worker keeps
        # all state mutation serialized while only the socket waits
        # overlap. Dead AND delisted endpoints age out without
        # burning a connect timeout at all; a mere registry flap
        # (still answering) keeps being scraped normally.
        live_eps = [(ep, st) for ep, st in round_eps
                    if not (st["missing"] and not st["ok"])]
        if len(live_eps) > 1:
            import concurrent.futures as _cf
            with _cf.ThreadPoolExecutor(
                    max_workers=min(8, len(live_eps))) as pool:
                list(pool.map(lambda p: scrape_endpoint(*p),
                              live_eps))
        elif live_eps:
            scrape_endpoint(*live_eps[0])
        with self._lock:
            self.scrapes += 1
            self._prune_incarnations_locked()
        new_events.sort(key=lambda e: (e.get("ts") is None,
                                       e.get("ts") or 0.0))
        return new_events

    # how many consecutive rounds a registry-vanished endpoint's state
    # (the endpoint->incarnation link holding its ring cursor) is
    # retained before being dropped
    _MISSING_ROUNDS_MAX = 30

    # dead incarnations (supervisor respawns under chaos) each pin a
    # full snapshot dict in "base"/"gauges"; keep a bounded number so
    # a long-lived dashboard's memory doesn't grow with churn. The
    # bound is deliberately generous, not zero: a lease FLAP (same
    # process vanishes from the registry and returns) must find its
    # baseline again, or its counters would merge twice.
    _DEAD_INCARNATIONS_MAX = 256

    def _prune_incarnations_locked(self):
        live = {st["incarnation"] for st in self._endpoints.values()}
        dead = [(ist.get("last_seen") or 0, inc)
                for inc, ist in self._incarnations.items()
                if inc not in live]
        excess = len(dead) - self._DEAD_INCARNATIONS_MAX
        if excess > 0:
            for _, inc in sorted(dead)[:excess]:
                del self._incarnations[inc]

    # -- export ------------------------------------------------------------
    def fleet_snapshot(self):
        """Merged fleet registry snapshot: accumulated counter /
        histogram sums plus the LIVE processes' gauges, in the exact
        ``Registry.snapshot`` schema (histogram buckets embedded) so
        the SLO engine's ``--metrics`` surface evaluates it unchanged.
        The ``__meta__`` entry describes the fleet instead of one
        process."""
        with self._lock:
            out = copy.deepcopy(self._acc)
            live = {inc: ist for inc, ist in
                    self._incarnations.items()
                    if ist.get("gauges") is not None
                    and any(st["incarnation"] == inc and st["ok"]
                            for st in self._endpoints.values())}
            for ist in live.values():
                gauges = {name: ent for name, ent in
                          ist["gauges"].items()
                          if name != META_KEY
                          and ent.get("kind") == "gauge"}
                try:
                    merge_snapshots(out, gauges)
                except ValueError:
                    # mixed-version kind collision (this process
                    # exports a name another exports as a counter):
                    # skip ITS gauges — validate-then-apply keeps the
                    # export atomic, and the dashboard/exporters keep
                    # rendering everyone else
                    continue
            now = time.time()
            out[META_KEY] = {
                "fleet": True,
                "processes": len(live),
                "scrapes": self.scrapes,
                "events_lost": self.events_lost,
                "ts": now,
                "endpoints": [
                    {"endpoint": ep, "role": st["role"],
                     "incarnation": st["incarnation"],
                     "uptime_s": st["uptime_s"], "ok": st["ok"],
                     "error": st["error"],
                     "age_s": (now - st["last_ok_ts"])
                     if st["last_ok_ts"] else None,
                     "last_event_age_s":
                         (now - st["last_event_ts"])
                         if st["last_event_ts"] else None}
                    for ep, st in sorted(self._endpoints.items())],
            }
        return out

    def render_prometheus(self):
        return render_prometheus_snapshot(self.fleet_snapshot())

    def dump_json(self, path):
        with open(path, "w") as f:
            json.dump(self.fleet_snapshot(), f, indent=1,
                      sort_keys=True)

    def fleet_percentile(self, hist_name, q):
        """Bucket-interpolated q-quantile of a merged fleet histogram
        (all label series pooled); None when absent/empty."""
        snap = self.fleet_snapshot()
        ent = snap.get(hist_name)
        if not ent or ent.get("kind") != "histogram":
            return None
        buckets = [float(b) for b in ent.get("buckets", ())]
        counts = [0] * (len(buckets) + 1)
        for s in ent["series"].values():
            for i, c in enumerate(s.get("counts", ())):
                if i < len(counts):
                    counts[i] += int(c)
        if not sum(counts):
            return None
        return bucket_percentile(buckets, counts, q)

    def close(self):
        with self._lock:
            for st in self._endpoints.values():
                st["client"].close()
            self._endpoints = {}
            if self._kv is not None:
                self._kv.close()
                self._kv = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# -- flag-driven arming ------------------------------------------------------

_ARMED = None


def maybe_arm_from_flags():
    """PADDLE_TPU_TELEMETRY=1 starts the scrape-only TelemetryServer
    for this process (PADDLE_TPU_TELEMETRY_PORT pins the port; 0 =
    ephemeral). With PADDLE_TPU_TELEMETRY_KV=<host:port> the server
    self-registers in the membership lease registry under role
    ``telemetry`` so collectors discover it without configuration."""
    global _ARMED
    from .. import flags
    try:
        if not flags.get_flag("telemetry") or _ARMED is not None:
            return _ARMED
    except KeyError:
        return None
    try:
        srv = TelemetryServer(
            port=int(flags.get_flag("telemetry_port"))).start()
    except OSError as e:
        # telemetry must never take the process down: a pinned port
        # already bound (two workers sharing one env) degrades to
        # disarmed, same discipline as the KV-registration fallback
        import sys
        print("paddle_tpu_torch.monitor.collector: telemetry server "
              "failed to bind (%r); telemetry disarmed" % e,
              file=sys.stderr)
        return None
    lease = None
    kv_ep = flags.get_flag("telemetry_kv")
    if kv_ep:
        try:
            from ..distributed import membership as _membership
            kv = _membership.KVClient(kv_ep, timeout=5.0)
            # this runs at `import paddle_tpu` time: a short bounded
            # timeout (not register_endpoint's default 30 s) so a
            # full slot table or unreachable KV cannot stall every
            # worker's interpreter startup — the fallback is serving
            # unregistered, loudly
            _, lease = _membership.register_endpoint(
                kv, TELEMETRY_ROLE,
                int(flags.get_flag("telemetry_slots")),
                srv.endpoint, ttl=2.0, timeout=5.0)
        except Exception as e:
            import sys
            print("paddle_tpu_torch.monitor.collector: telemetry KV "
                  "registration failed (%r); serving unregistered on "
                  "%s" % (e, srv.endpoint), file=sys.stderr)
            try:
                # on success the lease keeps the client; on failure
                # nothing else would ever close it
                kv.close()
            except Exception:
                pass
    _ARMED = (srv, lease)
    return _ARMED
