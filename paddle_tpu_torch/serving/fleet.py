"""Serving fleet: self-healing multi-replica router with exactly-once
decode under churn.

The port's copy of ``paddle_tpu/serving/fleet.py`` (the same frames,
verbs and journal, byte for byte, so a router or collector of either
package drives replicas of the other; cells are port ``Engine``s on the
card).

ROADMAP direction 2 composed: every fleet primitive the runtime already
has — membership's TTL-lease KV (the replica registry), resilience's
retry ``Policy`` + seeded fault injection, the frame protocol of
``distributed/rpc.py`` (so faults / trace context / retries ride along
for free), trace spans and the SLO error budget — put in front of N
``serving.Engine`` replicas the way production serving systems put a
fault-tolerant front door ahead of iteration-level schedulers (Orca,
OSDI '22) and treat replica churn as steady state (Borg, EuroSys '15).

Topology::

                    submit()/result()
                          |
                       Router ————— lease registry (KVServer, role
                      /  |  \\            '/replica/<slot>')
                SUBM /   |   \\ POLL+CANC      |
                    /    |    \\          Supervisor (respawns dead /
             ReplicaServer x N            evicted slots via factory)
                 |  journal (dedup by id)
              Engine (continuous batching, greedy decode)

Verbs (length-prefixed frames, same wire as the pserver/master/KV
tiers — an armed fault plan, tracer, or retry policy hooks them with
zero new plumbing):

    SUBM  name=<rid>  {prompt, max_new,   admit once (journal dedups a
                       sampling?}         retried/duplicated id);
                                          sampling = SamplingParams
                                          dict — carried in
                                          the journal, so resubmission
                                          re-executes with the SAME
                                          temperature/top-k/top-p/seed
                                          and stays deterministic
    POLL  {wait, max}                     long-poll finished-but-unacked
                                          results (at-least-once
                                          delivery; re-polled until
                                          acked)
    CANC  name=<rid>                      ack/forget a delivered result
                                          (idempotent)
    STAT                                  replica load/health snapshot
    METR / HLTH                           fleet telemetry scrape
                                          (monitor/collector.py):
                                          metrics-registry snapshot +
                                          recorder delta / liveness
    CLKS / EXIT                           clock probe / shutdown

Exactly-once contract: the Router assigns each accepted request a
durable id and journals it; dispatch is at-least-once (resubmission on
replica lease expiry, watchdog stall-eviction, or verb failure past the
retry deadline), delivery is at-least-once (results stay in the replica
journal until acked), and BOTH are deduped by id — the replica journal
dedups admission, the router journal dedups completion, so a
slow-but-alive replica's late result cannot double-complete a request
that a survivor re-executed. Greedy decode determinism makes the
re-execution token-identical, which is what lets the chaos gate
(tests/test_fleet.py) pin "kill a replica mid-traffic → every accepted
request completes exactly once, token-identical to the fault-free run".

Backpressure and load shedding: dispatch respects a bounded per-replica
in-flight window (``serving_fleet_window``); requests beyond it queue
router-side. Once the global queue bound (``serving_fleet_queue``) is
hit, ``submit`` fast-fails with the typed ``Overloaded`` error, counted
against the SLO error budget (a ``serving_request`` row with the error
lands under the router's engine label).

Telemetry: ``ptpu_fleet_{replicas,requests,resubmissions,shed,
evictions,duplicate_results}_*`` metrics plus the live
``ptpu_fleet_queue_depth`` gauge (the standing dispatch-queue depth
monitor.signals' queue-pressure rule reads); ``router.dispatch`` spans
(rid / slot / endpoint attrs — a resubmitted id shows two dispatch
spans with different endpoints, the resubmission hop ``trace merge``
renders) nesting the ``fleet.subm`` client verb span whose context
propagates into the replica's ``replica.SUBM`` server span; engine-side
request rows/spans carry the durable id (``Engine.submit(request_id=)``)
so the fleet's per-replica logs union into one SLO verdict
(``python -m paddle_tpu_torch.slo spec.json --log replica0.jsonl
replica1.jsonl ...``).
"""

import collections
import itertools
import json
import threading
import time
import uuid
import zlib

from ..distributed import membership as _membership
from ..distributed.membership import KVClient
from ..distributed.rpc import (_send_msg, _recv_msg, _clock_reply,
                               _metr_reply, _hlth_reply, _dump_reply)
from ..monitor import metrics as _metrics
from ..monitor import runtime as _monrt
from ..resilience import faults as _faults
from ..resilience.retry import Policy, RETRYABLE
from ..trace import runtime as _trace
from .engine import Engine, _flag

__all__ = ["Overloaded", "ReplicaDraining", "ReplicaServer", "Replica",
           "ReplicaClient", "Router", "FleetRequest", "Supervisor",
           "choose_replica", "REPLICA_ROLE", "CANDIDATE_ROLE",
           "EVICTED_PREFIX", "DRAINING_PREFIX", "VERSION_PREFIX"]

REPLICA_ROLE = "replica"
# Candidate replicas (canary analysis plane) register under
# their OWN role so the incumbent registry, its Supervisor and the
# collector's default discovery never see them; the router resolves
# the role only while a mirror is armed and keys candidate slots at
# _CAND_BASE + <registry slot> so one journal/poller/dedup machinery
# serves both populations (exactly-once holds across the split).
CANDIDATE_ROLE = "candidate"
_CAND_BASE = 1 << 20
# Stall-evicted slots are TOMBSTONED (CAS endpoint -> marker) rather
# than deleted: a delete would let the wedged holder's lease thread
# reclaim the slot with its create-if-absent CAS, while a changed value
# makes its next expect-guarded keepalive FAIL -> `lost` -> it stops
# serving a slot it no longer holds (membership's split-brain guard,
# reused as the eviction mechanism). The marker itself is
# registry-level protocol shared with every registry reader (the
# monitor collector filters it during discovery), so it lives in
# membership; re-exported here for the existing fleet API surface.
EVICTED_PREFIX = _membership.EVICTED_PREFIX
# Graceful-drain lease mark: the retiring holder re-marks
# its OWN lease value to "draining:<ep>" — the lease stays alive, the
# router keeps polling the endpoint for in-flight results but stops
# dispatching new work there. Registry-level protocol like
# EVICTED_PREFIX; lives in membership, re-exported here.
DRAINING_PREFIX = _membership.DRAINING_PREFIX
# Canary lease mark: a candidate replica's lease value is
# "version:<ver>:<ep>" so the registry itself carries the version the
# endpoint serves; the router strips it during candidate resolution
# and stamps the version on canary dispatch spans.
VERSION_PREFIX = _membership.VERSION_PREFIX

_REG = _metrics.registry()
FLEET_REPLICAS = _REG.gauge(
    "ptpu_fleet_replicas",
    "live serving replicas resolved from the lease registry", ("router",))
FLEET_REQUESTS = _REG.counter(
    "ptpu_fleet_requests_total", "requests accepted by the router",
    ("router",))
FLEET_RESUBMISSIONS = _REG.counter(
    "ptpu_fleet_resubmissions_total",
    "journaled requests re-submitted to a survivor after replica "
    "death/eviction", ("router",))
FLEET_SHED = _REG.counter(
    "ptpu_fleet_shed_total",
    "requests fast-failed (Overloaded) at the global queue bound",
    ("router",))
# live pressure gauge: the shed counter records the DROPS,
# this gauge the router's standing dispatch-queue depth — the
# queue-pressure input monitor.signals' sustained rules and the
# direction-2 autoscaling scale_hint() read (previously counters-only,
# so "is the queue deep RIGHT NOW" was not scrapeable)
FLEET_QUEUE_DEPTH = _REG.gauge(
    "ptpu_fleet_queue_depth",
    "requests waiting in the router's dispatch queue", ("router",))
FLEET_EVICTIONS = _REG.counter(
    "ptpu_fleet_evictions_total",
    "replicas evicted from dispatch", ("reason",))
FLEET_DUPLICATES = _REG.counter(
    "ptpu_fleet_duplicate_results_total",
    "late results for already-completed ids, deduped by the journal",
    ("router",))
# canary analysis plane: mirrored = shadow duplicates
# dispatched (scored, never served), dropped = duplicates abandoned
# best-effort (candidate dead/overloaded/timed out — NEVER affects the
# served request), canary = requests the weighted split sent to a
# candidate for real
FLEET_MIRRORED = _REG.counter(
    "ptpu_fleet_mirrored_total",
    "requests duplicated to shadow candidate replicas", ("router",))
FLEET_MIRROR_DROPPED = _REG.counter(
    "ptpu_fleet_mirror_dropped_total",
    "shadow duplicates abandoned without a joined pair", ("router",))
FLEET_CANARY = _REG.counter(
    "ptpu_fleet_canary_total",
    "requests served FOR REAL by canary candidate replicas",
    ("router",))


class Overloaded(RuntimeError):
    """Typed load-shed error: the router's global queue bound is hit.
    Raised synchronously from ``submit`` (fast-fail — the caller can
    back off / retry elsewhere) and counted against the SLO error
    budget."""

    def __init__(self, queued, bound):
        super().__init__(
            "router overloaded: %d queued >= global bound %d"
            % (queued, bound))
        self.queued = queued
        self.bound = bound


class ReplicaDraining(RuntimeError):
    """Typed SUBM NACK ("DRNG" reply) from a gracefully draining
    replica: admissions are closed while in-flight work retires and
    POLL/CANC keep serving. NOT retryable wire-level (the replica is
    healthy — retrying the same endpoint is pointless) and NOT a
    request failure: the router requeues the request for another
    replica without burning its attempt budget."""

    def __init__(self, rid):
        super().__init__("replica draining: %s not admitted" % rid)
        self.rid = rid


# -- replica side -----------------------------------------------------------

class ReplicaServer:
    """RPC front of ONE Engine replica (SUBM/POLL/CANC/STAT on the
    rpc.py frame protocol). The journal makes admission idempotent
    (exactly-once per id even when the router's at-least-once dispatch
    retries or a fault duplicates the frame) and keeps finished results
    until the router acks them with CANC (at-least-once delivery).

    Fault sites (armed plan): ``kill`` target ``replica`` /
    ``replica:<slot>`` hard-crashes the server exactly like the pserver
    kill-switch; ``stall`` wedges EVERY dispatch for its duration —
    the lease keeps beating (the 'process' is alive), so only the
    router's response-deadline watchdog can evict it."""

    _PRUNE_S = 120.0

    def __init__(self, engine, host="127.0.0.1", port=0, slot=None,
                 on_crash=None):
        import socketserver
        self.engine = engine
        self.slot = slot
        self.version = None        # serving artifact version
        self.kill_role = "replica"  # chaos-kill target role; Replica
        # rebinds it ("candidate") so plans can crash canary cells only
        self._on_crash = on_crash
        self._draining = False     # drain state: NACK new SUBM, keep
        self._lock = threading.Lock()  # POLL/CANC/STAT serving
        self._fin_cv = threading.Condition(self._lock)
        self._jobs = {}            # rid -> {"req": Request, "t0": ts}
        self._accepted = 0         # SUBMs admitted (fault thresholds)
        self._stall_until = 0.0
        # event-driven delivery: the engine's completion hook wakes
        # long-polling handlers the moment a future resolves, so the
        # router sees a result one RPC round trip after retirement
        # instead of a poll-granularity later
        engine.on_retire = self._on_engine_retire
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        op, name, payload, tctx = _recv_msg(
                            self.request, want_ctx=True)
                        trc = _trace._TRACER
                        if trc is not None and tctx is not None \
                                and op != "CLKS":
                            with trc.server_span("replica." + op, tctx,
                                                 op=op, rid=name):
                                outer._dispatch(self.request, op, name,
                                                payload)
                        else:
                            outer._dispatch(self.request, op, name,
                                            payload)
                        if op == "EXIT":
                            break
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self.endpoint = "%s:%d" % (host, self.port)
        trc = _trace._TRACER
        if trc is not None:
            trc.record_server_port(self.port, self.endpoint)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()

    def drain(self):
        """Close admissions (new SUBM gets the typed DRNG NACK, which
        the router re-dispatches elsewhere) while POLL/CANC/STAT keep
        serving so in-flight work retires and is acked. One-way: a
        draining server never re-admits — the cell retires next."""
        self._draining = True

    # ------------------------------------------------------------------
    def _maybe_fault(self):
        plan = _faults._ACTIVE
        if plan is None:
            return
        targets = [self.kill_role]
        if self.slot is not None:
            targets.append("%s:%d" % (self.kill_role, self.slot))
        v = self._accepted
        for t in targets:
            if plan.should_kill(t, v):
                # hard crash: no reply for the in-flight request; the
                # cell's on_crash models the whole process dying (lease
                # thread included). stop() must run off-thread —
                # shutdown() handshakes with serve_forever.
                cb = self._on_crash or self.stop
                threading.Thread(target=cb, daemon=True).start()
                raise ConnectionError("injected fault: replica killed")
            secs = plan.should_stall(t, v)
            if secs:
                self._stall_until = max(self._stall_until,
                                        time.monotonic() + secs)
        until = self._stall_until
        now = time.monotonic()
        if until > now:
            # wedge: EVERY handler thread that reaches dispatch sleeps
            # out the stall — the replica stops answering while its
            # engine thread (deliberately untouched) keeps decoding,
            # which is exactly the slow-but-alive shape whose late
            # results the router journal must dedup
            time.sleep(until - now)

    def _on_engine_retire(self, req):
        with self._fin_cv:
            self._fin_cv.notify_all()

    def _collect_done_locked(self, cap):
        done = []
        for rid, job in self._jobs.items():
            req = job["req"]
            if not req.done():
                continue
            if req._error is not None:
                done.append({"id": rid, "error": repr(req._error)})
            else:
                ent = {"id": rid, "tokens": list(req.tokens),
                       "score": req.score}
                ver = getattr(req, "versions", None)
                if ver is not None:
                    # scoring result: the served cache-version
                    # coordinates travel with the score so the caller
                    # can check its pin (determinism contract)
                    ent["versions"] = ver
                done.append(ent)
            if len(done) >= cap:
                break
        return done

    def _prune_locked(self, now):
        dead = [rid for rid, j in self._jobs.items()
                if j["req"].done() and now - j["t0"] > self._PRUNE_S]
        for rid in dead:                 # router gone: never acked
            del self._jobs[rid]

    def _dispatch(self, sock, op, name, payload):
        self._maybe_fault()
        if op == "SUBM":
            body = json.loads(bytes(payload).decode())
            bad = None
            drng = False
            with self._lock:
                self._prune_locked(time.time())
                if self._draining and name not in self._jobs:
                    # drain NACK: no NEW admissions (a duplicate SUBM
                    # for an already-journaled id still acks OK — the
                    # dedup contract holds through the drain). Sent
                    # below, after the lock (lock-discipline).
                    drng = True
                elif name not in self._jobs:
                    try:
                        if "features" in body:
                            # scoring payload (serving.sparse): the
                            # replica fronts a ScoringEngine — same
                            # journal/dedup/delivery machinery, the
                            # score rides the result wire's "score"
                            # with empty tokens
                            req = self.engine.submit(
                                body["features"], request_id=name,
                                version_pin=body.get("version_pin"))
                        else:
                            req = self.engine.submit(
                                body["prompt"], body["max_new"],
                                request_id=name,
                                sampling=body.get("sampling"))
                    except (ValueError, TypeError) as e:
                        # invalid request (e.g. prompt + max_new past
                        # the model's max_len — ValueError) or a
                        # WORKLOAD mismatch (TypeError: a scoring
                        # payload reaching a decode engine in a fleet
                        # that mixed replica kinds under one role):
                        # a typed reply — NOT a torn connection — so
                        # the router fails it terminally instead of
                        # retrying it into every replica in turn.
                        # Sent below, after the lock: a slow reader
                        # must not stall the other handler threads
                        # (analysis --runtime, lock-discipline).
                        bad = repr(e).encode()
                    except RuntimeError as e:
                        # engine closed (replica dying): tear the
                        # connection — the router retries elsewhere
                        raise ConnectionError(
                            "replica engine unavailable: %s" % e)
                    else:
                        self._jobs[name] = {"req": req,
                                            "t0": time.time()}
                        self._accepted += 1
            if drng:
                _send_msg(sock, "DRNG", name)
                return
            if bad is not None:
                _send_msg(sock, "BADR", name, bad)
                return
            _send_msg(sock, "OK", name)
        elif op == "POLL":
            body = json.loads(bytes(payload).decode()) if payload else {}
            wait = min(float(body.get("wait", 0.0)), 5.0)
            cap = int(body.get("max", 16))
            deadline = time.monotonic() + wait
            with self._fin_cv:
                while True:
                    done = self._collect_done_locked(cap)
                    remaining = deadline - time.monotonic()
                    if done or remaining <= 0:
                        break
                    # woken by the engine's on_retire hook the moment
                    # a future resolves (event-driven, not a scan)
                    self._fin_cv.wait(remaining)
            _send_msg(sock, "VAL", "",
                      json.dumps({"done": done}).encode())
        elif op == "CANC":
            # name: one rid, or a comma-joined batch (the router acks
            # a whole POLL delivery in ONE round trip)
            with self._lock:
                for rid in name.split(","):
                    self._jobs.pop(rid, None)
            _send_msg(sock, "OK", name)
        elif op == "STAT":
            with self._lock:
                inflight = sum(1 for j in self._jobs.values()
                               if not j["req"].done())
                unacked = len(self._jobs)
            st = self.engine.stats
            _send_msg(sock, "VAL", "", json.dumps({
                "slot": self.slot, "inflight": inflight,
                "unacked": unacked, "slots": self.engine.slots,
                "steps": st["steps"], "tokens": st["tokens"],
                "admissions": st["admissions"],
                "version": self.version,
                "draining": self._draining}).encode())
        elif op == "CLKS":
            _clock_reply(sock)
        elif op == "METR":
            # fleet telemetry scrape — deliberately BEHIND _maybe_fault
            # like every other verb: a wedged replica that stops
            # answering METR is exactly the staleness a collector must
            # see, not paper over
            _metr_reply(sock, payload, role="replica")
        elif op == "HLTH":
            _hlth_reply(sock, role="replica")
        elif op == "DUMP":
            # black-box capture — also behind _maybe_fault: a wedged
            # replica is dropped by the coordinator's deadline, which
            # is itself forensic signal (the bundle records who failed
            # to answer)
            with self._lock:
                inflight = sum(1 for j in self._jobs.values()
                               if not j["req"].done())
                unacked = len(self._jobs)
            st = self.engine.stats
            _dump_reply(sock, payload, role="replica", state={
                "slot": self.slot, "inflight": inflight,
                "unacked": unacked, "slots": self.engine.slots,
                "steps": st["steps"], "tokens": st["tokens"],
                "admissions": st["admissions"],
                "version": self.version,
                "draining": self._draining})
        elif op == "EXIT":
            _send_msg(sock, "OK")
            self.stop()
        else:
            _send_msg(sock, "ERR", "unknown op %s" % op)


class Replica:
    """One serving replica 'process': Engine + ReplicaServer + a TTL
    lease in the role registry (membership.register_endpoint). The
    Supervisor replaces the whole cell on death/eviction; a replacement
    built from the same model weights (shared object in-process, or a
    checkpoint in a real deployment) re-executes resubmitted requests
    token-identically — greedy decode is deterministic."""

    def __init__(self, kv, model, desired, slots=2, ttl=0.5,
                 role=REPLICA_ROLE, name=None, engine_factory=None,
                 version=None, shadow=False, **engine_kwargs):
        self.name = name or ("replica-" + uuid.uuid4().hex[:6])
        # serving artifact version (rolling updates): explicit,
        # or derived from the artifact directory name when cold-booting
        # from an inference artifact — stamped into STAT/DUMP and
        # the fleet's version-mix telemetry
        if version is None and isinstance(model, str):
            import os
            version = os.path.basename(os.path.normpath(model))
        self.version = version
        self.shadow = bool(shadow)
        if engine_factory is not None:
            # non-decode cells (serving.sparse ScoringEngine): the
            # factory builds anything speaking the Engine protocol
            # (submit/close/stats/slots/on_retire) — the RPC front,
            # lease, journal and router machinery are workload-blind
            self.engine = engine_factory(self.name)
        else:
            self.engine = Engine(model, slots=slots, name=self.name,
                                 **engine_kwargs)
        # canary analysis plane: shadow cells mark every
        # engine row/metric as mirrored (excluded from the incumbent
        # SLO surface); the version rides serving_request rows either
        # way so delta objectives can split samples by version
        try:
            self.engine.shadow = self.shadow
            self.engine.version = self.version
        except AttributeError:
            pass               # slotted factory engines: rows unmarked
        self.server = ReplicaServer(self.engine, on_crash=self.crash)
        self.endpoint = self.server.endpoint
        try:
            self.slot, self.lease = _membership.register_endpoint(
                kv, role, desired, self.endpoint, ttl=ttl)
        except Exception:
            # no free slot (registration raced/timed out): a half-built
            # cell must not leak its decode thread and listening socket
            # — the Supervisor retries with a fresh cell next tick
            try:
                self.server.stop()
            except OSError:
                pass
            self.engine.close()
            raise
        self.server.slot = self.slot
        self.server.version = self.version
        # fault kill-switches address cells by role ("candidate" /
        # "candidate:<slot>" vs the default "replica"), so a chaos plan
        # can kill a candidate mid-shadow without touching incumbents
        self.server.kill_role = role
        if role == CANDIDATE_ROLE and self.version:
            # stamp the version on the lease (registry-level canary
            # protocol): readers see which artifact the endpoint
            # serves. Best-effort — STAT still reports the version.
            try:
                self.lease.mark("%s%s:%s" % (VERSION_PREFIX,
                                             self.version,
                                             self.endpoint))
            except (ConnectionError, OSError):
                pass
        self.server.start()

    def drain(self):
        """Begin a graceful drain: close admissions on the server (new
        SUBM → typed DRNG NACK the router re-dispatches) and re-mark
        the lease value to ``draining:<ep>`` so every registry reader
        sees the state. The lease keeps beating — the router must keep
        polling for in-flight results until they are delivered and
        acked; the caller retires the cell (``shutdown``) once STAT
        reports inflight == 0 and unacked == 0."""
        self.server.drain()
        try:
            self.lease.mark(DRAINING_PREFIX + self.endpoint)
        except (ConnectionError, OSError):
            pass                 # KV unreachable: DRNG NACKs still gate

    def crash(self):
        """The injected-kill path: the whole 'process' dies — server,
        lease heartbeat, engine. In-flight engine requests fail with
        attribution (their rows carry the error; the router re-executes
        them on a survivor)."""
        self.lease._stop.set()
        try:
            self.server.stop()
        except OSError:
            pass
        self.engine.close()

    def shutdown(self):
        """Graceful leave: revoke the lease first so the router stops
        routing here before the endpoint disappears."""
        try:
            self.lease.revoke()
        except (ConnectionError, OSError):
            pass
        try:
            self.server.stop()
        except OSError:
            pass
        self.engine.close()


# -- router side ------------------------------------------------------------

class ReplicaClient:
    """Router-side client for one replica endpoint. EVERY verb is
    idempotent by construction — SUBM dedups by id in the replica
    journal, POLL/STAT are reads, CANC re-acks — so all of them may run
    under a retry ``Policy`` (reconnect + re-issue on socket errors),
    and the policy's total deadline doubles as the stall watchdog: a
    wedged replica that answers nothing for the whole deadline is
    reported to the router as down."""

    def __init__(self, endpoint, timeout=2.0, retry=None):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = float(timeout)
        self._retry = retry
        self._sock = None

    def _connect(self):
        import socket
        s = socket.create_connection(self._addr, timeout=self._timeout)
        s.settimeout(self._timeout)
        self._sock = s
        if _trace._TRACER is not None:
            _trace.annotate(endpoint="%s:%d" % self._addr)

    def _drop_conn(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, what, body):
        trc = _trace._TRACER
        if trc is None:
            return self._call_inner(what, body)
        with trc.span(what, endpoint="%s:%d" % self._addr):
            return self._call_inner(what, body)

    def _call_inner(self, what, body):
        if self._retry is None:
            if self._sock is None:
                self._connect()
            return body()

        def attempt():
            if self._sock is None:
                self._connect()
                _monrt.on_reconnect("fleet")
                _trace.annotate(reconnected=True)
            return body()

        return self._retry.run(
            attempt, what=what, retry_on=RETRYABLE,
            on_retry=lambda a, e: self._drop_conn())

    def submit(self, rid, prompt, max_new, sampling=None,
               features=None, version_pin=None):
        def body():
            if features is not None:
                # scoring payload (serving.sparse ScoringEngine)
                wire = {"features": features}
                if version_pin is not None:
                    wire["version_pin"] = version_pin
            else:
                wire = {"prompt": [int(t) for t in prompt],
                        "max_new": int(max_new)}
                if sampling is not None:
                    wire["sampling"] = sampling
            _send_msg(self._sock, "SUBM", rid, json.dumps(wire).encode())
            op, _, payload = _recv_msg(self._sock)
            if op == "BADR":
                # typed rejection: not retryable — the request itself
                # is invalid for the model, on any replica
                raise ValueError("replica rejected %s: %s"
                                 % (rid, bytes(payload).decode()))
            if op == "DRNG":
                # typed drain NACK: healthy replica, closed admissions
                # — the router re-dispatches elsewhere (no retry here:
                # this endpoint will keep refusing)
                raise ReplicaDraining(rid)
            if op != "OK":
                raise ConnectionError("SUBM reply %s" % op)
        return self._call("fleet.subm", body)

    def poll(self, wait=0.0, max_results=16):
        """Finished-but-unacked results: list of ``{"id", "tokens",
        "score"}`` (or ``{"id", "error"}``) dicts, possibly empty."""
        def body():
            # the reply legitimately takes up to `wait` (server-side
            # long-poll) + handling; widen the recv window for this
            # call only
            self._sock.settimeout(self._timeout + wait)
            try:
                _send_msg(self._sock, "POLL", "", json.dumps(
                    {"wait": wait, "max": max_results}).encode())
                op, _, payload = _recv_msg(self._sock)
            finally:
                if self._sock is not None:
                    try:
                        self._sock.settimeout(self._timeout)
                    except OSError:
                        pass
            if op != "VAL":
                raise ConnectionError("POLL reply %s" % op)
            return json.loads(bytes(payload).decode())["done"]
        return self._call("fleet.poll", body)

    def cancel(self, rids):
        """Ack one rid or a batch (sequence) in a single round trip."""
        wire = rids if isinstance(rids, str) else ",".join(rids)

        def body():
            _send_msg(self._sock, "CANC", wire)
            op, _, _ = _recv_msg(self._sock)
            if op != "OK":
                raise ConnectionError("CANC reply %s" % op)
        return self._call("fleet.canc", body)

    def stat(self):
        def body():
            _send_msg(self._sock, "STAT")
            op, _, payload = _recv_msg(self._sock)
            if op != "VAL":
                raise ConnectionError("STAT reply %s" % op)
            return json.loads(bytes(payload).decode())
        return self._call("fleet.stat", body)

    def close(self):
        self._drop_conn()


class FleetRequest:
    """Router-side result handle (the fleet analog of serving.Request):
    ``result()`` blocks until a replica's result is delivered exactly
    once, or the request fails terminally (Overloaded is raised at
    submit time instead — shed requests never get a handle)."""

    __slots__ = ("rid", "prompt", "max_new", "session", "sampling",
                 "features", "versions", "tokens", "score",
                 "resubmits", "t_submit", "t_done", "_event", "_error")

    def __init__(self, rid, prompt, max_new, session=None,
                 sampling=None, features=None):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.session = session
        self.sampling = sampling
        self.features = features   # scoring payload (serving.sparse)
        self.versions = None       # served cache version (scoring)
        self.tokens = None
        self.score = None
        self.resubmits = 0
        self.t_submit = time.perf_counter()
        self.t_done = None
        self._event = threading.Event()
        self._error = None

    def done(self):
        return self._event.is_set()

    def latency(self):
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                "fleet request %s not finished within %r s"
                % (self.rid, timeout))
        if self._error is not None:
            raise RuntimeError("fleet request %s failed: %r"
                               % (self.rid, self._error))
        return list(self.tokens), self.score


def choose_replica(loads, window, session=None, affinity=None):
    """PURE dispatch decision (the table-driven-test surface).

    loads:    {replica_slot: current in-flight count} for LIVE replicas
    window:   bounded per-replica in-flight cap (backpressure)
    session:  optional affinity key; affinity: {session: slot}

    Returns the chosen slot, or None when every replica is at its
    window (the request stays queued router-side). Session affinity
    wins while its replica is live and under the window; otherwise
    least-loaded, ties broken by the LOWEST slot index (deterministic)."""
    if session is not None and affinity is not None:
        slot = affinity.get(session)
        if slot in loads and loads[slot] < window:
            return slot
    cands = [(load, slot) for slot, load in loads.items()
             if load < window]
    if not cands:
        return None
    return min(cands)[1]


_QUEUED, _INFLIGHT, _DONE, _FAILED = "queued", "inflight", "done", \
    "failed"


def _strip_marks(val):
    """Strip lease-value marks: ``draining:``/``version:<ver>:`` ->
    (version | None, endpoint)."""
    ver = None
    if val.startswith(DRAINING_PREFIX):
        val = val[len(DRAINING_PREFIX):]
    if val.startswith(VERSION_PREFIX):
        ver, val = val[len(VERSION_PREFIX):].split(":", 1)
    return ver, val

# Completed/failed journal entries are retained this long for
# late-duplicate dedup (the slow-replica window), then pruned — the
# router journal must not grow with total traffic served. Session
# affinity is an LRU capped at _AFFINITY_MAX keys.
_JOURNAL_KEEP_S = 300.0
_JOURNAL_SWEEP_EVERY = 256
_AFFINITY_MAX = 8192


class Router:
    """The fleet front door: resolves live replicas from the lease
    registry, dispatches least-loaded with session affinity under a
    bounded per-replica window, journals accepted requests, and
    re-submits unfinished work to a survivor on replica lease expiry /
    stall eviction / verb failure — deduped by durable id, so
    completion is exactly-once (module docstring has the full
    contract)."""

    def __init__(self, kv_endpoint, role=REPLICA_ROLE, retry=None,
                 window=None, max_queue=None, stall_timeout=None,
                 poll_wait=0.2, refresh_interval=0.1, name="router",
                 max_attempts=5, client_timeout=1.0):
        self.name = name
        self.role = role
        self._window = int(window if window is not None
                           else _flag("serving_fleet_window", 8))
        self._max_queue = int(max_queue if max_queue is not None
                              else _flag("serving_fleet_queue", 64))
        self._stall_timeout = float(
            stall_timeout if stall_timeout is not None
            else _flag("serving_fleet_stall_timeout", 2.0))
        self._poll_wait = float(poll_wait)
        self._refresh = float(refresh_interval)
        self._client_timeout = float(client_timeout)
        self._max_attempts = int(max_attempts)
        # verbs run under a deadline-governed policy: the deadline IS
        # the stall watchdog threshold — a replica that answers nothing
        # for the whole budget is evicted, while transient frame faults
        # (drops/tears under an armed plan) are retried away inside it
        self._retry = retry if retry is not None else Policy(
            max_attempts=100, base_delay=0.02, max_delay=0.25,
            deadline=self._stall_timeout, seed=7)
        self._kv = KVClient(kv_endpoint)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._journal = {}       # rid -> entry dict
        self._queue = collections.deque()    # rids awaiting dispatch
        self._replicas = {}      # slot -> {"endpoint","client"}
        self._inflight = {}      # slot -> set(rid)
        self._draining = set()   # slots closed to NEW dispatch (polled
        #                          for in-flight results until retired)
        self._affinity = collections.OrderedDict()  # session -> slot
        self._seq = itertools.count()
        self._submits_since_sweep = 0
        self._id = uuid.uuid4().hex[:8]
        self._stop = threading.Event()
        self._closed = False
        # canary analysis plane: one armed mirror at a time
        # — {"mode": "shadow"|"canary", "version", "fraction"}.
        # Shadow duplicates a sampled fraction to candidate slots
        # (scored, never served); canary routes the sampled fraction
        # there FOR REAL. Candidate slots live in self._replicas under
        # _CAND_BASE-offset keys; shadow copies are tracked in their
        # own inflight map (never the journal's) so a dropped mirror
        # can never requeue into the serving path.
        self._mirror = None
        self._cand_versions = {}     # offset slot -> artifact version
        self._mirror_queue = collections.deque()  # rids to duplicate
        self._mirror_inflight = {}   # offset slot -> set(rid)
        self._mirror_jobs = {}       # rid -> {"t0","inc","cand","version"}
        self._mirror_timeout = max(30.0, 10 * self._stall_timeout)
        # instance counters (authoritative for tests; the global
        # ptpu_fleet_* metrics mirror them)
        self.stats = {"requests": 0, "completed": 0, "shed": 0,
                      "resubmissions": 0, "duplicates": 0,
                      "evictions": {}, "failed": 0, "drain_nacks": 0,
                      "mirrored": 0, "mirror_pairs": 0,
                      "mirror_dropped": 0, "canary": 0,
                      "canary_served": 0}
        self._threads = [
            threading.Thread(target=self._registry_loop, daemon=True,
                             name="ptpu-%s-registry" % name),
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="ptpu-%s-dispatch" % name),
            threading.Thread(target=self._mirror_loop, daemon=True,
                             name="ptpu-%s-mirror" % name),
        ]
        self._pollers = {}       # slot -> thread
        for t in self._threads:
            t.start()

    # -- public API --------------------------------------------------------
    def submit(self, prompt=None, max_new_tokens=None, session=None,
               sampling=None, features=None, version_pin=None):
        """Accept one request (returns its FleetRequest handle), or
        fast-fail with the typed ``Overloaded`` error once the global
        queue bound is hit — shed requests are counted against the SLO
        error budget and never journaled. ``sampling``: per-request
        ``SamplingParams`` (or its dict form); journaled with the
        request, so an at-least-once re-dispatch to a survivor replica
        re-executes with the SAME params + seed — deterministic
        counter-keyed sampling keeps the exactly-once dedup valid for
        stochastic traffic too.

        ``features`` (serving.sparse): a SCORING payload instead of a
        decode one — dict of field -> ragged id list for a replica
        fronting a ``ScoringEngine``. Journaled + resubmitted exactly
        like decode work (scoring is deterministic at a pinned cache
        version, so re-execution composes with the dedup); the score
        arrives on the handle's ``score`` with empty ``tokens``, the
        served cache version on ``versions``."""
        if features is not None:
            prompt, max_new = [], 0
            if isinstance(features, dict):
                # normalize to wire-safe plain types ONCE at the front
                # door (numpy ints/arrays in id lists would otherwise
                # die inside dispatch's json.dumps with an opaque
                # terminal error a direct ScoringEngine accepts fine)
                features = json.loads(json.dumps(
                    features,
                    default=lambda o: o.tolist()
                    if hasattr(o, "tolist") else repr(o)))
        else:
            prompt = [int(t) for t in prompt]
            max_new = int(max_new_tokens)
        if sampling is not None and not isinstance(sampling, dict):
            sampling = sampling.to_dict()      # SamplingParams → wire
        with self._cv:
            if self._closed:
                raise RuntimeError("router is closed")
            queued = len(self._queue)
            if queued >= self._max_queue:
                self.stats["shed"] += 1
                FLEET_SHED.inc(router=self.name)
                err = Overloaded(queued, self._max_queue)
                # the SLO error budget counts shed requests: a
                # serving_request row with the error lands under the
                # router's label (no engine ever saw the request, so
                # this cannot double-count)
                _monrt.on_serving_request(
                    engine=self.name, tokens=0,
                    prompt_len=len(prompt), error=repr(err))
                raise err
            self._submits_since_sweep += 1
            if self._submits_since_sweep >= _JOURNAL_SWEEP_EVERY:
                self._submits_since_sweep = 0
                self._sweep_journal_locked()
            rid = "%s-%06d" % (self._id, next(self._seq))
            handle = FleetRequest(rid, prompt, max_new, session=session,
                                  sampling=sampling, features=features)
            self._journal[rid] = {
                "rid": rid, "prompt": prompt, "max_new": max_new,
                "session": session, "sampling": sampling,
                "features": features, "version_pin": version_pin,
                "state": _QUEUED, "replica": None,
                "attempts": 0, "handle": handle,
            }
            mir = self._mirror
            if mir is not None and features is None \
                    and self._sampled(rid, mir["fraction"]):
                if mir["mode"] == "shadow":
                    # duplicate to a candidate, off the serving path:
                    # the copy is scored against the incumbent's
                    # result and joined by rid, never delivered
                    self._mirror_jobs[rid] = {
                        "t0": time.monotonic(), "inc": None,
                        "cand": None, "version": mir["version"]}
                    self._mirror_queue.append(rid)
                    self.stats["mirrored"] += 1
                    FLEET_MIRRORED.inc(router=self.name)
                else:
                    # canary split: dispatch prefers candidate slots
                    # for this rid (incumbent fallback — the split
                    # must never strand or shed work)
                    self._journal[rid]["canary"] = True
                    self.stats["canary"] += 1
                    FLEET_CANARY.inc(router=self.name)
            self._queue.append(rid)
            self.stats["requests"] += 1
            FLEET_REQUESTS.inc(router=self.name)
            FLEET_QUEUE_DEPTH.set(len(self._queue), router=self.name)
            self._cv.notify_all()
        return handle

    def generate_many(self, prompts, max_new_tokens, session=None,
                      sampling=None, timeout=300.0):
        """Synchronous convenience mirroring Engine.generate_many:
        submit every prompt, block for all results in input order.
        ``sampling`` applies to every prompt (one params dict)."""
        n = len(prompts)
        if not hasattr(max_new_tokens, "__len__"):
            max_new_tokens = [max_new_tokens] * n
        handles = [self.submit(p, m, session=session,
                               sampling=sampling)
                   for p, m in zip(prompts, max_new_tokens)]
        return [h.result(timeout=timeout) for h in handles]

    def replicas(self):
        """Live replica map {slot: endpoint} as the router sees it
        (draining slots included — they still serve POLL/CANC)."""
        with self._lock:
            return {s: r["endpoint"] for s, r in self._replicas.items()}

    def draining(self):
        """Slots currently closed to new dispatch (drain mark seen in
        the registry, or a DRNG NACK received ahead of it)."""
        with self._lock:
            return set(self._draining)

    # -- canary analysis plane ----------------------------------
    @staticmethod
    def _sampled(rid, fraction):
        """Deterministic per-request sampling decision, keyed on the
        durable rid — a resubmitted id samples identically, and a
        replayed log reproduces the same mirror population."""
        if fraction >= 1.0:
            return True
        if fraction <= 0.0:
            return False
        return (zlib.crc32(rid.encode()) & 0xffff) / 65536.0 < fraction

    def arm_shadow(self, version, fraction=None):
        """Arm SHADOW mirroring: a deterministic ``fraction`` sample of
        accepted decode requests is duplicated to candidate replicas
        (role ``candidate``) — scored against the incumbent's served
        result, joined by rid into ``mirror_pair`` rows, never served,
        never counted in the incumbent's SLO histograms."""
        frac = float(fraction if fraction is not None
                     else _flag("serving_mirror_fraction", 0.25))
        with self._cv:
            self._mirror = {"mode": "shadow", "version": str(version),
                            "fraction": frac}
            self._cv.notify_all()

    def arm_canary(self, version, weight=None):
        """Arm the CANARY split: the sampled ``weight`` fraction of
        accepted requests is served FOR REAL by candidate replicas
        (version stamped on row/span/lease); everything else stays on
        incumbents. Candidates at their window — or dead — fall back
        to incumbents: the split can shift load but never shed."""
        frac = float(weight if weight is not None
                     else _flag("serving_canary_weight", 0.1))
        with self._cv:
            self._mirror = {"mode": "canary", "version": str(version),
                            "fraction": frac}
            self._cv.notify_all()

    def disarm_mirror(self):
        """Return to single-version routing: stop sampling, abandon
        pending shadow work (best-effort by contract), and evict
        candidate slots from dispatch — their unfinished CANARY
        requests resubmit to incumbents, so exactly-once completion
        holds through a rollback."""
        with self._cv:
            self._mirror = None
            self._mirror_queue.clear()
            dropped = len(self._mirror_jobs)
            self._mirror_jobs.clear()
            if dropped:
                self.stats["mirror_dropped"] += dropped
                FLEET_MIRROR_DROPPED.inc(dropped, router=self.name)
            cands = [(s, self._replicas[s]["endpoint"])
                     for s in self._replicas if s >= _CAND_BASE]
            self._cv.notify_all()
        for slot, ep in cands:
            self._replica_down(slot, ep, "mirror_disarmed")

    def mirror_status(self):
        """Live mirror snapshot: mode/version/fraction, resolved
        candidate slots (un-offset), and the pair/drop ledger."""
        with self._lock:
            return {
                "mirror": dict(self._mirror) if self._mirror else None,
                "candidates": {
                    s - _CAND_BASE: self._replicas[s]["endpoint"]
                    for s in self._replicas if s >= _CAND_BASE},
                "versions": {s - _CAND_BASE: v for s, v
                             in self._cand_versions.items()},
                "pending": len(self._mirror_queue)
                + sum(1 for j in self._mirror_jobs.values()
                      if j["cand"] is None),
                "pairs": self.stats["mirror_pairs"],
                "dropped": self.stats["mirror_dropped"],
            }

    def wait_for_candidates(self, n, timeout=30.0):
        """Block until >= n candidate replicas are resolved and
        dispatchable (mirror must be armed — resolution is gated on
        it)."""
        deadline = time.time() + timeout
        while True:
            with self._lock:
                have = sum(1 for s in self._replicas
                           if s >= _CAND_BASE
                           and s not in self._draining)
            if have >= n:
                return have
            if time.time() >= deadline:
                raise TimeoutError(
                    "router resolved %d of %d candidates" % (have, n))
            time.sleep(0.02)

    def wait_for_replicas(self, n, timeout=30.0):
        """Block until the router has resolved >= n live replicas."""
        deadline = time.time() + timeout
        while True:
            reps = self.replicas()
            if len(reps) >= n:
                return reps
            if time.time() >= deadline:
                raise TimeoutError(
                    "router resolved %d of %d replicas"
                    % (len(reps), n))
            time.sleep(0.02)

    def close(self):
        """Stop the router. Journaled requests not yet completed fail
        (their ``result()`` raises)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._stop.set()
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        for t in list(self._pollers.values()):
            t.join(timeout=5)
        with self._lock:
            pending = [e for e in self._journal.values()
                       if e["state"] in (_QUEUED, _INFLIGHT)]
            replicas = list(self._replicas.values())
            self._replicas = {}
            self._queue.clear()
            FLEET_QUEUE_DEPTH.set(0, router=self.name)
        for e in pending:
            self._fail_entry(e, RuntimeError("router closed"))
        for r in replicas:
            r["client"].close()
        self._kv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- journal state transitions (always under self._lock) ---------------
    def _sweep_journal_locked(self):
        """Amortized retention sweep (every _JOURNAL_SWEEP_EVERY
        submits): drop terminal entries past the late-duplicate dedup
        window — a pruned id's eventual late result is acked as
        unknown. The caller-owned FleetRequest handle is unaffected."""
        cutoff = time.perf_counter() - _JOURNAL_KEEP_S
        dead = [rid for rid, e in self._journal.items()
                if e["state"] in (_DONE, _FAILED)
                and e["handle"].t_done is not None
                and e["handle"].t_done < cutoff]
        for rid in dead:
            del self._journal[rid]

    def _fail_entry(self, entry, err):
        entry["state"] = _FAILED
        self.stats["failed"] += 1
        if self._mirror_jobs.pop(entry["rid"], None) is not None:
            # no served result, no pair: the mirror copy is abandoned
            # (best-effort by contract)
            self.stats["mirror_dropped"] += 1
            FLEET_MIRROR_DROPPED.inc(router=self.name)
        h = entry["handle"]
        if h.t_done is None:
            h.t_done = time.perf_counter()
        h._error = err
        h._event.set()

    def _complete(self, slot, res):
        """One delivered result (poller thread). Returns True when the
        result should be ACKED to the delivering replica (always —
        even a duplicate: the replica may forget it either way)."""
        rid = res.get("id")
        with self._cv:
            if slot >= _CAND_BASE and rid in self._mirror_jobs:
                # SHADOW copy's result from a candidate: never
                # delivered — stash it and try the join. (A canary
                # result from a candidate slot is NOT in _mirror_jobs
                # and falls through to the normal path below.)
                self._mirror_inflight.get(slot, set()).discard(rid)
                self._mirror_jobs[rid]["cand"] = res
                self._try_join_locked(rid)
                return True
            entry = self._journal.get(rid)
            if entry is None:
                return True              # unknown id (pruned/foreign)
            if slot >= _CAND_BASE and not entry.get("canary"):
                # LATE SHADOW result whose mirror job was already
                # dropped (disarm, sweep timeout, or candidate
                # eviction — the poller drains for a grace window
                # past all three): ack and drop. Only canary-marked
                # entries may ever be completed by a candidate slot;
                # anything else would serve candidate-generated
                # tokens from an unvetted artifact — a rolled-back
                # rollout must have served ZERO candidate-only tokens.
                self.stats["mirror_dropped"] += 1
                FLEET_MIRROR_DROPPED.inc(router=self.name)
                return True
            if "error" in res:
                # replica-side failure (its engine died mid-request):
                # at-least-once dispatch handles it — requeue for a
                # survivor, but ONLY when the error comes from the
                # replica the entry is currently in flight on. A late
                # error from an evicted replica whose work was already
                # resubmitted must not yank the survivor's copy back
                # onto the queue (double decode / spurious attempts).
                if entry["state"] == _INFLIGHT \
                        and entry["replica"] == slot:
                    self._requeue_locked(entry, "replica error %s"
                                         % res["error"])
                return True
            if entry["state"] in (_DONE, _FAILED):
                # the exactly-once heart: a slow-but-alive replica's
                # late result for an id a survivor already completed
                # is DEDUPED here, never delivered twice — and a late
                # success for a TERMINALLY FAILED entry must not
                # resurrect it (its result() already raised)
                self.stats["duplicates"] += 1
                FLEET_DUPLICATES.inc(router=self.name)
                return True
            cur = entry["replica"]
            if cur is not None:
                self._inflight.get(cur, set()).discard(rid)
            entry["state"] = _DONE
            self.stats["completed"] += 1
            if cur is not None and cur >= _CAND_BASE:
                # canary-served for real by a candidate (the forced-
                # FAIL gate asserts this stays 0 when a rollout never
                # reaches the canary phase)
                self.stats["canary_served"] += 1
            h = entry["handle"]
            h.tokens = list(res["tokens"])
            h.score = res["score"]
            if res.get("versions") is not None:
                h.versions = res["versions"]   # scoring cache version
            h.resubmits = max(0, entry["attempts"] - 1)
            h.t_done = time.perf_counter()
            h._event.set()
            job = self._mirror_jobs.get(rid)
            if job is not None:
                # incumbent side of a shadow pair: stash the SERVED
                # tokens for the join (order-independent with the
                # candidate's result)
                job["inc"] = {"tokens": list(h.tokens)}
                self._try_join_locked(rid)
            self._cv.notify_all()        # capacity freed
        return True

    def _try_join_locked(self, rid):
        """Join one shadow pair (under the lock): once BOTH the
        incumbent's served tokens and the candidate's scored result
        are stashed, score agreement (exact token equality) and match
        (common-prefix fraction) and emit the ``mirror_pair`` row the
        token-agreement delta objective samples. A candidate-side
        error joins as a disagreeing pair carrying the error — the
        error-rate delta's evidence."""
        job = self._mirror_jobs.get(rid)
        if job is None or job["inc"] is None or job["cand"] is None:
            return
        del self._mirror_jobs[rid]
        inc_toks = job["inc"]["tokens"]
        cand = job["cand"]
        cerr = cand.get("error")
        if cerr is None:
            ctoks = list(cand.get("tokens") or ())
            agree = ctoks == inc_toks
            k = 0
            for a, b in zip(ctoks, inc_toks):
                if a != b:
                    break
                k += 1
            match = k / max(len(ctoks), len(inc_toks), 1)
        else:
            agree, match = False, 0.0
        self.stats["mirror_pairs"] += 1
        _monrt.on_mirror_pair(job["version"], rid, agree, match,
                              router=self.name, candidate_error=cerr)

    def _requeue_locked(self, entry, why):
        """Under the lock: put an unfinished entry back on the dispatch
        queue (resubmission) — or fail it when its attempt budget is
        spent (a request that somehow kills every replica it touches
        must not ping-pong forever)."""
        rid = entry["rid"]
        cur = entry["replica"]
        if cur is not None:
            self._inflight.get(cur, set()).discard(rid)
        entry["replica"] = None
        if entry["attempts"] >= self._max_attempts:
            self._fail_entry(entry, RuntimeError(
                "request %s exhausted %d attempts (last: %s)"
                % (rid, entry["attempts"], why)))
            return
        entry["state"] = _QUEUED
        self._queue.appendleft(rid)
        self.stats["resubmissions"] += 1
        FLEET_RESUBMISSIONS.inc(router=self.name)
        FLEET_QUEUE_DEPTH.set(len(self._queue), router=self.name)
        self._cv.notify_all()

    # -- replica lifecycle -------------------------------------------------
    def _add_replica(self, slot, endpoint):
        with self._lock:
            if self._closed or slot in self._replicas:
                return
            self._replicas[slot] = {
                "endpoint": endpoint,
                "client": ReplicaClient(endpoint,
                                        timeout=self._client_timeout,
                                        retry=self._retry),
            }
            self._inflight.setdefault(slot, set())
            # a fresh incarnation starts dispatchable — the drain mark
            # belonged to the slot's PREVIOUS holder
            self._draining.discard(slot)
            self._cv.notify_all()
        t = threading.Thread(
            target=self._poller_loop, args=(slot, endpoint),
            daemon=True, name="ptpu-%s-poll-%d" % (self.name, slot))
        self._pollers[slot] = t
        t.start()

    def _replica_down(self, slot, endpoint, reason):
        """Evict a replica from dispatch and RESUBMIT its unfinished
        journal entries to the survivors. Idempotent per (slot,
        endpoint) incarnation. For a stall (live-but-wedged holder) the
        registry slot is tombstoned so the supervisor respawns it and
        the wedged holder's expect-guarded lease keepalive loses."""
        with self._cv:
            info = self._replicas.get(slot)
            if info is None or info["endpoint"] != endpoint:
                return False             # already handled / replaced
            del self._replicas[slot]
            self._draining.discard(slot)
            self._cand_versions.pop(slot, None)
            rids = self._inflight.pop(slot, set())
            for rid in list(rids):
                entry = self._journal.get(rid)
                if entry is not None and entry["state"] == _INFLIGHT:
                    self._requeue_locked(entry, "replica %d %s"
                                         % (slot, reason))
            # shadow copies on a dead candidate are DROPPED, never
            # requeued — the mirror is best-effort and must not feed
            # work back into the serving path
            for rid in self._mirror_inflight.pop(slot, ()):
                if self._mirror_jobs.pop(rid, None) is not None:
                    self.stats["mirror_dropped"] += 1
                    FLEET_MIRROR_DROPPED.inc(router=self.name)
            for sess in [s for s, r in self._affinity.items()
                         if r == slot]:
                del self._affinity[sess]
            self.stats["evictions"][reason] = \
                self.stats["evictions"].get(reason, 0) + 1
            FLEET_EVICTIONS.inc(reason=reason)
        info["client"].close()
        if reason == "mirror_disarmed":
            # disarm eviction is ROUTER-LOCAL bookkeeping: the
            # candidate cell is healthy and its lease must survive —
            # the shadow->canary flip (and a later rollout) re-resolves
            # the same holders when the mirror re-arms. Tombstoning
            # here would make the live holder's keepalive lose and
            # turn every flip into a reap-and-respawn cycle.
            return True
        if slot >= _CAND_BASE:
            key = (_membership.role_prefix(CANDIDATE_ROLE)
                   + str(slot - _CAND_BASE))
        else:
            key = _membership.role_prefix(self.role) + str(slot)
        try:
            # tombstone (never delete): see EVICTED_PREFIX. The live
            # value may carry marks — candidates boot as
            # ``version:<ver>:<ep>``, drains re-mark ``draining:<ep>``
            # — so CAS against what the registry ACTUALLY holds; a
            # bare-endpoint expect would never match a marked lease,
            # the wedged holder's expect-guarded keepalive would keep
            # winning, and stall recovery would degrade into evict /
            # re-add churn instead of a supervisor respawn. A dead
            # holder's key may already be gone (get -> None) or the
            # value may have moved between get and CAS — the CAS just
            # fails; tombstoning is best-effort either way.
            cur = self._kv.get(key)
            if cur is not None \
                    and not cur.startswith(EVICTED_PREFIX) \
                    and _strip_marks(cur)[1] == endpoint:
                self._kv.cas(key, cur, EVICTED_PREFIX + endpoint,
                             ttl=max(10.0, 4 * self._stall_timeout))
        except RETRYABLE:
            pass
        return True

    # -- loops -------------------------------------------------------------
    def _registry_loop(self):
        while not self._stop.wait(self._refresh):
            try:
                raw = _membership.live_endpoints(self._kv, self.role)
            except RETRYABLE:
                continue
            live, marked, versions = {}, set(), {}
            for slot, ep in raw.items():
                if ep.startswith(EVICTED_PREFIX):
                    continue
                if ep.startswith(DRAINING_PREFIX):
                    # drain-marked lease: STILL LIVE (the poller keeps
                    # draining in-flight results) but closed to new
                    # dispatch; strip the mark to recover the endpoint
                    ep = ep[len(DRAINING_PREFIX):]
                    marked.add(slot)
                live[slot] = ep
            if self._mirror is not None:
                # mirror armed: additionally resolve CANDIDATE leases
                # under offset keys — same eviction / drain / poller
                # machinery, separate role registry. Disarmed, the
                # role is never read and any lingering candidate slots
                # fall out of `live` -> evicted below.
                try:
                    rawc = _membership.live_endpoints(self._kv,
                                                     CANDIDATE_ROLE)
                except RETRYABLE:
                    rawc = {}
                for slot, val in rawc.items():
                    if val.startswith(EVICTED_PREFIX):
                        continue
                    drain = val.startswith(DRAINING_PREFIX)
                    ver, ep = _strip_marks(val)
                    slot += _CAND_BASE
                    if drain:
                        marked.add(slot)
                    if ver is not None:
                        versions[slot] = ver
                    live[slot] = ep
            with self._lock:
                known = {s: r["endpoint"]
                         for s, r in self._replicas.items()}
                # a drain mark is terminal for the incarnation: union
                # new marks (a DRNG NACK may have added one ahead of
                # the registry), drop slots that left the registry
                self._draining |= marked
                self._draining &= set(live)
                self._cand_versions.update(versions)
            for slot, ep in known.items():
                if live.get(slot) != ep:
                    # lease expired (dead) or a replacement claimed the
                    # slot at a new endpoint
                    self._replica_down(slot, ep, "lease_expired")
            for slot, ep in live.items():
                if known.get(slot) != ep:
                    self._add_replica(slot, ep)
            with self._lock:
                # incumbents only: candidate capacity must not inflate
                # the fleet-size gauge the autoscaler converges on
                FLEET_REPLICAS.set(
                    sum(1 for s in self._replicas if s < _CAND_BASE),
                    router=self.name)

    def _dispatch_loop(self):
        while True:
            with self._cv:
                rid = slot = None
                while not self._stop.is_set():
                    # drop stale heads: an entry a slow replica's late
                    # result completed WHILE it sat requeued must not
                    # be re-executed (its state already left _QUEUED)
                    dropped = False
                    while self._queue and self._journal[
                            self._queue[0]]["state"] != _QUEUED:
                        self._queue.popleft()
                        dropped = True
                    if dropped:
                        # every queue mutation updates the gauge — a
                        # queue drained entirely by stale-head drops
                        # must not leave a phantom depth pinning the
                        # signals queue alert (and blocking its
                        # scale-down hint) forever
                        FLEET_QUEUE_DEPTH.set(len(self._queue),
                                              router=self.name)
                    if self._queue:
                        # draining slots are NOT dispatch candidates
                        # (they'd NACK); they still serve POLL/CANC
                        loads = {s: len(self._inflight.get(s, ()))
                                 for s in self._replicas
                                 if s not in self._draining}
                        entry = self._journal[self._queue[0]]
                        if entry.get("canary") \
                                and entry["attempts"] == 0:
                            # canary-sampled, first attempt: prefer
                            # candidate slots; fall back to incumbents
                            # when none are live/under-window (the
                            # split must never shed or strand work).
                            # A RESUBMISSION may land anywhere —
                            # exactly-once completion outranks the
                            # split after a candidate death.
                            cand = {s: l for s, l in loads.items()
                                    if s >= _CAND_BASE}
                            if cand and any(l < self._window
                                            for l in cand.values()):
                                loads = cand
                        elif not entry.get("canary"):
                            # candidates never serve unsampled traffic
                            loads = {s: l for s, l in loads.items()
                                     if s < _CAND_BASE}
                        slot = choose_replica(
                            loads, self._window,
                            session=entry["session"],
                            affinity=self._affinity)
                        if slot is not None:
                            rid = self._queue.popleft()
                            FLEET_QUEUE_DEPTH.set(
                                len(self._queue), router=self.name)
                            break
                    self._cv.wait(timeout=0.25)
                if rid is None:
                    return               # stopping
                entry = self._journal[rid]
                entry["state"] = _INFLIGHT
                entry["replica"] = slot
                entry["attempts"] += 1
                self._inflight[slot].add(rid)
                if entry["session"] is not None:
                    self._affinity[entry["session"]] = slot
                    self._affinity.move_to_end(entry["session"])
                    while len(self._affinity) > _AFFINITY_MAX:
                        self._affinity.popitem(last=False)
                info = self._replicas[slot]
            # wire work OUTSIDE the lock; the dispatch span carries
            # rid/slot/endpoint — a resubmitted id shows N dispatch
            # spans with different endpoints (the resubmission hop)
            attrs = {}
            if slot >= _CAND_BASE:
                # canary dispatch: the candidate's artifact version on
                # the span (the row carries it via the engine)
                attrs["version"] = self._cand_versions.get(slot)
            try:
                with _trace.span("router.dispatch", rid=rid, slot=slot,
                                 endpoint=info["endpoint"],
                                 attempt=entry["attempts"], **attrs):
                    info["client"].submit(
                        rid, entry["prompt"], entry["max_new"],
                        entry.get("sampling"),
                        features=entry.get("features"),
                        version_pin=entry.get("version_pin"))
            except RETRYABLE:
                self._replica_down(slot, info["endpoint"], "dispatch")
            except ReplicaDraining:
                # typed drain NACK: the replica is healthy but closed
                # to admissions (we raced its drain mark). Requeue
                # WITHOUT burning the attempt budget — admission was
                # refused, not tried — and stop dispatching to the
                # slot even before the lease mark propagates.
                with self._cv:
                    self._draining.add(slot)
                    e2 = self._journal.get(rid)
                    if e2 is not None and e2["state"] == _INFLIGHT \
                            and e2["replica"] == slot:
                        self._inflight.get(slot, set()).discard(rid)
                        e2["replica"] = None
                        e2["attempts"] -= 1
                        e2["state"] = _QUEUED
                        self._queue.appendleft(rid)
                        self.stats["drain_nacks"] += 1
                        FLEET_QUEUE_DEPTH.set(len(self._queue),
                                              router=self.name)
                        self._cv.notify_all()
            except Exception as e:
                # typed rejection (BADR) or another terminal error:
                # fail THIS request, not the replica
                with self._cv:
                    e2 = self._journal.get(rid)
                    if e2 is not None and e2["state"] == _INFLIGHT:
                        self._inflight.get(slot, set()).discard(rid)
                        self._fail_entry(e2, e)

    def _sweep_mirror_locked(self, now):
        """Drop shadow jobs past the mirror timeout (candidate never
        answered / incumbent result pruned): bounded state, and a
        wedged candidate cannot pin join stashes forever."""
        stale = [rid for rid, j in self._mirror_jobs.items()
                 if now - j["t0"] > self._mirror_timeout]
        for rid in stale:
            del self._mirror_jobs[rid]
            self.stats["mirror_dropped"] += 1
            FLEET_MIRROR_DROPPED.inc(router=self.name)
            for s in self._mirror_inflight.values():
                s.discard(rid)

    def _mirror_loop(self):
        """Dispatch SHADOW duplicates to candidate replicas — its own
        thread with its own clients (ReplicaClient sockets are never
        shared across threads). Best-effort by contract: a failed or
        timed-out duplicate is dropped and counted, never requeued
        into the serving path, and never touches the journal's state
        machine — a broken candidate can cost pairs, not traffic."""
        clients = {}             # offset slot -> (endpoint, client)
        try:
            while True:
                with self._cv:
                    rid = slot = None
                    while not self._stop.is_set():
                        self._sweep_mirror_locked(time.monotonic())
                        if self._mirror_queue:
                            if self._mirror_queue[0] \
                                    not in self._mirror_jobs:
                                # dropped (disarm/timeout/fail): skip
                                self._mirror_queue.popleft()
                                continue
                            loads = {s: len(self._mirror_inflight
                                            .get(s, ()))
                                     for s in self._replicas
                                     if s >= _CAND_BASE
                                     and s not in self._draining}
                            slot = choose_replica(loads, self._window)
                            if slot is not None:
                                rid = self._mirror_queue.popleft()
                                break
                        self._cv.wait(timeout=0.25)
                    if rid is None:
                        return           # stopping
                    entry = self._journal.get(rid)
                    if entry is None:
                        if self._mirror_jobs.pop(rid, None) \
                                is not None:
                            self.stats["mirror_dropped"] += 1
                            FLEET_MIRROR_DROPPED.inc(router=self.name)
                        continue
                    self._mirror_inflight.setdefault(slot,
                                                     set()).add(rid)
                    ep = self._replicas[slot]["endpoint"]
                    ver = self._cand_versions.get(slot)
                    prompt = entry["prompt"]
                    max_new = entry["max_new"]
                    sampling = entry.get("sampling")
                tup = clients.get(slot)
                if tup is None or tup[0] != ep:
                    if tup is not None:
                        tup[1].close()
                    tup = (ep, ReplicaClient(
                        ep, timeout=self._client_timeout,
                        retry=self._retry))
                    clients[slot] = tup
                try:
                    with _trace.span("router.mirror", rid=rid,
                                     slot=slot, endpoint=ep,
                                     version=ver):
                        tup[1].submit(rid, prompt, max_new, sampling)
                except Exception:
                    # candidate unreachable / NACK / reject: drop the
                    # copy (the served request is untouched)
                    tup[1].close()
                    with self._cv:
                        self._mirror_inflight.get(slot,
                                                  set()).discard(rid)
                        if self._mirror_jobs.pop(rid, None) \
                                is not None:
                            self.stats["mirror_dropped"] += 1
                            FLEET_MIRROR_DROPPED.inc(router=self.name)
        finally:
            for _, cl in clients.values():
                cl.close()

    def _poller_loop(self, slot, endpoint):
        """Long-poll one replica for finished results and ack them.
        A poll that fails past the retry deadline reports the replica
        down (stall watchdog). After a STALL eviction the poller keeps
        DRAINING for a grace window: the wedged replica's engine kept
        decoding, and its late results must reach the journal's dedup
        (and be acked) rather than be abandoned mid-socket."""
        client = ReplicaClient(endpoint, timeout=self._client_timeout,
                               retry=self._retry)
        draining_until = None
        try:
            while not self._stop.is_set():
                with self._lock:
                    info = self._replicas.get(slot)
                    live = (info is not None
                            and info["endpoint"] == endpoint)
                if not live and draining_until is None:
                    draining_until = time.monotonic() + max(
                        10.0, 3 * self._stall_timeout)
                if draining_until is not None \
                        and time.monotonic() > draining_until:
                    return
                try:
                    done = client.poll(wait=self._poll_wait)
                except RETRYABLE:
                    if live:
                        # nothing answered for the whole retry
                        # deadline. Registry still listing the
                        # endpoint = live-but-wedged holder (stall
                        # watchdog eviction); gone = plain death.
                        reason = "stall"
                        try:
                            if slot >= _CAND_BASE:
                                val = _membership.live_endpoints(
                                    self._kv, CANDIDATE_ROLE
                                    ).get(slot - _CAND_BASE)
                                if val is None or \
                                        _strip_marks(val)[1] \
                                        != endpoint:
                                    reason = "dead"
                            elif _membership.live_endpoints(
                                    self._kv, self.role
                                    ).get(slot) != endpoint:
                                reason = "dead"
                        except RETRYABLE:
                            pass
                        self._replica_down(slot, endpoint, reason)
                        draining_until = time.monotonic() + max(
                            10.0, 3 * self._stall_timeout)
                        if reason == "dead":
                            return
                        continue         # drain: the wedge may lift
                    # draining through a still-wedged endpoint: keep
                    # trying until the grace window closes — the late
                    # results behind the wedge are the whole point
                    continue
                if done:
                    for res in done:
                        self._complete(slot, res)
                    try:
                        # one batched ack per delivery round trip
                        client.cancel([res["id"] for res in done])
                    except RETRYABLE:
                        pass             # re-delivered next poll; dedup
        finally:
            client.close()


# -- supervisor -------------------------------------------------------------

class Supervisor:
    """Keeps ``desired`` replicas registered: watches the role registry
    and respawns a cell (via the factory callback) for every slot whose
    lease expired or that the router tombstoned. The factory returns a
    ``Replica`` (it claims the freed slot itself through
    register_endpoint); ``cells`` keeps every incarnation for test
    teardown, ``respawns`` counts replacements."""

    def __init__(self, kv, spawn_fn, desired, role=REPLICA_ROLE,
                 interval=0.1):
        self._kv = kv
        self._spawn = spawn_fn
        self.desired = int(desired)
        self.role = role
        self._interval = float(interval)
        self._stop = threading.Event()
        self.cells = []
        self.respawns = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ptpu-fleet-supervisor")

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)

    def _loop(self):
        prefix = _membership.role_prefix(self.role)
        while not self._stop.wait(self._interval):
            try:
                live = _membership.live_endpoints(self._kv, self.role)
            except RETRYABLE:
                continue
            # free tombstoned slots (compare-and-delete: never remove a
            # slot a fresh holder already re-claimed)
            alive = 0
            for slot, val in live.items():
                if val.startswith(EVICTED_PREFIX):
                    try:
                        self._kv.cad(prefix + str(slot), val)
                    except RETRYABLE:
                        pass
                else:
                    alive += 1
            for _ in range(self.desired - alive):
                if self._stop.is_set():
                    return
                try:
                    cell = self._spawn()
                except Exception:
                    break                # factory failed; retry next tick
                self.cells.append(cell)
                self.respawns += 1
