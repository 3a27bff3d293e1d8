"""Elastic membership: a TTL-lease KV service + pserver/trainer
registration (the etcd tier of the reference's cloud runtime).

The port's copy of ``paddle_tpu/distributed/membership.py`` (pure Python).

Reference parity: go/pserver/etcd_client.go:43-100 — a pserver claims one
of the `desired` index slots with a compare-and-swap under a TTL lease and
keeps the lease alive with heartbeats; trainers rendezvous by watching
until all slots are claimed. go/master/service.go uses the same store for
master state. A dead server's lease expires, freeing its slot for a
replacement, which recovers state from the last checkpoint
(go/pserver/service.go:156-205 LoadCheckpoint).

The store here is a small threaded TCP KV server (same length-prefixed
framing as distributed/rpc.py) — a stand-in for etcd
with the same semantics: PUT/GET/DEL, CAS (create-if-absent or
compare-and-swap), LIST by prefix, per-key TTL refreshed by LEAS.
"""

import json
import socketserver
import threading
import time
import uuid

from .rpc import (_send_msg, _recv_msg, _clock_reply, _metr_reply,
                  _hlth_reply, _dump_reply)
from ..monitor import metrics as _metrics
from ..trace import clock as _clock
from ..trace import runtime as _trace

__all__ = ["KVServer", "KVClient", "register_endpoint",
           "wait_for_endpoints", "live_endpoints", "role_prefix",
           "register_pserver", "wait_for_pservers", "TrainerLease",
           "EVICTED_PREFIX", "DRAINING_PREFIX", "VERSION_PREFIX"]

# Registry-level tombstone protocol: an evictor (serving.fleet's
# Router) CASes a slot's endpoint to "evicted:<ep>" instead of
# deleting it — the wedged holder's expect-guarded keepalive then
# loses (split-brain guard doubling as eviction), the supervisor
# frees the slot with compare-and-delete, and registry READERS (the
# fleet router, monitor.collector discovery) filter these values.
# Lives here because every consumer of the registry shares it.
EVICTED_PREFIX = "evicted:"

# Drain mark: a GRACEFULLY retiring holder re-marks its own lease value
# to "draining:<ep>" (serving.autoscale scale-down / rolling update).
# Unlike EVICTED_PREFIX the lease stays ALIVE and heartbeating — the
# router must keep polling the replica for in-flight results while
# refusing to dispatch NEW work to it, and the collector keeps scraping
# it so the drain is observable. Readers strip the prefix to recover
# the endpoint.
DRAINING_PREFIX = "draining:"

# Version mark (canary rollouts, serving.rollout): a CANDIDATE replica
# re-marks its lease value to "version:<ver>:<ep>" so every registry
# reader sees which artifact version the endpoint serves — the router
# stamps it on canary dispatch spans, `monitor watch` renders the
# version mix. Like DRAINING_PREFIX the lease stays alive; readers
# strip "version:<ver>:" to recover the endpoint.
VERSION_PREFIX = "version:"

_REG = _metrics.registry()
_HEARTBEATS = _REG.counter("ptpu_lease_heartbeats_total",
                           "TTL-lease keepalive beats sent")
_LEASE_RECLAIMS = _REG.counter(
    "ptpu_lease_reclaims_total",
    "expired leases re-claimed by their holder (stall recovered)")
_LEASE_LOST = _REG.counter(
    "ptpu_lease_lost_total",
    "leases lost to a usurper (holder must re-register)")


class KVServer:
    """TTL-lease KV store (etcd stand-in)."""

    def __init__(self, host="127.0.0.1", port=0, sweep_interval=0.1):
        self._data = {}          # key -> (value str, expiry ts | None)
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
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
                            with trc.server_span("kv." + op, tctx,
                                                 op=op, key=name):
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
        self._sweeper = threading.Thread(
            target=self._sweep_loop, args=(sweep_interval,), daemon=True)

    def start(self):
        self._thread.start()
        self._sweeper.start()
        return self

    def stop(self):
        self._shutdown.set()
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()

    # ------------------------------------------------------------------
    def _sweep_loop(self, interval):
        while not self._shutdown.wait(interval):
            now = time.time()
            with self._lock:
                dead = [k for k, (_, exp) in self._data.items()
                        if exp is not None and exp < now]
                for k in dead:
                    del self._data[k]

    def _alive(self, key):
        ent = self._data.get(key)
        if ent is None:
            return None
        if ent[1] is not None and ent[1] < time.time():
            del self._data[key]
            return None
        return ent

    def _dispatch(self, sock, op, name, payload):
        body = json.loads(payload.decode()) if payload else {}
        if op == "PUT":
            ttl = body.get("ttl")
            with self._lock:
                self._data[name] = (body["value"],
                                    time.time() + ttl if ttl else None)
            _send_msg(sock, "OK")
        elif op == "GET":
            with self._lock:
                ent = self._alive(name)
            if ent is None:
                _send_msg(sock, "MISS", name)
            else:
                _send_msg(sock, "VAL", name,
                          json.dumps({"value": ent[0]}).encode())
        elif op == "CAS":
            # old == None → create-if-absent (etcd CompareAndSwap with
            # prevExist=false, etcd_client.go:70). The swap is decided
            # under the lock; the reply is sent after releasing it — a
            # slow reader must not serialize every other KV handler
            # (analysis --runtime, lock-discipline)
            ttl = body.get("ttl")
            with self._lock:
                ent = self._alive(name)
                cur = ent[0] if ent is not None else None
                swapped = cur == body.get("old")
                if swapped:
                    self._data[name] = (
                        body["new"],
                        time.time() + ttl if ttl else None)
            if swapped:
                _send_msg(sock, "OK")
            else:
                _send_msg(sock, "FAIL", name,
                          json.dumps({"value": cur}).encode())
        elif op == "DEL":
            with self._lock:
                self._data.pop(name, None)
            _send_msg(sock, "OK")
        elif op == "CAD":
            # compare-and-delete: remove only while WE still own the key,
            # so a holder that lost its slot cannot delete the new
            # owner's registration (etcd DeleteIfValue semantics)
            with self._lock:
                ent = self._alive(name)
                deleted = ent is not None and ent[0] == body.get("old")
                if deleted:
                    self._data.pop(name, None)
            if deleted:
                _send_msg(sock, "OK")
            else:
                _send_msg(sock, "FAIL", name)
        elif op == "LIST":
            with self._lock:
                now = time.time()
                out = {k: v for k, (v, exp) in self._data.items()
                       if k.startswith(name)
                       and (exp is None or exp >= now)}
            _send_msg(sock, "VAL", name, json.dumps(out).encode())
        elif op == "LEAS":
            # refresh a key's TTL (lease keepalive); with "expect" set,
            # refuse to refresh a key someone ELSE now owns — a stalled
            # holder must not extend the usurper's lease
            ttl = body.get("ttl", 1.0)
            expect = body.get("expect")
            with self._lock:
                ent = self._alive(name)
                usurped = (ent is not None and expect is not None
                           and ent[0] != expect)
                if ent is not None and not usurped:
                    self._data[name] = (ent[0], time.time() + ttl)
            if ent is None:
                _send_msg(sock, "MISS", name)
            elif usurped:
                _send_msg(sock, "FAIL", name,
                          json.dumps({"value": ent[0]}).encode())
            else:
                _send_msg(sock, "OK")
        elif op == "CLKS":
            _clock_reply(sock)
        elif op == "METR":
            _metr_reply(sock, payload, role="kv")
        elif op == "HLTH":
            _hlth_reply(sock, role="kv")
        elif op == "DUMP":
            # registry view, bounded: key -> value for live entries
            # (the fleet roster an incident bundle pins down)
            with self._lock:
                now = time.time()
                live = {k: v for k, (v, exp) in
                        list(self._data.items())[:256]
                        if exp is None or exp >= now}
            _dump_reply(sock, payload, role="kv",
                        state={"keys": len(self._data),
                               "registry": live})
        elif op == "EXIT":
            _send_msg(sock, "OK")
            self.stop()
        else:
            _send_msg(sock, "ERR", "unknown op %s" % op)


class KVClient:
    def __init__(self, endpoint, timeout=30.0):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock = None
        with self._lock:
            self._connect_locked()

    def _connect_locked(self):
        import socket as _socket
        s = _socket.create_connection(self._addr,
                                      timeout=self._timeout)
        s.settimeout(self._timeout)
        self._sock = s

    def _call(self, op, name="", body=None):
        trc = _trace._TRACER
        if trc is None:
            return self._call_locked(op, name, body)
        with trc.span("kv." + op.lower(), key=name,
                      endpoint="%s:%d" % self._addr):
            out = self._call_locked(op, name, body)
        self._maybe_clock_probe(trc)
        return out

    def _call_locked(self, op, name="", body=None):
        with self._lock:
            if self._sock is None:
                self._connect_locked()
            _send_msg(self._sock, op, name,
                      json.dumps(body).encode() if body is not None
                      else b"")
            return _recv_msg(self._sock)

    def _drop_conn(self):
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def _maybe_clock_probe(self, trc):
        """Periodic NTP-style offset sample (see RPCClient). The lock
        inside _call_locked keeps the probe off in-flight traffic. A
        torn probe (e.g. a timed-out recv whose reply lands later)
        leaves the stream DESYNCED — drop the connection; the next
        call reconnects lazily, so long-lived users (the _Lease
        heartbeat thread keeping a pserver slot alive) survive a
        single failed probe instead of losing their lease."""
        try:
            _clock.probe(trc, "%s:%d" % self._addr,
                         self._clock_exchange)
        except (ConnectionError, OSError, ValueError, KeyError):
            self._drop_conn()

    def _clock_exchange(self):
        op, _, payload = self._call_locked("CLKS")
        if op != "OK" or not payload:
            return None
        return float(json.loads(payload.decode())["t"])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def put(self, key, value, ttl=None):
        assert self._call("PUT", key, {"value": value, "ttl": ttl})[0] \
            == "OK"

    def get(self, key):
        op, _, payload = self._call("GET", key)
        if op == "MISS":
            return None
        return json.loads(payload.decode())["value"]

    def cas(self, key, old, new, ttl=None):
        """Atomically set key old→new (old None = create-if-absent).
        Returns True on success."""
        op, _, _ = self._call("CAS", key,
                              {"old": old, "new": new, "ttl": ttl})
        return op == "OK"

    def delete(self, key):
        self._call("DEL", key)

    def cad(self, key, old):
        """Compare-and-delete: remove key only if it still holds `old`.
        Returns True if the key was deleted."""
        return self._call("CAD", key, {"old": old})[0] == "OK"

    def list(self, prefix):
        _, _, payload = self._call("LIST", prefix)
        return json.loads(payload.decode())

    def lease_keepalive(self, key, ttl, expect=None):
        return self._call("LEAS", key,
                          {"ttl": ttl, "expect": expect})[0] == "OK"

    def shutdown_server(self):
        try:
            self._call("EXIT")
        except (ConnectionError, OSError):
            pass

    def close(self):
        self._drop_conn()


PS_PREFIX = "/ps/"
TRAINER_PREFIX = "/trainer/"


class _Lease:
    """Heartbeat thread keeping one KV key alive (etcd lease keepalive).

    If the lease expired while we stalled (GC pause, compile), the next
    heartbeat RECLAIMS the key with a CAS create-if-absent; if someone
    else claimed it first, ``lost`` is set and heartbeating stops — the
    owner must check ``lost`` and re-register rather than keep serving a
    slot it no longer holds (split-brain guard)."""

    def __init__(self, kv, key, ttl, value="alive"):
        self.kv = kv
        self.key = key
        self.ttl = ttl
        self.value = value
        self._next_value = None
        self.lost = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.ttl / 3.0):
            try:
                _HEARTBEATS.inc()
                if self.kv.lease_keepalive(self.key, self.ttl,
                                           expect=self.value):
                    continue
                # A mark() in flight? The KV may already hold the NEW
                # value while self.value still reads the old one —
                # adopt it and keep beating rather than declaring the
                # lease usurped by our own transition.
                nxt = self._next_value
                if nxt is not None and self.kv.lease_keepalive(
                        self.key, self.ttl, expect=nxt):
                    self.value = nxt
                    continue
                # expired: try to reclaim our slot atomically
                if self.kv.cas(self.key, None, self.value, ttl=self.ttl):
                    _LEASE_RECLAIMS.inc()
                    continue
                cur = self.kv.get(self.key)
                if cur == self.value or \
                        (nxt is not None and cur == nxt):
                    continue                # raced with our own write
                self.lost = True            # someone else owns it now
                _LEASE_LOST.inc()
                return
            except (ConnectionError, OSError):
                return

    def mark(self, new_value):
        """Transition the lease's registered VALUE in place (e.g. ep ->
        'draining:'+ep) without surrendering the slot. CAS-guarded on
        our current value so a usurper's registration is never
        clobbered; returns True when the transition took. The heartbeat
        thread races this — ``_next_value`` is published BEFORE the CAS
        so a concurrent keepalive that sees the new value adopts it
        instead of flagging the lease lost. No lock is held across the
        KV calls (lock-discipline)."""
        if self.lost:
            return False
        self._next_value = new_value
        if self.kv.cas(self.key, self.value, new_value, ttl=self.ttl):
            self.value = new_value
            self._next_value = None
            return True
        # CAS lost: either the heartbeat already adopted new_value (the
        # reclaim path wrote it), or a usurper owns the slot.
        cur = None
        try:
            cur = self.kv.get(self.key)
        except (ConnectionError, OSError):
            pass
        if cur == new_value:
            self.value = new_value
            self._next_value = None
            return True
        self._next_value = None
        return False

    def revoke(self):
        """Stop heartbeating and release the key (graceful leave).

        Uses compare-and-delete keyed on our own value: if the lease was
        lost and another holder now owns the key, the delete is a no-op —
        a departing loser must not free the NEW owner's slot."""
        self._stop.set()
        # join BEFORE deleting: a heartbeat mid-iteration could otherwise
        # re-create the key with its reclaim CAS right after our delete,
        # leaving the departed member registered for up to one TTL. The
        # loop exits within ttl/3 of _stop.set(); if the thread is wedged
        # in a slow KV call, skip the delete and let the TTL expire it.
        self._thread.join(timeout=self.ttl * 2 + 1.0)
        if self.lost or self._thread.is_alive():
            return
        try:
            self.kv.cad(self.key, self.value)
        except (ConnectionError, OSError):
            pass


def role_prefix(role):
    """KV key prefix for a role's slot registry ('ps' -> '/ps/')."""
    return "/%s/" % role.strip("/")


def register_endpoint(kv, role, desired, my_endpoint, ttl=1.0,
                      timeout=30.0):
    """Claim one of the `desired` index slots of a ROLE with CAS under
    a TTL lease (etcd_client.go:43-100, generalized beyond pservers so
    serving replicas — and any future role — share one registration
    path). Returns (index, lease). A crashed holder's slot frees itself
    when its lease expires; the replacement claims the SAME index and
    recovers that member's state (checkpoint shard, serving engine,
    ...)."""
    prefix = role_prefix(role)
    deadline = time.time() + timeout
    while time.time() < deadline:
        for i in range(desired):
            key = prefix + str(i)
            if kv.cas(key, None, my_endpoint, ttl=ttl):
                return i, _Lease(kv, key, ttl, value=my_endpoint)
        time.sleep(ttl / 4.0)
    raise TimeoutError("no free %s slot out of %d" % (role, desired))


def wait_for_endpoints(kv, role, desired, timeout=30.0):
    """Rendezvous: block until all `desired` slots of a role are
    claimed; returns the endpoint list ordered by slot index."""
    prefix = role_prefix(role)
    deadline = time.time() + timeout
    while time.time() < deadline:
        claimed = kv.list(prefix)
        if len(claimed) >= desired and all(
                prefix + str(i) in claimed for i in range(desired)):
            return [claimed[prefix + str(i)] for i in range(desired)]
        time.sleep(0.05)
    raise TimeoutError("%s rendezvous: %d claimed of %d desired"
                       % (role, len(kv.list(prefix)), desired))


def live_endpoints(kv, role):
    """Current slot -> registered value map for a role (whatever leases
    are alive NOW — no rendezvous wait). Callers that tombstone slots
    (serving.fleet eviction writes a non-endpoint marker) filter the
    values themselves."""
    prefix = role_prefix(role)
    out = {}
    for k, v in kv.list(prefix).items():
        try:
            out[int(k[len(prefix):])] = v
        except ValueError:
            pass
    return out


def register_pserver(kv, desired, my_endpoint, ttl=1.0):
    """Thin pserver alias over register_endpoint (role 'ps')."""
    return register_endpoint(kv, "ps", desired, my_endpoint, ttl=ttl)


def wait_for_pservers(kv, desired, timeout=30.0):
    """Thin pserver alias over wait_for_endpoints (role 'ps')."""
    return wait_for_endpoints(kv, "ps", desired, timeout=timeout)


class TrainerLease:
    """Trainer membership: register under /trainer/<id> with a TTL
    heartbeat; the master (or peers) can list live trainers. Leaving (or
    dying) frees the id — join/leave mid-run is just lease lifecycle."""

    def __init__(self, kv, trainer_id, ttl=1.0):
        self.trainer_id = str(trainer_id)
        self.key = TRAINER_PREFIX + self.trainer_id
        # Unique per-incarnation value so the LEAS expect-guard can tell
        # a stalled old incarnation from its replacement: with a shared
        # "alive" value a zombie's heartbeat would extend the usurper's
        # lease and neither side would ever see `lost` (split-brain).
        incarnation = "alive:" + uuid.uuid4().hex
        kv.put(self.key, incarnation, ttl=ttl)
        self._lease = _Lease(kv, self.key, ttl, value=incarnation)

    @staticmethod
    def live_trainers(kv):
        return sorted(k[len(TRAINER_PREFIX):]
                      for k in kv.list(TRAINER_PREFIX))

    def leave(self):
        self._lease.revoke()
