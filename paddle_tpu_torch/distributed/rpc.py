"""Variable RPC: length-prefixed numpy frames over TCP.

The port's copy of ``paddle_tpu/distributed/rpc.py``: the same frames,
byte for byte, so a server or client of either package talks to one of
the other. Values on the wire are host numpy arrays and SelectedRows;
the port's SelectedRows (torch tensors) is serialized from its numpy
view and comes off the wire as CPU tensors over the receive buffer.

Reference parity: operators/detail/ gRPC service {SendVariable, GetVariable,
PrefetchVariable} (send_recv.proto:17-25) with VariableMessage carrying
LoDTensor or SelectedRows payloads, plus the reference's port-discovery file
(listen_and_serv_op.cc:51-57 SavePort → /tmp/paddle.selected_port) so
multi-process tests can rendezvous on an ephemeral port.

The wire format is numpy-native (header + raw buffers), not pickle-of-
arbitrary-objects, so a malicious peer can't execute code via the
deserializer.

Verb map over this one frame protocol (every tier rides the same
``_send_msg``/``_recv_msg``, so fault injection, trace-context
propagation and the retry policy apply to all of them for free):

    pserver   SEND PUT GET PRFT BARR CHNK EXIT
    master    GETT DONE FAIL PING        (distributed/master.py)
    kv store  PUT GET CAS DEL CAD LIST LEAS   (membership.py)
    serving   SUBM POLL CANC STAT        (serving/fleet.py replicas)
    all       CLKS                       (trace clock probes)
    all       METR HLTH                  (fleet telemetry scrape:
                                          registry snapshot + recorder
                                          delta / liveness — served by
                                          every dispatch loop plus
                                          monitor.collector's
                                          TelemetryServer)
    all       DUMP                       (forensics black-box capture:
                                          span ring + recorder tail +
                                          metrics + flags + role state
                                          in one reply — see
                                          monitor/forensics.py)
"""

import itertools
import json
import os
import socket
import socketserver
import struct
import threading
import time
import uuid

import numpy as np
import torch

from ..core.selected_rows import SelectedRows
from ..monitor import metrics as _metrics
from ..monitor import runtime as _mon
from ..resilience import faults as _faults
from ..resilience.retry import RETRYABLE
from ..trace import clock as _clock
from ..trace import runtime as _trace

__all__ = ["VariableServer", "RPCClient", "serialize_var",
           "deserialize_var"]

_MAGIC = b"PTV1"

# Optional trace-context block: an armed tracer prefixes a frame with
#   <4sII>(op=@TRC, nlen=len(ctx), plen=0) + ctx
# before the real header. '@' can never start a verb (ops are ljust'd
# uppercase names), so receivers detect and consume the block
# UNCONDITIONALLY — a disarmed process still interoperates with an
# armed peer — while headerless (old) frames parse exactly as before.
# Absent when tracing is disarmed or the ambient span is sampled out,
# so a disarmed fleet exchanges byte-identical old frames.
_TRC_OP = b"@TRC"
_TRC_MAX = 256

# distributed-runtime telemetry (paddle_tpu_torch.monitor registry; a counter
# bump is sub-microsecond next to a socket round-trip, so these record
# unconditionally — the watchdog/flight-recorder read them on stalls)
_REG = _metrics.registry()
_RPC_REQS = _REG.counter("ptpu_rpc_requests_total",
                         "pserver requests handled", ("op",))
_RPC_BYTES = _REG.counter("ptpu_rpc_payload_bytes_total",
                          "pserver payload bytes received")
_PS_ROUNDS = _REG.counter("ptpu_ps_rounds_total",
                          "sync-SGD rounds applied by this pserver")
_PS_EVICTIONS = _REG.counter(
    "ptpu_ps_incarnation_evictions_total",
    "pending grads/barrier slots evicted from dead trainer incarnations")
_PS_STALE = _REG.counter(
    "ptpu_ps_stale_rejections_total",
    "messages rejected (STLE) as stale-incarnation stragglers")
_RPC_CHUNK_PUSHES = _REG.counter(
    "ptpu_rpc_chunk_pushes_total",
    "chunk-parallel large-value pushes (client side)")


def _serialize_parts(value):
    """numpy array / SelectedRows → list of buffers (VariableMessage
    parity). Scatter-gather: the value's own memory is one of the parts,
    so a 100MB send never copies the tensor into an intermediate blob —
    the wire-efficiency property the reference built zero-copy bytebuffer
    streams for (operators/detail/variable_response.cc)."""
    if isinstance(value, SelectedRows):
        rows, val = value.numpy()
        head = {"kind": "selected_rows", "height": value.height,
                "rows_n": int(rows.shape[0]),
                "dtype": str(val.dtype),
                "shape": list(val.shape)}
        hb = json.dumps(head).encode()
        return [struct.pack("<I", len(hb)), hb,
                _array_buffer(rows.astype("<i8")),
                _array_buffer(val)]
    arr = np.ascontiguousarray(_host(value))
    head = {"kind": "lod_tensor", "dtype": str(arr.dtype),
            "shape": list(arr.shape)}
    hb = json.dumps(head).encode()
    return [struct.pack("<I", len(hb)), hb, _array_buffer(arr)]


def _host(value):
    """A value as a host numpy array (a tensor is copied off its
    device)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _array_buffer(arr):
    """Zero-copy byte view of an array; memoryview.cast rejects shapes
    containing 0, so empty arrays fall back to b''."""
    arr = np.ascontiguousarray(arr)
    if arr.size == 0:
        return b""
    return memoryview(arr).cast("B")


def serialize_var(value):
    """numpy array / SelectedRows → one bytes blob (kept for tests and
    checkpoint paths; the wire uses _serialize_parts without the join)."""
    return b"".join(_serialize_parts(value))


def deserialize_var(buf):
    (hlen,) = struct.unpack("<I", bytes(buf[:4]))
    head = json.loads(bytes(buf[4:4 + hlen]).decode())
    body = memoryview(buf)[4 + hlen:]
    # np.frombuffer over the (private, per-message) receive buffer: when
    # it is writable (bytearray from _recv_exact) the array shares it —
    # no third copy of a large tensor
    own = isinstance(buf, (bytearray, memoryview)) and not \
        (isinstance(buf, memoryview) and buf.readonly)
    if head["kind"] == "selected_rows":
        n = head["rows_n"]
        rows = np.frombuffer(body[:8 * n], "<i8")
        value = np.frombuffer(body[8 * n:],
                              head["dtype"]).reshape(head["shape"])
        if not own:
            rows, value = rows.copy(), value.copy()
        return SelectedRows(torch.from_numpy(rows), torch.from_numpy(value),
                            head["height"])
    arr = np.frombuffer(body, head["dtype"]).reshape(head["shape"])
    return arr if own else arr.copy()


def _slice_parts(parts, start, stop):
    """Byte range [start, stop) of the logical concatenation of a
    buffer list, as a list of zero-copy views."""
    out, pos = [], 0
    for p in parts:
        mv = p if isinstance(p, memoryview) else memoryview(p)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        ln = len(mv)
        lo, hi = max(start - pos, 0), min(stop - pos, ln)
        if lo < hi:
            out.append(mv[lo:hi])
        pos += ln
        if pos >= stop:
            break
    return out


# chunk-parallel push: values above the threshold split into ranges
# pushed CONCURRENTLY over side connections, each received directly
# into the shared transfer buffer (the reference's zero-copy
# bytebuffer-stream intent, variable_response.cc, scaled out). Streams
# only pay when cores can actually run them: measured on a 1-core box
# the scaling INVERTS (1 stream 53 ms, 4 streams 131 ms for 52 MB — the
# "syscall-bound" single stream was really core-bound), so the stream
# count is capped by cpu_count and a single-core host keeps the plain
# path (the JAX package's DCN chunk-parallel probe).
_CHUNK_THRESHOLD = 8 << 20
_CHUNK_STREAMS = min(4, os.cpu_count() or 1)
_CHUNK_MARKER = b"@PTCHUNKED:"


def _sendall_parts(sock, parts):
    """sendall over a buffer list: scatter-gather sendmsg with
    short-send handling (sendmsg is one syscall and may send less than
    the total for large messages)."""
    bufs = []
    for p in parts:
        mv = p if isinstance(p, memoryview) else memoryview(p)
        if mv.ndim != 1 or mv.format != "B":
            mv = mv.cast("B")
        if len(mv):
            bufs.append(mv)
    while bufs:
        try:
            sent = sock.sendmsg(bufs)
        except AttributeError:          # platform without sendmsg
            for mv in bufs:
                sock.sendall(mv)
            return
        while sent:
            if sent >= len(bufs[0]):
                sent -= len(bufs[0])
                bufs.pop(0)
            else:
                bufs[0] = bufs[0][sent:]
                sent = 0


def _send_msg(sock, op, name="", payload=b""):
    """payload: bytes or a list of buffers (scatter-gather, no join).

    An armed resilience fault plan hooks the frame here (drop / delay /
    close-mid-frame / duplicate); an armed tracer prefixes the ambient
    span's context block (same scatter-gather write — zero extra
    syscalls). Disarmed, each hook is one None check."""
    parts = payload if isinstance(payload, list) else [payload]
    total = sum(len(p) for p in parts)
    nb = name.encode()
    head = struct.pack("<4sII", op.encode().ljust(4), len(nb), total) + nb
    trc = _trace._TRACER
    if trc is not None:
        wire = trc.wire_context()
        if wire is not None:
            head = struct.pack("<4sII", _TRC_OP, len(wire), 0) \
                + wire + head
    frame = [head] + parts
    plan = _faults._ACTIVE
    if plan is not None:
        plan.on_send(sock, op, frame)   # may sleep or break the conn
    _sendall_parts(sock, frame)


def _recv_exact(sock, n):
    """Read exactly n bytes into ONE buffer via recv_into (no
    chunk-append-join reassembly copies)."""
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return buf


def _recv_into(sock, view):
    """Fill a writable memoryview exactly (recv_into loop)."""
    got, n = 0, len(view)
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed")
        got += r


def _recv_frame_head(sock):
    """Read the 12-byte frame head, transparently consuming an optional
    leading trace-context block — at most ONE, bounded BEFORE
    allocating: a garbage peer must not drive an unbounded read or pin
    the handler thread streaming repeated blocks. Returns raw
    (op_bytes, nlen, plen, ctx_bytes_or_None)."""
    head = _recv_exact(sock, 12)
    op, nlen, plen = struct.unpack("<4sII", head)
    ctx = None
    if op == _TRC_OP:
        if not 0 < nlen <= _TRC_MAX or plen:
            raise ConnectionError(
                "bad trace-context block (nlen %d plen %d)"
                % (nlen, plen))
        ctx = bytes(_recv_exact(sock, nlen))
        head = _recv_exact(sock, 12)
        op, nlen, plen = struct.unpack("<4sII", head)
        if op == _TRC_OP:
            raise ConnectionError("repeated trace-context block")
    return op, nlen, plen, ctx


def _recv_msg(sock, want_ctx=False):
    plan = _faults._ACTIVE
    if plan is not None:
        plan.on_recv(sock)              # may sleep or break the conn
    op, nlen, plen, ctx = _recv_frame_head(sock)
    name = _recv_exact(sock, nlen).decode() if nlen else ""
    payload = _recv_exact(sock, plen) if plen else b""
    if want_ctx:
        # server dispatch loops ask for the propagated span context to
        # open a child span; replies / old frames carry none
        return op.strip().decode(), name, payload, ctx
    return op.strip().decode(), name, payload


def _clock_exchange(sock):
    """One CLKS round trip on an IDLE client connection → the server's
    epoch seconds (None on a non-OK reply). The three timestamps around
    this call feed trace.clock's midpoint offset estimator."""
    _send_msg(sock, "CLKS")
    op, _, payload = _recv_msg(sock)
    if op != "OK" or not payload:
        return None
    return float(json.loads(bytes(payload).decode())["t"])


def _clock_reply(sock):
    """Serve one CLKS probe (shared by the pserver / master / KV
    dispatchers): reply with this process's epoch clock, stamped as
    late as possible so the sample sits at the handling midpoint."""
    _send_msg(sock, "OK", "", json.dumps({"t": time.time()}).encode())


def _metr_reply(sock, payload, role="proc", registry=None):
    """Serve one METR scrape (fleet telemetry): the full metrics
    registry snapshot (incarnation + uptime stamped by the registry
    itself) plus the flight-recorder event delta since the caller's
    cursor (empty when no recorder is armed — counters alone still
    make the process observable). Shared by every dispatch loop; the
    reply is one JSON frame, so faults/trace/retry ride along exactly
    like any other verb."""
    body = {}
    if payload:
        try:
            body = json.loads(bytes(payload).decode())
        except (ValueError, UnicodeDecodeError):
            body = {}
    reg = registry if registry is not None else _metrics.registry()
    out = {"role": role, "pid": os.getpid(),
           "incarnation": reg.incarnation, "uptime_s": reg.uptime_s(),
           "snapshot": reg.snapshot(),
           "events": [], "cursor": body.get("cursor"), "lost": 0}
    # a collector scraping several endpoints of the SAME process asks
    # only its designated primary for the event delta ("events": false
    # on the others) — the ring cursor advances once per process. The
    # ring belongs to the process-GLOBAL identity: a server pinning a
    # private registry override reports a different incarnation, and
    # serving it the global ring would double-deliver every event
    # (two "processes", each a primary of the one ring).
    rec = _mon.recorder() if registry is None else None
    if rec is not None and body.get("events", True):
        try:
            # cursors are only meaningful within ONE ring's sequence
            # space: monitor.enable() mid-process replaces the
            # recorder, and the caller's old-ring cursor would
            # silently filter every new row — reply with the ring id
            # and restart the delta when the caller's doesn't match
            cursor = body.get("cursor")
            if body.get("ring") is not None \
                    and body.get("ring") != rec.ring_id:
                cursor = None
            cur, rows, lost = rec.events_since(cursor)
            out["events"] = rows
            out["cursor"] = cur
            out["lost"] = lost
            out["ring"] = rec.ring_id
        except Exception:
            pass            # telemetry must never fail the server loop
    _send_msg(sock, "VAL", "", json.dumps(out).encode())


def _hlth_reply(sock, role="proc", registry=None):
    """Serve one HLTH liveness probe: who am I (role / pid /
    incarnation) and how long have I been up — the cheap half of the
    scrape a collector uses to paint fleet membership without pulling
    a whole registry snapshot."""
    reg = registry if registry is not None else _metrics.registry()
    _send_msg(sock, "VAL", "", json.dumps(
        {"role": role, "pid": os.getpid(), "alive": True,
         "incarnation": reg.incarnation,
         "uptime_s": reg.uptime_s()}).encode())


def _dump_reply(sock, payload, role="proc", registry=None, state=None):
    """Serve one DUMP black-box capture (incident forensics): this
    process's tail span ring (sampled-out spans included), flight-
    recorder ring tail, metrics snapshot, non-default flags, and the
    dispatcher's role-specific ``state`` summary — everything a
    coordinator needs to explain an incident after the fact, in one
    JSON frame. Every section is salvage-guarded: a capture must
    degrade to a partial snapshot, never fail (or stall) the serving
    loop. Shared by every dispatch loop, like _metr_reply."""
    body = {}
    if payload:
        try:
            body = json.loads(bytes(payload).decode())
        except (ValueError, UnicodeDecodeError):
            body = {}
    reg = registry if registry is not None else _metrics.registry()
    out = {"role": role, "pid": os.getpid(), "t": time.time(),
           "incarnation": reg.incarnation, "uptime_s": reg.uptime_s()}
    if state is not None:
        out["state"] = state
    try:
        out["snapshot"] = reg.snapshot()
    except Exception:
        pass
    try:
        from .. import flags as _flags_mod
        out["flags"] = _flags_mod.overrides()
    except Exception:
        pass
    try:
        out["spans"] = _trace.tail_dump(
            max_spans=int(body.get("spans_max", 4096)))
    except Exception:
        pass
    rec = _mon.recorder() if registry is None else None
    if rec is not None and body.get("events", True):
        try:
            _cur, rows, lost = rec.events_since(None)
            limit = int(body.get("events_max", 1024))
            out["events"] = rows[-limit:] if limit else rows
            out["events_lost"] = lost
            out["ring"] = rec.ring_id
        except Exception:
            pass
    _send_msg(sock, "VAL", "", json.dumps(out).encode())


def _parse_tag(tag):
    """'t<id>:i<inc>:s<seq>' → ('t<id>:i<inc>', seq); else (None, None)."""
    if not tag:
        return None, None
    parts = tag.split(":")
    if len(parts) == 3 and parts[2][:1] == "s":
        try:
            return parts[0] + ":" + parts[1], int(parts[2][1:])
        except ValueError:
            pass
    return None, None


class StaleIncarnationError(RuntimeError):
    """A server has seen a NEWER incarnation of this trainer id, so it
    rejected our message. Normally that means we are a dead
    incarnation's delayed retry — but after an elastic reschedule onto
    a host whose clock is behind, a LIVE replacement can look stale
    too. The error carries the server's max epoch so the sender can
    re-incarnate past it and retry instead of deadlocking the round."""

    def __init__(self, max_epoch):
        super().__init__(
            "server knows a newer incarnation (epoch %d) of this "
            "trainer — re-incarnate past it and retry" % max_epoch)
        self.max_epoch = max_epoch


def _inc_epoch(pref):
    """Incarnation ordering: 't<id>:i<16-hex-epoch><nonce>' → epoch int,
    or None for legacy/handmade incarnation ids (no ordering known)."""
    inc = pref.split(":i", 1)
    if len(inc) != 2 or len(inc[1]) < 16:
        return None
    try:
        return int(inc[1][:16], 16)
    except ValueError:
        return None


class VariableServer:
    """Parameter-server process half (listen_and_serv_op.cc semantics):
    holds a scope of variables; SEND accumulates gradients, GET serves
    values, PRFT serves embedding rows by id, BARR implements the fan_in
    round barrier, after which `optimize_fn` is invoked once per round."""

    def __init__(self, host="127.0.0.1", port=0, fan_in=1,
                 optimize_fn=None, port_file=None, sync=True,
                 sparse_tables=None):
        self.store = {}              # name -> np.ndarray
        # per-process-lifetime identity: a REPLACEMENT server recovered
        # from checkpoint restores the same round counter, so readers
        # that cache rows (serving.sparse hot-ID cache) key their
        # invalidation on this token — an incarnation bump means every
        # cached row from the dead server is suspect, round number
        # notwithstanding
        self.incarnation = uuid.uuid4().hex[:12]
        self.grads = {}              # name -> list of pending grads
        self.fan_in = fan_in
        self.optimize_fn = optimize_fn
        # name -> {"shard": i, "num_shards": n, "height": global_rows}:
        # this server holds rows {g : g % n == i} of the GLOBAL table,
        # stored compactly at local index g // n (mod-sharding, the
        # split_ids placement — distribute_transpiler.py:201-255 parity)
        self.sparse_tables = dict(sparse_tables or {})
        self.sync = sync             # False → async SGD: apply on arrival
        self._lock = threading.Lock()
        self._round_cv = threading.Condition(self._lock)
        self._barrier_count = 0
        self._barr_seen = set()      # tags counted toward THIS round
        self._applied = {}           # "t<id>:i<inc>" -> last applied seq
        self._untagged_seq = itertools.count()
        self._max_epoch = {}         # "t<id>" -> newest incarnation epoch
        self._pending_chunks = {}    # tid -> chunk-parallel push parts
        self._round = 0
        self._shutdown = threading.Event()
        # accepted connections, tracked so stop() can SEVER them: a
        # dying process resets every socket it holds, but an in-process
        # stop() would otherwise leave handler threads parked in recv
        # serving the dead store — exactly the zombie a client-side
        # resolver could never notice (serving.sparse's stale-forever
        # hazard). Closing them makes stop() look like process death
        # from every peer's side.
        self._conns = set()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with outer._lock:
                    outer._conns.add(self.request)
                try:
                    while True:
                        op, nlen, plen, tctx = _recv_frame_head(
                            self.request)
                        op = op.strip().decode()
                        name = _recv_exact(self.request, nlen).decode() \
                            if nlen else ""
                        if op == "CHNK":
                            # receive straight into the shared transfer
                            # buffer — no per-message temp copy (and no
                            # span: the commit SEND carries the trace)
                            outer._recv_chunk(self.request, name, plen)
                            continue
                        payload = _recv_exact(self.request, plen) \
                            if plen else b""
                        trc = _trace._TRACER
                        if trc is not None and tctx is not None \
                                and op != "CLKS":
                            with trc.server_span("pserver." + op, tctx,
                                                 op=op, var=name):
                                outer._dispatch(self.request, op, name,
                                                payload)
                        else:
                            outer._dispatch(self.request, op, name,
                                            payload)
                        if op == "EXIT":
                            break
                except (ConnectionError, OSError):
                    pass
                finally:
                    with outer._lock:
                        outer._conns.discard(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        if port_file:
            with open(port_file, "w") as f:
                f.write(str(self.port))
        trc = _trace._TRACER
        if trc is not None:
            # merge maps clients' clock-sample peer endpoints to this
            # process through the registered endpoint/port
            trc.record_server_port(self.port,
                                   "%s:%d" % (host, self.port))
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._shutdown.set()
        with self._round_cv:
            self._round_cv.notify_all()
        # shutdown() handshakes with serve_forever; if the serve thread was
        # never started that handshake would block forever — just close.
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()
        # sever accepted connections (see _conns above): peers see the
        # same connection reset a real process death gives them, so
        # their retry/resolver recovery path engages instead of a
        # zombie handler thread serving the dead store forever
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    # -- dispatch ------------------------------------------------------------
    def _prune_chunks_locked(self, now):
        for t in [t for t, e in self._pending_chunks.items()
                  if now - e["t0"] > 120.0]:
            del self._pending_chunks[t]

    def _recv_chunk(self, sock, name, plen):
        """One range of a chunk-parallel push, received DIRECTLY into
        the shared transfer buffer at its offset — zero reassembly
        copies (the scaled-out analog of variable_response.cc's
        zero-copy stream). name: "tid:i:n:off:total". Header fields are
        client-supplied: bound them BEFORE allocating or receiving, so a
        garbage peer cannot trigger an unbounded allocation or desync
        the stream with an out-of-range slice."""
        tid, _i, n, off, total = name.rsplit(":", 4)
        n, off, total = int(n), int(off), int(total)
        if not (0 < total <= (1 << 32) and 0 < n <= 64
                and 0 <= off and off + plen <= total):
            raise ConnectionError(
                "bad chunk header %r (plen %d)" % (name, plen))
        now = time.time()
        with self._lock:
            # prune transfers whose commit never came (dead client)
            self._prune_chunks_locked(now)
            entry = self._pending_chunks.setdefault(
                tid, {"buf": bytearray(total), "got": 0,
                      "n": n, "t0": now})
            if len(entry["buf"]) != total or entry["n"] != n:
                raise ConnectionError(
                    "chunk header %r disagrees with transfer" % name)
        _recv_into(sock, memoryview(entry["buf"])[off:off + plen])
        with self._lock:
            entry["got"] += 1
        _send_msg(sock, "OK")

    def _resolve_chunked(self, payload):
        """A SEND/PUT whose payload is the chunk-commit marker: hand
        back the already-assembled transfer buffer (every CHNK was acked
        before the client committed)."""
        if bytes(payload[:len(_CHUNK_MARKER)]) != _CHUNK_MARKER:
            return payload
        tid = bytes(payload[len(_CHUNK_MARKER):]).decode()
        with self._lock:
            self._prune_chunks_locked(time.time())
            entry = self._pending_chunks.pop(tid, None)
        if entry is None:
            raise KeyError("chunked transfer %s has no parts" % tid)
        if entry["got"] != entry["n"]:
            raise ConnectionError(
                "chunked transfer %s committed with %d/%d parts"
                % (tid, entry["got"], entry["n"]))
        return entry["buf"]

    def _dispatch(self, sock, op, name, payload):
        plan = _faults._ACTIVE
        if plan is not None and \
                plan.should_kill("pserver", self._round):
            # hard crash: no reply for the in-flight request, no
            # checkpoint — exactly what a SIGKILL'd pserver looks like.
            # stop() must run off-thread (shutdown() handshakes with
            # serve_forever and would deadlock from a handler thread).
            threading.Thread(target=self.stop, daemon=True).start()
            raise ConnectionError("injected fault: pserver killed")
        _RPC_REQS.inc(op=op)
        _RPC_BYTES.inc(len(payload))
        if op in ("SEND", "PUT"):
            payload = self._resolve_chunked(payload)
        if op == "SEND":
            value = deserialize_var(payload)
            # optional idempotency tag after "||": a retried send for the
            # same (name, tag) REPLACES the pending grad instead of
            # accumulating; a send whose round was ALREADY applied is
            # dropped; pending grads from a dead incarnation of the same
            # trainer are evicted — at-least-once trainer retries (elastic
            # recovery) then yield exactly-once round semantics
            tag = None
            if "||" in name:
                name, tag = name.split("||", 1)
            pref, seq = _parse_tag(tag)
            if self.sync:
                # decide under the lock, reply after releasing it:
                # _send_msg blocks on the socket and a slow reader must
                # not stall every other handler thread on self._lock
                # (enforced by analysis --runtime, lock-discipline)
                with self._lock:
                    stale = (self._stale_epoch(pref)
                             if pref is not None else None)
                    applied = (stale is None and pref is not None
                               and seq <= self._applied.get(pref, -1))
                    if stale is None and not applied:
                        if pref is not None:
                            self._evict_stale_incarnation(pref)
                        slot = self.grads.setdefault(name, {})
                        # untagged sends get a monotonic key, never
                        # reused: len(slot) could collide with a live
                        # key after an eviction shrank the dict,
                        # silently replacing a pending grad that
                        # should accumulate
                        slot[tag if tag is not None
                             else "#%d" % next(self._untagged_seq)] \
                            = value
                if stale is not None:
                    _PS_STALE.inc()
                    _send_msg(sock, "STLE", name, json.dumps(
                        {"max_epoch": stale}).encode())
                    return
                if applied:
                    _send_msg(sock, "OK")   # round already applied
                    return
            else:
                # Async SGD (ParameterServer2.h async paths /
                # async_update.md): apply this gradient immediately under
                # the lock — no round barrier, trainers never wait on each
                # other, updates may be stale.
                with self._lock:
                    if self.optimize_fn is not None:
                        self.optimize_fn(self.store, {name: value})
            _send_msg(sock, "OK")
        elif op == "GET":
            with self._lock:
                val = self.store.get(name)
            if val is None:
                _send_msg(sock, "MISS", name)
            else:
                _send_msg(sock, "VAL", name, _serialize_parts(val))
        elif op == "PRFT":
            ids = deserialize_var(payload).astype(np.int64).reshape(-1)
            with self._lock:
                table = self.store.get(name)
                meta = self.sparse_tables.get(name)
                rnd = self._round
            # the reply NAME carries the rows' version coordinates
            # ("<table>|v<round>|<incarnation>") so a caching reader
            # (serving.sparse) can bound staleness: the round bumps
            # once per applied optimize round, the incarnation changes
            # when a replacement server recovers from checkpoint. Old
            # clients ignore the reply name entirely — the payload is
            # byte-identical to the unversioned reply.
            ver = "%s|v%d|%s" % (name, rnd, self.incarnation)
            if table is None:
                _send_msg(sock, "MISS", name)
            elif meta is not None:
                # sharded table: global ids (all ≡ shard mod num_shards)
                # index the compact local store at g // n
                local = ids // int(meta["num_shards"])
                rows = np.asarray(table)[np.clip(local, 0,
                                                 len(table) - 1)]
                _send_msg(sock, "VAL", ver,
                          _serialize_parts(SelectedRows(
                              ids, rows, int(meta["height"]))))
            else:
                rows = np.asarray(table)[np.clip(ids, 0,
                                                 len(table) - 1)]
                _send_msg(sock, "VAL", ver,
                          _serialize_parts(SelectedRows(ids, rows,
                                                        len(table))))
        elif op == "PUT":
            with self._lock:
                self.store[name] = np.asarray(deserialize_var(payload))
            _send_msg(sock, "OK")
        elif op == "BARR":
            if self.sync:
                self._barrier(sock, name or None)
            else:
                _send_msg(sock, "OK")   # async mode: barrier is a no-op
        elif op == "CLKS":
            _clock_reply(sock)
        elif op == "METR":
            _metr_reply(sock, payload, role="pserver")
        elif op == "HLTH":
            _hlth_reply(sock, role="pserver")
        elif op == "DUMP":
            with self._lock:
                state = {"round": self._round,
                         "vars": len(self.store),
                         "pending_grads": {k: len(v) for k, v
                                           in self.grads.items()},
                         "fan_in": self.fan_in, "sync": self.sync,
                         "incarnation": self.incarnation}
            _dump_reply(sock, payload, role="pserver", state=state)
        elif op == "EXIT":
            _send_msg(sock, "OK")
            self.stop()
        else:
            _send_msg(sock, "ERR", "unknown op %s" % op)

    def _stale_epoch(self, pref):
        """Under the lock. Non-None → REJECT this message with STLE: its
        incarnation is OLDER than one already seen for the trainer id,
        i.e. it is (almost always) a dead incarnation's straggler.
        Without this gate a delayed retry from the dead incarnation
        would pass the _applied check (its entry may be pruned) and then
        evict the LIVE replacement's pending grads via
        _evict_stale_incarnation. The returned max epoch travels back in
        the STLE reply so that the rare LIVE sender judged stale (clock
        skew after an elastic reschedule) can re-incarnate past it and
        retry — a silent drop would deadlock the whole round. Legacy
        unordered incarnation ids return None and keep the old eviction
        rules."""
        epoch = _inc_epoch(pref)
        if epoch is None:
            return None
        tid = pref.split(":", 1)[0]
        cur = self._max_epoch.get(tid)
        if cur is not None and epoch < cur:
            return cur
        self._max_epoch[tid] = epoch
        return None

    def _evict_stale_incarnation(self, pref):
        """Drop EVERYTHING a dead incarnation of this trainer left
        behind: pending grads under every name, and its counted barrier
        slots. Called (under the lock) whenever a tagged SEND or BARR
        arrives — the replacement incarnation's first message cleans up
        after the crash, across all names, so a half-step from the dead
        process can never be merged into a round."""
        tid = pref.split(":", 1)[0]

        def stale(k):
            return (isinstance(k, str) and k.startswith(tid + ":")
                    and not k.startswith(pref + ":"))

        for slot in self.grads.values():
            for k in [k for k in slot if stale(k)]:
                del slot[k]
                _PS_EVICTIONS.inc()
        dead_barrs = {t for t in self._barr_seen if stale(t)}
        if dead_barrs:
            self._barr_seen -= dead_barrs
            self._barrier_count = max(
                0, self._barrier_count - len(dead_barrs))
        # drop the dead incarnations' applied-round history too, or a
        # long-lived pserver under elastic churn grows _applied forever.
        # Only prune entries PROVABLY older by epoch: for those, the
        # epoch gate already rejects any late retry, so the history is
        # dead weight. A legacy (unordered) entry must survive — it is
        # the only thing standing between a delayed applied-round retry
        # and this eviction path.
        caller_epoch = _inc_epoch(pref)
        if caller_epoch is not None:
            for k in [k for k in self._applied if stale(k + ":")]:
                ke = _inc_epoch(k)
                if ke is not None and ke < caller_epoch:
                    del self._applied[k]

    def _barrier(self, sock, tag=None):
        """Round barrier: after fan_in SENDs+BARRs, run the optimize step
        over accumulated grads, then release all waiters
        (listen_and_serv_op.cc:100-168 RunSyncLoop).

        Idempotency: a tagged barrier whose round was already applied
        returns immediately; a RETRY of a tag already counted toward the
        current round waits for the round without double-counting —
        together with tagged SENDs this makes at-least-once trainer
        retries exactly-once per round."""
        pref, seq = _parse_tag(tag)
        # the early replies (stale / already-applied) are decided under
        # the condition's lock but SENT after releasing it — socket
        # writes must never hold up the round for every other handler
        # (enforced by analysis --runtime, lock-discipline)
        with self._round_cv:
            stale = self._stale_epoch(pref) if pref is not None else None
            applied = (stale is None and pref is not None
                       and seq <= self._applied.get(pref, -1))
            if stale is None and not applied:
                if pref is not None:
                    self._evict_stale_incarnation(pref)
                my_round = self._round
                counted = not (tag and tag in self._barr_seen)
                if counted:
                    if tag:
                        self._barr_seen.add(tag)
                    self._barrier_count += 1
                if self._barrier_count >= self.fan_in:
                    grads, self.grads = self.grads, {}
                    merged = {}
                    for name, slot in grads.items():
                        glist = list(slot.values())
                        if not glist:  # fully evicted (stale incarnation)
                            continue
                        acc = glist[0]
                        for g in glist[1:]:
                            if isinstance(acc, SelectedRows):
                                acc = acc.merge(g)
                            else:
                                acc = acc + g
                        merged[name] = acc
                    if self.optimize_fn is not None:
                        self.optimize_fn(self.store, merged)
                    for t in self._barr_seen:
                        p, s = _parse_tag(t)
                        if p is not None:
                            self._applied[p] = max(
                                self._applied.get(p, -1), s)
                    self._barrier_count = 0
                    self._barr_seen = set()
                    self._round += 1
                    _PS_ROUNDS.inc()
                    self._round_cv.notify_all()
                else:
                    while (self._round == my_round
                           and not self._shutdown.is_set()):
                        self._round_cv.wait(timeout=0.1)
        if stale is not None:
            _PS_STALE.inc()
            _send_msg(sock, "STLE", tag or "", json.dumps(
                {"max_epoch": stale}).encode())
            return
        _send_msg(sock, "OK")


    # -- checkpoint / recover (go/pserver/service.go:156-205,346) ------------
    def checkpoint(self, path, keep_last=2):
        """Durably persist the parameter store. The blob goes to a
        VERSIONED file (path.<round>, CRC computed incrementally while
        writing — io.write_atomic_blob, shared with the trainer
        checkpoint path) and the meta JSON — which names the blob — is
        atomically renamed into place LAST, so a crash at any point
        leaves the previous (meta, blob) pair fully recoverable. The
        newest ``keep_last`` (meta, blob) pairs are RETAINED (versioned
        ``path.meta.<round>`` files + the ``path.meta`` newest-pointer),
        so recover() can fall back past a blob corrupted ON DISK after
        a clean write; anything older is pruned only after the new meta
        is durable."""
        import io as _io
        import json

        from ..io import write_atomic_blob, write_json_atomic

        with self._lock:
            arrays = {k: np.asarray(v) for k, v in self.store.items()}
            round_no = self._round
        d = os.path.dirname(os.path.abspath(path)) or "."
        base = os.path.basename(path)
        os.makedirs(d, exist_ok=True)
        buf = _io.BytesIO()
        np.savez(buf, **arrays)
        blob_name = "%s.%d" % (base, round_no)
        crc = write_atomic_blob(d, blob_name, buf.getbuffer())
        meta = {"round": round_no, "crc32": crc,
                "blob": blob_name, "names": sorted(arrays)}
        write_json_atomic("%s.meta.%d" % (path, round_no), meta)
        write_json_atomic(path + ".meta", meta)
        keep = {round_no}
        for n in os.listdir(d):
            if n.startswith(base + ".meta."):
                try:
                    keep.add(int(n[len(base) + 6:]))
                except ValueError:
                    pass
        keep = set(sorted(keep)[-max(1, keep_last):])
        for n in os.listdir(d):
            if not n.startswith(base + ".") or n.endswith(".tmp") \
                    or n == base + ".meta":
                continue
            tail = n[len(base) + 1:]
            ver = tail[5:] if tail.startswith("meta.") else tail
            try:
                if int(ver) in keep:
                    continue
            except ValueError:
                continue
            try:
                os.remove(os.path.join(d, n))
            except OSError:
                pass
        return meta

    def recover(self, path):
        """Reload the NEWEST VALID checkpoint written by checkpoint();
        returns its round number, or None when nothing valid exists
        (service.go recover path — a corrupt file is skipped, not
        trusted). Candidates: the versioned metas newest-first (the
        ``path.meta`` pointer is just the newest one's copy); a
        truncated or bit-flipped blob fails its CRC — checked on the
        exact bytes that get loaded, no re-read TOCTOU — and recovery
        FALLS BACK to the previous retained pair."""
        import io as _io
        import json
        import zlib

        d = os.path.dirname(os.path.abspath(path)) or "."
        base = os.path.basename(path)
        metas = []
        try:
            for n in os.listdir(d):
                if n.startswith(base + ".meta."):
                    try:
                        metas.append((int(n[len(base) + 6:]),
                                      os.path.join(d, n)))
                    except ValueError:
                        pass
        except OSError:
            return None
        metas.sort(reverse=True)
        if not metas and os.path.exists(path + ".meta"):
            metas = [(-1, path + ".meta")]    # pre-versioning layout
        for _, meta_path in metas:
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                blob = os.path.join(d, meta.get("blob", base))
                with open(blob, "rb") as f:
                    data = f.read()
                if zlib.crc32(data) != meta["crc32"]:
                    continue
                with np.load(_io.BytesIO(data)) as loaded:
                    with self._lock:
                        for name in loaded.files:
                            self.store[name] = loaded[name]
                        self._round = int(meta.get("round", 0))
                return meta["round"]
            except (OSError, ValueError, KeyError,
                    json.JSONDecodeError):
                continue
        return None


class RPCClient:
    """Trainer-side client (grpc_client.h:160-194 RPCClient parity, sync).

    retry:    optional resilience.retry.Policy — idempotent verbs (GET /
              PRFT / PUT, and SEND / BARR with a ROUND tag, which the
              server dedups across rounds) transparently reconnect and
              re-issue on socket errors. Untagged or free-form-tagged
              SEND / BARR never retry: a blind re-send would
              double-accumulate (see send_var / barrier).
    resolver: optional callable returning the CURRENT endpoint, checked
              on every reconnect — a membership-backed resolver (e.g.
              ``lambda: kv.get(PS_PREFIX + "0")``) makes the client
              follow a replacement pserver that recovered from its
              checkpoint on a new port after a lease expiry.
    """

    def __init__(self, endpoint, timeout=60.0, retry=None, resolver=None):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout
        self._retry = retry
        self._resolver = resolver
        self._sock = None
        self._side = []            # lazy chunk-parallel push streams
        self._connect()

    def _connect(self):
        if self._resolver is not None:
            try:
                ep = self._resolver()
            except Exception:
                ep = None
            if ep:
                host, port = ep.rsplit(":", 1)
                self._addr = (host, int(port))
        s = socket.create_connection(self._addr, timeout=self._timeout)
        # Steady-state recv timeout: a dead/hung server raises
        # socket.timeout instead of deadlocking the whole test suite
        # (grpc deadline parity). barrier() lifts it — a sync-mode barrier
        # legitimately blocks until the slowest trainer arrives.
        s.settimeout(self._timeout)
        self._sock = s
        if _trace._TRACER is not None:
            # the span (verb or retry attempt) learns which endpoint
            # actually served it — a resolver-followed REPLACEMENT
            # pserver shows up as a changed endpoint on the attempt
            _trace.annotate(endpoint="%s:%d" % self._addr)

    def _drop_conn(self):
        """Close the main socket AND every side stream (a reconnect must
        never reuse a half-used stream's stale bytes) — the connection
        set rebuilds lazily from scratch."""
        for s in [self._sock] + self._side:
            if s is None:
                continue
            try:
                s.close()
            except OSError:
                pass
        self._sock = None
        self._side = []

    def _retrying(self, what, idempotent, body):
        """Run a verb body under the retry policy (when configured and
        the verb is idempotent). The body must re-read self._sock — a
        retry reconnects, possibly to a REPLACEMENT endpoint via the
        resolver. With tracing armed, the verb is ONE logical client
        span; Policy.run opens an attempt child per try, so a retried
        GET reads as one span with N attempt children in the merged
        timeline."""
        trc = _trace._TRACER
        if trc is None:
            return self._retrying_inner(what, idempotent, body)
        with trc.span(what, endpoint="%s:%d" % self._addr):
            out = self._retrying_inner(what, idempotent, body)
        self._maybe_clock_probe(trc)
        return out

    def _retrying_inner(self, what, idempotent, body):
        if self._retry is None or not idempotent:
            if self._sock is None:
                self._connect()
            return body()

        def attempt():
            if self._sock is None:
                self._connect()
                _mon.on_reconnect("rpc")
                _trace.annotate(reconnected=True)
            return body()

        return self._retry.run(
            attempt, what=what, retry_on=RETRYABLE,
            on_retry=lambda a, e: self._drop_conn())

    def _maybe_clock_probe(self, trc):
        """Periodic NTP-style offset sample against this peer on the
        idle main connection (call-response protocol: nothing is in
        flight between verbs). A torn probe leaves the stream desynced
        — drop the connection and let it rebuild lazily."""
        if self._sock is None:
            return
        try:
            _clock.probe(trc, "%s:%d" % self._addr,
                         lambda: _clock_exchange(self._sock))
        except (ConnectionError, OSError, ValueError, KeyError):
            self._drop_conn()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _streams(self, n):
        while len(self._side) < n:
            s = socket.create_connection(self._addr,
                                         timeout=self._timeout)
            s.settimeout(self._timeout)
            self._side.append(s)
        return self._side[:n]

    def _push_value(self, op, wire, value, idempotent=True):
        """SEND/PUT with chunk-parallel streaming for large values: the
        serialized bytes split into _CHUNK_STREAMS ranges pushed
        concurrently over side connections (a single TCP stream is
        syscall-bound ~0.8 GB/s — PERF.md DCN tier), then committed on
        the main socket so ordering/idempotency semantics are untouched."""
        return self._retrying(
            "rpc." + op.lower(), idempotent,
            lambda: self._push_value_once(op, wire, value))

    def _push_value_once(self, op, wire, value):
        parts = _serialize_parts(value)
        total = sum(len(p) for p in parts)
        if total < _CHUNK_THRESHOLD or _CHUNK_STREAMS < 2:
            _send_msg(self._sock, op, wire, parts)
            return self._expect_ok()
        n = _CHUNK_STREAMS
        _RPC_CHUNK_PUSHES.inc()
        tid = uuid.uuid4().hex[:12]
        bounds = [total * i // n for i in range(n + 1)]
        socks = self._streams(n)
        errs = []

        def push_part(i):
            try:
                _send_msg(socks[i], "CHNK",
                          "%s:%d:%d:%d:%d" % (tid, i, n, bounds[i],
                                              total),
                          _slice_parts(parts, bounds[i], bounds[i + 1]))
                o, _, _ = _recv_msg(socks[i])
                if o != "OK":
                    raise ConnectionError("CHNK reply %s" % o)
            except BaseException as e:
                errs.append(e)

        threads = [threading.Thread(target=push_part, args=(i,),
                                    daemon=True) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            # a half-used side socket may hold stale bytes/replies:
            # never reuse it — a retry must reconnect fresh streams
            for s in self._side:
                try:
                    s.close()
                except OSError:
                    pass
            self._side = []
            raise errs[0]
        _send_msg(self._sock, op, wire, _CHUNK_MARKER + tid.encode())
        return self._expect_ok()

    def send_var(self, name, value, tag=None):
        """tag: optional idempotency token — a retried send with the
        same tag replaces the pending grad server-side (see SEND).

        Only a ROUND-format tag ('t<id>:i<inc>:s<seq>') licenses the
        retry policy to re-issue: the server's cross-round dedup
        (_applied) is keyed by the parsed prefix, so a free-form tag is
        deduped only within the current round — a replay after the
        round closed would be accumulated into the NEXT round."""
        wire = name if tag is None else "%s||%s" % (name, tag)
        self._push_value("SEND", wire, value,
                         idempotent=_parse_tag(tag)[0] is not None)

    def _expect_ok(self):
        op, _, payload = _recv_msg(self._sock)
        if op == "STLE":
            raise StaleIncarnationError(
                json.loads(payload.decode())["max_epoch"])
        assert op == "OK", op

    def get_var(self, name):
        def body():
            _send_msg(self._sock, "GET", name)
            op, _, payload = _recv_msg(self._sock)
            if op == "MISS":
                raise KeyError("server has no var %r" % name)
            return deserialize_var(payload)
        return self._retrying("rpc.get", True, body)

    def put_var(self, name, value):
        self._push_value("PUT", name, value)

    def prefetch(self, table_name, ids, want_version=False):
        """Fetch rows by id. ``want_version=True`` additionally returns
        the server's version coordinates parsed from the reply name —
        ``{"round": <optimize rounds applied>, "inc": <server
        incarnation>}``, or None against a pre-versioning server — the
        token serving.sparse's hot-ID cache keys bounded staleness and
        respawn invalidation on."""
        def body():
            _send_msg(self._sock, "PRFT", table_name,
                      serialize_var(np.asarray(ids, np.int64)))
            op, name, payload = _recv_msg(self._sock)
            if op == "MISS":
                raise KeyError("server has no table %r" % table_name)
            sr = deserialize_var(payload)
            if not want_version:
                return sr
            ver = None
            parts = name.split("|")
            if len(parts) == 3 and parts[1][:1] == "v":
                try:
                    ver = {"round": int(parts[1][1:]), "inc": parts[2]}
                except ValueError:
                    pass
            return sr, ver
        return self._retrying("rpc.prefetch", True, body)

    def barrier(self, tag=None):
        # ROUND-tagged barriers are exactly-once server-side across
        # rounds (_applied, keyed by the parsed tag prefix), so the
        # retry policy may re-issue them; an untagged or free-form tag
        # is only deduped within the current round (_barr_seen resets
        # when it closes) — a replay would count toward the NEXT round,
        # so those never retry
        def body():
            _send_msg(self._sock, "BARR", tag or "")
            # no deadline: the server replies only after all fan_in
            # trainers arrive, which can take arbitrarily long (slow
            # peers, compiles)
            self._sock.settimeout(None)
            try:
                self._expect_ok()
            finally:
                sock = self._sock
                if sock is not None:
                    try:
                        sock.settimeout(self._timeout)
                    except OSError:
                        pass
        return self._retrying("rpc.barrier",
                              _parse_tag(tag)[0] is not None, body)

    def shutdown_server(self):
        try:
            if self._sock is None:
                self._connect()
            _send_msg(self._sock, "EXIT", "")
            _recv_msg(self._sock)
        except (ConnectionError, OSError):
            pass

    def close(self):
        self._drop_conn()
