"""Tracer core: spans, ambient context, wire encoding, span log.

The port's copy of ``paddle_tpu/trace/runtime.py`` (pure Python).

Reference parity: the platform layer's host profiler + device tracer
pair (platform/profiler.h:26-107, device_tracer.h:32) correlates events
from many sources into one unified timeline; here the "many sources"
are PROCESSES (trainer / pserver / master / membership KV), so the
correlation key is a Dapper-style SpanContext propagated in-band with
each RPC and the unifier is the merge CLI (trace/merge.py).

Design points:

  * One process-wide ``Tracer`` (``enable()``/``_TRACER``), mirroring
    resilience.faults' arming: every hook site in the runtime is a
    single ``_TRACER is None`` check when tracing is disarmed.
  * Client-side spans are AMBIENT (a thread-local stack): the executor
    opens a root span per step, RPC verb spans nest under it, retry
    attempts under the verb span — and ``wire_context()`` reads the
    stack top to inject into outgoing frames.
  * Server-side spans are EXPLICIT (never pushed on the stack): a
    dispatch thread's reply sends must not re-inject the request's
    context back at the client.
  * Sampling is decided once at the ROOT (Dapper head sampling) and
    inherited; only sampled spans are PERSISTED at emission. A
    disarmed fleet exchanges byte-identical old frames.
  * Tail-based retention (the incident-forensics tier): an armed
    tracer additionally buffers EVERY completed span — sampled-out
    ones included, at full fidelity — in a bounded in-memory ring
    grouped by trace id (``_TailRing``). The retention decision is
    made AFTER the outcome is known: a root that closed with an
    error, a root over ``trace_tail_slow_ms``, or a trace id named by
    an open incident (``retain_trace``) promotes the WHOLE buffered
    trace to the span log, so ``trace merge`` reconstructs exactly
    the requests that went wrong without paying 100% sampling on
    disk. With the ring armed (``trace_tail_window`` > 0, the
    default) sampled-out spans DO inject their context block (wire
    form already carries the sampled=0 flag) so a remote peer's ring
    buffers the same trace under the same id; ``trace_tail_window=0``
    restores the historical headerless behavior.
  * The span log reuses monitor's FlightRecorder (bounded JSONL,
    atomic-append, in-band truncation marker). Rows:
      span        {trace, span, parent, name, t0, dur, pid, proc, tid,
                   attrs?}
      clock       {peer, offset, rtt}      (clock.py midpoint samples)
      server_port {port}                   (port -> pid for the merge)
      proc_meta   {argv}                   (lane naming)
"""

import collections
import os
import random
import sys
import threading
import time

from ..monitor import runtime as _mon
from ..monitor.recorder import FlightRecorder

__all__ = [
    "SpanContext", "Span", "Tracer", "enable", "disable", "enabled",
    "tracer", "span", "annotate", "current_span", "active_trace_id",
    "extract", "maybe_enable_from_flags", "detached_span", "child_span",
    "retain_trace", "tail_armed", "tail_dump",
]

_DEFAULT_MAX_BYTES = 64 << 20
_ID_BITS = 8              # bytes of entropy per id (16 hex chars)


def _new_id():
    return os.urandom(_ID_BITS).hex()


class SpanContext:
    """The propagated triple + sampling decision (Dapper header)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id, span_id, parent_id=None, sampled=True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = bool(sampled)

    def child(self):
        return SpanContext(self.trace_id, _new_id(), self.span_id,
                           self.sampled)

    def to_wire(self):
        """Compact wire form: b'<trace16>:<span16>:<0|1>'."""
        return ("%s:%s:%d" % (self.trace_id, self.span_id,
                              int(self.sampled))).encode()

    def __repr__(self):
        return "SpanContext(%s/%s parent=%s sampled=%s)" % (
            self.trace_id, self.span_id, self.parent_id, self.sampled)


def extract(wire):
    """Parse a wire context (bytes/str) -> SpanContext | None. Never
    raises: a malformed header from a mismatched peer degrades to
    untraced, not to a dead connection."""
    if wire is None:
        return None
    try:
        if isinstance(wire, (bytes, bytearray, memoryview)):
            wire = bytes(wire).decode("ascii")
        trace_id, span_id, sampled = wire.split(":")
        if not trace_id or not span_id:
            return None
        return SpanContext(trace_id, span_id, sampled=sampled != "0")
    except (ValueError, UnicodeDecodeError):
        return None


class Span:
    """One timed operation; a context manager. ``ambient`` spans push
    onto the tracer's thread-local stack (client side) so nested spans
    and ``wire_context()`` see them; server spans stay off the stack."""

    __slots__ = ("_trc", "ctx", "name", "attrs", "t0", "_pc0",
                 "_ambient")

    def __init__(self, trc, ctx, name, attrs, ambient):
        self._trc = trc
        self.ctx = ctx
        self.name = name
        self.attrs = attrs
        self._ambient = ambient
        self.t0 = None
        self._pc0 = None

    def annotate(self, **attrs):
        self.attrs.update(attrs)

    def start(self):
        """Explicit begin for spans whose lifetime cannot be a ``with``
        block (the serving request span opens at submit() on the caller
        thread and closes at retirement on the engine loop thread)."""
        return self.__enter__()

    def finish(self, error=None):
        """Explicit end pairing ``start()``; ``error`` lands in attrs
        the way an in-block exception would."""
        if error is not None:
            self.attrs["error"] = repr(error)
        return self.__exit__(None, None, None)

    def __enter__(self):
        self.t0 = time.time()
        self._pc0 = time.perf_counter()
        if self._ambient:
            self._trc._stack().append(self)
        return self

    def __exit__(self, etype, exc, tb):
        dur = time.perf_counter() - self._pc0
        if self._ambient:
            stack = self._trc._stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:            # never corrupt the ambient
                stack.remove(self)         # chain on exotic unwinds
        if etype is not None:
            self.attrs["error"] = repr(exc)
        if self.ctx.sampled or self._trc._tail is not None:
            self._trc._finish_span(self, dur)
        return False


class _NullSpan:
    """No-op stand-in so call sites can unconditionally ``with``."""

    ctx = None

    def annotate(self, **attrs):
        pass

    def start(self):
        return self

    def finish(self, error=None):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _TailRing:
    """Bounded in-memory buffer of COMPLETED spans grouped by trace id
    — the tail-retention staging area and the spans part of a black-box
    DUMP capture. LRU over traces (``window`` most recently touched
    trace ids survive) with a per-trace span cap so one pathological
    trace cannot evict the rest of the window."""

    __slots__ = ("window", "span_cap", "_lock", "_traces")

    def __init__(self, window, span_cap=512):
        self.window = int(window)
        self.span_cap = int(span_cap)
        self._lock = threading.Lock()
        self._traces = collections.OrderedDict()

    def append(self, trace_id, row, sampled):
        with self._lock:
            e = self._traces.get(trace_id)
            if e is None:
                e = self._traces[trace_id] = {
                    "rows": [], "sampled": bool(sampled), "dropped": 0}
                while len(self._traces) > self.window:
                    self._traces.popitem(last=False)
            else:
                self._traces.move_to_end(trace_id)
                if sampled:
                    e["sampled"] = True
            if len(e["rows"]) >= self.span_cap:
                e["dropped"] += 1
            else:
                e["rows"].append(row)

    def pop(self, trace_id):
        with self._lock:
            return self._traces.pop(trace_id, None)

    def snapshot(self):
        """[(trace_id, {rows, sampled, dropped})] oldest-first; rows
        lists are copied so the caller can serialize without racing
        concurrent appends."""
        with self._lock:
            return [(tid, {"rows": list(e["rows"]),
                           "sampled": e["sampled"],
                           "dropped": e["dropped"]})
                    for tid, e in self._traces.items()]

    def __len__(self):
        with self._lock:
            return len(self._traces)


_RETAINED_CAP = 4096      # retained-trace ids remembered per process


class Tracer:
    """Process-wide tracing state + span log writer."""

    def __init__(self, log_path=None, sample_rate=1.0, proc=None,
                 clock_interval=15.0, max_bytes=_DEFAULT_MAX_BYTES,
                 tail_window=None, tail_slow_ms=None):
        self.proc = proc or _default_proc()
        self.pid = os.getpid()
        self.sample_rate = float(sample_rate)
        # <=0 means "every opportunity" (tests / short runs)
        self.clock_interval = float(clock_interval)
        if tail_window is None or tail_slow_ms is None:
            from .. import flags
            try:
                if tail_window is None:
                    tail_window = flags.get_flag("trace_tail_window")
                if tail_slow_ms is None:
                    tail_slow_ms = flags.get_flag("trace_tail_slow_ms")
            except KeyError:      # stripped-down flag registry (tests)
                tail_window = tail_window or 0
                tail_slow_ms = tail_slow_ms or 0.0
        self.tail_slow_ms = float(tail_slow_ms)
        self._tail = (_TailRing(int(tail_window))
                      if int(tail_window) > 0 else None)
        self._retained = set()          # trace ids already promoted
        self._retained_order = collections.deque()
        # rows of promoted traces, kept for DUMP captures: promotion
        # pops the ring, but a forensics bundle assembled moments later
        # (signals promotes offenders BEFORE the capture hook runs)
        # must still see the offender's spans
        self._promoted = collections.deque(maxlen=2048)
        self._ports = []                # server_port rows (for DUMP)
        self._clocks = collections.deque(maxlen=256)  # clock rows
        self._local = threading.local()
        self._lock = threading.Lock()
        self._clock_last = {}           # peer endpoint -> monotonic ts
        self._rng = random.Random(os.urandom(8))
        self._rec = (FlightRecorder(log_path, max_bytes=max_bytes)
                     if log_path else None)
        if self._rec is not None:
            self._rec.record("proc_meta", pid=self.pid, proc=self.proc,
                             argv=sys.argv[:4])

    # -- ambient stack -----------------------------------------------------
    def _stack(self):
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def current_span(self):
        s = getattr(self._local, "stack", None)
        return s[-1] if s else None

    def wire_context(self):
        """Bytes to inject into an outgoing frame, or None (no ambient
        span; or sampled out with the tail ring off). With the ring on,
        sampled-out contexts DO propagate (the wire form carries the
        sampled=0 flag) so the remote peer's ring buffers the trace
        under the same id and tail retention can promote it fleet-wide.
        Called from rpc._send_msg under the armed branch only."""
        s = getattr(self._local, "stack", None)
        if not s:
            return None
        ctx = s[-1].ctx
        if not ctx.sampled and self._tail is None:
            return None
        return ctx.to_wire()

    # -- span creation -----------------------------------------------------
    def span(self, name, **attrs):
        """Child of the ambient span, or a new (sampled-per-rate) root."""
        cur = self.current_span()
        if cur is not None:
            ctx = cur.ctx.child()
        else:
            sampled = (self.sample_rate >= 1.0
                       or self._rng.random() < self.sample_rate)
            ctx = SpanContext(_new_id(), _new_id(), sampled=sampled)
        return Span(self, ctx, name, dict(attrs), ambient=True)

    def server_span(self, name, wire_ctx, **attrs):
        """Child of an EXTRACTED remote context (the request's header).
        Not ambient: reply sends must not carry it back."""
        ctx = wire_ctx if isinstance(wire_ctx, SpanContext) \
            else extract(wire_ctx)
        if ctx is None:
            return _NULL_SPAN
        return Span(self, ctx.child(), name, dict(attrs), ambient=False)

    # -- log rows ----------------------------------------------------------
    def _finish_span(self, span, dur):
        """A span closed: persist it (sampled / already-retained trace),
        buffer it in the tail ring, and — when an UNSAMPLED root closes
        — make the retention decision (error / slow) now that the
        outcome is known."""
        row = {"trace": span.ctx.trace_id, "span": span.ctx.span_id,
               "parent": span.ctx.parent_id, "name": span.name,
               "t0": span.t0, "dur": dur, "pid": self.pid,
               "proc": self.proc, "tid": threading.get_ident()}
        if span.attrs:
            row["attrs"] = span.attrs
        tid = span.ctx.trace_id
        tail = self._tail
        if span.ctx.sampled:
            if tail is not None:
                tail.append(tid, row, True)
            self._write_row(row)
            return
        if tail is None:
            return
        with self._lock:
            retained = tid in self._retained
        if retained:
            # trace was promoted while still open: late spans flow
            # straight to the log instead of re-buffering
            self._promoted.append(row)
            self._write_row(row)
            return
        tail.append(tid, row, False)
        if span.ctx.parent_id is None:
            if "error" in span.attrs:
                self.retain_trace(tid, "error")
            elif (self.tail_slow_ms > 0
                  and dur * 1000.0 >= self.tail_slow_ms):
                self.retain_trace(tid, "slow")

    def _write_row(self, row):
        rec = self._rec
        if rec is not None and rec.record("span", **row):
            _mon.TRACE_SPANS.inc(proc=self.proc)
        else:
            _mon.TRACE_DROPPED.inc()

    def retain_trace(self, trace_id, reason="incident"):
        """Retroactively promote a buffered trace to the span log; the
        tail-retention policy point (root error / slow root) and the
        incident hook (signals names offender trace ids). Idempotent;
        marks the id retained even when nothing is buffered yet so
        spans that close AFTER the decision persist too. Returns True
        when the promotion took effect."""
        if not trace_id or self._tail is None:
            return False
        with self._lock:
            if trace_id in self._retained:
                return False
            self._retained.add(trace_id)
            self._retained_order.append(trace_id)
            if len(self._retained_order) > _RETAINED_CAP:
                self._retained.discard(self._retained_order.popleft())
        entry = self._tail.pop(trace_id)
        if entry is not None and entry["sampled"]:
            return False      # head sampling already persisted it
        if entry is not None:
            for row in entry["rows"]:
                self._promoted.append(row)
                self._write_row(row)
        _mon.TRACE_RETAINED.inc(reason=reason)
        self.flush()
        return True

    def tail_dump(self, max_spans=4096):
        """Merge-consumable snapshot of this process's black box:
        'ev'-tagged rows (proc_meta / server_port / clock / span) in
        exactly the span-log shape, so a forensics bundle part feeds
        trace.merge.load_logs unchanged (every row carries the ``ts``
        the tolerant JSONL reader requires — the recorder would have
        stamped it). Most recent spans win when the ring holds more
        than ``max_spans``."""
        now = time.time()
        out = [{"ev": "proc_meta", "pid": self.pid, "proc": self.proc,
                "argv": sys.argv[:4], "ts": now}]
        for row in list(self._ports):
            out.append(dict(row, ev="server_port", ts=now))
        for row in list(self._clocks):
            out.append(dict(row, ev="clock", ts=now))
        spans = list(self._promoted)   # promoted traces left the ring
        if self._tail is not None:
            for _tid, e in self._tail.snapshot():
                spans.extend(e["rows"])
        for row in spans[-int(max_spans):] if max_spans else spans:
            out.append(dict(row, ev="span", ts=row.get("t0", now)))
        return out

    def record_server_port(self, port, endpoint=None):
        """Servers register their listening port (and, when known, the
        full host:port endpoint) so the merge can map a client clock
        sample's peer endpoint to this process — the endpoint
        disambiguates equal ports on different hosts."""
        row = {"port": int(port), "pid": self.pid,
               "proc": self.proc}
        if endpoint:
            row["endpoint"] = endpoint
        with self._lock:
            self._ports.append(row)     # kept for DUMP captures
            del self._ports[:-64]
        if self._rec is not None:
            self._rec.record("server_port", **row)

    def clock_due(self, peer):
        """Rate-limit clock probing per peer (one probe per
        ``clock_interval`` seconds; <=0 probes at every opportunity)."""
        now = time.monotonic()
        with self._lock:
            last = self._clock_last.get(peer)
            if last is not None and now - last < self.clock_interval:
                return False
            self._clock_last[peer] = now
        return True

    def record_clock(self, peer, offset, rtt):
        row = {"peer": peer, "offset": offset, "rtt": rtt,
               "pid": self.pid, "proc": self.proc}
        self._clocks.append(row)        # kept for DUMP captures
        if self._rec is not None:
            self._rec.record("clock", **row)

    def flush(self):
        if self._rec is not None:
            self._rec.flush()

    def close(self):
        if self._rec is not None:
            self._rec.close()


def _default_proc():
    base = os.path.basename(sys.argv[0] or "")
    if base.endswith(".py"):
        base = base[:-3]
    return base or ("pid%d" % os.getpid())


# -- process-wide arming ---------------------------------------------------

_TRACER = None


def enable(log_path=None, sample_rate=1.0, proc=None,
           clock_interval=15.0, max_bytes=_DEFAULT_MAX_BYTES,
           tail_window=None, tail_slow_ms=None):
    """Arm tracing process-wide; returns the Tracer. Re-arming replaces
    (and closes) the previous tracer. ``tail_window``/``tail_slow_ms``
    default to the like-named flags (None = read the flag)."""
    global _TRACER
    disable()
    _TRACER = Tracer(log_path=log_path, sample_rate=sample_rate,
                     proc=proc, clock_interval=clock_interval,
                     max_bytes=max_bytes, tail_window=tail_window,
                     tail_slow_ms=tail_slow_ms)
    return _TRACER


def disable():
    global _TRACER
    t, _TRACER = _TRACER, None
    if t is not None:
        t.close()


def enabled():
    return _TRACER is not None


def tracer():
    return _TRACER


def span(name, **attrs):
    """``with trace.span("round", step=i):`` — child of the ambient
    span or a new root; a no-op context manager when disarmed."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, **attrs)


def detached_span(name, **attrs):
    """A new ROOT span that is neither entered nor ambient: the caller
    owns its lifetime via ``start()``/``finish()``. This is the shape
    for operations that cross engine iterations AND threads — the
    serving request span opens at submit() on the caller thread and
    closes at retirement on the engine loop thread, where an ambient
    ``with`` block cannot reach. Head-sampled per the tracer rate like
    any root; a no-op when disarmed."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    sampled = (t.sample_rate >= 1.0 or t._rng.random() < t.sample_rate)
    return Span(t, SpanContext(_new_id(), _new_id(), sampled=sampled),
                name, dict(attrs), ambient=False)


def child_span(name, parent, **attrs):
    """Non-ambient child of an EXPLICIT parent span (which may live on
    another thread's stack, or on no stack at all) — the per-prefill-
    chunk and first-token spans under a serving request span. No-op
    when disarmed, when the parent is a no-op, or when the parent was
    sampled out with the tail ring off (an armed ring buffers
    sampled-out children so retention can recover them)."""
    t = _TRACER
    ctx = getattr(parent, "ctx", None)
    if t is None or ctx is None or (not ctx.sampled
                                    and t._tail is None):
        return _NULL_SPAN
    return Span(t, ctx.child(), name, dict(attrs), ambient=False)


def annotate(**attrs):
    """Attach attributes to the current ambient span (no-op without
    one) — the hook retry/reconnect/re-resolution sites use."""
    t = _TRACER
    if t is None:
        return
    cur = t.current_span()
    if cur is not None:
        cur.attrs.update(attrs)


def current_span():
    t = _TRACER
    return t.current_span() if t is not None else None


def active_trace_id():
    """The ambient trace id when the trace is reconstructable (sampled,
    or buffered by the tail ring), or None — monitor stamps it onto
    flight-recorder rows so per-process telemetry joins the fleet
    timeline."""
    t = _TRACER
    if t is None:
        return None
    cur = t.current_span()
    if cur is None:
        return None
    if not cur.ctx.sampled and t._tail is None:
        return None
    return cur.ctx.trace_id


def tail_armed():
    """True when the armed tracer's tail ring buffers sampled-out spans
    — call sites that stamp trace ids onto telemetry widen their
    'reconstructable?' gate with this (a sampled-out trace id is still
    worth stamping if retention can promote it)."""
    t = _TRACER
    return t is not None and t._tail is not None


def retain_trace(trace_id, reason="incident"):
    """Promote a buffered trace to the span log (tail retention) —
    signals calls this with incident offender trace ids. No-op when
    disarmed / ring off / already retained; never raises."""
    t = _TRACER
    if t is None:
        return False
    return t.retain_trace(trace_id, reason)


def tail_dump(max_spans=4096):
    """This process's black-box trace snapshot ('ev'-tagged rows for
    trace.merge) — the spans part of a forensics DUMP reply. [] when
    disarmed."""
    t = _TRACER
    if t is None:
        return []
    return t.tail_dump(max_spans=max_spans)


def _parse_rate(raw):
    """PADDLE_TPU_TRACE value -> sampling rate | None (off). '1'/'true'
    arm at rate 1.0; a float in (0, 1] samples that fraction of roots."""
    raw = str(raw).strip().lower()
    if not raw or raw in ("0", "false", "off", "no"):
        return None
    if raw in ("1", "true", "on", "yes"):
        return 1.0
    try:
        rate = float(raw)
    except ValueError:
        print("paddle_tpu_torch.trace: unparseable PADDLE_TPU_TRACE=%r — "
              "tracing stays off" % raw, file=sys.stderr)
        return None
    if rate <= 0:
        return None
    return min(rate, 1.0)


def maybe_enable_from_flags():
    """Flag-driven arming (called from package import):
    ``PADDLE_TPU_TRACE[=rate]`` arms, ``PADDLE_TPU_TRACE_LOG`` names the
    span log ('{pid}' substitutes the process id — every process of a
    fleet needs its own file), ``PADDLE_TPU_TRACE_PROC`` labels the
    timeline lane."""
    from .. import flags
    try:
        rate = _parse_rate(flags.get_flag("trace"))
    except KeyError:
        return None
    if rate is None:
        return None
    log = flags.get_flag("trace_log") or "ptpu_trace_{pid}.jsonl"
    log = log.replace("{pid}", str(os.getpid()))
    proc = flags.get_flag("trace_proc") or None
    interval = flags.get_flag("trace_clock_interval")
    try:
        return enable(log_path=log, sample_rate=rate, proc=proc,
                      clock_interval=interval)
    except OSError as e:
        # tracing must never take the process down: an unwritable log
        # path leaves tracing off instead of failing the import
        print("paddle_tpu_torch.trace: span log disabled (%s); tracing stays "
              "off" % e, file=sys.stderr)
        return None
