"""Flight recorder: bounded, structured JSONL log of run events.

The port's copy of ``paddle_tpu/monitor/recorder.py`` (pure Python).

The black-box half of paddle_tpu_torch.monitor: every structured event (run
metadata, per-step timing, compile/recompile, NaN-guard trips, stalls)
is one JSON object per line, written synchronously under a lock (events
are rare relative to their cost budgets: a step event per training step,
a compile event per recompilation). Bounded: past ``max_bytes`` the
recorder stops writing payload events and appends a single final
``truncated`` line carrying the dropped-event count, so a runaway run
cannot fill a disk while the log stays machine-parseable end to end.

Schema (every line):
  {"ts": <epoch seconds float>, "ev": "<type>", ...fields}
Event types written by the runtime:
  run_meta | devices | step | compile | xla_compile | nan_guard |
  stall | note | truncated
Event types written by the resilience tier (paddle_tpu_torch.resilience):
  fault | retry | reconnect | rollback | resume | checkpoint
Event types written by the serving tier (paddle_tpu_torch.serving):
  serving_step     one engine iteration (active/slots/queue_depth/
                   emitted/admitted/retired/dt, ambient trace id)
  serving_request  one request retired or failed (queue_wait/ttft/
                   tpot/tokens/prefill_chunks/prompt_len, the
                   REQUEST's trace id, error when failed)
"""

import collections
import json
import os
import threading
import time
import uuid

__all__ = ["FlightRecorder"]


def percentile_sorted(sorted_vals, q):
    """Nearest-rank percentile over an ASCENDING list; None when empty.
    Shared by the monitor and trace CLIs summarizing these logs."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]

_DEFAULT_MAX_BYTES = 64 << 20


_DEFAULT_RING = 2048


class FlightRecorder:
    def __init__(self, path, max_bytes=_DEFAULT_MAX_BYTES,
                 ring=_DEFAULT_RING):
        self.path = path
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._bytes = 0
        self._dropped = 0
        self._truncated_written = False
        # bounded in-memory tail of recent events, each stamped with a
        # monotonically increasing sequence number: the live scrape
        # surface (rpc METR serves "rows since cursor" from here, so a
        # fleet collector streams events without tailing N files). It
        # keeps filling past the on-disk byte cap — the cap bounds the
        # DISK, the ring is bounded by construction. ring_id names THIS
        # recorder's sequence space: monitor.enable() replaces the
        # recorder (sequence restarts) without the process restarting,
        # and a scraper whose cursor came from the OLD ring must learn
        # its cursor is meaningless rather than silently filter every
        # new row against it.
        self.ring_id = uuid.uuid4().hex[:12]
        self._ring = collections.deque(maxlen=int(ring))
        self._seq = 0
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        # append mode: the byte budget must count what is ALREADY in the
        # file, or every re-enable()/restart hands the same log a fresh
        # max_bytes and the disk-bound guarantee is gone
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            pass
        self._f = open(path, "a", buffering=1)

    def record(self, ev, **fields):
        """Append one event. Non-JSON-able field values degrade to their
        repr — a telemetry write must never throw into the hot path."""
        rec = {"ts": time.time(), "ev": str(ev)}
        rec.update(fields)
        try:
            line = json.dumps(rec)
        except (TypeError, ValueError):
            rec = {k: (v if isinstance(
                v, (str, int, float, bool, type(None))) else repr(v))
                for k, v in rec.items()}
            line = json.dumps(rec)
        # budget in ENCODED bytes (json.dumps default-escapes to ASCII,
        # but field values may carry multibyte text; getsize() at open
        # is bytes too, so the units must match)
        nb = len(line.encode("utf-8", "surrogatepass")) + 1
        with self._lock:
            if self._f is None:
                return False
            # the ring sees every event the recorder accepted, byte
            # cap or not. It stores the ENCODED line (the same bytes
            # the file gets, degraded reprs included): parsing happens
            # at scrape time in events_since — bounded by the ring and
            # rare — not once per hot-path record
            self._seq += 1
            self._ring.append((self._seq, line))
            if self._truncated_written:
                # the truncated marker is FINAL: smaller events after a
                # large overflowing one must not slip in past it, or the
                # marker lies about where recording stopped
                self._dropped += 1
                return False
            if self._bytes + nb > self.max_bytes:
                self._dropped += 1
                # in-band cap marker (profiler TRACE TRUNCATED parity)
                self._truncated_written = True
                tr = json.dumps({"ts": time.time(), "ev": "truncated",
                                 "max_bytes": self.max_bytes})
                try:
                    self._f.write(tr + "\n")
                except OSError:
                    pass                 # see below: never throw
                self._bytes += len(tr) + 1
                return False
            try:
                self._f.write(line + "\n")
            except OSError:
                # the never-throw contract covers the WRITE too: a full
                # disk must degrade to a counted drop, not propagate
                # into an engine loop / executor step and strand its
                # callers (the serving scheduler pops finished requests
                # before recording them)
                self._dropped += 1
                return False
            self._bytes += nb
            return True

    @property
    def dropped(self):
        with self._lock:
            return self._dropped

    def events_since(self, cursor=None):
        """Ring rows newer than ``cursor`` (a sequence number from a
        previous call; None = everything still in the ring). Returns
        ``(new_cursor, rows, lost)`` where ``lost`` counts rows that
        aged out of the bounded ring between scrapes — a slow scraper
        learns it missed events instead of silently under-counting."""
        with self._lock:
            if cursor is None:
                rows = list(self._ring)
                lost = 0
            else:
                cursor = int(cursor)
                rows = [(s, r) for s, r in self._ring if s > cursor]
                oldest = self._ring[0][0] if self._ring else \
                    self._seq + 1
                lost = max(0, oldest - cursor - 1)
            new_cursor = rows[-1][0] if rows else \
                (self._seq if cursor is None else max(cursor,
                                                      self._seq))
        # parse OUTSIDE the lock: a full-ring scrape decodes up to
        # `ring` lines, and record() on the hot path must not wait
        # behind it
        return new_cursor, [json.loads(r) for _, r in rows], lost

    def flush(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self):
        # no trailing note: the truncated marker (written at the first
        # drop) is the documented FINAL line of a capped log; the
        # in-process drop count stays readable via .dropped
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.close()
            finally:
                self._f = None


def read_jsonl_tolerant(path):
    """Parse a flight-recorder / span log that may still be LIVE: a
    writer killed mid-record leaves a truncated trailing line (and a
    crash mid-flush can tear an interior one). Malformed lines are
    skipped and counted, not fatal. Returns (events, skipped)."""
    events, skipped = [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if not isinstance(rec, dict) or "ts" not in rec \
                    or "ev" not in rec:
                skipped += 1
                continue
            events.append(rec)
    return events, skipped


def read_jsonl(path):
    """Parse a flight-recorder log → list of event dicts. Raises
    ValueError naming the first malformed line (schema guarantee the
    tests pin)."""
    events = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    "%s line %d is not valid JSON: %s" % (path, i + 1, e))
            if not isinstance(rec, dict) or "ts" not in rec \
                    or "ev" not in rec:
                raise ValueError(
                    "%s line %d missing ts/ev fields" % (path, i + 1))
            events.append(rec)
    return events
