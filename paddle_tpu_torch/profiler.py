"""Profiling API.

The counterpart of ``paddle_tpu/profiler.py``. Reference parity:
python/paddle/fluid/profiler.py:33-76 (``profiler`` context manager,
``cuda_profiler``, ``reset_profiler``) and the host RecordEvent machinery
(platform/profiler.h:26-107).

Host side, as in the JAX package: ``RecordEvent`` rows in a sorted
summary table, the chrome-trace export with its "M" metadata, the
``_TRACE_CAP`` bound with its in-band marker, ``add_span`` and
``summary``. The Executor records one ``exe.run(compiled)`` event a run
(the card synced inside it), one ``exe.run_steps(compiled)`` event a
``run_steps`` dispatch, and one ``op:<type>`` event an op.

Device side: ``profiler(state)`` with ``state`` other than ``"CPU"``,
and ``cuda_profiler`` (``tpu_profiler`` is its alias), open a
``torch.profiler.profile`` with CPU and CUDA activity when a card is
present, and write its chrome trace to ``<profile_path>/
device_trace.json`` (``cuda_profiler``: ``<output_file>/
device_trace.json``) when the block ends; each op of a run is a
``record_function("<type>.<seq>")`` range in it, the JAX package's
per-op scope name. The card is synced as the trace opens and before it
closes. The profile first runs a warm-up cycle of tiny kernels, whose
records it discards, then records; the card idles ``_TRACE_EDGE_S``
after recording starts and before it stops: the profiler's window can
open a little after its start returns, and a kernel that ran before it
would lose its record, so every kernel launched inside the block runs
inside the window. ``trace(fn, profile_path)`` does the same for one
call of ``fn``, and takes the trace again, with another call, while its
check (below) finds it incomplete, at most ``_TRACE_TRIES`` calls.
``last_device_trace()`` returns the last such profile. A failure
to open or write the device trace raises. Without a card ``profiler``
opens no device trace and ``cuda_profiler`` raises.

A closed device trace is checked for completeness
(``last_device_trace_check()``): each of the port's kernels
(``core/graphs.launch_counts``) must appear in it as many times as its
wrapper counted launches inside the block, and every kernel launch the
CUDA runtime or driver recorded outside a graph capture must have its
kernel's record. A trace that falls short warns (``RuntimeWarning``),
naming what is missing: the readings it gives under-count.

With the flag ``profile_memory`` on, every event also samples the
device's live and peak bytes (``device_memory``): on the card the caching
allocator's counts, on the CPU the bytes of the tensors the current
scope holds, with a running peak.
"""

import contextlib
import json
import os
import time
import warnings
from collections import defaultdict

import torch

__all__ = ["profiler", "tpu_profiler", "cuda_profiler", "reset_profiler",
           "start_profiler", "stop_profiler", "RecordEvent",
           "export_chrome_trace", "add_span", "summary", "device_memory",
           "last_device_trace", "last_device_trace_check", "trace"]

# name -> [count, total_s, live_bytes_last, peak_bytes_max]
_events = defaultdict(lambda: [0, 0.0, 0, 0])
_trace = []                               # (name, start_s, dur_s, thread)
_trace_dropped = 0                        # spans past the cap
_TRACE_CAP = 1_000_000                    # bound host memory on long runs
_thread_names = {}                        # thread ident -> human name
_enabled = False
_device = None            # the device of the last run under the profiler
_device_trace = None      # the open torch.profiler.profile, if any
_last_trace = None        # the last closed one
_last_check = None        # its completeness (``_check_trace``)
_ACTIVITIES = ("CPU", "CUDA")             # what a device trace records


def _note_thread():
    """Remember the current thread's NAME for the chrome-trace metadata
    lane ("M"-phase thread_name events) and return its ident."""
    import threading
    t = threading.current_thread()
    _thread_names[t.ident] = t.name
    return t.ident


def add_span(name, start_s, dur_s):
    """Append one externally-timed span to the host trace (the hook a
    runtime monitor routes its step spans through, into the same
    Perfetto timeline as RecordEvent rows). Honors the trace cap."""
    global _trace_dropped
    if not _enabled:
        return
    if len(_trace) < _TRACE_CAP:
        _trace.append((name, start_s, dur_s, _note_thread()))
    else:
        _trace_dropped += 1


def memory_enabled():
    from . import flags
    return flags.get_flag("profile_memory")


def note_device(device):
    """The device the running executor works on: the one
    ``device_memory`` reads."""
    global _device
    _device = torch.device(device)


def device_memory(device=None):
    """(live_bytes, peak_bytes) of ``device`` (default: the device of the
    last run under the profiler). On the card, the caching allocator's
    ``memory_allocated`` and ``max_memory_allocated``; on the CPU, the
    bytes of the tensors the current scope holds (peak = running max of
    live)."""
    device = torch.device(device) if device is not None else _device
    if device is not None and device.type == "cuda":
        return (int(torch.cuda.memory_allocated(device)),
                int(torch.cuda.max_memory_allocated(device)))
    from .core.scope import global_scope
    scope = global_scope()
    live = 0
    for name in scope.local_var_names():
        v = scope.find_var(name)
        if isinstance(v, torch.Tensor):
            live += v.numel() * v.element_size()
        elif hasattr(v, "nbytes"):
            live += int(v.nbytes)
    global _cpu_peak
    _cpu_peak = max(_cpu_peak, live)
    return live, _cpu_peak


_cpu_peak = 0


class RecordEvent:
    """RAII timing marker (platform/profiler.h RecordEvent parity). With
    FLAGS profile_memory on, also samples device live/peak bytes at exit
    — the FLAGS_benchmark per-op memory log of the reference
    (operator.cc:576-578), surfaced as table columns."""

    def __init__(self, name):
        self.name = name
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _enabled:
            now = time.perf_counter()
            ev = _events[self.name]
            ev[0] += 1
            ev[1] += now - self._t0
            if memory_enabled():
                live, peak = device_memory()
                ev[2] = live
                ev[3] = max(ev[3], peak)
            if len(_trace) < _TRACE_CAP:
                _trace.append((self.name, self._t0, now - self._t0,
                               _note_thread()))
            else:
                global _trace_dropped
                _trace_dropped += 1
        return False


def run_event(name, device):
    """The event of one executor run or dispatch on ``device``: while the
    profiler is on, ``RecordEvent(name)`` with the device noted and, on
    the card, synced inside the event (so the row records the run's time
    and not its launch); a no-op context while it is off."""
    if not _enabled:
        return contextlib.nullcontext()
    return _run_event(name, torch.device(device))


@contextlib.contextmanager
def _run_event(name, device):
    note_device(device)
    with RecordEvent(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def op_event(ctx, op):
    """The event of one op lowered in ``ctx``: while the profiler is on,
    ``RecordEvent("op:<type>")`` and, under a device trace,
    ``record_function("<type>.<seq>")`` too, the JAX package's per-op
    scope name. With the ``profile_memory`` flag the card is synced
    before the event's memory sample, so the bytes are this op's (not
    inside a CUDA graph capture, which may not sync). A no-op context
    while the profiler is off."""
    if not _enabled:
        return contextlib.nullcontext()
    return _op_event(ctx, op)


@contextlib.contextmanager
def _op_event(ctx, op):
    seq = getattr(ctx, "_op_seq", 0)
    ctx._op_seq = seq + 1
    with RecordEvent("op:%s" % op.type), \
            device_range("%s.%d" % (op.type, seq)):
        yield
        if ctx.device.type == "cuda" and memory_enabled() and \
                not torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize(ctx.device)


def device_range(name):
    """``torch.profiler.record_function(name)`` while a device trace is
    open, else a no-op context."""
    if _device_trace is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def reset_profiler():
    global _trace_dropped
    _events.clear()
    del _trace[:]
    _thread_names.clear()
    _trace_dropped = 0


def export_chrome_trace(path):
    """Write recorded host events as a chrome://tracing / Perfetto JSON
    file (tools/timeline.py parity; the device trace is written apart, by
    ``profiler``/``cuda_profiler``). "M"-phase metadata names the process
    and every thread lane (the reference's timeline.py _allocate_pids
    device/thread naming), so Perfetto shows "MainThread" instead of raw
    thread idents."""
    import json
    events = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
               "args": {"name": "paddle_tpu host"}}]
    if _trace_dropped:
        # machine-readable completeness record alongside the visible
        # instant marker below: tools checking args know EXACTLY how
        # many spans a capped trace is missing
        events.append({"name": "trace_dropped", "ph": "M", "pid": 0,
                       "tid": 0,
                       "args": {"trace_dropped": _trace_dropped,
                                "trace_cap": _TRACE_CAP}})
    seen_tids = {tid for _, _, _, tid in _trace}
    for tid in sorted(seen_tids):
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": tid,
                       "args": {"name": _thread_names.get(
                           tid, "thread-%d" % tid)}})
    events += [{"name": name, "ph": "X", "pid": 0, "tid": tid,
                "ts": start * 1e6, "dur": dur * 1e6,
                "cat": "host"}
               for name, start, dur, tid in _trace]
    if _trace_dropped:
        # surface the cap: a truncated timeline must say so in-band
        events.append({"name": "TRACE TRUNCATED: %d spans dropped past "
                               "the %d cap" % (_trace_dropped, _TRACE_CAP),
                       "ph": "i", "pid": 0, "tid": 0,
                       "ts": (_trace[-1][1] + _trace[-1][2]) * 1e6
                       if _trace else 0, "s": "g", "cat": "host"})
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)


def summary():
    """Host-trace accounting: recorded event names, span count, and —
    so a capped trace is visibly incomplete rather than silently short
    — the spans dropped past the _TRACE_CAP bound."""
    return {"event_names": len(_events),
            "total_calls": sum(v[0] for v in _events.values()),
            "spans": len(_trace),
            "trace_cap": _TRACE_CAP,
            "trace_dropped": _trace_dropped,
            "truncated": _trace_dropped > 0}


def start_profiler(state="All"):
    global _enabled
    _enabled = True


def stop_profiler(sorted_key=None, profile_path="/tmp/profile"):
    global _enabled
    _enabled = False
    with_mem = memory_enabled() or any(
        v[3] for v in _events.values())
    rows = [(name, cnt, tot, tot / cnt if cnt else 0.0, live, peak)
            for name, (cnt, tot, live, peak) in _events.items()]
    key = {"total": 2, "calls": 1, "name": 0, "ave": 3,
           None: 2}.get(sorted_key, 2)
    rows.sort(key=lambda r: r[key], reverse=key != 0)
    header = "%-40s %10s %14s %14s" % ("Event", "Calls", "Total(s)",
                                       "Avg(s)")
    if with_mem:
        header += " %14s %14s" % ("Live(MB)", "PeakHBM(MB)")
    lines = [header]
    for name, cnt, tot, avg, live, peak in rows:
        line = "%-40s %10d %14.6f %14.6f" % (name, cnt, tot, avg)
        if with_mem:
            line += " %14.2f %14.2f" % (live / 1e6, peak / 1e6)
        lines.append(line)
    if _trace_dropped:
        lines.append("TRACE TRUNCATED: %d span(s) dropped past the %d "
                     "cap — the table above is complete, the chrome "
                     "trace is not" % (_trace_dropped, _TRACE_CAP))
    report = "\n".join(lines)
    try:
        with open(profile_path + ".txt", "w") as f:
            f.write(report)
    except OSError:
        pass
    print(report)
    return rows


# each port kernel's launch counter (core/graphs.launch_counts) -> the
# name its kernel's records carry in a device trace
_KERNEL_NAMES = {"flash_fwd": "flash_fwd_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                 "matmul_stats": "matmul_stats_kernel",
                 "paged_attention": "paged_attention_kernel",
                 "dropout": "dropout_kernel",
                 "lstm_cell": "lstm_cell_"}


# host idle at each edge of a device trace's window, in seconds: the
# profiler drops the records of kernels that ran before its window opened
# by its own clock, and the window can open a little after the profile's
# start returns (on an H100, 4 of 120 bare passes of trace_window_probe.py
# lost their first kernels' records, and none of 120 passes padded so)
_TRACE_EDGE_S = 0.05
# kernels launched in the trace's warm-up cycle, whose records the
# profiler discards: in a process that has traced many times before, the
# first ~30 kernel records of a session were lost even 56 ms into a
# padded window (chip_smoke.py phase 18 (a') on an H100)
_TRACE_PRIMING = 128
# calls of its block trace() traces before it keeps an incomplete trace
_TRACE_TRIES = 3


def _prime_card():
    """Launch ``_TRACE_PRIMING`` tiny kernels and wait for them."""
    if "CUDA" not in _ACTIVITIES or not torch.cuda.is_initialized():
        return
    t = torch.zeros(1, device="cuda")
    for _ in range(_TRACE_PRIMING):
        t.add_(1.0)
    torch.cuda.synchronize()


@contextlib.contextmanager
def _device_trace_to(path, warn=True):
    """A ``torch.profiler.profile`` of CPU and CUDA activity around the
    block, its chrome trace written to ``<path>/device_trace.json`` and
    checked (``_check_trace``) against the kernel launches counted in
    the block; an incomplete trace warns when ``warn``. The profile runs
    a warm-up cycle first (tiny kernels whose records it discards), then
    records the block; the card is idle for ``_TRACE_EDGE_S`` on both
    sides of the block, so each of its kernels lies inside the recorded
    window."""
    global _device_trace, _last_trace, _last_check
    from .core.graphs import launch_counts
    os.makedirs(path, exist_ok=True)
    prof = torch.profiler.profile(
        activities=[getattr(torch.profiler.ProfilerActivity, a)
                    for a in _ACTIVITIES],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                         repeat=1))
    _sync_card()
    before = launch_counts()
    prof.__enter__()
    _device_trace = prof
    try:
        _prime_card()
        prof.step()             # the warm-up cycle ends: recording starts
        time.sleep(_TRACE_EDGE_S)
        yield prof
        _sync_card()
        time.sleep(_TRACE_EDGE_S)
    finally:
        _device_trace = None
        prof.__exit__(None, None, None)
        _last_trace = prof
    after = launch_counts()
    out = os.path.join(path, "device_trace.json")
    prof.export_chrome_trace(out)
    _last_check = _check_trace(out, {k: after[k] - before[k]
                                     for k in after})
    if warn and not _last_check["complete"]:
        warnings.warn(
            "the device trace %s is incomplete: %s" % (out, _last_check),
            RuntimeWarning, stacklevel=3)


def _sync_card():
    """Wait for the card's queued work, if the process has used it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _check_trace(path, launched):
    """The completeness of the chrome trace at ``path``: {"kernels":
    {counter: {"launched": n, "traced": m}} for each port kernel launched
    in the block, "unmatched_launches": the kernel launches the CUDA
    runtime or driver recorded, outside a graph capture, whose kernel has
    no record, "unmatched_at_ms": the earliest and the latest of their
    times from the trace's first event, "complete": whether nothing is
    missing}."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    kernels = {k: {"launched": n, "traced": 0}
               for k, n in launched.items() if n}
    recorded, launches, captures = set(), [], []
    for ev in events:
        cat, name = str(ev.get("cat", "")), str(ev.get("name", ""))
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "kernel":
            recorded.add(corr)
            for k, row in kernels.items():
                if _KERNEL_NAMES[k] in name:
                    row["traced"] += 1
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "LaunchKernel" in name:
                launches.append((ev.get("ts", 0), ev.get("tid"), corr))
            elif "BeginCapture" in name or "EndCapture" in name:
                captures.append((ev.get("ts", 0), ev.get("tid"),
                                 "Begin" in name))
    spans, open_at = [], {}
    for ts, tid, begin in sorted(captures, key=lambda c: c[0]):
        if begin:
            open_at[tid] = ts
        elif tid in open_at:
            spans.append((tid, open_at.pop(tid), ts))
    spans += [(tid, ts, float("inf")) for tid, ts in open_at.items()]
    t0 = min((ev["ts"] for ev in events if "ts" in ev), default=0)
    missing = [ts for ts, tid, corr in launches if corr not in recorded
               and not any(t == tid and a <= ts <= b for t, a, b in spans)]
    return {"kernels": kernels, "unmatched_launches": len(missing),
            "unmatched_at_ms": [(ts - t0) / 1e3 for ts in
                                (min(missing), max(missing))]
            if missing else [],
            "complete": not missing and all(
                r["traced"] >= r["launched"] for r in kernels.values())}


def last_device_trace():
    """The ``torch.profiler.profile`` of the last closed device trace, or
    None."""
    return _last_trace


def last_device_trace_check():
    """The completeness of the last closed device trace
    (``_check_trace``), or None."""
    return _last_check


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path="/tmp/profile"):
    """Host summary, and (``state`` not ``"CPU"``, a card present) the
    device trace written to ``<profile_path>/device_trace.json``."""
    trace = contextlib.nullcontext()
    if state in ("All", "GPU", "TPU") and torch.cuda.is_available():
        trace = _device_trace_to(profile_path)
    with trace:
        start_profiler(state)
        try:
            yield
        finally:
            stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """Device-trace-only context (the reference's ``cuda_profiler``): the
    trace goes to ``<output_file>/device_trace.json``. Raises without a
    card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cuda_profiler traces the CUDA card, and none is available")
    with _device_trace_to(output_file):
        yield


tpu_profiler = cuda_profiler


def trace(fn, profile_path):
    """Call ``fn()`` under the device trace ``cuda_profiler`` opens,
    written to ``<profile_path>/device_trace.json``, and return what it
    returned. A trace whose check finds it incomplete is taken again
    with another call of ``fn``, at most ``_TRACE_TRIES`` calls: the
    last check (``last_device_trace_check()``) says under ``"passes"``
    how many, and warns as ``cuda_profiler``'s does when it is still
    incomplete. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "profiler.trace traces the CUDA card, and none is available")
    for passes in range(1, _TRACE_TRIES + 1):
        with _device_trace_to(profile_path, warn=passes == _TRACE_TRIES):
            out = fn()
        if _last_check["complete"]:
            break
    _last_check["passes"] = passes
    return out
