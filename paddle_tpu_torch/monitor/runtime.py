"""Monitor runtime: the glue between the metrics registry, the flight
recorder, the stall watchdog, and the executors' hot paths.

The port's copy of ``paddle_tpu/monitor/runtime.py``, with the same
hooks, metric names and recorder rows. Where the JAX package asks jax,
the port asks torch: the ``devices`` row names the CUDA card
(``torch.cuda.get_device_name``, ``device_count``), device memory is
the caching allocator's ``memory_allocated`` /
``max_memory_allocated``, and the compile-time durations that
``jax.monitoring`` reports there are reported here by the Executor
itself (``on_compile_phase``: its step-plan build and its CUDA-graph
capture), under the same metric. The MFU gauge needs a cost function
(``on_compile(cost_fn=...)``), which the port's Executor does not pass
until the static cost model is ported (ROADMAP.md queue 1 item 11):
until then the gauge stays unset. ``peak_flops`` comes only from
``enable(peak_flops=)``/``set_peak_flops`` or the ``monitor_peak_flops``
flag.

`enable()` arms the subsystem; until then every executor hook is one
boolean check (`enabled()`), so an unmonitored run pays nothing. Armed,
each `Executor.run` / `ParallelExecutor.run` reports:

  * a step-latency observation (histogram + flight-recorder `step` line),
  * compile-cache hit/miss and RECOMPILE counters classified against the
    executor's own cache key — a recompile names which key component
    moved (feed signature / program version / options), the #1 silent
    throughput killer the static analyzer can only warn about,
  * feed-upload bytes (host arrays crossing to the device),
  * derived gauges: achieved MFU and tokens/s (static FLOPs per step
    from a cost function handed to ``on_compile``, priced once per
    compile), and device live/peak memory.

Compile wall time (the step-plan build and the CUDA-graph capture)
lands in ``ptpu_xla_compile_seconds`` under the JAX package's name, so a
fleet-level dashboard scrapes one metric from either package.
"""

import collections
import os
import sys
import threading
import time
import weakref

from . import metrics as _metrics
from .recorder import FlightRecorder
from .watchdog import Watchdog

__all__ = [
    "enable", "disable", "enabled", "recorder", "set_peak_flops",
    "set_tokens_per_step", "on_compile", "on_step", "on_nan_trip",
    "on_retry", "on_reconnect", "on_fault", "on_rollback", "on_resume",
    "on_checkpoint", "on_serving_step", "on_serving_request",
    "on_spec", "on_alert",
    "on_feed_plan", "on_megastep", "on_transform", "on_sparse_lookup",
    "on_sparse_evictions", "on_sparse_prefetch", "on_sparse_staleness",
    "summary", "session", "prometheus_text", "dump_metrics",
]

_REG = _metrics.registry()

# -- metric declarations (import-time, cheap, shared) ----------------------
STEPS = _REG.counter("ptpu_steps_total",
                     "completed executor steps", ("executor",))
STEP_SECONDS = _REG.histogram("ptpu_step_seconds",
                              "wall time of one executor step",
                              ("executor",))
CACHE_HITS = _REG.counter("ptpu_compile_cache_hits_total",
                          "compiled-step cache hits")
CACHE_MISSES = _REG.counter("ptpu_compile_cache_misses_total",
                            "compiled-step cache misses (traces+compiles)")
COMPILES = _REG.counter("ptpu_compiles_total",
                        "program compiles by cause", ("reason",))
RECOMPILES = _REG.counter(
    "ptpu_recompiles_total",
    "compiles of a program ALREADY compiled under another key — each one "
    "burned compile time that better feed bucketing could have saved")
FEED_BYTES = _REG.counter("ptpu_feed_bytes_total",
                          "host feed bytes uploaded to the device")
NAN_TRIPS = _REG.counter("ptpu_nan_guard_trips_total",
                         "NaN/Inf guard trips", ("where",))
XLA_COMPILE_SECONDS = _REG.histogram(
    "ptpu_xla_compile_seconds",
    "compile wall time (the Executor's step-plan build and CUDA-graph "
    "capture; the JAX package's XLA compile phases)", ("what",))
HBM_LIVE = _REG.gauge("ptpu_device_bytes_in_use", "device bytes live")
HBM_PEAK = _REG.gauge("ptpu_device_bytes_peak", "device bytes peak")
MFU = _REG.gauge("ptpu_mfu",
                 "achieved fraction of peak FLOP/s for the last step")
TOKENS_PER_SEC = _REG.gauge("ptpu_tokens_per_sec",
                            "tokens processed per second, last step")
STEP_FLOPS = _REG.gauge("ptpu_step_flops",
                        "static cost-model FLOPs of the cached step")
STALLS = _REG.counter("ptpu_stalls_total", "watchdog stall reports")
# resilience tier (paddle_tpu_torch.resilience): like the distributed-runtime
# counters these record unconditionally — a retry storm must be visible
# even when nobody armed the monitor beforehand
RETRIES = _REG.counter("ptpu_retries_total",
                       "retry-policy re-issues of idempotent client "
                       "verbs", ("what",))
RECONNECTS = _REG.counter("ptpu_reconnects_total",
                          "client transparent reconnects", ("what",))
FAULTS = _REG.counter("ptpu_fault_injections_total",
                      "armed fault-plan injections", ("kind",))
ROLLBACKS = _REG.counter("ptpu_rollbacks_total",
                         "resilient_loop rollback-and-skip recoveries",
                         ("reason",))
RESUMES = _REG.counter("ptpu_resumes_total",
                       "resilient_loop auto-resumes from checkpoint")
CHECKPOINTS = _REG.counter("ptpu_checkpoints_total",
                           "resilient_loop checkpoints by mode",
                           ("mode",))
# distributed-tracing tier (paddle_tpu_torch.trace): spans land in the span
# log; these counters make span volume and log-cap losses scrapeable
TRACE_SPANS = _REG.counter("ptpu_trace_spans_total",
                           "distributed-trace spans recorded", ("proc",))
TRACE_DROPPED = _REG.counter(
    "ptpu_trace_dropped_total",
    "distributed-trace spans lost (span log capped or absent)")
TRACE_RETAINED = _REG.counter(
    "ptpu_trace_retained_total",
    "traces retroactively promoted to the span log by tail-based "
    "retention (root error / slow root / incident offender)",
    ("reason",))
# serving tier (paddle_tpu_torch.serving): continuous-batching engine health.
# Counters tick unconditionally (sub-microsecond next to a decode step);
# the gauges make queue pressure and batch utilization scrapeable live
SERVING_QUEUE_DEPTH = _REG.gauge(
    "ptpu_serving_queue_depth",
    "requests waiting for a decode slot")
SERVING_SLOT_OCCUPANCY = _REG.gauge(
    "ptpu_serving_slot_occupancy",
    "fraction of decode slots active in the last engine step")
SERVING_TOKENS = _REG.counter(
    "ptpu_serving_tokens_total",
    "tokens emitted by the continuous-batching engine")
SERVING_ADMISSIONS = _REG.counter(
    "ptpu_serving_admissions_total",
    "requests admitted into a decode slot")
SERVING_RETIREMENTS = _REG.counter(
    "ptpu_serving_retirements_total",
    "requests retired from a decode slot (EOS or max_new)")
SERVING_FAILURES = _REG.counter(
    "ptpu_serving_request_failures_total",
    "requests failed (engine closed or loop death) — the SLO error "
    "budget numerator")
# request-level latency attribution: the three figures a
# serving SLO is written against, observed once per request retirement
SERVING_TTFT = _REG.histogram(
    "ptpu_serving_ttft_seconds",
    "request time-to-first-token (submit -> first decoded token)",
    ("engine",))
SERVING_TPOT = _REG.histogram(
    "ptpu_serving_tpot_seconds",
    "mean per-token decode latency after the first token", ("engine",))
SERVING_QUEUE_WAIT = _REG.histogram(
    "ptpu_serving_queue_wait_seconds",
    "request wait from submit to decode-slot admission", ("engine",))
# paged-KV / prefix-cache tier: pool pressure and reuse.
# Gauges reflect the engine's last iteration; counters accumulate
KV_BLOCKS_TOTAL = _REG.gauge(
    "ptpu_kv_blocks_total",
    "physical blocks in the paged KV pool")
KV_BLOCKS_USED = _REG.gauge(
    "ptpu_kv_blocks_used",
    "paged KV blocks referenced by live requests or the prefix cache")
# effective-bytes companions: block counts x the engine's
# quantization-aware bytes_per_block, so watch/SLO read real HBM — a
# quantized pool reports its smaller footprint day one
KV_BYTES_TOTAL = _REG.gauge(
    "ptpu_kv_bytes_total",
    "HBM bytes the paged KV pool reserves (quantization-aware)")
KV_BYTES_USED = _REG.gauge(
    "ptpu_kv_bytes_used",
    "HBM bytes of paged KV blocks currently referenced "
    "(quantization-aware)")
PREFIX_HITS = _REG.counter(
    "ptpu_prefix_cache_hits_total",
    "admissions whose prompt matched a cached prefix chain (those "
    "prefill chunks are skipped)")
PREFIX_MISSES = _REG.counter(
    "ptpu_prefix_cache_misses_total",
    "admissions with no cached prefix (cold prefill)")
PREFIX_EVICTIONS = _REG.counter(
    "ptpu_prefix_cache_evictions_total",
    "prefix-cache blocks LRU-freed under pool pressure")
SERVING_PREEMPTIONS = _REG.counter(
    "ptpu_serving_preemptions_total",
    "requests preempted (blocks freed, re-queued for re-prefill) "
    "when the KV pool ran dry")
# speculative decode tier: tokens drafted vs accepted and
# the dispatches that verified them — acceptance rate is
# accepted/drafted, accepted tokens per dispatch the bs1-floor lever
SPEC_DRAFTED = _REG.counter(
    "ptpu_spec_drafted_tokens_total",
    "draft tokens proposed to speculative scoring dispatches")
SPEC_ACCEPTED = _REG.counter(
    "ptpu_spec_accepted_tokens_total",
    "draft tokens accepted by the model's own (greedy/seeded-sampled) "
    "tokens — each one is a decode step the dispatch floor never saw")
SPEC_DISPATCHES = _REG.counter(
    "ptpu_spec_dispatches_total",
    "speculative scoring dispatches (each verifies gamma+1 positions "
    "per live slot and emits 1..gamma+1 tokens per slot)")
SERVING_STEP_SECONDS = _REG.histogram(
    "ptpu_serving_step_seconds",
    "wall time of one engine iteration (prefill chunk + decode step; "
    "the wait-for-batch admission window is policy, not latency, and "
    "is excluded) — the serving analogue of ptpu_step_seconds, so an "
    "SLO step_latency objective gates the SAME quantity from a "
    "metrics snapshot as from the recorder rows", ("engine",))
# megastep execution: K logical steps fused into ONE device
# dispatch (Executor.run_steps / ParallelExecutor.run_steps /
# serving.Engine megastep). Latency/MFU/tokens-s figures stay PER
# LOGICAL STEP (the megastep wall time divided by K) so dashboards and
# SLO step_latency gates read the same quantity at any K; these two
# counters make the fusion itself scrapeable (dispatch tax saved =
# steps_total - dispatches_total host round-trips)
MEGASTEP_DISPATCHES = _REG.counter(
    "ptpu_megastep_dispatches_total",
    "fused K-step device dispatches (K > 1)", ("executor",))
MEGASTEP_STEPS = _REG.counter(
    "ptpu_megastep_steps_total",
    "logical steps advanced inside fused K-step dispatches",
    ("executor",))
# feed-plan cache (core/executor): a normalization is the full per-call
# feed re-marshal the JAX package measured; a plan hit skipped it
FEED_NORMALIZATIONS = _REG.counter(
    "ptpu_feed_normalizations_total",
    "full _normalize_feeds derivations (feed-plan cache misses or "
    "uncached callers)")
FEED_PLAN_HITS = _REG.counter(
    "ptpu_feed_plan_hits_total",
    "feed-plan cache hits (per-call feed normalization skipped)")
# program-transform tier (paddle_tpu.transform): optimizing-pass
# activity. Counters tick unconditionally (transforms run per compile,
# not per step); the flight-recorder row lands only when armed
TRANSFORM_PASSES = _REG.counter(
    "ptpu_transform_passes_total",
    "optimizing-pass rewrite phases executed over a Program",
    ("pass",))
TRANSFORM_OPS_REMOVED = _REG.counter(
    "ptpu_transform_ops_removed_total",
    "ops removed or rewritten by an optimizing pass", ("pass",))
TRANSFORM_PATTERNS = _REG.counter(
    "ptpu_transform_patterns_total",
    "fusion-pattern hits by pattern name (transform/fusion.py)",
    ("pattern",))
# sparse serving tier (paddle_tpu_torch.serving.sparse): the hot-ID
# embedding cache in front of the live pserver shards, and the online-
# learning loop's read-your-writes staleness. Counters tick
# unconditionally (a dict probe is nothing next to a PRFT round trip);
# the staleness histogram backs the SLO `staleness_s` objective from a
# metrics snapshot the same way the latency histograms back TTFT
SPARSE_CACHE_HITS = _REG.counter(
    "ptpu_sparse_cache_hits_total",
    "embedding rows served from the hot-ID cache (no wire)")
SPARSE_CACHE_MISSES = _REG.counter(
    "ptpu_sparse_cache_misses_total",
    "embedding rows fetched from a pserver shard (cache cold)")
SPARSE_CACHE_STALE = _REG.counter(
    "ptpu_sparse_cache_stale_total",
    "cached rows re-fetched because they aged past the staleness "
    "bound or their shard's version/incarnation moved")
SPARSE_CACHE_EVICTIONS = _REG.counter(
    "ptpu_sparse_cache_evictions_total",
    "hot-ID cache rows evicted (LRU capacity or shard invalidation)")
SPARSE_PREFETCH_ROWS = _REG.counter(
    "ptpu_sparse_prefetch_rows_total",
    "embedding rows pulled over the PRFT wire (deduplicated, batched)")
SPARSE_PREFETCH_BYTES = _REG.counter(
    "ptpu_sparse_prefetch_bytes_total",
    "embedding row payload bytes pulled over the PRFT wire")
SPARSE_STALENESS = _REG.histogram(
    "ptpu_sparse_staleness_seconds",
    "read-your-writes staleness: an online update landing on the "
    "pservers -> the first serve whose rows reflect it", ("table",))
# alerting tier (paddle_tpu_torch.monitor.signals): exactly-once
# FIRING/RESOLVED edges from the streaming rule engine. The counter
# ticks unconditionally (transitions are rare by hysteresis
# construction); the gauge is the evaluating process's live count
ALERT_TRANSITIONS = _REG.counter(
    "ptpu_alert_transitions_total",
    "alert state transitions emitted by the monitor.signals rule "
    "engine", ("rule", "severity", "state"))
ALERTS_ACTIVE = _REG.gauge(
    "ptpu_alerts_active",
    "alerts currently FIRING in this process's signals evaluator")
# elastic fleet tier (serving.autoscale): the control loop's
# desired count, scale events, graceful drains and rolling weight
# updates. Counters tick unconditionally (scale events are rare);
# convergence is a histogram so fleet merges stay bucket-wise
FLEET_DESIRED = _REG.gauge(
    "ptpu_fleet_desired_replicas",
    "replica count the autoscale control loop is converging toward")
FLEET_VERSION_REPLICAS = _REG.gauge(
    "ptpu_fleet_version_replicas",
    "live replicas per serving artifact version (the fleet's version "
    "mix during a rolling update)", ("version",))
FLEET_SCALE_EVENTS = _REG.counter(
    "ptpu_fleet_scale_events_total",
    "autoscale desired-count moves", ("direction", "reason"))
FLEET_DRAINS = _REG.counter(
    "ptpu_fleet_drains_total",
    "graceful replica drains started by the control loop")
FLEET_ROLLS = _REG.counter(
    "ptpu_fleet_rolls_total",
    "rolling weight updates completed (aborted rolls excluded)")
FLEET_VERSION_CONVERGENCE = _REG.histogram(
    "ptpu_fleet_version_convergence_seconds",
    "rolling update start -> 100% of the fleet serving the new "
    "artifact version")
# canary analysis plane (serving.fleet mirroring + serving.rollout):
# shadow decode volume is counted HERE, never on the
# incumbent serving counters (the failed-request exclusion
# discipline applied to mirrored traffic); joined pairs and verdicts
# are the delta-SLO evidence a rollout is gated on
MIRROR_TOKENS = _REG.counter(
    "ptpu_mirror_tokens_total",
    "tokens decoded by SHADOW candidate engines (scored, never "
    "served; deliberately excluded from ptpu_serving_tokens_total)",
    ("engine",))
MIRROR_PAIRS = _REG.counter(
    "ptpu_mirror_pairs_total",
    "joined candidate/incumbent result pairs scored by the router",
    ("router",))
ROLLOUT_VERDICTS = _REG.counter(
    "ptpu_rollout_verdicts_total",
    "exactly-once delta-SLO verdicts emitted by rollout phases",
    ("phase", "verdict"))
ROLLOUT_PHASE = _REG.gauge(
    "ptpu_rollout_phase",
    "rollout controller phase (0 idle, 1 boot, 2 shadow, 3 canary, "
    "4 rolling, 5 promoted, -1 rolled-back)")


# bound on remembered per-compile cost entries: each key tuple pins its
# Program, so an unbounded map would leak graphs in a serving loop that
# compiles per-request programs (LRU eviction keeps the hot steps priced)
_COSTS_CAP = 512


class _State:
    on = False
    rec = None            # FlightRecorder | None
    dog = None            # Watchdog | None
    reporter = None       # (thread, stop_event) | None
    peak_flops = None     # float | None (None = auto-detect)
    lock = threading.Lock()
    # per-program compile history {"versions", "sigs", "count"} — WEAK
    # keys: a discarded Program must not stay pinned (and a reused id
    # must not inherit a dead program's history)
    programs = weakref.WeakKeyDictionary()
    # cache key (by value) -> {"flops", "bytes", "tokens", "devices"}
    costs = collections.OrderedDict()
    tokens_override = None
    devices_recorded = False
    platform = None       # cached backend platform (cannot change)
    t_enable = None
    step_serial = 0


_S = _State()


def enabled():
    return _S.on


def recorder():
    return _S.rec


def set_peak_flops(value):
    """Override the device peak FLOP/s used for the MFU gauge (the
    card's peak for the step's dtype)."""
    _S.peak_flops = float(value) if value else None


def set_tokens_per_step(n):
    """Pin tokens-per-step for the tokens/s gauge, overriding the
    integer-feed-size heuristic (call with None to restore it)."""
    _S.tokens_override = int(n) if n else None


def _auto_peak_flops():
    """The ``monitor_peak_flops`` flag, or None: the port keeps no table
    of cards."""
    from .. import flags
    try:
        v = float(flags.get_flag("monitor_peak_flops"))
    except KeyError:
        v = 0.0
    return v if v > 0 else None


def enable(log_path=None, stall_timeout=None, report_interval=None,
           peak_flops=None, max_log_bytes=None):
    """Arm the monitor. Idempotent-ish: calling again replaces the
    flight recorder / watchdog configuration.

    log_path:        flight-recorder JSONL path (None = no recorder)
    stall_timeout:   seconds without a completed step/compile before the
                     watchdog dumps stacks (None/0 = no watchdog)
    report_interval: seconds between one-line console reports (None/0 =
                     no reporter thread)
    peak_flops:      device peak FLOP/s for MFU (None = auto-detect)
    """
    disable()
    with _S.lock:
        if log_path:
            _S.rec = FlightRecorder(
                log_path, max_bytes=max_log_bytes or (64 << 20))
            _S.rec.record("run_meta", **_run_meta())
        if peak_flops:
            _S.peak_flops = float(peak_flops)
        _S.devices_recorded = False
        _S.t_enable = time.monotonic()
        _S.on = True
        if stall_timeout:
            _S.dog = Watchdog(stall_timeout, _on_stall).start()
        if report_interval:
            stop = threading.Event()
            t = threading.Thread(target=_report_loop,
                                 args=(stop, float(report_interval)),
                                 daemon=True, name="ptpu-monitor-report")
            t.start()
            _S.reporter = (t, stop)


def disable():
    with _S.lock:
        _S.on = False
        if _S.dog is not None:
            _S.dog.stop()
            _S.dog = None
        if _S.reporter is not None:
            t, stop = _S.reporter
            stop.set()
            _S.reporter = None
        if _S.rec is not None:
            _S.rec.close()
            _S.rec = None


def maybe_enable_from_flags():
    """Flag-driven arming (called from package import): PADDLE_TPU_MONITOR=1
    turns the monitor on, PADDLE_TPU_MONITOR_LOG names the JSONL,
    PADDLE_TPU_MONITOR_STALL_TIMEOUT arms the watchdog."""
    from .. import flags
    try:
        if not flags.get_flag("monitor"):
            return
    except KeyError:
        return
    stall = flags.get_flag("monitor_stall_timeout") or None
    report = flags.get_flag("monitor_report_interval") or None
    try:
        enable(log_path=flags.get_flag("monitor_log") or None,
               stall_timeout=stall, report_interval=report)
    except OSError as e:
        # telemetry must never take the process down: an unwritable log
        # path degrades to metrics-only instead of failing the import
        print("paddle_tpu_torch.monitor: flight recorder disabled (%s); "
              "continuing with metrics only" % e, file=sys.stderr)
        enable(log_path=None, stall_timeout=stall,
               report_interval=report)


def _run_meta():
    """Process metadata only — deliberately NO device queries: enable()
    may run at import time (env-armed), and touching the card there
    would initialize CUDA before a launcher forks or spawns its
    workers. Device info lands in a later `devices` event
    (_maybe_record_devices) once the program is actually running."""
    meta = {"pid": os.getpid(), "argv": sys.argv[:8],
            "python": sys.version.split()[0]}
    try:
        import torch
        meta["torch"] = torch.__version__
    except Exception:
        pass
    return meta


def _maybe_record_devices():
    """Emit the one-shot `devices` event on the first step/compile —
    by then the program runs, so asking CUDA is safe. Without a card it
    names the CPU."""
    if _S.devices_recorded or _S.rec is None:
        return
    _S.devices_recorded = True
    try:
        import torch
        if torch.cuda.is_available():
            _S.rec.record("devices", platform="gpu",
                          device_kind=torch.cuda.get_device_name(0),
                          device_count=torch.cuda.device_count())
        else:
            _S.rec.record("devices", platform="cpu", device_kind="cpu",
                          device_count=1)
    except Exception:
        pass


# -- executor hooks --------------------------------------------------------

def feed_nbytes(feed_arrays, device=None):
    """Host bytes that will cross to the device this step: numpy arrays,
    and CPU tensors when the step runs on the card (a tensor already on
    its device costs nothing)."""
    import numpy as np
    import torch
    on_card = device is not None and getattr(device, "type", "") == "cuda"
    total = 0
    for v in feed_arrays.values():
        if isinstance(v, (np.ndarray, np.generic)):
            total += v.nbytes
        elif on_card and isinstance(v, torch.Tensor) \
                and v.device.type == "cpu":
            total += v.numel() * v.element_size()
    return total


def tokens_in_feeds(feed_arrays):
    """Heuristic tokens-per-step: the largest integer-dtype feed is the
    token ids (LM src [B, T], classifier labels [B, 1], ...). Dense-only
    programs report their largest leading dim (samples/step)."""
    if _S.tokens_override:
        return _S.tokens_override
    import numpy as np
    best = 0
    lead = 0
    for k, v in feed_arrays.items():
        if k.endswith("@LOD") or k.endswith("@ACCUM_TOKENS"):
            continue
        dt = getattr(v, "dtype", None)
        shape = getattr(v, "shape", ())
        if dt is not None and _is_integer(dt) and shape:
            best = max(best, int(np.prod(shape)))
        if shape:
            lead = max(lead, int(shape[0]))
    return best or lead


def _is_integer(dt):
    """A numpy or torch integer dtype."""
    import numpy as np
    if isinstance(dt, np.dtype) or isinstance(dt, type):
        return np.issubdtype(dt, np.integer)
    return not (dt.is_floating_point or dt.is_complex) \
        and str(dt) != "torch.bool"


def on_compile(program, key, feed_sig, cost_fn=None, executor="exe",
               tokens=0, devices=1):
    """Cache-miss hook: classify the compile, price the step with the
    static cost model, flight-record the event. `key` is the executor's
    cache key; `devices` is how many chips run the step (scales the
    MFU denominator — the cost model priced the GLOBAL batch)."""
    if not _S.on:
        return
    # snapshot: a concurrent disable() may null these mid-hook, and
    # telemetry must never throw into the hot path
    rec, dog = _S.rec, _S.dog
    _maybe_record_devices()
    version = getattr(program, "_version", None)
    # a PassManager-transformed clone announces itself (parent version
    # + new program_version in _transform_meta); on the ARMED executor
    # path the caller's program carries the mirrored _transform_applied
    # (the compiled body was the transformed clone even though the
    # cache key — and this hook — see the original). Either way the
    # compile is attributed to the transform instead of counting as a
    # mystery new_program, so a post-transform recompile is classified
    transform_meta = getattr(program, "_transform_meta", None) \
        or getattr(program, "_transform_applied", None)
    # classify under the lock: two threads compiling the same program
    # concurrently (a supported Executor pattern) must not both read
    # count==0 and report new_program, hiding a real recompile
    with _S.lock:
        ent = _S.programs.setdefault(
            program, {"versions": set(), "sigs": set(), "pairs": set(),
                      "count": 0})
        if ent["count"] == 0:
            reason = ("transformed_program" if transform_meta
                      else "new_program")
        elif version not in ent["versions"]:
            reason = "program_version"
        elif feed_sig not in ent["sigs"]:
            reason = "feed_signature"
        elif (version, feed_sig) not in ent["pairs"]:
            # both components seen before, just never together — the
            # key churned on their combination, not on an option flag
            reason = "key_combination"
        else:
            # same (version, sig) compiled again: an option in the key
            # (amp/check_nan/fuse flags, fetch list, state keys) moved
            reason = "options"
        recompile = ent["count"] > 0
        ent["count"] += 1
        ent["versions"].add(version)
        ent["sigs"].add(feed_sig)
        ent["pairs"].add((version, feed_sig))

    CACHE_MISSES.inc()
    COMPILES.inc(reason=reason)
    if recompile:
        RECOMPILES.inc()

    flops = nbytes = None
    if cost_fn is not None and _flag("monitor_cost_model"):
        try:
            flops, nbytes = cost_fn()   # traces — NOT under the lock
            # keyed by VALUE: each run() builds a fresh (equal) key tuple
            with _S.lock:
                _S.costs[key] = {"flops": flops, "bytes": nbytes,
                                 "tokens": tokens,
                                 "devices": max(1, devices)}
                _S.costs.move_to_end(key)
                while len(_S.costs) > _COSTS_CAP:
                    _S.costs.popitem(last=False)
            STEP_FLOPS.set(flops)
        except Exception:
            pass  # cost model is advisory; never fail a compile over it
    if dog is not None:
        dog.touch()
    if rec is not None:
        extra = {}
        if transform_meta is not None:
            extra["transform_of"] = transform_meta.get("parent_version")
        rec.record("compile", executor=executor, reason=reason,
                   recompile=recompile, program=id(program),
                   version=version, flops=flops, bytes=nbytes,
                   tokens=tokens, **extra)
    _sample_device_memory()


def on_cache_hit():
    if _S.on:
        CACHE_HITS.inc()


def sync_every():
    """The monitor_sync_every flag (>= 1), read per step (cheap)."""
    from .. import flags
    try:
        return max(1, int(flags.get_flag("monitor_sync_every")))
    except KeyError:
        return 1


class StepTimer:
    """Per-executor window state for the monitor_sync_every
    amortization, shared by Executor and ParallelExecutor (one code
    path for the windowing logic). Thread-safe: a shared executor
    driven from two threads must never crash or corrupt the window."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._t0 = None

    def begin(self, now):
        """Count this step into the window; True when the caller should
        sync (end of window)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self._count += 1
            return self._count >= sync_every()

    def end_synced(self, now, step_t0):
        """Window-average per-step seconds; resets the window. step_t0
        is the fallback base when a concurrent thread already closed
        the window (never throws into the hot path)."""
        with self._lock:
            base = self._t0 if self._t0 is not None else step_t0
            n = max(1, self._count)
            self._count = 0
            self._t0 = None
            return max(0.0, (now - base) / n)


def step_timer(obj):
    """The per-executor StepTimer, lazily attached to the instance."""
    t = obj.__dict__.get("_mon_sync")
    if t is None:
        t = obj.__dict__.setdefault("_mon_sync", StepTimer())
    return t


def on_step(key, dt, feed_bytes=0, tokens=0, executor="exe",
            synced=True):
    """Step-completion hook. synced=True: dt is real (blocked) wall
    time — feeds the latency histogram and the MFU/tokens-s gauges.
    synced=False (monitor_sync_every amortization on async pipelines):
    dt is dispatch time only — the step still counts and logs, but is
    excluded from latency/throughput derivations."""
    if not _S.on:
        return
    rec, dog = _S.rec, _S.dog    # see on_compile: disable() race
    _maybe_record_devices()
    STEPS.inc(executor=executor)
    if synced:
        STEP_SECONDS.observe(dt, executor=executor)
    if feed_bytes:
        FEED_BYTES.inc(feed_bytes)
    mfu = None
    with _S.lock:
        cost = _S.costs.get(key) if key is not None else None
        if cost is not None:
            _S.costs.move_to_end(key)   # keep hot step keys resident
    if synced and cost is not None and dt > 0:
        if _S.peak_flops is None:
            _S.peak_flops = _auto_peak_flops() or 0.0
        if _S.peak_flops:
            # whole-program FLOPs over ALL participating chips' peak
            mfu = cost["flops"] / dt \
                / (_S.peak_flops * cost.get("devices", 1))
            MFU.set(mfu)
    tps = None
    if synced and tokens and dt > 0:
        tps = tokens / dt
        TOKENS_PER_SEC.set(tps)
    if dog is not None:
        dog.touch()
    with _S.lock:
        _S.step_serial += 1
        serial = _S.step_serial
    if rec is not None:
        extra = {}
        tr = _active_trace_id()
        if tr is not None:
            # join this process's step telemetry to the fleet timeline
            extra["trace"] = tr
        rec.record("step", executor=executor, n=serial,
                   dt=dt, feed_bytes=feed_bytes, tokens=tokens,
                   mfu=mfu, tokens_per_sec=tps, synced=synced, **extra)
    # route the step span into the host profiler timeline when tracing
    from .. import profiler as _prof
    if _prof._enabled:
        _prof.add_span("monitor.step", time.perf_counter() - dt, dt)
    _sample_device_memory()


def on_megastep(key, dt, k, feed_bytes=0, tokens=0, executor="exe",
                synced=True):
    """One fused K-step dispatch (Executor.run_steps /
    ParallelExecutor.run_steps) completed in ``dt`` seconds of wall
    time. Latency, MFU and tokens/s all derive PER LOGICAL STEP — the
    megastep wall time divided by K — so dashboards, the monitor CLI
    and SLO step_latency gates read the same quantity at any K. The
    compile-time cost entry for ``key`` priced the WHOLE megastep (K
    scanned steps), so MFU uses the full dt. ``tokens`` is the total
    across all K logical steps."""
    if not _S.on:
        return
    rec, dog = _S.rec, _S.dog    # see on_compile: disable() race
    _maybe_record_devices()
    k = max(1, int(k))
    per = dt / k
    STEPS.inc(k, executor=executor)
    MEGASTEP_DISPATCHES.inc(executor=executor)
    MEGASTEP_STEPS.inc(k, executor=executor)
    if synced:
        for _ in range(k):
            STEP_SECONDS.observe(per, executor=executor)
    if feed_bytes:
        FEED_BYTES.inc(feed_bytes)
    mfu = None
    with _S.lock:
        cost = _S.costs.get(key) if key is not None else None
        if cost is not None:
            _S.costs.move_to_end(key)
    if synced and cost is not None and dt > 0:
        if _S.peak_flops is None:
            _S.peak_flops = _auto_peak_flops() or 0.0
        if _S.peak_flops:
            mfu = cost["flops"] / dt \
                / (_S.peak_flops * cost.get("devices", 1))
            MFU.set(mfu)
    tps = None
    if synced and tokens and dt > 0:
        tps = tokens / dt
        TOKENS_PER_SEC.set(tps)
    if dog is not None:
        dog.touch()
    with _S.lock:
        _S.step_serial += k
        serial = _S.step_serial
    if rec is not None:
        extra = {}
        tr = _active_trace_id()
        if tr is not None:
            extra["trace"] = tr
        # ONE row per dispatch; dt is the PER-LOGICAL-STEP figure the
        # CLI/SLO surfaces gate, megastep_dt the raw dispatch wall time
        rec.record("step", executor=executor, n=serial, dt=per, k=k,
                   megastep_dt=dt, feed_bytes=feed_bytes, tokens=tokens,
                   mfu=mfu, tokens_per_sec=tps, synced=synced, **extra)
    _sample_device_memory()


def on_nan_trip(where, detail=""):
    if not _S.on:
        return
    rec = _S.rec
    NAN_TRIPS.inc(where=where)
    if rec is not None:
        rec.record("nan_guard", where=where, detail=detail)


# -- resilience hooks (paddle_tpu_torch.resilience: retry/faults/driver) ---------
# Counters always tick (sub-microsecond next to a socket error or an
# fsync); flight-recorder events land only when a recorder is armed.

def _active_trace_id():
    """Sampled ambient paddle_tpu_torch.trace id (None when disarmed) —
    stamped on flight-recorder rows so per-process telemetry joins the
    merged fleet timeline. Inline import: trace imports monitor."""
    from ..trace import runtime as _trace
    return _trace.active_trace_id()


def _trace_extra():
    tr = _active_trace_id()
    return {} if tr is None else {"trace": tr}


def on_retry(what, attempt, error=None):
    RETRIES.inc(what=what)
    rec = _S.rec
    if rec is not None:
        rec.record("retry", what=what, attempt=attempt,
                   error=repr(error), **_trace_extra())


def on_reconnect(what):
    RECONNECTS.inc(what=what)
    rec = _S.rec
    if rec is not None:
        rec.record("reconnect", what=what, **_trace_extra())


def on_fault(kind, site=""):
    FAULTS.inc(kind=kind)
    rec = _S.rec
    if rec is not None:
        rec.record("fault", kind=kind, site=site, **_trace_extra())


def on_rollback(step, reason):
    ROLLBACKS.inc(reason=reason)
    rec = _S.rec
    if rec is not None:
        rec.record("rollback", step=step, reason=reason)
        rec.flush()


def on_resume(step):
    RESUMES.inc()
    rec = _S.rec
    if rec is not None:
        rec.record("resume", step=step)


def on_checkpoint(step, path, mode):
    CHECKPOINTS.inc(mode=mode)
    rec = _S.rec
    if rec is not None:
        rec.record("checkpoint", step=step, path=path, mode=mode)


# -- serving hooks (paddle_tpu_torch.serving continuous-batching engine) ---------

def on_serving_step(active, slots, queue_depth, emitted=0, admitted=0,
                    retired=0, engine="engine", dt=None, k=1,
                    dispatched=None, kv_used=None, kv_total=None,
                    kv_bytes_used=None, kv_bytes_total=None,
                    prefix_hits=None, prefix_misses=None, preempted=0,
                    cache_hits=None, cache_misses=None,
                    cache_stale=None, cache_evictions=None,
                    spec_drafted=None, spec_accepted=None,
                    spec_emitted=None, spec_dispatches=None,
                    shadow=False, version=None):
    """One engine iteration completed: gauges reflect the step, counters
    accumulate, and (recorder armed) a ``serving_step`` row lands with
    the step wall time and the active trace id so the fleet timeline
    can join engine steps. Fused megastep iterations: ``dt`` is the
    whole dispatch, ``dispatched`` the scan trips the device ran
    (defaults to ``k``), ``k`` the decode steps actually consumed — a
    drain-tail megastep consumes fewer than it dispatched when every
    live slot retires early. The histogram observes (and the row
    reports) the PER-LOGICAL-STEP figure dt/dispatched, once per
    consumed step, so SLO step_latency gates stay comparable across
    K and a drain-tail dispatch cannot overstate per-step latency.
    Paged engines additionally report pool pressure (``kv_used`` /
    ``kv_total`` into the kv gauges and a ``kv_used_blocks`` row field
    the SLO engine and ``monitor watch`` gate on), cumulative prefix
    hit/miss counts, and ``preempted`` (requests pushed back to the
    queue this iteration)."""
    k = max(1, int(k))
    d = max(k, int(dispatched or k))
    per = None if dt is None else dt / d
    if shadow:
        # SHADOW engine step (canary analysis plane): scored, never
        # served — nothing here may tick the serving counters/gauges
        # the SLO engine, bench and autoscaler scale_hint read. The
        # decode volume lands on the mirror counter; the row below is
        # marked so slo/signals readers skip it too.
        if emitted:
            MIRROR_TOKENS.inc(emitted, engine=engine)
    else:
        SERVING_QUEUE_DEPTH.set(queue_depth)
        SERVING_SLOT_OCCUPANCY.set(active / slots if slots else 0.0)
        if kv_total is not None:
            KV_BLOCKS_TOTAL.set(kv_total)
        if kv_used is not None:
            KV_BLOCKS_USED.set(kv_used)
        if kv_bytes_total is not None:
            KV_BYTES_TOTAL.set(kv_bytes_total)
        if kv_bytes_used is not None:
            KV_BYTES_USED.set(kv_bytes_used)
        if preempted:
            SERVING_PREEMPTIONS.inc(preempted)
        if emitted:
            SERVING_TOKENS.inc(emitted)
        if admitted:
            SERVING_ADMISSIONS.inc(admitted)
        if retired:
            SERVING_RETIREMENTS.inc(retired)
        if dt is not None:
            for _ in range(k):
                SERVING_STEP_SECONDS.observe(per, engine=engine)
        if d > 1:
            MEGASTEP_DISPATCHES.inc(executor=engine)
            MEGASTEP_STEPS.inc(k, executor=engine)
    rec = _S.rec
    if rec is not None:
        extra = {} if d == 1 else {"k": k, "megastep_dt": dt,
                                   "dispatched": d}
        if shadow:
            extra["shadow"] = True
        if version is not None:
            extra["version"] = str(version)
        if kv_used is not None:
            # pool-pressure fields (paged engines only — dense rows
            # keep their earlier shape): kv_used_blocks is what slo/watch
            # windows gate on; the prefix counters are CUMULATIVE so a
            # window's hit rate is last-row arithmetic, not a sum
            extra["kv_used_blocks"] = kv_used
            extra["kv_total_blocks"] = kv_total
            if kv_bytes_total is not None:
                extra["kv_bytes_used"] = kv_bytes_used
                extra["kv_bytes_total"] = kv_bytes_total
            extra["prefix_hits"] = prefix_hits
            extra["prefix_misses"] = prefix_misses
            if preempted:
                extra["preempted"] = preempted
        if cache_hits is not None:
            # sparse scoring engines (serving.sparse): CUMULATIVE
            # hot-ID cache counters on every row, same discipline as
            # the prefix counters — a window's hit rate is last-row
            # arithmetic, never a sum
            extra["cache_hits"] = cache_hits
            extra["cache_misses"] = cache_misses
            extra["cache_stale"] = cache_stale
            extra["cache_evictions"] = cache_evictions
        if spec_dispatches is not None:
            # speculative engines: CUMULATIVE drafted/
            # accepted/emitted token counts + scoring dispatches, same
            # last-row-arithmetic discipline — acceptance rate and
            # accepted-tokens-per-dispatch fall out of any window's
            # last row
            extra["spec_drafted"] = spec_drafted
            extra["spec_accepted"] = spec_accepted
            extra["spec_emitted"] = spec_emitted
            extra["spec_dispatches"] = spec_dispatches
        rec.record("serving_step", engine=engine, active=active,
                   slots=slots, queue_depth=queue_depth,
                   emitted=emitted, admitted=admitted, retired=retired,
                   dt=per, **extra, **_trace_extra())


def on_prefix_lookup(hit):
    """One prefix-cache lookup at admission (paged engines)."""
    (PREFIX_HITS if hit else PREFIX_MISSES).inc()


def on_spec(drafted=0, accepted=0):
    """One speculative scoring dispatch completed:
    ``drafted`` tokens were proposed across the live slots, ``accepted``
    of them matched the model's own tokens and were committed (the
    per-slot bonus token is counted by ptpu_serving_tokens_total like
    every emitted token, not here)."""
    SPEC_DISPATCHES.inc()
    if drafted:
        SPEC_DRAFTED.inc(drafted)
    if accepted:
        SPEC_ACCEPTED.inc(accepted)


def on_prefix_evictions(n=1):
    """Prefix-cache blocks LRU-freed under pool pressure."""
    if n:
        PREFIX_EVICTIONS.inc(n)


# -- sparse serving hooks (paddle_tpu_torch.serving.sparse) ------------

def on_sparse_lookup(hits=0, misses=0, stale=0):
    """One batched hot-ID cache lookup resolved: ``hits`` rows served
    cacheside, ``misses`` fetched cold, ``stale`` re-fetched past the
    staleness bound / version bump (stale rows also count as misses on
    the wire — the counters answer different questions and are not
    meant to sum to the row count)."""
    if hits:
        SPARSE_CACHE_HITS.inc(hits)
    if misses:
        SPARSE_CACHE_MISSES.inc(misses)
    if stale:
        SPARSE_CACHE_STALE.inc(stale)


def on_sparse_evictions(n=1):
    if n:
        SPARSE_CACHE_EVICTIONS.inc(n)


def on_sparse_prefetch(rows, nbytes):
    """One batched PRFT pull against a pserver shard completed."""
    if rows:
        SPARSE_PREFETCH_ROWS.inc(rows)
    if nbytes:
        SPARSE_PREFETCH_BYTES.inc(nbytes)


def on_sparse_staleness(seconds, table="table"):
    """One measured read-your-writes staleness sample (online update
    landed -> first serve reflecting it). Observes the histogram and —
    recorder armed — lands a ``sparse_staleness`` row, the sample the
    SLO ``staleness_s`` objective gates on the --log surface."""
    SPARSE_STALENESS.observe(float(seconds), table=table)
    rec = _S.rec
    if rec is not None:
        rec.record("sparse_staleness", value=float(seconds),
                   table=table, **_trace_extra())


def on_serving_request(engine, queue_wait=None, ttft=None, tpot=None,
                       tokens=0, prefill_chunks=0, prompt_len=0,
                       trace_id=None, shadow=False, version=None,
                       error=None):
    """One request retired (or failed) — the request-level latency
    attribution tier. Histograms observe unconditionally (requests are
    rare next to decode steps, same discipline as the serving
    counters); a ``serving_request`` recorder row lands when the flight
    recorder is armed, carrying the REQUEST's trace id (not the ambient
    step's) so the fleet timeline can join request lanes."""
    if shadow:
        # mirrored request (canary analysis plane): like the
        # failed-request exclusion below but total — neither the
        # error counter nor the latency histograms may see shadow
        # traffic; the marked row is the delta evaluator's input.
        pass
    elif error is not None:
        # failed requests are the ERROR BUDGET's business only: their
        # retire stamp is the failure time (a kill/wedge gap, not
        # decode pace), so observing them would fail latency
        # objectives with shutdown artifacts. The recorder row below
        # still carries the raw values for forensics.
        SERVING_FAILURES.inc()
    else:
        if queue_wait is not None:
            SERVING_QUEUE_WAIT.observe(queue_wait, engine=engine)
        if ttft is not None:
            SERVING_TTFT.observe(ttft, engine=engine)
        if tpot is not None:
            SERVING_TPOT.observe(tpot, engine=engine)
    rec = _S.rec
    if rec is not None:
        row = {"engine": engine, "queue_wait": queue_wait, "ttft": ttft,
               "tpot": tpot, "tokens": tokens,
               "prefill_chunks": prefill_chunks,
               "prompt_len": prompt_len}
        if trace_id is not None:
            row["trace"] = trace_id
        if shadow:
            row["shadow"] = True
        if version is not None:
            row["version"] = str(version)
        if error is not None:
            row["error"] = error
        rec.record("serving_request", **row)


def on_alert(rule, severity, state, value=None, figures=None,
             offenders=None, active=None, at=None):
    """One alert transition from the monitor.signals rule engine
    (exactly-once FIRING/RESOLVED edge). Counter ticks
    unconditionally; the armed recorder lands an ``alert`` row
    stamped with the triggering windows' figures and the worst
    offenders in-window — the row the ``monitor alerts --incident``
    timeline splices with the goodput ledger. The row's ``trace``
    field carries the FIRST offender's trace id so an alert joins
    the merged fleet timeline like every other row kind."""
    ALERT_TRANSITIONS.inc(rule=rule, severity=severity, state=state)
    if active is not None:
        ALERTS_ACTIVE.set(active)
    rec = _S.rec
    if rec is not None:
        row = {"rule": rule, "severity": severity, "state": state,
               "value": value, "figures": figures or {},
               "offenders": list(offenders or ())}
        if at is not None:
            # the transition's LOGICAL time (the evaluation round's
            # clock) — the recorder stamps its own write-time ts, and
            # an offline replay's write time is not when the alert
            # condition held
            row["at"] = at
        tr = next((o.get("trace") for o in row["offenders"]
                   if o.get("trace")), None)
        if tr is not None:
            row["trace"] = tr
        rec.record("alert", **row)
        rec.flush()


def on_scale_event(direction, desired, live, reason, detail=None,
                   version_mix=None):
    """One autoscale desired-count move (serving.autoscale control
    loop). ``reason`` is a SHORT category tag ("pressure", "idle",
    "roll", "manual") — it labels the counter, so cardinality must
    stay bounded; the free-text hint rationale travels in ``detail``
    on the recorder row only. ``version_mix`` ({version: replicas})
    refreshes the per-version gauge, the fleet's version-mix story
    `monitor watch` renders."""
    FLEET_SCALE_EVENTS.inc(direction=direction, reason=reason)
    FLEET_DESIRED.set(int(desired))
    if version_mix:
        for ver, n in version_mix.items():
            FLEET_VERSION_REPLICAS.set(int(n), version=str(ver))
    rec = _S.rec
    if rec is not None:
        row = {"direction": direction, "desired": int(desired),
               "live": int(live), "reason": reason}
        if detail is not None:
            row["detail"] = detail
        if version_mix:
            row["version_mix"] = {str(k): int(v)
                                  for k, v in version_mix.items()}
        rec.record("scale_event", **row)
        rec.flush()


def on_drain(slot, endpoint, version=None):
    """One graceful replica drain started (admissions closed; the
    cell retires once its in-flight work delivers and acks)."""
    FLEET_DRAINS.inc()
    rec = _S.rec
    if rec is not None:
        rec.record("drain", slot=slot, endpoint=endpoint,
                   version=version)


def on_roll(from_version, to_version, convergence_s=None, replaced=0,
            shed_during=0, aborted=False, reason=None):
    """One rolling weight update finished — completed (the fleet
    reached 100% ``to_version``; ``convergence_s`` observed into the
    histogram the SLO's ``version_convergence_s`` objective reads) or
    ABORTED (roll halted, surviving fleet intact; no convergence
    observation — a half-roll's wall time is not a convergence).
    ``shed_during`` is the router's shed delta across the roll — the
    shed-during-roll error budget's sample."""
    if not aborted:
        FLEET_ROLLS.inc()
        if convergence_s is not None:
            FLEET_VERSION_CONVERGENCE.observe(float(convergence_s))
    rec = _S.rec
    if rec is not None:
        row = {"from_version": from_version, "to_version": to_version,
               "replaced": int(replaced),
               "shed_during": int(shed_during),
               "aborted": bool(aborted)}
        if convergence_s is not None:
            row["convergence_s"] = float(convergence_s)
        if reason is not None:
            row["reason"] = reason
        rec.record("roll", **row)
        rec.flush()


def on_mirror_pair(version, rid, agree, match, router="router",
                   candidate_error=None):
    """One joined shadow pair scored by the router: the candidate's
    result for a mirrored request matched against the incumbent's
    SERVED result for the same durable rid. ``agree`` is exact token
    equality, ``match`` the common-prefix fraction — the
    token-agreement delta objective's samples. The row keeps
    ``{version, rid}`` so either side's serving_request row is
    joinable by rid."""
    MIRROR_PAIRS.inc(router=router)
    rec = _S.rec
    if rec is not None:
        row = {"version": str(version), "rid": rid,
               "agree": bool(agree), "match": float(match),
               "router": router}
        if candidate_error is not None:
            row["candidate_error"] = candidate_error
        rec.record("mirror_pair", **row)


def on_verdict(phase, version, verdict, figures=None, pairs=None,
               requests=None, reason=None, rule=None):
    """One EXACTLY-ONCE delta-SLO verdict (monitor.signals DeltaRule /
    serving.rollout): a rollout phase's candidate either PASSed or
    FAILed its delta objectives. Ticks the verdict counter and — armed
    — lands a flushed ``verdict`` row (the gate record `monitor watch`
    and the rollout controller read)."""
    ROLLOUT_VERDICTS.inc(phase=phase, verdict=verdict)
    rec = _S.rec
    if rec is not None:
        row = {"phase": phase, "version": str(version),
               "verdict": verdict, "figures": figures or {}}
        if pairs is not None:
            row["pairs"] = int(pairs)
        if requests is not None:
            row["requests"] = int(requests)
        if reason is not None:
            row["reason"] = reason
        if rule is not None:
            row["rule"] = rule
        rec.record("verdict", **row)
        rec.flush()


_ROLLOUT_PHASES = {"idle": 0, "boot": 1, "shadow": 2, "canary": 3,
                   "rolling": 4, "promoted": 5, "rolled-back": -1}


def on_rollout(phase, version, detail=None, version_mix=None,
               convergence_s=None):
    """Rollout controller phase transition (serving.rollout). The
    gauge carries the live phase for scrape; the flushed ``rollout``
    row is what feeds the `monitor watch` status line — no parallel
    machinery, the collector already ships recorder rows."""
    ROLLOUT_PHASE.set(_ROLLOUT_PHASES.get(phase, 0))
    if version_mix:
        for ver, n in version_mix.items():
            FLEET_VERSION_REPLICAS.set(int(n), version=str(ver))
    rec = _S.rec
    if rec is not None:
        row = {"phase": phase, "version": str(version)}
        if detail is not None:
            row["detail"] = detail
        if version_mix:
            row["version_mix"] = {str(k): int(v)
                                  for k, v in version_mix.items()}
        if convergence_s is not None:
            row["convergence_s"] = float(convergence_s)
        rec.record("rollout", **row)
        rec.flush()


def on_feed_plan(hit):
    """core/executor feed-plan cache outcome for one run() call."""
    (FEED_PLAN_HITS if hit else FEED_NORMALIZATIONS).inc()


def on_transform(program, pass_name, ops_before, ops_after, dt,
                 changes=None, patterns=None):
    """One optimizing-pass rewrite phase over a Program completed
    (paddle_tpu.transform.PassManager). ``changes`` is the pass's own
    removed-or-rewritten count — constant folding REPLACES ops in
    place, so the op-count delta alone would hide its work.
    ``patterns`` (the fusion pass) maps pattern name -> hits for this
    phase. Counters tick unconditionally (transforms run per compile,
    not per step); the armed recorder additionally lands a
    ``transform`` row — program id, pass, ops before/after, wall time
    — following the recorder's row conventions."""
    removed = int(changes) if changes is not None \
        else max(0, int(ops_before) - int(ops_after))
    TRANSFORM_PASSES.inc(**{"pass": pass_name})
    if removed:
        TRANSFORM_OPS_REMOVED.inc(removed, **{"pass": pass_name})
    if patterns:
        for pat, n in patterns.items():
            if n:
                TRANSFORM_PATTERNS.inc(int(n), pattern=pat)
    if not _S.on:
        return
    rec = _S.rec
    if rec is not None:
        row = {"pass": pass_name, "ops_before": int(ops_before),
               "ops_after": int(ops_after), "removed": removed,
               "dt": dt}
        if patterns:
            row["patterns"] = {k: v for k, v in patterns.items() if v}
        rec.record("transform", program=id(program),
                   version=getattr(program, "_version", None), **row)


_mem_sample_counter = [0]


def _sample_device_memory():
    """Live/peak device bytes. On the card the caching allocator's
    ``memory_allocated`` / ``max_memory_allocated`` are one cheap call
    each — sampled every time; the CPU fallback walks the scope
    (O(vars)), so it samples only when profile_memory is on. The
    platform is queried once and cached — it cannot change."""
    import torch
    if _S.platform is None:
        try:
            _S.platform = "gpu" if torch.cuda.is_available() else "cpu"
        except Exception:
            return
    from .. import profiler as _prof
    try:
        if _S.platform == "gpu" and torch.cuda.is_initialized():
            live = int(torch.cuda.memory_allocated())
            peak = int(torch.cuda.max_memory_allocated())
        elif _prof.memory_enabled():
            live, peak = _prof.device_memory()
        else:
            return
        HBM_LIVE.set(live)
        HBM_PEAK.set(peak)
    except Exception:
        pass


def _flag(name):
    from .. import flags
    try:
        return flags.get_flag(name)
    except KeyError:
        return True


# -- compile phases --------------------------------------------------------

def on_compile_phase(what, duration):
    """One compile phase of the Executor finished in ``duration``
    seconds: ``plan_build`` (a step function built for a new cache key)
    or ``graph_capture`` (a ``run_steps`` CUDA graph captured). The
    counterpart of the JAX package's jax.monitoring listener: the same
    histogram, and the same ``xla_compile`` row for a phase of 10 ms or
    more."""
    if not _S.on:
        return
    rec, dog = _S.rec, _S.dog
    XLA_COMPILE_SECONDS.observe(duration, what=what)
    if dog is not None:
        # compile phases count as liveness: a long first capture must
        # not read as a stall
        dog.touch()
    if rec is not None and duration >= 0.01:
        rec.record("xla_compile", what=what, seconds=duration)


# -- stall + reporter ------------------------------------------------------

def _on_stall(idle, stacks):
    rec = _S.rec
    STALLS.inc()
    snap = _REG.snapshot()
    msg = ("paddle_tpu_torch.monitor WATCHDOG: no step/compile completed for "
           "%.1fs — dumping %d thread stacks" % (idle, len(stacks)))
    print(msg, file=sys.stderr)
    for label, stack in stacks.items():
        print("--- thread %s ---" % label, file=sys.stderr)
        print("\n".join(stack[-12:]), file=sys.stderr)
    if rec is not None:
        rec.record("stall", idle_seconds=idle, stacks=stacks,
                   metrics=snap)
        rec.flush()


def _report_loop(stop, interval):
    last_steps = 0
    while not stop.wait(interval):
        if not _S.on:
            continue
        s = summary()
        d = s["steps"] - last_steps
        last_steps = s["steps"]
        line = ("monitor: steps=%d (+%d) p50=%s p95=%s recompiles=%d"
                % (s["steps"], d, _fmt_s(s["p50_s"]), _fmt_s(s["p95_s"]),
                   s["recompiles"]))
        if s.get("mfu") is not None:
            line += " mfu=%.1f%%" % (100 * s["mfu"])
        if s.get("tokens_per_sec"):
            line += " tok/s=%.0f" % s["tokens_per_sec"]
        print(line, file=sys.stderr)


def _fmt_s(v):
    return "n/a" if v is None else "%.1fms" % (1000 * v)


# -- snapshots -------------------------------------------------------------

def summary():
    """One-look health dict (reporter line / bench.py stamp)."""
    steps = sum(STEPS.snapshot().values())
    out = {
        "steps": steps,
        "p50_s": _best_percentile(0.50),
        "p95_s": _best_percentile(0.95),
        "compiles": sum(COMPILES.snapshot().values()),
        "recompiles": RECOMPILES.value(),
        "cache_hits": CACHE_HITS.value(),
        "feed_bytes": FEED_BYTES.value(),
        "mfu": MFU.value(),
        "tokens_per_sec": TOKENS_PER_SEC.value(),
        "stalls": STALLS.value(),
    }
    return out


def _best_percentile(q):
    """Percentile over the busiest executor label (the headline series)."""
    snap = STEP_SECONDS.snapshot()
    if not snap:
        return None
    key = max(snap, key=lambda k: snap[k]["count"])
    return STEP_SECONDS.percentile(q, executor=key[0])


def prometheus_text():
    return _REG.render_prometheus()


def dump_metrics(path):
    """Write the registry as Prometheus text (.prom) or JSON."""
    if path.endswith(".json"):
        _REG.dump_json(path)
    else:
        with open(path, "w") as f:
            f.write(prometheus_text())


class MonitorSession:
    """Handle yielded by session(): .summary() returns the standard
    summary dict with the COUNT fields (steps/compiles/recompiles/
    cache_hits/feed_bytes/stalls) as deltas for the session's span;
    percentiles and gauges are ambient last-values."""

    _DELTA_KEYS = ("steps", "compiles", "recompiles", "cache_hits",
                   "feed_bytes", "stalls")

    def __init__(self, before):
        self._before = before
        self._after = None

    def _freeze(self):
        self._after = summary()

    def summary(self):
        cur = self._after if self._after is not None else summary()
        out = dict(cur)
        for k in self._DELTA_KEYS:
            out[k] = cur[k] - self._before[k]
        return out


class _SessionCM:
    def __init__(self, enable_kwargs):
        self._kw = enable_kwargs
        self._own = False
        self._sess = None

    def __enter__(self):
        # reuse an ambient session untouched (its recorder/watchdog
        # config wins); arm a fresh one only when the monitor is off
        self._own = not _S.on
        if self._own:
            enable(**self._kw)
        self._sess = MonitorSession(summary())
        return self._sess

    def __exit__(self, *exc):
        self._sess._freeze()
        if self._own:
            disable()
        return False


def session(log_path=None, **enable_kwargs):
    """``with monitor.session(log_path=...) as s:`` — the one shared
    arm-unless-ambient pattern (harness.monitored_run, benchmarks).
    Never resets the registry (counters are monotonic by contract);
    ``s.summary()`` reports the block's own counts as deltas."""
    return _SessionCM(dict(log_path=log_path, **enable_kwargs))


def reset_for_tests():
    """Clear metric series and compile history (test isolation)."""
    disable()
    _REG.reset()
    _S.programs.clear()
    _S.costs.clear()
    _S.tokens_override = None
    _S.peak_flops = None       # an explicit/auto peak must not leak
    _S.devices_recorded = False
    _S.platform = None
    _S.step_serial = 0
