"""Flag registry of the PyTorch port.

Same mechanics and environment names as ``paddle_tpu/flags.py``: every
flag is registered once with type, default and help; its value comes
from the ``PADDLE_TPU_<NAME>`` environment variable (gflags booleans:
0/false/off/no = off) or from ``set_flag``. One environment therefore
configures both packages. Registered here: the ``serving_*`` flags the
port's engine reads, ``fuse_conv_bn`` (the conv lowering's),
``megastep_inflight`` (``Executor.run_steps``'s), ``lod_bucketing``
(the LoD feeds'), ``data_home`` (``dataset.common``'s),
``check_nan_inf`` (the Executor's NaN/Inf guards), ``profile_memory``
(the profiler's), ``debug_nans`` (the Executor's NaN localization),
the runtime tiers' ``monitor*``, ``faults*``, ``trace*``,
``rpc_retry*``, ``telemetry*``, ``slo_spec``, ``signals_spec`` and
``forensics_dir``, the fleet tier's ``serving_fleet_*``,
``serving_mirror_fraction``, ``serving_canary_weight`` and the sparse
scoring tier's ``serving_sparse_*`` / ``serving_scoring_batch`` (under
the JAX package's names and defaults), and the Executor switch of the
feature not ported yet (``transform``), so that setting it fails
loudly instead of being ignored.
"""

import os

_TRUTHY_OFF = ("0", "false", "off", "no")


class _Flag:
    def __init__(self, name, type_, default, help_):
        self.name = name
        self.type = type_
        self.default = default
        self.help = help_
        self.env = "PADDLE_TPU_" + name.upper()
        self._override = None

    def value(self):
        if self._override is not None:
            return self._override
        raw = os.environ.get(self.env)
        if raw is None or not raw.strip():
            return self.default
        raw = raw.strip()
        if self.type is bool:
            return raw.lower() not in _TRUTHY_OFF
        return self.type(raw)


_FLAGS = {}


def _register(name, type_, default, help_):
    _FLAGS[name] = _Flag(name, type_, default, help_)


_register("serving_prefill_chunk", int, 16,
          "Engine prompt-prefill chunk length: an admitted prompt is "
          "written into the KV pool this many tokens per engine "
          "iteration, so one long prompt cannot stall the decode batch")
_register("serving_admission_wait", float, 0.0,
          "Engine wait-for-batch admission window (seconds): an IDLE "
          "engine holds admissions up to this long for the queue to "
          "fill to the slot count. 0 = greedy fill")
_register("serving_megastep", int, 1,
          "serving.Engine decode iterations fused into one dispatch (a "
          "CUDA graph of K decode steps on the card) when no admissions "
          "or prefills are pending; output stays token-identical to the "
          "K=1 engine. 1 = one eager decode step per iteration")
_register("serving_paged", bool, True,
          "paged KV block pool + per-slot block tables. The port runs "
          "the paged layout only; 0 raises (see ROADMAP.md)")
_register("serving_block_size", int, 16,
          "paged-KV block length (cache positions per block): the "
          "allocation, prefix-match and copy-on-write granule")
_register("serving_kv_blocks", int, 0,
          "paged-KV pool size in blocks. 0 = slots * ceil(max_len / "
          "block_size); smaller pools preempt the lowest-priority "
          "request when they run dry")
_register("serving_block_kernel", bool, True,
          "block-native paged attention: walk each slot's block chain "
          "with online softmax (the CUDA kernel on the card, its plain "
          "PyTorch version on the CPU). 0 = the dense-gather path")
_register("serving_kv_quant", str, "",
          "paged-KV pool quantization: '' (off), 'int8' or 'fp8' (e4m3 "
          "codes; both with per-vector f32 scales beside the pool, "
          "quantized on write, dequantized inside the attention block "
          "loop)")
_register("serving_attn_unroll", int, 1,
          "blocks gathered per online-softmax update in the plain "
          "PyTorch paged attention (numerics-neutral)")
_register("serving_prefix_cache", bool, True,
          "radix prefix cache over full prompt blocks: a matching "
          "admission skips those prefill chunks")
_register("serving_speculative", bool, False,
          "serving.Engine speculative decode: a drafter proposes up to "
          "serving_spec_gamma tokens per live slot and one scoring "
          "dispatch (the paged kernel at C = gamma + 1 query rows) "
          "verifies them all, accepting the longest prefix that matches "
          "the model's own greedy or counter-keyed sampled tokens, so "
          "output stays the non-speculative engine's. Requires "
          "serving_paged")
_register("serving_spec_gamma", int, 4,
          "speculative draft length gamma: tokens proposed per live "
          "slot per iteration (the scoring dispatch's C = gamma + 1). "
          "0 disables speculation outright: the engine runs the "
          "existing programs")
_register("serving_spec_drafter", str, "ngram",
          "speculative drafter: 'ngram' (host-side n-gram lookup over "
          "the request's own token chain and the radix prefix cache's "
          "published chains; no device cost) or 'truncated' (gamma "
          "decode steps through the first serving_spec_layers layers "
          "of the same weights and pool, on the device)")
_register("serving_spec_ngram", int, 3,
          "longest suffix n-gram the ngram drafter matches (it falls "
          "back to shorter suffixes down to serving_spec_ngram_min)")
_register("serving_spec_ngram_min", int, 2,
          "shortest suffix n-gram the ngram drafter accepts as "
          "evidence. 2 skips single-token matches, whose drafts are "
          "mostly rejected")
_register("serving_spec_layers", int, 0,
          "transformer layers the 'truncated' drafter runs (0 = "
          "n_layer // 2). Draft quality moves only the acceptance "
          "rate, never the output")
_register("fuse_conv_bn", bool, False,
          "fuse 1x1-conv + train-BN batch stats: a 1x1 convolution whose "
          "output feeds a train-mode batch_norm runs as one matmul whose "
          "epilogue also sums the shifted per-channel statistics BN needs "
          "(ops/matmul_stats.py: the CUDA kernel on the card, its plain "
          "PyTorch version on the CPU), so BN skips its own pass over "
          "the conv output. Default off, as in the JAX package")
_register("megastep_inflight", int, 2,
          "Executor.run_steps async dispatch window: how many "
          "un-fetched megastep dispatches may be in flight before the "
          "next run_steps(return_numpy=False) call blocks on the "
          "oldest. 2 = double buffering (host feed of megastep N+1 "
          "overlaps device compute of megastep N); 1 restores "
          "serialized dispatch")
_register("lod_bucketing", bool, True,
          "bucket flat LoD feed totals to the next power of two (zero "
          "pad rows at the tail, which every reduction masks), so the "
          "step's shapes stay the same across batches whose token totals "
          "differ")
_register("data_home", str,
          os.path.expanduser("~/.cache/paddle_tpu/dataset"),
          "dataset cache directory")
_register("check_nan_inf", bool, False,
          "scan every op output for NaN/Inf inside the compiled step")
_register("profile_memory", bool, False,
          "record device live/peak bytes on every profiler event "
          "(FLAGS_benchmark memory-logging parity, operator.cc:576-578)")
_register("transform", bool, False,
          "run the program-transform pass pipeline before execution. "
          "Not ported yet; 1 makes Executor.run raise (see ROADMAP.md)")
_register("monitor", bool, False,
          "arm paddle_tpu_torch.monitor at import: step/compile telemetry into "
          "the process-wide metrics registry (near-zero overhead; see "
          "monitor_log / monitor_stall_timeout for the recorder/watchdog)")
_register("monitor_log", str, "",
          "flight-recorder JSONL path (with the monitor flag on); empty "
          "= metrics only, no event log")
_register("monitor_stall_timeout", float, 0.0,
          "seconds without a completed step/compile before the monitor "
          "watchdog dumps all thread stacks + a metrics snapshot "
          "(0 = watchdog off)")
_register("monitor_report_interval", float, 0.0,
          "seconds between one-line monitor console reports to stderr "
          "(0 = no reporter thread)")
_register("monitor_peak_flops", float, 0.0,
          "device peak FLOP/s for the MFU gauge (0 = unset: the port "
          "keeps no table of cards, so the gauge stays unset)")
_register("monitor_sync_every", int, 1,
          "synchronize the card every Nth monitored step. 1 = every "
          "step: exact latency, but serializes asynchronous launches — "
          "fine on the CPU and for debugging. N>1: the card keeps its "
          "launch queue full; the monitor syncs once per N steps and "
          "reports the window-average as that step's latency "
          "(intermediate steps log dispatch time, flagged synced=false, "
          "and are excluded from the latency histogram/MFU)")
_register("monitor_cost_model", bool, True,
          "price each compiled step with the static cost model so the "
          "monitor can derive MFU (the cost model is ROADMAP.md queue 1 "
          "item 11: until then no step is priced)")
_register("faults", str, "",
          "arm a paddle_tpu_torch.resilience fault-injection plan at "
          "import: "
          "a JSON spec, or @/path/to/plan.json (see resilience/faults.py "
          "for the spec schema). Empty = no injection, zero-cost hooks")
_register("faults_seed", int, 0,
          "decision seed for the armed fault plan — a fixed seed gives "
          "a reproducible chaos run")
_register("trace", str, "",
          "arm paddle_tpu_torch.trace cross-process distributed tracing at "
          "import: '1'/'true' records every root span, a float in "
          "(0, 1] head-samples that fraction of roots "
          "(PADDLE_TPU_TRACE=0.01 for fleets). Span context propagates "
          "through RPC frames; arm the WHOLE fleet together. Empty/0 = "
          "off, zero-cost hooks (one is-None check per site)")
_register("trace_log", str, "",
          "span-log JSONL path ('{pid}' substitutes the process id — "
          "each process needs its own file). Empty = "
          "ptpu_trace_<pid>.jsonl in the cwd. Merge the fleet's logs: "
          "python -m paddle_tpu_torch.trace merge *.jsonl -o timeline.json")
_register("trace_proc", str, "",
          "process label for the merged fleet-timeline lane (default: "
          "the executable basename) — e.g. trainer0, pserver1")
_register("trace_clock_interval", float, 15.0,
          "seconds between NTP-style clock-offset probes per peer "
          "(midpoint method over an idle RPC round trip; the merge CLI "
          "uses the min-RTT sample to skew-correct timestamps). <=0 "
          "probes at every opportunity")
_register("trace_tail_window", int, 256,
          "tail-based trace retention: number of recent traces the "
          "always-on in-memory span ring buffers per process (ALL "
          "spans, sampled-out ones included, grouped by trace id) so "
          "a retention decision made AFTER a trace ends — root error, "
          "root over trace_tail_slow_ms, or an incident naming the "
          "trace — can still promote the whole trace to the span log. "
          "0 disables the ring and restores pre-forensics behavior "
          "(sampled-out spans emit headerless frames)")
_register("trace_tail_slow_ms", float, 0.0,
          "tail-retention slow threshold: a ROOT span whose duration "
          "reaches this many milliseconds is retroactively promoted "
          "to the span log with reason 'slow' (derive it from the SLO "
          "latency objective). <=0 disables the slow rule; error and "
          "incident-offender promotion stay on")
_register("rpc_retry", bool, True,
          "run idempotent RPC verbs (GET/PRFT/PUT, tagged SEND/BARR, "
          "master GETT/DONE/FAIL/PING) under the resilience retry "
          "policy: transparent reconnect + bounded exponential backoff "
          "on socket errors instead of dying with the first broken "
          "connection")
_register("rpc_retry_deadline", float, 6.0,
          "total wall-clock budget (seconds) for one verb's retry loop "
          "— sized to ride out a pserver replacement (membership lease "
          "expiry + checkpoint recovery), after which the error "
          "propagates. The backoff schedule fills the whole budget "
          "(attempts are not the limiter)")


_register("debug_nans", bool, False,
          "NaN localization (the JAX package's jax_debug_nans): every "
          "float op output of Executor.run is checked as it is made, "
          "and the backward runs under torch.autograd.detect_anomaly, "
          "so the first op that makes a NaN raises FloatingPointError "
          "naming it. Reads the device after every op: run_steps then "
          "runs K plain run() calls with no capture")
_register("forensics_dir", str, "",
          "directory monitor.forensics writes incident bundles into "
          "(black-box DUMP captures assembled into a CRC-manifested "
          "bundle when a signals incident OPENs). Empty = "
          "forensics_bundles under the cwd")
_register("serving_fleet_window", int, 8,
          "serving.fleet Router per-replica in-flight window "
          "(backpressure): at most this many journaled requests are "
          "dispatched to one replica at a time; the rest queue "
          "router-side")
_register("serving_fleet_queue", int, 64,
          "serving.fleet Router global queue bound (load shedding): "
          "once this many requests await dispatch, submit() fast-fails "
          "with the typed Overloaded error, counted against the SLO "
          "error budget")
_register("serving_sparse_staleness_s", float, 5.0,
          "serving.sparse hot-ID cache bounded-staleness window "
          "(seconds): a cached embedding row older than this "
          "re-fetches from its pserver shard on next touch")
_register("serving_sparse_cache_rows", int, 65536,
          "serving.sparse hot-ID cache capacity in ROWS (LRU): the "
          "per-process bound on cached embedding rows across tables")
_register("serving_scoring_batch", int, 8,
          "serving.sparse ScoringEngine batch capacity: requests "
          "scored per dispatch (short batches pad to this shape)")
_register("serving_mirror_fraction", float, 0.25,
          "serving.fleet shadow mirroring: deterministic fraction of "
          "accepted decode requests duplicated to CANDIDATE replicas "
          "while a shadow mirror is armed (scored against the "
          "incumbent's result, never served)")
_register("serving_canary_weight", float, 0.1,
          "serving.fleet canary split: deterministic fraction of "
          "accepted requests served by candidate replicas while a "
          "canary is armed")
_register("serving_fleet_stall_timeout", float, 2.0,
          "serving.fleet Router response-deadline watchdog: a replica "
          "that answers no verb for this long is evicted from "
          "dispatch, its registry slot tombstoned for the supervisor, "
          "and its unfinished requests re-submitted to a survivor")
_register("telemetry", bool, False,
          "arm the scrape-only monitor.collector.TelemetryServer at "
          "import: the process becomes METR/HLTH scrapeable by a fleet "
          "collector")
_register("telemetry_port", int, 0,
          "TelemetryServer listen port (0 = ephemeral)")
_register("telemetry_kv", str, "",
          "membership KV endpoint (host:port) the armed "
          "TelemetryServer registers its endpoint with (role "
          "'telemetry', TTL lease); empty = serve unregistered")
_register("telemetry_slots", int, 16,
          "how many 'telemetry' role slots the lease registry offers")
_register("signals_spec", str, "",
          "default SLO/signals spec JSON for python -m "
          "paddle_tpu_torch.monitor alerts. Empty = fall back to "
          "slo_spec, then defaults-only rules")
_register("slo_spec", str, "",
          "default SLO spec JSON path: python -m paddle_tpu_torch.slo "
          "uses it when no spec argument is given, and python -m "
          "paddle_tpu_torch.monitor watch renders a live verdict line "
          "against it")


def get_flag(name):
    return _FLAGS[name].value()


def set_flag(name, value):
    """Programmatic override (wins over the environment); values coerce
    through the flag's type with the same parsing env vars get."""
    f = _FLAGS[name]
    if value is not None and not isinstance(value, f.type):
        if f.type is bool:
            value = str(value).strip().lower() not in _TRUTHY_OFF
        else:
            value = f.type(value)
    f._override = value



def overrides():
    """{name: current value} of every flag whose value differs from
    its default (env var or set_flag) — the active-configuration stamp
    a DUMP capture carries."""
    out = {}
    for f in _FLAGS.values():
        v = f.value()
        if v != f.default:
            out[f.name] = v
    return out
