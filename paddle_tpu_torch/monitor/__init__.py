"""paddle_tpu_torch.monitor — always-available runtime telemetry.

The port's counterpart of ``paddle_tpu/monitor`` (see each module's
docstring):
  metrics   thread-safe Counter/Gauge/Histogram registry + Prometheus
            text / JSON export (+ bucket-wise histogram merge and the
            incarnation/uptime snapshot stamp)
  recorder  bounded JSONL flight recorder of structured run events
            (+ a bounded in-memory ring served as the METR scrape
            delta)
  watchdog  stall detector that dumps all thread stacks
  runtime   the executor, serving, resilience and wire hooks
  collector fleet telemetry plane: METR/HLTH scrape over RPC,
            exact-sum merge, one fleet-labeled re-export (imported
            lazily: it needs the distributed tier)
  goodput   goodput/badput wall-time attribution over recorder rows
  signals   SLO burn-rate alerting, sustained-condition rules with
            hysteresis and the autoscaling scale_hint() plane
  watch     the live terminal dashboards over logs or a fleet
  forensics incident bundles (black-box DUMP captures, CRC manifest)

Quickstart::

    from paddle_tpu_torch import monitor
    monitor.enable(log_path="run.jsonl", stall_timeout=300)
    ...train...
    print(monitor.prometheus_text())

or env-driven: ``PADDLE_TPU_MONITOR=1 PADDLE_TPU_MONITOR_LOG=run.jsonl``.
Summarize a recorded log: ``python -m paddle_tpu_torch.monitor run.jsonl``;
the live dashboard: ``python -m paddle_tpu_torch.monitor watch run.jsonl
[--slo spec.json]``; ``goodput``, ``alerts`` and ``bundle`` likewise.
"""

from .metrics import (Counter, Gauge, Histogram, Registry,  # noqa: F401
                      registry)
from .recorder import (FlightRecorder, read_jsonl,  # noqa: F401
                       read_jsonl_tolerant)
from .watchdog import Watchdog, thread_stacks  # noqa: F401
from .watch import watch  # noqa: F401
from .runtime import (  # noqa: F401
    enable, disable, enabled, recorder, set_peak_flops,
    set_tokens_per_step, on_compile, on_compile_phase, on_cache_hit,
    on_step, on_nan_trip,
    on_retry, on_reconnect, on_fault, on_rollback, on_resume,
    on_checkpoint, on_serving_step, on_serving_request, on_feed_plan,
    on_alert,
    on_megastep, on_transform, feed_nbytes,
    tokens_in_feeds, sync_every, step_timer, summary, session,
    prometheus_text, dump_metrics, maybe_enable_from_flags,
    reset_for_tests,
)
