"""paddle_tpu_torch.monitor — always-available runtime telemetry.

The port's counterpart of ``paddle_tpu/monitor``, as far as ROADMAP.md
queue 1 item 10(a) takes it (see each module's docstring):
  metrics   thread-safe Counter/Gauge/Histogram registry + Prometheus
            text / JSON export (+ bucket-wise histogram merge and the
            incarnation/uptime snapshot stamp)
  recorder  bounded JSONL flight recorder of structured run events
            (+ a bounded in-memory ring served as the METR scrape
            delta)
  watchdog  stall detector that dumps all thread stacks
  runtime   the executor, resilience and wire hooks

The fleet plane (collector, signals, watch, forensics, goodput and the
``python -m`` CLI) is item 10(b).

Quickstart::

    from paddle_tpu_torch import monitor
    monitor.enable(log_path="run.jsonl", stall_timeout=300)
    ...train...
    print(monitor.prometheus_text())

or env-driven: ``PADDLE_TPU_MONITOR=1 PADDLE_TPU_MONITOR_LOG=run.jsonl``.
"""

from .metrics import (Counter, Gauge, Histogram, Registry,  # noqa: F401
                      registry)
from .recorder import (FlightRecorder, read_jsonl,  # noqa: F401
                       read_jsonl_tolerant)
from .watchdog import Watchdog, thread_stacks  # noqa: F401
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
