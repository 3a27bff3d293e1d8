"""paddle_tpu_torch.trace — Dapper-style cross-process distributed tracing.

The port's copy of ``paddle_tpu/trace``: the same spans, wire block,
span log and merge, so the logs of processes of either package merge
into one timeline.

The fleet half of the observability tier: paddle_tpu_torch.monitor answers
"is THIS process healthy"; trace answers "why was step N slow ACROSS
the fleet". A ``SpanContext`` (trace_id / span_id / parent_id, sampled
flag) propagates through the existing RPC frames as an optional,
backward-compatible header block (distributed/rpc.py); the pserver /
master / membership dispatch loops open child spans per request, the
retry policy records each attempt as a child of the one logical client
span, and every process appends its spans to a bounded JSONL log
(the flight recorder's atomic-append/truncation discipline).

NTP-style clock-offset samples (midpoint method over RPC round trips,
periodic per peer) ride in the same log so the merge CLI can stitch all
per-process logs into ONE skew-corrected Perfetto/Chrome timeline:

    python -m paddle_tpu_torch.trace merge trainer.jsonl ps.jsonl -o t.json
    python -m paddle_tpu_torch.trace stats *.jsonl       # p50/p95 per verb,
                                                   # per-round critical
                                                   # path, stragglers

Arming (fleet-wide — every process of a run must share the decision,
like PADDLE_TPU_FAULTS): ``PADDLE_TPU_TRACE=1`` (or a sampling rate in
(0,1]) + ``PADDLE_TPU_TRACE_LOG=run-{pid}.jsonl``, or programmatic
``trace.enable(log_path=..., sample_rate=...)``. Disarmed, every hook
site is a single is-None check (same bar as resilience.faults).
"""

from .runtime import (  # noqa: F401
    Span, SpanContext, Tracer, active_trace_id, annotate, child_span,
    current_span, detached_span, disable, enable, enabled, extract,
    maybe_enable_from_flags, retain_trace, span, tail_armed,
    tail_dump, tracer,
)
from .clock import midpoint_offset, probe  # noqa: F401
