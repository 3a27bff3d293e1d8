"""Thread-safe metrics registry: counters, gauges, histograms with labels.

The port's copy of ``paddle_tpu/monitor/metrics.py`` (pure Python).

The runtime half of the observability story (the static half is
paddle_tpu.analysis). Reference parity: the 2018 framework had no
metrics registry at all — its closest analogs are the profiler's
per-event count/total table (platform/profiler.h) and the pserver's
ad-hoc stderr logs; here every subsystem (executor, distributed runtime,
watchdog) reports into ONE process-wide registry that exports Prometheus
text or a JSON snapshot at any moment, the always-on production shape.

Design: metric objects are cheap to update (one lock + dict store per
observation — sub-microsecond, invisible next to a training step or a
socket round-trip) and are safe to create at import time; creating a
metric never starts threads or touches files. `registry()` returns the
process default; tests may build private `Registry()` instances.
"""

import bisect
import copy
import json
import threading
import time
import uuid

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "registry",
           "bucket_percentile", "merge_snapshots", "META_KEY",
           "render_prometheus_snapshot"]

# Reserved snapshot key carrying registry identity (never a metric name
# — metric names are prometheus identifiers, so the collision is
# impossible by construction). The fleet collector keys restart
# detection and same-process dedup on the incarnation in here.
META_KEY = "__meta__"

# Multi-label series keys join their label values with the ASCII unit
# separator (JSON-safe, never in a printable label value) so the
# renderer can split them back LOSSLESSLY — a "," join would
# mis-attribute any comma-bearing value. Single-label keys are the
# bare value (the schema every existing consumer reads); legacy
# ","-joined multi-label keys from older snapshots still split on ",".
_KEY_SEP = "\x1f"

# step latencies span ~100us (tiny CPU graphs) to minutes (first XLA
# compile included in a run() call); exponential buckets, factor ~2.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


def _merge_hist_ent(dst, src):
    """Accumulate one histogram series entry ({counts, sum, count})
    into another, bucket-wise — the ONE merge arithmetic behind both
    Histogram.merge (object level) and merge_snapshots (dict level)."""
    for i, c in enumerate(src["counts"]):
        dst["counts"][i] += int(c)
    dst["sum"] += float(src["sum"])
    dst["count"] += int(src["count"])


def bucket_percentile(buckets, counts, q):
    """Bucket-interpolated q-quantile (0..1) over NON-cumulative
    per-bucket counts (``len(buckets) + 1`` entries, overflow last);
    None when empty. ONE algorithm shared by ``Histogram.percentile``
    (live) and the SLO evaluator's offline snapshot math
    (paddle_tpu/slo.py) — a fix to either must be a fix to both, or
    --metrics verdicts drift from live percentiles."""
    total = sum(counts)
    if not total:
        return None
    target = q * total
    acc = 0.0
    for i, c in enumerate(counts):
        if acc + c >= target and c:
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i] if i < len(buckets) else buckets[-1]
            frac = (target - acc) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        acc += c
    return buckets[-1]


def _label_key(label_names, labels):
    if set(labels) != set(label_names):
        raise ValueError(
            "metric labels %s do not match declared %s"
            % (sorted(labels), sorted(label_names)))
    return tuple(str(labels[n]) for n in label_names)


class _Metric:
    kind = "untyped"

    def __init__(self, name, help_="", label_names=()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._series = {}       # label-value tuple -> stored value

    def _snapshot_ent(self):
        """This metric as one snapshot-dict entry — the ONE shape the
        registry snapshot, the fleet collector's merge, and the
        Prometheus renderer all share."""
        ent = {"kind": self.kind, "help": self.help,
               "labels": list(self.label_names),
               "series": {_KEY_SEP.join(k): v
                          for k, v in self.snapshot().items()}}
        if self.kind == "histogram":
            ent["buckets"] = list(self.buckets)
        return ent

    def clear(self):
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    """Monotonically increasing count (resets only with the process)."""

    kind = "counter"

    def inc(self, value=1, **labels):
        if value < 0:
            raise ValueError("counter increment must be >= 0")
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._series.get(key, 0)

    def snapshot(self):
        with self._lock:
            return dict(self._series)


class Gauge(_Metric):
    """Point-in-time value (can go up and down)."""

    kind = "gauge"

    def set(self, value, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, value=1, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._series.get(key)

    def snapshot(self):
        with self._lock:
            return dict(self._series)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics) with a cheap
    bucket-interpolated percentile for in-process reporting."""

    kind = "histogram"

    def __init__(self, name, help_="", label_names=(), buckets=None):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))

    def observe(self, value, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            ent = self._series.get(key)
            if ent is None:
                ent = self._series[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            idx = bisect.bisect_left(self.buckets, value)
            ent["counts"][idx] += 1
            ent["sum"] += float(value)
            ent["count"] += 1

    def count(self, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            ent = self._series.get(key)
            return ent["count"] if ent else 0

    def sum(self, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            ent = self._series.get(key)
            return ent["sum"] if ent else 0.0

    def percentile(self, q, **labels):
        """Approximate q-quantile (0..1) by linear interpolation inside
        the containing bucket. None when empty."""
        key = _label_key(self.label_names, labels)
        with self._lock:
            ent = self._series.get(key)
            if not ent or not ent["count"]:
                return None
            counts = list(ent["counts"])
        return bucket_percentile(self.buckets, counts, q)

    def snapshot(self):
        with self._lock:
            return {k: {"counts": list(v["counts"]), "sum": v["sum"],
                        "count": v["count"]}
                    for k, v in self._series.items()}

    def merge(self, other):
        """Merge another Histogram's observations into this one,
        bucket-wise (the fleet-collector primitive: two processes'
        snapshots of the SAME histogram sum exactly because every
        process embeds identical bucket boundaries). Mismatched
        boundaries are a schema violation — a silent elementwise sum
        would produce a histogram whose percentiles mean nothing, so
        it raises instead."""
        if tuple(other.buckets) != self.buckets:
            raise ValueError(
                "histogram %r bucket boundaries differ: %s vs %s"
                % (self.name, self.buckets, tuple(other.buckets)))
        for key, ent in other.snapshot().items():
            with self._lock:
                mine = self._series.get(key)
                if mine is None:
                    mine = self._series[key] = {
                        "counts": [0] * (len(self.buckets) + 1),
                        "sum": 0.0, "count": 0}
                _merge_hist_ent(mine, ent)


class Registry:
    """Named collection of metrics. get-or-create semantics: asking for
    an existing name with the same type and labels returns the SAME
    object (so modules can declare their metrics independently); a
    conflicting re-registration raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        # registry identity, stamped into every snapshot: the
        # incarnation changes when the process (or a test's private
        # Registry) is recreated, and uptime_s is monotonic within one
        # incarnation — together they let a fleet collector tell a
        # counter RESET (process restart) from counter progress, so
        # deltas never go negative across a respawn.
        self.incarnation = uuid.uuid4().hex[:16]
        self._t0 = time.monotonic()

    def uptime_s(self):
        """Seconds since this registry (≈ this process) came up."""
        return time.monotonic() - self._t0

    def _get_or_create(self, cls, name, help_, label_names, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or \
                        m.label_names != tuple(label_names):
                    raise ValueError(
                        "metric %r already registered as %s%s"
                        % (name, type(m).__name__, m.label_names))
                want_buckets = kw.get("buckets")
                if want_buckets is not None and \
                        m.buckets != tuple(sorted(want_buckets)):
                    raise ValueError(
                        "histogram %r already registered with buckets %s"
                        % (name, m.buckets))
                return m
            m = cls(name, help_, label_names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help_="", label_names=()):
        return self._get_or_create(Counter, name, help_, label_names)

    def gauge(self, name, help_="", label_names=()):
        return self._get_or_create(Gauge, name, help_, label_names)

    def histogram(self, name, help_="", label_names=(), buckets=None):
        return self._get_or_create(Histogram, name, help_, label_names,
                                   buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self):
        """{name: {"kind", "labels", "series": {"l1,l2": value}}} — the
        JSON-able dump the flight recorder and watchdog embed.
        Histograms additionally carry their "buckets" boundaries so a
        dumped snapshot stays percentile-evaluable offline (the SLO
        engine's --metrics source). The reserved ``__meta__`` entry
        stamps the registry's incarnation and monotonic uptime so a
        scraper can detect process restarts (counter resets)."""
        # ONE lock acquisition covers the incarnation stamp AND the
        # series reads (lock order registry -> metric, same as
        # reset()): a reset racing this snapshot can never produce
        # the old incarnation stamped onto cleared counters — which a
        # collector would re-base and then double-merge.
        with self._lock:
            out = {META_KEY: {"incarnation": self.incarnation,
                              "uptime_s": self.uptime_s(),
                              "ts": time.time()}}
            for m in self._metrics.values():
                out[m.name] = m._snapshot_ent()
        return out

    def render_prometheus(self):
        # ONE exposition implementation for the per-process export
        # and the fleet collector's merged re-export
        return render_prometheus_snapshot(self.snapshot())

    def dump_json(self, path):
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)

    def reset(self):
        """Clear every series (metric objects survive — references held
        by modules stay valid). Test isolation helper. The incarnation
        is rolled: to any scraper a reset IS a restart (every counter
        returns to zero), and the new incarnation keeps its deltas from
        going negative."""
        with self._lock:
            # roll AND clear under the registry lock: snapshot()
            # takes the same lock, so no scraper can observe the new
            # incarnation stamped onto pre-reset totals (which a
            # collector would double-merge as a fresh process's).
            # Lock order registry -> metric matches snapshot()'s.
            self.incarnation = uuid.uuid4().hex[:16]
            self._t0 = time.monotonic()
            for m in self._metrics.values():
                m.clear()


def render_prometheus_snapshot(snap):
    """Prometheus text exposition of a snapshot dict — THE format
    implementation, shared by ``Registry.render_prometheus`` (one
    process) and the fleet collector's merged re-export
    (``monitor.collector``)."""
    lines = []
    for name in sorted(snap):
        if name == META_KEY:
            continue
        ent = snap[name]
        kind = ent.get("kind", "untyped")
        labels = list(ent.get("labels", ()))
        if "help" in ent:
            lines.append("# HELP %s %s" % (name, ent["help"]))
        lines.append("# TYPE %s %s" % (name, kind))

        def fmt(key, extra=()):
            # a single-label metric's series key IS the label value
            # (empty string included — it must still render the
            # label, not collide with an unlabeled series);
            # multi-label keys split on the lossless unit separator
            # (legacy ","-joined snapshots on disk fall back to ",")
            if not labels:
                vals = []
            elif len(labels) == 1:
                vals = [key]
            elif _KEY_SEP in key or not key:
                vals = key.split(_KEY_SEP)
            else:
                vals = key.split(",")
            pairs = list(zip(labels, vals)) + list(extra)
            if not pairs:
                return ""
            return "{%s}" % ",".join(
                '%s="%s"' % (k, str(v).replace('"', r'\"'))
                for k, v in pairs)

        for key, v in sorted(ent.get("series", {}).items()):
            if kind == "histogram":
                acc = 0
                for b, c in zip(ent.get("buckets", ()), v["counts"]):
                    acc += c
                    lines.append("%s_bucket%s %d" % (
                        name, fmt(key, [("le", repr(float(b)))]),
                        acc))
                lines.append("%s_bucket%s %d" % (
                    name, fmt(key, [("le", "+Inf")]), v["count"]))
                lines.append("%s_sum%s %s" % (name, fmt(key),
                                              v["sum"]))
                lines.append("%s_count%s %d" % (name, fmt(key),
                                                v["count"]))
            else:
                lines.append("%s%s %s" % (name, fmt(key), v))
    return "\n".join(lines) + "\n"


def merge_snapshots(into, src):
    """Merge one ``Registry.snapshot()``-shaped dict into another,
    IN PLACE (``into`` is mutated and returned) — the fleet
    collector's accumulation primitive, unit-testable without
    sockets:

      * counters / gauges: exact per-series sum,
      * histograms: bucket-wise count sum (+ sum/count), after
        checking the embedded boundaries match — mismatched buckets
        raise loudly instead of producing meaningless percentiles,
      * the reserved ``__meta__`` entry of ``src`` is ignored
        (``into`` keeps its own, if any).

    Metrics present in only one snapshot pass through unchanged; a
    name carried with DIFFERENT kinds on the two sides is a schema
    violation and raises — BEFORE any mutation (validate-then-apply),
    so a failed merge never leaves ``into`` half-merged (the fleet
    accumulator would double-count on retry otherwise)."""
    for name, ent in src.items():
        if name == META_KEY:
            continue
        mine = into.get(name)
        if mine is None:
            continue
        if mine.get("kind") != ent.get("kind"):
            raise ValueError(
                "metric %r kind mismatch: %r vs %r"
                % (name, mine.get("kind"), ent.get("kind")))
        if ent.get("kind") == "histogram" and \
                list(mine.get("buckets", ())) != \
                list(ent.get("buckets", ())):
            raise ValueError(
                "histogram %r bucket boundaries differ: %s vs %s"
                % (name, mine.get("buckets"), ent.get("buckets")))
    for name, ent in src.items():
        if name == META_KEY:
            continue
        mine = into.get(name)
        if mine is None:
            into[name] = copy.deepcopy(ent)
            continue
        if ent.get("kind") == "histogram":
            for key, s in ent["series"].items():
                m = mine["series"].get(key)
                if m is None:
                    mine["series"][key] = copy.deepcopy(s)
                    continue
                _merge_hist_ent(m, s)
        else:
            for key, v in ent["series"].items():
                mine["series"][key] = mine["series"].get(key, 0) + v
    return into


_default = Registry()


def registry():
    """The process-wide default registry."""
    return _default
