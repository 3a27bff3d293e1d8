"""CLI: summarize or live-watch a flight-recorder JSONL log.

The port's copy of ``paddle_tpu/monitor/__main__.py`` (pure Python).

    python -m paddle_tpu_torch.monitor run.jsonl [--json]
    python -m paddle_tpu_torch.monitor watch run.jsonl [--interval S]
        [--window N] [--once] [--slo spec.json]
    python -m paddle_tpu_torch.monitor watch rep0.jsonl rep1.jsonl ...
        # serving fleet: one log per replica, dashboard over the union
    python -m paddle_tpu_torch.monitor watch --fleet <kv-endpoint>
        # LIVE fleet scrape over RPC (monitor/collector.py) — no files
    python -m paddle_tpu_torch.monitor goodput run.jsonl [rep1.jsonl ...]
        # goodput/badput wall-time attribution (monitor/goodput.py)
    python -m paddle_tpu_torch.monitor alerts --fleet <kv-endpoint>
        # LIVE streaming rule engine (monitor/signals.py): SLO burn-
        # rate + sustained-condition alerts over the scraped fleet
    python -m paddle_tpu_torch.monitor alerts run.jsonl [--spec slo.json]
        # offline replay: the same rules over a recorded log
    python -m paddle_tpu_torch.monitor alerts --incident run.jsonl ...
        # timeline splicing alert rows with the goodput ledger's
        # badput intervals ("what happened at 14:32")
    python -m paddle_tpu_torch.monitor bundle <dir>
        # incident forensics (monitor/forensics.py): verify a bundle's
        # CRC manifest and render the skew-corrected cross-process
        # timeline centered on the offender traces
    python -m paddle_tpu_torch.monitor bundle --capture --fleet <kv> <dir>
        # on-demand black-box capture: DUMP every fleet process into a
        # new bundle under <dir>, then render it

The summary covers BOTH workloads a log may carry: training `step`
rows (step count, latency percentiles, compile/recompile causes, MFU,
tokens/s) and serving `serving_step`/`serving_request` rows (engine
step p50/p95, occupancy, queue depth, TTFT/TPOT percentiles, error
count) — one command reports whatever ran. `--json` emits the same
summary as one JSON object for scripts (bench.py consumes this shape).
`watch` tails a (possibly live) log and renders a refreshing terminal
dashboard; `--once` renders a single frame and exits (scripts/tests).
"""

import argparse
import json
import sys

from .recorder import percentile_sorted as _percentile
from .recorder import read_jsonl_tolerant


def summarize_log(path):
    # tolerant parse: a LIVE run's log legitimately ends mid-record
    # when the writer is killed — skip-and-count instead of raising
    events, skipped = read_jsonl_tolerant(path)
    steps = [e for e in events if e["ev"] == "step"]
    compiles = [e for e in events if e["ev"] == "compile"]
    # a megastep row is ONE dispatch advancing k logical steps with
    # dt = per-logical-step wall time — counts and totals weight by k
    # so figures stay comparable across K (the megastep contract)
    def _k(e):
        return int(e.get("k") or 1)
    # latency percentiles use SYNCED samples only: unsynced steps
    # (monitor_sync_every amortization) logged dispatch time, not wall
    dts = sorted(e["dt"] for e in steps
                 if e.get("dt") is not None and e.get("synced", True))
    mfus = [e["mfu"] for e in steps if e.get("mfu")]
    tps = [e["tokens_per_sec"] for e in steps if e.get("tokens_per_sec")]
    reasons = {}
    for c in compiles:
        reasons[c.get("reason", "?")] = reasons.get(
            c.get("reason", "?"), 0) + 1
    # device info rides a separate lazy `devices` event (run_meta is
    # written at enable() time, before the device may be known)
    dev = next((e for e in events if e["ev"] == "devices"), {})
    out = {
        "path": path,
        "events": len(events),
        "platform": dev.get("platform"),
        "device_kind": dev.get("device_kind"),
        "steps": sum(_k(e) for e in steps),
        "p50_s": _percentile(dts, 0.50),
        "p95_s": _percentile(dts, 0.95),
        "total_step_s": sum(e["dt"] * _k(e) for e in steps
                            if e.get("dt") is not None
                            and e.get("synced", True)),
        "compiles": len(compiles),
        "compile_reasons": reasons,
        "recompiles": sum(1 for c in compiles if c.get("recompile")),
        "xla_compile_s": sum(e.get("seconds", 0.0) for e in events
                             if e["ev"] == "xla_compile"),
        "feed_bytes": sum(e.get("feed_bytes") or 0 for e in steps),
        "mean_mfu": (sum(mfus) / len(mfus)) if mfus else None,
        "mean_tokens_per_sec": (sum(tps) / len(tps)) if tps else None,
        "nan_trips": sum(1 for e in events if e["ev"] == "nan_guard"),
        "stalls": sum(1 for e in events if e["ev"] == "stall"),
        "truncated": any(e["ev"] == "truncated" for e in events),
        "skipped_lines": skipped,
        "serving": _summarize_serving(events),
    }
    return out


def _summarize_serving(events):
    """Aggregate serving_step / serving_request rows (None when the
    log carries neither — a pure training log stays unchanged). The
    latency samples come from the SLO engine's ONE rows->samples
    extraction (failed-request exclusion included), so this summary
    and `python -m paddle_tpu_torch.slo --log` always agree on a file."""
    sstep = [e for e in events if e["ev"] == "serving_step"]
    sreq = [e for e in events if e["ev"] == "serving_request"]
    if not sstep and not sreq:
        return None
    from .. import slo as _slo
    # latency/request fields only — the goodput ledger has its own
    # subcommand, no need to sweep the whole file here
    s = _slo.samples_from_events(events, compute_goodput=False)
    sdts = sorted(s["step_latency"])
    ttft = sorted(s["ttft"])
    tpot = sorted(s["tpot"])
    qw = sorted(s["queue_wait"])
    occ = [e["active"] / e["slots"] for e in sstep if e.get("slots")]
    return {
        # fused serving_step rows (megastep) advance k decode steps
        "steps": sum(int(e.get("k") or 1) for e in sstep),
        "step_p50_s": _percentile(sdts, 0.50),
        "step_p95_s": _percentile(sdts, 0.95),
        "mean_occupancy": (sum(occ) / len(occ)) if occ else None,
        "max_queue_depth": max(
            (e.get("queue_depth") or 0 for e in sstep), default=0),
        "tokens": sum(e.get("emitted") or 0 for e in sstep),
        "requests": s["requests"],
        "errors": s["errors"],
        "ttft_p50_s": _percentile(ttft, 0.50),
        "ttft_p95_s": _percentile(ttft, 0.95),
        "tpot_p50_s": _percentile(tpot, 0.50),
        "tpot_p95_s": _percentile(tpot, 0.95),
        "queue_wait_p95_s": _percentile(qw, 0.95),
    }


def _fmt_ms(v):
    return "n/a" if v is None else "%.2f ms" % (1000 * v)


def render(s):
    lines = [
        "flight log %s: %d events%s" % (
            s["path"], s["events"],
            " [TRUNCATED]" if s["truncated"] else ""),
        "  device      %s %s" % (s.get("platform") or "?",
                                 s.get("device_kind") or ""),
        "  steps       %d  (p50 %s, p95 %s, total %.2f s)" % (
            s["steps"], _fmt_ms(s["p50_s"]), _fmt_ms(s["p95_s"]),
            s["total_step_s"]),
        "  compiles    %d  (%s)  recompiles %d  xla wall %.2f s" % (
            s["compiles"],
            ", ".join("%s=%d" % kv
                      for kv in sorted(s["compile_reasons"].items()))
            or "-",
            s["recompiles"], s["xla_compile_s"]),
        "  feed bytes  %d" % s["feed_bytes"],
    ]
    if s["mean_mfu"] is not None:
        lines.append("  MFU         %.1f%%" % (100 * s["mean_mfu"]))
    if s["mean_tokens_per_sec"] is not None:
        lines.append("  tokens/s    %.0f" % s["mean_tokens_per_sec"])
    sv = s.get("serving")
    if sv:
        lines.append(
            "  serving     %d step(s)  (p50 %s, p95 %s)  occupancy "
            "%s  max queue %d  tokens %d" % (
                sv["steps"], _fmt_ms(sv["step_p50_s"]),
                _fmt_ms(sv["step_p95_s"]),
                "n/a" if sv["mean_occupancy"] is None
                else "%.2f" % sv["mean_occupancy"],
                sv["max_queue_depth"], sv["tokens"]))
        if sv["requests"]:
            lines.append(
                "  requests    %d  TTFT p50 %s p95 %s  TPOT p50 %s "
                "p95 %s  queue_wait p95 %s%s" % (
                    sv["requests"],
                    _fmt_ms(sv["ttft_p50_s"]), _fmt_ms(sv["ttft_p95_s"]),
                    _fmt_ms(sv["tpot_p50_s"]), _fmt_ms(sv["tpot_p95_s"]),
                    _fmt_ms(sv["queue_wait_p95_s"]),
                    "  ERRORS %d" % sv["errors"] if sv["errors"]
                    else ""))
    if s["nan_trips"]:
        lines.append("  NaN trips   %d" % s["nan_trips"])
    if s["stalls"]:
        lines.append("  STALLS      %d" % s["stalls"])
    if s.get("skipped_lines"):
        lines.append("  skipped     %d partial/torn line(s) (live or "
                     "killed writer)" % s["skipped_lines"])
    return "\n".join(lines)


def _watch_main(argv):
    from .watch import watch, watch_fleet
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.monitor watch",
        description="Tail a flight-recorder log and render a live "
                    "terminal dashboard (or --fleet for the live "
                    "scraped fleet view — no files)")
    p.add_argument("log", nargs="*",
                   help="flight-recorder .jsonl path(s) — one per "
                        "replica for a serving fleet; the dashboard "
                        "aggregates the union")
    p.add_argument("--fleet", default=None, metavar="KV_ENDPOINT",
                   help="live fleet scrape: discover processes from "
                        "this membership KV registry (host:port) and "
                        "scrape their metrics over RPC instead of "
                        "tailing files")
    p.add_argument("--endpoint", action="append", default=[],
                   metavar="ROLE=HOST:PORT",
                   help="extra static scrape endpoint for --fleet "
                        "(e.g. master=127.0.0.1:7164; repeatable — "
                        "the master and KV server are not "
                        "lease-registered)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between refreshes (default 2)")
    p.add_argument("--window", type=int, default=256,
                   help="rolling-window rows per series (default 256)")
    p.add_argument("--once", action="store_true",
                   help="render one frame from the current log "
                        "contents and exit")
    p.add_argument("--slo", default=None,
                   help="SLO spec JSON evaluated live over the "
                        "rolling request window (default: the "
                        "PADDLE_TPU_SLO_SPEC flag when set)")
    args = p.parse_args(argv)
    if not args.log and args.fleet is None and not args.endpoint:
        p.error("pass log file(s), or --fleet/--endpoint for the "
                "live scrape")
    slo_spec = args.slo
    if slo_spec is None:
        from .. import flags
        slo_spec = flags.get_flag("slo_spec") or None
    if slo_spec is not None:
        # validate up front: a typo'd --slo path (or a bad flag-named
        # spec) must be a clean exit 2, like the slo CLI, not a
        # traceback out of the render loop
        from .. import slo as _slo
        try:
            slo_spec = _slo.load_spec(slo_spec)
        except (OSError, ValueError) as e:
            print("watch: bad SLO spec %s: %s" % (args.slo or
                                                  "(from flag)", e),
                  file=sys.stderr)
            return 2
    if args.fleet is not None or args.endpoint:
        if args.log:
            print("watch: --fleet scrapes live endpoints; log files "
                  "are ignored with it", file=sys.stderr)
        static = []
        for s in args.endpoint:
            if "=" not in s:
                print("watch: --endpoint wants ROLE=HOST:PORT, got %r"
                      % s, file=sys.stderr)
                return 2
            role, ep = s.split("=", 1)
            static.append((role, ep))
        frame = watch_fleet(kv_endpoint=args.fleet, static=static,
                            interval=args.interval,
                            window=args.window, once=args.once,
                            slo_spec=slo_spec)
        return 1 if args.once and frame is None else 0
    frame = watch(args.log, interval=args.interval, window=args.window,
                  once=args.once, slo_spec=slo_spec)
    # --once on a log that does not exist is a scripting error (1);
    # the live loop instead waits for the file and exits 0 on Ctrl-C
    return 1 if args.once and frame is None else 0


def _alerts_main(argv):
    from . import signals as sg
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.monitor alerts",
        description="SLO burn-rate + sustained-condition alerting "
                    "(monitor/signals.py): stream against a live "
                    "scraped fleet (--fleet/--endpoint), replay a "
                    "recorded log, or render an --incident timeline")
    p.add_argument("log", nargs="*",
                   help="flight-recorder .jsonl path(s) to replay "
                        "offline (or to splice with --incident)")
    p.add_argument("--fleet", default=None, metavar="KV_ENDPOINT",
                   help="live mode: discover processes from this "
                        "membership KV registry and scrape them over "
                        "RPC each --interval")
    p.add_argument("--endpoint", action="append", default=[],
                   metavar="ROLE=HOST:PORT",
                   help="extra static scrape endpoint for live mode "
                        "(repeatable)")
    p.add_argument("--spec", default=None,
                   help="SLO/signals spec JSON: error-budget "
                        "objectives arm burn rules, its 'rules' "
                        "object overrides the sustained-condition "
                        "defaults (default: the PADDLE_TPU_SIGNALS_"
                        "SPEC flag, then PADDLE_TPU_SLO_SPEC)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between live scrape rounds "
                        "(default 2)")
    p.add_argument("--rounds", type=int, default=None,
                   help="stop the live loop after N rounds "
                        "(default: run until Ctrl-C)")
    p.add_argument("--round-s", type=float, default=1.0,
                   dest="round_s",
                   help="offline replay round granularity in seconds "
                        "of ROW time (default 1)")
    p.add_argument("--incident", action="store_true",
                   help="render the incident timeline of the given "
                        "log(s): alert rows spliced with badput "
                        "intervals and recovery markers")
    p.add_argument("--json", action="store_true",
                   help="emit transitions (or the incident entries) "
                        "as JSON")
    args = p.parse_args(argv)

    if args.incident:
        if not args.log:
            p.error("--incident needs flight-recorder log file(s)")
        try:
            entries, ledgers = sg.incident_entries(args.log)
        except OSError as e:
            print("alerts: unreadable log: %s" % e, file=sys.stderr)
            return 2
        print(json.dumps({"entries": entries}) if args.json
              else sg.render_incident(entries, ledgers))
        return 0

    spec_src = args.spec
    if spec_src is None:
        from .. import flags
        spec_src = flags.get_flag("signals_spec") \
            or flags.get_flag("slo_spec") or None
    spec = None
    if spec_src:
        from .. import slo as _slo
        try:
            spec = _slo.load_spec(spec_src)
        except (OSError, ValueError) as e:
            print("alerts: bad spec %s: %s" % (spec_src, e),
                  file=sys.stderr)
            return 2
    try:
        sig = sg.Signals(spec=spec)
    except ValueError as e:
        print("alerts: bad rule config: %s" % e, file=sys.stderr)
        return 2

    if args.fleet is not None or args.endpoint:
        from .collector import Collector
        static = []
        for s in args.endpoint:
            if "=" not in s:
                print("alerts: --endpoint wants ROLE=HOST:PORT, got "
                      "%r" % s, file=sys.stderr)
                return 2
            role, ep = s.split("=", 1)
            static.append((role, ep))
        col = Collector(kv_endpoint=args.fleet, static=static)
        rounds = 0
        n_transitions = 0       # count only: the loop may run for
        try:                    # weeks, transitions must not pile up
            while args.rounds is None or rounds < args.rounds:
                events = col.scrape_once()
                trs = sig.observe(snapshot=col.fleet_snapshot(),
                                  events=events)
                for tr in trs:
                    print(json.dumps(tr) if args.json
                          else sg.render_transition(tr))
                n_transitions += len(trs)
                rounds += 1
                if args.rounds is None or rounds < args.rounds:
                    import time as _time
                    _time.sleep(args.interval)
        except KeyboardInterrupt:
            pass
        finally:
            col.close()
        if not args.json:
            hint = sig.scale_hint()
            print("%d round(s), %d transition(s)   %s\n"
                  "scale hint: %s x%d  (%s)"
                  % (rounds, n_transitions,
                     sg.active_alerts_line(sig).strip(),
                     hint.direction, hint.magnitude, hint.reason))
        return 0

    if not args.log:
        p.error("pass log file(s), or --fleet/--endpoint for the "
                "live scrape")
    events = []
    try:
        for path in args.log:
            evs, _ = read_jsonl_tolerant(path)
            events.extend(evs)
    except OSError as e:
        print("alerts: unreadable log: %s" % e, file=sys.stderr)
        return 2
    # one log = one process's timeline: the goodput rule evaluates a
    # rolling ledger per round; a multi-log UNION would collapse
    # concurrent processes' intervals, so it stays off there (use
    # watch's per-source rollup for fleets)
    transitions = sig.replay(events, round_s=args.round_s,
                             goodput=len(args.log) == 1)
    if args.json:
        print(json.dumps({"transitions": transitions,
                          "active": sig.active(),
                          "scale_hint": list(sig.scale_hint())}))
    else:
        for tr in transitions:
            print(sg.render_transition(tr))
        hint = sig.scale_hint()
        print("%d transition(s)   %s\nscale hint: %s x%d  (%s)"
              % (len(transitions), sg.active_alerts_line(sig).strip(),
                 hint.direction, hint.magnitude, hint.reason))
    return 0


def _goodput_main(argv):
    from . import goodput as gp
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.monitor goodput",
        description="Goodput/badput wall-time attribution over "
                    "flight-recorder log(s) — one per process; "
                    "several render a fleet rollup")
    p.add_argument("log", nargs="+",
                   help="flight-recorder .jsonl path(s)")
    p.add_argument("--json", action="store_true",
                   help="emit the ledger as one JSON object")
    args = p.parse_args(argv)
    try:
        report = gp.ledger(args.log)
    except OSError as e:
        print("goodput: unreadable log: %s" % e, file=sys.stderr)
        return 2
    print(json.dumps(report) if args.json else gp.render(report))
    return 0


def _bundle_main(argv):
    from . import forensics as fx
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.monitor bundle",
        description="Incident forensics (monitor/forensics.py): "
                    "verify a bundle's CRC manifest and render the "
                    "one-screen incident summary + offender-centered "
                    "cross-process timeline; --capture assembles a "
                    "fresh bundle from a live fleet first")
    p.add_argument("dir",
                   help="bundle directory to render — with --capture, "
                        "the base directory the new bundle is "
                        "created under")
    p.add_argument("--capture", action="store_true",
                   help="fan DUMP out across the fleet (discovery "
                        "via --fleet/--endpoint) and assemble a new "
                        "bundle under <dir> before rendering it")
    p.add_argument("--fleet", default=None, metavar="KV_ENDPOINT",
                   help="membership KV registry (host:port) for "
                        "--capture discovery")
    p.add_argument("--endpoint", action="append", default=[],
                   metavar="ROLE=HOST:PORT",
                   help="extra static capture endpoint (repeatable — "
                        "the master and KV server are not "
                        "lease-registered)")
    p.add_argument("--deadline", type=float, default=2.0,
                   help="per-process DUMP deadline in seconds; a "
                        "slower process is dropped and recorded as "
                        "missing (default 2)")
    args = p.parse_args(argv)
    path = args.dir
    if args.capture:
        if args.fleet is None and not args.endpoint:
            p.error("--capture needs --fleet and/or --endpoint")
        static = []
        for s in args.endpoint:
            if "=" not in s:
                print("bundle: --endpoint wants ROLE=HOST:PORT, got "
                      "%r" % s, file=sys.stderr)
                return 2
            role, ep = s.split("=", 1)
            static.append((role, ep))
        path = fx.capture(kv_endpoint=args.fleet, static=static,
                          deadline_s=args.deadline, out_dir=args.dir)
    try:
        return fx.render(path)
    except (OSError, ValueError) as e:
        # missing directory / unreadable or non-bundle manifest: a
        # usage error on the analysis/slo convention
        print("bundle: %s: %s" % (path, e), file=sys.stderr)
        return 2


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        return _main(argv)
    except BrokenPipeError:
        # `... | head` closed the pipe mid-render: a truncated listing
        # is what the reader asked for, not a traceback. Re-point
        # stdout at devnull so the interpreter's exit flush stays
        # quiet too.
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY),
                sys.stdout.fileno())
        return 0


def _main(argv):
    if argv and argv[0] == "watch":
        return _watch_main(argv[1:])
    if argv and argv[0] == "goodput":
        return _goodput_main(argv[1:])
    if argv and argv[0] == "alerts":
        return _alerts_main(argv[1:])
    if argv and argv[0] == "bundle":
        return _bundle_main(argv[1:])
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.monitor",
        description="Summarize a paddle_tpu_torch.monitor flight-recorder "
                    "log (or `watch <log>` for a live dashboard)")
    p.add_argument("log", help="flight-recorder .jsonl path")
    p.add_argument("--json", action="store_true",
                   help="emit the summary as one JSON object")
    args = p.parse_args(argv)
    s = summarize_log(args.log)
    if args.json:
        print(json.dumps(s))
    else:
        print(render(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
