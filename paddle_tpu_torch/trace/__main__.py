"""CLI: merge per-process span logs / report fleet latency stats.

The port's copy of ``paddle_tpu/trace/__main__.py`` (pure Python).

    python -m paddle_tpu_torch.trace merge trainer.jsonl ps.jsonl -o t.json
    python -m paddle_tpu_torch.trace stats *.jsonl [--root round] [--json]

``merge`` writes one skew-corrected Perfetto/Chrome timeline (load it
at ui.perfetto.dev or chrome://tracing) with per-process lanes and
cross-process flow arrows. ``stats`` prints per-verb p50/p95, the
per-round critical-path breakdown, and straggler attribution.
"""

import argparse
import json
import sys

from .merge import merge_files, render_stats, stats_files, write_timeline


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.trace",
        description="paddle_tpu distributed-trace span-log tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    pm = sub.add_parser("merge",
                        help="merge span logs into one skew-corrected "
                             "Perfetto timeline")
    pm.add_argument("logs", nargs="+", help="per-process span .jsonl")
    pm.add_argument("-o", "--out", default="timeline.json",
                    help="output Chrome/Perfetto JSON path")
    pm.add_argument("--json", action="store_true",
                    help="print the merge info summary as JSON")

    ps = sub.add_parser("stats",
                        help="per-verb p50/p95, per-round critical "
                             "path, straggler attribution")
    ps.add_argument("logs", nargs="+", help="per-process span .jsonl")
    ps.add_argument("--root", default=None,
                    help="only count roots with this span name as "
                         "rounds (default: every root span)")
    ps.add_argument("--json", action="store_true",
                    help="emit the stats as one JSON object")

    args = p.parse_args(argv)
    if args.cmd == "merge":
        info = write_timeline(args.logs, args.out)
        if args.json:
            print(json.dumps(info))
        else:
            print("merged %d spans from %d process(es) -> %s "
                  "(reference pid %s)"
                  % (info["spans"], info["processes"], args.out,
                     info["reference_pid"]))
            for pid, off in sorted(info["clock_offsets"].items()):
                print("  pid %-8d clock offset %+.6fs" % (pid, off))
        return 0
    s = stats_files(args.logs, root_name=args.root)
    print(json.dumps(s) if args.json else render_stats(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
