"""Perf regression gate: compare a bench.py JSON against a baseline.

The port's copy of ``paddle_tpu/perfgate.py`` (pure Python).

The BENCH_r01..r06.json records checked into the repo are a perf
HISTORY; this module makes them a GATE — ``python -m
paddle_tpu_torch.perfgate current.json`` compares the current round's
probes against the newest baseline round with an explicit noise band
per probe, and exits 0 (pass) / 1 (regression) / 2 (bad input) per
the analysis/slo CLI convention, so CI or a round's harness can
fail a build on a real throughput loss without flapping on host
noise. ``bench.py`` stamps the same verdict vs the previous round
into its own output.

Comparison rules (the part a naive differ gets wrong):

  * every probe carries a DIRECTION (tokens/s regress when they
    FALL; ms/batch when they RISE) and an explicit default noise
    band (%%) sized from the JAX package's measured round-to-round
    spreads (``paddle_tpu/perfgate.py``),
  * when either side stamped a measured spread (``*_spread_pct``
    from the interleaved A/B protocol), the band widens to it —
    a delta smaller than the run's own spread is noise by
    definition,
  * some probes are percentage-POINT values around zero (router
    overhead); those use an absolute band, not a relative one,
  * a probe missing or null on either side is SKIPPED with a reason
    (a config that failed its repeats must not read as a
    regression), and rounds from different PLATFORMS never compare
    (a CPU rehearsal round vs a chip round would scream regression
    on every probe),
  * an UNSTAMPED round (no ``platform`` field — the pre-r06 records)
    is the one platform-AMBIGUOUS pairing: the mismatch guard cannot
    fire, so a chip round could silently compare against a CPU
    baseline. The CLI warns loudly whenever either side lacks the
    stamp, and ``--require-platform-stamp`` turns that warning into
    exit 1 — the chip round's CI should pass it.

CLI::

    python -m paddle_tpu_torch.perfgate current.json baseline.json [--json]
    python -m paddle_tpu_torch.perfgate current.json --baseline-dir .
                          # newest BENCH_r*.json in the dir
    python -m paddle_tpu_torch.perfgate current.json current.json
                          # self-compare: always exit 0 (sanity)
"""

import argparse
import glob
import json
import os
import re
import sys

__all__ = ["PROBES", "Probe", "load_result", "latest_baseline",
           "compare", "render", "main"]


class Probe:
    """One gated figure: where it lives in the bench JSON, which way
    is better, and how much round-over-round movement is noise."""

    def __init__(self, name, path, direction="higher", band_pct=15.0,
                 spread_path=None, band_abs=None):
        assert direction in ("higher", "lower")
        self.name = name
        self.path = tuple(path)
        self.direction = direction
        self.band_pct = float(band_pct)
        self.spread_path = tuple(spread_path) if spread_path else None
        self.band_abs = band_abs      # absolute units (pct-point probes)

    def get(self, result, path=None):
        cur = result
        for k in (path if path is not None else self.path):
            if not isinstance(cur, dict):
                return None
            cur = cur.get(k)
        return cur if isinstance(cur, (int, float)) else None


# Default bands are the JAX package's (``paddle_tpu/perfgate.py``), so a
# verdict is the same from either package.
PROBES = (
    Probe("resnet_imgs_per_sec", ("value",), "higher", 10.0,
          ("spread_pct",)),
    Probe("transformer_small_tok_s",
          ("transformer_tokens_per_sec_per_chip",), "higher", 15.0),
    Probe("transformer_large_tok_s",
          ("transformer_large_tokens_per_sec_per_chip",), "higher",
          10.0, ("transformer_large_spread_pct",)),
    Probe("transformer_xl_tok_s",
          ("transformer_xl_tokens_per_sec_per_chip",), "higher",
          10.0, ("transformer_xl_spread_pct",)),
    Probe("lstm_ms_per_batch", ("lstm_ms_per_batch",), "lower",
          10.0, ("lstm_spread_pct",)),
    Probe("monitor_step_p50_ms", ("monitor", "p50_ms"), "lower",
          30.0),
    Probe("serving_tok_s", ("serving", "value"), "higher", 30.0),
    Probe("serving_speedup", ("serving", "speedup"), "higher", 20.0),
    Probe("serving_megastep_bs1_speedup",
          ("serving", "megastep_bs1_speedup"), "higher", 25.0),
    Probe("serving_prefix_speedup", ("serving", "prefix_speedup"),
          "higher", 25.0),
    # speculative-decode probes: the verified-tokens-per-
    # scoring-dispatch multiplication (the figure a chip converts to
    # wall time at the dispatch floor), the acceptance rates of the
    # two drafting regimes, and the bs1-floor wall A/B (on THIS CPU
    # container the γ+1-position scoring compute is not free, so the
    # wall ratio sits below 1 — the gate holds it from regressing and
    # the chip round is where it flips; missing-on-baseline skips
    # keep rounds r01-r06 comparable)
    Probe("serving_spec_tok_per_dispatch",
          ("serving", "accepted_tokens_per_dispatch"), "higher",
          25.0),
    Probe("serving_spec_bs1_speedup",
          ("serving", "spec_bs1_speedup"), "higher", 25.0,
          ("serving", "spec_bs1_spread_pct")),
    Probe("serving_spec_shared_accept_rate",
          ("serving", "spec_shared_accept_rate"), "higher", 30.0),
    Probe("serving_spec_natural_accept_rate",
          ("serving", "spec_natural_accept_rate"), "higher", 30.0),
    Probe("megastep_k1_tok_s", ("megastep", "k1_tok_s"), "higher",
          20.0, ("megastep", "k1_spread_pct")),
    Probe("megastep_k8_tok_s", ("megastep", "k8_tok_s"), "higher",
          20.0, ("megastep", "k8_spread_pct")),
    Probe("megastep_speedup", ("megastep", "speedup"), "higher",
          15.0),
    Probe("fleet_router_overhead_pct",
          ("fleet", "router_overhead_pct"), "lower", 15.0,
          band_abs=10.0),
    # recsys sparse-serving probe: warm-cache scoring
    # throughput + the warm/cold ratio the hot-ID cache buys, plus
    # the routed-vs-direct front-door overhead (pct points around
    # zero -> absolute band, like the fleet probe)
    Probe("recsys_warm_rps", ("recsys", "warm_rps"), "higher", 30.0,
          ("recsys", "warm_spread_pct")),
    Probe("recsys_warm_over_cold", ("recsys", "warm_over_cold"),
          "higher", 25.0),
    Probe("recsys_router_overhead_pct",
          ("recsys", "router_overhead_pct"), "lower", 15.0,
          band_abs=10.0),
    # inference-specialization probes: the artifact-booted
    # engine's serving tok/s must not regress vs prior rounds (the
    # source-engine A/B rides the same stamp), the artifact cold-boot
    # wall must stay bounded (the direction-2 replica-respawn cost),
    # and the zoo-wide fusion hit count is a deterministic coverage
    # floor — fewer hits means a pattern stopped matching. Missing on
    # pre-15 baselines -> skip, like the spec/recsys probes
    Probe("specialize_art_tok_s", ("specialize", "artifact_tok_s"),
          "higher", 30.0, ("specialize", "artifact_spread_pct")),
    Probe("specialize_boot_s", ("specialize", "artifact_boot_s"),
          "lower", 50.0),
    Probe("specialize_zoo_fused", ("specialize", "zoo_fused_total"),
          "higher", 5.0),
    # elastic-fleet probes: the autoscale control loop's
    # serving-path overhead is pct points around zero -> absolute
    # band like the router-overhead probes; the roll wall clock and
    # the shed-during-roll count guard the rolling-update contract
    # (shed band 0: ANY shed during a roll is a regression, not
    # noise). Missing on pre-18 baselines -> skip
    Probe("autoscale_overhead_pct",
          ("autoscale", "overhead_pct"), "lower", 15.0,
          band_abs=10.0),
    Probe("autoscale_roll_s", ("autoscale", "roll_s"), "lower",
          50.0),
    Probe("autoscale_roll_shed", ("autoscale", "roll_shed"),
          "lower", 0.0, band_abs=0.0),
    # block-kernel probes: the large-capacity step-time
    # speedup of the chain-walk kernel over the dense gather, the
    # capacity-scaling flatness ratio (how much faster gather grows
    # with pool capacity than the block kernel — the acceptance
    # figure), and the int8-KV arm's speedup. Missing on pre-20
    # baselines -> skip, like every probe introduced mid-history
    Probe("serving_block_kernel_speedup",
          ("serving", "block_kernel_speedup"), "higher", 25.0,
          ("serving", "block_kernel_spread_pct")),
    Probe("serving_block_scale_ratio",
          ("serving", "block_kernel_scale_ratio"), "higher", 25.0),
    Probe("serving_block_quant_speedup",
          ("serving", "block_kernel_quant_speedup"), "higher", 30.0),
)


def load_result(source):
    """Bench record -> result dict. Accepts a path or a dict; a
    checked-in round file (``{"n", "cmd", "result": {...}}``) is
    unwrapped, a raw bench.py line passes through. Raises ValueError
    on anything that is not a bench result (no ``metric`` stamp)."""
    if isinstance(source, dict):
        rec = source
    else:
        with open(source) as f:
            rec = json.load(f)
    if not isinstance(rec, dict):
        raise ValueError("bench record is not a JSON object")
    # round-file shapes across the history: r06+ wrap the result dict
    # under "result"; r04 parsed it into "parsed"; r01-r03 only carry
    # the harness's "tail" whose last JSON-looking line IS the result
    for key in ("result", "parsed"):
        if isinstance(rec.get(key), dict) and "metric" in rec[key]:
            rec = rec[key]
            break
    else:
        if "metric" not in rec and isinstance(rec.get("tail"), str):
            for line in reversed(rec["tail"].splitlines()):
                line = line.strip()
                if line.startswith("{") and '"metric"' in line:
                    try:
                        rec = json.loads(line)
                        break
                    except json.JSONDecodeError:
                        continue     # torn tail line: scan earlier
    if "metric" not in rec:
        raise ValueError(
            "not a bench.py result (no 'metric' stamp): %s"
            % (source if not isinstance(source, dict) else "<dict>"))
    return rec


def latest_baseline(dirpath, exclude=None):
    """Newest checked-in round (highest NN in BENCH_rNN.json) whose
    result actually LOADS (an aborted round — the r05 shape — is
    skipped, not compared against); None when the directory has no
    usable round. ``exclude``: a path to skip (the round being
    stamped must not baseline against itself)."""
    rounds = []
    for path in glob.glob(os.path.join(dirpath, "BENCH_r*.json")):
        if exclude and os.path.abspath(path) == os.path.abspath(
                exclude):
            continue
        m = re.search(r"BENCH_r(\d+)\.json$", path)
        if m:
            rounds.append((int(m.group(1)), path))
    for _, path in sorted(rounds, reverse=True):
        try:
            load_result(path)
            return path
        except (OSError, ValueError, json.JSONDecodeError):
            continue
    return None


def compare(current, baseline, band_scale=1.0):
    """-> verdict dict {"pass", "compared", "regressions",
    "improvements", "platform", "baseline_platform", "probes":
    [{name, current, baseline, delta_pct?, delta?, band, status,
    reason?}]}. Pure function of the two result dicts (the CLI and
    bench.py's stamp share it)."""
    cur = load_result(current)
    base = load_result(baseline)
    plat_c = cur.get("platform")
    plat_b = base.get("platform")
    mismatch = (plat_c is not None and plat_b is not None
                and plat_c != plat_b)
    probes = []
    for p in PROBES:
        ent = {"name": p.name, "direction": p.direction,
               "current": p.get(cur), "baseline": p.get(base)}
        if mismatch:
            ent.update({"status": "skipped",
                        "reason": "platform mismatch (%s vs %s)"
                        % (plat_c, plat_b)})
            probes.append(ent)
            continue
        if ent["current"] is None or ent["baseline"] is None:
            ent.update({"status": "skipped",
                        "reason": "missing on %s side" % (
                            "current" if ent["current"] is None
                            else "baseline")})
            probes.append(ent)
            continue
        c, b = float(ent["current"]), float(ent["baseline"])
        if p.band_abs is not None:
            band = p.band_abs * band_scale
            delta = c - b
            ent["delta"] = round(delta, 3)
            ent["band"] = band
            worse = delta > band if p.direction == "lower" \
                else delta < -band
            better = delta < -band if p.direction == "lower" \
                else delta > band
        else:
            spreads = [p.band_pct]
            if p.spread_path:
                for side in (cur, base):
                    s = p.get(side, p.spread_path)
                    if s is not None:
                        spreads.append(float(s))
            band = max(spreads) * band_scale
            if b == 0:
                ent.update({"status": "skipped",
                            "reason": "baseline is zero"})
                probes.append(ent)
                continue
            delta_pct = 100.0 * (c - b) / abs(b)
            ent["delta_pct"] = round(delta_pct, 2)
            ent["band"] = round(band, 2)
            worse = delta_pct > band if p.direction == "lower" \
                else delta_pct < -band
            better = delta_pct < -band if p.direction == "lower" \
                else delta_pct > band
        ent["status"] = ("regression" if worse
                         else "improved" if better else "pass")
        probes.append(ent)
    regressions = [e["name"] for e in probes
                   if e["status"] == "regression"]
    return {"pass": not regressions,
            "compared": sum(1 for e in probes
                            if e["status"] != "skipped"),
            "regressions": regressions,
            "improvements": [e["name"] for e in probes
                             if e["status"] == "improved"],
            "platform": plat_c, "baseline_platform": plat_b,
            "probes": probes}


def render(verdict):
    head = "perfgate: %s  (%d probe(s) compared, %d regression(s))" \
        % ("PASS" if verdict["pass"] else "REGRESSION",
           verdict["compared"], len(verdict["regressions"]))
    lines = [head]
    for e in verdict["probes"]:
        if e["status"] == "skipped":
            lines.append("  SKIP %-28s %s" % (e["name"], e["reason"]))
            continue
        if "delta_pct" in e:
            delta = "%+.1f%%" % e["delta_pct"]
            band = "band ±%.0f%%" % e["band"]
        else:
            delta = "%+.3f" % e["delta"]
            band = "band ±%g" % e["band"]
        lines.append(
            "  %-4s %-28s %12g -> %-12g %8s (%s, %s better)"
            % (e["status"].upper()[:4], e["name"], e["baseline"],
               e["current"], delta, band, e["direction"]))
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.perfgate",
        description="Gate a bench.py JSON against a baseline round; "
                    "exit 0 pass / 1 regression / 2 bad input")
    p.add_argument("current", help="current bench.py JSON (or round "
                                   "file with a 'result' key)")
    p.add_argument("baseline", nargs="?", default=None,
                   help="baseline JSON (default: newest BENCH_r*.json "
                        "in --baseline-dir)")
    p.add_argument("--baseline-dir", default=".",
                   help="where to look for BENCH_r*.json when no "
                        "baseline is named (default: cwd)")
    p.add_argument("--band-scale", type=float, default=1.0,
                   help="multiply every noise band (e.g. 2.0 on a "
                        "known-noisy host)")
    p.add_argument("--min-compared", type=int, default=0,
                   help="fail (exit 1) unless at least this many "
                        "probes actually compared — guards a CI gate "
                        "against going silently INERT when every "
                        "probe skips (platform mismatch, failed "
                        "configs). Default 0: a fully-skipped round "
                        "passes with a loud stderr warning, since a "
                        "CPU rehearsal gated against a chip baseline "
                        "is legitimate")
    p.add_argument("--require-platform-stamp", action="store_true",
                   help="fail (exit 1) unless BOTH sides carry a "
                        "'platform' stamp. An unstamped pre-r06 "
                        "baseline is the one platform-AMBIGUOUS "
                        "pairing (the mismatch guard cannot fire), "
                        "so a chip round could silently gate against "
                        "a CPU record — chip-round CI should pass "
                        "this")
    p.add_argument("--json", action="store_true",
                   help="emit the verdict as one JSON object")
    args = p.parse_args(argv)

    baseline = args.baseline
    if baseline is None:
        baseline = latest_baseline(args.baseline_dir,
                                   exclude=args.current)
        if baseline is None:
            print("perfgate: no BENCH_r*.json baseline in %s"
                  % args.baseline_dir, file=sys.stderr)
            return 2
    try:
        verdict = compare(args.current, baseline,
                          band_scale=args.band_scale)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print("perfgate: bad input: %s" % e, file=sys.stderr)
        return 2
    verdict["baseline"] = str(baseline)
    unstamped = [side for side, plat in
                 (("current", verdict["platform"]),
                  ("baseline", verdict["baseline_platform"]))
                 if plat is None]
    print(json.dumps(verdict) if args.json else
          render(verdict) + "\n  baseline: %s" % baseline)
    if unstamped:
        print("perfgate: WARNING — %s side(s) carry no 'platform' "
              "stamp (pre-r06 round?): this comparison is "
              "platform-AMBIGUOUS — the CPU-vs-chip mismatch guard "
              "cannot fire, so these deltas may compare different "
              "hardware. Re-stamp the round (bench.py stamps "
              "platform since r06) or pass an explicit stamped "
              "baseline." % " and ".join(unstamped), file=sys.stderr)
        if args.require_platform_stamp:
            print("perfgate: --require-platform-stamp set — gate "
                  "FAILED on the ambiguous pairing", file=sys.stderr)
            return 1
    if verdict["compared"] < args.min_compared:
        print("perfgate: only %d probe(s) compared < --min-compared "
              "%d — gate FAILED" % (verdict["compared"],
                                    args.min_compared),
              file=sys.stderr)
        return 1
    if verdict["pass"] and verdict["compared"] == 0:
        print("perfgate: WARNING — 0 probes compared (every probe "
              "skipped); this gate verdict is INERT, not a clean "
              "bill of health", file=sys.stderr)
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
