"""Perf regression gate (): probe comparison semantics and
the 0/1/2 CLI exit-code contract over checked-in bench fixtures."""

import json
import os
import subprocess
import sys

import pytest

from paddle_tpu_torch import perfgate

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
BASE = os.path.join(FIX, "bench_base.json")
REGRESSED = os.path.join(FIX, "bench_regressed.json")
NOISY_OK = os.path.join(FIX, "bench_noisy_ok.json")
CHIP = os.path.join(FIX, "bench_chip.json")
BAD = os.path.join(FIX, "bench_bad.json")


def _cli(*argv):
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.perfgate"] + list(argv),
        capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return out.returncode, out.stdout, out.stderr


def test_self_compare_passes_exit_0():
    rc, out, _ = _cli(BASE, BASE)
    assert rc == 0
    assert "PASS" in out and "REGRESSION" not in out.splitlines()[0]


def test_doctored_regression_flagged_exit_1():
    rc, out, _ = _cli(REGRESSED, BASE, "--json")
    assert rc == 1
    v = json.loads(out)
    assert not v["pass"]
    assert "resnet_imgs_per_sec" in v["regressions"]
    assert "megastep_k8_tok_s" in v["regressions"]
    # unrelated probes stay green
    assert "serving_tok_s" not in v["regressions"]


def test_noise_band_absorbs_same_round_jitter():
    # -2% resnet / +4% megastep: inside every band -> pass
    rc, out, _ = _cli(NOISY_OK, BASE)
    assert rc == 0, out


def test_bad_input_exit_2():
    assert _cli(BAD, BASE)[0] == 2
    assert _cli("/nonexistent.json", BASE)[0] == 2
    rc, _, err = _cli(BASE, "--baseline-dir", FIX + "/nowhere")
    assert rc == 2 and "no BENCH_r" in err


def test_platform_mismatch_skips_not_screams():
    v = perfgate.compare(BASE, CHIP)
    assert v["pass"] and v["compared"] == 0
    assert all(p["status"] == "skipped" for p in v["probes"])
    assert "platform mismatch" in v["probes"][0]["reason"]


def test_measured_spread_widens_the_band():
    base = perfgate.load_result(BASE)
    cur = json.loads(json.dumps(base))
    # megastep k1 carries a measured 12% spread; a 15% drop would
    # breach the default 20%? no — band is max(20, 12) = 20 -> pass;
    # a 25% drop breaches it
    cur["megastep"]["k1_tok_s"] = base["megastep"]["k1_tok_s"] * 0.85
    v = perfgate.compare(cur, base)
    assert "megastep_k1_tok_s" not in v["regressions"]
    cur["megastep"]["k1_tok_s"] = base["megastep"]["k1_tok_s"] * 0.70
    v = perfgate.compare(cur, base)
    assert "megastep_k1_tok_s" in v["regressions"]


def test_lower_is_better_probe_direction():
    base = perfgate.load_result(BASE)
    cur = json.loads(json.dumps(base))
    cur["lstm_ms_per_batch"] = base["lstm_ms_per_batch"] * 1.5  # +50%
    v = perfgate.compare(cur, base)
    assert "lstm_ms_per_batch" in v["regressions"]
    cur["lstm_ms_per_batch"] = base["lstm_ms_per_batch"] * 0.5
    v = perfgate.compare(cur, base)
    assert "lstm_ms_per_batch" in v["improvements"]


def test_absolute_band_probe_router_overhead():
    base = perfgate.load_result(BASE)
    cur = json.loads(json.dumps(base))
    cur["fleet"]["router_overhead_pct"] = 5.0     # within ±10 points
    assert perfgate.compare(cur, base)["pass"]
    cur["fleet"]["router_overhead_pct"] = 15.0    # 16.7 points worse
    v = perfgate.compare(cur, base)
    assert "fleet_router_overhead_pct" in v["regressions"]


def test_missing_probe_skipped_with_reason():
    base = perfgate.load_result(BASE)
    cur = json.loads(json.dumps(base))
    del cur["megastep"]
    v = perfgate.compare(cur, base)
    ent = {p["name"]: p for p in v["probes"]}["megastep_k8_tok_s"]
    assert ent["status"] == "skipped" and "missing" in ent["reason"]
    assert v["pass"]                  # a failed config != a regression


def test_latest_baseline_picks_newest_loadable(tmp_path):
    (tmp_path / "BENCH_r03.json").write_text(json.dumps(
        {"result": {"metric": "m", "value": 1}}))
    (tmp_path / "BENCH_r07.json").write_text(json.dumps(
        {"rc": 1, "result": None}))       # aborted round: skipped
    (tmp_path / "BENCH_r05.json").write_text(json.dumps(
        {"result": {"metric": "m", "value": 2}}))
    best = perfgate.latest_baseline(str(tmp_path))
    assert best.endswith("BENCH_r05.json")
    assert perfgate.latest_baseline(
        str(tmp_path), exclude=best).endswith("BENCH_r03.json")


def test_load_result_historic_round_shapes():
    # r06+ "result" wrapper
    assert perfgate.load_result(
        {"result": {"metric": "m", "value": 1}})["value"] == 1
    # r04 "parsed"
    assert perfgate.load_result(
        {"parsed": {"metric": "m", "value": 2}})["value"] == 2
    # r01-r03: result only as the tail's last JSON line
    rec = {"tail": "noise\n{\"metric\": \"m\", \"value\": 3}"}
    assert perfgate.load_result(rec)["value"] == 3
    with pytest.raises(ValueError, match="metric"):
        perfgate.load_result({"nope": 1})


# -- platform-stamp ambiguity guard ( satellite) -------------------

def _unstamped(tmp_path, name="BENCH_r02.json"):
    """A pre-r06-shaped round with NO platform stamp — the one
    platform-AMBIGUOUS pairing (the mismatch guard cannot fire)."""
    base = perfgate.load_result(BASE)
    rec = json.loads(json.dumps(base))
    rec.pop("platform", None)
    path = tmp_path / name
    path.write_text(json.dumps({"result": rec}))
    return str(path)


def test_unstamped_baseline_warns_loudly(tmp_path):
    old = _unstamped(tmp_path)
    rc, out, err = _cli(BASE, old)
    assert rc == 0                        # advisory by default: the
    assert "platform-AMBIGUOUS" in err    # warning is loud, the CPU
    assert "baseline" in err              # rehearsal keeps passing
    # stamped-vs-stamped comparisons stay silent
    rc2, _, err2 = _cli(BASE, BASE)
    assert rc2 == 0 and "AMBIGUOUS" not in err2


def test_require_platform_stamp_gates_chip_ci(tmp_path):
    old = _unstamped(tmp_path)
    rc, _, err = _cli(BASE, old, "--require-platform-stamp")
    assert rc == 1
    assert "--require-platform-stamp" in err
    # both sides stamped: the flag is satisfied (CPU self-compare)
    rc2, _, _ = _cli(BASE, BASE, "--require-platform-stamp")
    assert rc2 == 0


# -- the port against the JAX package ---------------------------------------

def _rounds(tmp_path):
    """BENCH_r*.json rounds written here (none of the repository's):
    the fixture rounds under the round-file names, and an unstamped
    one."""
    paths = {}
    for i, src in enumerate((BASE, REGRESSED, NOISY_OK, CHIP), start=1):
        p = tmp_path / ("BENCH_r%02d.json" % i)
        p.write_text(open(src).read())
        paths[i] = str(p)
    paths["unstamped"] = _unstamped(tmp_path, "BENCH_r09.json")
    return paths


@pytest.mark.parametrize("case", [
    ("base", "base"), ("regressed", "base"), ("noisy", "base"),
    ("base", "chip"), ("base", "unstamped"), ("bad", "base"),
    ("base", "dir"), ("regressed", "dir")])
@pytest.mark.parametrize("as_json", [False, True])
def test_verdicts_equal_the_jax_package(case, as_json, tmp_path, capsys):
    """Both packages' ``perfgate.main`` on the same rounds: the same
    exit code and the same report, text or JSON."""
    from paddle_tpu import perfgate as jperfgate
    from torch_fleet_harness import run_main_both
    r = _rounds(tmp_path)
    files = {"base": r[1], "regressed": r[2], "noisy": r[3], "chip": r[4],
             "unstamped": r["unstamped"], "bad": BAD}
    argv = [files[case[0]]]
    argv += (["--baseline-dir", str(tmp_path)] if case[1] == "dir"
             else [files[case[1]]])
    if as_json:
        argv.append("--json")
    want, got = run_main_both("perfgate", argv, capsys)
    assert got == want
    if case == ("regressed", "base"):
        assert want[0] == 1
    assert [vars(p) for p in jperfgate.PROBES] == \
        [vars(p) for p in perfgate.PROBES]
