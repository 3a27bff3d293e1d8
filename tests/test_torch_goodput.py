"""Goodput/badput ledger (): golden attribution over a
checked-in chaos-run fixture, the exact sum-to-wall contract, the CLI,
the SLO goodput_fraction objective, and a LIVE armed run whose
injected stall shows up as badput."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import monitor, slo
from paddle_tpu_torch.monitor import goodput as gp

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "goodput_chaos.jsonl")


def test_ledger_golden_over_chaos_fixture():
    """Hand-computed attribution of the checked-in chaos timeline:
    every second of the 9 s wall is named (see the fixture rows —
    compile [0,1], steps, a fused serving megastep, a 1.5 s stall,
    retry/reconnect and resume gaps, an async checkpoint gap, a
    preemption gap)."""
    events, skipped = monitor.read_jsonl_tolerant(FIXTURE)
    assert skipped == 0
    led = gp.ledger_from_events(events)
    cats = led["categories"]
    assert led["wall_s"] == pytest.approx(9.0)
    assert cats["compile"] == pytest.approx(1.0)
    assert cats["productive"] == pytest.approx(4.0)
    assert cats["stall"] == pytest.approx(1.5)
    assert cats["fault_recovery"] == pytest.approx(1.4)
    assert cats["checkpoint"] == pytest.approx(0.5)
    assert cats["preemption"] == pytest.approx(0.1)
    assert cats["idle"] == pytest.approx(0.5)
    assert led["goodput_fraction"] == pytest.approx(4.0 / 9.0)
    # the attribution contract: categories sum to wall EXACTLY
    assert sum(cats.values()) == pytest.approx(led["wall_s"])
    assert led["counts"]["steps"] == 4
    assert led["counts"]["serving_steps"] == 6
    assert led["counts"]["tokens"] == 10
    assert led["counts"]["preemptions"] == 1


def test_ledger_degenerate_inputs():
    assert gp.ledger_from_events([])["goodput_fraction"] is None
    one = gp.ledger_from_events([{"ts": 5.0, "ev": "step",
                                  "dt": 1.0}])
    assert one["wall_s"] == 0.0 and one["goodput_fraction"] is None


def test_goodput_cli_single_and_fleet_rollup(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.monitor", "goodput",
         FIXTURE, "--json"],
        capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["processes"][FIXTURE]["wall_s"] == pytest.approx(9.0)
    # fleet rollup: two processes = the fixture + a copy of it
    twin = tmp_path / "replica1.jsonl"
    twin.write_text(open(FIXTURE).read())
    rep2 = gp.ledger([FIXTURE, str(twin)])
    assert rep2["fleet"]["wall_s"] == pytest.approx(18.0)
    assert rep2["fleet"]["categories"]["productive"] == \
        pytest.approx(8.0)
    assert rep2["fleet"]["goodput_fraction"] == \
        pytest.approx(4.0 / 9.0)
    text = gp.render(rep2)
    assert "FLEET" in text and "goodput 44.4%" in text


def test_slo_goodput_fraction_objective(tmp_path):
    spec_pass = {"name": "g", "objectives": [
        {"metric": "goodput_fraction", "min_ratio": 0.40}]}
    spec_fail = {"name": "g", "objectives": [
        {"metric": "goodput_fraction", "min_ratio": 0.60}]}
    samples = slo.samples_from_monitor_log(FIXTURE)
    assert samples["goodput"]["goodput_fraction"] == \
        pytest.approx(4.0 / 9.0)
    assert slo.evaluate(spec_pass, samples)["pass"]
    v = slo.evaluate(spec_fail, samples)
    assert not v["pass"]
    obj = v["objectives"][0]
    assert obj["measured"] == pytest.approx(4.0 / 9.0)
    assert ">=" in slo.render(v)
    # multi-log: per-process rollup, NOT a union timeline
    twin = tmp_path / "replica1.jsonl"
    twin.write_text(open(FIXTURE).read())
    samples2 = slo.samples_from_monitor_log([FIXTURE, str(twin)])
    assert samples2["goodput"]["wall_s"] == pytest.approx(18.0)
    assert samples2["goodput"]["goodput_fraction"] == \
        pytest.approx(4.0 / 9.0)
    # spec validation: min_ratio is mandatory
    with pytest.raises(ValueError, match="min_ratio"):
        slo.load_spec({"objectives": [
            {"metric": "goodput_fraction"}]})
    # CLI exit codes over the same fixture
    for spec, want in ((spec_pass, 0), (spec_fail, 1)):
        p = tmp_path / ("spec%d.json" % want)
        p.write_text(json.dumps(spec))
        rc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.slo", str(p),
             "--log", FIXTURE],
            capture_output=True, text=True,
            env=dict(os.environ, JAX_PLATFORMS="cpu")).returncode
        assert rc == want


def test_live_armed_run_attributes_injected_stall(tmp_path):
    """ acceptance (armed run): a monitored run with a real
    stall in the middle — the ledger attributes the full wall to
    named categories (sum == wall, the >=95%% bar by construction)
    with productive step time AND the stall visible as badput."""
    log = str(tmp_path / "armed.jsonl")
    monitor.enable(log_path=log, stall_timeout=0.2)
    try:
        x = fluid.layers.data("x", [8])
        loss = fluid.layers.mean(fluid.layers.fc(x, 4))
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        xv = np.random.rand(4, 8).astype(np.float32)
        for _ in range(5):
            exe.run(feed={"x": xv}, fetch_list=[loss])
        time.sleep(0.8)                  # the injected stall
        for _ in range(5):
            exe.run(feed={"x": xv}, fetch_list=[loss])
    finally:
        monitor.disable()
    events, _ = monitor.read_jsonl_tolerant(log)
    led = gp.ledger_from_events(events)
    cats = led["categories"]
    assert led["wall_s"] > 0.8
    # every second named: the attribution never leaks or double counts
    assert sum(cats.values()) == pytest.approx(led["wall_s"],
                                               rel=1e-6)
    assert cats["productive"] > 0
    assert cats["stall"] >= 0.2          # the injected badput, visible
    assert led["goodput_fraction"] is not None
    # and the SLO gate sees the same figure
    v = slo.evaluate(
        {"objectives": [{"metric": "goodput_fraction",
                         "min_ratio": 0.999}]},
        slo.samples_from_monitor_log(log))
    assert not v["pass"]                 # the stall burned the budget


# -- the port against the JAX package ---------------------------------------

def test_ledger_equals_the_jax_package(tmp_path):
    """The breakdown of the chaos fixture, alone and rolled up with a
    second process, is the JAX package's, figure for figure."""
    from paddle_tpu.monitor import goodput as jgp
    events, _ = monitor.read_jsonl_tolerant(FIXTURE)
    assert gp.ledger_from_events(events) == jgp.ledger_from_events(events)
    twin = tmp_path / "replica1.jsonl"
    twin.write_text(open(FIXTURE).read())
    paths = [FIXTURE, str(twin)]
    assert gp.ledger(paths) == jgp.ledger(paths)
    assert gp.render(gp.ledger(paths)) == jgp.render(jgp.ledger(paths))


@pytest.mark.parametrize("as_json", [False, True])
def test_goodput_cli_equals_the_jax_package(as_json, tmp_path, capsys):
    from torch_fleet_harness import run_main_both
    twin = tmp_path / "replica1.jsonl"
    twin.write_text(open(FIXTURE).read())
    argv = ["goodput", FIXTURE, str(twin)] + (["--json"] if as_json
                                               else [])
    want, got = run_main_both("monitor.__main__", argv, capsys)
    assert got == want
