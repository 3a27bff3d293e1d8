"""paddle_tpu_torch.serving.rollout: the canary analysis plane, chaos-gated
().

Tiers:

  * Mirror sampler + delta-spec units (no fleet): deterministic
    rid-hash sampling, loud delta-spec validation, the pure
    ``slo.evaluate_delta`` verdict arithmetic, and the DeltaRule's
    exactly-once decision (pending until the pair/request gates,
    one FIRING on FAIL, silence on PASS, forced override).
  * The accounting seam (satellite 4): shadow rows are EXCLUDED
    wholesale from the incumbent SLO surface — serving samples,
    error counters, queue/occupancy gauges, ``scale_hint()`` — while
    errored shadow rows still reach the offender ring.
  * THE CHAOS GATE (tier-1 smoke + ``-m slow`` soak, seeded like
    test_autoscale.py): a full artifact -> shadow -> canary ->
    promote pipeline under seeded frame faults with a candidate
    KILLED mid-shadow and mid-canary — the verdicts land
    exactly-once from >= min_pairs joined pairs, every accepted
    request completes exactly once, token-identical to the
    fault-free sequential baseline, zero shed; and a DEGRADED
    candidate (different weights -> token disagreement) FAILs,
    auto-rolls-back before serving a single candidate-only token,
    and opens an exactly-once incident whose forensics bundle names
    the candidate version.
"""

import json
import threading
import time

import pytest

from paddle_tpu_torch import monitor, serving, slo
from paddle_tpu_torch.monitor import runtime as monrt
from paddle_tpu_torch.monitor import signals as msignals
from paddle_tpu_torch.monitor.watch import (WatchState, render_frame,
                                            rollout_line)
from paddle_tpu_torch.distributed.membership import KVServer, KVClient
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.autoscale import Autoscaler
from paddle_tpu_torch.serving.fleet import Router
from paddle_tpu_torch.serving.rollout import (RolloutController,
                                              fetch_verdicts)

from torch_fleet_harness import (VOCAB, engines_on_the_cpu, lm_pair,
                                 save_artifacts)


@pytest.fixture(autouse=True)
def _cpu_engines(monkeypatch):
    engines_on_the_cpu(monkeypatch)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """One tiny LM saved as v1/v2 (same weights: PASS + token identity
    across the promotion is the contract) plus v_bad — same interface,
    DIFFERENT weights (d_inner halved, fresh init), whose greedy
    decode disagrees with the incumbent: the token-agreement delta
    objective must FAIL it."""
    import paddle_tpu as jfluid
    from paddle_tpu import serving as jserving
    from paddle_tpu.models import transformer
    from torch_fleet_harness import D_MODEL, MAX_LEN, N_HEAD, N_LAYER
    base = tmp_path_factory.mktemp("canary")
    out = save_artifacts(base)
    out["lm"] = lm_pair()[1]
    main_b, startup_b = jfluid.Program(), jfluid.Program()
    scope_b = jfluid.Scope()
    with jfluid.program_guard(main_b, startup_b), \
            jfluid.scope_guard(scope_b):
        _, logits_b = transformer.transformer_lm(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=32)
        jfluid.Executor(jfluid.CPUPlace()).run(startup_b)
    out["v_bad"] = str(base / "v_bad")
    jserving.save_lm_artifact(out["v_bad"], main_b, scope_b, [logits_b],
                              N_LAYER, N_HEAD, D_MODEL, MAX_LEN)
    return out


def _requests(rng, n, max_prompt=8, min_new=4, max_new=10):
    reqs = []
    for _ in range(n):
        plen = int(rng.randint(1, max_prompt + 1))
        prompt = [1] + rng.randint(3, VOCAB, plen - 1).tolist()
        reqs.append((prompt, int(rng.randint(min_new, max_new + 1))))
    return reqs


DELTA = {
    "window_s": 300.0, "min_pairs": 6, "min_requests": 6,
    "objectives": [
        # thresholds are deliberately loose: a loaded CI host must
        # not flake the latency ratio, and injected chaos legitimately
        # fails a few in-flight candidate copies (a kill right before
        # the gates fill concentrates error pairs in a tiny sample) —
        # the degradation signal under test is token agreement
        {"metric": "delta_ttft", "percentile": 0.95,
         "max_inflation": 50.0, "min_floor_s": 0.5},
        {"metric": "delta_error_rate", "max_delta": 0.75},
        {"metric": "token_agreement", "min_ratio": 0.9},
    ],
}


# -- sampler + spec units ---------------------------------------------------

def test_mirror_sampler_deterministic():
    """The shadow/canary sampler is a pure rid hash: the same rid
    always lands on the same side of the fraction (replica-count and
    call-order independent), 0.0 selects nothing, 1.0 everything, and
    the selected fraction tracks the configured one."""
    rids = ["r%04d" % i for i in range(2000)]
    for frac in (0.1, 0.25, 0.5):
        picked = [r for r in rids if Router._sampled(r, frac)]
        assert picked == [r for r in rids if Router._sampled(r, frac)]
        assert abs(len(picked) / len(rids) - frac) < 0.06
    assert not [r for r in rids if Router._sampled(r, 0.0)]
    assert len([r for r in rids if Router._sampled(r, 1.0)]) == 2000


def test_validate_delta_spec_loud():
    assert slo.validate_delta_spec(DELTA)["min_pairs"] == 6
    with pytest.raises(ValueError, match="objectives"):
        slo.validate_delta_spec({"objectives": []})
    with pytest.raises(ValueError, match="max_inflation"):
        slo.validate_delta_spec({"objectives": [
            {"metric": "delta_ttft", "percentile": 0.95}]})
    with pytest.raises(ValueError, match="percentile"):
        slo.validate_delta_spec({"objectives": [
            {"metric": "delta_tpot", "percentile": 1.5,
             "max_inflation": 2.0}]})
    with pytest.raises(ValueError, match="max_delta"):
        slo.validate_delta_spec({"objectives": [
            {"metric": "delta_error_rate"}]})
    with pytest.raises(ValueError, match="min_ratio"):
        slo.validate_delta_spec({"objectives": [
            {"metric": "token_agreement"}]})
    with pytest.raises(ValueError, match="unknown metric"):
        slo.validate_delta_spec({"objectives": [
            {"metric": "delta_goodput", "max_inflation": 2.0,
             "percentile": 0.5}]})
    # load_spec validates an embedded delta block the same way
    with pytest.raises(ValueError, match="unknown metric"):
        slo.load_spec({"objectives": [
            {"metric": "error_rate", "target": 0.99,
             "windows": [{"short_s": 60, "long_s": 300,
                          "burn_rate": 2.0}]}],
            "delta": {"objectives": [{"metric": "nope"}]}})


def test_evaluate_delta_arithmetic():
    now = 1000.0

    def req(side_shadow, ttft, err=None, version="v2"):
        e = {"ev": "serving_request", "ts": now, "ttft": ttft,
             "tpot": 0.001, "queue_wait": 0.0}
        if side_shadow:
            e["shadow"], e["version"] = True, version
        if err:
            e["error"] = err
        return e

    events = [req(False, 0.010) for _ in range(8)] \
        + [req(True, 0.012) for _ in range(8)] \
        + [{"ev": "mirror_pair", "ts": now, "version": "v2",
            "rid": "r%d" % i, "agree": i != 0, "match": 1.0}
           for i in range(8)]
    ds = slo.delta_samples_from_events(events, "v2")
    assert ds["pairs"] == 8 and ds["agree"] == 7
    assert ds["cand"]["requests"] == ds["inc"]["requests"] == 8
    rep = slo.evaluate_delta(
        {"objectives": [
            {"metric": "delta_ttft", "percentile": 0.95,
             "max_inflation": 1.5},
            {"metric": "delta_error_rate", "max_delta": 0.01},
            {"metric": "token_agreement", "min_ratio": 0.8}]}, ds)
    assert rep["pass"], rep
    by = {o["metric"]: o for o in rep["objectives"]}
    assert abs(by["delta_ttft"]["measured"] - 1.2) < 1e-6
    assert by["delta_error_rate"]["measured"] == 0.0
    assert by["token_agreement"]["measured"] == 7 / 8
    # inflation above threshold flips the verdict
    rep = slo.evaluate_delta(
        {"objectives": [{"metric": "delta_ttft", "percentile": 0.95,
                         "max_inflation": 1.1}]}, ds)
    assert not rep["pass"]
    # ... unless the candidate percentile sits under the absolute
    # floor: ratio inflation over a near-zero baseline is not a
    # regression (cand p95 = 12 ms here)
    rep = slo.evaluate_delta(
        {"objectives": [{"metric": "delta_ttft", "percentile": 0.95,
                         "max_inflation": 1.1,
                         "min_floor_s": 0.05}]}, ds)
    assert rep["pass"], rep
    assert "floor" in rep["objectives"][0]["reason"]
    with pytest.raises(ValueError, match="min_floor_s"):
        slo.validate_delta_spec(
            {"objectives": [{"metric": "delta_ttft",
                             "max_inflation": 1.1,
                             "min_floor_s": -1}]})
    # a side with no samples is a FAIL with a reason, never a crash
    rep = slo.evaluate_delta(
        {"objectives": [{"metric": "delta_tpot", "percentile": 0.5,
                         "max_inflation": 2.0}]},
        slo.delta_samples_from_events([], "v2"))
    assert not rep["pass"]
    assert "no" in rep["objectives"][0]["reason"]
    # errored candidate requests are excluded from latency per side
    # (the failed-request exclusion), but counted in the error-rate
    # delta
    events2 = [req(False, 0.010) for _ in range(4)] \
        + [req(True, 5.0, err="boom"), req(True, 0.011)]
    ds2 = slo.delta_samples_from_events(events2, "v2")
    assert ds2["cand"]["errors"] == 1
    assert ds2["cand"]["ttft"] == [0.011]


def test_delta_rule_exactly_once(tmp_path):
    """PENDING until the gates; decides once; PASS never fires; FAIL
    fires exactly one page-severity edge; the verdict recorder row
    lands exactly once either way."""
    mlog = str(tmp_path / "verdicts.jsonl")
    with monitor.session(log_path=mlog):
        now = time.time()
        inc = [{"ev": "serving_request", "ts": now, "ttft": 0.01,
                "tpot": 0.001, "queue_wait": 0.0} for _ in range(6)]
        sh = [{"ev": "serving_request", "ts": now, "ttft": 0.01,
               "tpot": 0.001, "queue_wait": 0.0, "shadow": True,
               "version": "v2"} for _ in range(6)]
        pairs = [{"ev": "mirror_pair", "ts": now, "version": "v2",
                  "rid": "r%d" % i, "agree": True, "match": 1.0}
                 for i in range(6)]
        rule = msignals.DeltaRule(DELTA, "v2", phase="shadow")
        sig = msignals.Signals(rules=[rule])
        sig.feed_events(inc + sh, now=now)     # no pairs yet: pending
        assert sig.evaluate(now=now) == []
        assert rule.verdict is None
        sig.feed_events(pairs, now=now)
        assert sig.evaluate(now=now) == []     # PASS: no edge
        assert rule.verdict == "PASS"
        assert sig.evaluate(now=now + 1) == []

        # a pair set that disagrees -> FAIL fires EXACTLY once
        bad = [dict(p, agree=False, match=0.4) for p in pairs]
        rule2 = msignals.DeltaRule(DELTA, "v3", phase="shadow")
        sig2 = msignals.Signals(rules=[rule2])
        sig2.feed_events(
            inc + [dict(e, version="v3") for e in sh]
            + [dict(p, version="v3") for p in bad], now=now)
        edges = sig2.evaluate(now=now)
        assert [e["state"] for e in edges] == ["FIRING"]
        assert edges[0]["severity"] == "page"
        assert rule2.verdict == "FAIL"
        assert sig2.evaluate(now=now + 1) == []
        assert sig2.evaluate(now=now + 100) == []
    rows = monitor.read_jsonl(mlog)
    verd = [r for r in rows if r["ev"] == "verdict"]
    assert [(v["version"], v["verdict"]) for v in verd] == \
        [("v2", "PASS"), ("v3", "FAIL")]


# -- the accounting seam (satellite 4) --------------------------------------

def test_shadow_rows_excluded_from_slo_surface():
    """Armed shadow must leave the incumbent surface untouched:
    samples_from_events drops shadow rows, Signals neither samples
    nor counts them (errored ones still reach the offender ring),
    and shadow serving_step rows never vote in the queue/occupancy
    gauges scale_hint() reads."""
    now = time.time()
    shadow_req = {"ev": "serving_request", "ts": now, "ttft": 9.0,
                  "tpot": 9.0, "queue_wait": 9.0, "shadow": True,
                  "version": "v2"}
    shadow_err = dict(shadow_req, error="candidate exploded",
                      trace="t-shadow")
    shadow_step = {"ev": "serving_step", "ts": now, "dt": 9.0,
                   "engine": "cand", "queue_depth": 50, "slots": 2,
                   "active": 2, "shadow": True, "version": "v2"}
    samples = slo.samples_from_events(
        [shadow_req, shadow_err, shadow_step], compute_goodput=False)
    assert samples["requests"] == 0 and samples["errors"] == 0
    assert samples["ttft"] == []

    sig = msignals.Signals(spec=None)
    sig.feed_events([shadow_req, shadow_err, shadow_step], now=now)
    assert sig._row_totals["requests"] == 0
    assert sig._row_totals["errors"] == 0
    assert not sig._samples.get("ttft")
    assert not sig._samples.get("step_latency")
    assert "queue_depth" not in sig._series
    assert "occupancy" not in sig._series
    assert sig.scale_hint().direction == "hold"
    offs = list(sig._offenders)
    assert len(offs) == 1 and offs[0]["trace"] == "t-shadow"

    # the identical rows WITHOUT the shadow mark do land (the seam is
    # the flag, not the shape)
    sig2 = msignals.Signals(spec=None)
    live = [{k: v for k, v in e.items() if k != "shadow"}
            for e in (shadow_req, shadow_step)]
    sig2.feed_events(live, now=now)
    assert sig2._row_totals["requests"] == 1
    assert "queue_depth" in sig2._series


def test_shadow_engine_rows_skip_serving_metrics(tmp_path):
    """runtime.on_serving_step/on_serving_request with shadow=True
    tick ONLY the mirror surface: serving tokens/latency histograms
    and engine gauges keep their incumbent-only meaning."""
    with monitor.session(log_path=str(tmp_path / "m.jsonl")):
        tok0 = sum(monrt.SERVING_TOKENS.snapshot().values())
        mir0 = sum(monrt.MIRROR_TOKENS.snapshot().values())
        t0 = {k: v["count"] for k, v
              in monrt.SERVING_TTFT.snapshot().items()}
        monrt.on_serving_step(active=2, slots=2, queue_depth=7,
                              emitted=3, engine="cand-eng", dt=0.01,
                              shadow=True, version="v2")
        monrt.on_serving_request("cand-eng", ttft=0.5, tpot=0.1,
                                 queue_wait=0.2, shadow=True,
                                 version="v2")
        assert sum(monrt.SERVING_TOKENS.snapshot().values()) == tok0
        assert sum(monrt.MIRROR_TOKENS.snapshot().values()) \
            == mir0 + 3
        t1 = {k: v["count"] for k, v
              in monrt.SERVING_TTFT.snapshot().items()}
        assert t1 == t0
        occ = monrt.SERVING_SLOT_OCCUPANCY.snapshot()
        assert ("cand-eng",) not in occ


def test_late_candidate_result_never_completes_serving_entry():
    """A candidate's LATE shadow result — its mirror job already
    dropped by disarm/sweep while the grace-window poller kept
    draining — must be acked-and-dropped, never fall through to the
    journal and complete the still-pending serving entry with
    candidate-generated tokens (the 'rollback serves zero
    candidate-only tokens' invariant). Canary-marked entries are the
    one legitimate candidate-completion path and must stay open."""
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    router = None
    try:
        router = Router(kvs.endpoint, refresh_interval=5.0,
                        name="lateshadow")
        cand = fleet._CAND_BASE + 0

        # shadow entry whose mirror job was dropped (disarm): the
        # late candidate result must not touch the journal entry
        router.arm_shadow("v2", fraction=1.0)
        h = router.submit([1, 2, 3], 4)
        rid = h.rid
        assert rid in router._mirror_jobs
        router.disarm_mirror()
        dropped0 = router.stats["mirror_dropped"]
        assert router._complete(
            cand, {"id": rid, "tokens": [9, 9, 9], "score": 0.0})
        with router._lock:
            entry = router._journal[rid]
            assert entry["state"] == "queued"
            assert not h._event.is_set()
        assert router.stats["completed"] == 0
        assert router.stats["canary_served"] == 0
        assert router.stats["mirror_dropped"] == dropped0 + 1

        # canary-marked entry: a candidate slot MAY complete it
        router.arm_canary("v2", weight=1.0)
        h2 = router.submit([1, 2, 3], 4)
        with router._lock:
            assert router._journal[h2.rid].get("canary")
        assert router._complete(
            cand, {"id": h2.rid, "tokens": [7, 8], "score": 0.5})
        assert h2.result(timeout=5) == ([7, 8], 0.5)
    finally:
        if router is not None:
            router.close()
        try:
            kv.shutdown_server()
            kv.close()
        except OSError:
            pass


def test_stall_evicted_candidate_tombstone_sticks():
    """Evicting a candidate must tombstone its MARKED lease value
    ('version:<ver>:<ep>' — Replica stamps it at boot): a
    bare-endpoint CAS never matches a marked lease, so the wedged
    holder's expect-guarded keepalive would keep winning and stall
    recovery would degrade into evict/re-add churn instead of the
    rollout controller's bounded respawn."""
    from paddle_tpu_torch.distributed import membership as _mem
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    router = None
    try:
        router = Router(kvs.endpoint, refresh_interval=5.0,
                        name="tomb")
        ep = "127.0.0.1:59999"
        key = _mem.role_prefix(fleet.CANDIDATE_ROLE) + "0"
        kv.put(key, fleet.VERSION_PREFIX + "v2:" + ep, ttl=30.0)
        slot = fleet._CAND_BASE + 0

        class _Client:
            def close(self):
                pass

        with router._cv:
            router._replicas[slot] = {"endpoint": ep,
                                      "client": _Client()}
            router._inflight.setdefault(slot, set())
            router._cand_versions[slot] = "v2"
        assert router._replica_down(slot, ep, "stall")
        assert kv.get(key) == fleet.EVICTED_PREFIX + ep
    finally:
        if router is not None:
            router.close()
        try:
            kv.shutdown_server()
            kv.close()
        except OSError:
            pass


# -- the chaos gate ---------------------------------------------------------

CHAOS_SPEC = {
    "rpc": {"drop": 0.03, "duplicate": 0.03, "close_mid_frame": 0.02,
            "delay": 0.05, "delay_s": 0.003, "max": 6},
    "kill": [{"target": "shadow", "after": 2},
             {"target": "canary", "after": 1}],
}


def _run_rollout_chaos(arts, reqs, seq, seed, tmp_path, tag):
    """KV + autoscaler (2 incumbents from v1) + router; armed seeded
    plan (frame faults on the incumbents' ports, candidate kills
    mid-shadow and mid-canary); traffic flows while the controller
    drives artifact v2 -> shadow -> canary -> promote. Asserts the
     acceptance invariants."""
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    auto = router = ctl = plan = None
    try:
        auto = Autoscaler(kvs.endpoint, arts["v1"], desired=2,
                          min_replicas=1, max_replicas=5, slots=2,
                          ttl=0.4, interval=0.05, cooldown=0.0,
                          drain_timeout=15.0, health_timeout=15.0,
                          prefill_chunk=4).start()
        auto.wait_steady(timeout=30)
        spec = dict(CHAOS_SPEC)
        rpc_spec = dict(spec["rpc"])
        rpc_spec["ports"] = [c.server.port for c in auto.cells]
        spec["rpc"] = rpc_spec
        plan = faults.arm(spec, seed=seed)
        router = Router(kvs.endpoint, window=3, max_queue=64,
                        stall_timeout=1.0, refresh_interval=0.05,
                        client_timeout=0.8, name="canary-" + tag)
        router.wait_for_replicas(2, timeout=15)
        desired0 = auto.status()["desired"]

        ctl = RolloutController(
            kvs.endpoint, router, auto, arts["v2"],
            {"delta": DELTA}, candidates=2, shadow_fraction=1.0,
            canary_weight=0.4, verdict_timeout=60.0, max_respawns=4,
            slots=2, ttl=0.4, prefill_chunk=4)
        done = {}
        th = threading.Thread(
            target=lambda: done.update(st=ctl.run()), daemon=True)
        th.start()

        out, i = [], 0
        deadline = time.monotonic() + 180
        while th.is_alive():
            batch = [reqs[j % len(reqs)]
                     for j in range(i, i + 4)]
            hs = [router.submit(p, m) for p, m in batch]
            got = [h.result(timeout=120) for h in hs]
            for j, (bt, bs) in enumerate(got):
                assert bt == seq[(i + j) % len(reqs)][0], \
                    "request %d diverged" % (i + j)
            out += got
            i += 4
            if time.monotonic() > deadline:
                raise AssertionError(
                    "rollout did not terminate: %r" % ctl.status())
        th.join(timeout=120)
        st = done.get("st") or ctl.status()

        # PASS promoted the artifact, verdicts landed per phase
        assert st["phase"] == "promoted", st
        assert st["verdicts"]["shadow"]["verdict"] == "PASS"
        assert st["verdicts"]["canary"]["verdict"] == "PASS"
        assert st["verdicts"]["shadow"]["pairs"] \
            >= DELTA["min_pairs"]
        assert st["convergence_s"] and st["convergence_s"] > 0

        # chaos actually fired: frame faults + both mid-phase kills
        kinds = {k for k, _ in plan.trips}
        assert kinds & {"drop", "duplicate", "close_mid_frame",
                        "delay"}, plan.trips
        assert ("kill", "shadow") in plan.trips, plan.trips
        assert ("kill", "canary") in plan.trips, plan.trips
        assert ctl.respawns >= 1

        # exactly-once, zero shed, zero failures on the serving path
        rst = router.stats
        assert rst["failed"] == 0
        assert rst["shed"] == 0
        assert rst["completed"] == rst["requests"] == len(out)
        assert rst["mirror_pairs"] >= DELTA["min_pairs"]
        assert rst["canary_served"] >= 1

        # the fleet converged to v2-only; elasticity was untouched
        fst = auto.wait_steady(timeout=30)
        assert fst["version_mix"].get("v2") == 2
        assert not fst["version_mix"].get("v1")
        assert auto.status()["desired"] == desired0

        # verdicts are served on the wire (VERD, idempotent)
        verd = fetch_verdicts(ctl.control.endpoint)
        assert verd["phase"] == "promoted"
        assert verd["verdicts"]["shadow"]["verdict"] == "PASS"
        return ctl
    finally:
        faults.disarm()
        if ctl is not None:
            ctl.close()
        if router is not None:
            router.close()
        if auto is not None:
            auto.close()
        try:
            kv.shutdown_server()
            kv.close()
        except OSError:
            pass


def test_rollout_chaos_pass_promotes(rng, arts, tmp_path):
    """Tier-1 gate: the full pipeline under seeded frame faults +
    mid-shadow and mid-canary candidate kills — PASS verdicts from
    joined pairs, token-identical exactly-once completion, zero shed,
    fleet promoted to v2."""
    reqs = _requests(rng, 12, min_new=4, max_new=8)
    seq = serving.sequential_generate(arts["lm"], reqs)
    mlog = str(tmp_path / "rollout-mon.jsonl")
    with monitor.session(log_path=mlog):
        _run_rollout_chaos(arts, reqs, seq, seed=1907,
                           tmp_path=tmp_path, tag="smoke")
    rows = monitor.read_jsonl(mlog)
    # exactly one verdict row per phase (the exactly-once contract on
    # the evidence surface itself)
    verd = [r for r in rows if r["ev"] == "verdict"]
    assert [(v["phase"], v["verdict"]) for v in verd] == \
        [("shadow", "PASS"), ("canary", "PASS")]
    pairs = [r for r in rows if r["ev"] == "mirror_pair"]
    assert len(pairs) >= DELTA["min_pairs"]
    assert all(r["version"] == "v2" and r["rid"] for r in pairs)
    # same weights -> every CLEAN pair agrees; a copy cut down by the
    # chaos kill joins as a disagreeing pair carrying the error (the
    # error-rate delta's evidence), never as silent agreement
    clean = [r for r in pairs if not r.get("candidate_error")]
    assert clean and all(r["agree"] for r in clean)
    phases = [r["phase"] for r in rows if r["ev"] == "rollout"]
    assert phases[0] == "boot" and phases[-1] == "promoted"
    assert "shadow" in phases and "canary" in phases \
        and "rolling" in phases
    # mirrored rows are marked; canary-served rows carry the version
    sreq = [r for r in rows if r["ev"] == "serving_request"]
    assert any(r.get("shadow") for r in sreq)
    assert any(r.get("version") == "v2" and not r.get("shadow")
               for r in sreq)
    # the watch dashboard renders the status line from the same rows
    st = WatchState()
    for r in rows:
        st.feed_event(r)
    line = rollout_line(st)
    assert "phase promoted" in line and "v2" in line
    assert "shadow:PASS" in line and "canary:PASS" in line
    assert "convergence" in line
    frame = render_frame(st, mlog, now=time.time())
    assert "rollout" in frame


def test_rollout_degraded_candidate_rolls_back(rng, arts, tmp_path):
    """The FAIL path end-to-end: a candidate with DIFFERENT weights
    fails token agreement in shadow, the rollout auto-rolls-back
    WITHOUT serving a single candidate-only token, and the
    exactly-once incident carries a forensics bundle naming the
    candidate version."""
    reqs = _requests(rng, 10, min_new=4, max_new=8)
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    auto = router = ctl = None
    mlog = str(tmp_path / "fail-mon.jsonl")
    try:
        with monitor.session(log_path=mlog):
            auto = Autoscaler(kvs.endpoint, arts["v1"], desired=2,
                              min_replicas=1, max_replicas=4,
                              slots=2, ttl=0.4, interval=0.05,
                              cooldown=0.0,
                              prefill_chunk=4).start()
            auto.wait_steady(timeout=30)
            router = Router(kvs.endpoint, window=3, max_queue=64,
                            stall_timeout=1.0,
                            refresh_interval=0.05,
                            client_timeout=0.8, name="canary-fail")
            router.wait_for_replicas(2, timeout=15)
            ctl = RolloutController(
                kvs.endpoint, router, auto, arts["v_bad"],
                {"delta": DELTA}, candidates=1,
                shadow_fraction=1.0, verdict_timeout=60.0,
                slots=2, ttl=0.4, prefill_chunk=4, capture=True,
                capture_dir=str(tmp_path / "bundles"))
            done = {}
            th = threading.Thread(
                target=lambda: done.update(st=ctl.run()),
                daemon=True)
            th.start()
            i = 0
            deadline = time.monotonic() + 180
            while th.is_alive():
                hs = [router.submit(p, m)
                      for p, m in reqs[i % len(reqs):
                                       i % len(reqs) + 3]]
                for h in hs:
                    h.result(timeout=120)
                i += 3
                if time.monotonic() > deadline:
                    raise AssertionError(
                        "no verdict: %r" % ctl.status())
            th.join(timeout=120)
            st = done.get("st") or ctl.status()

            assert st["phase"] == "rolled-back", st
            rep = st["verdicts"]["shadow"]
            assert rep["verdict"] == "FAIL"
            agree = [o for o in rep["objectives"]
                     if o["metric"] == "token_agreement"]
            assert agree and agree[0]["pass"] is False
            # ZERO candidate-only tokens were served: canary never
            # armed, no canary completion ever counted
            assert router.stats["canary_served"] == 0
            assert router.stats["canary"] == 0
            # the incumbent fleet is intact, single-version
            fst = auto.wait_steady(timeout=30)
            assert fst["version_mix"] == {"v1": 2}
            assert router.mirror_status()["mirror"] is None
            # ...and still serves, token-identically
            seq = serving.sequential_generate(arts["lm"], reqs[:3])
            hs = [router.submit(p, m) for p, m in reqs[:3]]
            for (bt, _), h in zip(seq, hs):
                assert h.result(timeout=120)[0] == bt
    finally:
        if ctl is not None:
            ctl.close()
        if router is not None:
            router.close()
        if auto is not None:
            auto.close()
        try:
            kv.shutdown_server()
            kv.close()
        except OSError:
            pass
    rows = monitor.read_jsonl(mlog)
    verd = [r for r in rows if r["ev"] == "verdict"]
    assert len(verd) == 1 and verd[0]["verdict"] == "FAIL"
    assert verd[0]["version"] == "v_bad"
    # exactly-once incident: one FIRING alert row for the delta rule
    alerts = [r for r in rows if r["ev"] == "alert"
              and r["rule"].startswith("delta:")]
    assert len(alerts) == 1
    assert alerts[0]["state"] == "FIRING"
    assert alerts[0]["severity"] == "page"
    assert "v_bad" in alerts[0]["rule"]
    phases = [r["phase"] for r in rows if r["ev"] == "rollout"]
    assert phases[-1] == "rolled-back"
    assert "canary" not in phases and "rolling" not in phases
    # the forensics bundle landed and its incident names the version
    from paddle_tpu_torch.monitor import forensics
    bundles = sorted((tmp_path / "bundles").glob("bundle-*"))
    assert bundles, "no forensics bundle captured"
    man = forensics.load_manifest(str(bundles[-1]))
    assert "v_bad" in (man.get("rule") or "")
    assert man.get("incident_file") == "incident.json"
    with open(bundles[-1] / "incident.json") as f:
        inc = json.load(f)
    assert "v_bad" in inc.get("rule", "")


def test_rollout_forced_fail_serves_nothing(rng, arts, tmp_path):
    """force_fail (the operator override / drill path) rolls back
    from shadow without waiting for the gates — and provably without
    a single candidate-served token."""
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    auto = router = ctl = None
    try:
        with monitor.session(log_path=str(tmp_path / "m.jsonl")):
            auto = Autoscaler(kvs.endpoint, arts["v1"], desired=1,
                              min_replicas=1, max_replicas=3,
                              slots=2, ttl=0.4, interval=0.05,
                              prefill_chunk=4).start()
            auto.wait_steady(timeout=30)
            router = Router(kvs.endpoint, window=3,
                            refresh_interval=0.05,
                            client_timeout=0.8,
                            name="canary-forced")
            router.wait_for_replicas(1, timeout=15)
            ctl = RolloutController(
                kvs.endpoint, router, auto, arts["v2"],
                {"delta": DELTA}, candidates=1,
                shadow_fraction=1.0, verdict_timeout=60.0,
                slots=2, ttl=0.4, prefill_chunk=4)
            ctl.force_fail("chaos drill")
            st = ctl.run()
            assert st["phase"] == "rolled-back"
            rep = st["verdicts"]["shadow"]
            assert rep["verdict"] == "FAIL" and rep.get("forced")
            assert rep["reason"] == "chaos drill"
            assert router.stats["canary_served"] == 0
            assert router.stats["canary"] == 0
            assert auto.wait_steady(timeout=30)["version_mix"] == \
                {"v1": 1}
    finally:
        if ctl is not None:
            ctl.close()
        if router is not None:
            router.close()
        if auto is not None:
            auto.close()
        try:
            kv.shutdown_server()
            kv.close()
        except OSError:
            pass


@pytest.mark.slow
def test_rollout_chaos_soak_three_runs(rng, arts, tmp_path):
    """The acceptance soak: the seeded rollout-chaos scenario passes
    3 consecutive times (fresh fleet each time)."""
    reqs = _requests(rng, 12, min_new=4, max_new=8)
    seq = serving.sequential_generate(arts["lm"], reqs)
    for attempt in range(3):
        with monitor.session(
                log_path=str(tmp_path / ("soak%d.jsonl" % attempt))):
            _run_rollout_chaos(arts, reqs, seq, seed=4242,
                               tmp_path=tmp_path,
                               tag="soak%d" % attempt)
