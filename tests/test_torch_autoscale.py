"""paddle_tpu_torch.serving.autoscale: the elastic fleet, chaos-gated
().

Tiers:

  * Drain protocol units (no control loop): the membership drain mark
    (``_Lease.mark`` re-values a live lease in place — it must KEEP
    beating under the new value), the replica-side drain asymmetry
    (SUBM → typed ``DRNG`` NACK while duplicate-SUBM/POLL/CANC/STAT
    keep serving), and the router's penalty-free re-dispatch on a DRNG
    it learns about only from the wire.
  * Scale-hint plumbing: ``Signals.evaluate()`` feeds its
    ``scale_hint()`` into the controller's ``offer_hint`` (the
    capture-hook pattern), which moves ``desired`` under bounds +
    cooldown and refuses during a roll.
  * Roll ABORT: a v2 that cannot boot, and a v2 that boots but fails
    its health gate, each halt the ROLL — never the fleet; the
    surviving v1 keeps serving.
  * THE CHAOS GATE (tier-1 smoke + ``-m slow`` soak, seeded like
    test_fleet.py): one fleet scales 2→4→2 under frame faults with a
    replica KILLED mid-scale-down, then rolls v1→v2 under live traffic
    with a replica KILLED mid-roll — every accepted request completes
    exactly once, token-identical to the fault-free sequential
    baseline; zero requests shed during the roll; the final fleet
    serves only v2, observable in STAT, the controller's status, the
    version-mix gauge, and the recorder's scale_event/drain/roll rows.
"""

import time

import numpy as np
import pytest

from paddle_tpu_torch import monitor, serving
from paddle_tpu_torch.distributed import membership
from paddle_tpu_torch.distributed.membership import (KVServer, KVClient,
                                                     live_endpoints)
from paddle_tpu_torch.monitor import runtime as monrt
from paddle_tpu_torch.monitor import signals as msignals
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.autoscale import Autoscaler
from paddle_tpu_torch.serving.fleet import (ReplicaClient, ReplicaDraining,
                                            Router)

from torch_fleet_harness import (VOCAB, engines_on_the_cpu, lm_pair,
                                 save_artifacts)


@pytest.fixture(autouse=True)
def _cpu_engines(monkeypatch):
    engines_on_the_cpu(monkeypatch)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """One tiny LM, saved by the JAX package as TWO artifact versions
    (same weights; version labels are the directory basenames v1/v2),
    and the port's decode model over the same weights."""
    out = save_artifacts(tmp_path_factory.mktemp("elastic"))
    out["lm"] = lm_pair()[1]
    return out


def _requests(rng, n, max_prompt=8, min_new=4, max_new=10):
    reqs = []
    for _ in range(n):
        plen = int(rng.randint(1, max_prompt + 1))
        prompt = [1] + rng.randint(3, VOCAB, plen - 1).tolist()
        reqs.append((prompt, int(rng.randint(min_new, max_new + 1))))
    return reqs


def _kv_pair():
    kvs = KVServer(sweep_interval=0.05).start()
    return kvs, KVClient(kvs.endpoint)


# -- drain protocol units ---------------------------------------------------

def test_lease_mark_keeps_beating_then_revokes():
    """The drain mark re-values a LIVE lease: after ``mark`` the value
    reads ``draining:<ep>``, the heartbeat keeps renewing it well past
    the TTL (unlike an eviction tombstone the holder is still alive),
    and ``revoke`` still frees the slot via CAD on the marked value."""
    kvs, kv = _kv_pair()
    try:
        slot, lease = membership.register_endpoint(
            kv, "replica", 2, "h:1", ttl=0.3)
        marked = membership.DRAINING_PREFIX + "h:1"
        assert lease.mark(marked) is True
        assert lease.value == marked
        assert live_endpoints(kv, "replica") == {slot: marked}
        time.sleep(1.0)                   # > 3x TTL
        assert not lease.lost
        assert live_endpoints(kv, "replica") == {slot: marked}
        lease.revoke()
        assert live_endpoints(kv, "replica") == {}
        # a revoked lease's slot is gone: a late mark cannot re-create
        # it (CAS against the old value has nothing to hit)
        assert lease.mark("late-mark") is False
        assert live_endpoints(kv, "replica") == {}
    finally:
        kv.shutdown_server()
        kv.close()


def test_replica_drain_asymmetry(arts):
    """Satellite 5: a draining replica NACKs new SUBM with the typed
    DRNG reply while duplicate-SUBM dedup, POLL delivery, CANC ack and
    STAT keep serving — and its lease stays registered under the drain
    mark so the router keeps polling for the in-flight results."""
    kvs, kv = _kv_pair()
    cell, cli = None, None
    try:
        cell = fleet.Replica(kv, arts["lm"], desired=1, slots=2,
                             prefill_chunk=4, ttl=0.4, version="v1")
        cli = ReplicaClient(cell.endpoint, timeout=2.0)
        cli.submit("r1", [1, 5], 4)
        cell.drain()
        vals = list(live_endpoints(kv, fleet.REPLICA_ROLE).values())
        assert fleet.DRAINING_PREFIX + cell.endpoint in vals
        with pytest.raises(ReplicaDraining):
            cli.submit("r2", [1, 6], 4)
        cli.submit("r1", [1, 5], 4)       # duplicate of admitted id: OK
        st = cli.stat()
        assert st["draining"] is True and st["version"] == "v1"
        done, deadline = [], time.time() + 30
        while time.time() < deadline and not done:
            done = cli.poll(wait=0.2)
        assert done and done[0]["id"] == "r1" and done[0]["tokens"]
        cli.cancel("r1")
        # delivered AND acked -> the journal empties: the CANC-safe
        # retire condition the autoscaler's drain loop waits for
        deadline = time.time() + 5
        while time.time() < deadline and cell.server._jobs:
            time.sleep(0.02)
        assert not cell.server._jobs
        assert not cell.lease.lost        # still beating, post-drain
    finally:
        if cli is not None:
            cli.close()
        if cell is not None:
            cell.shutdown()
        kv.shutdown_server()
        kv.close()


def test_router_redispatches_on_drng(arts):
    """The router side of satellite 5: admissions closed on one
    replica WITHOUT a registry mark — the router learns only from the
    typed DRNG NACK, re-queues without burning the attempt budget, and
    completes everything on the survivor."""
    kvs, kv = _kv_pair()
    cells, router = [], None
    try:
        cells = [fleet.Replica(kv, arts["lm"], desired=2, slots=2,
                               prefill_chunk=4, ttl=0.4)
                 for _ in range(2)]
        lo = min(cells, key=lambda c: c.slot)
        lo.server.drain()                 # server-side only: no mark
        router = Router(kvs.endpoint, window=3, max_queue=32,
                        stall_timeout=2.0, refresh_interval=0.05,
                        client_timeout=1.0, name="drng")
        router.wait_for_replicas(2, timeout=10)
        # first dispatch tie-breaks to the LOWEST slot = the draining
        # one, so at least one DRNG NACK is deterministic
        hs = [router.submit([1, 4 + i], 4) for i in range(4)]
        outs = [h.result(timeout=60) for h in hs]
        assert len(outs) == 4 and all(t for t, _ in outs)
        assert router.stats["drain_nacks"] >= 1
        assert router.stats["failed"] == 0
        assert lo.slot in router.draining()
    finally:
        if router is not None:
            router.close()
        for c in cells:
            c.shutdown()
        kv.shutdown_server()
        kv.close()


# -- scale-hint plumbing ----------------------------------------------------

def test_scale_hook_moves_desired():
    """Tentpole wiring: ``Signals.evaluate()`` calls the installed
    scale hook with its hint; the controller clamps to bounds,
    respects the cooldown, and refuses to move during a roll."""
    kvs, kv = _kv_pair()
    auto = None
    try:
        # not .start()ed: no replica ever spawns — the hint plumbing
        # is pure controller state
        auto = Autoscaler(kvs.endpoint, "unused", desired=2,
                          min_replicas=1, max_replicas=3,
                          cooldown=0.0, register=False)
        sig = msignals.Signals()
        auto.attach(sig)
        assert sig.scale_hook == auto.offer_hint
        sig.evaluate(now=time.time())     # hold hint: desired unmoved
        assert auto.last_hint is not None
        assert auto.last_hint[0] == "hold" and auto.desired == 2

        assert auto.offer_hint(("up", 1, "queue pressure")) is True
        assert auto.desired == 3
        assert auto.offer_hint(("up", 2, "more")) is False  # at max
        assert auto.desired == 3
        assert auto.offer_hint(("down", 1, "idle")) is True
        assert auto.desired == 2
        assert auto.last_scale["reason"] == "idle"
        # cooldown: a fresh controller-side gate, not hint spam
        auto._cooldown = 60.0
        assert auto.offer_hint(("down", 1, "idle")) is False
        assert auto.desired == 2
        auto._cooldown = 0.0
        # a roll in progress holds elasticity
        auto.roll("unused2", version="v2")
        assert auto.offer_hint(("up", 1, "pressure")) is False
        assert auto.desired == 2
        with pytest.raises(RuntimeError, match="in progress"):
            auto.roll("unused3")
    finally:
        if auto is not None:
            auto.close()
        kv.shutdown_server()
        kv.close()


def test_autoscale_in_analysis_import_check():
    """The port's autoscaler imports neither jax nor paddle_tpu."""
    from torch_fleet_harness import assert_isolated
    assert_isolated("paddle_tpu_torch.serving.autoscale")


# -- roll abort -------------------------------------------------------------

def test_roll_abort_halts_roll_not_fleet(arts, tmp_path):
    """A v2 that cannot boot, then a v2 that boots but never passes
    the health gate: both abort the ROLL; the surviving v1 fleet keeps
    serving and the controller returns to steady."""
    kvs, kv = _kv_pair()
    auto = None
    try:
        auto = Autoscaler(kvs.endpoint, arts["v1"], desired=1,
                          min_replicas=1, max_replicas=3, slots=2,
                          ttl=0.4, interval=0.05, cooldown=0.0,
                          health_timeout=0.8, register=False,
                          prefill_chunk=4).start()
        auto.wait_steady(timeout=30)

        auto.roll(str(tmp_path / "nope"), version="broken")
        last = auto.wait_roll(timeout=30)
        assert last["aborted"] is True and "boot" in last["reason"]

        auto._healthy = lambda cell, version: False
        auto.roll(arts["v2"])
        last = auto.wait_roll(timeout=30)
        assert last["aborted"] is True and "health" in last["reason"]
        del auto._healthy

        st = auto.wait_steady(timeout=30)
        assert st["live"] == 1 and st["version"] == "v1"
        assert st["version_mix"].get("v1") == 1
        assert not st["version_mix"].get("v2")
        assert auto.aborted_rolls == 2 and auto.rolls == 0
        # the surviving fleet still serves
        cell = auto._active[0]
        cli = ReplicaClient(cell.endpoint, timeout=2.0)
        try:
            cli.submit("alive", [1, 7], 4)
            done, deadline = [], time.time() + 30
            while time.time() < deadline and not done:
                done = cli.poll(wait=0.2)
            assert done and done[0]["tokens"]
            cli.cancel("alive")
        finally:
            cli.close()
    finally:
        if auto is not None:
            auto.close()
        kv.shutdown_server()
        kv.close()


# -- the chaos gate ---------------------------------------------------------

ELASTIC_SPEC = {
    "rpc": {"drop": 0.03, "duplicate": 0.03, "close_mid_frame": 0.02,
            "delay": 0.05, "delay_s": 0.003, "max": 6},
    "kill": [{"target": "drain", "after": 0},
             {"target": "roll", "after": 0}],
}


def _run_elastic_chaos(arts, reqs, seq, seed, tmp_path, tag):
    """Stand up KV + autoscaler (2 replicas cold-booted from the v1
    artifact) + router, arm the seeded plan, then: traffic while
    scaling 2→4, traffic while scaling 4→2 (first drain KILLED
    mid-drain), traffic while rolling v1→v2 (first roll drain KILLED
    mid-roll). Asserts the  acceptance invariants."""
    kvs, kv = _kv_pair()
    auto, router, plan = None, None, None

    def burst(batch, off):
        return [router.submit(p, m, session="s%d" % ((off + i) % 4))
                for i, (p, m) in enumerate(batch)]

    try:
        auto = Autoscaler(kvs.endpoint, arts["v1"], desired=2,
                          min_replicas=1, max_replicas=5, slots=2,
                          ttl=0.4, interval=0.05, cooldown=0.0,
                          drain_timeout=15.0, health_timeout=15.0,
                          prefill_chunk=4).start()
        auto.wait_steady(timeout=30)
        spec = dict(ELASTIC_SPEC)
        rpc_spec = dict(spec["rpc"])
        # frame faults on the v1 cells' ports (later spawns get fresh
        # ports; the kill targets are port-independent)
        rpc_spec["ports"] = [c.server.port for c in auto.cells]
        spec["rpc"] = rpc_spec
        plan = faults.arm(spec, seed=seed)
        router = Router(kvs.endpoint, window=3, max_queue=64,
                        stall_timeout=1.0, refresh_interval=0.05,
                        client_timeout=0.8, name="auto-" + tag)
        router.wait_for_replicas(2, timeout=15)

        out = []
        # scale UP mid-traffic: 2 -> 4
        hs = burst(reqs[:8], 0)
        assert auto.set_desired(4, reason="pressure",
                                detail="test burst") == 4
        out += [h.result(timeout=120) for h in hs]
        auto.wait_steady(timeout=30)
        assert auto.status()["live"] == 4
        router.wait_for_replicas(4, timeout=15)

        # scale DOWN mid-traffic: 4 -> 2; the armed plan kills the
        # first drained cell the moment its drain begins
        hs = burst(reqs[8:16], 8)
        assert auto.set_desired(2, reason="idle") == 2
        out += [h.result(timeout=120) for h in hs]
        auto.wait_steady(timeout=45)
        assert auto.status()["live"] == 2
        assert ("kill", "drain") in plan.trips, plan.trips

        # rolling weight update v1 -> v2 under live traffic; the plan
        # kills the first rolled-out cell mid-drain
        shed0 = router.stats["shed"]
        hs = burst(reqs[16:], 16)
        auto.roll(arts["v2"])
        last = auto.wait_roll(timeout=90)
        out += [h.result(timeout=120) for h in hs]
        assert last["aborted"] is False, last
        assert last["from"] == "v1" and last["to"] == "v2"
        assert last["shed_during"] == 0
        assert last["convergence_s"] > 0
        assert router.stats["shed"] == shed0
        assert ("kill", "roll") in plan.trips, plan.trips

        # EXACTLY ONCE, TOKEN-IDENTICAL across all three phases
        assert len(out) == len(reqs)
        for i, ((bt, bs), (et, es)) in enumerate(zip(seq, out)):
            assert bt == et, "request %d diverged: %r vs %r" % (i, bt,
                                                                et)
            np.testing.assert_allclose(es, bs, rtol=1e-4, atol=1e-4)
        rst = router.stats
        assert rst["completed"] == rst["requests"] == len(reqs)
        assert rst["failed"] == 0

        # the fleet converged to v2-only, observable everywhere:
        st = auto.wait_steady(timeout=30)
        assert st["live"] == 2 and st["version"] == "v2"
        assert st["version_mix"].get("v2") == 2
        assert not st["version_mix"].get("v1")
        for cell in list(auto._active):   # ...at the wire (STAT)
            cli = ReplicaClient(cell.endpoint, timeout=2.0)
            try:
                assert cli.stat()["version"] == "v2"
            finally:
                cli.close()
        mix = {k[0]: int(v) for k, v in   # ...and in telemetry
               monrt.FLEET_VERSION_REPLICAS.snapshot().items()}
        assert mix.get("v2") == 2 and not mix.get("v1")
        kinds = {k for k, _ in plan.trips}
        assert kinds & {"drop", "duplicate", "close_mid_frame",
                        "delay"}, plan.trips
        return auto
    finally:
        faults.disarm()
        if router is not None:
            router.close()
        if auto is not None:
            auto.close()
        try:
            kv.shutdown_server()
            kv.close()
        except OSError:
            pass


def test_autoscale_chaos_smoke(rng, arts, tmp_path):
    """Tier-1 gate: 2→4→2 elasticity + a v1→v2 roll, kills mid-drain
    AND mid-roll under seeded frame faults — exactly once,
    token-identical, zero shed during the roll, fleet all-v2."""
    reqs = _requests(rng, 24, min_new=4, max_new=10)
    seq = serving.sequential_generate(arts["lm"], reqs)
    mlog = str(tmp_path / "autoscale-mon.jsonl")
    with monitor.session(log_path=mlog):
        _run_elastic_chaos(arts, reqs, seq, seed=1807,
                           tmp_path=tmp_path, tag="smoke")
    # the recorder rows tell the same story, in the shape the SLO's
    # version_convergence_s / roll_shed objectives and the watch
    # dashboard's autoscale line consume
    rows = monitor.read_jsonl(mlog)
    scale = [r for r in rows if r["ev"] == "scale_event"]
    assert {e["direction"] for e in scale} >= {"up", "down"}
    assert all(e["reason"] in ("pressure", "idle", "roll", "manual")
               for e in scale)
    assert any(r["ev"] == "drain" for r in rows)
    rolls = [r for r in rows if r["ev"] == "roll"]
    assert rolls and rolls[-1]["aborted"] is False
    assert rolls[-1]["from_version"] == "v1"
    assert rolls[-1]["to_version"] == "v2"
    assert rolls[-1]["shed_during"] == 0
    assert rolls[-1]["convergence_s"] > 0
    from paddle_tpu_torch import slo
    samples = slo.samples_from_events(rows, compute_goodput=False)
    assert samples["version_convergence_s"]
    assert samples["roll_shed"] == [0.0]
    verdict = slo.evaluate(
        {"objectives": [
            {"metric": "version_convergence_s", "percentile": 1.0,
             "max_seconds": 120.0},
            {"metric": "roll_shed", "max_value": 0}]},
        samples)
    assert verdict["pass"], verdict


@pytest.mark.slow
def test_autoscale_chaos_soak_deterministic_three_runs(rng, arts,
                                                       tmp_path):
    """The acceptance soak: the seeded elastic-chaos scenario passes 3
    consecutive times (fresh fleet each time)."""
    reqs = _requests(rng, 32, min_new=4, max_new=12)
    seq = serving.sequential_generate(arts["lm"], reqs)
    for attempt in range(3):
        _run_elastic_chaos(arts, reqs, seq, seed=9090,
                           tmp_path=tmp_path, tag="soak%d" % attempt)


# -- the port against the JAX package ---------------------------------------

_ROW_TIMES = {"ts", "convergence_s", "pid", "incarnation", "endpoint",
              "detail"}


def _scale_and_roll(pkg, arts, reqs, tmp_path):
    """Scale 1 -> 2 -> 1, then roll v1 -> v2, with an autoscaler of
    package ``pkg`` over the shared artifacts (booted in that package)
    and a router of the same package: (results, roll / scale_event /
    drain rows without times and endpoints)."""
    import importlib
    mon = importlib.import_module(pkg + ".monitor")
    auto_mod = importlib.import_module(pkg + ".serving.autoscale")
    fl = importlib.import_module(pkg + ".serving.fleet")
    memb = importlib.import_module(pkg + ".distributed.membership")
    kvs = memb.KVServer(sweep_interval=0.05).start()
    kv = memb.KVClient(kvs.endpoint)
    log = str(tmp_path / (pkg + ".jsonl"))
    auto = router = None
    try:
        with mon.session(log_path=log):
            auto = auto_mod.Autoscaler(
                kvs.endpoint, arts["v1"], desired=1, min_replicas=1,
                max_replicas=3, slots=2, ttl=0.4, interval=0.05,
                cooldown=0.0, register=False, prefill_chunk=4).start()
            auto.wait_steady(timeout=30)
            router = fl.Router(kvs.endpoint, window=3,
                               refresh_interval=0.05, name="r")
            router.wait_for_replicas(1, timeout=20)
            out = router.generate_many([p for p, _ in reqs[:6]],
                                       [m for _, m in reqs[:6]],
                                       timeout=120)
            auto.set_desired(2, "manual")
            auto.wait_steady(timeout=30)
            auto.set_desired(1, "manual")
            auto.wait_steady(timeout=30)
            auto.roll(arts["v2"])
            last = auto.wait_roll(timeout=60)
            assert last["aborted"] is False, last
            out += router.generate_many([p for p, _ in reqs[6:]],
                                        [m for _, m in reqs[6:]],
                                        timeout=120)
    finally:
        if router is not None:
            router.close()
        if auto is not None:
            auto.close()
        kv.shutdown_server()
        kv.close()
    rows = [{k: v for k, v in r.items() if k not in _ROW_TIMES}
            for r in mon.read_jsonl(log)
            if r["ev"] in ("roll", "scale_event", "drain")]
    return out, rows


def test_scale_and_roll_rows_equal_the_jax_package(arts, tmp_path):
    """The same scale 1 -> 2 -> 1 and roll v1 -> v2 through each
    package's autoscaler: token-identical results (the port's cells
    boot the JAX package's artifacts) and the same roll, scale_event
    and drain rows, apart from times and endpoints."""
    from torch_fleet_harness import assert_same_tokens, requests
    reqs = requests(np.random.RandomState(9), 10)
    want = _scale_and_roll("paddle_tpu", arts, reqs, tmp_path)
    got = _scale_and_roll("paddle_tpu_torch", arts, reqs, tmp_path)
    assert_same_tokens(want[0], got[0])
    assert got[1] == want[1]
    assert any(r["ev"] == "roll" for r in got[1]), got[1]
