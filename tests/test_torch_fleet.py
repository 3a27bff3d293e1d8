"""paddle_tpu_torch.serving.fleet: the port's twin of tests/test_fleet.py,
and the fleet held against the JAX package's.

The LM is initialized by the JAX package and carried into the port
(tests/torch_fleet_harness.py); port replicas serve on the CPU. Beside
the JAX file's tiers (decision table, shed and dedup, the chaos gate),
the port's fleet must give the JAX fleet's token streams, fault-free
and under the chaos plan, and the wire must work across packages: a
JAX ``Router`` drives port replicas and a JAX ``Collector`` scrapes
them.
"""

import numpy as np
import pytest

from paddle_tpu_torch import monitor, serving
from paddle_tpu_torch.distributed.membership import (KVServer, KVClient,
                                                     live_endpoints)
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.fleet import (Overloaded, Router,
                                            choose_replica)
from torch_fleet_harness import (assert_same_tokens, close_kv, kv_pair,
                                 lm_pair)
from torch_fleet_harness import requests as _requests


@pytest.fixture(scope="module")
def lms():
    """(JAX decode model, port decode model) over the same weights."""
    return lm_pair()


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


# -- pure decision logic (table-driven; no sockets) -------------------------

def test_choose_replica_table():
    cases = [
        # (loads, window, session, affinity) -> expected
        # least-loaded wins
        (({0: 3, 1: 1, 2: 2}, 4, None, None), 1),
        # tie on load -> LOWEST slot id (deterministic)
        (({2: 1, 0: 1, 1: 1}, 4, None, None), 0),
        (({5: 0, 3: 0}, 4, None, None), 3),
        # replicas at the window are not candidates
        (({0: 4, 1: 2}, 4, None, None), 1),
        # every replica at the window -> None (stays queued)
        (({0: 4, 1: 4}, 4, None, None), None),
        (({}, 4, None, None), None),    # no live replicas
        # session affinity wins over least-loaded while under window
        (({0: 3, 1: 0}, 4, "s", {"s": 0}), 0),
        # affinity replica AT the window -> spill to least-loaded
        (({0: 4, 1: 2}, 4, "s", {"s": 0}), 1),
        # affinity to a DEAD replica (not in loads) -> least-loaded
        (({1: 2, 2: 1}, 4, "s", {"s": 0}), 2),
        # session without a mapping yet -> least-loaded
        (({0: 2, 1: 1}, 4, "s", {}), 1),
    ]
    for (loads, window, sess, aff), want in cases:
        got = choose_replica(loads, window, session=sess, affinity=aff)
        assert got == want, ((loads, window, sess, aff), got, want)


def test_router_shed_and_duplicate_dedup(tmp_path):
    """Router semantics that need no replicas: the typed Overloaded
    shed at the global queue bound (counted against the SLO error
    budget) and the journal's exactly-once completion — a late
    duplicate result for an already-completed id is deduped, never
    delivered twice."""
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    log = str(tmp_path / "router.jsonl")
    try:
        with monitor.session(log_path=log):
            router = Router(kvs.endpoint, max_queue=2, name="shedtest",
                            refresh_interval=0.05)
            try:
                h1 = router.submit([1, 2], 4, session="a")
                h2 = router.submit([1, 3], 4, session="a")
                with pytest.raises(Overloaded) as ei:
                    router.submit([1, 4], 4)
                assert ei.value.queued == 2 and ei.value.bound == 2
                assert router.stats["shed"] == 1
                assert router.stats["requests"] == 2

                # late-duplicate dedup: first result completes the
                # handle; the second (a slow replica's late copy) is
                # counted and DROPPED
                rid = h1.rid
                router._complete(0, {"id": rid, "tokens": [7, 8],
                                     "score": -1.0})
                assert h1.result(timeout=5) == ([7, 8], -1.0)
                router._complete(1, {"id": rid, "tokens": [7, 8],
                                     "score": -1.0})
                assert router.stats["duplicates"] == 1
                assert router.stats["completed"] == 1
                # unknown ids (pruned/foreign) are acked, not crashed
                router._complete(0, {"id": "nope", "tokens": [],
                                     "score": 0.0})
                assert router.stats["completed"] == 1
                # close fails the never-dispatched request loudly
                router.close()
                with pytest.raises(RuntimeError, match="closed"):
                    h2.result(timeout=5)
                with pytest.raises(RuntimeError, match="closed"):
                    router.submit([1], 2)
            finally:
                router.close()
    finally:
        kv.shutdown_server()
        kv.close()
    # the shed request landed in the SLO error budget: a
    # serving_request row with the typed error under the router label
    rows = [r for r in monitor.read_jsonl(log)
            if r["ev"] == "serving_request" and r.get("error")]
    assert any(r["engine"] == "shedtest" and "Overloaded" in r["error"]
               for r in rows)


# -- the chaos gate ---------------------------------------------------------

DESIRED = 3

CHAOS_SPEC = {
    "rpc": {"drop": 0.04, "duplicate": 0.04, "close_mid_frame": 0.02,
            "delay": 0.05, "delay_s": 0.003, "max": 8},
    "kill": [{"target": "replica:0", "after": 3}],
    "stall": [{"target": "replica:1", "after": 2, "seconds": 4.0}],
}


def _run_fleet_chaos(lm, reqs, seq, seed, tmp_path, tag,
                     shed_probe=True):
    """Stand up KV + 3 replicas + supervisor + router, arm the seeded
    plan, drive traffic through the churn, and assert the 
    acceptance invariants. Returns (router stats, plan, supervisor)."""
    from paddle_tpu_torch.trace import runtime as trt

    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    tlog = str(tmp_path / ("spans-%s.jsonl" % tag))

    def spawn():
        return fleet.Replica(kv, lm, desired=DESIRED, slots=2,
                             prefill_chunk=4, ttl=0.4, device="cpu")

    trt.enable(log_path=tlog, sample_rate=1.0, proc="fleet-" + tag)
    cells = []
    sup = None
    router = None
    try:
        cells = [spawn() for _ in range(DESIRED)]
        spec = dict(CHAOS_SPEC)
        rpc_spec = dict(spec["rpc"])
        rpc_spec["ports"] = [c.server.port for c in cells]
        spec["rpc"] = rpc_spec
        plan = faults.arm(spec, seed=seed)
        sup = fleet.Supervisor(kv, spawn, desired=DESIRED,
                               interval=0.1).start()
        router = Router(kvs.endpoint, window=3, max_queue=64,
                        stall_timeout=1.0, refresh_interval=0.05,
                        client_timeout=0.8, name="router-" + tag)
        router.wait_for_replicas(DESIRED, timeout=15)

        handles = [router.submit(p, m, session="s%d" % (i % 4))
                   for i, (p, m) in enumerate(reqs)]
        out = [h.result(timeout=120) for h in handles]

        # EXACTLY ONCE, TOKEN-IDENTICAL: every accepted request
        # completed, and re-execution on a survivor produced the same
        # greedy continuation as the fault-free baseline
        assert len(out) == len(reqs)
        for i, ((st, ss), (et, es)) in enumerate(zip(seq, out)):
            assert st == et, "request %d diverged: %r vs %r" % (i, st,
                                                                et)
            np.testing.assert_allclose(es, ss, rtol=1e-4, atol=1e-4)
        st = router.stats
        assert st["completed"] == st["requests"] == len(reqs)
        assert st["failed"] == 0

        # every planned fault class fired, and churn really happened
        kinds = {k for k, _ in plan.trips}
        assert "kill" in kinds, plan.trips
        assert "stall" in kinds, plan.trips
        assert kinds & {"drop", "duplicate", "close_mid_frame",
                        "delay"}, plan.trips
        assert st["resubmissions"] >= 1, st
        assert sum(st["evictions"].values()) >= 2, st
        # the wedged replica answers no verb for the router's deadline:
        # the poller's long-poll ("stall") or a SUBM's retry deadline
        # ("dispatch") evicts it, whichever reaches it first
        assert set(st["evictions"]) & {"stall", "dispatch"}, st

        # load shedding: a burst past the queue bound fast-fails with
        # the typed error while the fleet is busy healing
        if shed_probe:
            # window=1 x 3 replicas = 3 dispatchable; queue bound 1 —
            # a burst of 12 must hit the bound no matter how fast the
            # dispatch thread drains
            with fleet.Router(kvs.endpoint, window=1, max_queue=1,
                              name="shed-" + tag,
                              refresh_interval=0.05) as tiny:
                tiny.wait_for_replicas(1, timeout=10)
                with pytest.raises(Overloaded):
                    for _ in range(12):
                        tiny.submit([1, 2, 3], 4)

        # the respawned replicas REJOINED the registry and serve
        # traffic: full capacity again, then a fresh round decodes
        # token-identically through the healed fleet
        router.wait_for_replicas(DESIRED, timeout=20)
        assert sup.respawns >= 1
        again = router.generate_many([p for p, _ in reqs[:4]],
                                     [m for _, m in reqs[:4]],
                                     timeout=60)
        for (bt, _), (nt, _) in zip(seq[:4], again):
            assert bt == nt
        live = {v for v in live_endpoints(kv, "replica").values()}
        assert any(c.endpoint in live for c in sup.cells), \
            "no respawned replica is registered"
        return st, plan, sup
    finally:
        faults.disarm()
        if router is not None:
            router.close()
        if sup is not None:
            sup.stop()
        for c in cells + (sup.cells if sup is not None else []):
            try:
                c.shutdown()
            except Exception:
                pass
        trt.disable()
        try:
            kv.shutdown_server()
            kv.close()
        except OSError:
            pass


def test_fleet_chaos_smoke(rng, lm, tmp_path):
    """Tier-1 gate: kill + stall + frame faults mid-traffic; exactly
    once, token-identical, healed, shed typed, hop traced."""
    from paddle_tpu_torch.trace import merge as tmerge
    reqs = _requests(rng, 18, min_new=6, max_new=14)
    seq = serving.sequential_generate(lm, reqs)
    mlog = str(tmp_path / "fleet-mon.jsonl")
    with monitor.session(log_path=mlog):
        st, plan, sup = _run_fleet_chaos(lm, reqs, seq, seed=1301,
                                         tmp_path=tmp_path, tag="smoke")

    # the monitor log tells the same story: request rows from several
    # engine incarnations, fleet counters ticked
    rows = monitor.read_jsonl(mlog)
    engines = {r["engine"] for r in rows
               if r["ev"] == "serving_request" and not r.get("error")}
    assert len(engines) >= 2, engines

    # trace merge shows the RESUBMISSION HOP: one rid dispatched to
    # two different endpoints, and the replica-side server spans
    tlog = str(tmp_path / "spans-smoke.jsonl")
    spans = [r for r in monitor.read_jsonl(tlog) if r["ev"] == "span"]
    disp = {}
    for s in spans:
        if s["name"] == "router.dispatch":
            at = s.get("attrs") or {}
            disp.setdefault(at.get("rid"), set()).add(
                at.get("endpoint"))
    hops = {rid: eps for rid, eps in disp.items() if len(eps) >= 2}
    assert hops, "no resubmission hop visible in the span log"
    assert any(s["name"] == "replica.SUBM" for s in spans)
    # engine-side request spans carry the durable fleet id
    rids = {(s.get("attrs") or {}).get("rid")
            for s in spans if s["name"] == "serving.request"}
    assert set(hops) & rids, "resubmitted rid has no request span"
    merged, info = tmerge.merge_files([tlog])
    names = {e.get("name") for e in merged["traceEvents"]}
    assert {"router.dispatch", "replica.SUBM",
            "serving.request"} <= names


@pytest.mark.slow
def test_fleet_chaos_soak_deterministic_three_runs(rng, lm, tmp_path):
    """The acceptance soak: the seeded chaos scenario passes 3
    consecutive times (fresh fleet each time) on a longer run."""
    reqs = _requests(rng, 40, min_new=6, max_new=16)
    seq = serving.sequential_generate(lm, reqs)
    for attempt in range(3):
        _run_fleet_chaos(lm, reqs, seq, seed=4242, tmp_path=tmp_path,
                         tag="soak%d" % attempt, shed_probe=False)


# -- satellites -------------------------------------------------------------

def test_register_endpoint_role_parameterized():
    """Satellite: membership registration is role-parameterized; the
    pserver helpers are thin aliases over the same path."""
    from paddle_tpu_torch.distributed import membership as m
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    try:
        i0, l0 = m.register_endpoint(kv, "replica", 2, "h:1", ttl=0.5)
        i1, l1 = m.register_endpoint(kv, "replica", 2, "h:2", ttl=0.5)
        assert {i0, i1} == {0, 1}
        by_slot = {i0: "h:1", i1: "h:2"}
        assert m.wait_for_endpoints(kv, "replica", 2, timeout=5) == \
            [by_slot[0], by_slot[1]]
        assert m.live_endpoints(kv, "replica") == by_slot
        with pytest.raises(TimeoutError):
            m.register_endpoint(kv, "replica", 2, "h:3", ttl=0.5,
                                timeout=0.3)
        # roles are namespaced: the pserver alias sees its own slots
        ip, lp = m.register_pserver(kv, 1, "h:9", ttl=0.5)
        assert ip == 0
        assert m.wait_for_pservers(kv, 1, timeout=5) == ["h:9"]
        assert m.role_prefix("ps") == m.PS_PREFIX
        for lease in (l0, l1, lp):
            lease.revoke()
        assert m.live_endpoints(kv, "replica") == {}
    finally:
        kv.shutdown_server()
        kv.close()


def test_fleet_in_analysis_import_check():
    """The port's fleet tier imports neither jax nor paddle_tpu."""
    from torch_fleet_harness import assert_isolated
    assert_isolated("paddle_tpu_torch.serving.fleet",
                    "paddle_tpu_torch.serving.autoscale",
                    "paddle_tpu_torch.serving.rollout")


def test_fault_plan_stall_and_fleet_verbs():
    """Satellite: the fault plan grew the serving verbs as frame-fault
    sites and a one-shot stall injection."""
    from paddle_tpu_torch.resilience.faults import _DEFAULT_OPS, FaultPlan
    assert {"SUBM", "POLL", "CANC", "STAT"} <= _DEFAULT_OPS
    plan = FaultPlan({"stall": [{"target": "replica:1", "after": 2,
                                 "seconds": 1.5}]}, seed=7)
    assert plan.should_stall("replica:1", 1) == 0.0
    assert plan.should_stall("replica:0", 5) == 0.0   # other target
    assert plan.should_stall("replica:1", 2) == 1.5
    assert plan.should_stall("replica:1", 9) == 0.0   # one-shot
    assert ("stall", "replica:1") in plan.trips


# -- the port against the JAX package ---------------------------------------

def _serve_fleet(pkg, model, reqs, n=3, **replica_kw):
    """``reqs`` through a Router over ``n`` replicas of package ``pkg``
    (KV, replicas and router all of it); returns the results."""
    import importlib
    fl = importlib.import_module(pkg + ".serving.fleet")
    kvs, kv = kv_pair(pkg)
    cells, router = [], None
    try:
        cells = [fl.Replica(kv, model, desired=n, slots=2, prefill_chunk=4,
                            ttl=0.5, **replica_kw) for _ in range(n)]
        router = fl.Router(kvs.endpoint, window=3, refresh_interval=0.05,
                           name="parity-" + pkg)
        router.wait_for_replicas(n, timeout=20)
        return router.generate_many([p for p, _ in reqs],
                                    [m for _, m in reqs], timeout=120)
    finally:
        if router is not None:
            router.close()
        for c in cells:
            c.shutdown()
        close_kv(kv)


def test_fleet_tokens_equal_the_jax_fleet(lms):
    """Fault-free, the port's fleet gives the JAX fleet's token streams
    (fp32, the same weights and requests)."""
    jlm, tlm = lms
    reqs = _requests(np.random.RandomState(7), 12, min_new=6, max_new=14)
    want = _serve_fleet("paddle_tpu", jlm, reqs)
    got = _serve_fleet("paddle_tpu_torch", tlm, reqs, device="cpu")
    assert_same_tokens(want, got)


def test_fleet_chaos_tokens_equal_the_jax_fleet(lms, tmp_path):
    """Under the seeded chaos plan (kill, stall, frame faults) the
    port's fleet still gives the JAX fleet's fault-free token streams,
    which its exactly-once contract makes the JAX fleet's under any
    plan."""
    jlm, tlm = lms
    reqs = _requests(np.random.RandomState(11), 14, min_new=6, max_new=14)
    want = _serve_fleet("paddle_tpu", jlm, reqs)
    _run_fleet_chaos(tlm, reqs, want, seed=1301, tmp_path=tmp_path,
                     tag="parity", shed_probe=False)


def test_jax_router_and_collector_drive_port_replicas(lms, tmp_path):
    """The wire across packages: a JAX ``Router`` serves through port
    replicas (SUBM/POLL/STAT frames of the port's ReplicaServer) with
    the JAX package's tokens, and a JAX ``Collector`` scrapes them."""
    from paddle_tpu import serving as jserving
    from paddle_tpu.monitor.collector import Collector as JCollector
    from paddle_tpu.serving import fleet as jfleet
    jlm, tlm = lms
    reqs = _requests(np.random.RandomState(3), 10)
    want = jserving.sequential_generate(jlm, reqs)
    kvs, kv = kv_pair("paddle_tpu_torch")
    cells, router = [], None
    try:
        with monitor.session(log_path=str(tmp_path / "mon.jsonl")):
            tokens = monitor.registry().get("ptpu_serving_tokens_total")
            before = tokens.value()
            cells = [fleet.Replica(kv, tlm, desired=2, slots=2,
                                   prefill_chunk=4, ttl=0.5, device="cpu")
                     for _ in range(2)]
            router = jfleet.Router(kvs.endpoint, window=3,
                                   refresh_interval=0.05,
                                   name="jax-router")
            router.wait_for_replicas(2, timeout=20)
            got = router.generate_many([p for p, _ in reqs],
                                       [m for _, m in reqs], timeout=120)
            assert_same_tokens(want, got)
            assert router.stats["completed"] == len(reqs)
            # discovery through the port's KV registry, METR/HLTH frames
            # from the port's ReplicaServer
            with JCollector(kv_endpoint=kvs.endpoint,
                            roles=("replica",)) as col:
                col.scrape_once()
                snap = col.fleet_snapshot()
            eps = {e["endpoint"]: e for e in snap["__meta__"]["endpoints"]}
            for c in cells:
                assert eps[c.endpoint]["ok"], eps
            # the replicas are this process: the scraped counter is its
            # registry's, grown by the tokens served
            tok = snap["ptpu_serving_tokens_total"]
            assert sum(tok["series"].values()) == tokens.value()
            assert tokens.value() - before == sum(len(t) for t, _ in got)
    finally:
        if router is not None:
            router.close()
        for c in cells:
            c.shutdown()
        close_kv(kv)
