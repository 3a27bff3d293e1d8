"""paddle_tpu_torch.serving.sparse: the port's twin of
tests/test_sparse_serving.py, and the scoring engine held against the
JAX package's (within 1e-5, the same dense weights and shards). The
scoring dispatches run on the CPU (``place=CPUPlace()``); the JAX
file's check of the autoparallel placement hook is left out with the
transform tier (ROADMAP.md queue 1 item 11).

Tiers:

  * Hot-ID cache UNIT contracts, clock-injected (no sleeps): LRU
    capacity eviction, bounded-staleness re-fetch, version-bump
    staling, incarnation-change invalidation.
  * SparseClient against LIVE row shards: deduplicated batched PRFT,
    hit/miss/stale counters, version observation, measured miss cost
    feeding the autoparallel placement hook.
  * ScoringEngine: bitwise equality with a direct Executor run of the
    same program over the same rows; the serving_step/serving_request
    telemetry rows + the watch dashboard's sparse cache line.
  * THE ACCEPTANCE GATE: routed DeepFM scoring through KV registry +
    Router + scoring Replica is BITWISE-identical to the direct
    engine at a pinned cache version; the chaos smoke kills a pserver
    mid-serve WITH online updates landing (recover from checkpoint,
    resolver follows, incarnation bump invalidates the cache, no
    stale-forever rows) and every request completes exactly once with
    measured staleness under the SLO ``staleness_s`` bound. A 3x
    deterministic soak runs behind ``-m slow``.
"""

import json
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import monitor, slo
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.distributed.membership import KVServer, KVClient
from paddle_tpu_torch.distributed import membership as _membership
from paddle_tpu_torch.distributed.rpc import VariableServer
from paddle_tpu_torch.models import deepfm as dfm
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.sparse import (HotIDCache, SparseClient,
                                             ScoringEngine, OnlineTrainer,
                                             measure_staleness)

VOCAB, DIM, F, NSHARD = 64, 4, 3, 2
LR = 0.5


def _make_tables(seed=0):
    rng = np.random.RandomState(seed)
    return {"fm_first_w": rng.rand(VOCAB, 1).astype(np.float32),
            "fm_second_w": rng.rand(VOCAB, DIM).astype(np.float32)}


def _spawn_shard(shard, tables, store_override=None):
    """One live row shard: PRFT serves global ids, the optimize_fn is
    the server-side lazy sparse SGD the online trainer lands on."""
    meta = {t: {"shard": shard, "num_shards": NSHARD, "height": VOCAB}
            for t in tables}

    def opt_fn(store, merged):
        for g, val in merged.items():
            t = g[:-5] if g.endswith("@GRAD") else g
            if t in store and isinstance(val, SelectedRows):
                local = np.asarray(val.rows) // NSHARD
                # the port's SelectedRows come off the wire as CPU
                # tensors over the receive buffer
                store[t][local] -= LR * np.asarray(val.value)

    srv = VariableServer(fan_in=1, sparse_tables=meta,
                         optimize_fn=opt_fn)
    src = store_override if store_override is not None else tables
    for t in tables:
        srv.store[t] = np.asarray(src[t])[shard::NSHARD].copy()
    srv.start()
    return srv, "127.0.0.1:%d" % srv.port


# -- hot-ID cache unit contracts (clock-injected, no sleeps) ----------------

def test_cache_lru_capacity_eviction():
    c = HotIDCache(capacity=3, staleness_s=100.0)
    ver = {"round": 0, "inc": "a"}
    for i in range(5):
        c.insert("t", [i], [np.full(2, i, np.float32)], ver, now=0.0)
    assert len(c) == 3
    assert c.stats["evictions"] == 2
    served, need = c.split("t", [0, 1, 2, 3, 4], 1, now=0.0)
    # the two OLDEST inserts were LRU-evicted
    assert sorted(served) == [2, 3, 4] and sorted(need) == [0, 1]


def test_cache_bounded_staleness_refetches():
    c = HotIDCache(capacity=10, staleness_s=1.0)
    c.insert("t", [7], [np.ones(2, np.float32)],
             {"round": 0, "inc": "a"}, now=0.0)
    served, need = c.split("t", [7], 1, now=0.5)
    assert 7 in served and not need          # within the bound
    served, need = c.split("t", [7], 1, now=1.5)
    assert not served and need == [7]        # past the bound: re-fetch
    assert c.stats["stale"] == 1


def test_cache_version_bump_stales_round_and_inc():
    c = HotIDCache(capacity=10, staleness_s=100.0)
    c.observe_version("t", 0, {"round": 1, "inc": "a"})
    c.insert("t", [4], [np.ones(2, np.float32)],
             {"round": 1, "inc": "a"}, now=0.0)
    served, _ = c.split("t", [4], 1, now=0.0)
    assert 4 in served
    # a fresh fetch elsewhere revealed round 3: the cached round-1 row
    # is stale on next touch, clock notwithstanding
    c.observe_version("t", 0, {"round": 3, "inc": "a"})
    served, need = c.split("t", [4], 1, now=0.0)
    assert not served and need == [4]
    assert c.stats["stale"] == 1
    # incarnation change (respawned server) drops the shard outright
    c.insert("t", [4], [np.ones(2, np.float32)],
             {"round": 3, "inc": "a"}, now=0.0)
    c.observe_version("t", 0, {"round": 0, "inc": "B"})
    assert len(c) == 0
    assert c.stats["invalidations"] == 1


# -- SparseClient against live shards ---------------------------------------

def test_sparse_client_dedup_batched_prefetch_and_hits():
    tables = _make_tables()
    servers, eps = [], []
    for s in range(NSHARD):
        srv, ep = _spawn_shard(s, tables)
        servers.append(srv)
        eps.append(ep)
    try:
        cache = HotIDCache(capacity=100, staleness_s=60.0)
        cli = SparseClient("fm_second_w", eps, cache=cache)
        ids = [3, 8, 3, 8, 11, 3]           # duplicates dedup on wire
        rows = cli.lookup(ids)
        np.testing.assert_array_equal(rows,
                                      tables["fm_second_w"][ids])
        assert cli.stats["wire_rows"] == 3   # unique ids only
        rows2 = cli.lookup(ids)
        np.testing.assert_array_equal(rows2, rows)
        assert cli.stats["wire_rows"] == 3   # all hits, zero wire
        assert cache.stats["hits"] >= 3
        # version coordinates observed per shard
        vers = cli.latest_versions()
        assert set(vers) == {0, 1}
        assert all(v["inc"] for v in vers.values())
        # the measured miss path: a live EWMA after the wire pulls
        per_row = cli.miss_row_seconds()
        assert per_row is not None and per_row > 0
        cli.close()
    finally:
        for srv in servers:
            srv.stop()


def test_incarnation_bump_invalidates_after_respawn(tmp_path):
    """A replacement pserver recovered from checkpoint carries a NEW
    incarnation: one wire fetch against it invalidates the shard's
    cached rows, so a row mutated after recovery is re-served fresh
    even though its cache entry was nowhere near the staleness
    bound."""
    tables = _make_tables()
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    servers, eps, leases = [], [], []
    try:
        for s in range(NSHARD):
            srv, ep = _spawn_shard(s, tables)
            servers.append(srv)
            eps.append(ep)
            _, lease = _membership.register_endpoint(
                kv, "ps", NSHARD, ep, ttl=0.5)
            leases.append(lease)
        cache = HotIDCache(capacity=100, staleness_s=600.0)
        cli = SparseClient("fm_second_w", eps, kv=kv, cache=cache)
        pid = 2                              # shard 0 (2 % 2 == 0)
        row0 = cli.lookup([pid])[0].copy()
        np.testing.assert_array_equal(row0, tables["fm_second_w"][pid])

        ckpt = str(tmp_path / "shard0.ckpt")
        servers[0].checkpoint(ckpt)
        leases[0].revoke()                   # the old cell dies
        servers[0].stop()
        repl, new_ep = _spawn_shard(0, tables,
                                    store_override=tables)
        assert repl.recover(ckpt) is not None
        # the recovered store then diverges (post-respawn update the
        # cache must not hide forever)
        repl.store["fm_second_w"][pid // NSHARD] = 9.25
        servers[0] = repl
        _membership.register_endpoint(kv, "ps", NSHARD, new_ep,
                                      ttl=0.5)
        # a MISS on the respawned shard (new id) reveals the new
        # incarnation -> the shard's cached rows invalidate
        cli.lookup([4])                      # shard 0, cold id
        fresh = cli.lookup([pid])[0]
        assert fresh[0] == pytest.approx(9.25), \
            "cached pre-respawn row served after incarnation bump"
        assert cache.stats["invalidations"] >= 1
        cli.close()
    finally:
        for srv in servers:
            srv.stop()
        kv.shutdown_server()
        kv.close()


# -- scoring engine ---------------------------------------------------------

@pytest.fixture()
def scoring_setup():
    tables = _make_tables(seed=3)
    servers, eps = [], []
    for s in range(NSHARD):
        srv, ep = _spawn_shard(s, tables)
        servers.append(srv)
        eps.append(ep)
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.scope_guard(scope):
        prob, _ = dfm.build_scoring_net(F, DIM, dnn_dims=(8,))
        fluid.Executor(fluid.CPUPlace()).run(startup)

    def make_engine(name="scoring", staleness_s=60.0, batch=4):
        cache = HotIDCache(capacity=1000, staleness_s=staleness_s)
        c1 = SparseClient("fm_first_w", eps, cache=cache)
        c2 = SparseClient("fm_second_w", eps, cache=cache)
        feat = dfm.make_featurizer(c1, c2, F, DIM)
        return ScoringEngine(main, scope, prob.name, feat,
                             clients=[c1, c2], batch=batch, name=name,
                             place=fluid.CPUPlace())

    yield {"tables": tables, "servers": servers, "eps": eps,
           "main": main, "scope": scope, "prob": prob,
           "make_engine": make_engine}
    for srv in servers:
        srv.stop()


def _feats(rng, n):
    return [{"f%d" % f: [int(rng.randint(0, VOCAB))]
             for f in range(F)} for _ in range(n)]


def test_scoring_engine_bitwise_matches_direct_executor(scoring_setup):
    s = scoring_setup
    rng = np.random.RandomState(1)
    feats = _feats(rng, 6)
    # ragged multi-hot: one request's field carries 3 ids (sum-pooled),
    # another drops a field entirely (pools to zero)
    feats[1]["f0"] = [2, 5, 9]
    del feats[2]["f1"]
    eng = s["make_engine"]()
    try:
        got = eng.score_many(feats)
        # reference: hand-gather the SAME rows, one direct run per
        # example padded into the engine's batch shape
        exe = fluid.Executor(fluid.CPUPlace())
        for i, feats_i in enumerate(feats):
            first = np.zeros((4, F), np.float32)
            second = np.zeros((4, F, DIM), np.float32)
            for f in range(F):
                for tid in feats_i.get("f%d" % f, ()):
                    first[0, f] += s["tables"]["fm_first_w"][tid, 0]
                    second[0, f] += s["tables"]["fm_second_w"][tid]
            out, = exe.run(s["main"],
                           feed={"fm_first_rows": first,
                                 "fm_second_rows": second},
                           fetch_list=[s["prob"].name],
                           scope=s["scope"])
            want = float(np.asarray(out).reshape(-1)[0])
            assert got[i] == want, (i, got[i], want)
    finally:
        eng.close()
        for c in eng._clients:
            c.close()


def test_scoring_telemetry_rows_and_watch_line(scoring_setup,
                                               tmp_path):
    from paddle_tpu_torch.monitor.watch import watch
    s = scoring_setup
    rng = np.random.RandomState(2)
    log = str(tmp_path / "scoring.jsonl")
    with monitor.session(log_path=log):
        eng = s["make_engine"](name="recsys")
        try:
            eng.score_many(_feats(rng, 8))
            eng.score_many(_feats(rng, 8))   # warm window: cache hits
        finally:
            eng.close()
            for c in eng._clients:
                c.close()
    rows = [json.loads(ln) for ln in open(log) if ln.strip()]
    steps = [r for r in rows if r.get("ev") == "serving_step"]
    reqs = [r for r in rows if r.get("ev") == "serving_request"]
    assert steps and reqs
    assert steps[-1]["engine"] == "recsys"
    # cumulative cache counters ride the rows (last-row arithmetic)
    assert steps[-1]["cache_hits"] > 0
    assert steps[-1]["cache_misses"] > 0
    # the TTFT-analogue lands per request
    assert all(r["ttft"] is not None for r in reqs)
    assert all(r["queue_wait"] is not None for r in reqs)
    frame = watch(log, once=True)
    sp = [ln for ln in frame.split("\n") if ln.startswith("sparse")]
    assert sp, "watch frame misses the sparse cache line:\n%s" % frame
    assert "hit rate" in sp[0] and "stale" in sp[0]


def test_fleet_lines_render_sparse_counters():
    from paddle_tpu_torch.monitor.watch import fleet_lines
    snap = {
        "__meta__": {"processes": 1, "scrapes": 1, "endpoints": []},
        "ptpu_sparse_cache_hits_total": {
            "kind": "counter", "series": {"": 40}},
        "ptpu_sparse_cache_misses_total": {
            "kind": "counter", "series": {"": 10}},
        "ptpu_sparse_cache_stale_total": {
            "kind": "counter", "series": {"": 3}},
        "ptpu_sparse_prefetch_rows_total": {
            "kind": "counter", "series": {"": 13}},
    }
    lines = fleet_lines(snap)
    sp = [ln for ln in lines if "sparse" in ln]
    assert sp and "hit rate 80%" in sp[0] and "prefetch rows 13" in sp[0]


# -- SLO staleness_s objective ----------------------------------------------

def test_slo_staleness_objective_exit_codes(tmp_path):
    log = tmp_path / "staleness.jsonl"
    t = time.time()
    rows = [{"ts": t + i, "ev": "sparse_staleness",
             "value": v, "table": "emb"}
            for i, v in enumerate([0.05, 0.12, 0.31])]
    log.write_text("".join(json.dumps(r) + "\n" for r in rows))
    passing = tmp_path / "pass.json"
    passing.write_text(json.dumps({"objectives": [
        {"metric": "staleness_s", "percentile": 1.0,
         "max_seconds": 0.5}]}))
    failing = tmp_path / "fail.json"
    failing.write_text(json.dumps({"objectives": [
        {"metric": "staleness_s", "percentile": 1.0,
         "max_seconds": 0.1}]}))
    assert slo.main([str(passing), "--log", str(log)]) == 0
    assert slo.main([str(failing), "--log", str(log)]) == 1
    # spec schema: staleness_s needs max_seconds, like every latency
    with pytest.raises(ValueError):
        slo.load_spec({"objectives": [{"metric": "staleness_s"}]})
    # measured-value check: p100 over the exact samples
    samples = slo.samples_from_monitor_log(str(log))
    assert samples["staleness_s"] == [0.05, 0.12, 0.31]
    v = slo.evaluate({"objectives": [
        {"metric": "staleness_s", "max_seconds": 0.5}]}, samples)
    assert v["objectives"][0]["measured"] == pytest.approx(0.31)


# -- device loader satellite ------------------------------------------------

def test_device_loader_mixed_lod_dense_rides_plan_cache():
    """A batch mixing ragged (LoD) and dense feeds — the scoring
    pipeline shape — keeps its DENSE subset on the worker-thread plan
    cache; the LoD value passes through host-side intact."""
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.reader.device_loader import DeviceLoader
    import torch

    lod = LoDTensor(np.arange(6, dtype=np.int64).reshape(6, 1),
                    [[0, 2, 6]])
    dense = np.ones((4, 3), np.float32)
    feeds = [{"ids": lod, "x": dense} for _ in range(3)]
    loader = DeviceLoader(iter(feeds), device="cpu")
    out = list(loader)
    assert len(out) == 3
    for batch in out:
        assert isinstance(batch["ids"], LoDTensor)   # LoD intact
        assert isinstance(batch["x"], torch.Tensor)  # staged dense
    # the dense subset derived ONE plan and hit it afterwards
    plans = loader._plans
    assert plans is not None and len(plans._plans) == 1
    assert plans.hits == 2 and plans.misses == 1


# -- acceptance: routed bitwise identity + chaos ----------------------------

def _routed_vs_direct(s, rng, kvs, kv, n=8):
    feats = _feats(rng, n)
    direct = s["make_engine"](name="direct")
    cell = fleet.Replica(kv, None, desired=1, ttl=0.5,
                         engine_factory=lambda name:
                         s["make_engine"](name="replica"))
    router = fleet.Router(kvs.endpoint, refresh_interval=0.05)
    try:
        router.wait_for_replicas(1)
        want = direct.score_many(feats)
        handles = [router.submit(features=f) for f in feats]
        got = [h.result(timeout=60) for h in handles]
        assert all(toks == [] for toks, _ in got)
        assert [sc for _, sc in got] == want      # BITWISE
        # pinned cache version: both engines served the same shard
        # coordinates, comparable without key juggling (versions()
        # stringifies shard keys — the wire shape)
        assert handles[0].versions == direct.versions()
        assert router.stats["completed"] == n
        assert router.stats["failed"] == 0
        # malformed scoring payload -> BADR typed reject: THIS request
        # fails terminally, the replica stays in dispatch
        bad = router.submit(features="not-a-dict")
        with pytest.raises(RuntimeError, match="failed"):
            bad.result(timeout=30)
        # schema errors reject at SUBMIT (BADR surface), terminally —
        # an unknown field can never fail a co-admitted batch
        bad2 = router.submit(features={"f99": [1]})
        with pytest.raises(RuntimeError, match="failed"):
            bad2.result(timeout=30)
        with pytest.raises(ValueError, match="unknown feature"):
            direct.submit({"f99": [1]})
        # numpy ids normalize at the front door (wire-safe journal)
        ok = router.submit(features={
            k: [np.int64(v[0])] for k, v in feats[0].items()})
        assert ok.result(timeout=30)[1] == want[0]
        assert router.stats["failed"] == 2
    finally:
        router.close()
        cell.shutdown()
        for eng in (direct, cell.engine):
            for c in eng._clients:
                c.close()
        direct.close()


def test_routed_scoring_bitwise_identical(scoring_setup):
    """Acceptance: routed DeepFM scoring == direct single-process
    executor scoring, bitwise, at a pinned cache version (the LM
    token-identity contract, ported)."""
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    try:
        _routed_vs_direct(scoring_setup, np.random.RandomState(5),
                          kvs, kv)
    finally:
        kv.shutdown_server()
        kv.close()


def _chaos_round(tmp_path, seed):
    """One chaos pass: routed scoring under online updates, pserver 0
    killed mid-serve, recovered from checkpoint on a new port, the
    resolver follows, the cache invalidates on the incarnation bump —
    every request exactly once, staleness measured and SLO-gated."""
    from paddle_tpu_torch.resilience import faults

    tables = _make_tables(seed=seed)
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    servers, eps, leases = [], [], []
    rng = np.random.RandomState(seed)
    log = str(tmp_path / ("chaos_%d.jsonl" % seed))
    try:
        for sh in range(NSHARD):
            srv, ep = _spawn_shard(sh, tables)
            servers.append(srv)
            eps.append(ep)
            _, lease = _membership.register_endpoint(
                kv, "ps", NSHARD, ep, ttl=0.5)
            leases.append(lease)

        main, startup = fluid.Program(), fluid.Program()
        scope = fluid.Scope()
        with fluid.program_guard(main, startup), \
                fluid.scope_guard(scope):
            prob, _ = dfm.build_scoring_net(F, DIM, dnn_dims=(8,))
            fluid.Executor(fluid.CPUPlace()).run(startup)

        with monitor.session(log_path=log):
            cache = HotIDCache(capacity=1000, staleness_s=0.2)
            c1 = SparseClient("fm_first_w", eps, kv=kv, cache=cache)
            c2 = SparseClient("fm_second_w", eps, kv=kv, cache=cache)
            feat = dfm.make_featurizer(c1, c2, F, DIM)
            eng = ScoringEngine(main, scope, prob.name, feat,
                                clients=[c1, c2], batch=4,
                                name="chaos-scoring",
                                place=fluid.CPUPlace())
            cell = fleet.Replica(
                kv, None, desired=1, ttl=0.5, role="scoring",
                engine_factory=lambda name: eng)
            router = fleet.Router(kvs.endpoint, role="scoring",
                                  refresh_interval=0.05,
                                  stall_timeout=8.0)
            router.wait_for_replicas(1)

            # online updates land while serving reads
            hot = rng.randint(0, VOCAB, 6)
            trainer = OnlineTrainer(
                "fm_second_w", eps, height=VOCAB, interval=0.03,
                kv=kv,
                update_fn=lambda: (hot, rng.rand(len(hot), DIM)
                                   .astype(np.float32) * 0.01))
            trainer.start()

            # seeded frame faults on the pserver wire (PRFT reads +
            # tagged SEND/BARR updates): drops/dups the retry policy
            # must ride out without double-applying
            faults.arm({"rpc": {"drop": 0.03, "duplicate": 0.03,
                                "ops": ["PRFT", "SEND", "BARR"],
                                "max": 12}}, seed=seed)

            handles = []
            n_reqs = 24
            for i in range(n_reqs):
                handles.append(
                    router.submit(features=_feats(rng, 1)[0]))
                if i == 9:
                    # kill shard 0 mid-serve: checkpoint first (the
                    # durable state a real pserver already has), then
                    # the process dies
                    ckpt = str(tmp_path / ("sh0_%d.ckpt" % seed))
                    servers[0].checkpoint(ckpt)
                    leases[0].revoke()
                    servers[0].stop()
                if i == 11:
                    # supervisor respawns: recover + re-register at a
                    # NEW port; the client resolver follows
                    repl, new_ep = _spawn_shard(0, tables)
                    assert repl.recover(ckpt) is not None
                    servers[0] = repl
                    _, leases[0] = _membership.register_endpoint(
                        kv, "ps", NSHARD, new_ep, ttl=0.5)
                time.sleep(0.02)
            results = [h.result(timeout=120) for h in handles]
            faults.disarm()
            assert len(results) == n_reqs
            assert router.stats["completed"] == n_reqs
            assert router.stats["failed"] == 0
            assert router.stats["requests"] == n_reqs
            # no stale-forever rows: an update landed AFTER the
            # respawn becomes serve-visible, measured end-to-end
            trainer.stop()
            st = measure_staleness(trainer, c2,
                                   probe_id=int(hot[0]),
                                   timeout=30.0)
            assert st < 5.0, "staleness %.3fs past the bound" % st
            # the incarnation bump actually invalidated shard 0
            assert cache.stats["invalidations"] >= 1

            trainer.close()
            router.close()
            cell.shutdown()
            for c in (c1, c2):
                c.close()
        # SLO gate over the recorded rows: the measured staleness
        # sample must pass the staleness_s objective
        spec = tmp_path / ("slo_%d.json" % seed)
        spec.write_text(json.dumps({"objectives": [
            {"metric": "staleness_s", "percentile": 1.0,
             "max_seconds": 5.0},
            {"metric": "error_rate", "max_ratio": 0.0}]}))
        assert slo.main([str(spec), "--log", log]) == 0
    finally:
        from paddle_tpu_torch.resilience import faults
        faults.disarm()
        for srv in servers:
            try:
                srv.stop()
            except Exception:
                pass
        kv.shutdown_server()
        kv.close()


@pytest.mark.slow
def test_chaos_pserver_kill_mid_serve_smoke(tmp_path):
    _chaos_round(tmp_path, seed=4242)


@pytest.mark.slow
def test_chaos_pserver_kill_soak(tmp_path):
    for seed in (4242, 1301, 7):
        _chaos_round(tmp_path, seed=seed)


# -- the port against the JAX package ---------------------------------------

def test_scores_within_1e5_of_the_jax_scoring_engine(scoring_setup):
    """The same scoring net (built by each package, the port's weights
    copied from the JAX startup), each package's ScoringEngine with its
    own hot-ID cache over the same two row shards: scores within 1e-5
    (the two dense forwards sum in different orders)."""
    import paddle_tpu as jfluid
    from paddle_tpu.models import deepfm as jdfm
    from paddle_tpu.serving import sparse as jsparse
    from paddle_tpu_torch.core.scope import load_numpy_state
    s = scoring_setup
    jmain, jstartup = jfluid.Program(), jfluid.Program()
    jscope = jfluid.Scope()
    with jfluid.program_guard(jmain, jstartup), \
            jfluid.scope_guard(jscope), jfluid.unique_name.guard():
        jprob, _ = jdfm.build_scoring_net(F, DIM, dnn_dims=(8,))
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        prob, _ = dfm.build_scoring_net(F, DIM, dnn_dims=(8,))
    names = [v.name for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None]
    assert names
    load_numpy_state(scope, {n: np.asarray(jscope.find_var(n))
                             for n in names}, "cpu")
    feats = _feats(np.random.RandomState(4), 10)
    feats[3]["f0"] = [1, 7, 9]
    del feats[5]["f2"]
    engines = []
    try:
        jc1 = jsparse.SparseClient("fm_first_w", s["eps"],
                                   cache=jsparse.HotIDCache(1000, 60.0))
        jc2 = jsparse.SparseClient("fm_second_w", s["eps"],
                                   cache=jc1.cache)
        engines.append(jsparse.ScoringEngine(
            jmain, jscope, jprob.name,
            jdfm.make_featurizer(jc1, jc2, F, DIM), clients=[jc1, jc2],
            batch=4, name="jax"))
        c1 = SparseClient("fm_first_w", s["eps"],
                          cache=HotIDCache(1000, 60.0))
        c2 = SparseClient("fm_second_w", s["eps"], cache=c1.cache)
        engines.append(ScoringEngine(
            main, scope, prob.name, dfm.make_featurizer(c1, c2, F, DIM),
            clients=[c1, c2], batch=4, name="port",
            place=fluid.CPUPlace()))
        want = engines[0].score_many(feats)
        got = engines[1].score_many(feats)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    finally:
        for eng in engines:
            eng.close()
            for c in eng._clients:
                c.close()
