"""The port's counterpart of tests/test_resilience.py: its 26 scenarios run
against paddle_tpu_torch (the CPU asked for explicitly), and the seeded
pieces are held against the JAX package in the same process — the
same FaultPlan decisions, backoff sequences and corrupted bytes for the
same seeds, and ``resilient_loop`` ending with the JAX run's summary and
weights within 2e-4.

paddle_tpu_torch.resilience unit tier: retry policy semantics, seeded
fault-plan determinism, RPC transparent reconnect (incl. the
membership-resolver replacement pickup), side-stream lifecycle on
reconnect, client context managers, the corrupt-checkpoint fallback
paths in BOTH io.load_checkpoint and pserver recover() (truncated blob,
bit-flipped blob, missing meta, meta naming a deleted blob), the shared
incremental-CRC blob writer, and the resilient_loop driver
(NaN rollback-and-skip, auto-resume, rollback THROUGH a corrupt
newest checkpoint). The full composition lives in tests/test_chaos.py.
"""

import functools
import json
import os
import time
import zlib

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.distributed.master import (TaskQueue, MasterServer,
                                                 MasterClient)
from paddle_tpu_torch.distributed.membership import KVServer, KVClient
from paddle_tpu_torch.distributed.rpc import VariableServer, RPCClient
from paddle_tpu_torch.models import harness
from paddle_tpu_torch.resilience import Policy, faults, resilient_loop

# the port's harness runs on the card unless asked: these run on the CPU
_resilient_run = functools.partial(harness.resilient_run,
                                   place=fluid.CPUPlace())


@pytest.fixture(autouse=True)
def _disarm():
    """No fault plan may leak across tests."""
    yield
    faults.disarm()


def _fast_policy(**kw):
    kw.setdefault("max_attempts", 10)
    kw.setdefault("base_delay", 0.01)
    kw.setdefault("deadline", 10.0)
    return Policy(**kw)


# -------------------------------------------------------------------------
# retry.Policy
# -------------------------------------------------------------------------

def test_policy_backoff_deterministic_bounded():
    p = Policy(max_attempts=5, base_delay=0.1, max_delay=0.5,
               multiplier=2.0, jitter=0.25, seed=42)
    d1, d2 = list(p.delays()), list(Policy(
        max_attempts=5, base_delay=0.1, max_delay=0.5, multiplier=2.0,
        jitter=0.25, seed=42).delays())
    assert d1 == d2                       # seeded jitter is reproducible
    assert len(d1) == 4                   # one sleep per RETRY
    assert all(d <= 0.5 * 1.25 for d in d1)       # max_delay * jitter cap
    base = [0.1, 0.2, 0.4, 0.5]
    for d, b in zip(d1, base):
        assert b <= d <= b * 1.25         # exponential growth, capped


def test_policy_run_retries_then_succeeds_and_exhausts():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient")
        return "ok"

    p = _fast_policy()
    assert p.run(flaky) == "ok"
    assert len(calls) == 3

    def always():
        raise ConnectionError("down")

    with pytest.raises(ConnectionError):
        Policy(max_attempts=3, base_delay=0.001, deadline=5).run(always)

    # non-retryable errors pass straight through
    def poison():
        raise ValueError("not a socket error")

    with pytest.raises(ValueError):
        p.run(poison)


def test_policy_deadline_bounds_total_wait():
    """The deadline, not max_attempts, ends the loop: far fewer than 50
    attempts fit 0.2 s of 0.05 s backoffs (no assertion on the clock:
    a slow host only makes the count smaller)."""
    retries = []
    with pytest.raises(ConnectionError):
        Policy(max_attempts=50, base_delay=0.05, max_delay=0.05,
               jitter=0.0, deadline=0.2).run(
                   lambda: (_ for _ in ()).throw(ConnectionError()),
                   on_retry=lambda a, e: retries.append(a))
    assert len(retries) <= 4


# -------------------------------------------------------------------------
# faults.FaultPlan
# -------------------------------------------------------------------------

def test_fault_plan_seeded_decisions_and_budget():
    spec = {"rpc": {"drop": 0.5, "max": 4}}
    a = faults.FaultPlan(spec, seed=9)
    b = faults.FaultPlan(spec, seed=9)
    da = [a._draw("send:SEND", ("drop",)) for _ in range(50)]
    db = [b._draw("send:SEND", ("drop",)) for _ in range(50)]
    assert da == db                           # per-site stream is seeded
    assert sum(d is not None for d in da) == 4          # budget respected
    c = faults.FaultPlan(spec, seed=10)
    dc = [c._draw("send:SEND", ("drop",)) for _ in range(50)]
    assert dc != da                           # seed actually matters


def test_fault_plan_one_shot_kill_and_nan():
    plan = faults.FaultPlan({"kill": [{"target": "pserver", "after": 3}],
                             "nan": {"step": 2, "name": "x"}})
    assert not plan.should_kill("pserver", 2)
    assert plan.should_kill("pserver", 3)
    assert not plan.should_kill("pserver", 99)          # one-shot
    assert not plan.should_kill("master", 99)           # wrong target

    feeds = {"x": np.ones((4,), np.float32)}
    same = plan.maybe_poison_feeds(1, feeds)
    assert same is feeds
    poisoned = plan.maybe_poison_feeds(2, feeds)
    assert np.isnan(poisoned["x"]).any()
    assert not np.isnan(feeds["x"]).any()               # input untouched
    again = plan.maybe_poison_feeds(2, feeds)
    assert again is feeds                               # one-shot


def test_corrupt_file_modes(tmp_path):
    p = str(tmp_path / "blob")
    data = bytes(range(256)) * 8
    with open(p, "wb") as f:
        f.write(data)
    faults.corrupt_file(p, "bitflip", seed=3)
    with open(p, "rb") as f:
        assert zlib.crc32(f.read()) != zlib.crc32(data)
    with open(p, "wb") as f:
        f.write(data)
    faults.corrupt_file(p, "truncate")
    assert os.path.getsize(p) == len(data) // 2


# -------------------------------------------------------------------------
# RPC retry / reconnect / fault kinds on the wire
# -------------------------------------------------------------------------

def test_injected_faults_are_survived_exactly_once():
    """drop / close-mid-frame / duplicate each break the connection; the
    retry policy reconnects and re-issues; tagged rounds stay
    exactly-once (a duplicated frame double-delivers, the tag dedups)."""
    applied = []

    def opt(store, grads):
        applied.append({k: np.asarray(v).copy()
                        for k, v in grads.items()})

    server = VariableServer(fan_in=1, optimize_fn=opt).start()
    cli = RPCClient("127.0.0.1:%d" % server.port, retry=_fast_policy())
    plan = faults.arm({"rpc": {"drop": 0.25, "duplicate": 0.2,
                               "close_mid_frame": 0.1, "delay": 0.1,
                               "delay_s": 0.001,
                               "ports": [server.port], "max": 12}},
                      seed=11)
    g = np.ones((3,), np.float32)
    try:
        for s in range(8):
            cli.send_var("w@GRAD", g, tag="t0:iaaa:s%d" % s)
            cli.barrier(tag="t0:iaaa:s%d" % s)
    finally:
        faults.disarm()
        cli.shutdown_server()
        cli.close()
    assert len(applied) == 8
    for a in applied:
        np.testing.assert_allclose(a["w@GRAD"], g)      # never doubled
    assert len(plan.trips) > 0


def test_resolver_follows_replacement_server():
    """Endpoint resolver: when the connection breaks, the retrying
    client re-resolves — a replacement pserver on a NEW port is picked
    up transparently (membership-lease recovery shape)."""
    from paddle_tpu_torch.monitor import runtime as mrt
    s_a = VariableServer().start()
    s_a.store["w"] = np.zeros(2, np.float32)
    ep = {"cur": "127.0.0.1:%d" % s_a.port}
    cli = RPCClient(ep["cur"], retry=_fast_policy(),
                    resolver=lambda: ep["cur"])
    before = mrt.RECONNECTS.value(what="rpc")
    try:
        assert cli.get_var("w")[0] == 0
        s_b = VariableServer()
        s_b.store["w"] = np.ones(2, np.float32)
        s_b.start()
        s_a.stop()
        ep["cur"] = "127.0.0.1:%d" % s_b.port
        cli._drop_conn()          # the conn died with the old server
        assert cli.get_var("w")[0] == 1
        assert mrt.RECONNECTS.value(what="rpc") > before
    finally:
        cli.shutdown_server()
        cli.close()


@pytest.mark.parametrize("tag", [None, "free-form"])
def test_non_round_tagged_send_and_barrier_never_retry(tag):
    """A blind re-send of a gradient without a ROUND tag would
    double-accumulate: the server's cross-round dedup (_applied) is
    keyed by the parsed 't<id>:i<inc>:s<seq>' prefix, so neither an
    untagged nor a free-form-tagged SEND/BARR may be replayed — the
    retry wrapper must refuse, surfacing the error instead."""
    server = VariableServer().start()
    cli = RPCClient("127.0.0.1:%d" % server.port, retry=_fast_policy())
    plan = faults.arm({"rpc": {"drop": 1.0, "ops": ["SEND", "BARR"],
                               "ports": [server.port], "max": 2}},
                      seed=0)
    try:
        with pytest.raises((ConnectionError, OSError)):
            cli.send_var("w@GRAD", np.ones(2, np.float32), tag=tag)
        assert plan.trips == [("drop", "send:SEND")]
        cli._drop_conn()
        with pytest.raises((ConnectionError, OSError)):
            cli.barrier(tag=tag)
        assert plan.trips[1] == ("drop", "send:BARR")
    finally:
        faults.disarm()
        cli.close()
        server.stop()


def test_default_policy_deadline_governs_and_jitter_unsynced():
    """default_policy(): the backoff schedule must be able to fill the
    whole flag deadline (a handful of attempts must not exhaust first),
    and the jitter seed derives from the pid so a fleet of trainers
    does not back off in lockstep."""
    import os as _os
    from paddle_tpu_torch.resilience.retry import default_policy
    pol = default_policy()
    assert pol is not None                     # rpc_retry default: on
    assert pol.seed == _os.getpid()
    budget = 0.0
    for d in pol.delays():
        budget += d
        if budget >= pol.deadline:
            break
    assert budget >= pol.deadline


def test_nan_poison_falls_back_from_integer_feed():
    """Naming an int feed in the nan plan must not crash the step path:
    NaN can't live in an int array, so the poison falls back to a float
    feed (labels keep their dtype)."""
    plan = faults.FaultPlan({"nan": {"step": 0, "name": "label"}})
    feeds = {"img": np.ones((2, 2), np.float32),
             "label": np.zeros((2, 1), np.int64)}
    out = plan.maybe_poison_feeds(0, feeds)
    assert np.isnan(out["img"]).any()
    assert out["label"].dtype == np.int64


def test_side_streams_dropped_and_rebuilt_on_reconnect(monkeypatch):
    """Satellite: chunk-push side sockets must not survive a
    close()/reconnect — stale half-used streams would desync a retried
    push. The set rebuilds lazily and the push still lands."""
    monkeypatch.setattr(rpc, "_CHUNK_THRESHOLD", 1 << 10)
    monkeypatch.setattr(rpc, "_CHUNK_STREAMS", 2)
    server = VariableServer().start()
    cli = RPCClient("127.0.0.1:%d" % server.port, retry=_fast_policy())
    try:
        big = np.arange(4096, dtype=np.float32)
        cli.put_var("big", big)
        assert len(cli._side) == 2            # side streams opened
        cli._drop_conn()                      # retry-path reconnect
        assert cli._side == []                # stale entries dropped
        cli.put_var("big2", big + 1)          # rebuilds lazily
        assert len(cli._side) == 2
        np.testing.assert_array_equal(cli.get_var("big2"), big + 1)
        cli.close()
        assert cli._side == [] and cli._sock is None
    finally:
        cli2 = RPCClient("127.0.0.1:%d" % server.port)
        cli2.shutdown_server()
        cli2.close()


def test_client_context_managers():
    server = VariableServer().start()
    master = MasterServer(TaskQueue(payloads=["a"])).start()
    kvs = KVServer().start()
    with RPCClient("127.0.0.1:%d" % server.port) as c:
        c.put_var("x", np.ones(2, np.float32))
        assert c.get_var("x")[0] == 1
    assert c._sock is None
    with MasterClient("127.0.0.1:%d" % master.port) as mc:
        tid, payload = mc.get_task()
        assert payload == "a"
        mc.task_done(tid)
    assert mc._sock is None
    with KVClient(kvs.endpoint) as kc:
        kc.put("k", "v")
        assert kc.get("k") == "v"
    server.stop()
    master.stop()
    kvs.stop()


def test_master_client_retries_through_broken_connection():
    q = TaskQueue(payloads=list(range(3)), timeout_s=30)
    master = MasterServer(q).start()
    cli = MasterClient("127.0.0.1:%d" % master.port,
                       retry=_fast_policy())
    try:
        tid, payload = cli.get_task()
        cli._drop_conn()                      # connection dies mid-epoch
        cli.task_done(tid)                    # transparently reconnects
        assert cli.counts()["done"] == 1
    finally:
        cli.shutdown_server()
        cli.close()


# -------------------------------------------------------------------------
# corrupt-checkpoint fallbacks (satellite: io.load_checkpoint + recover)
# -------------------------------------------------------------------------

def _mk_linear_program():
    x = fluid.layers.data("x", [4])
    y = fluid.layers.data("y", [1])
    pred = fluid.layers.fc(x, 1, bias_attr=False,
                           param_attr=fluid.ParamAttr(name="w_res"))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _save_io_ckpts(dirname, values):
    """One io checkpoint per (step, value): the single param w_res set
    to `value` — so a load's provenance is readable off the weight."""
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.scope_guard(scope):
        _mk_linear_program()
        fluid.Executor(fluid.CPUPlace()).run(startup)
        for step, value in values:
            scope.set("w_res", np.full((4, 1), value, np.float32))
            pio.save_checkpoint(dirname, step, main, scope)
    return main


def _load_step_and_w(dirname, main):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        step = pio.load_checkpoint(dirname, main, scope)
        w = scope.find_var("w_res")
    return step, (None if w is None else float(np.asarray(w)[0, 0]))


@pytest.mark.parametrize("wreck", ["truncate", "bitflip", "missing_meta",
                                   "deleted_blob"])
def test_io_load_checkpoint_falls_back_past_corruption(tmp_path, wreck):
    d = str(tmp_path)
    main = _save_io_ckpts(d, [(1, 1.0), (2, 2.0), (3, 3.0)])
    blob = os.path.join(d, "ckpt-3.npz")
    if wreck in ("truncate", "bitflip"):
        faults.corrupt_file(blob, wreck, seed=5)
    elif wreck == "missing_meta":
        os.unlink(os.path.join(d, "meta-3.json"))
    else:
        os.unlink(blob)           # meta-3 now points at a deleted blob
    step, w = _load_step_and_w(d, main)
    assert step == 2 and w == 2.0


def test_io_load_checkpoint_all_corrupt_returns_none(tmp_path):
    d = str(tmp_path)
    main = _save_io_ckpts(d, [(1, 1.0), (2, 2.0)])
    for n in os.listdir(d):
        if n.startswith("ckpt-"):
            faults.corrupt_file(os.path.join(d, n), "bitflip", seed=1)
    step, _ = _load_step_and_w(d, main)
    assert step is None


@pytest.mark.parametrize("wreck", ["truncate", "bitflip", "missing_meta",
                                   "deleted_blob"])
def test_pserver_recover_falls_back_past_corruption(tmp_path, wreck):
    path = str(tmp_path / "ps.ckpt")
    s = VariableServer()
    s.store["w"] = np.full(3, 1.0, np.float32)
    s._round = 1
    s.checkpoint(path)
    s.store["w"] = np.full(3, 2.0, np.float32)
    s._round = 2
    s.checkpoint(path)
    s.stop()
    if wreck in ("truncate", "bitflip"):
        faults.corrupt_file(path + ".2", wreck, seed=5)
    elif wreck == "missing_meta":
        os.unlink(path + ".meta.2")
    else:
        os.unlink(path + ".2")
    s2 = VariableServer()
    assert s2.recover(path) == 1
    assert s2.store["w"][0] == 1.0
    s2.stop()


def test_pserver_recover_all_corrupt_returns_none(tmp_path):
    path = str(tmp_path / "ps.ckpt")
    s = VariableServer()
    s.store["w"] = np.ones(3, np.float32)
    s._round = 1
    s.checkpoint(path)
    s.stop()
    faults.corrupt_file(path + ".1", "bitflip", seed=2)
    s2 = VariableServer()
    assert s2.recover(path) is None
    s2.stop()


def test_pserver_checkpoint_retention_and_prune(tmp_path):
    path = str(tmp_path / "ps.ckpt")
    s = VariableServer()
    for r in range(1, 5):
        s.store["w"] = np.full(2, float(r), np.float32)
        s._round = r
        s.checkpoint(path, keep_last=2)
    s.stop()
    names = sorted(os.listdir(str(tmp_path)))
    # only the newest two (blob, meta) pairs + the newest-pointer remain
    assert names == ["ps.ckpt.3", "ps.ckpt.4", "ps.ckpt.meta",
                     "ps.ckpt.meta.3", "ps.ckpt.meta.4"]


def test_incremental_crc_blob_writer(tmp_path):
    """Satellite: the CRC is computed while writing (shared helper),
    never by re-reading — and it matches what a reader hashes."""
    data = os.urandom(3 << 20)
    crc = pio.write_atomic_blob(str(tmp_path), "blob.bin", data,
                                chunk=1 << 19)
    with open(str(tmp_path / "blob.bin"), "rb") as f:
        on_disk = f.read()
    assert on_disk == data
    assert crc == zlib.crc32(data)


def test_save_checkpoint_meta_crc_matches_blob(tmp_path):
    d = str(tmp_path)
    _save_io_ckpts(d, [(5, 7.0)])
    with open(os.path.join(d, "meta-5.json")) as f:
        meta = json.load(f)
    with open(os.path.join(d, meta["file"]), "rb") as f:
        assert zlib.crc32(f.read()) == meta["crc32"]


# -------------------------------------------------------------------------
# resilient_loop driver
# -------------------------------------------------------------------------

def _feeds(rng, n=8):
    xv = rng.rand(n, 4).astype(np.float32)
    return {"x": xv, "y": xv.sum(1, keepdims=True).astype(np.float32)}


def test_driver_nan_rollback_and_skip(tmp_path):
    faults.arm({"nan": {"step": 3, "name": "x"}}, seed=0)
    log = str(tmp_path / "run.jsonl")
    with monitor.session(log_path=log):
        summ = _resilient_run(
            _mk_linear_program, _feeds, str(tmp_path / "ck"), steps=6,
            checkpoint_every=2, background=False)
    assert summ["rollbacks"] == 1
    assert summ["skipped_steps"] == [3]
    assert summ["steps"] == 5                 # 6 batches, one skipped
    assert all(np.isfinite(summ["losses"]))
    evs = {e["ev"] for e in monitor.read_jsonl(log)}
    assert {"fault", "rollback", "checkpoint"} <= evs


def test_driver_auto_resume(tmp_path):
    ck = str(tmp_path / "ck")
    s1 = _resilient_run(_mk_linear_program, _feeds, ck, steps=5,
                               checkpoint_every=2, background=False)
    assert s1["resumed_from"] is None
    # "restart": fresh program/scope, same ckpt dir
    s2 = _resilient_run(_mk_linear_program, _feeds, ck, steps=2,
                               checkpoint_every=2, background=False)
    assert s2["resumed_from"] == 3            # newest ckpt (steps 1, 3)
    assert s2["start_step"] == 4


def test_driver_rollback_through_corrupt_newest_checkpoint(tmp_path):
    """The NaN rollback composes with the CRC fallback: the newest
    checkpoint was corrupted on disk, so the rollback target is the one
    before it."""
    ck = str(tmp_path / "ck")
    rolled = {}

    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.scope_guard(scope):
        _mk_linear_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        w_init = scope.get_numpy("w_res").copy()
        rng = np.random.RandomState(0)
        batches = [_feeds(rng) for _ in range(6)]

        def step_fn(step, feeds):
            return exe.run(main, feed=feeds,
                           fetch_list=[main.global_block().var(n)
                                       for n in [_loss_name(main)]])[0]

        def on_rollback(step):
            rolled["w"] = scope.get_numpy("w_res").copy()

        # ckpts: baseline step0 (nth=1), step1 (nth=2 — CORRUPTED)
        faults.arm({"ckpt": {"nth": 2, "mode": "bitflip"},
                    "nan": {"step": 2, "name": "x"}}, seed=0)
        summ = resilient_loop(step_fn, batches, ck, program=main,
                              scope=scope, checkpoint_every=2,
                              background=False, on_rollback=on_rollback)
    assert summ["rollbacks"] == 1 and summ["skipped_steps"] == [2]
    # the rollback landed on the step-0 baseline (== the init weights),
    # not the corrupt step-1 checkpoint
    np.testing.assert_array_equal(rolled["w"], w_init)


def _loss_name(program):
    """The mean op's output var name (the loss) of a built program."""
    for op in reversed(program.global_block().ops):
        if op.type == "mean":
            return op.output("Out")[0]
    raise AssertionError("no mean op")


def test_driver_background_writer_off_step_path(tmp_path):
    ck = str(tmp_path / "ck")
    summ = _resilient_run(_mk_linear_program, _feeds, ck,
                                 steps=6, checkpoint_every=2,
                                 background=True)
    assert summ["rollbacks"] == 0
    # background writer flushed on close: the newest ckpt is loadable
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.scope_guard(scope):
        _mk_linear_program()
        assert pio.load_checkpoint(ck, main, scope) is not None


def test_driver_too_many_rollbacks_raises(tmp_path):
    def bad_step(step, feeds):
        return np.float32("nan")

    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.scope_guard(scope):
        _mk_linear_program()
        fluid.Executor(fluid.CPUPlace()).run(startup)
        rng = np.random.RandomState(0)
        with pytest.raises(FloatingPointError):
            resilient_loop(bad_step, [_feeds(rng) for _ in range(9)],
                           str(tmp_path / "ck"), program=main,
                           scope=scope, checkpoint_every=2,
                           max_rollbacks=2, background=False)


# -------------------------------------------------------------------------
# the port against the JAX package, same seeds
# -------------------------------------------------------------------------

def _jax():
    import paddle_tpu
    from paddle_tpu.resilience import faults as jfaults, retry as jretry
    return paddle_tpu, jfaults, jretry


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_plan_decisions_match_the_jax_package(seed):
    _, jfaults, _ = _jax()
    spec = {"rpc": {"drop": 0.2, "close_mid_frame": 0.1,
                    "duplicate": 0.1, "delay": 0.3, "max": 150}}
    mine = faults.FaultPlan(spec, seed)
    theirs = jfaults.FaultPlan(spec, seed)
    kinds = faults._SEND_KINDS
    assert kinds == jfaults._SEND_KINDS
    for site in ("send:SEND", "send:BARR", "recv", "send:GET"):
        a = [mine._draw(site, kinds) for _ in range(60)]
        b = [theirs._draw(site, kinds) for _ in range(60)]
        assert a == b, site
        assert len(set(a)) > 2, a          # the draw is not degenerate
    assert mine.trips == theirs.trips


@pytest.mark.parametrize("kw", [
    dict(max_attempts=6, base_delay=0.05, max_delay=2.0, seed=3),
    dict(max_attempts=9, base_delay=0.1, max_delay=0.5, multiplier=3.0,
         jitter=0.5, seed=11),
])
def test_backoff_sequences_match_the_jax_package(kw):
    _, _, jretry = _jax()
    assert list(Policy(**kw).delays()) == list(jretry.Policy(**kw).delays())


@pytest.mark.parametrize("mode, seed", [("bitflip", 0), ("bitflip", 5),
                                        ("truncate", 0)])
def test_corrupt_file_bytes_match_the_jax_package(tmp_path, mode, seed):
    _, jfaults, _ = _jax()
    blob = np.random.RandomState(seed).bytes(4096)
    paths = []
    for i, fn in enumerate((faults.corrupt_file, jfaults.corrupt_file)):
        p = str(tmp_path / ("b%d" % i))
        with open(p, "wb") as f:
            f.write(blob)
        fn(p, mode, seed=seed)
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        got, want = a.read(), b.read()
    assert got == want and got != blob


def test_resilient_loop_matches_the_jax_package(tmp_path):
    """The same NaN plan, program and start values through both
    packages' ``resilient_loop``: the same summary (steps, rollbacks,
    skipped steps) and weights within 2e-4."""
    jfluid, jfaults, _ = _jax()
    from paddle_tpu.resilience import resilient_loop as jloop

    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", [4])
            y = pkg.layers.data("y", [1])
            pred = pkg.layers.fc(x, 1, bias_attr=False,
                                 param_attr=pkg.ParamAttr(name="w_res"))
            loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return main, startup, loss

    rng = np.random.RandomState(4)
    batches = [_feeds(rng) for _ in range(6)]
    jmain, jstart, jloss = build(jfluid)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    w0 = np.asarray(jscope.find_var("w_res")).copy()
    tmain, tstart, tloss = build(fluid)
    tscope = fluid.Scope()
    texe = fluid.Executor(fluid.CPUPlace())
    texe.run(tstart, scope=tscope)
    fluid.load_numpy_state(tscope, {"w_res": w0}, "cpu")

    spec = {"nan": {"step": 2, "name": "x"}}
    jfaults.arm(spec, seed=0)
    try:
        want = jloop(lambda s, f: jexe.run(jmain, feed=f, fetch_list=[jloss],
                                           scope=jscope)[0],
                     batches, str(tmp_path / "j"), program=jmain,
                     scope=jscope, checkpoint_every=2, background=False)
    finally:
        jfaults.disarm()
    faults.arm(spec, seed=0)
    try:
        got = resilient_loop(
            lambda s, f: texe.run(tmain, feed=f, fetch_list=[tloss],
                                  scope=tscope)[0],
            batches, str(tmp_path / "t"), program=tmain, scope=tscope,
            checkpoint_every=2, background=False)
    finally:
        faults.disarm()
    for k in ("steps", "rollbacks", "skipped_steps", "resumed_from",
              "checkpoints"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(tscope.get_numpy("w_res"),
                               np.asarray(jscope.find_var("w_res")),
                               rtol=2e-4, atol=2e-4)
