"""The port's counterpart of tests/test_membership.py: the same scenarios
against paddle_tpu_torch on the CPU. Lease expiries and rendezvous are
waited for with bounded polls (tests/torch_wire_harness.py), never fixed
sleeps.

Elastic membership tier.

Reference parity: go/pserver/etcd_client.go:43-100 — TTL-lease slot
registration with CAS + desired-count rendezvous; go/master/service.go —
task redistribution around trainer churn. Scenarios pinned here:
 * KV store semantics: put/get, TTL expiry, CAS create-if-absent, lease
   keepalive.
 * pserver rendezvous: N servers claim N slots, trainers block until all
   claimed.
 * THE elastic scenario: 2 pservers under lease, one killed mid-run; its
   lease expires, a REPLACEMENT claims the same slot, recovers the shard
   from checkpoint, and training completes with exactly the state an
   uninterrupted run produces (send-tag idempotency makes the retried
   round exactly-once).
 * trainer join/leave: a trainer dies mid-task; the master times the task
   out and a late-joining trainer finishes the queue.
"""

import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch.distributed import ops as dist_ops
from paddle_tpu_torch.distributed.membership import (
    KVServer, KVClient, register_pserver, wait_for_pservers,
    TrainerLease, PS_PREFIX)
from paddle_tpu_torch.distributed.rpc import (RPCClient, VariableServer,
                                              StaleIncarnationError)
from paddle_tpu_torch.distributed.master import (MasterServer, MasterClient,
                                                 TaskQueue)
from torch_wire_harness import until, wait_serving


@pytest.fixture
def kv():
    server = KVServer(sweep_interval=0.05).start()
    cli = KVClient(server.endpoint)
    yield cli
    try:
        cli.shutdown_server()
        cli.close()
    except OSError:
        pass


def test_kv_put_get_ttl_cas(kv):
    kv.put("a", "1")
    assert kv.get("a") == "1"
    kv.put("b", "2", ttl=0.15)
    assert kv.get("b") == "2"
    until(lambda: kv.get("b") is None)         # lease expired
    # CAS create-if-absent
    assert kv.cas("c", None, "x")
    assert not kv.cas("c", None, "y")          # already exists
    assert kv.cas("c", "x", "y")               # swap
    assert kv.get("c") == "y"
    # lease keepalive holds a key past its original TTL (2 s of 0.25 s
    # keepalives on a 1 s TTL: only a 1 s stall could drop it)
    kv.put("d", "3", ttl=1.0)
    for _ in range(8):
        time.sleep(0.25)
        assert kv.lease_keepalive("d", 1.0)
    assert kv.get("d") == "3"
    assert sorted(kv.list("")) == ["a", "c", "d"]


def test_pserver_rendezvous_and_slot_reuse(kv):
    i0, lease0 = register_pserver(kv, 2, "ep0:1", ttl=0.3)
    i1, lease1 = register_pserver(kv, 2, "ep1:1", ttl=0.3)
    assert {i0, i1} == {0, 1}
    eps = wait_for_pservers(kv, 2, timeout=5)
    assert eps == ["ep0:1", "ep1:1"] if i0 == 0 else ["ep1:1", "ep0:1"]
    # kill server 1 (no revoke — crash): slot frees after TTL
    lease1._stop.set()
    until(lambda: len(kv.list("/ps/")) == 1)
    i_new, lease_new = register_pserver(kv, 2, "ep2:1", ttl=0.3)
    assert i_new == i1                          # same slot reclaimed
    eps = wait_for_pservers(kv, 2, timeout=5)
    assert "ep2:1" in eps
    lease0.revoke()
    lease_new.revoke()
    assert kv.list("/ps/") == {}


def test_trainer_join_leave_master_redistributes(kv):
    """Trainer A dies mid-task (lease lapses, no ack); the master times
    the task out; trainer B joins later and drains the queue."""
    master = MasterServer(TaskQueue(
        payloads=["chunk%d" % i for i in range(6)],
        timeout_s=0.3, max_retries=3)).start()
    ep = "127.0.0.1:%d" % master.port

    a = TrainerLease(kv, "A", ttl=0.2)
    ca = MasterClient(ep, worker_id="A")
    tid1, payload1 = ca.get_task()
    assert tid1 is not None                    # A holds a task...
    a._lease._stop.set()                       # ...and crashes (no ack)
    until(lambda: "A" not in TrainerLease.live_trainers(kv))

    b = TrainerLease(kv, "B", ttl=0.5)
    assert TrainerLease.live_trainers(kv) == ["B"]
    cb = MasterClient(ep, worker_id="B")
    got = []
    deadline = time.time() + 10
    while time.time() < deadline:
        tid, payload = cb.get_task()
        if tid is None:
            if payload == "done":
                break
            time.sleep(0.1)
            continue
        got.append(payload)
        cb.task_done(tid)
    assert master.queue.all_done()
    # A's abandoned task was redistributed to B
    assert payload1 in got
    assert len(set(got)) == 6                  # every chunk processed
    b.leave()
    ca.close()
    cb.close()
    master.stop()


def _mk_trainer(lr=0.1):
    x = fluid.layers.data("x", [4])
    y = fluid.layers.data("y", [1])
    pred = fluid.layers.fc(
        x, 1, bias_attr=False,
        param_attr=fluid.ParamAttr(
            name="w_el", initializer=fluid.initializer.Constant(0.0)))
    h = fluid.layers.fc(
        pred, 1, bias_attr=False,
        param_attr=fluid.ParamAttr(
            name="v_el", initializer=fluid.initializer.Constant(1.0)))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(h, y))
    fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return loss


def _boot_ps(t, ep, scope_holder):
    prog = t.get_pserver_program(ep)
    pstart = t.get_startup_program(ep)
    sscope = fluid.Scope()
    with fluid.scope_guard(sscope):
        fluid.Executor(fluid.CPUPlace()).run(pstart)

    def run():
        fluid.Executor(fluid.CPUPlace()).run(prog, feed={},
                                             fetch_list=[], scope=sscope)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    scope_holder[ep] = (sscope, th)
    return th


def test_pserver_killed_and_replaced_training_state_correct(kv):
    """Start 2 pservers under lease, train, kill one, register a
    replacement recovered from checkpoint, finish training — final
    params equal the uninterrupted run (exactly-once rounds)."""
    rng = np.random.RandomState(0)
    xv = rng.rand(16, 4).astype(np.float32)
    yv = (xv @ np.array([1., 2., 3., 4.], np.float32))[:, None]
    steps = 6

    # ---- uninterrupted local baseline -------------------------------
    main0, startup0 = fluid.Program(), fluid.Program()
    scope0 = fluid.Scope()
    with fluid.program_guard(main0, startup0), fluid.scope_guard(scope0):
        loss0 = _mk_trainer()
        exe0 = fluid.Executor(fluid.CPUPlace())
        exe0.run(startup0)
        for _ in range(steps):
            exe0.run(main0, feed={"x": xv, "y": yv}, fetch_list=[loss0])
        w_base = scope0.get_numpy("w_el").copy()
        v_base = scope0.get_numpy("v_el").copy()

    # ---- elastic run: 2 pservers, one dies at step 3 ----------------
    import tempfile
    ckpt_dir = tempfile.mkdtemp()
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.scope_guard(scope):
        loss = _mk_trainer()
        t = fluid.DistributeTranspiler(mode="pserver")
        # claim slots first so endpoints are real before transpile
        probe0 = VariableServer()
        probe1 = VariableServer()
        ep0 = "127.0.0.1:%d" % probe0.port
        ep1 = "127.0.0.1:%d" % probe1.port
        probe0.stop()
        probe1.stop()
        _, lease0 = register_pserver(kv, 2, ep0, ttl=0.3)
        _, lease1 = register_pserver(kv, 2, ep1, ttl=0.3)
        eps = wait_for_pservers(kv, 2)
        t.transpile(trainer_id=0, program=main, pservers=",".join(eps),
                    trainers=1)

        holders = {}
        _boot_ps(t, eps[0], holders)
        _boot_ps(t, eps[1], holders)
        wait_serving(eps[0])
        wait_serving(eps[1])

        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        done = 0
        killed = False
        while done < steps:
            try:
                exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss])
                done += 1
            except Exception:
                # server gone: wait for the replacement rendezvous and
                # retry THE SAME step (same send tags → exactly-once)
                dist_ops.reset_clients()
                new_eps = wait_for_pservers(kv, 2, timeout=10)
                remap = dict(zip(eps, new_eps))
                for op in main.global_block().ops:
                    if op.type in ("send", "recv", "send_sparse",
                                   "prefetch"):
                        op.attrs["epmap"] = [remap.get(e, e) for e in
                                             op.attrs.get("epmap", [])]
                        op.attrs["endpoints"] = new_eps
                continue
            if done == 3 and not killed:
                killed = True
                # snapshot server 1's state, then hard-kill it
                cli = RPCClient(eps[1])
                park = {}
                for vn in ("w_el", "v_el"):
                    try:
                        park[vn] = cli.get_var(vn)
                    except KeyError:
                        pass
                cli.close()
                np.savez(ckpt_dir + "/shard1.npz", **park)
                # crash: no lease revoke, no graceful shutdown
                lease1._stop.set()
                cli2 = RPCClient(eps[1])
                cli2.shutdown_server()
                cli2.close()
                dist_ops.reset_clients()
                # lease expires, slot frees
                until(lambda: len(kv.list("/ps/")) == 1)

                # replacement: new port, recovers shard state, claims
                # the freed slot
                probe2 = VariableServer()
                ep2 = "127.0.0.1:%d" % probe2.port
                probe2.stop()
                slot, lease2 = register_pserver(kv, 2, ep2, ttl=0.3)
                assert slot == 1
                t2 = fluid.DistributeTranspiler(mode="pserver")
                # rebuild server program against the same trainer program
                # structure: reuse t with swapped endpoint
                t._eps = [eps[0], ep2]
                _boot_ps(t, ep2, holders)
                wait_serving(ep2)
                # restore the recovered state into the new server
                data = np.load(ckpt_dir + "/shard1.npz")
                cli3 = RPCClient(ep2)
                for vn in data.files:
                    cli3.put_var(vn, data[vn])
                cli3.close()
                dist_ops.reset_clients()

        # final params the trainer-visible way: recv already put them
        # in the trainer scope at the last successful step
        w_fin = scope.get_numpy("w_el").copy()
        v_fin = scope.get_numpy("v_el").copy()

        for epx in list(holders):
            try:
                cli = RPCClient(epx)
                cli.shutdown_server()
                cli.close()
            except OSError:
                pass
        dist_ops.reset_clients()
        lease0.revoke()

    np.testing.assert_allclose(w_fin, w_base, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v_fin, v_base, rtol=1e-5, atol=1e-6)


def test_send_tag_exactly_once_rounds():
    """At-least-once retries become exactly-once rounds: a duplicate
    tagged SEND replaces (not accumulates), a duplicate BARR of the same
    tag doesn't double-count fan_in, a retry of an ALREADY-APPLIED round
    is a no-op, and pending grads of a dead trainer incarnation are
    evicted when its replacement sends."""
    applied = []

    def opt(store, grads):
        applied.append({k: np.asarray(v).copy() for k, v in grads.items()})
        for k, g in grads.items():
            p = k.replace("@GRAD", "")
            if p in store:
                store[p] = store[p] - np.asarray(g)

    server = VariableServer(fan_in=1, optimize_fn=opt).start()
    cli = RPCClient("127.0.0.1:%d" % server.port)
    try:
        cli.put_var("w", np.zeros((2,), np.float32))
        g = np.ones((2,), np.float32)

        # round s0: send, then RETRY the send (simulated failed recv),
        # then barrier twice with the same tag
        cli.send_var("w@GRAD", g, tag="t0:iaaa:s0")
        cli.send_var("w@GRAD", g, tag="t0:iaaa:s0")     # replaced
        cli.barrier(tag="t0:iaaa:s0")
        assert len(applied) == 1
        np.testing.assert_allclose(applied[0]["w@GRAD"], g)  # not 2g
        np.testing.assert_allclose(cli.get_var("w"), -g)

        # full retry of the APPLIED round: send + barrier are no-ops
        cli.send_var("w@GRAD", g, tag="t0:iaaa:s0")
        cli.barrier(tag="t0:iaaa:s0")
        assert len(applied) == 1
        np.testing.assert_allclose(cli.get_var("w"), -g)

        # trainer restarts (new incarnation): it first leaves a stale
        # pending grad... (crash before barrier)
        cli.send_var("w@GRAD", 5 * g, tag="t0:iaaa:s1")
        # ...the replacement incarnation's send evicts it
        cli.send_var("w@GRAD", g, tag="t0:ibbb:s0")
        cli.barrier(tag="t0:ibbb:s0")
        assert len(applied) == 2
        np.testing.assert_allclose(applied[1]["w@GRAD"], g)   # not 6g
        np.testing.assert_allclose(cli.get_var("w"), -2 * g)
    finally:
        cli.shutdown_server()
        cli.close()


def test_rpc_zero_size_arrays_roundtrip():
    """Zero-length dimensions must serialize (memoryview.cast rejects
    them; the wire falls back to empty buffers)."""
    from paddle_tpu_torch.distributed.rpc import serialize_var, deserialize_var
    from paddle_tpu_torch.core.selected_rows import SelectedRows

    a = np.zeros((0, 4), np.float32)
    got = deserialize_var(serialize_var(a))
    assert got.shape == (0, 4)
    sr = SelectedRows(np.zeros((0,), np.int64),
                      np.zeros((0, 3), np.float32), 7)
    got = deserialize_var(serialize_var(sr))
    assert got.value.shape == (0, 3) and got.height == 7

    server = VariableServer().start()
    cli = RPCClient("127.0.0.1:%d" % server.port)
    try:
        cli.put_var("empty", a)
        back = cli.get_var("empty")
        assert back.shape == (0, 4)
    finally:
        cli.shutdown_server()
        cli.close()


def test_stale_incarnation_barrier_and_grads_evicted():
    """A restarted trainer must not (a) double-count fan_in with its dead
    incarnation's barrier, nor (b) let the dead incarnation's pending
    grad — under ANY name — leak into the next round."""
    applied = []

    def opt(store, grads):
        applied.append({k: np.asarray(v).copy()
                        for k, v in grads.items()})

    server = VariableServer(fan_in=2, optimize_fn=opt).start()
    c_a = RPCClient("127.0.0.1:%d" % server.port)
    c_b = RPCClient("127.0.0.1:%d" % server.port)
    g = np.ones((2,), np.float32)
    try:
        # trainer A (incarnation i1): sends TWO names, barriers, crashes
        # while waiting for B
        c_a.send_var("w@GRAD", 5 * g, tag="t0:i111:s0")
        c_a.send_var("u@GRAD", 5 * g, tag="t0:i111:s0")
        th = threading.Thread(target=lambda: c_a.barrier(tag="t0:i111:s0"),
                              daemon=True)
        th.start()
        until(lambda: server._barrier_count == 1)

        # A restarts (incarnation i222) and only re-sends ONE name
        c_a2 = RPCClient("127.0.0.1:%d" % server.port)
        c_a2.send_var("w@GRAD", g, tag="t0:i222:s0")
        # the dead barrier slot must be evicted when A2 barriers — the
        # round needs A2 + B, not A(dead) + A2
        tb = threading.Thread(target=lambda: c_a2.barrier(
            tag="t0:i222:s0"), daemon=True)
        tb.start()
        time.sleep(0.3)
        assert len(applied) == 0        # round must NOT have fired yet
        # trainer B arrives: round completes with exactly A2's + B's
        c_b.send_var("w@GRAD", g, tag="t1:ibbb:s0")
        c_b.barrier(tag="t1:ibbb:s0")
        tb.join(timeout=5)
        assert len(applied) == 1
        np.testing.assert_allclose(applied[0]["w@GRAD"], 2 * g)  # not 7g
        # the dead incarnation's u@GRAD never survived
        assert "u@GRAD" not in applied[0]
        c_a2.close()
    finally:
        c_b.shutdown_server()
        c_a.close()
        c_b.close()


def test_dead_incarnation_straggler_dropped_by_epoch_gate():
    """A delayed message from a DEAD incarnation (older time_ns epoch,
    the Executor's incarnation format) must be dropped outright — even
    when its applied-round history was pruned — so it can neither evict
    the live replacement's pending grads nor contribute its own."""
    applied = []

    def opt(store, grads):
        applied.append({k: np.asarray(v).copy()
                        for k, v in grads.items()})

    inc_old = "%016x" % 1000 + "aaaaaaaa"   # epoch 1000
    inc_new = "%016x" % 2000 + "bbbbbbbb"   # epoch 2000 (replacement)
    server = VariableServer(fan_in=1, optimize_fn=opt).start()
    cli = RPCClient("127.0.0.1:%d" % server.port)
    g = np.ones((2,), np.float32)
    try:
        # replacement incarnation sends its grad first
        cli.send_var("w@GRAD", 2 * g, tag="t0:i%s:s0" % inc_new)
        # dead incarnation's straggler arrives late: rejected with STLE
        # (NOT silently acked — a live-but-skewed sender must find out),
        # and the replacement's pending grad must survive untouched
        with pytest.raises(StaleIncarnationError) as exc:
            cli.send_var("w@GRAD", 100 * g, tag="t0:i%s:s7" % inc_old)
        assert exc.value.max_epoch == 2000
        with server._lock:
            assert len(server.grads["w@GRAD"]) == 1
        # a straggler BARR is rejected too and must not count
        with pytest.raises(StaleIncarnationError):
            cli.barrier(tag="t0:i%s:s7" % inc_old)
        assert len(applied) == 0
        cli.barrier(tag="t0:i%s:s0" % inc_new)
        assert len(applied) == 1
        np.testing.assert_allclose(applied[0]["w@GRAD"], 2 * g)
    finally:
        cli.shutdown_server()
        cli.close()


def test_stale_live_trainer_reincarnates_and_recovers():
    """The OTHER side of the epoch gate: a LIVE trainer judged stale
    (rescheduled onto a host whose clock is behind) must not deadlock —
    the send op re-incarnates past the server's max epoch and retries
    the whole round, which then applies its gradient."""
    import types
    from paddle_tpu_torch.distributed import ops as dops
    applied = []

    def opt(store, grads):
        applied.append({k: np.asarray(v).copy()
                        for k, v in grads.items()})

    server = VariableServer(fan_in=1, optimize_fn=opt).start()
    ep = "127.0.0.1:%d" % server.port
    seed = RPCClient(ep)
    g = np.ones((2,), np.float32)
    try:
        # server has already seen epoch 2000 for trainer 0
        seed.send_var("w@GRAD", 9 * g,
                      tag="t0:i%s:s0" % ("%016x" % 2000 + "bbbbbbbb"))
        # live trainer restarts with a BEHIND clock: epoch 1000
        ex = fluid.Executor(fluid.CPUPlace())
        ex._incarnation = "%016x" % 1000 + "aaaaaaaa"
        ctx = types.SimpleNamespace(
            executor=ex, incarnation=ex._incarnation + "pn", run_seq=0,
            env={"w@GRAD": 3 * g}, get=lambda n: 3 * g)

        class _Op:
            def attr(self, name, default=None):
                return {"trainer_id": 0, "endpoints": [ep],
                        "sync": True}.get(name, default)

            def input(self, k):
                return ["w@GRAD"]

        dops._send(ctx, _Op())
        assert len(applied) == 1
        np.testing.assert_allclose(applied[0]["w@GRAD"], 3 * g)
        # executor minted an incarnation past the server's max epoch
        assert int(ex._incarnation[:16], 16) > 2000
        assert ctx.incarnation.endswith("pn")
    finally:
        seed.shutdown_server()
        seed.close()
        dops.reset_clients()


def test_reincarnation_replays_whole_round_and_skips_closed():
    """Re-incarnating mid-round changes the tag, so (a) EARLIER tagged
    sends of the same round must be replayed (the first new-tag message
    evicts their old-tag pending grads), and (b) endpoints whose round
    barrier already completed must be skipped (their round applied the
    old-tag grads; a new-tag resend would double-apply)."""
    import types
    from paddle_tpu_torch.distributed import ops as dops
    applied = []

    def opt(store, grads):
        applied.append({k: np.asarray(v).copy()
                        for k, v in grads.items()})

    server = VariableServer(fan_in=1, optimize_fn=opt).start()
    ep = "127.0.0.1:%d" % server.port
    cli = RPCClient(ep)
    g = np.ones((2,), np.float32)
    try:
        ex = fluid.Executor(fluid.CPUPlace())
        ex._incarnation = "%016x" % 1000 + "aaaaaaaa"
        env = {"w@GRAD": 3 * g,
               "ids0": np.array([1, 3], np.int64),
               "emb@GRAD@RAW": np.ones((2, 2), np.float32)}
        ctx = types.SimpleNamespace(
            executor=ex, incarnation=ex._incarnation + "pn", run_seq=0,
            env=env, get=lambda n: env[n])

        class _DenseOp:
            def attr(self, name, default=None):
                return {"trainer_id": 0, "endpoints": [ep],
                        "sync": False}.get(name, default)

            def input(self, k):
                return ["w@GRAD"]

        class _SparseOp:
            def attr(self, name, default=None):
                return {"trainer_id": 0, "endpoints": [ep],
                        "grad_name": "emb@GRAD", "height": 10
                        }.get(name, default)

            def input(self, k):
                return {"Ids": ["ids0"], "Grads": ["emb@GRAD@RAW"]}[k]

        # dense send lands first (epoch 1000 becomes the max)
        dops._send(ctx, _DenseOp())
        # a dead predecessor's HIGHER-epoch straggler now arrives: it
        # bumps max to 2000 and evicts the live trainer's pending dense
        # grad (different incarnation, same trainer id)
        cli.send_var("x@GRAD", 9 * g,
                     tag="t0:i%s:s0" % ("%016x" % 2000 + "bbbbbbbb"))
        with server._lock:
            assert "w@GRAD" not in server.grads \
                or not server.grads["w@GRAD"]
        # the sparse send is now judged stale → re-incarnate → the
        # WHOLE round (dense + sparse) replays under the new tag
        dops._send_sparse(ctx, _SparseOp())
        cli.barrier()        # untagged trailing barrier closes the round
        assert len(applied) == 1
        assert "w@GRAD" in applied[0], applied[0].keys()   # replayed
        assert "emb@GRAD" in applied[0]
        assert "x@GRAD" not in applied[0]   # dead straggler evicted
        np.testing.assert_allclose(applied[0]["w@GRAD"], 3 * g)

        # (b) an endpoint whose barrier completed is skipped on replay:
        # journal replay must not re-send or re-barrier a closed server
        ctx2 = types.SimpleNamespace(
            executor=ex, incarnation=ex._incarnation + "pn", run_seq=1,
            env=env, get=lambda n: env[n],
            _round_journal=[], round_closed_eps={ep})

        class _SyncOp(_DenseOp):
            def attr(self, name, default=None):
                return {"trainer_id": 0, "endpoints": [ep],
                        "sync": True}.get(name, default)

        dops._send(ctx2, _SyncOp())
        assert len(applied) == 1      # nothing sent, no round fired
        with server._lock:
            assert not server.grads.get("w@GRAD")
    finally:
        cli.shutdown_server()
        cli.close()
        dops.reset_clients()


def test_lease_reclaims_after_stall(kv):
    """A heartbeat that finds its key expired (stall > TTL) must reclaim
    the slot atomically rather than vanish; if ANOTHER server claimed it
    meanwhile, the lease reports `lost` instead of split-braining."""
    i, lease = register_pserver(kv, 1, "epA:1", ttl=0.4)
    # simulate a stall: delete the key out from under the lease (as the
    # TTL sweeper would); the next heartbeat must re-create it
    kv.delete(PS_PREFIX + "0")
    until(lambda: kv.get(PS_PREFIX + "0") == "epA:1")
    assert not lease.lost

    # now a competitor steals the slot during a stall: holder must
    # detect the loss and stop
    lease2_val = "epB:1"
    kv.delete(PS_PREFIX + "0")
    assert kv.cas(PS_PREFIX + "0", None, lease2_val, ttl=5.0)
    until(lambda: lease.lost)
    assert kv.get(PS_PREFIX + "0") == "epB:1"
    lease.revoke()
    # the loser's graceful leave must NOT free the new owner's slot
    assert kv.get(PS_PREFIX + "0") == "epB:1"


def test_revoke_is_compare_and_delete(kv):
    """Even when `lost` was never observed (heartbeat thread raced or
    died), revoke only deletes the key if it still holds OUR value."""
    i, lease = register_pserver(kv, 1, "epA:1", ttl=0.4)
    lease._stop.set()                    # freeze the heartbeat thread
    lease._thread.join(timeout=2.0)
    kv.put(PS_PREFIX + "0", "epB:1", ttl=5.0)   # usurper took the slot
    lease.revoke()
    assert kv.get(PS_PREFIX + "0") == "epB:1"
    # and cad() itself: deletes only on a value match
    kv.put("/x", "v1")
    assert not kv.cad("/x", "other")
    assert kv.get("/x") == "v1"
    assert kv.cad("/x", "v1")
    assert kv.get("/x") is None


def test_trainer_lease_incarnations_distinct(kv):
    """Two incarnations of the same trainer id must hold DISTINGUISHABLE
    leases: a stalled old incarnation's heartbeat cannot extend the
    replacement's lease, so the old one observes `lost` (split-brain
    guard — with a shared 'alive' value both would think they own the
    slot)."""
    old = TrainerLease(kv, "7", ttl=0.4)
    assert TrainerLease.live_trainers(kv) == ["7"]
    # replacement incarnation overwrites the key (restart after a stall)
    new = TrainerLease(kv, "7", ttl=0.4)
    assert new._lease.value != old._lease.value
    until(lambda: old._lease.lost)   # old heartbeats hit the expect-guard
    assert not new._lease.lost
    # old incarnation's graceful leave must not deregister the new one
    old.leave()
    assert TrainerLease.live_trainers(kv) == ["7"]
    new.leave()
    assert TrainerLease.live_trainers(kv) == []
