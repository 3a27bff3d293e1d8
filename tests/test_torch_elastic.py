"""The port's counterpart of tests/test_elastic.py: the same five
scenarios against paddle_tpu_torch on the CPU. Lease and task timeouts
are waited for with bounded polls (tests/torch_wire_harness.py), never
fixed sleeps.

Elastic / fault-tolerance tier: master task queue with
timeout+retry+snapshot, pserver checkpoint/recover, and the two
kill-and-resume stories — a trainer dying mid-epoch and a pserver dying
mid-run — completing with correct final state."""

import os
import threading
import time

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.distributed.master import (TaskQueue, MasterServer,
                                                 MasterClient)
from paddle_tpu_torch.distributed.rpc import VariableServer, RPCClient
from paddle_tpu_torch.distributed import ops as dist_ops
from torch_wire_harness import until


def test_task_queue_basic_and_retry():
    q = TaskQueue(payloads=["a", "b"], timeout_s=0.2, max_retries=1)
    t1 = q.get_task("w1")
    t2 = q.get_task("w2")
    assert {t1["payload"], t2["payload"]} == {"a", "b"}
    assert q.get_task("w1") is None
    q.task_done(t1["id"])
    # w2 never acks: lease expires, task returns to todo with retries+1
    t2b = until(lambda: q.get_task("w3"))
    assert t2b["payload"] == t2["payload"] and t2b["retries"] == 1
    # expire again -> retries exceeds max -> failed
    until(lambda: q.get_task("w4") is None and q.counts()["failed"] == 1)
    c = q.counts()
    assert c == {"todo": 0, "pending": 0, "done": 1, "failed": 1}


def test_task_queue_snapshot_resume(tmp_path):
    snap = str(tmp_path / "queue.json")
    q = TaskQueue(payloads=["x", "y", "z"], timeout_s=5, snapshot_path=snap)
    t = q.get_task("w1")
    q.task_done(t["id"])
    q.get_task("w1")              # leave one pending at "crash" time
    # master restarts from the snapshot: pending leases go back to todo
    q2 = TaskQueue(timeout_s=5, snapshot_path=snap)
    c = q2.counts()
    assert c["done"] == 1 and c["todo"] == 2 and c["pending"] == 0


def test_master_server_trainer_killed_mid_epoch(tmp_path):
    """Two trainers consume chunks; one dies holding a task. Its lease
    times out, the surviving trainer finishes every chunk."""
    chunks = [{"lo": i * 4, "hi": (i + 1) * 4} for i in range(6)]
    q = TaskQueue(payloads=chunks, timeout_s=0.3, max_retries=3,
                  snapshot_path=str(tmp_path / "q.json"))
    server = MasterServer(q).start()
    ep = "127.0.0.1:%d" % server.port
    seen = []
    lock = threading.Lock()

    def load(payload):
        return range(payload["lo"], payload["hi"])

    def good_trainer():
        cli = MasterClient(ep, "good")
        for rec in cli.records(load):
            with lock:
                seen.append(rec)
        cli.close()

    def dying_trainer():
        cli = MasterClient(ep, "doomed")
        task_id, payload = cli.get_task()
        assert task_id is not None
        cli.close()              # dies without ack — lease must expire

    try:
        d = threading.Thread(target=dying_trainer)
        d.start()
        d.join()
        g = threading.Thread(target=good_trainer)
        g.start()
        g.join(timeout=20)
        assert not g.is_alive(), "good trainer hung"
        assert sorted(seen) == list(range(24)), \
            "every record must be delivered despite the dead trainer"
    finally:
        cli = MasterClient(ep)
        cli.shutdown_server()
        cli.close()


def test_pserver_checkpoint_recover(tmp_path):
    path = str(tmp_path / "ps.ckpt")
    s1 = VariableServer()
    s1.store["w"] = np.arange(6, dtype=np.float32).reshape(2, 3)
    s1._round = 7
    meta = s1.checkpoint(path)
    assert meta["round"] == 7
    s1.stop()

    s2 = VariableServer()
    assert s2.recover(path) == 7
    np.testing.assert_array_equal(s2.store["w"],
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    s2.stop()
    # corrupt blob is rejected, not trusted (blob name comes from the meta)
    import json
    with open(path + ".meta") as f:
        blob = os.path.join(os.path.dirname(path), json.load(f)["blob"])
    with open(blob, "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff")
    s3 = VariableServer()
    assert s3.recover(path) is None
    s3.stop()


def test_pserver_killed_mid_run_resumes(tmp_path):
    """Kill the pserver mid-training; restart it from its checkpoint; the
    trainer finishes and the final weights match an uninterrupted run."""
    path = str(tmp_path / "ps2.ckpt")
    rng = np.random.RandomState(3)
    xv = rng.rand(16, 4).astype(np.float32)
    yv = (xv @ np.array([2., -1., 0.5, 1.], np.float32))[:, None]
    lr = 0.1

    def opt(store, grads):
        for k, g in grads.items():
            p = k.replace("@GRAD", "")
            if p in store:
                store[p] = store[p] - lr * np.asarray(g)

    def grad(w):
        pred = xv @ w
        return xv.T @ (2.0 / len(xv) * (pred - yv))

    # --- uninterrupted reference: 10 plain SGD steps --------------------
    w_ref = np.zeros((4, 1), np.float32)
    for _ in range(10):
        w_ref = w_ref - lr * grad(w_ref)

    # --- interrupted run: 5 steps, kill, recover, 5 more ----------------
    s1 = VariableServer(fan_in=1, optimize_fn=opt, sync=False).start()
    c1 = RPCClient("127.0.0.1:%d" % s1.port)
    c1.put_var("w", np.zeros((4, 1), np.float32))
    for _ in range(5):
        w = c1.get_var("w")
        c1.send_var("w@GRAD", grad(w))
    s1.checkpoint(path)
    c1.close()
    s1.stop()                      # pserver dies

    s2 = VariableServer(fan_in=1, optimize_fn=opt, sync=False)
    assert s2.recover(path) is not None
    s2.start()
    c2 = RPCClient("127.0.0.1:%d" % s2.port)
    for _ in range(5):
        w = c2.get_var("w")
        c2.send_var("w@GRAD", grad(w))
    w_final = c2.get_var("w")
    c2.shutdown_server()
    c2.close()

    np.testing.assert_allclose(w_final, w_ref, rtol=1e-5, atol=1e-6)
    dist_ops.reset_clients()
