"""The port's counterpart of tests/test_chaos.py: ``_chaos_scenario``
with ``SMOKE_SPEC`` against paddle_tpu_torch on the CPU, under
``_assert_chaos_run``'s checks; the soak stays behind ``-m slow``.

Chaos tier: the full resilience composition under one seeded fault
plan. A zoo-MLP trainer pulls batch tasks from the elastic master,
computes loss+grads with the real Executor, pushes tagged gradient
rounds to a pserver under a membership TTL lease, and runs inside
``resilience.resilient_loop`` (background trainer checkpoints, NaN
rollback guard). The armed plan then:

  * drops / delays / duplicates / tears RPC frames to the pserver
    (the retry policy reconnects; tagged rounds stay exactly-once),
  * KILLS the pserver mid-run (its lease expires, a supervisor boots a
    replacement recovered from the pserver checkpoint, the trainer's
    membership resolver follows it to the new port),
  * corrupts one trainer checkpoint on disk (the rollback CRC-scan
    must skip it),
  * injects one NaN batch (rollback-and-skip; the restored params are
    re-pushed to the pserver).

Pass criteria: the run completes, final loss
within 10% of a fault-free run from the same init/data, and EXACT
at-least-once task accounting on the master (every task done once,
none failed). ``test_chaos_smoke`` is the fast tier-1 gate; the
``slow``-marked soak repeats the scenario 3x proving the fixed fault
seed is deterministic.
"""

import itertools
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed.master import (TaskQueue, MasterServer,
                                                 MasterClient)
from paddle_tpu_torch.distributed.membership import (KVServer, KVClient,
                                                     register_pserver,
                                                     PS_PREFIX)
from paddle_tpu_torch.distributed.rpc import VariableServer, RPCClient
from paddle_tpu_torch.models.mlp import mlp
from paddle_tpu_torch.resilience import Policy, faults, resilient_loop

DIM = 64
N_CLASSES = 10
LR = 0.15


def _make_batches(n_tasks, batch=16, seed=0):
    """Deterministic learnable data: labels from a fixed projection."""
    rng = np.random.RandomState(seed)
    proj = rng.randn(DIM, N_CLASSES).astype(np.float32)
    out = []
    for _ in range(n_tasks):
        x = rng.rand(batch, DIM).astype(np.float32)
        y = np.argmax(x @ proj, axis=1).astype(np.int64)[:, None]
        out.append({"img": x, "label": y})
    return out


def _build_trainer_program():
    """Zoo MLP WITHOUT a local optimizer: grads are computed here,
    applied server-side (pserver SGD) — the distributed split."""
    img = fluid.layers.data("img", [DIM])
    label = fluid.layers.data("label", [1], dtype="int64")
    _, avg_cost, _ = mlp(img, label, hidden_sizes=(32,),
                         num_classes=N_CLASSES)
    param_grads = fluid.backward.append_backward(avg_cost)
    return avg_cost, param_grads


def _sgd_optimize(store, grads):
    for k, g in grads.items():
        p = k.replace("@GRAD", "")
        if p in store:
            store[p] = store[p] - LR * np.asarray(g)


class _PServerCell:
    """The pserver 'process': server + its membership lease + a
    checkpoint thread. The supervisor replaces the whole cell."""

    def __init__(self, kv, ckpt_path, recover=False):
        self.ckpt_path = ckpt_path
        self.server = VariableServer(fan_in=1, optimize_fn=_sgd_optimize,
                                     sync=True)
        self.recovered_round = (self.server.recover(ckpt_path)
                                if recover else None)
        self.server.start()
        self.endpoint = "127.0.0.1:%d" % self.server.port
        _, self.lease = register_pserver(kv, 1, self.endpoint, ttl=0.4)
        self._stop = threading.Event()
        self._ckpt_thread = threading.Thread(target=self._ckpt_loop,
                                             daemon=True)
        self._ckpt_thread.start()

    def _ckpt_loop(self):
        while not self._stop.wait(0.05):
            try:
                self.server.checkpoint(self.ckpt_path)
            except Exception:
                pass

    def crash(self):
        """The injected kill already broke the server; the lease thread
        'dies with the process'."""
        self._stop.set()
        self.lease._stop.set()

    def shutdown(self):
        self._stop.set()
        try:
            self.lease.revoke()
        except Exception:
            pass
        try:
            self.server.stop()
        except Exception:
            pass


def _run_training(batches, ckpt_dir, cell1, init_params=None,
                  kv_endpoint=None, master_ep=None, ps_ckpt=None,
                  plan=None, checkpoint_every=4):
    """One complete trainer run against live master/pserver/KV services.
    Returns (summary, init_params, final_params, replacement_info)."""
    pol = Policy(max_attempts=12, base_delay=0.05, max_delay=2.0,
                 deadline=25.0, seed=5)
    resolver_kv = KVClient(kv_endpoint)
    supervisor_kv = KVClient(kv_endpoint)
    state = {"killed": False, "cell1": cell1, "cell2": None}
    stop_sup = threading.Event()

    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.scope_guard(scope):
        avg_cost, param_grads = _build_trainer_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        params = [p.name for p, _ in param_grads]
        grad_names = [g.name for _, g in param_grads]
        if init_params is not None:
            for name, v in init_params.items():
                scope.set(name, v.copy())
        init_snapshot = {p: scope.get_numpy(p).copy()
                         for p in params}

        def ps_resolver():
            return resolver_kv.get(PS_PREFIX + "0")

        cli = RPCClient(ps_resolver(), retry=pol, resolver=ps_resolver)
        for p in params:
            cli.put_var(p, scope.get_numpy(p))
        mcli = MasterClient(master_ep, retry=pol)
        inc = "%016x" % time.time_ns() + "c0ffee00"
        seq = itertools.count()

        def supervise():
            """Watches for the injected pserver kill: stops the dead
            cell's lease ('the process died'), waits for the slot to
            expire, boots a replacement recovered from the pserver
            checkpoint, registered under the SAME slot."""
            while not stop_sup.wait(0.03):
                if plan is None:
                    return
                if not state["killed"]:
                    if ("kill", "pserver") in plan.trips:
                        state["killed"] = True
                        state["cell1"].crash()
                elif state["cell2"] is None:
                    if supervisor_kv.get(PS_PREFIX + "0") is None:
                        state["cell2"] = _PServerCell(
                            supervisor_kv, ps_ckpt, recover=True)
                        return

        def step_fn(step, feeds):
            outs = exe.run(main, feed=feeds,
                           fetch_list=[avg_cost.name] + grad_names)
            loss = float(np.asarray(outs[0]).reshape(-1)[0])
            if not np.isfinite(loss):
                return loss          # poisoned: push NOTHING, roll back
            tag = "t0:i%s:s%d" % (inc, next(seq))
            for name, gval in zip(grad_names, outs[1:]):
                cli.send_var(name, np.asarray(gval), tag=tag)
            cli.barrier(tag=tag)
            for p in params:
                scope.set(p, cli.get_var(p))
            return loss

        def on_rollback(step):
            # after a rollback the trainer scope is the source of
            # truth: re-push the restored params to the pserver
            for p in params:
                cli.put_var(p, scope.get_numpy(p))

        def batches_from_master():
            while True:
                tid, payload = mcli.get_task()
                if tid is None:
                    if payload == "done":
                        return
                    time.sleep(0.02)
                    continue
                yield batches[payload]
                mcli.task_done(tid)

        sup = threading.Thread(target=supervise, daemon=True)
        try:
            sup.start()
            summary = resilient_loop(
                step_fn, batches_from_master(), ckpt_dir, program=main,
                scope=scope, checkpoint_every=checkpoint_every,
                max_rollbacks=4, background=True,
                on_rollback=on_rollback)
            final_params = {p: scope.get_numpy(p).copy()
                            for p in params}
        finally:
            stop_sup.set()
            sup.join(timeout=5)
            cli.close()
            mcli.close()
            resolver_kv.close()
            supervisor_kv.close()
    return summary, init_snapshot, final_params, state


def _chaos_scenario(n_tasks, fault_spec, seed, tmp_path, tag):
    """Stand up KV + master + pserver, run baseline (no faults) then
    the chaos run (same init, same data), return both results."""
    batches = _make_batches(n_tasks, seed=seed)

    def run(run_tag, init_params, spec):
        kvs = KVServer(sweep_interval=0.05).start()
        kv = KVClient(kvs.endpoint)
        ps_ckpt = str(tmp_path / ("ps-%s.ckpt" % run_tag))
        cell = _PServerCell(kv, ps_ckpt)
        master = MasterServer(TaskQueue(
            payloads=list(range(n_tasks)), timeout_s=60,
            snapshot_path=str(tmp_path / ("q-%s.json" % run_tag)))).start()
        master_ep = "127.0.0.1:%d" % master.port
        plan = None
        if spec is not None:
            spec = dict(spec)
            rpc_spec = dict(spec.get("rpc") or {})
            rpc_spec["ports"] = [cell.server.port]
            spec["rpc"] = rpc_spec
            plan = faults.arm(spec, seed=seed)
        try:
            summary, init_snap, final, state = _run_training(
                batches, str(tmp_path / ("ck-%s" % run_tag)), cell,
                init_params=init_params, kv_endpoint=kvs.endpoint,
                master_ep=master_ep, ps_ckpt=ps_ckpt, plan=plan)
            with MasterClient(master_ep) as mc:
                counts = mc.counts()
        finally:
            faults.disarm()
            for c in (state.get("cell2"), cell):
                if c is not None:
                    c.shutdown()
            master.stop()
            try:
                kv.shutdown_server()
                kv.close()
            except OSError:
                pass
        return summary, init_snap, final, counts, plan, state

    base_summary, init_snap, _, base_counts, _, _ = run(
        "base-" + tag, None, None)
    chaos_summary, _, _, chaos_counts, plan, state = run(
        "chaos-" + tag, init_snap, fault_spec)
    return (base_summary, base_counts, chaos_summary, chaos_counts,
            plan, state)


SMOKE_SPEC = {
    "rpc": {"drop": 0.06, "duplicate": 0.05, "close_mid_frame": 0.03,
            "delay": 0.08, "delay_s": 0.003, "max": 10},
    "kill": [{"target": "pserver", "after": 14}],
    "ckpt": {"nth": 2, "mode": "bitflip"},
    "nan": {"step": 9, "name": "img"},
}


def _assert_chaos_run(base_summary, base_counts, chaos_summary,
                      chaos_counts, plan, state, n_tasks):
    # exact at-least-once task accounting on the master
    for counts in (base_counts, chaos_counts):
        assert counts == {"todo": 0, "pending": 0, "done": n_tasks,
                          "failed": 0}
    # every planned fault class actually fired
    kinds = {k for k, _ in plan.trips}
    assert "kill" in kinds, plan.trips
    assert "nan" in kinds, plan.trips
    assert "ckpt_corrupt" in kinds, plan.trips
    assert kinds & {"drop", "duplicate", "close_mid_frame", "delay"}, \
        plan.trips
    # the pserver was replaced via lease expiry and RECOVERED state
    assert state["killed"]
    assert state["cell2"] is not None, "replacement pserver never booted"
    assert state["cell2"].recovered_round is not None \
        and state["cell2"].recovered_round > 0
    # the NaN batch was rolled back and skipped, and the run completed
    assert chaos_summary["rollbacks"] == 1
    assert chaos_summary["steps"] == n_tasks - 1      # one batch skipped
    assert base_summary["steps"] == n_tasks
    assert all(np.isfinite(chaos_summary["losses"]))
    # final loss within 10% of the fault-free run (+ absolute slack for
    # near-zero plateaus)
    fb, ff = base_summary["final_loss"], chaos_summary["final_loss"]
    assert abs(ff - fb) <= 0.10 * abs(fb) + 0.05, (fb, ff)
    # training actually learned something in both runs
    assert fb < base_summary["losses"][0]
    assert ff < chaos_summary["losses"][0]


def test_chaos_smoke(tmp_path):
    """Tier-1 gate: the full kill/drop/corrupt/NaN composition on a
    small model with tight timeouts."""
    n_tasks = 26
    log = str(tmp_path / "chaos.jsonl")
    with monitor.session(log_path=log):
        results = _chaos_scenario(n_tasks, SMOKE_SPEC, seed=1301,
                                  tmp_path=tmp_path, tag="smoke")
    _assert_chaos_run(*results, n_tasks=n_tasks)
    # the flight recorder captured the whole story
    evs = {e["ev"] for e in monitor.read_jsonl(log)}
    assert {"fault", "retry", "reconnect", "rollback",
            "checkpoint"} <= evs, evs


@pytest.mark.slow
def test_chaos_soak_deterministic_three_runs(tmp_path):
    """The acceptance soak: the same seeded fault plan passes 3
    consecutive times (fresh services each time) on a longer run."""
    n_tasks = 60
    spec = dict(SMOKE_SPEC)
    spec["kill"] = [{"target": "pserver", "after": 30}]
    spec["nan"] = {"step": 20, "name": "img"}
    spec["ckpt"] = {"nth": 3, "mode": "truncate"}
    for attempt in range(3):
        results = _chaos_scenario(n_tasks, spec, seed=4242,
                                  tmp_path=tmp_path,
                                  tag="soak%d" % attempt)
        _assert_chaos_run(*results, n_tasks=n_tasks)
