"""The port's DistributeTranspiler and parameter-server training
against the JAX package.

  * The transpiled trainer program, each pserver program and each
    pserver startup program serialize to JSON identical to the JAX
    transpiler's: the fc toy of tests/test_distributed.py, a 2-layer
    narrow LM and DeepFM with both FM tables ``is_distributed``.
  * Pserver-mode training in the port (trainer and pservers on the CPU,
    servers as threads) matches the JAX package's local run from the
    same start values (the JAX package's startup, put into the port's
    scopes with ``load_numpy_state`` and sliced into the table shards):
    1 trainer with 1 pserver, 1 trainer with 2 pservers (Adam, multi
    step), the sharded table with SGD and with lazy Adam, and two
    trainers at fan-in 2 (their summed half-batch SGD gradients are the
    full batch's at twice the learning rate). Limits: the JAX tests'
    own (rtol 1e-4, atol 1e-5 at tests/test_distributed.py:168) and
    2e-4 of max(1, max|w|) for multi-step Adam.
  * Async mode reaches the local loss (tests/test_distributed.py:201).

Servers signal readiness through their port files
(tests/torch_wire_harness.py); every join is bounded.
"""

import json
import threading

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import deepfm as JD
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.distributed import ops as dist_ops
from paddle_tpu_torch.distributed import rpc as trpc
from paddle_tpu_torch.models import deepfm as TD
from paddle_tpu_torch.models import transformer as TT
from torch_wire_harness import (boot_pservers, probe_ports, shutdown,
                                table_from_shards)

EPS2 = "127.0.0.1:6170,127.0.0.1:6171"     # names only: nothing listens
LM = dict(vocab_size=64, max_len=16, n_layer=2, n_head=2, d_model=32,
          d_inner=64)
VOCAB, DIM = 10, 4


# -- the nets, built the same way in either package ------------------------

def fc_toy(fluid, opt="sgd", lr=0.1):
    x = fluid.layers.data("x", [4])
    y = fluid.layers.data("y", [1])
    pred = fluid.layers.fc(x, 1, bias_attr=False, param_attr=fluid.ParamAttr(
        name="w_dist", initializer=fluid.initializer.Constant(0.0)))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    _opt(fluid, opt, lr).minimize(loss)
    return loss


def lm(fluid, opt="adam", lr=1e-3):
    T = TT if fluid is tfluid else JT
    loss, _ = T.transformer_lm(**LM)
    _opt(fluid, opt, lr).minimize(loss)
    return loss


def table_net(fluid, opt="sgd", lr=0.1, dist=True):
    ids = fluid.layers.data("ids", [1], dtype="int64")
    y = fluid.layers.data("y", [1])
    emb = fluid.layers.embedding(
        ids, size=[VOCAB, DIM], is_sparse=True, is_distributed=dist,
        param_attr=fluid.ParamAttr(
            name="dist_emb", initializer=fluid.initializer.Constant(0.1)))
    pred = fluid.layers.fc(emb, 1, bias_attr=False, param_attr=fluid.ParamAttr(
        name="dist_fc_w", initializer=fluid.initializer.Constant(0.2)))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    _opt(fluid, opt, lr).minimize(loss)
    return loss


def deepfm_net(fluid, opt="adam", lr=0.01, dist=True):
    D = TD if fluid is tfluid else JD
    fields = [fluid.layers.data("field_%d" % i, [1], dtype="int64")
              for i in range(4)]
    label = fluid.layers.data("click", [1])
    _, logit = D.deepfm(fields, vocab_size=50, embed_dim=4, dnn_dims=(16,),
                        is_sparse=True, is_distributed=dist)
    loss = fluid.layers.mean(
        fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
    _opt(fluid, opt, lr).minimize(loss)
    return loss


def _opt(fluid, name, lr):
    return (fluid.optimizer.SGD(learning_rate=lr) if name == "sgd"
            else fluid.optimizer.Adam(learning_rate=lr))


def _programs(fluid, net, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = net(fluid, **kw)
    return main, startup, loss


def _json(prog):
    # a listen_and_serv op holds its optimize blocks as a list of
    # Blocks, which Program.to_json does not spell out (in either)
    return json.dumps(prog.to_dict(), sort_keys=True,
                      default=lambda b: {"__block__": b.idx})


# -- transpiled programs ---------------------------------------------------

@pytest.mark.parametrize("net, trainers, sync", [
    (fc_toy, 1, True), (fc_toy, 2, False), (lm, 1, True),
    (deepfm_net, 2, True), (table_net, 1, True)],
    ids=["fc_toy", "fc_toy_async", "lm", "deepfm_dist", "table"])
def test_transpiled_programs_match_the_jax_package(net, trainers, sync):
    out = []
    for fluid in (tfluid, jfluid):
        main, startup, _ = _programs(fluid, net)
        t = fluid.DistributeTranspiler(mode="pserver")
        t.transpile(trainer_id=trainers - 1, program=main, pservers=EPS2,
                    trainers=trainers, sync_mode=sync,
                    startup_program=startup)
        progs = [main.to_json(), startup.to_json()]
        for ep in EPS2.split(","):
            pprog = t.get_pserver_program(ep)
            progs += [_json(pprog), _json(t.get_startup_program(ep, pprog))]
        out.append(progs)
    assert len(out[0]) == 6
    for got, want in zip(*out):
        assert got == want
    ops = json.loads(out[0][0])["blocks"][0]["ops"]
    types = [o["type"] for o in ops]
    assert "send" in types and "recv" in types
    if net in (deepfm_net, table_net):
        assert "prefetch" in types and "send_sparse" in types
        assert "lookup_table" not in types


# -- training --------------------------------------------------------------

def _jax_local(net, batches, lr_scale=1.0, **kw):
    """The JAX package's local run: (start values, losses, params)."""
    main, startup, loss = _programs(jfluid, net, **kw)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    state = {n: np.asarray(scope.find_var(n)).copy()
             for n in scope.local_var_names()
             if scope.find_var(n) is not None}
    if lr_scale != 1.0:
        for n in state:
            if n.startswith("learning_rate"):
                scope.set(n, state[n] * lr_scale)
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0])) for f in batches]
    params = {p.name: np.asarray(scope.find_var(p.name)).copy()
              for p in main.global_block().all_parameters()}
    return state, losses, params


def _port_pserver(net, streams, n_ps, tmp_path, state, sync=True, **kw):
    """Port pserver-mode training on the CPU: ``n_ps`` pserver threads,
    one trainer a stream of batches (threads when there are several).
    Returns (each trainer's losses, trainer 0's scope, server scopes)."""
    eps = probe_ports(n_ps)
    n_tr = len(streams)
    trainers = []
    for tid in range(n_tr):
        main, startup, loss = _programs(tfluid, net, **kw)
        t = tfluid.DistributeTranspiler(mode="pserver")
        t.transpile(trainer_id=tid, program=main, pservers=",".join(eps),
                    trainers=n_tr, sync_mode=sync, startup_program=startup)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        tfluid.load_numpy_state(scope, {n: v for n, v in state.items()
                                        if scope.find_var(n) is not None},
                                "cpu")
        trainers.append((main, scope, exe, loss))
    servers, errors = boot_pservers(tfluid, t, eps, tmp_path, init=state)
    losses = [[] for _ in range(n_tr)]
    fails = []

    def train(tid):
        main, scope, exe, loss = trainers[tid]
        try:
            for f in streams[tid]:
                losses[tid].append(float(exe.run(
                    main, feed=f, fetch_list=[loss], scope=scope)[0]))
        except BaseException as e:                 # surfaced below
            fails.append((tid, repr(e)))

    try:
        if n_tr == 1:
            train(0)
        else:
            ths = [threading.Thread(target=train, args=(i,), daemon=True)
                   for i in range(n_tr)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in ths), "trainer hung"
    finally:
        shutdown(eps, trpc, dist_ops, servers)
    assert not fails and not errors, (fails, errors)
    return losses, trainers[0][1], [s for s, _ in servers]


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _close_multistep(got, want):
    """2e-4 of max(1, max|w|): the multi-step bound."""
    np.testing.assert_allclose(
        got, want, rtol=0, atol=2e-4 * max(1.0, float(np.abs(want).max())))


def _toy_batches(steps=5):
    rng = np.random.RandomState(0)
    xv = rng.rand(16, 4).astype(np.float32)
    yv = (xv @ np.array([1., 2., 3., 4.], np.float32))[:, None]
    return [{"x": xv, "y": yv}] * steps


def test_one_trainer_one_pserver_matches_jax(tmp_path):
    batches = _toy_batches()
    state, jl, jp = _jax_local(fc_toy, batches)
    tl, scope, _ = _port_pserver(fc_toy, [batches], 1, tmp_path, state)
    _close(tl[0], jl)
    _close(scope.get_numpy("w_dist"), jp["w_dist"])


def test_lm_one_trainer_two_pservers_adam_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    batches = [JT.make_lm_batch(rng, 4, LM["max_len"], LM["vocab_size"])
               for _ in range(3)]
    state, jl, jp = _jax_local(lm, batches)
    tl, scope, sscopes = _port_pserver(lm, [batches], 2, tmp_path, state)
    np.testing.assert_allclose(tl[0], jl, rtol=2e-4)
    for name, want in jp.items():
        _close_multistep(scope.get_numpy(name), want)
    # each parameter lives on one server (round-robin placement)
    held = [set(s.local_var_names()) & set(jp) for s in sscopes]
    assert held[0] and held[1] and not held[0] & held[1]


def _table_batches(steps=5):
    # every vocab id in every batch: dense Adam == lazy Adam exactly
    rng = np.random.RandomState(7)
    out = []
    for _ in range(steps):
        ids = np.concatenate([np.arange(VOCAB, dtype=np.int64),
                              rng.randint(0, VOCAB, size=(6,))])[:, None]
        out.append({"ids": ids.astype(np.int64),
                    "y": ids.astype(np.float32) * 0.05 + 0.3})
    return out


@pytest.mark.parametrize("opt, lr", [("sgd", 0.1), ("adam", 0.05)],
                         ids=["sgd", "lazy_adam"])
def test_sharded_table_matches_jax(tmp_path, opt, lr):
    batches = _table_batches()
    state, jl, jp = _jax_local(table_net, batches, opt=opt, lr=lr,
                               dist=False)
    tl, scope, sscopes = _port_pserver(table_net, [batches], 2, tmp_path,
                                       state, opt=opt, lr=lr)
    # the trainer never holds the [V, D] table
    assert scope.find_var("dist_emb") is None
    table = table_from_shards(sscopes, "dist_emb", VOCAB,
                              lambda s, n: s.get_numpy(n))
    _close(tl[0], jl, atol=1e-6)
    _close(table, jp["dist_emb"])
    _close(scope.get_numpy("dist_fc_w"), jp["dist_fc_w"])


def test_two_trainers_match_jax_double_batch(tmp_path):
    """Two trainers (each half of every batch) against two pservers at
    fan-in 2: the merged round's summed half-batch mean gradients are
    twice the full batch's, so SGD matches the JAX package's one trainer
    on the full batch at twice the learning rate."""
    batches = _table_batches(3)
    halves = [[{k: v[:len(v) // 2] for k, v in b.items()} for b in batches],
              [{k: v[len(v) // 2:] for k, v in b.items()} for b in batches]]
    state, _, jp = _jax_local(table_net, batches, lr_scale=2.0, dist=False)
    _, scope, sscopes = _port_pserver(table_net, halves, 2, tmp_path, state)
    table = table_from_shards(sscopes, "dist_emb", VOCAB,
                              lambda s, n: s.get_numpy(n))
    _close(table, jp["dist_emb"])
    _close(scope.get_numpy("dist_fc_w"), jp["dist_fc_w"])


def test_deepfm_distributed_tables_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    feed = {"field_%d" % i: rng.randint(0, 50, (16, 1)).astype(np.int64)
            for i in range(4)}
    feed["click"] = (feed["field_0"] % 2).astype(np.float32)
    batches = [feed] * 4
    state, jl, jp = _jax_local(deepfm_net, batches, dist=False)
    tl, scope, sscopes = _port_pserver(deepfm_net, [batches], 2, tmp_path,
                                       state)
    assert tl[0][-1] < tl[0][0]
    # lazy (row-sparse) Adam on the tables vs the JAX package's dense
    # Adam: rows no batch touches differ, so hold the loss and the
    # dense parameters
    np.testing.assert_allclose(tl[0], jl, rtol=2e-4)
    for name, want in jp.items():
        if scope.find_var(name) is not None:
            _close_multistep(scope.get_numpy(name), want)


def test_async_mode_reaches_local_loss(tmp_path):
    batches = _toy_batches()
    state, jl, jp = _jax_local(fc_toy, batches)
    tl, scope, _ = _port_pserver(fc_toy, [batches], 1, tmp_path, state,
                                 sync=False)
    # one trainer: apply-on-arrival is the sync update sequence
    _close(scope.get_numpy("w_dist"), jp["w_dist"])
    assert tl[0][-1] < tl[0][0]


def test_send_barriers_endpoints_in_transpiled_order(monkeypatch):
    """Every trainer barriers the pservers in the transpiled order: two
    trainer processes iterating a set (whose order follows each
    process's string hash seed) could each wait at a server the other
    has not reached, and the round would never close."""
    eps = ["127.0.0.1:%d" % p for p in (7005, 7001, 7004, 7002, 7006,
                                         7003)]
    seen = []

    class Fake:
        def __init__(self, ep):
            self.ep = ep

        def send_var(self, *a, **k):
            pass

        def barrier(self, tag=None):
            seen.append(self.ep)

    monkeypatch.setattr(dist_ops, "_client", Fake)
    prog = tfluid.Program()
    blk = prog.global_block()
    blk.create_var(name="g", shape=[2], dtype="float32")
    blk.append_op(type="send", inputs={"X": ["g"]}, outputs={},
                  attrs={"epmap": eps[:1], "endpoints": eps,
                         "sync": True, "trainer_id": 0})
    tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed={"g": np.ones(2, np.float32)}, scope=tfluid.Scope())
    assert seen == eps
