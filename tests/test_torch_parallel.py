"""The port's parallel tier against the JAX package, in one process (one
rank; ``tests/test_torch_parallel_ranks.py`` runs the meshes over gloo
ranks).

* Ring and Ulysses attention on a one-rank mesh against the JAX
  package's dense attention, outputs and gradients, causal and not
  (rtol 1e-5 / atol 1e-6).
* MoE gating (top-1, top-2, capacity drops, overflow, aux loss) and the
  dense ``moe_ffn`` against ``paddle_tpu.parallel.moe`` on the same
  logits: dispatch (the routing) identical, values at rtol 1e-5; ties
  break at the first index, as ``argmax`` / ``lax.top_k`` break them.
* ``gpipe`` (stacked and heterogeneous, with aux) and
  ``gpipe_interleaved`` on a one-rank mesh against a plain loop over the
  stages, outputs and gradients.
* ``pipeline_stack``'s dense and MoE fallbacks, ``recompute`` included,
  against the JAX lowering: one SGD step's loss and every updated
  parameter (rtol 2e-5).
* The collective ops as identities without a mesh.
* ``transformer_lm_parallel``'s Program JSON identical to the JAX
  package's for every strategy the dryrun builds, both schedules.
* ``ParallelExecutor`` on a one-rank mesh bitwise equal to ``Executor``
  (run and run_steps), gradient accumulation against the JAX package's
  on a one-device mesh (2e-4), and the JAX package's error texts.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import parallel as jpar
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import parallel as tpar
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.parallel import moe as tmoe
from paddle_tpu_torch.parallel import pipeline as tpipe

import jax
import jax.numpy as jnp


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(**axes):
    return tpar.make_mesh(axes or None, devices="cpu")


def _t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


# -- ring / Ulysses ----------------------------------------------------------
@pytest.mark.parametrize("variant", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sp_attention_one_rank_matches_dense(variant, causal):
    from paddle_tpu.ops.flash_attention import flash_attention as jflash
    rng = np.random.RandomState(7)
    q, k, v, w = (rng.randn(2, 4, 16, 8).astype(np.float32)
                  for _ in range(4))
    mesh = _mesh(sp=1)
    fn = tpar.ring_attention if variant == "ring" else \
        tpar.ulysses_attention
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = fn(tq, tk, tv, mesh, causal=causal)
    (out * _t(w)).sum().backward()

    def f(q, k, v):
        out = jflash(q, k, v, causal=causal)
        return jnp.sum(out * w), out
    (_, ref), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    for g, r in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


# -- MoE ---------------------------------------------------------------------
def _logits(seed, t=24, e=4, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, e).astype(np.float32)
    if ties:
        # equal top logits: the first index must win, as in JAX
        x[::3, 1] = x[::3, 2] = x[::3].max(-1) + 1.0
        x[1::3, 0] = x[1::3, 3] = x[1::3].max(-1) + 1.0
    return x


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("capacity", [2, 6, 12])
def test_top1_gating_matches_jax(capacity, ties):
    from paddle_tpu.parallel import moe as jmoe
    x = _logits(1, ties=ties)
    jd, jc, ja = jmoe.top1_gating(jnp.asarray(x), capacity)
    td, tc, ta = tmoe.top1_gating(_t(x), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("capacity", [3, 8, 14])
def test_topk_gating_matches_jax(capacity, ties):
    from paddle_tpu.parallel import moe as jmoe
    x = _logits(2, ties=ties)
    jd, jc, ja, jo = jmoe.topk_gating(jnp.asarray(x), capacity, k=2)
    td, tc, ta, to = tmoe.topk_gating(_t(x), capacity, k=2)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    np.testing.assert_allclose(float(to), float(jo), rtol=1e-5)
    if capacity == 3:
        assert float(to) > 0        # capacity really drops assignments


def test_top_k_ties_break_at_the_first_index():
    x = _logits(3, ties=True)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 2)
    tv, ti = tmoe._top_k(_t(x), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (torch.argmax(_t(x), -1).numpy()
            == np.asarray(jnp.argmax(x, -1))).all()


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax(top_k):
    from paddle_tpu.parallel import moe as jmoe
    rng = np.random.RandomState(4)
    x = rng.randn(32, 8).astype(np.float32)
    gate = (rng.randn(8, 4) * 0.5).astype(np.float32)
    up = (rng.randn(4, 8, 16) * 0.3).astype(np.float32)
    down = (rng.randn(4, 16, 8) * 0.3).astype(np.float32)
    jo, ja, js = jmoe.moe_ffn(x, gate, up, down, top_k=top_k,
                              return_stats=True)
    to, ta, ts = tmoe.moe_ffn(_t(x), _t(gate), _t(up), _t(down),
                              top_k=top_k, return_stats=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    np.testing.assert_allclose(float(ts["overflow"]),
                               float(js["overflow"]), rtol=1e-5)


def test_moe_noise_draws_are_counter_keyed():
    x = _t(_logits(5))
    seed = torch.tensor(11, dtype=torch.int64)
    a = tmoe.top1_gating(x, 6, rng=(seed, 3), noise_std=1.0)[1]
    b = tmoe.top1_gating(x, 6, rng=(seed, 3), noise_std=1.0)[1]
    c = tmoe.top1_gating(x, 6, rng=(seed, 4), noise_std=1.0)[1]
    plain = tmoe.top1_gating(x, 6)[1]
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, plain)


# -- pipelines ---------------------------------------------------------------
def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _stage_aux(p, x):
    y = _stage(p, x)
    return y, (y * y).mean()


def _stack(seed, s, v=None, d=6):
    rng = np.random.RandomState(seed)
    lead = (s,) if v is None else (s, v)
    return {"w": _t((rng.randn(*lead, d, d) * 0.5).astype(np.float32),
                    True),
            "b": _t((rng.randn(*lead, d) * 0.1).astype(np.float32), True)}


def _grads(out, params, xs):
    loss = out.sum() if not isinstance(out, tuple) else \
        out[0].sum() + 3.0 * out[1]
    return torch.autograd.grad(loss, [params["w"], params["b"], xs])


def test_gpipe_one_rank_matches_a_loop():
    mesh = _mesh(pp=1)
    params = _stack(1, 1)
    xs = _t(np.random.RandomState(2).randn(4, 3, 6).astype(np.float32),
            True)
    out = tpar.gpipe(_stage, params, xs, mesh)
    ref = torch.stack([_stage({k: v[0] for k, v in params.items()}, xs[i])
                       for i in range(4)])
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-7)
    for g, r in zip(_grads(out, params, xs), _grads(ref, params, xs)):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)


def test_gpipe_with_aux_matches_a_loop():
    mesh = _mesh(pp=1)
    params = _stack(3, 1)
    xs = _t(np.random.RandomState(4).randn(2, 5, 6).astype(np.float32),
            True)
    out, aux = tpar.gpipe(_stage_aux, params, xs, mesh, with_aux=True)
    p0 = {k: v[0] for k, v in params.items()}
    res = [_stage_aux(p0, xs[i]) for i in range(2)]
    ref = torch.stack([r[0] for r in res])
    ref_aux = sum(r[1] for r in res) / 2
    torch.testing.assert_close(out, ref)
    torch.testing.assert_close(aux, ref_aux)
    for g, r in zip(_grads((out, aux), params, xs),
                    _grads((ref, ref_aux), params, xs)):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)


def test_gpipe_heterogeneous_one_rank_matches_a_loop():
    mesh = _mesh(pp=1)
    p = {k: v[0] for k, v in _stack(5, 1).items()}
    xs = _t(np.random.RandomState(6).randn(3, 2, 6).astype(np.float32))
    out = tpar.gpipe(_stage, [p], xs, mesh)
    ref = torch.stack([_stage(p, xs[i]) for i in range(3)])
    torch.testing.assert_close(out, ref)
    with pytest.raises(ValueError, match="per-stage params list"):
        tpar.gpipe(_stage, [p, p], xs, mesh)


def test_gpipe_interleaved_one_rank_matches_a_loop():
    mesh = _mesh(pp=1)
    params = _stack(7, 1, v=3)
    xs = _t(np.random.RandomState(8).randn(1, 4, 6).astype(np.float32),
            True)
    out = tpar.gpipe_interleaved(_stage, params, xs, mesh, n_chunks=3)
    h = xs[0]
    for c in range(3):
        h = _stage({k: v[0, c] for k, v in params.items()}, h)
    ref = h[None]
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-7)
    for g, r in zip(_grads(out, params, xs), _grads(ref, params, xs)):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="interleaved schedule needs"):
        tpar.gpipe_interleaved(_stage, params, xs.repeat(2, 1, 1), mesh, 3)


def test_pipeline_schedules_match_the_jax_tick_tables():
    """Each stage's live ticks, microbatches and hops are the JAX loops'
    (gpipe: stage s runs microbatch t - s; interleaved: the hop h = t -
    ((t - s) mod S) of microbatch t - h, chunk h // S)."""
    for s_n, m in ((2, 4), (4, 8), (3, 3)):
        for s in range(s_n):
            sched = tpipe._Schedule(s, s_n, m)
            live = [(t, sched.at(t)["mb"]) for t in range(sched.ticks)
                    if sched.at(t)["live"]]
            assert live == [(t, t - s) for t in range(s, s + m)]
    for s_n, m, v in ((2, 2, 2), (4, 3, 2)):
        for s in range(s_n):
            sched = tpipe._Schedule(s, s_n, m, v)
            assert sched.ticks == m - 1 + v * s_n
            for t in range(sched.ticks):
                a = sched.at(t)
                h = t - ((t - s) % s_n)
                assert a["live"] == (0 <= h < v * s_n and t - h < m)
                if a["live"]:
                    assert (a["mb"], a["chunk"]) == (t - h, h // s_n)


# -- pipeline_stack fallbacks against the JAX lowering ------------------------
def _stack_program(pkg, moe, recompute, schedule):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8, 16])
        kw = dict(num_experts=4, moe_gate_groups=2,
                  num_microbatches=2) if moe else {}
        out = pkg.layers.pipelined_decoder_stack(
            x, n_layer=2, n_head=2, d_inner=32, recompute=recompute,
            schedule=schedule, **kw)
        aux = None
        if moe:
            out, aux = out
        loss = pkg.layers.mean(pkg.layers.square(out))
        if aux is not None:
            loss = pkg.layers.elementwise_add(loss,
                                              pkg.layers.scale(aux, 0.1))
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("moe,recompute,schedule", [
    (False, False, "gpipe"), (False, True, "gpipe"),
    (False, False, "interleaved"), (True, False, "gpipe"),
    (True, True, "gpipe")])
def test_pipeline_stack_fallback_matches_jax(moe, recompute, schedule,
                                             one_thread):
    jmain, jstart, jloss = _stack_program(jfluid, moe, recompute, schedule)
    tmain, _, tloss = _stack_program(tfluid, moe, recompute, schedule)
    assert tmain.to_json() == jmain.to_json()
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    names = [p.name for p in jmain.global_block().all_parameters()]
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None}
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    feed = {"x": np.random.RandomState(9).randn(4, 8, 16)
            .astype(np.float32)}
    with jfluid.scope_guard(jscope):
        want, = jexe.run(jmain, feed=feed, fetch_list=[jloss])
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tloss], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5)
    for n in names:
        np.testing.assert_allclose(tscope.get_numpy(n),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=2e-5, atol=2e-6, err_msg=n)
    assert not np.array_equal(tscope.get_numpy(names[0]), state[names[0]])


# -- the collective ops ------------------------------------------------------
@pytest.mark.parametrize("op_type", [
    "c_allreduce_sum", "c_allreduce_max", "c_allgather",
    "c_reducescatter", "c_broadcast", "all_to_all", "c_sync_comm_stream"])
def test_collective_ops_are_identities_without_a_mesh(op_type):
    from torch_op_harness import check, rand
    check(op_type, {"X": rand(1, 4, 6)}, {}, ["Out"])


@pytest.mark.parametrize("op_type", ["moe_ffn", "pipeline_stack"])
def test_sweep_cases_match_jax(op_type):
    """``tools/op_sweep.parallel_cases`` (chip_smoke phase 19 (a) runs
    them on the card against the CPU) through both packages' Executors:
    outputs and gradients at the harness's tolerances."""
    from torch_op_harness import check
    from paddle_tpu_torch.tools import op_sweep
    for case in op_sweep.parallel_cases():
        if case[0] == op_type:
            check(*case)


# -- Program JSON -------------------------------------------------------------
DRYRUN = [({"dp": 2, "tp": 2}, 0), ({"dp": 2, "sp": 2}, 0),
          ({"dp": 2, "pp": 2}, 0), ({"dp": 2, "ep": 2}, 4),
          ({"dp": 2, "tp": 2, "sp": 2}, 0), ({"dp": 2, "pp": 2, "tp": 2}, 0),
          ({"dp": 2, "pp": 2, "ep": 2}, 4),
          ({"dp": 2, "pp": 2, "tp": 2, "sp": 2}, 0)]


def _lm_program(pkg, T, par, axes, experts, schedule="gpipe"):
    st = par.DistributedStrategy(
        dp=axes.get("dp", 1), tp=axes.get("tp", 1), sp=axes.get("sp", 1),
        pp=axes.get("pp", 1), ep=axes.get("ep", 1), pp_schedule=schedule)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        avg_cost, _ = T.transformer_lm_parallel(
            vocab_size=64, max_len=16, n_layer=2, n_head=4, d_model=32,
            d_inner=64, strategy=st, num_experts=experts)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return main, startup, avg_cost


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
@pytest.mark.parametrize("axes,experts", DRYRUN,
                         ids=["-".join(a) for a, _ in DRYRUN])
def test_lm_parallel_program_json_is_the_jax_one(axes, experts, schedule):
    jm, js, _ = _lm_program(jfluid, JT, jpar, axes, experts, schedule)
    tm, ts, _ = _lm_program(tfluid, TT, tpar, axes, experts, schedule)
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()
    assert tm._sharding_hints == jm._sharding_hints


# -- ParallelExecutor at one rank ------------------------------------------------
def _init_state(main, startup):
    scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def _batch(i, b=4):
    return TT.make_lm_batch(np.random.RandomState(40 + i), b, 16, 64)


def test_parallel_executor_one_rank_is_executor_bitwise(one_thread):
    axes = {"dp": 2, "pp": 2}
    jm, js, _ = _lm_program(jfluid, JT, jpar, axes, 0)
    tm, _, loss = _lm_program(tfluid, TT, tpar, axes, 0)
    state = _init_state(jm, js)
    s1, s2, s3 = tfluid.Scope(), tfluid.Scope(), tfluid.Scope()
    for s in (s1, s2, s3):
        tfluid.load_numpy_state(s, state, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    mesh = _mesh(dp=1)
    pexe = tfluid.ParallelExecutor(loss_name=loss.name, main_program=tm,
                                   mesh=mesh, scope=s2)
    for i in range(3):
        a, = exe.run(tm, feed=_batch(i), fetch_list=[loss], scope=s1)
        b, = pexe.run([loss], feed=_batch(i))
        assert np.array_equal(a, b)
    pexe3 = tfluid.ParallelExecutor(loss_name=loss.name, main_program=tm,
                                    mesh=mesh, scope=s3)
    got = pexe3.run_steps([loss], feeds=[_batch(i) for i in range(3)])
    for i, step in enumerate(got):
        assert step[0].shape == ()
    for n in state:
        assert np.array_equal(s1.get_numpy(n), s2.get_numpy(n)), n
        assert np.array_equal(s1.get_numpy(n), s3.get_numpy(n)), n


def test_gradient_accumulation_matches_jax(one_thread):
    axes = {"dp": 1}
    jst = jpar.DistributedStrategy(dp=1, gradient_accumulation_steps=2)
    tst = tpar.DistributedStrategy(dp=1, gradient_accumulation_steps=2)
    jm, js, jl = _lm_program(jfluid, JT, jpar, axes, 0)
    tm, _, tl = _lm_program(tfluid, TT, tpar, axes, 0)
    state = _init_state(jm, js)
    jscope = jfluid.Scope()
    for n, v in state.items():
        jscope.set(n, np.array(v))
    jexe = jfluid.ParallelExecutor(loss_name=jl.name, main_program=jm,
                                   mesh=jpar.make_mesh(
                                       {"dp": 1}, jax.devices()[:1]),
                                   scope=jscope, strategy=jst)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    texe = tfluid.ParallelExecutor(loss_name=tl.name, main_program=tm,
                                   mesh=_mesh(dp=1), scope=tscope,
                                   strategy=tst)
    for i in range(2):
        want, = jexe.run([jl], feed=_batch(i))
        got, = texe.run([tl], feed=_batch(i))
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4)
    for n in state:
        jw = np.asarray(jscope.find_var(n))
        assert np.abs(tscope.get_numpy(n) - jw).max() \
            <= 2e-4 * max(1.0, float(np.abs(jw).max())), n
    with pytest.raises(ValueError, match="does not compose with gradient"):
        texe.run_steps([tl], feeds=[_batch(0)])


def test_parallel_executor_errors_are_the_jax_ones():
    tm, _, tl = _lm_program(tfluid, TT, tpar, {"dp": 1}, 0)
    mesh = _mesh(dp=1)
    with pytest.raises(ValueError, match="mesh needs 2 devices but only 1"):
        tpar.make_mesh({"dp": 2}, devices="cpu")
    # mixed precision is ported: as in the JAX package, no error
    tfluid.ParallelExecutor(main_program=tm, mesh=mesh,
                            strategy=tpar.DistributedStrategy(
                                use_bf16_compute=True))
    with pytest.raises(ValueError, match="num_trainers=2"):
        tfluid.ParallelExecutor(main_program=tm, mesh=mesh, num_trainers=2)
    with pytest.raises(TypeError, match="unsupported ParallelExecutor"):
        tfluid.ParallelExecutor(main_program=tm, mesh=mesh, bogus=1)
    with pytest.raises(ValueError, match="gradient_accumulation_loss_norm"):
        tfluid.ParallelExecutor(
            main_program=tm, mesh=mesh, strategy=tpar.DistributedStrategy(
                gradient_accumulation_loss_norm="bytes"))
    st = tpar.DistributedStrategy(dp=None, tp=2, pp=2)
    assert st.effective_dp(devices=8) == 2
    assert jpar.DistributedStrategy(dp=None, tp=2, pp=2).effective_dp(
        devices=list(range(8))) == 2


def _fake_mesh(**axes):
    """A mesh's names and sizes without a process group (the rejections
    below raise before any collective)."""
    mesh = tpar.Mesh.__new__(tpar.Mesh)
    mesh.axis_names = tuple(axes)
    mesh.shape = dict(axes)
    mesh.size = int(np.prod(list(axes.values())))
    return mesh


@pytest.mark.parametrize("axes,gate_groups,err,match", [
    ({"dp": 1, "pp": 2, "sp": 2}, 1, NotImplementedError,
     "does not compose with sequence"),
    ({"dp": 2, "pp": 2, "ep": 2}, 1, ValueError,
     r"does not match the mesh's dp\*ep=2\*2")])
def test_pipeline_stack_rejections_are_the_jax_ones(axes, gate_groups, err,
                                                    match):
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu.core import registry as jreg
    progs = []
    for pkg in (jfluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", [8, 16])
            pkg.layers.pipelined_decoder_stack(
                x, n_layer=2, n_head=2, d_inner=32, num_experts=4,
                moe_gate_groups=gate_groups, num_microbatches=2)
        progs.append(main)
    jop, top = (p.global_block().ops[-1] for p in progs)
    env = {n: torch.zeros(tuple(max(1, int(d)) for d in
                                progs[1].global_block().var(n).shape))
           for n in top.input_names}
    ctx = treg.LowerContext(env, torch.device("cpu"),
                            mesh=_fake_mesh(**axes))
    with pytest.raises(err, match=match) as got:
        treg.lookup("pipeline_stack").lower(ctx, top)

    class _JaxMesh:
        axis_names = tuple(axes)
        shape = dict(axes)
    jenv = {n: jnp.zeros(v.shape) for n, v in env.items()}
    jctx = jreg.LowerContext(jenv, None, mesh=_JaxMesh())
    with pytest.raises(err) as want:
        jreg.lookup("pipeline_stack").lower(jctx, jop)
    assert str(got.value) == str(want.value)


def _token_norm_program(pkg):
    """tests/test_grad_accumulation.py's token-normalized LoD model (a
    sum over tokens over a sum of lengths) and its feeds: 8 sequences
    whose two halves hold 8 and 16 tokens."""
    rng = np.random.RandomState(5)
    lengths = [1, 2, 3, 2, 5, 3, 7, 1]   # k=2 -> totals [8, 16]
    xv = rng.rand(sum(lengths), 4).astype(np.float32)
    wv = np.asarray(lengths, np.float32).reshape(-1, 1)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4], lod_level=1)
        w = pkg.layers.data("w", [1])
        h = pkg.layers.fc(x, 8, act="tanh")
        tok_sum = pkg.layers.reduce_sum(pkg.layers.sequence_pool(h, "sum"))
        loss = pkg.layers.elementwise_div(tok_sum, pkg.layers.reduce_sum(w))
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    state = _init_state(main, startup) if pkg is jfluid else None
    return main, loss, xv, wv, lengths, state


def _run_token_norm(pkg, par, prog, accum_steps, loss_norm, state, steps=3):
    """3 SGD steps through ``ParallelExecutor`` on one rank: (losses,
    parameters)."""
    main, loss, xv, wv, lengths, _ = prog
    st = par.DistributedStrategy(dp=1, gradient_accumulation_steps=accum_steps,
                                 gradient_accumulation_loss_norm=loss_norm)
    lod = pkg.create_lod_tensor(xv, [lengths], pkg.CPUPlace())
    if pkg is jfluid:
        scope = jfluid.Scope()
        for n, v in state.items():
            scope.set(n, np.array(v))
        exe = jfluid.ParallelExecutor(
            loss_name=loss.name, main_program=main, scope=scope, strategy=st,
            mesh=jpar.make_mesh({"dp": 1}, jax.devices()[:1]))
    else:
        scope = tfluid.Scope()
        tfluid.load_numpy_state(scope, state, "cpu")
        exe = tfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                      scope=scope, strategy=st,
                                      mesh=_mesh(dp=1))
    losses = [float(np.asarray(exe.run([loss], feed={"x": lod, "w": wv})[0]))
              for _ in range(steps)]
    return losses, {n: np.asarray(scope.find_var(n)) if pkg is jfluid
                    else scope.get_numpy(n) for n in state}


def test_ragged_token_accumulation_matches_full_batch_and_jax(one_thread):
    """Two microbatches of 8 and 16 tokens weighted by their token totals
    (loss_norm='token'): the port equals its own full batch (2e-5) and
    the JAX package's accumulation (2e-4); without a loss_norm the JAX
    package's refusal."""
    jprog = _token_norm_program(jfluid)
    tprog = _token_norm_program(tfluid)
    state = jprog[-1]
    full, wfull = _run_token_norm(tfluid, tpar, tprog, 1, None, state)
    got, wgot = _run_token_norm(tfluid, tpar, tprog, 2, "token", state)
    want, wwant = _run_token_norm(jfluid, jpar, jprog, 2, "token", state)
    np.testing.assert_allclose(got, full, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    for n in state:
        np.testing.assert_allclose(wgot[n], wfull[n], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(wgot[n], wwant[n], rtol=2e-4, atol=1e-5)
    with pytest.raises(ValueError, match="unequal"):
        _run_token_norm(tfluid, tpar, tprog, 2, None, state)
