"""The port's parallel tier over gloo ranks on the CPU, against the JAX
package (``__graft_entry__.dryrun_multichip``'s contract).

Each world size is one spawn (``tests/torch_rank_harness.py``): N
processes of ``tests/torch_parallel_worker.py``, one thread each, over a
``FileStore`` in the test's temporary directory, every rendezvous and
join bounded. The ranks import only the port; the JAX package's runs
are made here, on the 8 virtual CPU devices of ``tests/conftest.py``.

* The dryrun combos at its sizes (vocab 64, max_len 16, 2 layers, 4
  heads, d_model 32, d_inner 64, batch 4 * dp, 3 SGD steps at lr 0.1,
  its seeds): dp x tp, dp x sp, dp x pp, dp x ep at 4 ranks, dp x tp x
  sp, dp x pp x tp, dp x pp x ep at 8. Per-step losses within the
  dryrun's limit (2e-4, or 2e-3 with sp or ep) of both the JAX package's
  single-device run and its mesh run, relative to max(1, |loss|), and
  the final weights within 50 times that of max(1, max|w|); so does
  dp x pp on the interleaved schedule (4 layers, two chunks a rank). The
  16-rank dp x pp x tp x sp combo is marked slow; it is held against the
  single-device run (this process has 8 devices).
* Ring and Ulysses attention, forward and backward, at sp = 4 and at
  sp = 2 beside dp = 2, causal and not, against the JAX functions on the
  same seeded inputs (rtol 1e-5 / atol 1e-6).
* At 2 ranks: ``run_steps(K=3)`` over pp = 2 and over sp = 2 bitwise
  equal to 3 ``run`` calls, with no megastep, and within the dryrun's
  limit of the JAX package's single-device run; gradient accumulation
  (2 microbatches, dp = 2) against
  the JAX package's on a 2-device mesh (2e-4); ``DeviceLoader(
  sharding=mesh)`` staging each rank's dp block (and ``megabatches``
  sharding the stack's dim 1); a checkpoint saved from a tp-sharded
  scope at 2 ranks and loaded at 1, bitwise; the collective-forms tool
  (``tools/collective_forms.py``) on 2 CPU ranks.
"""

import json
import os

import numpy as np
import pytest

import jax

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import parallel as jpar
from paddle_tpu.models import transformer as JT
from torch_rank_harness import run_ranks

COMBOS4 = [("dp_tp", {"dp": 2, "tp": 2}, 0, 2e-4, 0),
           ("dp_sp", {"dp": 2, "sp": 2}, 1, 2e-3, 0),
           ("dp_pp", {"dp": 2, "pp": 2}, 3, 2e-4, 0),
           ("dp_ep", {"dp": 2, "ep": 2}, 4, 2e-3, 4)]
COMBOS8 = [("dp_tp_sp", {"dp": 2, "tp": 2, "sp": 2}, 2, 2e-3, 0),
           ("dp_pp_tp", {"dp": 2, "pp": 2, "tp": 2}, 5, 2e-4, 0),
           ("dp_pp_ep", {"dp": 2, "pp": 2, "ep": 2}, 6, 2e-3, 4)]
COMBO16 = ("dp_pp_tp_sp", {"dp": 2, "pp": 2, "tp": 2, "sp": 2}, 7, 2e-3, 0)
# run_steps over a mesh that DTensor does not cover (pp or sp alone)
RUN_STEPS = [("steps_pp", {"pp": 2}, 10), ("steps_sp", {"sp": 2}, 11)]
ATTN_SHAPE = (4, 4, 16, 8)
ATTN = [("%s_%s_%s" % (v, "c" if c else "f", tag), v, c, axes, ba)
        for tag, axes, ba in (("sp4", {"sp": 4}, None),
                              ("dp2sp2", {"dp": 2, "sp": 2}, "dp"))
        for v in ("ring", "ulysses") for c in (False, True)]


def _strategy(pkg_par, axes, **kw):
    return pkg_par.DistributedStrategy(
        dp=axes.get("dp", 1), tp=axes.get("tp", 1), sp=axes.get("sp", 1),
        pp=axes.get("pp", 1), ep=axes.get("ep", 1), **kw)


def _jax_program(axes, experts, n_layer=2, **kw):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        avg_cost, _ = JT.transformer_lm_parallel(
            vocab_size=64, max_len=16, n_layer=n_layer, n_head=4,
            d_model=32, d_inner=64, strategy=_strategy(jpar, axes, **kw),
            num_experts=experts)
        jfluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return main, startup, avg_cost


def _batches(axes, seed, steps=3):
    return [{k: np.asarray(v) for k, v in JT.make_lm_batch(
        np.random.RandomState(seed + 100 * i), 4 * axes.get("dp", 1), 16,
        64).items()} for i in range(steps)]


def _jax_lm(cid, axes, seed, experts, tmp, mesh_run=True, n_layer=2,
            **kw):
    """Initial parameters (written for the ranks), and the JAX package's
    single-device and mesh runs: (losses, weights) each."""
    main, startup, avg_cost = _jax_program(axes, experts, n_layer, **kw)
    scope1 = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope1):
        exe.run(startup)
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable and scope1.find_var(v.name) is not None]
    init = {n: np.array(np.asarray(scope1.find_var(n))) for n in names}
    path = os.path.join(str(tmp), "%s_init.npz" % cid)
    np.savez(path, **init)
    runs = {}
    batches = _batches(axes, seed)
    if not kw.get("gradient_accumulation_steps"):
        losses = []
        with jfluid.scope_guard(scope1):
            for feed in batches:
                losses.append(float(np.asarray(exe.run(
                    main, feed=feed, fetch_list=[avg_cost])[0])))
        runs["single"] = (losses, {n: np.asarray(scope1.find_var(n))
                                   for n in names})
    if mesh_run:
        scope2 = jfluid.Scope()
        for n, v in init.items():
            scope2.set(n, np.array(v))
        pexe = jfluid.ParallelExecutor(
            loss_name=avg_cost.name, main_program=main,
            mesh=jpar.make_mesh(dict(axes)), scope=scope2,
            strategy=_strategy(jpar, axes, **kw))
        losses = [float(np.asarray(pexe.run([avg_cost], feed=f)[0]))
                  for f in batches]
        runs["mesh"] = (losses, {n: np.asarray(scope2.find_var(n))
                                 for n in names})
    return path, runs


def _jax_attn(variant, causal, axes, batch_axis, seed):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(*ATTN_SHAPE).astype(np.float32)
                  for _ in range(4))
    mesh = jpar.make_mesh(dict(axes))
    fn = jpar.ring_attention if variant == "ring" else \
        jpar.ulysses_attention

    def f(q, k, v):
        out = fn(q, k, v, mesh, axis_name="sp", causal=causal,
                 batch_axis=batch_axis)
        return (out * w).sum(), out
    # one compile of the forward and backward together
    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {"out": np.asarray(out), "dq": np.asarray(grads[0]),
            "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}


def _lm_case(cid, axes, seed, experts, path, **kw):
    return dict({"id": cid, "kind": "lm", "axes": list(axes.items()),
                 "seed": seed, "num_experts": experts, "init": path}, **kw)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks4")
    refs, cases = {}, []
    for cid, axes, seed, _, experts in COMBOS4:
        path, refs[cid] = _jax_lm(cid, axes, seed, experts, tmp)
        cases.append(_lm_case(cid, axes, seed, experts, path))
    # the interleaved schedule: 4 layers, 2 virtual stages a rank
    path, refs["dp_pp_interleaved"] = _jax_lm(
        "dp_pp_interleaved", {"dp": 2, "pp": 2}, 3, 0, tmp, n_layer=4,
        pp_schedule="interleaved")
    cases.append(_lm_case("dp_pp_interleaved", {"dp": 2, "pp": 2}, 3, 0,
                          path, n_layer=4, schedule="interleaved"))
    for cid, variant, causal, axes, ba in ATTN:
        refs[cid] = _jax_attn(variant, causal, axes, ba, seed=17)
        cases.append({"id": cid, "kind": "attn", "variant": variant,
                      "causal": causal, "axes": list(axes.items()),
                      "batch_axis": ba, "shape": list(ATTN_SHAPE),
                      "seed": 17})
    return run_ranks(4, cases, tmp), refs


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks8")
    refs, cases = {}, []
    for cid, axes, seed, _, experts in COMBOS8:
        path, refs[cid] = _jax_lm(cid, axes, seed, experts, tmp)
        cases.append(_lm_case(cid, axes, seed, experts, path))
    return run_ranks(8, cases, tmp), refs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks2")
    refs, cases = {}, []
    axes = {"dp": 2}
    path, refs["accum"] = _jax_lm("accum", axes, 8, 0, tmp,
                                  gradient_accumulation_steps=2)
    cases.append(_lm_case("accum", axes, 8, 0, path, accum=2))
    path, _ = _jax_lm("ckpt", {"tp": 2}, 9, 0, tmp, mesh_run=False)
    ckpt_dir = os.path.join(str(tmp), "ckpt")
    cases.append(_lm_case("ckpt", {"tp": 2}, 9, 0, path, save=ckpt_dir))
    for cid, axes, seed in RUN_STEPS:
        path, refs[cid] = _jax_lm(cid, axes, seed, 0, tmp, mesh_run=False)
        cases.append(_lm_case(cid, axes, seed, 0, path, run_steps=True))
    cases.append({"id": "loader", "kind": "loader", "axes": [["dp", 2]],
                  "seed": 3, "per_rank": True})
    cases.append({"id": "loader_mega", "kind": "loader",
                  "axes": [["dp", 2]], "seed": 3, "per_rank": True,
                  "megabatch": 2})
    res = run_ranks(2, cases, tmp)
    for r in range(2):
        for cid in ("loader", "loader_mega"):
            with np.load(os.path.join(str(tmp), "out_w2",
                                      "%s.r%d.npz" % (cid, r))) as z:
                res["%s.r%d" % (cid, r)] = {k: z[k] for k in z.files}
    return res, refs, ckpt_dir


def _hold(got, runs, tol):
    for which, (losses, weights) in runs.items():
        for i, (lp, ls) in enumerate(zip(got["losses"], losses)):
            assert np.isfinite(lp), lp
            assert abs(lp - ls) <= tol * max(1.0, abs(ls)), \
                "%s step %d: %r != %r" % (which, i, lp, ls)
        wmax = 0.0
        for n, w in weights.items():
            wmax = max(wmax, float(np.abs(got["w/" + n] - w).max())
                       / max(1.0, float(np.abs(w).max())))
        assert wmax <= 50 * tol, "%s weights: max rel %g" % (which, wmax)


@pytest.mark.parametrize("cid,tol", [(c[0], c[3]) for c in COMBOS4]
                         + [("dp_pp_interleaved", 2e-4)])
def test_dryrun_combos_at_4_ranks(world4, cid, tol):
    res, refs = world4
    assert set(refs[cid]) == {"single", "mesh"}
    _hold(res[cid], refs[cid], tol)


@pytest.mark.parametrize("cid,tol", [(c[0], c[3]) for c in COMBOS8])
def test_dryrun_combos_at_8_ranks(world8, cid, tol):
    res, refs = world8
    _hold(res[cid], refs[cid], tol)


@pytest.mark.slow
def test_dryrun_four_axes_at_16_ranks(tmp_path):
    cid, axes, seed, tol, experts = COMBO16
    path, runs = _jax_lm(cid, axes, seed, experts, tmp_path,
                         mesh_run=False)
    res = run_ranks(16, [_lm_case(cid, axes, seed, experts, path)],
                    tmp_path, timeout=600)
    _hold(res[cid], runs, tol)


@pytest.mark.parametrize("cid", [a[0] for a in ATTN])
def test_ring_and_ulysses_match_jax(world4, cid):
    res, refs = world4
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(res[cid][name], refs[cid][name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_gradient_accumulation_at_2_ranks(world2):
    res, refs, _ = world2
    _hold(res["accum"], refs["accum"], 2e-4)


@pytest.mark.parametrize("cid,tol", [("steps_pp", 2e-4),
                                     ("steps_sp", 2e-3)])
def test_run_steps_over_ranks_is_k_run_calls(world2, cid, tol):
    res, refs, _ = world2
    got = res[cid]
    # over several ranks no megastep (no CUDA graph on the card): K run
    # calls, bitwise equal to calling run K times
    assert int(got["steps_megastep_dispatches"]) == 0
    np.testing.assert_array_equal(got["steps_losses"], got["losses"])
    names = [k for k in got if k.startswith("w/")]
    assert len(names) > 10
    for n in names:
        np.testing.assert_array_equal(got["steps_" + n], got[n], err_msg=n)
    _hold(got, refs[cid], tol)


def test_device_loader_stages_each_ranks_block(world2):
    res = world2[0]
    rng = np.random.RandomState(3)
    batches = [{"x": rng.randn(8, 3).astype(np.float32),
                "y": rng.randint(0, 9, (8, 1)).astype(np.int32)}
               for _ in range(4)]
    for r in range(2):
        got = res["loader.r%d" % r]
        for i, b in enumerate(batches):
            for n in ("x", "y"):
                np.testing.assert_array_equal(got["%d/%s" % (i, n)],
                                              b[n][4 * r:4 * (r + 1)])
                assert tuple(got["%d/%s/global" % (i, n)]) == b[n].shape
        mega = res["loader_mega.r%d" % r]
        for j in range(2):
            for n in ("x", "y"):
                want = np.stack([batches[2 * j + i][n][4 * r:4 * (r + 1)]
                                 for i in range(2)])
                np.testing.assert_array_equal(mega["%d/%s" % (j, n)], want)


def test_checkpoint_from_2_ranks_loads_at_1_bitwise(world2):
    res, _, ckpt_dir = world2
    scope = tfluid.Scope()
    step = tfluid.io.load_checkpoint(ckpt_dir, scope=scope)
    assert step == 3
    got = res["ckpt"]
    names = [k[2:] for k in got if k.startswith("w/")]
    assert len(names) > 10
    for n in names:
        assert np.array_equal(scope.get_numpy(n), got["w/" + n]), n


def test_collective_forms_tool_runs_on_cpu_ranks(capsys):
    # the tool checks that both forms of each collective agree before it
    # times them; a disagreement or a stuck rank exits non-zero
    from paddle_tpu_torch.tools import collective_forms
    assert collective_forms.main(["--device", "cpu", "--worlds", "2",
                                  "--kib", "64", "--reps", "1",
                                  "--timeout", "120"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == {"2/all_gather/64", "2/psum_scatter/64"}
    assert all(v["port"] > 0 and v["tensor"] > 0 for v in got.values())
