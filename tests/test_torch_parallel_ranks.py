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
  scope at 2 ranks and loaded at 1, bitwise, and so from pp- and
  ep-placed scopes; the collective-forms tool
  (``tools/collective_forms.py``) on 2 CPU ranks, and the step-split
  tool (``tools/parallel_step_split.py``) on 4.
* A plain ``Executor`` run of the dp x pp program on the scope its 3
  steps left (each rank's stage blocks, gathered whole at the read):
  its loss on the next batch within 2e-4 of the JAX package's on its
  runs' final weights.
* What each rank holds (``parallel/blocks.py``): after the 3 steps of
  dp x pp and dp x ep (4 ranks), dp x pp x ep and dp x pp x tp (8), and
  Adam over pp = 2 (2 ranks, the moments), every persistable whose hint
  names a mesh axis has on each rank the JAX mesh run's per-device shard
  shape (``addressable_shards[0].data.shape``). Of the unhinted ones the
  JAX run shards only the sparse MoE's gates (``moe_ffn_*.w_0``) under
  dp x ep, on ep along their expert dim, a placement GSPMD chose for
  their update; the port keeps unhinted values as the hints place them
  (``UNHINTED_JAX_SHARDS``). Adam's moments follow their parameter in
  both packages.
* Sequence blocks: in dp x sp (4 ranks), sp = 4 (4 ranks) and sp = 2 (2
  ranks) the LM's Q enters each ring region, and its output leaves it,
  as the rank's [B/dp, H, T/sp, dk] block; the step makes no gather of
  the port's and no all-gather or reduce-scatter of DTensor's, and the
  bytes the ring sends are the count worked out from the code
  (``_ring_bytes``). Ring and Ulysses on each rank's block of DTensor
  inputs match the JAX functions as the whole-tensor calls do, with the
  bytes their rotations and all-to-alls send.
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
# the LM over sp alone at 4 ranks (the dryrun's batch, 4)
SP4 = ("sp4", {"sp": 4}, 12, 2e-3, 0)
# the unhinted persistables the JAX mesh run leaves sharded after its
# steps (GSPMD's placement of their update): the sparse MoE's gates
UNHINTED_JAX_SHARDS = {"dp_ep": {"moe_ffn_0.w_0", "moe_ffn_1.w_0"}}
# the combos whose every persistable's shape a rank is held against the
# JAX mesh run's shard shape, by world size
SHAPES4 = ("dp_pp", "dp_ep")
SHAPES8 = ("dp_pp_tp", "dp_pp_ep")
# the global norm a dp x pp case clips its gradients to (small enough
# that every step clips)
CLIP = 0.5
# checkpoints saved from 2 ranks: (case, axes, seed, experts)
CKPTS = [("ckpt_pp", {"pp": 2}, 13, 0), ("ckpt_ep", {"ep": 2}, 14, 4)]
# run_steps over a mesh that DTensor does not cover (pp or sp alone)
RUN_STEPS = [("steps_pp", {"pp": 2}, 10), ("steps_sp", {"sp": 2}, 11)]
ATTN_SHAPE = (4, 4, 16, 8)
ATTN = [("%s_%s_%s" % (v, "c" if c else "f", tag), v, c, axes, ba)
        for tag, axes, ba in (("sp4", {"sp": 4}, None),
                              ("dp2sp2", {"dp": 2, "sp": 2}, "dp"))
        for v in ("ring", "ulysses") for c in (False, True)]
# the causal cases again on each rank's block of DTensor inputs
ATTN_BLOCKS = [a for a in ATTN if a[2]]


def _strategy(pkg_par, axes, **kw):
    return pkg_par.DistributedStrategy(
        dp=axes.get("dp", 1), tp=axes.get("tp", 1), sp=axes.get("sp", 1),
        pp=axes.get("pp", 1), ep=axes.get("ep", 1), **kw)


def _jax_program(axes, experts, n_layer=2, optimizer="sgd", clip=None,
                 **kw):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        avg_cost, _ = JT.transformer_lm_parallel(
            vocab_size=64, max_len=16, n_layer=n_layer, n_head=4,
            d_model=32, d_inner=64, strategy=_strategy(jpar, axes, **kw),
            num_experts=experts)
        if clip:
            jfluid.clip.set_gradient_clip(
                jfluid.clip.GradientClipByGlobalNorm(clip))
        if optimizer == "adam":
            jfluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        else:
            jfluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return main, startup, avg_cost


def _batches(axes, seed, steps=3):
    return [{k: np.asarray(v) for k, v in JT.make_lm_batch(
        np.random.RandomState(seed + 100 * i), 4 * axes.get("dp", 1), 16,
        64).items()} for i in range(steps)]


def _jax_lm(cid, axes, seed, experts, tmp, mesh_run=True, n_layer=2,
            shapes=None, optimizer="sgd", clip=None, evals=None, **kw):
    """Initial parameters (written for the ranks), and the JAX package's
    single-device and mesh runs: (losses, weights) each. ``shapes``, a
    dict, gets each persistable's per-device shard shape after the mesh
    run (under its name) and the program's hints (under "hints");
    ``evals``, a dict, each run's loss on the next batch through a plain
    Executor from its final weights (under the run's name)."""
    main, startup, avg_cost = _jax_program(axes, experts, n_layer,
                                           optimizer, clip, **kw)
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
        if shapes is not None:
            shapes["hints"] = dict(main._sharding_hints)
            for n in names:
                val = scope2.find_var(n)
                shapes[n] = tuple(val.addressable_shards[0].data.shape)
    if evals is not None:
        feed = _batches(axes, seed, len(batches) + 1)[-1]
        test = main.clone(for_test=True)
        for which, (_, weights) in runs.items():
            scope3 = jfluid.Scope()
            for n, v in weights.items():
                scope3.set(n, np.array(v))
            with jfluid.scope_guard(scope3):
                evals[which] = float(np.asarray(exe.run(
                    test, feed=feed, fetch_list=[avg_cost])[0]))
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
        shapes = refs.setdefault(cid + "/shapes", {})
        evals = refs.setdefault(cid + "/eval", {}) if cid == "dp_pp" \
            else None
        path, refs[cid] = _jax_lm(cid, axes, seed, experts, tmp,
                                  shapes=shapes, evals=evals)
        cases.append(_lm_case(cid, axes, seed, experts, path,
                              eval=evals is not None))
    cid, axes, seed, _, experts = SP4
    path, refs[cid] = _jax_lm(cid, axes, seed, experts, tmp,
                              mesh_run=False)
    cases.append(_lm_case(cid, axes, seed, experts, path))
    # a global-norm clip reads every gradient, the held stage blocks'
    # gathered whole
    path, refs["clip_pp"] = _jax_lm("clip_pp", {"dp": 2, "pp": 2}, 16, 0,
                                    tmp, clip=CLIP)
    cases.append(_lm_case("clip_pp", {"dp": 2, "pp": 2}, 16, 0, path,
                          clip=CLIP))
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
    for cid, variant, causal, axes, ba in ATTN_BLOCKS:
        cases.append({"id": cid + "_blocks", "kind": "attn",
                      "variant": variant, "causal": causal,
                      "axes": list(axes.items()), "batch_axis": ba,
                      "shape": list(ATTN_SHAPE), "seed": 17,
                      "blocks": True})
    return run_ranks(4, cases, tmp), refs


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks8")
    refs, cases = {}, []
    for cid, axes, seed, _, experts in COMBOS8:
        shapes = refs.setdefault(cid + "/shapes", {})
        path, refs[cid] = _jax_lm(cid, axes, seed, experts, tmp,
                                  shapes=shapes)
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
    # Adam over pp = 2: the moments follow their stage weights
    shapes = refs.setdefault("adam_pp/shapes", {})
    path, refs["adam_pp"] = _jax_lm("adam_pp", {"pp": 2}, 15, 0, tmp,
                                    shapes=shapes, optimizer="adam")
    cases.append(_lm_case("adam_pp", {"pp": 2}, 15, 0, path,
                          optimizer="adam"))
    for cid, axes, seed, experts in CKPTS:
        path, _ = _jax_lm(cid, axes, seed, experts, tmp, mesh_run=False)
        cases.append(_lm_case(cid, axes, seed, experts, path,
                              save=os.path.join(str(tmp), cid)))
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
    res["tmp"] = str(tmp)
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


def _held_like_jax(got, shapes, cid):
    """Every persistable's shape on this rank against the JAX mesh run's
    per-device shard shape: equal where the hint names a mesh axis, and
    where it does not, equal but for ``UNHINTED_JAX_SHARDS`` (held whole
    by the port). Returns the names held as a block."""
    hints = shapes["hints"]
    names = [k[len("shape/"):] for k in got if k.startswith("shape/")]
    assert set(names) == set(shapes) - {"hints"}
    odd, blocks = UNHINTED_JAX_SHARDS.get(cid, set()), []
    for n in names:
        mine = tuple(int(d) for d in got["shape/" + n])
        if mine != tuple(got["w/" + n].shape):
            blocks.append(n)
        if n in hints or n not in odd:
            assert mine == shapes[n], "%s: %s on this rank, %s in JAX" % (
                n, mine, shapes[n])
        else:
            assert mine == tuple(got["w/" + n].shape) != shapes[n], n
    return blocks


def test_global_norm_clip_over_held_stage_blocks(world4):
    res, refs = world4
    got = res["clip_pp"]
    held = [k for k in got if k.startswith("shape/")
            and tuple(got[k]) != tuple(got["w/" + k[6:]].shape)]
    assert len(held) == 12, held
    # the clip gathers the held gradients whole: an all-gather for each
    # of the 12 stage blocks' gradients a step, once for the norm and
    # once for the scaled gradient, beyond dp x pp's own (no clip)
    base = int(res["dp_pp"].get("calls/all_gather", 0))
    assert int(got["calls/all_gather"]) - base == 3 * 12 * 2
    _hold(got, refs["clip_pp"], 2e-4)


def test_plain_executor_reads_a_pp_trained_scope(world4):
    # after dp x pp steps the scope holds each rank's stage blocks; a
    # plain Executor's run of the program gathers them whole (its dense
    # loop over every layer) and matches the JAX package's evaluation of
    # its single-device and mesh runs' final weights
    res, refs = world4
    got = float(res["dp_pp"]["eval_loss"])
    assert set(refs["dp_pp/eval"]) == {"single", "mesh"}
    for which, want in refs["dp_pp/eval"].items():
        assert abs(got - want) <= 2e-4 * max(1.0, abs(want)), \
            "%s: %r != %r" % (which, got, want)


@pytest.mark.parametrize("cid", SHAPES4)
def test_each_rank_holds_the_jax_shard_shapes_at_4_ranks(world4, cid):
    res, refs = world4
    blocks = _held_like_jax(res[cid], refs[cid + "/shapes"], cid)
    assert len(blocks) >= (12 if cid == "dp_pp" else 4), blocks


@pytest.mark.parametrize("cid", SHAPES8)
def test_each_rank_holds_the_jax_shard_shapes_at_8_ranks(world8, cid):
    res, refs = world8
    blocks = _held_like_jax(res[cid], refs[cid + "/shapes"], cid)
    assert len(blocks) >= 11, blocks


def test_adam_moments_follow_their_stage_weights(world2):
    res, refs, _ = world2
    got = res["adam_pp"]
    blocks = _held_like_jax(got, refs["adam_pp/shapes"], "adam_pp")
    moments = [n for n in blocks if "moment" in n]
    # each of the 12 stage weights and its two moments
    assert len(blocks) == 36 and len(moments) == 24, blocks
    _hold(got, refs["adam_pp"], 2e-4)


def _ring_bytes(steps, layers, b, h, t, dk, sp):
    """The bytes a rank's ring regions send in ``steps`` LM steps, from
    the code (``ring._Ring``): the forward rotates its K and V blocks
    [b, h, t/sp, dk] sp - 1 times, and the backward sends each step's dK
    and dV home, sp - 1 times."""
    block = b * h * (t // sp) * dk * 4
    return steps * layers * 2 * (sp - 1) * 2 * block


@pytest.mark.parametrize("world,cid,dp,sp", [(4, "dp_sp", 2, 2),
                                             (4, "sp4", 1, 4),
                                             (2, "steps_sp", 1, 2)])
def test_sp_activations_stay_sequence_blocks(request, world, cid, dp, sp):
    res = request.getfixturevalue("world%d" % world)[0]
    got = res[cid]
    rows = json.loads(str(got["sp_attention"]))
    b, h, t, dk = 4 * dp, 4, 16, 8
    assert len(rows) == 2 * 3          # 2 layers x 3 steps
    for q_local, q_global, o_local, o_global, q_pl, o_pl in rows:
        assert q_global == o_global == [b, h, t, dk]
        assert q_local == o_local == [b // dp, h, t // sp, dk]
        assert "Shard(dim=2)" in q_pl and "Shard(dim=2)" in o_pl
    # no gather between the regions: the port's collectives are the
    # ring's rotations and the fetched loss's sum over the ranks (its
    # 4 bytes over each mesh dim, a step), DTensor's the all-reduces of
    # the loss and the weight gradients
    kinds = {k.split("/", 1)[1] for k in got if k.startswith("calls/")}
    assert kinds <= {"ppermute", "all_reduce"}, kinds
    assert int(got.get("sent/all_reduce", 0)) == \
        3 * ((dp > 1) + (sp > 1)) * 4
    funcol = {k.split("/", 1)[1] for k in got if k.startswith("funcol/")}
    assert funcol <= {"all_reduce"}, funcol
    assert int(got["sent/ppermute"]) == _ring_bytes(3, 2, b // dp, h, t,
                                                    dk, sp)
    _hold(got, request.getfixturevalue("world%d" % world)[1][cid], 2e-3)


@pytest.mark.parametrize("cid", [a[0] for a in ATTN_BLOCKS])
def test_ring_and_ulysses_on_sequence_blocks_match_jax(world4, cid):
    res, refs = world4
    got = res[cid + "_blocks"]
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], refs[cid][name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    b, h, t, dk = ATTN_SHAPE
    dp, sp = (2, 2) if cid.endswith("dp2sp2") else (1, 4)
    assert tuple(got["out_local"]) == (b // dp, h, t // sp, dk)
    block = (b // dp) * h * (t // sp) * dk * 4
    kinds = {k.split("/", 1)[1]: int(got[k]) for k in got
             if k.startswith("sent/")}
    if cid.startswith("ring"):
        # K and V rotated sp - 1 times, dK and dV sent home as often
        assert kinds == {"ppermute": 2 * (sp - 1) * 2 * block}, kinds
    else:
        # Q, K, V and the output, and their gradients, one all-to-all each
        assert kinds == {"all_to_all": 8 * block}, kinds


@pytest.mark.parametrize("cid", [c[0] for c in CKPTS])
def test_checkpoint_from_pp_and_ep_ranks_loads_at_1_bitwise(world2, cid):
    res = world2[0]
    scope = tfluid.Scope()
    step = tfluid.io.load_checkpoint(os.path.join(res["tmp"], cid),
                                     scope=scope)
    assert step == 3
    got = res[cid]
    names = [k[2:] for k in got if k.startswith("w/")]
    held = [n for n in names
            if tuple(got["shape/" + n]) != tuple(got["w/" + n].shape)]
    assert len(held) >= 4, held
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


def test_parallel_step_split_tool_runs_on_cpu_ranks(capsys):
    # the tool's timers wrap the port's collectives and DTensor's
    # dispatch; a rank that fails or hangs exits non-zero
    from paddle_tpu_torch.tools import parallel_step_split
    assert parallel_step_split.main([
        "--device", "cpu", "--small", "--combos", "dp_pp,dp_sp",
        "--steps", "1", "--timeout", "300"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (run,) = got["runs"]
    assert len(run["ranks"]) == 4
    for rank in run["ranks"]:
        for combo in ("dp_pp", "dp_sp"):
            res = rank[combo]
            assert res["step_ms"] > 0 and res["first_ms"] > 0
            assert np.isfinite(res["losses"]).all()
            assert res["buckets"]["collectives"] > 0
            assert res["buckets"]["backward"] > 0
