"""Pattern fusion, inference specialization and the specialized and bf16
artifacts of paddle_tpu_torch, against the JAX package.

Twins of ``tests/test_specialize.py`` (its memory-planning and
calibration tests wait for ``transform/memory.py`` and ``calibrate.py``,
ROADMAP.md queue 1 item 11(a) part two; its routed fleet replica case
is ``tests/test_torch_fleet.py``'s): the per-pattern fusion goldens and
safety rules, the cnn_infer zoo model through every pattern family
bitwise, ``specialize_for_inference`` stripping training and staying
bitwise, the bf16 pass's rtol contract, the artifact round trip and its
corruption matrix, half-width bf16 parameters, serving cold start from
the artifact directory (in process and in a fresh process) and
``ScoringEngine.from_artifact``. Then across the packages:

  * ``specialize_for_inference`` (fp32 and ``bf16=True``) rewrites every
    ``TRANSFORM_ZOO`` entry to the JAX package's Program JSON;
  * specialized fp32 LM artifacts cross both ways: written by either
    package, an engine of the other serves identical greedy tokens to
    the writer's own engine (scores at rtol 1e-4: the packages sum in
    other orders);
  * a port-written ``bf16=True`` LM artifact boots in the port: its
    weights are the bfloat16 roundings of the fp32 ones, its first 8
    teacher-forced logits stay within 2^-6 of max(1, max|logit|) of the
    fp32 artifact's (bf16 keeps 8 bits; the JAX package's bf16 artifact
    is held to the same limit in tests/test_torch_artifact.py), and its
    engine serves.

The test LM is ``transformer_lm(vocab 40, max_len 48, 1 layer, 2 heads,
d_model 32, d_inner 64)``; ``end_id`` lies past the vocabulary.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu import transform as jtransform
from paddle_tpu.models import transform_zoo_entry as jzoo
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import serving
from paddle_tpu_torch.io import ArtifactError
from paddle_tpu_torch.models import (TRANSFORM_ZOO, transform_zoo_entry,
                                     transformer)
from paddle_tpu_torch.models.transformer_infer import TransformerLMInfer
from paddle_tpu_torch.transform import (
    FusionPass, PassManager, default_passes,
    specialize_for_inference, verify_bitwise)

N_LAYER, N_HEAD, D_MODEL, MAX_LEN, VOCAB = 1, 2, 32, 48, 40
CFG = (N_LAYER, N_HEAD, D_MODEL, MAX_LEN)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ops(program):
    return [op.type for op in program.global_block().ops]


def _staged(build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetches = build()
    return main, startup, fetches


# -- per-pattern golden fixtures -------------------------------------------

def test_fusion_golden_matmul_bias_act():
    def build():
        x = fluid.layers.data("x", [8])
        h = fluid.layers.fc(x, 4, act="relu")     # mul+add+relu -> 1
        return fluid.layers.fc(h, 2)              # mul+add       -> 1

    main, _, out = _staged(build)
    assert _ops(main) == ["mul", "elementwise_add", "relu",
                          "mul", "elementwise_add"]
    res = PassManager([FusionPass()]).run(main, keep=[out.name])
    assert _ops(res.program) == ["fused_matmul_bias_act"] * 2
    assert res.patterns["matmul_bias_act"] == 1
    assert res.patterns["matmul_bias"] == 1
    assert res.stats["fusion"] == 3
    first, second = res.program.global_block().ops
    assert first.attr("mm_type") == "mul"
    assert first.attr("act_type") == "relu"
    assert second.attr("act_type") == ""
    assert second.output("Out") == [out.name]


def test_fusion_golden_transpose_pairs():
    def build():
        x = fluid.layers.data("x", [2, 3, 4])
        a = fluid.layers.transpose(x, [0, 2, 3, 1])
        b = fluid.layers.transpose(a, [0, 3, 1, 2])   # inverse: gone
        c = fluid.layers.scale(b, 2.0)
        d = fluid.layers.transpose(c, [0, 2, 1, 3])
        e = fluid.layers.transpose(d, [0, 1, 3, 2])   # composes
        return fluid.layers.scale(e, 3.0)

    main, startup, out = _staged(build)
    res = PassManager([FusionPass()]).run(main, keep=[out.name])
    assert _ops(res.program) == ["scale", "transpose", "scale"]
    assert res.patterns["transpose_transpose"] == 2
    assert res.program.global_block().ops[1].attr("axis") == [0, 2, 3, 1]
    assert res.program.global_block().ops[0].input("X") == ["x"]

    def feeds(rng):
        return {"x": rng.rand(2, 2, 3, 4).astype(np.float32)}
    ok, detail = verify_bitwise(main, startup, feeds, [out.name],
                                res.program)
    assert ok, detail


def test_fusion_golden_transpose_identity_protected_keeps_assign():
    def build():
        x = fluid.layers.data("x", [2, 3])
        a = fluid.layers.transpose(x, [0, 2, 1])
        return fluid.layers.transpose(a, [0, 2, 1])

    main, _, out = _staged(build)
    res = PassManager([FusionPass()]).run(main, keep=[out.name])
    assert _ops(res.program) == ["assign"]
    a = res.program.global_block().ops[0]
    assert a.input("X") == ["x"] and a.output("Out") == [out.name]


def test_fusion_golden_reshape_chain_and_scale_cast():
    def build():
        x = fluid.layers.data("x", [2, 6])
        r = fluid.layers.reshape(x, [-1, 12])
        r2 = fluid.layers.reshape(r, [-1, 3, 4])      # outer wins
        c = fluid.layers.cast(r2, "float32")
        return fluid.layers.scale(c, 0.5, bias=1.0)   # pairs with cast

    main, startup, out = _staged(build)
    assert _ops(main) == ["reshape", "reshape", "cast", "scale"]
    res = PassManager([FusionPass()]).run(main, keep=[out.name])
    assert _ops(res.program) == ["reshape", "fused_scale_cast"]
    assert res.patterns["reshape_reshape"] == 1
    assert res.patterns["scale_cast"] == 1
    rs = res.program.global_block().ops[0]
    assert rs.attr("shape") == [-1, 3, 4] and rs.input("X") == ["x"]
    fsc = res.program.global_block().ops[1]
    assert [t for t, _ in fsc.attr("ops")] == ["cast", "scale"]

    def feeds(rng):
        return {"x": rng.rand(3, 2, 6).astype(np.float32)}
    ok, detail = verify_bitwise(main, startup, feeds, [out.name],
                                res.program)
    assert ok, detail


def test_fusion_safety_rules():
    """A multi-consumer intermediate and a keep-set intermediate refuse
    to fuse."""
    def build():
        x = fluid.layers.data("x", [4])
        mm = fluid.layers.fc(x, 4, bias_attr=False)    # bare mul
        y = fluid.layers.elementwise_add(mm, mm)       # reads it twice
        return y, mm

    main, _, (y, mm) = _staged(build)
    res = PassManager([FusionPass()]).run(main, keep=[y.name])
    assert _ops(res.program) == _ops(main)
    assert sum(res.patterns.values()) == 0

    def build2():
        x = fluid.layers.data("x", [4])
        return fluid.layers.fc(x, 4, act="relu")

    main2, _, h = _staged(build2)
    gb = main2.global_block()
    pre_act = gb.ops[1].output("Out")[0]               # the add's out
    res2 = PassManager([FusionPass()]).run(main2, keep=[h.name, pre_act])
    assert _ops(res2.program)[-1] == gb.ops[-1].type   # act survives
    assert pre_act in [n for op in res2.program.global_block().ops
                       for n in op.output_names]


def test_fusion_pattern_counters_tick():
    from paddle_tpu_torch.monitor import runtime as monrt

    def build():
        x = fluid.layers.data("x", [8])
        return fluid.layers.fc(x, 4, act="relu")

    main, _, out = _staged(build)
    before = monrt.TRANSFORM_PATTERNS.value(pattern="matmul_bias_act")
    PassManager([FusionPass()]).run(main, keep=[out.name])
    assert monrt.TRANSFORM_PATTERNS.value(pattern="matmul_bias_act") == \
        before + 1


def test_cnn_infer_zoo_fuses_all_patterns_bitwise():
    main, startup, feed_fn, fetch_names = transform_zoo_entry("cnn_infer")
    res = PassManager(default_passes()).run(main, keep=fetch_names)
    assert _ops(res.program) == [
        "fused_scale_cast", "fused_matmul_bias_act", "pool2d",
        "reshape", "fused_matmul_bias_act"]
    for pat in ("matmul_bias_act", "transpose_transpose",
                "reshape_reshape", "scale_cast"):
        assert res.patterns[pat] >= 1, res.patterns
    ok, detail = verify_bitwise(main, startup, feed_fn, fetch_names,
                                res.program)
    assert ok, detail


# -- specialize_for_inference ----------------------------------------------

def _train_net(fl=fluid):
    x = fl.layers.data("x", [8])
    label = fl.layers.data("label", [1], dtype="int64")
    h = fl.layers.fc(x, 6, act="relu")
    pred = fl.layers.fc(h, 3, act="softmax")
    cost = fl.layers.mean(fl.layers.cross_entropy(pred, label))
    fl.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return pred, cost


def _forward(program, scope, feed, fetch):
    return fluid.Executor(fluid.CPUPlace()).run(
        program, feed=feed, fetch_list=[fetch], scope=scope)[0]


def test_specialize_strips_training_and_stays_bitwise():
    main, startup, (pred, cost) = _staged(_train_net)
    assert "sgd" in _ops(main) and "backward_marker" in _ops(main)
    spec = specialize_for_inference(main, ["x"], [pred.name])
    assert _ops(spec.program) == ["fused_matmul_bias_act"] * 2
    assert spec.transform.patterns["matmul_bias_act"] == 2
    assert "sgd" in _ops(main)                # the source is untouched
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).rand(4, 8).astype(np.float32)}
    src = _forward(main.prune([pred.name]), scope, feed, pred.name)
    got = _forward(spec.program, scope, feed, pred.name)
    assert got.tobytes() == src.tobytes()


def test_specialize_validates_names():
    main, _, (pred, _) = _staged(_train_net)
    with pytest.raises(ValueError, match="not a variable"):
        specialize_for_inference(main, ["bogus"], [pred.name])


def test_bf16_pass_rtol_contract_not_bitwise():
    main, startup, (pred, cost) = _staged(_train_net)
    plain = specialize_for_inference(main, ["x"], [pred.name])
    assert "cast" not in _ops(plain.program)          # off by default
    spec = specialize_for_inference(main, ["x"], [pred.name], bf16=True)
    ops = spec.program.global_block().ops
    assert spec.bf16_sites == 2
    for i, op in enumerate(ops):
        if op.type == "fused_matmul_bias_act":
            assert ops[i + 1].type == "cast" \
                and ops[i + 1].attr("out_dtype") == "float32"
    w = [v for n, v in spec.program.global_block().vars.items()
         if n.endswith(".w_0")]
    assert w and all(v.dtype == "bfloat16" for v in w)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    feed = {"x": np.random.RandomState(1).rand(4, 8).astype(np.float32)}
    src = _forward(main.prune([pred.name]), scope, feed, pred.name)
    got = _forward(spec.program, scope, feed, pred.name)
    assert got.dtype == np.float32
    assert got.tobytes() != src.tobytes()             # it DID round
    np.testing.assert_allclose(got, src, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("model", sorted(TRANSFORM_ZOO))
def test_specialize_is_the_jax_program(model, bf16):
    with fluid.unique_name.guard():
        main, _, _, fetch = transform_zoo_entry(model)
    with jfluid.unique_name.guard():
        jmain, _, _, jfetch = jzoo(model)
    feeds = [v.name for v in main.list_vars() if v.is_data]
    mine = specialize_for_inference(main, feeds, fetch, bf16=bf16)
    theirs = jtransform.specialize_for_inference(jmain, feeds, jfetch,
                                                 bf16=bf16)
    assert mine.program.to_json() == theirs.program.to_json()
    assert mine.to_dict() == theirs.to_dict()


# -- the artifact round trip ------------------------------------------------

@pytest.fixture()
def small_artifact(tmp_path):
    main, startup, (pred, cost) = _staged(_train_net)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    d = str(tmp_path / "art")
    tio.save_inference_model(d, ["x"], [pred], None, main_program=main,
                             scope=scope)
    return {"dir": d, "main": main, "scope": scope, "pred": pred}


def test_artifact_roundtrip_bitwise_and_manifest(small_artifact):
    s = small_artifact
    feed = {"x": np.random.RandomState(2).rand(4, 8).astype(np.float32)}
    src = _forward(s["main"].prune([s["pred"].name]), s["scope"], feed,
                   s["pred"].name)
    m = tio.load_inference_manifest(s["dir"])
    assert m["format"] == 2 and m["feed_names"] == ["x"]
    assert m["fetch_names"] == [s["pred"].name]
    assert m["transform"]["patterns"]["matmul_bias_act"] == 2
    assert isinstance(m["model_crc32"], int)
    assert isinstance(m["params_crc32"], int)
    fresh = fluid.Scope()
    prog, feeds, fetches = tio.load_inference_model(s["dir"], None,
                                                    scope=fresh)
    assert feeds == ["x"] and [v.name for v in fetches] == [s["pred"].name]
    assert _ops(prog) == ["fused_matmul_bias_act"] * 2
    got = _forward(prog, fresh, feed, fetches[0].name)
    assert got.tobytes() == src.tobytes()


def test_artifact_corrupt_matrix(small_artifact):
    d = small_artifact["dir"]
    m = tio.load_inference_manifest(d)

    def reload():
        return tio.load_inference_model(d, None, scope=fluid.Scope())

    pf = os.path.join(d, m["params_file"])
    blob = open(pf, "rb").read()
    open(pf, "wb").write(blob[:-16])
    with pytest.raises(ArtifactError, match="params CORRUPT"):
        reload()
    flipped = bytearray(blob)
    flipped[len(flipped) // 2] ^= 0x40
    open(pf, "wb").write(bytes(flipped))
    with pytest.raises(ArtifactError, match="params CORRUPT"):
        reload()
    open(pf, "wb").write(blob)
    reload()
    mf = os.path.join(d, m["model_file"])
    model_bytes = open(mf, "rb").read()
    os.unlink(mf)
    with pytest.raises(ArtifactError, match="program missing"):
        reload()
    open(mf, "wb").write(model_bytes[:-4] + b"xxxx")
    with pytest.raises(ArtifactError, match="program CORRUPT"):
        reload()
    open(mf, "wb").write(model_bytes)
    man = os.path.join(d, tio.MANIFEST)
    man_bytes = open(man, "rb").read()
    open(man, "wb").write(man_bytes[:-8])
    with pytest.raises(ArtifactError, match="manifest"):
        reload()
    open(man, "wb").write(man_bytes)
    reload()
    with pytest.raises(ArtifactError, match="not a serving artifact"):
        serving.model_from_artifact(str(d) + "-nope", device="cpu")


def test_bf16_artifact_stores_half_width_params(tmp_path):
    main, startup, (pred, cost) = _staged(_train_net)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    d = str(tmp_path / "bf16art")
    tio.save_inference_model(d, ["x"], [pred], None, main_program=main,
                             scope=scope, bf16=True)
    m = tio.load_inference_manifest(d)
    assert m["bf16"] is True
    assert m["param_dtypes"].get("fc_0.w_0") == "bfloat16"
    fresh = fluid.Scope()
    prog, _, fetches = tio.load_inference_model(d, None, scope=fresh)
    w = fresh.find_var("fc_0.w_0")
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, scope.find_var("fc_0.w_0").to(torch.bfloat16))
    feed = {"x": np.random.RandomState(3).rand(4, 8).astype(np.float32)}
    src = _forward(main.prune([pred.name]), scope, feed, pred.name)
    got = _forward(prog, fresh, feed, fetches[0].name)
    np.testing.assert_allclose(got, src, rtol=2e-2, atol=2e-2)


# -- serving cold start ---------------------------------------------------

def _lm(fl, T):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        _, logits = T.transformer_lm(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=64)
    return main, startup, logits


@pytest.fixture(scope="module")
def lm_setup(tmp_path_factory):
    """The LM in both packages with the JAX startup values, and the
    specialized (fp32) and bf16 artifacts each package writes."""
    jmain, jstart, jlogits = _lm(jfluid, JT)
    tmain, _, tlogits = _lm(fluid, transformer)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart)
    names = [v.name for v in jmain.list_vars() if v.persistable]
    tscope = fluid.Scope()
    fluid.load_numpy_state(tscope, {n: np.asarray(jscope.find_var(n))
                                    for n in names}, "cpu")
    base = tmp_path_factory.mktemp("lm")
    arts = {}
    for label, kw in (("fp32", {}), ("bf16", {"bf16": True})):
        arts["jax", label] = str(base / ("jax-" + label))
        jserving.save_lm_artifact(arts["jax", label], jmain, jscope,
                                  [jlogits], *CFG, end_id=VOCAB, **kw)
        arts["port", label] = str(base / ("port-" + label))
        serving.save_lm_artifact(arts["port", label], tmain, tscope,
                                 [tlogits], *CFG, end_id=VOCAB, **kw)
    lm = TransformerLMInfer.from_program(tmain, tscope, *CFG,
                                         end_id=VOCAB, device="cpu")
    return dict(lm=lm, arts=arts, tmain=tmain, tscope=tscope)


def _requests(rng, n, max_prompt=8, min_new=4, max_new=10):
    reqs = []
    for _ in range(n):
        plen = int(rng.randint(1, max_prompt + 1))
        reqs.append(([1] + rng.randint(3, VOCAB, plen - 1).tolist(),
                     int(rng.randint(min_new, max_new + 1))))
    return reqs


def _serve(model, reqs, **kw):
    with serving.Engine(model, slots=2, prefill_chunk=4, device="cpu",
                        **kw) as eng:
        return eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])


def _jax_serve(model, reqs):
    with jserving.Engine(model, slots=2, prefill_chunk=4) as eng:
        return eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])


def test_engine_from_artifact_token_identity(lm_setup):
    """An engine booted from the port's specialized artifact DIRECTORY
    serves the source-model engine's tokens, scores bitwise."""
    d = lm_setup["arts"]["port", "fp32"]
    m = tio.load_inference_manifest(d)
    assert m["config"]["kind"] == "transformer_lm"
    assert m["transform"]["patterns"]["matmul_bias"] >= 1
    reqs = _requests(np.random.RandomState(7), 6)
    assert _serve(d, reqs) == _serve(lm_setup["lm"], reqs)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_specialized_artifacts_cross_both_ways(lm_setup, writer):
    """A specialized fp32 artifact written by either package: the other
    package's engine serves the writer's own engine's greedy tokens."""
    d = lm_setup["arts"][writer, "fp32"]
    reqs = _requests(np.random.RandomState(9), 6)
    mine, theirs = _serve(d, reqs), _jax_serve(d, reqs)
    for i, ((a, sa), (b, sb)) in enumerate(zip(mine, theirs)):
        assert a == b, "request %d: %r vs %r" % (i, a, b)
        np.testing.assert_allclose(sa, sb, rtol=1e-4, atol=1e-4)


def test_port_bf16_artifact_boots_in_the_port(lm_setup):
    fp32 = serving.model_from_artifact(lm_setup["arts"]["port", "fp32"],
                                       device="cpu")
    d = lm_setup["arts"]["port", "bf16"]
    man = tio.load_inference_manifest(d)
    assert man["bf16"] and man["param_dtypes"]["fc_0.w_0"] == "bfloat16"
    model = serving.model_from_artifact(d, device="cpu")
    np.testing.assert_array_equal(
        model.layers[0].wq.numpy(),
        fp32.layers[0].wq.to(torch.bfloat16).float().numpy())
    rng = np.random.RandomState(0)
    toks = [1] + rng.randint(3, VOCAB, 7).tolist()
    got, want = [], []
    for m, out in ((model, got), (fp32, want)):
        state = m._init_state(1)
        with torch.no_grad():
            for t in range(8):
                lg, state = m._step_logits(torch.tensor([toks[t]]), state,
                                           t)
                out.append(lg.float().numpy()[0])
    got, want = np.array(got), np.array(want)
    assert got.tobytes() != want.tobytes()          # the weights rounded
    lim = 2.0 ** -6 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= lim
    reqs = _requests(np.random.RandomState(5), 4)
    out = _serve(d, reqs)
    assert [len(t) for t, _ in out] == [n for _, n in reqs]


def test_fresh_process_artifact_serve_bitwise(lm_setup, tmp_path):
    """A fresh interpreter holding nothing but the port's specialized
    artifact directory (and never importing jax) serves the source
    engine's tokens and scores."""
    reqs = _requests(np.random.RandomState(11), 4, max_new=8)
    want = _serve(lm_setup["lm"], reqs)
    script = tmp_path / "serve_artifact.py"
    script.write_text(
        "import json, sys\n"
        "from paddle_tpu_torch import serving\n"
        "reqs = json.loads(sys.argv[2])\n"
        "with serving.engine_from_artifact(sys.argv[1], slots=2,\n"
        "        prefill_chunk=4, device='cpu') as eng:\n"
        "    outs = eng.generate_many([p for p, _ in reqs],\n"
        "                             [m for _, m in reqs])\n"
        "assert 'jax' not in sys.modules\n"
        "print('ARTOUT ' + json.dumps([[t, float(s)] for t, s in outs]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, str(script), lm_setup["arts"]["port", "fp32"],
         json.dumps(reqs)], capture_output=True, text=True, timeout=240,
        env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("ARTOUT ")][-1]
    got = json.loads(line[len("ARTOUT "):])
    assert [(list(t), float(s)) for t, s in want] == \
        [(list(t), float(s)) for t, s in got]


def test_scoring_engine_from_artifact_bitwise(tmp_path):
    """The dense-scoring cold start: ``ScoringEngine.from_artifact`` of
    a specialized artifact scores bitwise as a direct run of the source
    program."""
    from paddle_tpu_torch.models import deepfm as dfm
    from paddle_tpu_torch.serving.sparse.scoring import ScoringEngine

    F, DIM = 3, 4
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup):
        prob, _ = dfm.build_scoring_net(F, DIM, dnn_dims=(8,))
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(tmp_path / "scoring-art")
    tio.save_inference_model(d, ["fm_first_rows", "fm_second_rows"],
                             [prob], exe, main_program=main, scope=scope)
    assert "fused_matmul_bias_act" in _ops(tio.load_inference_model(
        d, None, scope=fluid.Scope())[0])
    rng = np.random.RandomState(3)
    feats = [{"first": rng.rand(F).astype(np.float32),
              "second": rng.rand(F, DIM).astype(np.float32)}
             for _ in range(3)]

    def featurizer(features, batch):
        first = np.zeros((batch, F), np.float32)
        second = np.zeros((batch, F, DIM), np.float32)
        for i, f in enumerate(features):
            first[i], second[i] = f["first"], f["second"]
        return {"fm_first_rows": first, "fm_second_rows": second}

    eng = ScoringEngine.from_artifact(d, featurizer, batch=2,
                                      name="art-scoring",
                                      place=fluid.CPUPlace())
    try:
        got = eng.score_many(feats)
    finally:
        eng.close()
    for i, f in enumerate(feats):
        out, = exe.run(main, feed=featurizer([f], 2),
                       fetch_list=[prob.name], scope=scope)
        assert got[i] == float(np.asarray(out).reshape(-1)[0]), i
