"""Serving cold start from an artifact directory, across the two packages.

``transformer_lm(vocab 128, max_len 32, 2 layers, 2 heads, d_model 64,
d_inner 128)`` is built and initialized by ``paddle_tpu``; the same
Program and values live in a port scope too. Pinned:

  * the port's ``extract_params`` yields the JAX package's stream (roles
    and arrays, bitwise) on the plain Program and on the JAX package's
    specialized artifact Program (fused ops);
  * a JAX ``save_lm_artifact`` directory, specialized (the JAX default)
    or not, boots a port ``Engine(<dir>)`` whose greedy fp32 tokens equal
    the JAX engine's from the same directory (scores at rtol 1e-4: the
    packages sum in other orders), through the paged and dense layouts;
  * a JAX ``bf16=True`` artifact boots in the port: its parameters are
    the stored bfloat16 values bit for bit, and its first 8 teacher-forced
    steps' logits stay within 2^-6 of max(1, max|logit|) of the JAX
    executor running the artifact's own Program (bf16 keeps 8 bits, and
    the two round at other points over two layers: measured 0.016 of a
    2.7 logit range). The JAX package's own decode model does not boot
    that artifact (its ``extract_params`` stops at the weights' casts);
  * a port-written artifact boots the JAX engine with identical tokens,
    and ``Engine(<dir>)`` equals an engine over ``from_program`` on the
    live port scope;
  * every ``ArtifactError`` case, and the default (specialized) write
    path, byte for byte the JAX package's;
  * a fresh interpreter that imports only ``paddle_tpu_torch`` serves
    from the directory on the CPU with ``jax`` never loaded.
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
from paddle_tpu.models import transformer as JT
from paddle_tpu.models.transformer_infer import (
    extract_params as jax_extract_params)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.transformer_infer import (
    TransformerLMInfer, extract_params)

VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER = 128, 32, 2, 2, 64, 128
CFG = (N_LAYER, N_HEAD, D_MODEL, MAX_LEN)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lm(fluid, T):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, logits = T.transformer_lm(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER)
    return main, startup, logits


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """The LM in both packages with the same values, and JAX-written
    artifacts: specialized, plain, and bf16 (f32 and bf16 configs)."""
    jmain, jstart, jlogits = _lm(jfluid, JT)
    tmain, _, tlogits = _lm(tfluid, TT)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart)
    names = [v.name for v in jmain.list_vars() if v.persistable]
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, {n: np.asarray(jscope.find_var(n))
                                     for n in names}, "cpu")
    base = tmp_path_factory.mktemp("art")
    arts = {}
    for label, kw in (("specialized", {}),
                      ("plain", {"specialize": False}),
                      ("bf16", {"bf16": True}),
                      ("bf16_model", {"bf16": True, "dtype": "bfloat16"})):
        arts[label] = str(base / label)
        jserving.save_lm_artifact(arts[label], jmain, jscope, [jlogits],
                                  *CFG, end_id=VOCAB, **kw)
    return dict(jmain=jmain, jscope=jscope, jlogits=jlogits, tmain=tmain,
                tscope=tscope, tlogits=tlogits, arts=arts, base=base)


def _requests(seed, n, max_prompt=12, min_new=4, max_new=14):
    rng = np.random.default_rng(seed)
    return [([1] + rng.integers(3, VOCAB, int(rng.integers(0, max_prompt))
                                ).tolist(),
             int(rng.integers(min_new, max_new + 1))) for _ in range(n)]


def _jax_serve(model, reqs):
    with jserving.Engine(model, slots=3, prefill_chunk=4) as eng:
        return eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])


def _serve(model, reqs, **kw):
    with serving.Engine(model, slots=3, prefill_chunk=4, device="cpu",
                        **kw) as eng:
        return eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])


def _same(got, ref):
    for i, ((a, sa), (b, sb)) in enumerate(zip(got, ref)):
        assert a == b, "request %d: %r vs %r" % (i, a, b)
        np.testing.assert_allclose(sa, sb, rtol=1e-4, atol=1e-4)


def _streams_equal(mine, theirs):
    assert [r for r, _ in mine] == [r for r, _ in theirs]
    for (_, a), (_, b) in zip(mine, theirs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("which", ["program", "specialized"])
def test_extract_params_matches_jax(src, which):
    if which == "program":
        mine = extract_params(src["tmain"], src["tscope"])
        theirs = jax_extract_params(src["jmain"], src["jscope"])
    else:
        d = src["arts"]["specialized"]
        tscope, jscope = tfluid.Scope(), jfluid.Scope()
        tprog, _, _ = tio.load_inference_model(d, None, scope=tscope)
        jprog, _, _ = jfluid.io.load_inference_model(d, None, scope=jscope)
        assert "fused_matmul_bias_act" in [
            op.type for op in tprog.global_block().ops]
        mine = extract_params(tprog, tscope)
        theirs = jax_extract_params(jprog, jscope)
    assert len(mine) == 3 + 10 * N_LAYER
    _streams_equal(mine, theirs)


@pytest.mark.parametrize("which", ["specialized", "plain"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_port_boots_jax_artifact(src, which, paged):
    d = src["arts"][which]
    reqs = _requests(0, 7)
    ref = _jax_serve(d, reqs)
    _same(_serve(d, reqs, paged=paged), ref)


@pytest.mark.parametrize("label", ["bf16", "bf16_model"])
def test_jax_bf16_artifact_boots_in_the_port(src, label):
    import ml_dtypes
    d = src["arts"][label]
    man = tio.load_inference_manifest(d)
    assert man["bf16"] and man["param_dtypes"]["fc_0.w_0"] == "bfloat16"
    model = serving.model_from_artifact(d, device="cpu")
    assert model.dtype == (torch.bfloat16 if label == "bf16_model"
                           else torch.float32)
    jscope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        prog, _, fetches = jfluid.io.load_inference_model(d, exe)
    stored = np.asarray(jscope.find_var("fc_0.w_0"))
    assert stored.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(
        model.layers[0].wq.float().numpy(), stored.astype(np.float32))
    with pytest.raises(Exception):
        jserving.model_from_artifact(d)     # the JAX decode model cannot
    rng = np.random.RandomState(0)
    toks = np.concatenate([[1], rng.randint(3, VOCAB, MAX_LEN - 1)])
    feed = {"src": toks[None].astype(np.int64),
            "pos": np.arange(MAX_LEN, dtype=np.int64)[None],
            "mask": np.ones((1, MAX_LEN), np.float32)}
    with jfluid.scope_guard(jscope):
        ref = np.asarray(exe.run(prog, feed=feed, fetch_list=fetches)[0],
                         np.float32).reshape(MAX_LEN, VOCAB)[:8]
    state = model._init_state(1)
    got = []
    with torch.no_grad():
        for t in range(8):
            lg, _ = model._step_logits(torch.tensor([int(toks[t])]), state,
                                       t)
            got.append(lg.float().numpy()[0])
    lim = 2.0 ** -6 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(np.array(got) - ref).max()) <= lim


def test_port_artifact_boots_jax_engine(src, tmp_path):
    d = str(tmp_path / "port-art")
    serving.save_lm_artifact(d, src["tmain"], src["tscope"],
                             [src["tlogits"]], *CFG, end_id=VOCAB,
                             specialize=False)
    reqs = _requests(1, 7)
    ref = _jax_serve(d, reqs)
    _same(_serve(d, reqs), ref)
    _same(_serve(d, reqs, paged=False), ref)


def test_engine_dir_equals_live_scope_engine(src, tmp_path):
    d = str(tmp_path / "port-art")
    serving.save_lm_artifact(d, src["tmain"], src["tscope"],
                             [src["tlogits"]], *CFG, end_id=VOCAB,
                             specialize=False)
    live = TransformerLMInfer.from_program(
        src["tmain"], src["tscope"], *CFG, end_id=VOCAB, device="cpu")
    reqs = _requests(2, 6)
    want = _serve(live, reqs)
    assert _serve(d, reqs) == want
    with serving.engine_from_artifact(d, slots=3, prefill_chunk=4,
                                      device="cpu") as eng:
        assert eng.generate_many([p for p, _ in reqs],
                                 [m for _, m in reqs]) == want


def test_model_from_artifact_runs_on_the_card_unless_asked(src):
    """No silent CPU: without device='cpu' the model goes to the card,
    or, with no card, raises."""
    d = src["arts"]["plain"]
    if torch.cuda.is_available():
        assert serving.model_from_artifact(d).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.model_from_artifact(d)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.Engine(d, slots=1)


# -- ArtifactError cases ---------------------------------------------------

def _edit_config(src_dir, dst, edit):
    """A copy of an artifact with its manifest's config edited."""
    os.makedirs(dst)
    for name in os.listdir(src_dir):
        with open(os.path.join(src_dir, name), "rb") as f:
            data = f.read()
        if name == tio.MANIFEST:
            man = json.loads(data)
            edit(man["config"])
            data = json.dumps(man).encode()
        with open(os.path.join(dst, name), "wb") as f:
            f.write(data)
    return dst


def test_artifact_error_wrong_kind(src, tmp_path):
    d = _edit_config(src["arts"]["plain"], str(tmp_path / "k"),
                     lambda c: c.update(kind="deepfm"))
    with pytest.raises(serving.ArtifactError, match="kind 'deepfm'"):
        serving.model_from_artifact(d, device="cpu")


@pytest.mark.parametrize("key", ["n_layer", "n_head", "d_model", "max_len"])
def test_artifact_error_missing_config_key(src, tmp_path, key):
    d = _edit_config(src["arts"]["plain"], str(tmp_path / key),
                     lambda c: c.pop(key))
    with pytest.raises(serving.ArtifactError, match="missing '%s'" % key):
        serving.model_from_artifact(d, device="cpu")


def test_artifact_error_stream_does_not_replay(src, tmp_path):
    d = _edit_config(src["arts"]["specialized"], str(tmp_path / "n"),
                     lambda c: c.update(n_layer=N_LAYER + 1))
    with pytest.raises(serving.ArtifactError,
                       match="does not replay.*%s" % os.path.basename(d)):
        serving.model_from_artifact(d, device="cpu")


def test_artifact_error_flipped_params_byte(src, tmp_path):
    d = _edit_config(src["arts"]["plain"], str(tmp_path / "f"),
                     lambda c: None)
    pf = os.path.join(d, tio.load_inference_manifest(d)["params_file"])
    with open(pf, "r+b") as f:
        f.seek(os.path.getsize(pf) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(serving.ArtifactError, match="params CORRUPT"):
        serving.Engine(d, slots=1, device="cpu")


def test_artifact_error_no_manifest(tmp_path):
    with pytest.raises(serving.ArtifactError,
                       match="not a serving artifact"):
        serving.Engine(str(tmp_path), slots=1, device="cpu")


def test_save_lm_artifact_default_raises(src, tmp_path):
    """The default write path (``specialize=True``, refused before the
    transform tier was ported) now runs, and writes the JAX package's
    specialized artifact byte for byte from the same Program and
    values."""
    d = serving.save_lm_artifact(str(tmp_path / "a"), src["tmain"],
                                 src["tscope"], [src["tlogits"]], *CFG,
                                 end_id=VOCAB)
    want = src["arts"]["specialized"]
    for f in ("__model__", "__params__.npz", tio.MANIFEST):
        with open(os.path.join(d, f), "rb") as a, \
                open(os.path.join(want, f), "rb") as b:
            assert a.read() == b.read(), f


# -- a fresh process serves from the directory ----------------------------

def test_fresh_process_serves_without_jax(src):
    d = src["arts"]["specialized"]
    reqs = _requests(3, 4)
    want = _serve(d, reqs)
    code = (
        "import json, sys\n"
        "from paddle_tpu_torch import serving\n"
        "eng = serving.engine_from_artifact(sys.argv[1], slots=2,\n"
        "                                   prefill_chunk=4, device='cpu')\n"
        "outs = eng.generate_many(json.loads(sys.argv[2]),\n"
        "                         json.loads(sys.argv[3]))\n"
        "eng.close()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu')]\n"
        "print('ARTOUT ' + json.dumps([[t, s] for t, s in outs]))\n"
        "print('LOADED ' + json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code, d, json.dumps([p for p, _ in reqs]),
         json.dumps([m for _, m in reqs])],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = dict(ln.split(" ", 1) for ln in proc.stdout.splitlines()
                 if ln.startswith(("ARTOUT ", "LOADED ")))
    assert json.loads(lines["LOADED"]) == []
    got = json.loads(lines["ARTOUT"])
    assert [t for t, _ in got] == [t for t, _ in want]
    assert [s for _, s in got] == [s for _, s in want]
