"""paddle_tpu_torch.io against the JAX package's io, both ways.

The files are the JAX package's: the same ``.npy``/``.npz`` arrays, the
same Program JSON and manifest, the same CRC32s. So here:

  * persistables saved by either package (one ``.npy`` per var, and one
    ``.npz`` with ``filename=``) load in the other as identical arrays;
  * the same Program and scope saved by both packages with
    ``save_inference_model(specialize=False)`` give byte-identical
    ``__model__``, params blob and manifest (``np.savez`` stamps no
    clock: every zip entry carries the 1980 default date);
  * a checkpoint of either package resumes 3 Adam steps of the packed
    LM in the other, and the resumed weights match the writer's own
    continued steps at 2e-4 of max(1, max|w|) per tensor (the
    reference's multi-step bound; fp32 summed in other orders);
  * the JAX package's io cases (``tests/test_io_and_m2.py``: round trip,
    combined file, inference model, checkpoint corruption fallback;
    ``tests/test_specialize.py``: the corrupt matrix and the legacy
    directory) hold in the port;
  * the port's own rules: the load-device rule, bfloat16 blobs decoded
    bit for bit, 64-bit arrays narrowed; the transform-tier write paths
    (specialized, bf16) write the JAX package's files byte for byte.

The LM is ``transformer_lm(vocab 128, max_len 32, 2 layers, 2 heads,
d_model 64, d_inner 128, packed=True)``.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import transformer as TT

LM = dict(vocab_size=128, max_len=32, n_layer=2, n_head=2, d_model=64,
          d_inner=128)
TOL = 2e-4                 # of max(1, max|w|), per tensor, after 3 steps


def _lm(fluid, T, adam=True):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg, logits = T.transformer_lm(packed=True, **LM)
        if adam:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg)
    return main, startup, avg, logits


def _batches(n, seed=10):
    return [JT.make_lm_batch(np.random.RandomState(seed + i), 4, 32, 128)
            for i in range(n)]


def _jax_start(startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return scope


def _state(scope, names):
    return {n: np.asarray(scope.find_var(n)) for n in names
            if scope.find_var(n) is not None}


def _persistables(main):
    return [v.name for v in main.list_vars() if v.persistable]


@pytest.fixture(scope="module")
def pair():
    """The LM built by both packages, the JAX startup scope, and a port
    scope holding the same values."""
    jprog = _lm(jfluid, JT)
    tprog = _lm(tfluid, TT)
    assert jprog[0].to_json() == tprog[0].to_json()
    jscope = _jax_start(jprog[1])
    names = _persistables(jprog[0])
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, _state(jscope, names), "cpu")
    return jprog, tprog, jscope, tscope, names


# -- persistables, both forms, both directions ---------------------------

@pytest.mark.parametrize("filename", [None, "all_params"],
                         ids=["npy", "npz"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_persistables_cross_package(pair, tmp_path, filename, direction):
    jprog, tprog, jscope, tscope, names = pair
    d = str(tmp_path / "vars")
    if direction == "jax_to_port":
        jfluid.io.save_persistables(None, d, jprog[0], filename=filename,
                                    scope=jscope)
        fresh = tfluid.Scope()
        tio.load_persistables(None, d, tprog[0], filename=filename,
                              scope=fresh)
        got = {n: fresh.get_numpy(n) for n in names}
        want = _state(jscope, names)
        assert all(isinstance(fresh.find_var(n), torch.Tensor)
                   for n in names)
    else:
        tio.save_persistables(None, d, tprog[0], filename=filename,
                              scope=tscope)
        fresh = jfluid.Scope()
        jfluid.io.load_persistables(None, d, jprog[0], filename=filename,
                                    scope=fresh)
        got = _state(fresh, names)
        want = {n: tscope.get_numpy(n) for n in names}
    assert sorted(got) == sorted(names)
    for n in names:
        assert got[n].dtype == want[n].dtype, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_inference_model_files_identical(pair, tmp_path):
    """Same Program, same values: both packages write the same bytes."""
    jprog, tprog, jscope, tscope, _ = pair
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jfluid.io.save_inference_model(jd, [], [jprog[3]], None,
                                   main_program=jprog[0], scope=jscope,
                                   specialize=False, config={"a": 1})
    tio.save_inference_model(td, [], [tprog[3]], None,
                             main_program=tprog[0], scope=tscope,
                             specialize=False, config={"a": 1})
    jm, tm = (tio.load_inference_manifest(x) for x in (jd, td))
    assert jm == tm
    assert jm["model_crc32"] == tm["model_crc32"]
    assert jm["params_crc32"] == tm["params_crc32"]
    for name in ("__model__", jm["params_file"], tio.MANIFEST):
        with open(os.path.join(jd, name), "rb") as f1, \
                open(os.path.join(td, name), "rb") as f2:
            assert f1.read() == f2.read(), name


# -- checkpoints resume across the packages ------------------------------

def _jax_steps(main, avg, scope, batches):
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        return [float(exe.run(main, feed=b, fetch_list=[avg])[0])
                for b in batches]


def _port_steps(main, avg, scope, batches):
    exe = tfluid.Executor(tfluid.CPUPlace())
    return [float(exe.run(main, feed=b, fetch_list=[avg], scope=scope)[0])
            for b in batches]


def _close(got, want, names):
    for n in names:
        a, b = np.asarray(got[n], np.float64), np.asarray(want[n],
                                                          np.float64)
        lim = TOL * max(1.0, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= lim, n


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_across_packages(tmp_path, direction):
    """Two Adam steps in the writer, ``save_checkpoint``, then 3 steps
    in the other package from a fresh scope against 3 more steps in the
    writer."""
    jmain, jstart, javg, _ = _lm(jfluid, JT)
    tmain, _, tavg, _ = _lm(tfluid, TT)
    names = _persistables(jmain)
    first, more = _batches(2), _batches(3, seed=20)
    ck = str(tmp_path / "ckpt")
    jscope = _jax_start(jstart)
    if direction == "jax_to_port":
        _jax_steps(jmain, javg, jscope, first)
        jfluid.io.save_checkpoint(ck, 2, jmain, scope=jscope)
        tscope = tfluid.Scope()
        assert tio.load_checkpoint(ck, tmain, scope=tscope) == 2
        resumed = _port_steps(tmain, tavg, tscope, more)
        cont = _jax_steps(jmain, javg, jscope, more)
        got = {n: tscope.get_numpy(n) for n in names}
        want = _state(jscope, names)
    else:
        tscope = tfluid.Scope()
        tfluid.load_numpy_state(tscope, _state(jscope, names), "cpu")
        _port_steps(tmain, tavg, tscope, first)
        tio.save_checkpoint(ck, 2, tmain, scope=tscope)
        fresh = jfluid.Scope()
        assert jfluid.io.load_checkpoint(ck, jmain, scope=fresh) == 2
        resumed = _jax_steps(jmain, javg, fresh, more)
        cont = _port_steps(tmain, tavg, tscope, more)
        got = _state(fresh, names)
        want = {n: tscope.get_numpy(n) for n in names}
    np.testing.assert_allclose(resumed, cont, rtol=1e-4)
    _close(got, want, names)


def test_checkpoint_bitwise_resume_inside_the_port(tmp_path):
    """3 steps, checkpoint, 3 steps in a fresh scope == 6 uninterrupted
    steps, bitwise (chip_smoke phase 11a's check, on the CPU)."""
    main, start, avg, _ = _lm(tfluid, TT)
    names = _persistables(main)
    init = _state(_jax_start(_lm(jfluid, JT)[1]), names)
    batches = _batches(6)
    whole = tfluid.Scope()
    tfluid.load_numpy_state(whole, init, "cpu")
    want = _port_steps(main, avg, whole, batches)
    part = tfluid.Scope()
    tfluid.load_numpy_state(part, init, "cpu")
    got = _port_steps(main, avg, part, batches[:3])
    ck = str(tmp_path / "ckpt")
    tio.save_checkpoint(ck, 3, main, scope=part)
    resumed = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    assert tio.load_checkpoint(ck, main, scope=resumed, executor=exe) == 3
    got += _port_steps(main, avg, resumed, batches[3:])
    assert got == want
    for n in names:
        assert torch.equal(resumed.find_var(n), whole.find_var(n)), n


# -- the JAX package's io cases, in the port -----------------------------

def _mlp(fluid, img_dim=16, classes=4):
    x = fluid.layers.data("x", [img_dim])
    label = fluid.layers.data("label", [1], dtype="int64")
    pred = fluid.layers.fc(x, classes, act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
    return x, label, pred, loss


@pytest.fixture
def mlp():
    """An fc-softmax net with SGD, started on the CPU in its own scope."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x, label, pred, loss = _mlp(tfluid)
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(8, 16).astype(np.float32),
            "label": rng.randint(0, 4, (8, 1)).astype(np.int64)}
    return dict(main=main, exe=exe, scope=scope, pred=pred, loss=loss,
                feed=feed)


def test_save_load_params_roundtrip(mlp, tmp_path):
    m = mlp
    m["exe"].run(m["main"], feed=m["feed"], fetch_list=[m["loss"]],
                 scope=m["scope"])
    eval_prog = m["main"].prune([m["pred"]])
    before, = m["exe"].run(eval_prog, feed={"x": m["feed"]["x"]},
                           fetch_list=[m["pred"]], scope=m["scope"])
    tio.save_params(m["exe"], str(tmp_path / "model"), m["main"],
                    scope=m["scope"])
    for p in m["main"].all_parameters():
        m["scope"].set(p.name, torch.zeros_like(m["scope"].find_var(p.name)))
    tio.load_params(m["exe"], str(tmp_path / "model"), m["main"],
                    scope=m["scope"])
    after, = m["exe"].run(eval_prog, feed={"x": m["feed"]["x"]},
                          fetch_list=[m["pred"]], scope=m["scope"])
    np.testing.assert_array_equal(before, after)


def test_save_load_combined_file(mlp, tmp_path):
    m = mlp
    tio.save_persistables(m["exe"], str(tmp_path), m["main"],
                          filename="all_params", scope=m["scope"])
    assert os.path.exists(tmp_path / "all_params.npz")
    names = [p.name for p in m["main"].all_parameters()]
    orig = {n: m["scope"].get_numpy(n).copy() for n in names}
    for n in names:
        m["scope"].set(n, torch.zeros_like(m["scope"].find_var(n)))
    tio.load_persistables(m["exe"], str(tmp_path), m["main"],
                          filename="all_params", scope=m["scope"])
    for n in names:
        np.testing.assert_array_equal(m["scope"].get_numpy(n), orig[n])


def test_inference_model_roundtrip(mlp, tmp_path):
    m = mlp
    x = m["feed"]["x"][:4]
    want, = m["exe"].run(m["main"].prune([m["pred"]]), feed={"x": x},
                         fetch_list=[m["pred"]], scope=m["scope"])
    d = str(tmp_path / "infer")
    tio.save_inference_model(d, ["x"], [m["pred"]], m["exe"],
                             main_program=m["main"], scope=m["scope"],
                             specialize=False)
    fresh = tfluid.Scope()
    prog, feeds, fetches = tio.load_inference_model(d, m["exe"],
                                                    scope=fresh)
    assert feeds == ["x"]
    assert [v.name for v in fetches] == [m["pred"].name]
    got, = m["exe"].run(prog, feed={"x": x}, fetch_list=fetches,
                        scope=fresh)
    np.testing.assert_array_equal(got, want)


def test_checkpoint_atomic_and_corrupt_recovery(mlp, tmp_path):
    m = mlp
    scope = m["scope"]
    ck = str(tmp_path / "ckpt")
    tio.save_checkpoint(ck, 1, m["main"], scope=scope)
    names = [p.name for p in m["main"].all_parameters()]
    vals1 = {n: scope.get_numpy(n).copy() for n in names}
    # step 2, then corrupt it: the loader must fall back to step 1
    scope.set(names[0], scope.find_var(names[0]) + 1.0)
    tio.save_checkpoint(ck, 2, m["main"], scope=scope)
    with open(os.path.join(ck, "ckpt-2.npz"), "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    for n in names:
        scope.set(n, torch.zeros_like(scope.find_var(n)))
    assert tio.load_checkpoint(ck, m["main"], scope=scope) == 1
    np.testing.assert_array_equal(scope.get_numpy(names[0]),
                                  vals1[names[0]])
    assert tio.load_checkpoint(str(tmp_path / "none"), m["main"],
                               scope=scope) is None


def test_checkpoint_keeps_the_newest(mlp, tmp_path):
    m = mlp
    ck = str(tmp_path / "ckpt")
    for step in range(1, 6):
        tio.save_checkpoint(ck, step, m["main"], scope=m["scope"],
                            keep_last=2)
    assert sorted(os.listdir(ck)) == ["ckpt-4.npz", "ckpt-5.npz",
                                      "meta-4.json", "meta-5.json"]
    with open(os.path.join(ck, "meta-5.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 5 and meta["file"] == "ckpt-5.npz"


@pytest.fixture
def small_artifact(mlp, tmp_path):
    d = str(tmp_path / "art")
    tio.save_inference_model(d, ["x"], [mlp["pred"]], mlp["exe"],
                             main_program=mlp["main"], scope=mlp["scope"],
                             specialize=False)
    return d


def test_artifact_corrupt_matrix(small_artifact):
    """Every corruption raises ``ArtifactError`` naming the damaged
    piece (after ``tests/test_specialize.py``)."""
    d = small_artifact
    m = tio.load_inference_manifest(d)
    exe = tfluid.Executor(tfluid.CPUPlace())

    def reload():
        return tio.load_inference_model(d, exe, scope=tfluid.Scope())

    pf = os.path.join(d, m["params_file"])
    with open(pf, "rb") as f:
        blob = f.read()
    with open(pf, "wb") as f:
        f.write(blob[:-16])                         # truncated params
    with pytest.raises(tio.ArtifactError, match="params CORRUPT"):
        reload()
    flipped = bytearray(blob)
    flipped[len(flipped) // 2] ^= 0x40
    with open(pf, "wb") as f:
        f.write(bytes(flipped))                     # bit-flipped params
    with pytest.raises(tio.ArtifactError, match="params CORRUPT"):
        reload()
    with open(pf, "wb") as f:
        f.write(blob)
    reload()                                        # restored: loads

    mf = os.path.join(d, m["model_file"])
    with open(mf, "rb") as f:
        model_bytes = f.read()
    os.unlink(mf)
    with pytest.raises(tio.ArtifactError, match="program missing"):
        reload()
    with open(mf, "wb") as f:
        f.write(model_bytes[:-4] + b"xxxx")
    with pytest.raises(tio.ArtifactError, match="program CORRUPT"):
        reload()
    with open(mf, "wb") as f:
        f.write(model_bytes)

    man = os.path.join(d, tio.MANIFEST)
    with open(man, "rb") as f:
        man_bytes = f.read()
    with open(man, "wb") as f:
        f.write(man_bytes[:-8])                     # torn manifest
    with pytest.raises(tio.ArtifactError, match="manifest"):
        reload()
    with open(man, "wb") as f:
        f.write(man_bytes)
    reload()
    with pytest.raises(tio.ArtifactError, match="not a serving artifact"):
        tserving.model_from_artifact(d + "-nope", device="cpu")


def test_artifact_legacy_dir_still_loads(mlp, tmp_path):
    """A pre-manifest directory (Program JSON + one .npy per var) loads
    through the legacy path."""
    m = mlp
    d = str(tmp_path / "legacy")
    os.makedirs(d)
    prog = tio.get_inference_program([m["pred"]], m["main"])
    dd = prog.to_dict()
    dd["feed_names"], dd["fetch_names"] = ["x"], [m["pred"].name]
    with open(os.path.join(d, "__model__"), "w") as f:
        json.dump(dd, f)
    tio.save_persistables(m["exe"], d, prog, scope=m["scope"])
    fresh = tfluid.Scope()
    prog2, feeds, fetches = tio.load_inference_model(d, m["exe"],
                                                     scope=fresh)
    assert feeds == ["x"] and [v.name for v in fetches] == [m["pred"].name]
    assert isinstance(fresh.find_var("fc_0.w_0"), torch.Tensor)


# -- the port's own rules ------------------------------------------------

def test_load_device_rule(mlp, tmp_path):
    """Executor's device when given; else the device of the value the
    name holds; else the CPU. A 'meta' tensor stands in for a card."""
    m = mlp
    d = str(tmp_path / "vars")
    tio.save_persistables(None, d, m["main"], scope=m["scope"])
    name = "fc_0.w_0"
    held = tfluid.Scope()
    held.set(name, torch.empty(16, 4, device="meta"))
    tio.load_persistables(None, d, m["main"], scope=held)
    assert held.find_var(name).device.type == "meta"
    assert held.find_var("fc_0.b_0").device.type == "cpu"
    tio.load_persistables(m["exe"], d, m["main"], scope=held)
    assert held.find_var(name).device.type == "cpu"


def test_bf16_blobs_decode_bitwise_and_uint16_is_refused():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 16, (3, 5)).astype(np.uint16)
    t = tio._bf16(bits)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                          bits)
    with pytest.raises((TypeError, ValueError)):
        tfluid.core.scope.to_tensor(bits, "cpu")


@pytest.mark.parametrize("filename", [None, "all"], ids=["npy", "npz"])
def test_bf16_values_save_as_the_jax_package_does(tmp_path, filename):
    """A bfloat16 scope value (an AMP model's, a bf16 artifact's
    weights) is written as its raw 2-byte records, the records the JAX
    package's np.save writes for a bfloat16 array (numpy holds no
    bfloat16; only the header's byte-order mark differs, '|V2' against
    ml_dtypes' '<V2'). The port loads both packages' files back as
    bfloat16 bit for bit."""
    import ml_dtypes
    bits = np.random.default_rng(1).integers(
        0, 2 ** 15, (3, 4)).astype(np.uint16)      # finite, positive
    prog = tfluid.Program()
    prog.global_block().create_var(name="w", shape=(3, 4),
                                   dtype="bfloat16", persistable=True)
    jprog = jfluid.Program()
    jprog.global_block().create_var(name="w", shape=(3, 4),
                                    dtype="bfloat16", persistable=True)
    held = tfluid.Scope()
    held.set("w", tio._bf16(bits))
    jscope = jfluid.Scope()
    jscope.set("w", bits.view(ml_dtypes.bfloat16))
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    tio.save_persistables(None, td, prog, filename=filename, scope=held)
    with jfluid.scope_guard(jscope):
        jfluid.io.save_persistables(None, jd, jprog, filename=filename,
                                    scope=jscope)
    for d in (td, jd):
        if filename is None:
            raw = np.load(os.path.join(d, "w.npy"))
        else:
            with np.load(os.path.join(d, filename + ".npz")) as z:
                raw = z["w"]
        assert raw.dtype.itemsize == 2 and raw.dtype.kind == "V"
        assert raw.tobytes() == bits.tobytes()
        back = tfluid.Scope()
        tio.load_persistables(None, d, prog, filename=filename, scope=back)
        assert back.find_var("w").dtype == torch.bfloat16
        assert torch.equal(back.find_var("w"), held.find_var("w"))


def test_64bit_arrays_load_narrowed(tmp_path):
    ck = str(tmp_path / "ckpt")
    tio.write_checkpoint_arrays(ck, 1, {
        "a": np.arange(4, dtype=np.int64),
        "b": np.linspace(0, 1, 3, dtype=np.float64)})
    scope = tfluid.Scope()
    assert tio.load_checkpoint(ck, tfluid.Program(), scope=scope) == 1
    assert scope.find_var("a").dtype == torch.int32
    assert scope.find_var("b").dtype == torch.float32
    assert scope.find_var("a").tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("kw", [{"specialize": True}, {"bf16": True}])
def test_transform_write_paths_raise(tmp_path, kw):
    """The transform tier's write paths (refused before it was ported):
    the specialized artifact (the default) and the bf16 one, written by
    both packages from the same Program and values, are the same files
    byte for byte; the port loads the bf16 one with its weights
    bfloat16."""
    progs, scopes = [], []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x, label, pred, loss = _mlp(fluid)
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        progs.append((main, startup, pred))
    jmain, jstart, jpred = progs[0]
    tmain, _, tpred = progs[1]
    jscope = _jax_start(jstart)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, _state(jscope, _persistables(jmain)),
                            "cpu")
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(jd, ["x"], [jpred], None,
                                       main_program=jmain, scope=jscope,
                                       **kw)
    tio.save_inference_model(td, ["x"], [tpred], None, main_program=tmain,
                             scope=tscope, **kw)
    for f in ("__model__", "__params__.npz", tio.MANIFEST):
        with open(os.path.join(jd, f), "rb") as a, \
                open(os.path.join(td, f), "rb") as b:
            assert a.read() == b.read(), f
    held = tfluid.Scope()
    prog, _, _ = tio.load_inference_model(td, None, scope=held)
    assert "fused_matmul_bias_act" in [op.type for op in
                                       prog.global_block().ops]
    w = held.find_var("fc_0.w_0")
    assert w.dtype == (torch.bfloat16 if kw.get("bf16") else torch.float32)


def test_jax_specialized_artifact_loads_in_the_port(tmp_path):
    """The JAX package's default artifact holds fused op types the port
    has no lowering for; the port parses the Program and loads the
    params."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        _, _, pred, _ = _mlp(jfluid)
    scope = _jax_start(startup)
    d = str(tmp_path / "spec")
    jfluid.io.save_inference_model(d, ["x"], [pred], None,
                                   main_program=main, scope=scope)
    fresh = tfluid.Scope()
    prog, feeds, fetches = tio.load_inference_model(d, None, scope=fresh)
    assert [op.type for op in prog.global_block().ops] == [
        "fused_matmul_bias_act"]
    assert feeds == ["x"] and [v.name for v in fetches] == [pred.name]
    for n in ("fc_0.w_0", "fc_0.b_0"):
        np.testing.assert_array_equal(fresh.get_numpy(n),
                                      np.asarray(scope.find_var(n)))
