"""The port's model zoo against the JAX package: mlp, cnn, cnn_infer,
VGG-16, DeepFM (tests/test_torch_deepfm.py trains it), ssd
(tests/test_torch_ssd.py trains it) and the encoder-decoder MT
transformer.

* Every ``TRANSFORM_ZOO`` entry the port builds gives the JAX package's
  ``Program.to_json()`` (main and startup), built only; the port builds
  every entry of the JAX package's zoo.
* Three training steps of mlp, cnn, VGG-16 and the MT model (packed and
  unpacked, with padded masks) start both packages from one startup scope
  (the JAX package's, copied in with ``load_numpy_state``) and hold the
  losses at rtol 2e-4 and every parameter at 2e-4 of max(1, max|w|), the
  reference's multi-step bound (``__graft_entry__.py:154``); so does the
  MoE LM (``transformer_moe``, SGD added to the zoo's forward). VGG's dropout
  draws cannot be compared draw for draw (threefry against the port's
  Philox), so both Programs have every ``dropout_prob`` set to 0 first;
  VGG trains with Momentum at batch 8 (``_vgg_spec`` says why), its
  first step held at 2e-4 and its next two within twice what the JAX
  package parts from itself after a 1e-7 perturbation
  (``test_vgg_steps_match_jax`` says why).
* The ``cnn_infer`` forward on a uint8 batch matches at rtol 1e-5 /
  atol 1e-6.
* VGG with its dropout: ``run_steps(K=3)`` equals 3 ``run()`` calls,
  bitwise, on one thread (CPU PyTorch reduces in thread order).

Everything runs on the CPU; ``chip_smoke.py`` (phase 13) trains mlp, cnn,
VGG-16 and the MT model on the card.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models as JM
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.models as TM
from paddle_tpu_torch import nets
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models import vgg as TV

BUILT = ["mlp", "cnn", "cnn_infer", "resnet", "vgg", "deepfm", "ssd",
         "transformer", "transformer_moe", "transformer_mt"]
STEP_RTOL = 2e-4


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _staged(pkg, models, name):
    with pkg.unique_name.guard():
        return models.transform_zoo_entry(name)


@pytest.mark.parametrize("name", BUILT)
def test_to_json_identical(name):
    jmain, jstart, _, jfetch = _staged(jfluid, JM, name)
    tmain, tstart, _, tfetch = _staged(tfluid, TM, name)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    assert tfetch == jfetch


def test_every_jax_zoo_entry_is_built():
    assert sorted(TM.TRANSFORM_ZOO) == sorted(JM.TRANSFORM_ZOO)
    with pytest.raises(KeyError, match="unknown"):
        TM.transform_zoo_entry("no_such_model")


def test_transformer_moe_trains_like_jax(one_thread):
    """The MoE zoo entry (``sparse_moe`` FFNs, the dense fallback's
    routing) with SGD added to both staged programs: three steps from the
    JAX package's startup scope, the loss (with the aux loss) at rtol
    2e-4 and every parameter within 2e-4 of max(1, max|w|)."""
    progs = []
    for pkg, models in ((jfluid, JM), (tfluid, TM)):
        main, startup, feeds, fetch = _staged(pkg, models,
                                              "transformer_moe")
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            pkg.optimizer.SGD(learning_rate=0.5).minimize(
                main.global_block().var(fetch[0]))
        progs.append((main, startup, feeds, fetch))
    (jmain, jstart, feeds, fetch), (tmain, _, _, tfetch) = progs
    assert tmain.to_json() == jmain.to_json() and tfetch == fetch
    assert "moe_ffn" in [op.type for op in tmain.global_block().ops]
    jscope, jexe, state = _jax_start(jstart)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    for i in range(3):
        feed = feeds(np.random.RandomState(60 + i))
        with jfluid.scope_guard(jscope):
            ref, = jexe.run(jmain, feed=feed, fetch_list=fetch)
        got, = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=STEP_RTOL)
    params = [p.name for p in tmain.global_block().all_parameters()]
    assert _worst(params, tscope.get_numpy, jscope) <= STEP_RTOL
    assert _worst(params, lambda n: state[n], jscope) > 1e-4


def test_nets_pieces_build_the_jax_ops():
    """glu, scaled_dot_product_attention and sequence_conv_pool emit the
    JAX package's Program (main and startup)."""
    def build(pkg, nets_mod):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", [6, 8])
            nets_mod.glu(x, dim=-1)
            nets_mod.scaled_dot_product_attention(x, x, x, num_heads=2)
        return main
    from paddle_tpu import nets as jnets
    assert build(tfluid, nets).to_json() == build(jfluid, jnets).to_json()
    jmain, jstart, _ = _seq_conv_pool_net(jfluid, jnets)
    tmain, tstart, _ = _seq_conv_pool_net(tfluid, nets)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    assert [op.type for op in tmain.global_block().ops] == [
        "sequence_conv", "elementwise_add", "sigmoid", "sequence_pool"]


def _seq_conv_pool_net(pkg, nets_mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [5], lod_level=1)
        out = nets_mod.sequence_conv_pool(x, num_filters=4, filter_size=3)
    return main, startup, out


def test_sequence_conv_pool_matches_jax():
    """The forward over a LoD feed of 3 sequences (lengths 4, 1, 6)
    from the JAX package's startup values, at rtol 1e-5."""
    from paddle_tpu import nets as jnets
    rng = np.random.RandomState(5)
    lens = [4, 1, 6]
    data = rng.randn(sum(lens), 5).astype(np.float32)
    jmain, jstart, jout = _seq_conv_pool_net(jfluid, jnets)
    tmain, _, tout = _seq_conv_pool_net(tfluid, nets)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        want, = jexe.run(jmain, feed={"x": jfluid.create_lod_tensor(
            data, [lens])}, fetch_list=[jout])
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable
             and jscope.find_var(v.name) is not None}
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={"x": tfluid.create_lod_tensor(data, [lens])},
        fetch_list=[tout], scope=tscope)
    assert np.asarray(got).shape == (3, 4)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_glu_and_attention_match_jax():
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(2, 6, 8).astype(np.float32)}

    def run(pkg, nets_mod, jax_side):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", [6, 8])
            outs = [nets_mod.glu(x, dim=-1),
                    nets_mod.scaled_dot_product_attention(x, x, x,
                                                          num_heads=2)]
        if jax_side:
            with pkg.scope_guard(pkg.Scope()):
                return pkg.Executor(pkg.CPUPlace()).run(
                    main, feed=feed, fetch_list=outs)
        return pkg.Executor(pkg.CPUPlace()).run(
            main, feed=feed, fetch_list=outs, scope=pkg.Scope())
    from paddle_tpu import nets as jnets
    for got, ref in zip(run(tfluid, nets, False), run(jfluid, jnets, True)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


# --------------------------------------------------------------------------
# three training steps against the JAX package

def _mt_spec(packed):
    """The MT model at the zoo's size with Adam and padded masks."""
    vocab, max_len = 64, 16

    def build(pkg, T):
        avg_cost, _ = T.transformer(
            src_vocab_size=vocab, trg_vocab_size=vocab, max_len=max_len,
            n_layer=2, n_head=2, d_model=32, d_inner=64, packed=packed)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        return (avg_cost,)

    def feeds(rng):
        return TT.mt_feeds(TT.make_lm_batch(rng, 3, max_len, vocab),
                           TT.make_lm_batch(rng, 3, max_len, vocab))
    return build, feeds


def _vgg_spec():
    """VGG-16 (``vgg16_bn_drop``) with Momentum, batch 8. The zoo's VGG
    step trains with Adam, whose first update is lr * g / (|g| + eps) per
    element: VGG's conv biases sit before a batch norm, so their true
    gradient is 0 and each package steps them by +-lr on the sign of its
    own rounding noise. The layers' math is what is compared here, so the
    optimizer is one whose update is proportional to the gradient. Batch
    2 (the zoo's) puts the batch norm after fc_0 over two samples, which
    maps each feature to about +-1 and turns rounding into percents."""
    def build(pkg, V):
        image = pkg.layers.data("data", [3, 32, 32])
        label = pkg.layers.data("label", [1], dtype="int64")
        predict = V.vgg16_bn_drop(image, 10)
        avg_cost = pkg.layers.mean(pkg.layers.cross_entropy(predict, label))
        pkg.optimizer.Momentum(learning_rate=0.01,
                               momentum=0.9).minimize(avg_cost)
        return (avg_cost,)

    def feeds(rng):
        return {"data": rng.rand(8, 3, 32, 32).astype("float32"),
                "label": rng.randint(0, 10, (8, 1)).astype("int64")}
    return build, feeds


def _programs(name, pkg, models):
    if name == "vgg":
        from paddle_tpu.models import vgg as JV
        build, feeds = _vgg_spec()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = build(pkg, TV if pkg is tfluid else JV)
        _zero_dropout(main)
        return main, startup, feeds, [v.name for v in fetch]
    if name.startswith("mt_"):
        from paddle_tpu.models import transformer as JT
        build, feeds = _mt_spec(name == "mt_packed")
        T = TT if pkg is tfluid else JT
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = build(pkg, T)
        return main, startup, feeds, [v.name for v in fetch]
    return _staged(pkg, models, name)


def _zero_dropout(main):
    """Every dropout op of ``main`` at dropout_prob 0 (the same change on
    both sides; a draw at p = 0 keeps every element in both packages)."""
    ops = [op for op in main.global_block().ops if op.type == "dropout"]
    assert ops
    for op in ops:
        op.attrs["dropout_prob"] = 0.0


def _jax_start(jstart):
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(jstart)
    state = {n: np.asarray(scope.find_var(n))
             for n in scope.local_var_names()
             if scope.find_var(n) is not None}
    return scope, exe, state


def _worst(params, scope_of, ref):
    """The largest |w - w_ref| / max(1, max|w_ref|) over ``params``."""
    out = 0.0
    for n in params:
        jw = np.asarray(ref.find_var(n))
        out = max(out, float(np.abs(scope_of(n) - jw).max())
                  / max(1.0, float(np.abs(jw).max())))
    return out


@pytest.mark.parametrize("name", ["mlp", "cnn", "mt_packed",
                                  "mt_unpacked"])
def test_three_steps_match_jax(name):
    jmain, jstart, feeds, fetch = _programs(name, jfluid, JM)
    tmain, _, _, tfetch = _programs(name, tfluid, TM)
    assert tfetch == fetch
    jscope, jexe, state = _jax_start(jstart)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    for i in range(3):
        feed = feeds(np.random.RandomState(30 + i))
        with jfluid.scope_guard(jscope):
            ref = jexe.run(jmain, feed=feed, fetch_list=fetch)
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, np.asarray(r), rtol=STEP_RTOL)
    params = [p.name for p in tmain.global_block().all_parameters()]
    for n in params:
        jw = np.asarray(jscope.find_var(n))
        scale = max(1.0, float(np.abs(jw).max()))
        assert float(np.abs(tscope.get_numpy(n) - jw).max()) \
            <= STEP_RTOL * scale, n
    moved = _worst(params, lambda n: state[n], jscope)
    assert moved > 1e-4            # the steps really moved the weights


def test_vgg_steps_match_jax():
    """VGG-16 (dropout zeroed, Momentum, batch 8). The first step (one
    forward, every layer's gradient, one update) is held at 2e-4 like the
    other models. Over three steps VGG-16 is chaotic at these batch
    sizes: batch norms over a few values per channel (2x2 maps in the
    last group, 8 samples after fc_0) amplify rounding, and the JAX
    package started from its own scope perturbed by 1e-7 relative (the
    control) parts from itself by about 1e-3 by step 3. So steps 2 and 3
    are held to twice what the control parts by, losses and weights."""
    jmain, jstart, feeds, fetch = _programs("vgg", jfluid, JM)
    tmain, _, _, _ = _programs("vgg", tfluid, TM)
    jscope, jexe, state = _jax_start(jstart)
    cscope = jfluid.Scope()
    noise = np.random.RandomState(1)
    for n, v in state.items():
        v = np.array(v)
        if v.dtype == np.float32:
            v = (v * (1 + 1e-7 * noise.randn(*v.shape))).astype(np.float32)
        cscope.set(n, v)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    params = [p.name for p in tmain.global_block().all_parameters()]
    for i in range(3):
        feed = feeds(np.random.RandomState(30 + i))
        with jfluid.scope_guard(jscope):
            ref = float(np.asarray(jexe.run(jmain, feed=feed,
                                            fetch_list=fetch)[0]))
        with jfluid.scope_guard(cscope):
            ctl = float(np.asarray(jexe.run(jmain, feed=feed,
                                            fetch_list=fetch)[0]))
        got = float(texe.run(tmain, feed=feed, fetch_list=fetch,
                             scope=tscope)[0])
        port = _worst(params, tscope.get_numpy, jscope)
        control = _worst(params, lambda n: np.asarray(cscope.find_var(n)),
                         jscope)
        if i == 0:
            assert got == pytest.approx(ref, rel=STEP_RTOL)
            assert port <= STEP_RTOL, port
        else:
            assert control > 1e-6          # the control parts
            assert abs(got - ref) <= 2 * max(abs(ctl - ref), 1e-6 * ref)
            assert port <= 2 * control, (i, port, control)
    assert _worst(params, lambda n: state[n], jscope) > 1e-4


def test_cnn_infer_uint8_forward_matches_jax():
    jmain, jstart, feeds, fetch = _programs("cnn_infer", jfluid, JM)
    tmain, _, _, _ = _programs("cnn_infer", tfluid, TM)
    assert [op.type for op in tmain.global_block().ops][:2] == [
        "cast", "scale"]
    jscope, jexe, state = _jax_start(jstart)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    feed = feeds(np.random.RandomState(5))
    assert feed["img"].dtype == np.uint8
    with jfluid.scope_guard(jscope):
        ref, = jexe.run(jmain, feed=feed, fetch_list=fetch)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got, = exe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    # the feed stays uint8 up to the cast
    cast = tmain.global_block().ops[0]
    x = exe._feed_tensor("img", feed["img"])
    assert x.dtype == torch.uint8 and cast.attr("in_dtype") == "uint8"


@pytest.mark.parametrize("in_dtype, out_dtype", [
    ("uint8", "float32"), ("float32", "int32"), ("int32", "float32")])
def test_cast_matches_jax(in_dtype, out_dtype):
    x = (np.random.RandomState(6).randn(3, 5) * 50).astype(in_dtype)

    def run(pkg, jax_side):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            v = pkg.layers.data("x", [5], dtype=in_dtype)
            out = pkg.layers.cast(v, out_dtype)
        if jax_side:
            with pkg.scope_guard(pkg.Scope()):
                return np.asarray(pkg.Executor(pkg.CPUPlace()).run(
                    main, feed={"x": x}, fetch_list=[out])[0])
        return pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"x": x}, fetch_list=[out], scope=pkg.Scope())[0]
    got, ref = run(tfluid, False), run(jfluid, True)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_vgg_dropout_run_steps_equals_runs_bitwise(one_thread):
    """VGG-16 with its dropouts (on the CPU, the dropout kernel's plain
    version): one run_steps(K=3) dispatch draws and computes what 3
    run() calls do."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        _, _, avg, _ = TV.build_train_net(image_shape=(3, 32, 32))
    assert sum(op.type == "dropout" for op in main.global_block().ops) == 10
    init = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=init)
    names = init.local_var_names()
    rng = np.random.RandomState(7)
    batches = [{"data": rng.rand(2, 3, 32, 32).astype(np.float32),
                "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
               for _ in range(3)]

    def copy():
        scope = tfluid.Scope()
        for n in names:
            scope.set(n, init.find_var(n).clone())
        return scope
    s1, s2 = copy(), copy()
    exe = tfluid.Executor(tfluid.CPUPlace())
    eager = [float(exe.run(main, feed=b, fetch_list=[avg], scope=s1)[0])
             for b in batches]
    mega = [float(o[0]) for o in tfluid.Executor(tfluid.CPUPlace())
            .run_steps(main, feeds=batches, fetch_list=[avg], scope=s2)]
    assert mega == eager
    for n in names:
        assert torch.equal(s1.find_var(n), s2.find_var(n)), n
    # the draws are real: another seed gives another first loss
    main.random_seed = 5
    other = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=batches[0], fetch_list=[avg], scope=copy())
    assert float(other[0]) != eager[0]
