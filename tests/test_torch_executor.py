"""The port's Executor, autograd and optimizers against the JAX package.

Each parity test builds one model in both packages (the same Program:
see test_torch_program.py), runs the JAX package's startup program, puts
those values into a port scope with ``load_numpy_state`` (torch and jax
draw different random numbers from one seed), and compares fetches.
Everything runs on the CPU (``CPUPlace``): the port's plain PyTorch
versions stand where the CUDA kernels run on the card (where
``chip_smoke.py`` trains the full-width model with TF32 switched off,
so fp32 GEMMs stay fp32 as here). Tolerances:
rtol 1e-5 for one forward (same fp32 ops, other summation order), and
for 3 optimizer steps 2e-4 of max(1, max|w|) per tensor, the
reference's own multi-step bound (``__graft_entry__.py:154``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.lod import LoDTensor
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.ops import flash_attention as TF

SMALL = dict(vocab_size=64, max_len=16, n_layer=2, n_head=2, d_model=32,
             d_inner=64)
ENTRY = dict(vocab_size=256, max_len=32, n_layer=2, n_head=4, d_model=64,
             d_inner=128)          # __graft_entry__.entry()'s model


def build(fluid, T, cfg, packed=False, opt=None, grads=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _ = T.transformer_lm(packed=packed, **cfg)
        pgrads = []
        if opt == "adam":
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        elif opt == "sgd":
            fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
        elif grads:
            pgrads = fluid.append_backward(avg_cost)
    return main, startup, avg_cost, pgrads


def jax_start(startup):
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
    state = {n: np.asarray(scope.find_var(n))
             for n in scope.local_var_names()
             if scope.find_var(n) is not None}
    return scope, exe, state


def port_scope(state):
    scope = tfluid.Scope()
    tfluid.load_numpy_state(scope, state, "cpu")
    return scope


def test_entry_program_loss_matches():
    jmain, jstart, javg, _ = build(jfluid, JT, ENTRY)
    tmain, _, tavg, _ = build(tfluid, TT, ENTRY)
    jscope, jexe, state = jax_start(jstart)
    feed = JT.make_lm_batch(np.random.RandomState(0), 4, 32, 256)
    with jfluid.scope_guard(jscope):
        ref, = jexe.run(jmain, feed=feed, fetch_list=[javg])
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tavg], scope=port_scope(state))
    assert got.shape == () and np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_fetched_param_grads_match(packed):
    """append_backward in both packages: every P@GRAD, with the loss."""
    jmain, jstart, javg, jg = build(jfluid, JT, SMALL, packed, grads=True)
    tmain, _, tavg, tg = build(tfluid, TT, SMALL, packed, grads=True)
    names = [g.name for _, g in tg]
    assert names == [g.name for _, g in jg] and "lm_word_emb@GRAD" in names
    assert "lm_pos_emb@GRAD" not in names        # trainable=False
    jscope, jexe, state = jax_start(jstart)
    feed = JT.make_lm_batch(np.random.RandomState(1), 4, 16, 64)
    fetch = [javg.name, javg.name + "@GRAD"] + names
    with jfluid.scope_guard(jscope):
        ref = jexe.run(jmain, feed=feed, fetch_list=fetch)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=fetch, scope=port_scope(state))
    for name, a, b in zip(fetch, got, ref):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a / scale, b / scale, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _max_rel(w1, w2):
    return max(float(np.abs(w1[n] - w2[n]).max())
               / max(1.0, float(np.abs(w1[n]).max())) for n in w1)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_three_steps_match_jax(packed, opt):
    jmain, jstart, javg, _ = build(jfluid, JT, SMALL, packed, opt)
    tmain, _, tavg, _ = build(tfluid, TT, SMALL, packed, opt)
    jscope, jexe, state = jax_start(jstart)
    tscope = port_scope(state)
    texe = tfluid.Executor(tfluid.CPUPlace())
    for i in range(3):
        feed = JT.make_lm_batch(np.random.RandomState(10 + i), 4, 16, 64)
        with jfluid.scope_guard(jscope):
            ref, = jexe.run(jmain, feed=feed, fetch_list=[javg])
        got, = texe.run(tmain, feed=feed, fetch_list=[tavg], scope=tscope)
        assert abs(float(got) - float(ref)) <= 2e-4 * max(1.0, abs(ref))
    jw = {n: np.asarray(jscope.find_var(n)) for n in state}
    tw = {n: tscope.get_numpy(n) for n in state}
    assert _max_rel(jw, tw) <= 2e-4
    # the optimizer really moved the weights, and the beta powers
    # advanced once per step
    assert _max_rel(jw, state) > 1e-3
    if opt == "adam":
        pows = [n for n in state if "beta1_pow_acc" in n]
        assert pows and all(np.allclose(tw[n], 0.9 ** 4) for n in pows)


def test_packed_runs_sp_attention_through_flash_attention():
    """On CPU tensors the sp_attention lowering takes the plain version:
    the training step never counts a kernel launch."""
    tmain, tstart, tavg, _ = build(tfluid, TT, SMALL, True, "adam")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(tstart, scope=scope)
    before = dict(TF.flash_attention.launches)
    feed = JT.make_lm_batch(np.random.RandomState(2), 4, 16, 64)
    exe.run(tmain, feed=feed, fetch_list=[tavg], scope=scope)
    assert TF.flash_attention.launches == before


def test_unused_parameter_gets_zero_grad():
    """A parameter the loss does not reach gets a zero gradient, as
    jax.grad gives (torch.autograd returns None for it)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4])
        used = tfluid.layers.fc(x, 3)
        tfluid.layers.fc(x, 5)                    # never reaches the loss
        loss = tfluid.layers.reduce_sum(used)
        pg = tfluid.append_backward(loss)
    names = [g.name for _, g in pg]
    assert names == ["fc_0.w_0@GRAD", "fc_0.b_0@GRAD", "fc_1.w_0@GRAD",
                     "fc_1.b_0@GRAD"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    xs = np.arange(8, dtype=np.float32).reshape(2, 4)
    gw0, gb0, gw1, gb1, lg = exe.run(
        main, feed={"x": xs}, fetch_list=names + [loss.name + "@GRAD"],
        scope=scope)
    np.testing.assert_allclose(gw0, np.repeat(xs.sum(0)[:, None], 3, 1))
    np.testing.assert_allclose(gb0, np.full(3, 2.0))
    assert not gw1.any() and not gb1.any() and gw1.shape == (4, 5)
    assert float(lg) == 1.0


def _startup_values(seed, runs=1):
    main, startup = tfluid.Program(), tfluid.Program()
    startup.random_seed = seed
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        TT.transformer_lm(vocab_size=1024, max_len=16, n_layer=1, n_head=2,
                          d_model=64, d_inner=128)
    exe = tfluid.Executor(tfluid.CPUPlace())
    for _ in range(runs):
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
    return {n: scope.get_numpy(n) for n in scope.local_var_names()}


def test_startup_draws_deterministic_and_distributed():
    """The port's initializers draw from torch generators (they cannot
    match jax's threefry draw for draw): the same seed and run count give
    the same values, another seed or a later run of the same executor
    other values, and the draws follow the initializers' laws."""
    a, b = _startup_values(7), _startup_values(7)
    assert all(np.array_equal(a[n], b[n]) for n in a)
    other = _startup_values(8)
    later = _startup_values(7, runs=2)
    emb = "lm_word_emb"
    assert not np.array_equal(a[emb], other[emb])
    assert not np.array_equal(a[emb], later[emb])
    # Normal(0, d_model**-0.5) over 1024 x 64 draws: mean within 4
    # standard errors, std within 2%
    w = a[emb]
    assert abs(w.mean()) < 4 * 64 ** -0.5 / np.sqrt(w.size)
    assert abs(w.std() / 64 ** -0.5 - 1) < 0.02
    # Xavier uniform [64, 64]: within +-sqrt(6 / 128), std limit/sqrt(3)
    x = a["fc_0.w_0"]
    limit = np.sqrt(6.0 / 128)
    assert np.abs(x).max() <= limit
    assert abs(x.std() / (limit / np.sqrt(3)) - 1) < 0.05
    # the position table is the exact sinusoid table, biases are zero
    np.testing.assert_array_equal(a["lm_pos_emb"],
                                  TT.position_encoding_init(16, 64))
    assert not a["fc_4.b_0"].any()


def test_executor_without_a_place_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    for place in (None, tfluid.CUDAPlace(0), tfluid.TPUPlace(0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfluid.Executor(place)
    assert tfluid.Executor(tfluid.CPUPlace()).device.type == "cpu"
    assert isinstance(tfluid.TPUPlace(0), tfluid.CUDAPlace)


def _small_step():
    tmain, tstart, tavg, _ = build(tfluid, TT, SMALL, True, "sgd")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(tstart, scope=scope)
    feed = JT.make_lm_batch(np.random.RandomState(3), 4, 16, 64)
    return exe, tmain, tavg, scope, feed


@pytest.mark.parametrize("flag", ["transform", "monitor"])
def test_left_out_flags_raise(flag, monkeypatch):
    """``transform`` is not ported and raises, naming ROADMAP.md. The
    monitor is ported: its flag arms it (``maybe_enable_from_flags``,
    which the package runs at import) and the run reports its step."""
    from paddle_tpu_torch import monitor
    exe, main, avg, scope, feed = _small_step()
    monkeypatch.setenv("PADDLE_TPU_" + flag.upper(), "1")
    assert tflags.get_flag(flag)
    if flag == "transform":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            exe.run(main, feed=feed, fetch_list=[avg], scope=scope)
        return
    monitor.maybe_enable_from_flags()
    try:
        assert monitor.enabled()
        before = monitor.summary()["steps"]
        exe.run(main, feed=feed, fetch_list=[avg], scope=scope)
        assert monitor.summary()["steps"] == before + 1
    finally:
        monitor.disable()


def test_left_out_features_raise():
    """What the port leaves out raises (the left-out flag: the test
    above). LoD feeds, which raised
    here before, are ported (tests/test_torch_lod.py): a LoD src whose
    lengths cover its rows gives the dense step's loss through run(), and
    run_steps takes a list of such feeds."""
    exe, main, avg, scope, feed = _small_step()
    state = {n: scope.get_numpy(n) for n in scope.local_var_names()}
    lod = dict(feed, src=LoDTensor(feed["src"], [[0, 1, 4]]))
    losses = []
    for f in (feed, lod):
        s = tfluid.Scope()
        tfluid.load_numpy_state(s, state, "cpu")
        losses.append(exe.run(main, feed=f, fetch_list=[avg], scope=s)[0])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    out = exe.run_steps(main, feeds=[lod, lod], fetch_list=[avg],
                        scope=scope)
    assert len(out) == 2 and all(np.isfinite(o[0]) for o in out)
    # the LM's three training options are ported now: each builds the
    # op it stands for (tests/test_torch_recompute.py and
    # tests/test_torch_dropout.py run them)
    for kw, op_type in ((dict(recompute=True), "recompute_block"),
                        (dict(dropout_rate=0.1), "dropout"),
                        (dict(label_smooth_eps=0.1), "label_smooth")):
        prog, start = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(prog, start):
            TT.transformer_lm(**dict(SMALL, **kw))
        assert op_type in {op.type for op in prog.global_block().ops}


def test_host_ops_and_markers_raise():
    """The wire's host ops are ported (tests/test_torch_pserver.py runs
    them); a CUDA graph cannot hold one, so ``run_steps`` refuses a
    program that has one, with the JAX package's message."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    prog = tfluid.Program()
    prog.global_block().append_op(type="send", inputs={}, outputs={})
    with pytest.raises(NotImplementedError, match="host \\(IO\\) ops"):
        exe.run_steps(prog, feeds=[{}], scope=tfluid.Scope())
    # the grad markers' rematerialization and calc_gradient are ported
    # now: checkpoint=True gives the plain gradients, and a bare
    # calc_gradient_marker (no targets, no inputs) runs and binds nothing
    grads = {}
    for ckpt in (False, True):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup), \
                tfluid.unique_name.guard():
            x = tfluid.layers.data("x", [4])
            loss = tfluid.layers.reduce_sum(tfluid.layers.fc(x, 2))
            pg = tfluid.append_backward(loss, checkpoint=ckpt)
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        scope.set("fc_0.w_0", torch.ones(4, 2))
        grads[ckpt] = exe.run(main, feed={"x": np.ones((1, 4), np.float32)},
                              fetch_list=[g for _, g in pg], scope=scope)
    for a, b in zip(grads[True], grads[False]):
        np.testing.assert_array_equal(a, b)
    marker = tfluid.Program()
    marker.global_block().append_op(type="calc_gradient_marker")
    assert exe.run(marker, scope=tfluid.Scope()) == []


def test_sp_attention_on_a_mesh_raises():
    """It no longer raises: the parallel tier is ported. On a mesh whose
    sp axis holds one rank the op is flash attention over the whole
    sequence, as without a mesh (ring and Ulysses over more ranks are
    tests/test_torch_parallel_ranks.py's)."""
    from paddle_tpu_torch import parallel
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        q = tfluid.layers.data("q", [2, 8, 8], append_batch_size=True)
        tfluid.layers.sequence_parallel_attention(q, q, q, causal=True)
    op = main.global_block().ops[-1]
    t = torch.randn((1, 2, 8, 8), generator=torch.Generator().manual_seed(0))
    outs = []
    for mesh in (None, parallel.make_mesh({"dp": 1, "sp": 1}, "cpu")):
        ctx = registry.LowerContext({"q": t}, torch.device("cpu"),
                                    mesh=mesh)
        registry.lookup("sp_attention").lower(ctx, op)
        outs.append(ctx.get(op.output("Out")[0]))
    assert torch.equal(outs[0], outs[1])
