"""The port's AMP (``paddle_tpu_torch/amp.py``) against the JAX package's.

Twins of ``tests/test_amp.py``'s three tests (a small convnet trained
under ``amp_guard`` keeps every persistable fp32, moves its numerics off
the fp32 run and stays within bf16 reach of it; the guard scopes and
restores), then against the JAX package on the same numpy-seeded inputs:

  * the matmul-class products under AMP (``mul``, ``matmul`` with a
    transpose and an alpha, ``conv2d``, ``depthwise_conv2d``,
    ``conv2d_transpose``): bfloat16 results in both packages, within
    2^-7 of max(1, |x|) (one bfloat16 rounding apart), and outside AMP
    fp32 results within 1e-5;
  * three AMP Momentum steps of the ResNet zoo entry from one startup
    scope: the packages' AMP runs part by no more than the larger of the
    two packages' own AMP-against-fp32 gaps (the control: what bf16
    rounding does to these steps), losses step by step and every
    persistable at the end; the fp32 runs agree within 1e-4;
  * the ``lstm`` lowering with a bfloat16 Input under AMP: with no
    initial state both packages refuse (the JAX package's scan refuses a
    carry the step widens to float32), with float32 H0/C0 both step in
    float32 and agree;
  * ``ParallelExecutor(use_bf16_compute=True)`` at one rank: its steps
    (``run`` and ``run_steps``) are bitwise the Executor's under
    ``amp_guard()``, and the ambient AMP setting is left as it was;
  * ``Executor.run_steps`` keys its step by the AMP state.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transform_zoo_entry as jzoo
from paddle_tpu_torch import parallel as tpar
from paddle_tpu_torch.models import transform_zoo_entry as tzoo

BF16_TOL = 2.0 ** -7     # of max(1, |x|): one bfloat16 rounding apart


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build_convnet(fluid):
    x = fluid.layers.data("x", [3, 8, 8])
    y = fluid.layers.data("y", [1], dtype="int64")
    conv = fluid.layers.conv2d(x, num_filters=8, filter_size=3,
                               padding=1, bias_attr=False)
    bn = fluid.layers.batch_norm(conv, act="relu")
    pool = fluid.layers.pool2d(bn, pool_size=2, pool_stride=2)
    pred = fluid.layers.fc(pool, 4, act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
    return loss, pred


def _train(amp, steps=6, seed=11):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = seed
    scope = tfluid.Scope()
    rng = np.random.RandomState(0)
    xv = rng.randn(16, 3, 8, 8).astype(np.float32)
    yv = rng.randint(0, 4, (16, 1)).astype(np.int64)
    with tfluid.program_guard(main, startup), \
            tfluid.unique_name.guard("amp_"):
        loss, pred = _build_convnet(tfluid)
        tfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    losses = []
    with tfluid.amp.amp_guard(amp):
        for _ in range(steps):
            l, = exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss],
                         scope=scope)
            losses.append(float(l))
        p, = exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[pred],
                     scope=scope)
    state = {v.name: scope.find_var(v.name)
             for v in main.global_block().vars.values()
             if v.persistable and scope.find_var(v.name) is not None}
    return losses, p, state


# -- the JAX package's tests/test_amp.py ---------------------------------

def test_amp_trains_with_fp32_master_state():
    losses, pred, state = _train(amp=True)
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()
    # every persistable (parameters, Adam moments and beta powers, BN
    # running statistics) stays fp32: bf16 lives in activations only
    assert state
    for name, t in state.items():
        assert t.dtype == torch.float32, (name, t.dtype)


def test_amp_engages_bf16_and_stays_close_to_fp32():
    l32, p32, s32 = _train(amp=False)
    l16, p16, s16 = _train(amp=True)
    assert np.abs(p16 - p32).max() > 1e-7          # the cast happened
    np.testing.assert_allclose(l16, l32, rtol=0.08, atol=5e-3)
    assert s32.keys() == s16.keys()
    for n in s32:
        a, b = s32[n].numpy(), s16[n].numpy()
        drift = float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))
        assert drift < 0.08, (n, drift)


def test_amp_guard_scopes_and_restores():
    amp = tfluid.amp
    assert not amp.amp_enabled()
    with amp.amp_guard(True):
        assert amp.amp_enabled()
        with amp.amp_guard(False):
            assert not amp.amp_enabled()
        assert amp.amp_enabled()
    assert not amp.amp_enabled()


# -- the products against the JAX package -------------------------------

def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


PRODUCTS = {
    "mul": ("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["out"]},
            {"x_num_col_dims": 2}, {"x": (2, 3, 16), "w": (16, 8)}),
    "matmul": ("matmul", {"X": ["x"], "Y": ["w"]}, {"Out": ["out"]},
               {"transpose_Y": True, "alpha": 0.125},
               {"x": (2, 4, 5, 16), "w": (2, 4, 6, 16)}),
    "conv2d": ("conv2d", {"Input": ["x"], "Filter": ["w"]},
               {"Output": ["out"]}, {"strides": [2, 2], "paddings": [1, 1]},
               {"x": (2, 4, 9, 9), "w": (6, 4, 3, 3)}),
    "depthwise_conv2d": ("depthwise_conv2d",
                         {"Input": ["x"], "Filter": ["w"]},
                         {"Output": ["out"]}, {"paddings": [1, 1]},
                         {"x": (2, 4, 6, 6), "w": (4, 1, 3, 3)}),
    "conv2d_transpose": ("conv2d_transpose",
                         {"Input": ["x"], "Filter": ["w"]},
                         {"Output": ["out"]},
                         {"strides": [2, 2], "paddings": [1, 1]},
                         {"x": (2, 4, 5, 5), "w": (4, 3, 3, 3)}),
}


def _one_op(fluid, op_type, inputs, outputs, attrs, arrays):
    prog = fluid.Program()
    blk = prog.global_block()
    for name, arr in arrays.items():
        blk.create_var(name=name, shape=arr.shape, dtype="float32")
    blk.create_var(name="out", dtype="float32")
    blk.append_op(type=op_type, inputs=inputs, outputs=outputs,
                  attrs=attrs)
    return prog


@pytest.mark.parametrize("amp", [True, False], ids=["amp", "fp32"])
@pytest.mark.parametrize("case", sorted(PRODUCTS))
def test_amp_products_match_jax(case, amp):
    op_type, inputs, outputs, attrs, shapes = PRODUCTS[case]
    arrays = {n: _rand(i + 3, *s) for i, (n, s) in
              enumerate(sorted(shapes.items()))}
    jprog = _one_op(jfluid, op_type, inputs, outputs, attrs, arrays)
    with jfluid.scope_guard(jfluid.Scope()), jfluid.amp.amp_guard(amp):
        want, = jfluid.Executor(jfluid.CPUPlace()).run(
            jprog, feed=arrays, fetch_list=["out"], return_numpy=False)
    tprog = _one_op(tfluid, op_type, inputs, outputs, attrs, arrays)
    with tfluid.amp.amp_guard(amp):
        got, = tfluid.Executor(tfluid.CPUPlace()).run(
            tprog, feed=arrays, fetch_list=["out"], scope=tfluid.Scope(),
            return_numpy=False)
    assert str(want.dtype) == ("bfloat16" if amp else "float32")
    assert got.dtype == (torch.bfloat16 if amp else torch.float32)
    # a fetch as numpy widens bfloat16 to float32 exactly
    fetched = tfluid.core.as_numpy(got)
    assert fetched.dtype == np.float32
    assert np.array_equal(fetched, got.float().numpy())
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    if amp:
        lim = BF16_TOL * np.maximum(1.0, np.abs(want))
        assert (np.abs(got - want) <= lim).all(), \
            float(np.abs(got - want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- three AMP steps of the ResNet zoo entry -----------------------------

def _zoo_steps(name, steps=3):
    with jfluid.unique_name.guard():
        jm, js, feed_fn, fetch = jzoo(name)
    with tfluid.unique_name.guard():
        tm, _, _, tfetch = tzoo(name)
    assert jm.to_json() == tm.to_json()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(js)
    names = [v.name for v in jm.list_vars()
             if v.persistable and jscope.find_var(v.name) is not None]
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    rng = np.random.RandomState(0)
    feeds = [feed_fn(rng) for _ in range(steps)]

    def jax_run(amp):
        sc = jfluid.Scope()
        for n, v in init.items():
            sc.set(n, v.copy())
        exe = jfluid.Executor(jfluid.CPUPlace())
        with jfluid.scope_guard(sc), jfluid.amp.amp_guard(amp):
            losses = [float(np.asarray(exe.run(jm, feed=f,
                                               fetch_list=fetch)[0]))
                      for f in feeds]
        return losses, {n: np.asarray(sc.find_var(n), np.float32)
                        for n in names}

    def port_run(amp):
        sc = tfluid.Scope()
        tfluid.load_numpy_state(sc, init, "cpu")
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.amp.amp_guard(amp):
            losses = [float(exe.run(tm, feed=f, fetch_list=tfetch,
                                    scope=sc)[0]) for f in feeds]
        return losses, {n: sc.get_numpy(n) for n in names}

    return {(pkg, amp): run(amp) for pkg, run in (("jax", jax_run),
                                                  ("port", port_run))
            for amp in (False, True)}


def _weights_gap(a, b):
    return max(float(np.abs(a[n] - b[n]).max())
               / max(1.0, float(np.abs(a[n]).max())) for n in a)


# the port's AMP run may part from the JAX package's by at most this many
# times the JAX package's own AMP-against-fp32 gap. Over feed seeds 0-3
# (3 steps, one thread) the losses' mean gap read 0.36-1.23x and the
# weights' 0.79-1.00x; one step's loss gap is rounding noise (0.01-9.7x
# over those seeds' first 6 steps), so the losses are held as a mean
AMP_FROM_JAX_X = 2.0


def test_resnet_zoo_amp_steps_within_the_control(one_thread):
    """Three steps of the ResNet zoo entry, fp32 and under AMP, in both
    packages from one startup state: fp32 agrees, AMP engages in both,
    and the port's AMP losses (their mean gap over the steps) and weights
    part from the JAX package's AMP run by at most AMP_FROM_JAX_X times
    the JAX package's AMP run's gap from its fp32 run (the control, which
    the port's numbers do not enter)."""
    runs = _zoo_steps("resnet")
    (j32, jw32), (j16, jw16) = runs["jax", False], runs["jax", True]
    (t32, tw32), (t16, tw16) = runs["port", False], runs["port", True]
    np.testing.assert_allclose(t32, j32, rtol=1e-4)
    assert _weights_gap(tw32, jw32) < 1e-4
    for i in range(len(j16)):                           # AMP engaged
        assert min(abs(j16[i] - j32[i]), abs(t16[i] - t32[i])) > \
            100 * abs(t32[i] - j32[i]), i
    gap = float(np.mean(np.abs(np.subtract(t16, j16))))
    control = float(np.mean(np.abs(np.subtract(j16, j32))))
    assert gap <= AMP_FROM_JAX_X * control, (t16, j16, j32)
    assert _weights_gap(jw16, tw16) <= \
        AMP_FROM_JAX_X * _weights_gap(jw32, jw16)


# -- the lstm lowering with a bfloat16 Input ------------------------------

def _lstm_net(fluid, init_state):
    x = fluid.layers.data("x", [8], lod_level=1)
    kw = {}
    if init_state:
        kw = dict(h_0=fluid.layers.data("h0", [4]),
                  c_0=fluid.layers.data("c0", [4]))
    proj = fluid.layers.fc(x, 16, bias_attr=False)   # bf16 under AMP
    h, _ = fluid.layers.dynamic_lstm(proj, 16, **kw)
    return fluid.layers.sequence_pool(h, "sum"), h, proj


def _lstm_run(fluid, init_state):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out, h, proj = _lstm_net(fluid, init_state)
    rng = np.random.RandomState(0)
    t = fluid.LoDTensor()
    t.set(rng.randn(7, 8).astype(np.float32))
    t.set_recursive_sequence_lengths([[3, 4]])
    feed = {"x": t}
    if init_state:
        feed["h0"] = feed["c0"] = np.zeros((2, 4), np.float32)
    return main, startup, feed, [out, h, proj]


def test_lstm_bf16_input_matches_jax_under_amp():
    """With no initial state the default H0/C0 are zeros of the Input's
    dtype (bfloat16) while the step computes in float32: both packages
    refuse. With float32 H0/C0 both step in float32 and agree."""
    jm, js, feed, jfetch = _lstm_run(jfluid, False)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(js)
        with jfluid.amp.amp_guard(True), pytest.raises(Exception,
                                                       match="carry"):
            exe.run(jm, feed=feed, fetch_list=jfetch)
    init = {v.name: np.asarray(scope.find_var(v.name))
            for v in jm.list_vars() if v.persistable}
    tm, _, tfeed, tfetch = _lstm_run(tfluid, False)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, init, "cpu")
    with tfluid.amp.amp_guard(True), pytest.raises(Exception,
                                                   match="H0 and C0"):
        tfluid.Executor(tfluid.CPUPlace()).run(
            tm, feed=tfeed, fetch_list=tfetch, scope=tscope)

    jm, js, feed, jfetch = _lstm_run(jfluid, True)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(js)
        with jfluid.amp.amp_guard(True):
            want = exe.run(jm, feed=feed, fetch_list=jfetch,
                           return_numpy=False)
    init = {v.name: np.asarray(scope.find_var(v.name))
            for v in jm.list_vars() if v.persistable}
    tm, _, tfeed, tfetch = _lstm_run(tfluid, True)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, init, "cpu")
    with tfluid.amp.amp_guard(True):
        got = tfluid.Executor(tfluid.CPUPlace()).run(
            tm, feed=tfeed, fetch_list=tfetch, scope=tscope,
            return_numpy=False)
    assert [str(np.asarray(w).dtype) for w in want] == \
        ["float32", "float32", "bfloat16"]
    assert [g.dtype for g in got] == [torch.float32, torch.float32,
                                      torch.bfloat16]
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        lim = BF16_TOL * np.maximum(1.0, np.abs(w))
        assert (np.abs(g.float().numpy() - w) <= lim).all()


# -- ParallelExecutor(use_bf16_compute=True), run_steps' key -------------

def _lm(fluid=tfluid):
    from paddle_tpu_torch.models import transformer as TT
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg, _ = TT.transformer_lm(vocab_size=64, max_len=16, n_layer=1,
                                   n_head=2, d_model=32, d_inner=64,
                                   packed=True)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg)
    return main, startup, avg


def _lm_batch(i):
    from paddle_tpu_torch.models import transformer as TT
    return TT.make_lm_batch(np.random.RandomState(60 + i), 4, 16, 64)


def test_bf16_compute_strategy_pins_amp(one_thread):
    main, startup, avg = _lm()
    exe = tfluid.Executor(tfluid.CPUPlace())
    base = tfluid.Scope()
    exe.run(startup, scope=base)
    init = {n: base.get_numpy(n) for n in base.local_var_names()
            if base.find_var(n) is not None}
    scopes = [tfluid.Scope() for _ in range(4)]
    for s in scopes:
        tfluid.load_numpy_state(s, init, "cpu")
    with tfluid.amp.amp_guard(True):
        want = [float(exe.run(main, feed=_lm_batch(i), fetch_list=[avg],
                              scope=scopes[0])[0]) for i in range(3)]
    fp32 = [float(exe.run(main, feed=_lm_batch(i), fetch_list=[avg],
                          scope=scopes[1])[0]) for i in range(3)]
    assert want != fp32
    strategy = tpar.DistributedStrategy(use_bf16_compute=True)
    mesh = tpar.make_mesh(None, devices="cpu")
    pexe = tfluid.ParallelExecutor(loss_name=avg.name, main_program=main,
                                   mesh=mesh, scope=scopes[2],
                                   strategy=strategy)
    got = [float(pexe.run([avg], feed=_lm_batch(i))[0]) for i in range(3)]
    assert got == want
    assert not tfluid.amp.amp_enabled()      # the ambient setting kept
    pexe3 = tfluid.ParallelExecutor(loss_name=avg.name, main_program=main,
                                    mesh=mesh, scope=scopes[3],
                                    strategy=strategy)
    steps = pexe3.run_steps([avg], feeds=[_lm_batch(i) for i in range(3)])
    assert [float(s[0]) for s in steps] == want
    assert not tfluid.amp.amp_enabled()
    for n in init:
        a = scopes[0].get_numpy(n)
        assert np.array_equal(a, scopes[2].get_numpy(n)), n
        assert np.array_equal(a, scopes[3].get_numpy(n)), n


def test_run_steps_keys_its_step_by_amp(one_thread):
    main, startup, avg = _lm()
    exe = tfluid.Executor(tfluid.CPUPlace())
    base = tfluid.Scope()
    exe.run(startup, scope=base)
    init = {n: base.get_numpy(n) for n in base.local_var_names()
            if base.find_var(n) is not None}
    feeds = [_lm_batch(i) for i in range(2)]
    got = {}
    for amp in (True, False):
        s1, s2 = tfluid.Scope(), tfluid.Scope()
        tfluid.load_numpy_state(s1, init, "cpu")
        tfluid.load_numpy_state(s2, init, "cpu")
        with tfluid.amp.amp_guard(amp):
            steps = exe.run_steps(main, feeds=feeds, fetch_list=[avg],
                                  scope=s1)
            runs = [exe.run(main, feed=f, fetch_list=[avg], scope=s2)
                    for f in feeds]
        assert [float(s[0]) for s in steps] == [float(r[0]) for r in runs]
        got[amp] = [float(s[0]) for s in steps]
    assert got[True] != got[False]
    assert len(exe._megasteps) == 2
