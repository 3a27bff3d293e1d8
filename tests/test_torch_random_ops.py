"""The port's random ops: counter-keyed Philox draws.

``uniform_random``, ``gaussian_random``, their ``*_batch_size_like``
forms, ``truncated_gaussian_random`` and ``nce``'s negatives draw
Philox4x32-10 words (``core/philox.py``) keyed by the run's seed and the
op's ordinal among the program's random ops. threefry and Philox streams
never match, so each op is held against the JAX package by distribution
at 10**5 draws: the means within 6 standard errors of their difference,
the standard deviations within 2%, and the two-sample Kolmogorov-Smirnov
statistic under 0.012 (a chance of about 1e-6 for two samples of one
distribution). Within the port the draws are held bitwise: the Philox
words to a numpy Philox4x32-10 (and its known-answer vectors),
``run_steps(K=3)`` to 3 ``run()`` calls, and a recompute region's
recompute to its forward.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import philox

N = 100_000
MASK = 0xFFFFFFFF


# -- the Philox words ---------------------------------------------------------

def _np_philox(ctr, key, rounds=10):
    """Philox4x32 in numpy uint64 (Salmon et al., SC'11): products of two
    32-bit words are exact in 64 bits."""
    c = [np.asarray(x, np.uint64) for x in ctr]
    k0, k1 = (np.uint64(int(k)) for k in key)
    for r in range(rounds):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & np.uint64(MASK)
            k1 = (k1 + np.uint64(0xBB67AE85)) & np.uint64(MASK)
        p0 = c[0] * np.uint64(0xD2511F53)
        p1 = c[2] * np.uint64(0xCD9E8D57)
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & np.uint64(MASK),
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & np.uint64(MASK)]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((MASK,) * 4, (MASK, MASK),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10, through the
    port's int64 tensors and through the numpy reference."""
    got = philox.philox4x32([torch.tensor([c]) for c in ctr],
                            [torch.tensor([k]) for k in key])
    assert tuple(int(w) for w in got) == want
    assert tuple(int(w[()]) for w in _np_philox(ctr, key)) == want


@pytest.mark.parametrize("n,seed,key", [(10, 7, 0), (4097, 2 ** 33 + 5, 3),
                                        (1, 0, 2 ** 32 - 1)])
def test_words_match_numpy_philox(n, seed, key):
    """Word i of a draw is word i % 4 of Philox4x32-10 at counter (i // 4,
    0, 0, 0) and key (seed mod 2**32, key)."""
    got = philox.words(n, torch.tensor(seed), key, "cpu").numpy()
    ctr = np.arange((n + 3) // 4, dtype=np.uint64)
    zero = np.zeros_like(ctr)
    want = np.stack(_np_philox((ctr, zero, zero, zero),
                               (seed & MASK, key)), axis=1).reshape(-1)[:n]
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_words_chunked_draw_is_one_stream(monkeypatch):
    """A draw split into chunks (large initializers) is the same words."""
    seed = torch.tensor(11)
    whole = philox.words(1000, seed, 5, "cpu")
    monkeypatch.setattr(philox, "_CHUNK", 64)
    np.testing.assert_array_equal(philox.words(1000, seed, 5, "cpu"), whole)


# -- distributions against the JAX package -------------------------------------

def _ks(a, b):
    """The two-sample Kolmogorov-Smirnov statistic."""
    a, b = np.sort(a), np.sort(b)
    pts = np.concatenate([a, b])
    return float(np.max(np.abs(np.searchsorted(a, pts, "right") / a.size
                               - np.searchsorted(b, pts, "right") / b.size)))


def _same_distribution(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    assert got.size == want.size == N
    se = np.sqrt(got.var() / got.size + want.var() / want.size)
    assert abs(got.mean() - want.mean()) < 6 * se, (got.mean(), want.mean())
    assert abs(got.std() / want.std() - 1) < 0.02, (got.std(), want.std())
    assert _ks(got, want) < 0.012


def _draw(pkg, op_type, attrs, ref_shape=None):
    """One run of a program holding one ``op_type`` op (seed 3)."""
    main = pkg.Program()
    main.random_seed = 3
    blk = main.global_block()
    blk.create_var(name="r", shape=list(attrs["shape"]), dtype="float32")
    inputs, feed = {}, {}
    if ref_shape is not None:
        blk.create_var(name="ref", shape=[-1, ref_shape[1]],
                       dtype="float32")
        inputs = {"Input": ["ref"]}
        feed = {"ref": np.zeros(ref_shape, np.float32)}
    blk.append_op(type=op_type, inputs=inputs, outputs={"Out": ["r"]},
                  attrs=dict(attrs, dtype="float32"))
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        out, = exe.run(main, feed=feed, fetch_list=["r"])
    return np.asarray(out)


@pytest.mark.parametrize("op_type,attrs,ref", [
    ("uniform_random", {"shape": [N], "min": -2.0, "max": 3.0}, None),
    ("uniform_random_batch_size_like",
     {"shape": [-1, 1000], "min": -1.0, "max": 1.0}, (100, 4)),
    ("gaussian_random", {"shape": [N], "mean": 1.5, "std": 0.5}, None),
    ("gaussian_random_batch_size_like",
     {"shape": [-1, 1000], "mean": 0.0, "std": 2.0}, (100, 4)),
    ("truncated_gaussian_random", {"shape": [N], "mean": 1.0, "std": 0.5},
     None),
], ids=lambda v: v if isinstance(v, str) else "")
def test_draw_matches_jax_by_distribution(op_type, attrs, ref):
    got = _draw(tfluid, op_type, attrs, ref)
    want = _draw(jfluid, op_type, attrs, ref)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    _same_distribution(got, want)
    if op_type.startswith("uniform"):
        assert got.min() >= attrs["min"] and got.max() < attrs["max"]
    if op_type.startswith("truncated"):
        lo, hi = attrs["mean"] - 2 * attrs["std"], \
            attrs["mean"] + 2 * attrs["std"]
        assert got.min() >= lo and got.max() <= hi


def _nce_net(pkg, classes=50, neg=10, dim=4):
    x = pkg.layers.data("x", [dim])
    label = pkg.layers.data("label", [1], dtype="int64")
    cost = pkg.layers.nce(x, label, num_total_classes=classes,
                          num_neg_samples=neg)
    loss = pkg.layers.mean(cost)
    return [x, label], loss


def _nce_samples(pkg, batch=N // 10):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, loss = _nce_net(pkg)
    nce_op = [op for op in main.global_block().ops if op.type == "nce"][0]
    samples = nce_op.output("SampleLabels")[0]
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(batch, 4).astype(np.float32),
            "label": rng.randint(0, 50, (batch, 1)).astype(np.int64)}
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        out, = exe.run(main, feed=feed, fetch_list=[samples])
    return np.asarray(out)


def test_nce_negatives_match_jax_by_distribution():
    """10 negatives for each of 10**4 rows, uniform over the 50 classes:
    the true label first, then the draws."""
    got, want = _nce_samples(tfluid), _nce_samples(jfluid)
    assert got.shape == want.shape == (N // 10, 11)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    got, want = got[:, 1:], want[:, 1:]
    assert got.min() >= 0 and got.max() < 50
    _same_distribution(got, want)


def test_nce_cost_matches_jax_on_the_same_negatives(monkeypatch):
    """Given the port's negatives (``jax.random.randint`` patched to
    return them), the JAX lowering's cost and logits are the port's at
    rtol 1e-5, from the JAX package's startup values. The layer's Bias is
    [C, 1], which the JAX lowering indexes flat."""
    import jax.numpy as jnp
    progs = {}
    for pkg in (jfluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            _, loss = _nce_net(pkg)
        progs[pkg] = (main, startup, loss)
    assert progs[tfluid][0].to_json() == progs[jfluid][0].to_json()
    nce_op = [op for op in progs[tfluid][0].global_block().ops
              if op.type == "nce"][0]
    fetch = [nce_op.output("Cost")[0], nce_op.output("SampleLogits")[0],
             nce_op.output("SampleLabels")[0]]
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(32, 4).astype(np.float32),
            "label": rng.randint(0, 50, (32, 1)).astype(np.int64)}
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(progs[jfluid][1])
    state = {n: np.asarray(jscope.find_var(n))
             for n in jscope.local_var_names()}
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    cost, logits, samples = tfluid.Executor(tfluid.CPUPlace()).run(
        progs[tfluid][0], feed=feed, fetch_list=fetch, scope=tscope)
    monkeypatch.setattr("jax.random.randint",
                        lambda *a, **k: jnp.asarray(samples[:, 1:]))
    with jfluid.scope_guard(jscope):
        jcost, jlogits, jsamples = jexe.run(progs[jfluid][0], feed=feed,
                                            fetch_list=fetch)
    np.testing.assert_array_equal(np.asarray(jsamples), samples)
    np.testing.assert_allclose(logits, np.asarray(jlogits), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cost, np.asarray(jcost), rtol=1e-5)


# -- run_steps draws what K runs draw ----------------------------------------

def _noise_net(pkg):
    x = pkg.layers.data("x", [8])
    noise = pkg.layers.gaussian_random_batch_size_like(x, [-1, 8], std=0.1)
    h = pkg.layers.fc(pkg.layers.elementwise_add(x, noise), 4, act="tanh")
    loss = pkg.layers.mean(h)
    return [x], loss


def _feeds(net, k, batch=16):
    rng = np.random.RandomState(5)
    out = []
    for _ in range(k):
        f = {"x": rng.rand(batch, 4 if net is _nce_net else 8).astype(
            np.float32)}
        if net is _nce_net:
            f["label"] = rng.randint(0, 50, (batch, 1)).astype(np.int64)
        out.append(f)
    return out


@pytest.mark.parametrize("net", [_nce_net, _noise_net],
                         ids=["nce", "gaussian_batch_size_like"])
def test_run_steps_draws_bitwise_k_runs(net):
    """run_steps(K=3) of a net that draws inside its step: every loss and
    persistable bitwise equal to 3 run() calls from the same state."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 9
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        _, loss = net(tfluid)
        tfluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    feeds = _feeds(net, 3)
    results = []
    for mega in (False, True):
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        if mega:
            losses = [o[0] for o in exe.run_steps(
                main, feeds=feeds, fetch_list=[loss], scope=scope)]
        else:
            losses = [exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0] for f in feeds]
        results.append((losses, {n: scope.get_numpy(n)
                                 for n in scope.local_var_names()}))
    (seq, seq_state), (got, got_state) = results
    np.testing.assert_array_equal(np.asarray(got), np.asarray(seq))
    assert len(set(float(v) for v in np.ravel(seq))) == 3
    for n in seq_state:
        np.testing.assert_array_equal(got_state[n], seq_state[n], err_msg=n)


def test_recompute_region_replays_its_draws():
    """A gaussian draw inside a recompute region: the backward's
    recompute draws what the forward drew, so one SGD step gives bitwise
    the loss and weights of the same net without the region."""
    def build(region):
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = 4
        with tfluid.program_guard(main, startup), \
                tfluid.unique_name.guard():
            x = tfluid.layers.data("x", [8])
            h = tfluid.layers.fc(x, 8, act="tanh")
            if region:
                with tfluid.layers.recompute():
                    noise = tfluid.layers.gaussian_random_batch_size_like(
                        h, [-1, 8], std=0.5)
                    h = tfluid.layers.fc(tfluid.layers.elementwise_add(
                        h, noise), 4, act="tanh")
            else:
                noise = tfluid.layers.gaussian_random_batch_size_like(
                    h, [-1, 8], std=0.5)
                h = tfluid.layers.fc(tfluid.layers.elementwise_add(
                    h, noise), 4, act="tanh")
            loss = tfluid.layers.mean(h)
            tfluid.optimizer.SGD(learning_rate=1.0).minimize(loss)
        return main, startup, loss

    feed = _feeds(_noise_net, 1)[0]
    outs = []
    for region in (True, False):
        main, startup, loss = build(region)
        assert (sum(op.type == "recompute_block"
                    for op in main.global_block().ops) == 1) == region
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        lv, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        outs.append((lv, {n: scope.get_numpy(n)
                          for n in scope.local_var_names()}))
    (l1, s1), (l0, s0) = outs
    np.testing.assert_array_equal(l1, l0)
    assert sorted(s1) == sorted(s0)
    for n in s0:
        np.testing.assert_array_equal(s1[n], s0[n], err_msg=n)
