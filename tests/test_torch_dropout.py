"""Dropout in the PyTorch port: the counter-keyed draw and its contracts.

The port draws its masks from Philox4x32-10 keyed by the run's seed and
each op's key (``ops/dropout.py``); jax's threefry never matches it draw
for draw, so:

  * the generator, which the sampler shares, is pinned to the published
    known-answer vectors and the sampler's bits to their values before
    the two shared it;
  * the draw is held by distribution: the keep share of 200,000 draws
    lies within 4 sigma of the binomial's mean;
  * against the JAX package the deterministic paths are exact: ``is_test``
    and p = 0 under both implementations, and each implementation's
    scaling given one mask (the JAX package's Bernoulli draw replaced by
    the port's mask);
  * inside the port: a ``run_steps(K)`` dispatch draws what K ``run()``
    calls draw, bitwise (contract a); the same program, seed and feeds
    draw the same masks run to run (b); the LM with recompute regions, or
    with its whole forward checkpointed, equals the LM without, bitwise
    (c). CPU PyTorch reduces in thread order, so the bitwise cases run on
    one thread.

Everything runs on the CPU, where the plain version stands for the CUDA
kernel; ``chip_smoke.py`` holds the kernel against it bit for bit.
"""

import numpy as np
import jax
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import philox, registry
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.ops import dropout as TD
from paddle_tpu_torch.serving import sampling

_MASK = 0xFFFFFFFF
SMALL = dict(vocab_size=64, max_len=16, n_layer=2, n_head=2, d_model=32,
             d_inner=64)

# Philox4x32-10 known answers (Random123's kat_vectors): counter, key, out
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_MASK,) * 4, (_MASK, _MASK),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _philox_reference(ctr, key):
    """Philox4x32-10 on Python integers (no overflow to avoid)."""
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & _MASK, (k[1] + 0xBB67AE85) & _MASK]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & _MASK,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & _MASK]
    return tuple(c)


# -- the generator ------------------------------------------------------------

@pytest.mark.parametrize("ctr, key, want", KAT)
def test_shared_philox_known_answers(ctr, key, want):
    got = philox.philox4x32(tuple(torch.tensor([x]) for x in ctr),
                            tuple(torch.tensor([x]) for x in key))
    assert tuple(int(g) for g in got) == want
    assert sampling.philox4x32 is philox.philox4x32


def test_sampler_bits_unchanged():
    """The sampler's uniforms for five (seed, counter) pairs, as they
    were before the sampler and dropout shared one Philox."""
    seeds = torch.tensor([0, 1, 7, 12345, 2 ** 32 - 1])
    counts = torch.tensor([0, 1, 100, 2 ** 33 + 5, 77])
    u = sampling.uniform(sampling.step_keys(seeds, counts))
    assert [int(x * 2 ** 24) for x in u.tolist()] == [
        6694888, 11274260, 12358651, 4535071, 635890]


def test_bits_follow_the_counter_layout():
    """Element i takes word i % 4 at counter (i // 4, 0, 0, 0) and key
    (seed mod 2**32, op key)."""
    seed, key = 2 ** 33 + 17, 5
    bits = TD._bits(10, torch.tensor(seed), key, "cpu").tolist()
    want = []
    for i in range(10):
        words = _philox_reference((i // 4, 0, 0, 0), (seed & _MASK, key))
        want.append(words[i % 4])
    assert bits == want


# -- the draw -----------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_share_within_4_sigma(p):
    n = 200_000
    x = torch.ones(n)
    _, mask = TD.dropout(x, torch.tensor(3), 7, p, want_mask=True)
    kept = float(mask.sum())
    sigma = (n * p * (1 - p)) ** 0.5
    assert abs(kept - n * (1 - p)) < 4 * sigma, (kept, n * (1 - p), sigma)


def test_same_key_same_mask_other_key_other_mask():
    x = torch.ones(4096)
    a = TD.dropout(x, torch.tensor(11), 2, 0.5, want_mask=True)[1]
    b = TD.dropout(x, torch.tensor(11), 2, 0.5, want_mask=True)[1]
    c = TD.dropout(x, torch.tensor(11), 3, 0.5, want_mask=True)[1]
    d = TD.dropout(x, torch.tensor(12), 2, 0.5, want_mask=True)[1]
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("upscale", [False, True])
def test_out_is_x_times_mask_scaled_in_f32(dtype, upscale):
    """On an odd size: Out = x * Mask (* the f32 reciprocal of 1 - p),
    in f32, rounded once."""
    x = torch.from_numpy(
        np.random.RandomState(0).randn(1001).astype(np.float32)).to(dtype)
    out, mask = TD.dropout(x, torch.tensor(5), 1, 0.3, scale=upscale,
                           want_mask=True)
    assert out.dtype == mask.dtype == dtype
    want = x.float() * mask.float()
    if upscale:
        want = want * float(np.float32(1) / np.float32(0.7))
    assert torch.equal(out, want.to(dtype))
    assert set(mask.float().unique().tolist()) <= {0.0, 1.0}


def test_gradient_is_the_draw_of_the_incoming_gradient():
    x = torch.randn(257, requires_grad=True)
    g = torch.randn(257)
    out, mask = TD.dropout(x, torch.tensor(9), 4, 0.25, scale=True,
                           want_mask=True)
    out.backward(g)
    want, _ = TD.dropout(g, torch.tensor(9), 4, 0.25, scale=True)
    assert torch.equal(x.grad, want)
    assert torch.equal(x.grad == 0, mask == 0)


# -- the op against the JAX package -------------------------------------------

def _dropout_program(fluid, x, attrs):
    prog = fluid.Program()
    blk = prog.global_block()
    blk.create_var(name="x", shape=x.shape, dtype="float32")
    for n in ("out", "mask"):
        blk.create_var(name=n, dtype="float32")
    blk.append_op(type="dropout", inputs={"X": ["x"]},
                  outputs={"Out": ["out"], "Mask": ["mask"]}, attrs=attrs)
    return prog


def _run_dropout(x, attrs):
    """(port Out, port Mask, JAX Out, JAX Mask) of one dropout op."""
    jprog = _dropout_program(jfluid, x, attrs)
    with jfluid.scope_guard(jfluid.Scope()):
        jout, jmask = jfluid.Executor(jfluid.CPUPlace()).run(
            jprog, feed={"x": x}, fetch_list=["out", "mask"])
    tout, tmask = tfluid.Executor(tfluid.CPUPlace()).run(
        _dropout_program(tfluid, x, attrs), feed={"x": x},
        fetch_list=["out", "mask"], scope=tfluid.Scope())
    return tout, tmask, np.asarray(jout), np.asarray(jmask)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("is_test, p", [(True, 0.3), (False, 0.0)],
                         ids=["is_test", "p0"])
def test_deterministic_paths_equal_jax(impl, is_test, p):
    x = np.random.RandomState(1).randn(4, 33).astype(np.float32)
    tout, tmask, jout, jmask = _run_dropout(
        x, {"dropout_prob": p, "is_test": is_test,
            "dropout_implementation": impl})
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tmask, jmask)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_training_scaling_equals_jax_given_one_mask(monkeypatch, impl):
    """The JAX package's Bernoulli draw replaced by the port's mask: both
    implementations scale it to the same Out, bit for bit."""
    x = np.random.RandomState(2).randn(4, 33).astype(np.float32)
    attrs = {"dropout_prob": 0.3, "dropout_implementation": impl}
    tout, tmask, _, _ = _run_dropout(x, attrs)
    assert 0 < tmask.sum() < tmask.size
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jax.numpy.asarray(tmask > 0))
    _, _, jout, jmask = _run_dropout(x, attrs)
    np.testing.assert_array_equal(jmask, tmask)
    np.testing.assert_array_equal(jout, tout)


# -- the contracts inside the port --------------------------------------------

def _lm(dropout=0.1, recompute=False, checkpoint=False, seed=3):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = seed
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        avg, _ = TT.transformer_lm(packed=True, dropout_rate=dropout,
                                   recompute=recompute, **SMALL)
        opt = tfluid.optimizer.Adam(1e-3)
        pg = tfluid.append_backward(avg, checkpoint=checkpoint)
        opt.apply_gradients(sorted(pg, key=lambda x: x[0].name))
    return main, startup, avg


def _state():
    main, startup, _ = _lm()
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    return {n: scope.find_var(n).clone() for n in scope.local_var_names()}


def _scope(state):
    scope = tfluid.Scope()
    for n, v in state.items():
        scope.set(n, v.clone())
    return scope


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [TT.make_lm_batch(rng, 4, 16, 64) for _ in range(n)]


def _eager(main, avg, scope, batches):
    exe = tfluid.Executor(tfluid.CPUPlace())
    return [float(exe.run(main, feed=b, fetch_list=[avg], scope=scope)[0])
            for b in batches]


def _assert_same_state(a, b, names):
    for n in names:
        assert torch.equal(a.find_var(n), b.find_var(n)), n


@pytest.mark.parametrize("k", [1, 3])
def test_run_steps_equals_k_runs_bitwise(one_thread, k):
    """Contract (a): the K run seeds staged for one dispatch are the ones
    K run() calls take."""
    state = _state()
    main, _, avg = _lm()
    batches = _batches(2 * k)
    s1, s2 = _scope(state), _scope(state)
    eager = _eager(main, avg, s1, batches)
    exe = tfluid.Executor(tfluid.CPUPlace())
    mega = []
    for i in range(2):
        out = exe.run_steps(main, feeds=batches[i * k:(i + 1) * k],
                            fetch_list=[avg], scope=s2)
        mega += [float(o[0]) for o in out]
    assert mega == eager
    _assert_same_state(s1, s2, state)


def test_same_program_seed_and_feeds_same_masks():
    """Contract (b), and another program seed draws other masks."""
    feed = _batches(1)[0]
    masks = []
    for seed in (3, 3, 4):
        main, startup, avg = _lm(seed=seed)
        name = next(op.output("Mask")[0] for op in main.global_block().ops
                    if op.type == "dropout")
        out = tfluid.Executor(tfluid.CPUPlace()).run(
            main, feed=feed, fetch_list=[name], scope=_scope(_state()))
        masks.append(out[0])
    np.testing.assert_array_equal(masks[0], masks[1])
    assert 0 < masks[0].sum() < masks[0].size
    assert not np.array_equal(masks[0], masks[2])


@pytest.mark.parametrize("how", ["regions", "checkpoint"])
def test_recompute_equals_plain_with_dropout_bitwise(one_thread, how):
    """Contract (c): the recompute replays the forward's masks, so 3 Adam
    steps with recompute regions (or the whole forward checkpointed)
    equal 3 without, losses and every persistable."""
    state = _state()
    batches = _batches(3, seed=1)
    plain, _, avg = _lm()
    s1, s2 = _scope(state), _scope(state)
    ref = _eager(plain, avg, s1, batches)
    other, _, avg2 = _lm(recompute=how == "regions",
                         checkpoint=how == "checkpoint")
    got = _eager(other, avg2, s2, batches)
    assert got == ref
    _assert_same_state(s1, s2, state)


def test_op_keys_ignore_regions_and_names():
    """The op key is the op's ordinal among the program's random ops, in
    program order through the recompute regions."""
    def keyed(recompute, prefix):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup), \
                tfluid.unique_name.guard(prefix):
            TT.transformer_lm(packed=True, dropout_rate=0.1,
                              recompute=recompute, **SMALL)
        keys = registry.random_op_keys(main.global_block())
        found = []

        def walk(blk):
            for op in blk.ops:
                if id(op) in keys:
                    found.append((keys[id(op)], op.type))
                for sub in registry.sub_blocks(op):
                    walk(sub)

        walk(main.global_block())
        return found

    plain = keyed(False, "a_")
    assert plain == keyed(True, "b_")
    assert plain == [(k, "dropout")
                     for k in range(1 + 3 * SMALL["n_layer"])]


def test_recompute_with_dropout_trains():
    """tests/test_recompute.py's test of the same name, in the port: 20
    Adam steps of the dropout LM with recompute regions stay finite and
    the loss falls."""
    main, startup = tfluid.Program(), tfluid.Program()
    scope = tfluid.Scope()
    with tfluid.program_guard(main, startup):
        cost, _ = TT.transformer_lm(vocab_size=32, max_len=8, n_layer=2,
                                    n_head=2, d_model=16, d_inner=32,
                                    packed=True, recompute=True,
                                    dropout_rate=0.3)
        tfluid.optimizer.Adam(learning_rate=1e-2).minimize(cost)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    losses = []
    for _ in range(20):
        feeds = TT.make_lm_batch(rng, 4, 8, 32)
        loss, = exe.run(main, feed=feeds, fetch_list=[cost], scope=scope)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_run_steps_body_copies_nothing_from_the_host(monkeypatch):
    """After a first step, a step body of the dropout LM (the composed
    attention with its causal-bias constant) makes no tensor from host
    memory: a CUDA graph capture would fail on the pageable copy."""
    from paddle_tpu_torch.core import executor as texecutor
    state = _state()
    main, _, avg = _lm()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = _scope(state)
    batches = _batches(2)
    exe.run(main, feed=batches[0], fetch_list=[avg], scope=scope)
    inside, on = [], [False]
    real_body, real_from_numpy = texecutor._Megastep._body, torch.from_numpy

    def body(self, *args, **kwargs):
        on[0] = True
        try:
            return real_body(self, *args, **kwargs)
        finally:
            on[0] = False

    def from_numpy(arr):
        if on[0]:
            inside.append(arr.shape)
        return real_from_numpy(arr)

    monkeypatch.setattr(texecutor._Megastep, "_body", body)
    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    exe.run_steps(main, feeds=batches, fetch_list=[avg], scope=scope)
    assert not inside, inside
