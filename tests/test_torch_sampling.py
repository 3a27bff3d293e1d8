"""Sampled decode in the PyTorch port: the counter-keyed sampler against
the JAX package, and the sampled engine against itself.

The port's RNG is its own (Philox4x32-10 on integer tensor ops; jax's
threefry never matches it draw for draw), so:

  * the generator is pinned to the published known-answer vectors of
    Philox4x32-10 and to a plain-Python-integer reference;
  * the filter (``filter_logits``) keeps exactly the set of tokens the
    JAX package's ``sample`` hands to its categorical draw, ties
    included;
  * the draw is held by distribution: over 20,000 draws the port's
    empirical distribution and the JAX package's differ in total
    variation by less than ``TV_LIMIT``. Each empirical distribution is
    off its law by about sqrt(p (1 - p) / n) per token, which sums to an
    expected distance near 0.01 between the two; the limit is three
    times that, and a temperature 1.5x the right one must exceed it;
  * inside the port, sampled serving is seed-reproducible, identical
    under speculation and under megastep, bitwise greedy at temperature
    0 in a mixed batch, and a preempted sampled request regenerates its
    exact output.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.serving import sampling as jsampling
from paddle_tpu_torch import serving
from paddle_tpu_torch.models.transformer_infer import (
    TransformerLMInfer, init_stream)
from paddle_tpu_torch.serving import sampling
from paddle_tpu_torch.serving.spec import NgramDrafter

VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER = 64, 48, 2, 2, 32, 64
N_DRAWS = 20_000
TV_LIMIT = 0.03
_MASK = 0xFFFFFFFF


# -- the generator ------------------------------------------------------------

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


@pytest.mark.parametrize("ctr, key, want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = sampling.philox4x32(tuple(torch.tensor([x]) for x in ctr),
                              tuple(torch.tensor([x]) for x in key))
    assert tuple(int(g) for g in got) == want
    assert _philox_reference(ctr, key) == want


def test_philox_matches_integer_reference():
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2 ** 32, size=(500, 4))
    key = rng.integers(0, 2 ** 32, size=(500, 2))
    got = sampling.philox4x32(
        tuple(torch.from_numpy(ctr[:, i]) for i in range(4)),
        tuple(torch.from_numpy(key[:, i]) for i in range(2)))
    got = np.stack([g.numpy() for g in got], axis=1)
    want = [_philox_reference(tuple(int(x) for x in c),
                              tuple(int(x) for x in k))
            for c, k in zip(ctr, key)]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_uniform_is_a_function_of_seed_and_counter():
    seeds = torch.arange(4000) % 7
    counts = torch.arange(4000) // 7
    u = sampling.uniform(sampling.step_keys(seeds, counts))
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    again = sampling.uniform(sampling.step_keys(seeds.flip(0),
                                                counts.flip(0)))
    assert torch.equal(again.flip(0), u)
    # distinct (seed, counter) pairs give distinct draws
    assert len(set(u.tolist())) > 3990


# -- the filter -----------------------------------------------------------------

def _jax_filtered(monkeypatch, logits, temp, topk, topp):
    """The filtered logits the JAX package's ``sample`` hands to its
    categorical draw (its ``jax.vmap`` is replaced by one that records
    them)."""
    seen = []

    def vmap(_fn):
        def call(keys, final):
            seen.append(np.asarray(final))
            return jnp.zeros(final.shape[:1], jnp.int32)
        return call
    n = logits.shape[0]
    keys = jsampling.step_keys(jnp.arange(n, dtype=jnp.uint32),
                               jnp.zeros((n,), jnp.int32))
    monkeypatch.setattr(jsampling, "jax", types.SimpleNamespace(
        nn=jax.nn, random=jax.random, vmap=vmap))
    jsampling.sample(jnp.asarray(logits), jnp.asarray(temp),
                     jnp.asarray(topk), jnp.asarray(topp), keys)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("top_k, top_p", [(0, 1.0), (5, 1.0), (0, 0.8),
                                          (10, 0.9), (3, 0.5), (1, 1.0)])
def test_filter_logits_keeps_the_jax_set(monkeypatch, top_k, top_p):
    """Seeded logits, with ties: half of the rows are rounded to steps
    of 0.5, so equal scores straddle the top-k boundary and equal
    probabilities the top-p one. Temperatures include 0 (computed at
    1)."""
    rng = np.random.default_rng(top_k + int(10 * top_p))
    n, v = 32, 24
    logits = (rng.normal(size=(n, v)) * 2.0).astype(np.float32)
    logits[::2] = np.round(logits[::2] * 2.0) / 2.0
    temp = rng.choice([0.0, 0.7, 1.0, 1.3], size=n).astype(np.float32)
    topk = np.full(n, top_k, np.int32)
    topp = np.full(n, top_p, np.float32)
    ref = _jax_filtered(monkeypatch, logits, temp, topk, topp)
    got = sampling.filter_logits(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(topk).long(), torch.from_numpy(topp)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    kept = np.isfinite(got)
    np.testing.assert_allclose(got[kept], ref[kept], rtol=1e-5, atol=1e-6)
    if top_k and top_p == 1.0:
        # ties at the boundary are kept: some row keeps more than k
        assert (kept.sum(1) >= top_k).all()
        if top_k > 1:
            assert (kept.sum(1) > top_k).any()


# -- the draw --------------------------------------------------------------------

_S, _V = 48, 16


def _draw(logits, temp, topk, topp, seed0=0):
    n = logits.shape[0]
    return sampling.sample(
        torch.as_tensor(logits), torch.full((n,), float(temp)),
        torch.full((n,), int(topk)), torch.full((n,), float(topp)),
        sampling.step_keys(torch.arange(seed0, seed0 + n),
                           torch.zeros(n, dtype=torch.long))).numpy()


def test_top_k_never_leaves_the_k_set():
    row = np.random.RandomState(3).randn(1, _V).astype(np.float32)
    ids = _draw(np.tile(row, (_S, 1)), 1.0, 3, 1.0)
    top3 = set(np.argsort(row[0])[::-1][:3].tolist())
    assert set(ids.tolist()) <= top3 and len(set(ids.tolist())) > 1


def test_top_p_keeps_the_dominant_token():
    logits = np.zeros((_S, _V), np.float32)
    logits[:, 5] = 10.0
    assert set(_draw(logits, 1.0, 0, 0.5, seed0=7).tolist()) == {5}


def test_temperature_to_zero_converges_to_argmax():
    row = np.random.RandomState(5).randn(1, _V).astype(np.float32)
    ids = _draw(np.tile(row, (_S, 1)), 0.01, 0, 1.0, seed0=11)
    assert set(ids.tolist()) == {int(np.argmax(row[0]))}


def _tv(a, b):
    return 0.5 * np.abs(np.bincount(a, minlength=_V)
                        - np.bincount(b, minlength=_V)).sum() / N_DRAWS


@pytest.mark.parametrize("temp, top_k, top_p", [(0.8, 10, 0.95),
                                                (1.0, 0, 1.0)])
def test_draws_match_jax_in_distribution(temp, top_k, top_p):
    """20,000 draws from one row of logits: the port's (seed 7, counters
    0..n-1) against the JAX package's (seeds 0..n-1) within TV_LIMIT;
    the control, the port at 1.5x the temperature, is beyond it."""
    row = (np.random.default_rng(0).normal(size=_V) * 1.5).astype(
        np.float32)
    logits = np.tile(row, (N_DRAWS, 1))
    ref = np.asarray(jsampling.sample(
        jnp.asarray(logits), jnp.full((N_DRAWS,), temp, jnp.float32),
        jnp.full((N_DRAWS,), top_k, jnp.int32),
        jnp.full((N_DRAWS,), top_p, jnp.float32),
        jsampling.step_keys(jnp.arange(N_DRAWS, dtype=jnp.uint32),
                            jnp.zeros((N_DRAWS,), jnp.int32))))

    def port(t):
        return sampling.sample(
            torch.from_numpy(logits), torch.full((N_DRAWS,), t),
            torch.full((N_DRAWS,), top_k), torch.full((N_DRAWS,), top_p),
            sampling.step_keys(torch.full((N_DRAWS,), 7),
                               torch.arange(N_DRAWS))).numpy()
    assert _tv(port(temp), ref) < TV_LIMIT
    assert _tv(port(1.5 * temp), ref) > TV_LIMIT


# -- the sampled engine ------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    stream = init_stream(VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER,
                         seed=0)
    return TransformerLMInfer.from_stream(stream, N_LAYER, N_HEAD, D_MODEL,
                                          MAX_LEN, end_id=VOCAB,
                                          device="cpu")


def _requests(seed, n, min_new=8, max_new=16):
    rng = np.random.default_rng(seed)
    return [([1] + rng.integers(3, VOCAB, int(rng.integers(0, 12))).tolist(),
             int(rng.integers(min_new, max_new + 1))) for _ in range(n)]


SAMPLED = [dict(temperature=0.9, top_k=8, top_p=0.95, seed=31 + i)
           for i in range(6)]


def _run(eng, reqs, samp):
    hs = [eng.submit(p, m, sampling=s) for (p, m), s in zip(reqs, samp)]
    return [h.result(timeout=60) for h in hs]


def _engine(lm, **kw):
    kw.setdefault("slots", 3)
    return serving.Engine(lm, prefill_chunk=4, block_size=4, device="cpu",
                          **kw)


def test_sampled_engine_replays_and_composes(lm):
    """The same seeds replay identically (a second pass, a fresh
    engine); the speculative engine and megastep 4 give the plain
    engine's sampled tokens."""
    reqs = _requests(0, 6)
    with _engine(lm) as eng:
        eng.warmup(sampled=True)
        a, b = _run(eng, reqs, SAMPLED), _run(eng, reqs, SAMPLED)
        assert eng.stats["megastep_dispatches"] == 0
    with _engine(lm) as eng:
        c = _run(eng, reqs, SAMPLED)
    with _engine(lm, speculative=True, spec_gamma=3) as eng:
        eng._drafter = NgramDrafter(3, 1)
        d = _run(eng, reqs, SAMPLED)
        assert eng.stats["spec_dispatches"] > 0
    with _engine(lm, megastep=4) as eng:
        e = _run(eng, reqs, SAMPLED)
        assert eng.stats["megastep_dispatches"] > 0
    toks = [t for t, _ in a]
    for other in (b, c, d, e):
        assert [t for t, _ in other] == toks
    np.testing.assert_allclose([s for _, s in d], [s for _, s in a],
                               rtol=1e-4)
    assert [s for _, s in e] == [s for _, s in a]
    # the draws differ from the greedy continuation
    with _engine(lm) as eng:
        greedy = eng.generate_many([p for p, _ in reqs],
                                   [m for _, m in reqs])
    assert [t for t, _ in greedy] != toks


def test_other_seeds_draw_other_tokens(lm):
    reqs = _requests(1, 4)
    with _engine(lm) as eng:
        a = _run(eng, reqs, SAMPLED)
        b = _run(eng, reqs, [dict(s, seed=s["seed"] + 100)
                             for s in SAMPLED])
    assert [t for t, _ in a] != [t for t, _ in b]


@pytest.mark.parametrize("megastep", [1, 4])
def test_greedy_slots_of_a_mixed_batch_are_bitwise_greedy(lm, megastep):
    """Temperature-0 requests served beside sampled ones (the sampled
    step runs) give the all-greedy run's tokens and scores, bit for
    bit."""
    reqs = _requests(2, 6)
    greedy_idx = (0, 3, 5)
    samp = [None if i in greedy_idx else SAMPLED[i] for i in range(6)]
    with _engine(lm, slots=6, megastep=megastep) as eng:
        mixed = _run(eng, reqs, samp)
        alone = _run(eng, [reqs[i] for i in greedy_idx],
                     [{"temperature": 0.0}] * len(greedy_idx))
    for i, ref in zip(greedy_idx, alone):
        assert mixed[i] == ref


def test_preempted_sampled_request_regenerates_its_output(lm):
    """Under a pool that holds one max_len request, sampled requests
    are preempted and re-prefilled; their draws restart with them, so
    the output is the roomy engine's."""
    reqs = [([1] + list(range(3, 15)), 30), ([1] + list(range(5, 17)), 30),
            ([1] + list(range(9, 19)), 30)]
    samp = SAMPLED[:3]
    with _engine(lm, num_blocks=12, prefix_cache=False) as eng:
        small = _run(eng, reqs, samp)
        assert eng.stats["preemptions"] > 0
        assert eng._pool.used == 0
    with _engine(lm) as eng:
        roomy = _run(eng, reqs, samp)
        assert eng.stats["preemptions"] == 0
    assert [t for t, _ in small] == [t for t, _ in roomy]
