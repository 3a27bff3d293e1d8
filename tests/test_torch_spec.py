"""Speculative decode in the PyTorch port against the JAX package.

The port's drafter (``serving/spec.py``, a copy) proposes what the JAX
package's does; its scoring step (``_spec_logits_paged``) gives the JAX
package's logits and pool writes; and ``Engine(speculative=True)`` on
the CPU gives the greedy tokens of the JAX package's
``sequential_generate`` — at gamma 2 and 4, for both drafters, through
slot recycling, multi-chunk prefill, mid-flight admission, megastep
composition, preemption under a small pool and EOS inside an accepted
draft — while both acceptance branches run. Scores (sums of fp32
log-probs, summed in other orders) are compared at rtol 1e-4; the
scoring step's logits and pool writes at rtol 1e-5 / atol 1e-5.

The LM is ``transformer_lm(vocab 64, max_len 48, 2 layers, 2 heads,
d_model 32, d_inner 64)`` initialized by ``paddle_tpu``; ``end_id`` is
set past the vocabulary so requests run to ``max_new`` (long decodes
cross block boundaries), except where EOS is the point: there the
natural ``end_id=2`` is kept.
"""

import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer
from paddle_tpu.models.transformer_infer import (
    TransformerLMInfer as JaxLM, extract_params)
from paddle_tpu.serving.spec import NgramDrafter as JaxDrafter
from paddle_tpu_torch import flags, serving
from paddle_tpu_torch.models.transformer_infer import TransformerLMInfer
from paddle_tpu_torch.serving.spec import NgramDrafter

VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER = 64, 48, 2, 2, 32, 64
DK = D_MODEL // N_HEAD


@pytest.fixture(scope="module")
def lms():
    """{end_id: (jax model, port model)} for end_id 2 and VOCAB."""
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.scope_guard(scope):
        transformer.transformer_lm(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER)
        fluid.Executor(fluid.CPUPlace()).run(startup)
        stream = [(role, [np.asarray(a) for a in arrays])
                  for role, arrays in extract_params(main, scope)]
        out = {}
        for end in (2, VOCAB):
            out[end] = (
                JaxLM(main, scope, N_LAYER, N_HEAD, D_MODEL, MAX_LEN,
                      end_id=end),
                TransformerLMInfer.from_stream(
                    stream, N_LAYER, N_HEAD, D_MODEL, MAX_LEN,
                    end_id=end, device="cpu"))
    return out


def _requests(seed, n, max_prompt=13, min_new=4, max_new=20):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(1, max_prompt + 1))
        prompt = [1] + rng.integers(3, VOCAB, plen - 1).tolist()
        reqs.append((prompt, int(rng.integers(min_new, max_new + 1))))
    return reqs


def _assert_identical(ref, got):
    for i, ((rt, rs), (gt, gs)) in enumerate(zip(ref, got)):
        assert gt == rt, "request %d diverged: %r vs %r" % (i, gt, rt)
        np.testing.assert_allclose(gs, rs, rtol=1e-4, atol=1e-4)


def _engine(model, min_n=1, **kw):
    """A speculative engine on the CPU. ``min_n=1`` lets weak one-token
    evidence draft, so the rejection branch runs too."""
    kw.setdefault("slots", 3)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("block_size", 4)
    eng = serving.Engine(model, speculative=True, device="cpu", **kw)
    if eng._drafter is not None:
        eng._drafter = NgramDrafter(max_n=3, min_n=min_n)
    return eng


def _spec_stats(stats):
    return {k: v for k, v in stats.items() if k.startswith("spec_")}


# -- the drafter ------------------------------------------------------------

@pytest.mark.parametrize("min_n", [1, 2])
@pytest.mark.parametrize("extra", [False, True], ids=["own", "published"])
def test_ngram_drafter_matches_jax(min_n, extra):
    """200 seeded random chains over a small alphabet (so n-grams
    repeat), each proposed at a random gamma, with and without other
    published chains to search."""
    rng = np.random.default_rng(100 + min_n + 10 * extra)
    mine, ref = NgramDrafter(3, min_n), JaxDrafter(3, min_n)
    drafted = 0
    for _ in range(200):
        chain = rng.integers(0, 6, int(rng.integers(0, 40))).tolist()
        others = [rng.integers(0, 6, int(rng.integers(2, 30))).tolist()
                  for _ in range(int(rng.integers(1, 4)))] if extra else ()
        gamma = int(rng.integers(0, 6))
        got = mine.propose(chain, gamma, extra_chains=others)
        assert got == ref.propose(chain, gamma, extra_chains=others)
        drafted += bool(got)
    assert drafted > 40


# -- the scoring step -------------------------------------------------------

@pytest.mark.parametrize("block_kernel", [True, False],
                         ids=["kernel", "gather"])
def test_spec_logits_paged_matches_jax(lms, block_kernel):
    """S=3, C=5 over a random pool: ragged draft counts (4 and 1) and
    one masked slot. Logits at each valid position and the written pool
    entries agree with the JAX package's; every other entry of the
    port's pool is bitwise unchanged (its trash block, past the JAX
    package's pool, takes the dropped writes)."""
    jlm, tlm = lms[VOCAB]
    rng = np.random.default_rng(5)
    bs, nbmax, s, c = 4, MAX_LEN // 4, 3, 5
    nb = s * nbmax + 4
    shape = (nb, N_LAYER, N_HEAD, bs, DK)
    pk = rng.normal(size=shape).astype(np.float32)
    pv = rng.normal(size=shape).astype(np.float32)
    btab = rng.permutation(nb)[:s * nbmax].reshape(s, nbmax).astype(
        np.int32)
    pos = np.array([6, 21, 13], np.int32)
    n_valid = np.array([4, 1, 3], np.int32)
    mask = np.array([True, True, False])
    toks = rng.integers(3, VOCAB, size=(s, c)).astype(np.int32)
    jstate = {"pool_k": jnp.asarray(pk), "pool_v": jnp.asarray(pv)}
    jl, jstate = jlm._spec_logits_paged(
        jnp.asarray(toks), jstate, jnp.asarray(pos), jnp.asarray(btab),
        jnp.asarray(n_valid), write_mask=jnp.asarray(mask),
        block_kernel=block_kernel)
    trash = np.zeros((1,) + shape[1:], np.float32)
    tstate = {"pool_k": torch.from_numpy(np.concatenate([pk, trash])),
              "pool_v": torch.from_numpy(np.concatenate([pv, trash]))}
    tl, tstate = tlm._spec_logits_paged(
        torch.from_numpy(toks).long(), tstate,
        torch.from_numpy(pos).long(), torch.from_numpy(btab),
        torch.from_numpy(n_valid).long(),
        write_mask=torch.from_numpy(mask), block_kernel=block_kernel)
    assert tl.shape == (s, c, VOCAB)
    valid = (np.arange(c)[None] <= n_valid[:, None]) & mask[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               rtol=1e-5, atol=1e-5)
    written = np.zeros((nb, bs), bool)
    for i, j in zip(*np.nonzero(valid)):
        p = pos[i] + j
        written[btab[i, p // bs], p % bs] = True
    for name, init in (("pool_k", pk), ("pool_v", pv)):
        got = tstate[name].numpy()
        np.testing.assert_allclose(got[:-1], np.asarray(jstate[name]),
                                   rtol=1e-5, atol=1e-5)
        changed = np.any(got[:-1] != init, axis=(1, 2, 4))
        np.testing.assert_array_equal(changed, written)
        keep = ~written[:, None, None, :, None] & np.ones(shape, bool)
        np.testing.assert_array_equal(got[:-1][keep], init[keep])
        assert got[-1].any()                    # the dropped writes


# -- the speculative engine -------------------------------------------------

@pytest.mark.parametrize("drafter", ["ngram", "truncated"])
@pytest.mark.parametrize("gamma", [2, 4])
def test_spec_engine_matches_jax(lms, drafter, gamma):
    """Slot recycling and multi-chunk prefill under speculation: the
    greedy tokens are the JAX package's ``sequential_generate``'s, and
    drafts were both accepted and rejected."""
    jlm, tlm = lms[VOCAB]
    reqs = _requests(gamma, 8)
    assert max(len(p) for p, _ in reqs) > 4
    ref = jserving.sequential_generate(jlm, reqs)
    with _engine(tlm, spec_gamma=gamma, spec_drafter=drafter,
                 spec_layers=1) as eng:
        eng.warmup()
        out = eng.generate_many([p for p, _ in reqs],
                                [m for _, m in reqs])
        st = _spec_stats(eng.stats)
        assert eng._spec_layers == (1 if drafter == "truncated" else 0)
    _assert_identical(ref, out)
    assert st["spec_dispatches"] > 0
    assert 0 < st["spec_accepted"] < st["spec_drafted"]
    assert st["spec_emitted"] > st["spec_accepted"]
    assert (st["spec_draft_steps"] > 0) == (drafter == "truncated")


def test_spec_mid_flight_admission(lms):
    """Requests submitted while the engine speculates join at an
    iteration boundary and decode as the JAX package's baseline."""
    jlm, tlm = lms[VOCAB]
    reqs = _requests(11, 5, min_new=10, max_new=18)
    ref = jserving.sequential_generate(jlm, reqs)
    with _engine(tlm, spec_gamma=4) as eng:
        first = [eng.submit(p, m) for p, m in reqs[:3]]
        time.sleep(0.03)
        rest = [eng.submit(p, m) for p, m in reqs[3:]]
        out = [r.result(timeout=60) for r in first + rest]
        assert eng.stats["spec_dispatches"] > 0
    _assert_identical(ref, out)


def test_spec_megastep_composition(lms):
    """megastep 4 with speculation: drafted iterations take the scoring
    dispatch, draftless ones still run K steps; tokens unchanged through
    a mid-flight admission."""
    jlm, tlm = lms[VOCAB]
    reqs = _requests(12, 6, min_new=8, max_new=16)
    ref = jserving.sequential_generate(jlm, reqs)
    with _engine(tlm, slots=2, megastep=4, spec_gamma=2) as eng:
        eng.warmup()
        out = eng.generate_many([p for p, _ in reqs[:4]],
                                [m for _, m in reqs[:4]])
        first = [eng.submit(p, m) for p, m in reqs[4:5]]
        time.sleep(0.02)
        rest = [eng.submit(p, m) for p, m in reqs[5:]]
        out += [h.result(timeout=60) for h in first + rest]
        stats = dict(eng.stats)
    _assert_identical(ref, out)
    assert stats["spec_dispatches"] > 0 and stats["megastep_dispatches"] > 0


def test_spec_gamma0_runs_the_existing_programs(lms):
    """gamma 0 turns speculation off: no scoring dispatch, no spec_*
    count, the plain tokens; a bad drafter name and the dense layout
    are refused."""
    jlm, tlm = lms[VOCAB]
    reqs = _requests(13, 4)
    ref = jserving.sequential_generate(jlm, reqs)
    with _engine(tlm, spec_gamma=0) as eng:
        assert eng._speculative is False and eng._drafter is None
        out = eng.generate_many([p for p, _ in reqs],
                                [m for _, m in reqs])
        assert not any(_spec_stats(eng.stats).values())
        assert eng.stats["decode_steps_run"] > 0
    _assert_identical(ref, out)
    with pytest.raises(ValueError, match="drafter"):
        _engine(tlm, spec_drafter="nope")
    with pytest.raises(ValueError, match="ROADMAP"):
        _engine(tlm, paged=False)


def test_spec_flags_configure_the_engine(lms):
    """The ``serving_spec_*`` flags (PADDLE_TPU_SERVING_SPEC_* in the
    environment) configure an engine built without arguments."""
    _, tlm = lms[VOCAB]
    names = ("serving_speculative", "serving_spec_gamma",
             "serving_spec_drafter", "serving_spec_layers",
             "serving_spec_ngram", "serving_spec_ngram_min")
    for name, value in zip(names, ("1", "3", "truncated", "1", "4", "1")):
        flags.set_flag(name, value)
    try:
        with serving.Engine(tlm, slots=1, device="cpu") as eng:
            assert (eng._speculative, eng._spec_gamma, eng._spec_kind,
                    eng._spec_layers) == (True, 3, "truncated", 1)
            assert (eng._drafter.max_n, eng._drafter.min_n) == (4, 1)
        flags.set_flag("serving_spec_layers", 0)
        with serving.Engine(tlm, slots=1, device="cpu") as eng:
            assert eng._spec_layers == N_LAYER // 2
    finally:
        for name in names:
            flags.set_flag(name, None)


def test_spec_preemption_under_small_pool_leaks_nothing(lms):
    """Pool-dry preemption under speculation: mandatory write positions
    walk the plain engine's pressure ladder, draft positions grow only
    best-effort; the preempted request re-prefills and gives the JAX
    package's tokens, and every block comes back."""
    jlm, tlm = lms[VOCAB]
    reqs = [([1] + list(range(3, 15)), 32), ([1] + list(range(5, 17)), 32)]
    ref = jserving.sequential_generate(jlm, reqs)
    with _engine(tlm, slots=2, block_size=8, num_blocks=9,
                 prefix_cache=False, spec_gamma=4) as eng:
        out = eng.generate_many([p for p, _ in reqs],
                                [m for _, m in reqs])
        stats = dict(eng.stats)
        assert eng._pool.used == 0
    _assert_identical(ref, out)
    assert stats["preemptions"] >= 1 and stats["spec_dispatches"] > 0


def test_spec_eos_inside_accepted_draft(lms):
    """With the natural end_id=2: requests whose greedy continuation
    ends in EOS are served by a truncated drafter at full depth (its
    drafts are the model's own tokens, so they are accepted past the
    EOS position) and by the port's plain engine. EOS must land inside
    an accepted draft, truncate the emission there, and the tokens equal
    the plain engine's and the JAX package's ``sequential_generate``."""
    jlm, tlm = lms[2]
    cands = _requests(14, 40, min_new=24, max_new=24)
    seq = serving.sequential_generate(tlm, cands)
    reqs = [r for r, (t, _) in zip(cands, seq)
            if len(t) >= 3 and t[-1] == 2][:3]
    assert len(reqs) == 3
    ref = jserving.sequential_generate(jlm, reqs)
    inside = []
    with _engine(tlm, slots=2, spec_gamma=4, spec_drafter="truncated",
                 spec_layers=N_LAYER) as eng:
        real = eng._spec_step_impl

        def watch(st, btab, dn, out, sampled=False):
            drafts = dn.clone()
            real(st, btab, dn, out, sampled)
            c = dn.shape[1]
            for s in range(dn.shape[0]):
                ne = int(out[s, c])
                # EOS emitted at j = ne-1 >= 1 that was itself an
                # accepted draft (draft j+1 sits in column j+1)
                if ne > 1 and out[s, c + 1] and int(out[s, ne - 1]) == 2 \
                        and ne <= int(drafts[s, 0]) \
                        and int(drafts[s, ne]) == 2:
                    inside.append(s)
        eng._spec_step_impl = watch
        out = eng.generate_many([p for p, _ in reqs],
                                [m for _, m in reqs])
    with serving.Engine(tlm, slots=2, prefill_chunk=4, block_size=4,
                        device="cpu") as plain:
        base = plain.generate_many([p for p, _ in reqs],
                                   [m for _, m in reqs])
    assert inside
    assert [t for t, _ in out] == [t for t, _ in base]
    _assert_identical(ref, out)
    assert all(t[-1] == 2 for t, _ in out)


@pytest.mark.parametrize("drafter, body, name", [
    ("ngram", "_spec_step_impl", "scoring"),
    ("truncated", "_draft_truncated_impl", "drafting")])
def test_spec_dispatch_failure_raises_naming_the_call(lms, drafter, body,
                                                      name):
    """A failing scoring or drafting dispatch fails the requests with an
    error that names it; nothing falls back to the plain step."""
    _, tlm = lms[VOCAB]

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch refused")
    with _engine(tlm, spec_gamma=2, spec_drafter=drafter) as eng:
        setattr(eng, body, broken)
        req = eng.submit([1] + [5, 6] * 6, 12)
        with pytest.raises(RuntimeError,
                           match="speculative %s dispatch failed" % name):
            req.result(timeout=60)
        assert eng.stats["decode_steps_run"] == 0
