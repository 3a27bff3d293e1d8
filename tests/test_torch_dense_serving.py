"""The dense ``paged=False`` serving layout of paddle_tpu_torch against
the JAX package, and the ``Request`` timing fields.

The LM is ``transformer_lm(vocab 128, max_len 32, 2 layers, 2 heads,
d_model 64, d_inner 128)`` initialized by ``paddle_tpu``, replayed into
the port with ``TransformerLMInfer.from_program`` on the CPU. Pinned:

  * ``_step_logits_slots`` (ragged per-slot depths, one slot masked) and
    ``_prefill_chunk_slot`` (a padded chunk) against the JAX methods on
    the same caches: logits and caches at rtol 1e-5 / atol 1e-5 (fp32,
    the packages sum in other orders), and a masked slot's cache
    bitwise untouched;
  * the dense engine's greedy tokens equal the JAX dense engine's, the
    port's ``sequential_generate`` and the port's paged engine (scores
    at rtol 1e-4); megastep 8 is bitwise megastep 1 (tokens and
    scores); seeded sampled requests draw identical tokens in the dense
    and the paged engine; the dense route never calls the paged
    attention op;
  * ``paged=False`` refuses ``speculative=True`` and ``kv_quant``, as
    the JAX package does;
  * ``Request.queue_wait <= ttft``, ``tpot`` is 0.0 for a one-token
    request, and ``latency()`` has the JAX package's keys.

No EOS golden is used: ``end_id`` is past the vocabulary except where a
test says so.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as JT
from paddle_tpu.models.transformer_infer import TransformerLMInfer as JaxLM
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import serving
from paddle_tpu_torch.models.transformer_infer import TransformerLMInfer
from paddle_tpu_torch.ops import paged_attention as TPA

VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER = 128, 32, 2, 2, 64, 128
DK = D_MODEL // N_HEAD


@pytest.fixture(scope="module")
def lms():
    """(JAX model, port model), end_id past the vocabulary."""
    main, startup = jfluid.Program(), jfluid.Program()
    scope = jfluid.Scope()
    with jfluid.program_guard(main, startup), jfluid.scope_guard(scope):
        JT.transformer_lm(vocab_size=VOCAB, max_len=MAX_LEN,
                          n_layer=N_LAYER, n_head=N_HEAD, d_model=D_MODEL,
                          d_inner=D_INNER)
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        jlm = JaxLM(main, scope, N_LAYER, N_HEAD, D_MODEL, MAX_LEN,
                    end_id=VOCAB)
    tlm = TransformerLMInfer.from_program(main, scope, N_LAYER, N_HEAD,
                                          D_MODEL, MAX_LEN, end_id=VOCAB,
                                          device="cpu")
    return jlm, tlm


def _requests(seed, n, max_prompt=13, min_new=4, max_new=18):
    rng = np.random.default_rng(seed)
    return [([1] + rng.integers(3, VOCAB, int(rng.integers(0, max_prompt))
                                ).tolist(),
             int(rng.integers(min_new, max_new + 1))) for _ in range(n)]


def _serve(model, reqs, sampling=None, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("prefill_chunk", 4)
    with serving.Engine(model, **kw) as eng:
        eng.warmup(sampled=sampling is not None)
        hs = [eng.submit(p, m, sampling=None if sampling is None
                         else sampling[i])
              for i, (p, m) in enumerate(reqs)]
        out = [h.result(timeout=120) for h in hs]
        return out, dict(eng.stats), hs


def _caches(rng, rows):
    shape = (rows, N_HEAD, MAX_LEN, DK)
    return {("k%d" % i if h == 0 else "v%d" % i):
            rng.normal(size=shape).astype(np.float32)
            for i in range(N_LAYER) for h in (0, 1)}


def test_step_logits_slots_matches_jax(lms):
    """4 slots at ragged depths, slot 2 masked (its write must not land,
    its logits are never read)."""
    jlm, tlm = lms
    rng = np.random.default_rng(0)
    caches = _caches(rng, 4)
    tok = rng.integers(3, VOCAB, 4).astype(np.int32)
    pos = np.array([0, 7, 20, 31], np.int32)
    mask = np.array([True, True, False, True])
    jl, js = jlm._step_logits_slots(
        jnp.asarray(tok), {k: jnp.asarray(v) for k, v in caches.items()},
        jnp.asarray(pos), write_mask=jnp.asarray(mask))
    ts = {k: torch.from_numpy(v.copy()) for k, v in caches.items()}
    tl, ts = tlm._step_logits_slots(
        torch.from_numpy(tok).long(), ts, torch.from_numpy(pos).long(),
        write_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                               rtol=1e-5, atol=1e-5)
    for k in caches:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(ts[k].numpy()[2], caches[k][2])
    # unmasked slots wrote exactly their own position
    changed = np.any(ts["k0"].numpy() != caches["k0"], axis=(1, 3))
    expect = np.zeros_like(changed)
    expect[[0, 1, 3], pos[[0, 1, 3]]] = True
    np.testing.assert_array_equal(changed, expect)


def test_step_logits_slots_unmasked_matches_jax(lms):
    jlm, tlm = lms
    rng = np.random.default_rng(1)
    caches = _caches(rng, 3)
    tok = rng.integers(3, VOCAB, 3).astype(np.int32)
    pos = np.array([5, 0, 12], np.int32)
    jl, js = jlm._step_logits_slots(
        jnp.asarray(tok), {k: jnp.asarray(v) for k, v in caches.items()},
        jnp.asarray(pos))
    ts = {k: torch.from_numpy(v.copy()) for k, v in caches.items()}
    tl, ts = tlm._step_logits_slots(torch.from_numpy(tok).long(), ts,
                                    torch.from_numpy(pos).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for k in caches:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start, n_valid", [(0, 8), (13, 5), (29, 2)])
def test_prefill_chunk_slot_matches_jax(lms, start, n_valid):
    """A chunk of 8 into slot 1 of 3; the padded tail and the other
    slots stay as they were."""
    jlm, tlm = lms
    rng = np.random.default_rng(2 + start)
    caches = _caches(rng, 3)
    toks = rng.integers(3, VOCAB, 8).astype(np.int32)
    js = jlm._prefill_chunk_slot(
        {k: jnp.asarray(v) for k, v in caches.items()}, jnp.int32(1),
        jnp.asarray(toks), jnp.int32(start), jnp.int32(n_valid))
    ts = {k: torch.from_numpy(v.copy()) for k, v in caches.items()}
    tlm._prefill_chunk_slot(ts, 1, torch.from_numpy(toks).long(), start,
                            n_valid)
    for k in caches:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5, atol=1e-5)
        for s in (0, 2):
            np.testing.assert_array_equal(ts[k].numpy()[s], caches[k][s])
    changed = np.any(ts["v1"].numpy()[1] != caches["v1"][1], axis=(0, 2))
    np.testing.assert_array_equal(
        np.nonzero(changed)[0], np.arange(start, start + n_valid))


def test_dense_engine_matches_jax_sequential_and_paged(lms, monkeypatch):
    jlm, tlm = lms
    calls = []
    real = TPA.paged_attention

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(TPA, "paged_attention", counted)
    reqs = _requests(0, 10)
    assert max(len(p) for p, _ in reqs) > 4          # multi-chunk prefill
    with jserving.Engine(jlm, slots=3, prefill_chunk=4,
                         paged=False) as eng:
        ref = eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])
    dense, stats, _ = _serve(tlm, reqs, slots=3, paged=False)
    assert not calls and stats["kv_peak_blocks"] == 0
    assert stats["retirements"] == len(reqs)
    paged, _, _ = _serve(tlm, reqs, slots=3, block_size=4)
    assert calls
    seq = serving.sequential_generate(tlm, reqs)
    for other in (ref, paged, seq):
        for i, ((a, sa), (b, sb)) in enumerate(zip(dense, other)):
            assert a == b, "request %d: %r vs %r" % (i, a, b)
            np.testing.assert_allclose(sa, sb, rtol=1e-4, atol=1e-4)


def test_dense_megastep_is_bitwise_single_step(lms):
    _, tlm = lms
    reqs = _requests(1, 6, min_new=12, max_new=24)
    one, _, _ = _serve(tlm, reqs, slots=3, paged=False)
    eight, stats, _ = _serve(tlm, reqs, slots=3, paged=False, megastep=8)
    assert stats["megastep_dispatches"] > 0
    assert eight == one


def test_dense_sampled_equals_paged_sampled(lms):
    _, tlm = lms
    reqs = _requests(2, 6, min_new=8, max_new=16)
    samp = [None if i == 2 else dict(temperature=0.9, top_k=8, top_p=0.95,
                                     seed=40 + i) for i in range(6)]
    dense, _, _ = _serve(tlm, reqs, sampling=samp, slots=3, paged=False)
    dense4, s4, _ = _serve(tlm, reqs, sampling=samp, slots=3, paged=False,
                           megastep=4)
    paged, _, _ = _serve(tlm, reqs, sampling=samp, slots=3, block_size=4)
    assert s4["megastep_dispatches"] > 0
    assert [t for t, _ in dense] == [t for t, _ in paged]
    assert dense4 == dense
    greedy, _, _ = _serve(tlm, reqs, slots=3, paged=False)
    assert [t for t, _ in dense] != [t for t, _ in greedy]
    assert dense[2] == greedy[2]


def test_dense_engine_recycles_slots_with_eos(lms):
    """end_id inside the vocabulary (2): requests may retire early; the
    dense engine still gives the paged engine's and the JAX dense
    engine's tokens with one slot recycled many times."""
    jlm, tlm = lms
    jlm2 = JaxLM.__new__(JaxLM)
    jlm2.__dict__.update(jlm.__dict__)
    jlm2.end_id = 2
    tlm.end_id = 2
    try:
        reqs = _requests(3, 8)
        dense, _, _ = _serve(tlm, reqs, slots=1, paged=False)
        paged, _, _ = _serve(tlm, reqs, slots=1)
    finally:
        tlm.end_id = VOCAB
    with jserving.Engine(jlm2, slots=1, prefill_chunk=4,
                         paged=False) as eng:
        ref = eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])
    assert [t for t, _ in dense] == [t for t, _ in paged] == \
        [t for t, _ in ref]


@pytest.mark.parametrize("kw", [{"speculative": True},
                                {"kv_quant": "int8"}],
                         ids=["speculative", "kv_quant"])
def test_dense_refuses_pool_options(lms, kw):
    _, tlm = lms
    with pytest.raises(ValueError, match="paged KV layout"):
        serving.Engine(tlm, slots=1, device="cpu", paged=False, **kw)


def test_serving_paged_flag_selects_dense(lms):
    _, tlm = lms
    tflags.set_flag("serving_paged", "off")
    try:
        with serving.Engine(tlm, slots=2, device="cpu") as eng:
            assert not eng._paged and eng._pool is None
            assert eng._state["k0"].shape == (2, N_HEAD, MAX_LEN, DK)
            toks, _ = eng.submit([1, 5, 9], 4).result(30)
    finally:
        tflags.set_flag("serving_paged", None)
    assert toks == serving.sequential_generate(tlm, [([1, 5, 9], 4)])[0][0]


# -- Request timing fields -----------------------------------------------

@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_request_timing_fields(lms, paged):
    _, tlm = lms
    reqs = [([1, 4, 5, 6, 7, 8], 1), ([1, 9], 6), ([1] + [3] * 9, 1),
            ([1, 10, 11], 9)]
    _, _, hs = _serve(tlm, reqs, slots=2, paged=paged)
    for h, (_, m) in zip(hs, reqs):
        lat = h.latency()
        assert 0.0 <= h.queue_wait <= h.ttft
        assert h.t_enqueue <= h.t_admit <= h.t_first_token <= h.t_retire
        assert lat["tokens"] == m == len(h.tokens)
        if m == 1:
            assert h.tpot == 0.0
        else:
            assert h.tpot >= 0.0
        assert lat["queue_wait"] == h.queue_wait and lat["ttft"] == h.ttft
        assert lat["prefill_chunks"] == h.prefill_chunks
    jreq = jserving.Request([1, 2], 3)
    assert set(hs[0].latency()) == set(jreq.latency())
    fresh = serving.Request([1, 2], 3)
    assert fresh.queue_wait is None and fresh.ttft is None
    assert fresh.tpot is None
