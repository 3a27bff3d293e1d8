"""paddle_tpu_torch.serving.Engine against the JAX package.

The port's engine (``device="cpu"``, greedy) must produce the tokens of
``paddle_tpu.serving.sequential_generate`` on the same weights, through
slot recycling, chunked prefill, a prefix-cache hit with copy-on-write,
and preemption under a small pool; inside the port the block-kernel
and gather paths must agree. Scores (sums of fp32 log-probs) are
compared at rtol 1e-4: the packages sum in different orders.

The LM is ``transformer_lm(vocab 64, max_len 48, 2 layers, 2 heads,
d_model 32, d_inner 64)`` initialized by ``paddle_tpu``; ``end_id`` is
set past the vocabulary so requests run to ``max_new`` (long decodes
cross block boundaries), except in the recycling test, which keeps the
default ``end_id=2`` so natural EOS retirement is exercised too.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer
from paddle_tpu.models.transformer_infer import (
    TransformerLMInfer as JaxLM, extract_params)
from paddle_tpu_torch import flags, serving
from paddle_tpu_torch.models.transformer_infer import TransformerLMInfer

VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER = 64, 48, 2, 2, 32, 64


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


def _requests(seed, n, max_prompt=13, min_new=4, max_new=20, prefix=()):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(1, max_prompt + 1))
        prompt = [1] + list(prefix) + rng.integers(
            3, VOCAB, plen - 1).tolist()
        reqs.append((prompt, int(rng.integers(min_new, max_new + 1))))
    return reqs


def _assert_identical(ref, got):
    for i, ((rt, rs), (gt, gs)) in enumerate(zip(ref, got)):
        assert gt == rt, "request %d diverged: %r vs %r" % (i, gt, rt)
        np.testing.assert_allclose(gs, rs, rtol=1e-4, atol=1e-4)


def _serve(model, reqs, **kw):
    kw.setdefault("device", "cpu")
    with serving.Engine(model, **kw) as eng:
        eng.warmup()
        out = eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])
        return out, dict(eng.stats)


def test_recycling_and_chunked_prefill_match_jax(lms):
    jlm, tlm = lms[2]
    reqs = _requests(0, 10)
    assert max(len(p) for p, _ in reqs) > 4     # multi-chunk prefill
    ref = jserving.sequential_generate(jlm, reqs)
    out, stats = _serve(tlm, reqs, slots=3, prefill_chunk=4)
    _assert_identical(ref, out)
    assert stats["retirements"] == len(reqs) and stats["prefill_chunks"] > 10
    _assert_identical(ref, serving.sequential_generate(tlm, reqs))


def test_prefix_hit_and_cow_match_jax(lms):
    """A block-aligned 8-token prompt is served, then served again (a
    full-prompt hit: activation copy-on-writes the last shared block)
    beside prompts that extend it (partial hits)."""
    jlm, tlm = lms[VOCAB]
    base = [1] + np.random.default_rng(1).integers(3, VOCAB, 7).tolist()
    first = [(base, 12)]
    later = [(base, 15)] + [(base + t, m) for t, m in
                            (([9, 10, 11], 10), ([12] * 6, 14))]
    ref = jserving.sequential_generate(jlm, first + later)
    with serving.Engine(tlm, slots=3, prefill_chunk=4, block_size=4,
                        device="cpu") as eng:
        out = eng.generate_many([p for p, _ in first], [12])
        out += eng.generate_many([p for p, _ in later],
                                 [m for _, m in later])
        stats = dict(eng.stats)
    _assert_identical(ref, out)
    assert stats["prefix_hits"] == 3 and stats["cow_copies"] >= 1
    assert stats["prefix_hit_tokens"] > 0


def test_preemption_under_small_pool_matches_jax(lms):
    """12 blocks of 4 positions hold exactly one max_len request: three
    slots of long requests must preempt and resume."""
    jlm, tlm = lms[VOCAB]
    reqs = _requests(2, 6, max_prompt=14, min_new=20, max_new=30)
    ref = jserving.sequential_generate(jlm, reqs)
    out, stats = _serve(tlm, reqs, slots=3, prefill_chunk=4, block_size=4,
                        num_blocks=12, prefix_cache=False)
    _assert_identical(ref, out)
    assert stats["preemptions"] > 0


def test_block_kernel_equals_gather_inside_the_port(lms):
    _, tlm = lms[VOCAB]
    reqs = _requests(3, 8, min_new=10, max_new=30)
    kern, s1 = _serve(tlm, reqs, slots=4, prefill_chunk=4, block_size=4)
    gath, s2 = _serve(tlm, reqs, slots=4, prefill_chunk=4, block_size=4,
                      block_kernel=False)
    assert [t for t, _ in kern] == [t for t, _ in gath]
    np.testing.assert_allclose([s for _, s in kern],
                               [s for _, s in gath], rtol=1e-5)
    assert s1["decode_steps"] == s2["decode_steps"]


def test_int8_kv_engine_is_deterministic(lms):
    _, tlm = lms[VOCAB]
    reqs = _requests(4, 4)
    a, _ = _serve(tlm, reqs, slots=2, kv_quant="int8")
    b, _ = _serve(tlm, reqs, slots=2, kv_quant="int8")
    assert a == b


@pytest.mark.parametrize("block_kernel", [True, False],
                         ids=["block", "gather"])
def test_fp8_kv_engine_matches_jax(lms, block_kernel):
    """``kv_quant='fp8'``: the port's engine stores e4m3 codes with
    per-vector scales and gives the JAX package's fp8 engine's greedy
    tokens on the same weights (through both attention paths)."""
    jlm, tlm = lms[VOCAB]
    reqs = _requests(4, 6)
    with jserving.Engine(jlm, slots=3, prefill_chunk=4, block_size=4,
                         kv_quant="fp8") as eng:
        ref = eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])
    out, stats = _serve(tlm, reqs, slots=3, prefill_chunk=4, block_size=4,
                        kv_quant="fp8", block_kernel=block_kernel)
    _assert_identical(ref, out)
    with serving.Engine(tlm, slots=1, device="cpu", kv_quant="fp8") as eng:
        assert eng._state["pool_k"].dtype == torch.float8_e4m3fn
        assert eng._state["pool_ks"].dtype == torch.float32
        assert eng._block_bytes < _kvpool_dense_bytes(tlm, eng)


def _kvpool_dense_bytes(tlm, eng):
    from paddle_tpu_torch.serving import kvpool
    return kvpool.bytes_per_block(tlm.n_layer, tlm.n_head, eng._block_size,
                                  tlm.d_model // tlm.n_head)


def test_default_attention_path_selection(lms):
    _, tlm = lms[VOCAB]
    with serving.Engine(tlm, slots=1, device="cpu") as eng:
        assert eng._block_kernel
    bf16 = TransformerLMInfer(
        {"word_emb": tlm.word_emb.numpy(), "pos_emb": tlm.pos_emb.numpy(),
         "w_out": tlm.w_out.numpy(),
         "layers": [{k: v.numpy() for k, v in layer.named_parameters()}
                    for layer in tlm.layers]},
        N_LAYER, N_HEAD, D_MODEL, MAX_LEN, dtype=torch.bfloat16,
        device="cpu")
    with serving.Engine(bf16, slots=1, device="cpu") as eng:
        assert not eng._block_kernel
    with serving.Engine(bf16, slots=1, device="cpu",
                        kv_quant="int8") as eng:
        assert eng._block_kernel


def test_unported_options_raise(lms):
    """The telemetry is ported (tests/test_torch_telemetry.py), so the
    monitor flag no longer refuses the engine; the dense layout
    (tests/test_torch_dense_serving.py) and artifact cold start
    (tests/test_torch_artifact.py) are ported, so ``paged=False`` builds
    a dense engine and a path that holds no artifact raises the
    artifact's own error. Megastep, speculative decode and sampled
    requests are ported (tests/test_torch_megastep.py,
    tests/test_torch_spec.py, tests/test_torch_sampling.py), and their
    flags configure the engine instead of refusing it."""
    _, tlm = lms[VOCAB]
    with serving.Engine(tlm, slots=1, device="cpu", paged=False) as eng:
        assert not eng._paged and eng._pool is None
    with pytest.raises(serving.ArtifactError, match="not a serving"):
        serving.Engine("an/artifact/dir", slots=1, device="cpu")
    flags.set_flag("serving_megastep", 4)
    try:
        with serving.Engine(tlm, slots=1, device="cpu") as eng:
            assert eng._megastep == 4
    finally:
        flags.set_flag("serving_megastep", None)
    flags.set_flag("serving_speculative", "1")
    try:
        with serving.Engine(tlm, slots=1, device="cpu") as eng:
            assert eng._speculative
    finally:
        flags.set_flag("serving_speculative", None)
    # the monitor flag (PADDLE_TPU_MONITOR in the environment) leaves
    # the engine serving
    flags.set_flag("monitor", "1")
    try:
        with serving.Engine(tlm, slots=1, device="cpu") as eng:
            assert len(eng.submit([1, 5], 3).result(30)[0]) == 3
    finally:
        flags.set_flag("monitor", None)
    with serving.Engine(tlm, slots=1, device="cpu") as eng:
        toks, _ = eng.submit([1, 5], 3,
                             sampling={"temperature": 0.7}).result(30)
        assert len(toks) == 3
        toks, _ = eng.submit([1, 5], 3,
                             sampling={"temperature": 0.0}).result(30)
        assert len(toks) == 3
