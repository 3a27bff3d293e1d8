"""paddle_tpu_torch.serving's paged KV pool, prefix cache and sampling
tier: the port of ``tests/test_kvpool.py``.

``tests/test_torch_serving.py`` and ``tests/test_torch_sampling.py``
already hold the broad paged contract against the JAX package (slot
recycling, chunked prefill, a prefix hit with copy-on-write, preemption
under a small pool, sampled draws in distribution, sampled engine
identities). This module ports the rest, each case its own test:

  * host accounting units: ``bytes_per_block``, ``BlockPool`` refcounts
    and FIFO recycling, ``RadixCache`` match/insert/LRU-evict;
  * ``SamplingParams`` validation and its dict (wire) form;
  * a shared 10-token system prompt across 8 requests skips the cached
    prefill chunks (hit counters and chunk counts exact) at token
    identity with the JAX package's ``sequential_generate``;
  * copy-on-write on a fully block-aligned cached prompt;
  * preemption and resume (greedy, and seeded sampling reproducing
    itself across preemption), the pool drained to 0 blocks after;
  * a zero-block admission under pressure yields instead of evicting
    the head-of-line request (no ping-pong);
  * seeded sampling reproducible, temperature 0 bitwise greedy, and a
    megastep-4 engine drawing the single-step engine's tokens.

The replica-wire, SLO-gate and metrics-gauge cases of
``tests/test_kvpool.py`` (its ``test_sampling_over_replica_wire_and_
router_journal``, ``test_kv_rows_slo_gate_and_watch_line`` and
``test_metrics_gauges_reflect_pool``) run through the fleet, SLO and
monitor tiers, whose port is held by tests/test_torch_fleet.py,
tests/test_torch_slo.py and tests/test_torch_telemetry.py.

Scores (sums of fp32 log-probs) are compared at rtol 1e-5 / atol 1e-5
against the JAX package (the packages sum in other orders).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as JT
from paddle_tpu.models.transformer_infer import TransformerLMInfer as JaxLM
from paddle_tpu_torch import serving
from paddle_tpu_torch.models.transformer_infer import TransformerLMInfer
from paddle_tpu_torch.serving import kvpool
from paddle_tpu_torch.serving.sampling import SamplingParams

N_LAYER, N_HEAD, D_MODEL, MAX_LEN, VOCAB = 1, 2, 32, 32, 40
BS = 4                        # block_size: small so short prompts cache


@pytest.fixture(scope="module")
def lms():
    """(JAX model, port model) on the same weights; end_id past the
    vocabulary, so decode lengths (and pool pressure) are fixed."""
    main, startup = jfluid.Program(), jfluid.Program()
    scope = jfluid.Scope()
    with jfluid.program_guard(main, startup), jfluid.scope_guard(scope):
        JT.transformer_lm(vocab_size=VOCAB, max_len=MAX_LEN,
                          n_layer=N_LAYER, n_head=N_HEAD, d_model=D_MODEL,
                          d_inner=64)
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        jlm = JaxLM(main, scope, N_LAYER, N_HEAD, D_MODEL, MAX_LEN,
                    end_id=VOCAB)
    tlm = TransformerLMInfer.from_program(main, scope, N_LAYER, N_HEAD,
                                          D_MODEL, MAX_LEN, end_id=VOCAB,
                                          device="cpu")
    return jlm, tlm


@pytest.fixture(scope="module")
def eng(lms):
    """The shared paged engine (block_size 4, auto pool = 16 blocks,
    prefix cache on)."""
    e = serving.Engine(lms[1], slots=2, prefill_chunk=4, block_size=BS,
                       device="cpu")
    assert e._paged and e._pool.num_blocks == 2 * (MAX_LEN // BS)
    yield e
    e.close()


@pytest.fixture(scope="module")
def shared_prefix():
    rng = np.random.RandomState(101)
    return [1] + rng.randint(3, VOCAB, 9).tolist()   # 10 tokens


def _ident(seq, out):
    for i, ((st, ss), (et, es)) in enumerate(zip(seq, out)):
        assert st == et, "request %d diverged: %r vs %r" % (i, st, et)
        np.testing.assert_allclose(es, ss, rtol=1e-5, atol=1e-5)


# -- host accounting units -------------------------------------------------

def test_bytes_per_block_accounting():
    # 2 (K and V) * L * H * bs * dk * dtype
    assert kvpool.bytes_per_block(3, 4, 16, 64, 4) \
        == 2 * 3 * 4 * 16 * 64 * 4
    assert kvpool.bytes_per_block(1, 1, 1, 1, 2) == 4
    # quantized: one code byte per element + one f32 scale per vector
    assert kvpool.bytes_per_block(3, 4, 16, 64, kv_quant="fp8") \
        == 2 * 3 * 4 * 16 * (64 + 4)


def test_block_pool_alloc_free_share_refcounts():
    pool = kvpool.BlockPool(4, 16)
    a = pool.alloc(2)
    assert a == [0, 1] and pool.used == 2 and pool.free_blocks == 2
    assert pool.alloc(3) is None          # all-or-nothing
    pool.share(a[0])
    pool.free(a[0])                       # still referenced (shared)
    assert pool.used == 2 and pool.refcount(a[0]) == 1
    pool.free(a[0])
    assert pool.used == 1                 # now back on the free list
    pool.free(a[1])
    assert pool.used == 0
    with pytest.raises(ValueError):
        pool.free(a[1])                   # double free is loud
    with pytest.raises(ValueError):
        pool.share(99)                    # share of unreferenced block
    # recycled FIFO: determinism of block assignment
    assert pool.alloc(4) == [2, 3, 0, 1]


def test_radix_cache_match_insert_evict():
    pool = kvpool.BlockPool(8, 2)
    cache = kvpool.RadixCache(2, pool)
    toks = [5, 6, 7, 8, 9, 10]
    blocks = pool.alloc(3)                # request owns 3 full blocks
    assert cache.insert(toks, blocks) == 3
    assert cache.blocks_cached() == 3
    # a second publisher of the same prefix creates nothing new
    dup = pool.alloc(3)
    assert cache.insert(toks, dup) == 0
    for b in dup:
        pool.free(b)
    # match takes reader refs and reports hit tokens
    got, n = cache.match([5, 6, 7, 8, 99, 100])
    assert got == blocks[:2] and n == 4
    assert cache.hits == 1 and cache.hit_tokens == 4
    _, n0 = cache.match([42, 43])
    assert n0 == 0 and cache.misses == 1
    # the original owner retires: cache refs keep the chain alive
    for b in blocks:
        pool.free(b)
    assert pool.used == 3
    # eviction skips blocks a reader still references: only the
    # unreferenced leaf [9, 10] is evictable now
    assert cache.evict(3) == 1 and cache.evictions == 1
    for b in got:
        pool.free(b)
    assert cache.evict(5) == 2
    assert pool.used == 0 and cache.blocks_cached() == 0


def test_sampling_params_validation_and_wire():
    sp = SamplingParams(temperature=0.7, top_k=5, top_p=0.9, seed=42)
    assert SamplingParams.from_dict(sp.to_dict()).to_dict() \
        == sp.to_dict()
    assert SamplingParams().greedy and not sp.greedy
    # misspelled knobs must not silently run greedy, and non-dict wire
    # payloads raise ValueError (not AttributeError)
    for bad in ({"temperature": -1}, {"top_k": -2}, {"top_p": 0.0},
                {"top_p": 1.5}, {"seed": -1}, {"temp": 0.9},
                {"topK": 4}, "hot", [0.7], 42):
        with pytest.raises(ValueError):
            SamplingParams.from_dict(bad)


# -- prefix cache: hit vs cold, COW ----------------------------------------

def test_prefix_cache_hit_skips_prefill_chunks(eng, lms, shared_prefix):
    """8 requests sharing a 10-token system prompt: the cold first one
    publishes 2 full blocks; every later admission matches them and
    skips those prefill chunks, at token identity."""
    jlm, _ = lms
    rng = np.random.RandomState(7)
    reqs = [(list(shared_prefix) + rng.randint(3, VOCAB, 2).tolist(), 6)
            for _ in range(8)]
    seq = jserving.sequential_generate(jlm, reqs)
    h0, m0 = eng.stats["prefix_hits"], eng.stats["prefix_misses"]
    c0, t0 = eng.stats["prefill_chunks"], eng.stats["prefix_hit_tokens"]
    first = eng.submit(*reqs[0])
    out = [first.result(timeout=60)]
    rest = [eng.submit(p, m) for p, m in reqs[1:]]
    out += [h.result(timeout=60) for h in rest]
    _ident(seq, out)
    assert eng.stats["prefix_hits"] - h0 == 7
    assert eng.stats["prefix_misses"] - m0 == 1
    # every hit skipped the 2 cached blocks' 8 positions
    assert eng.stats["prefix_hit_tokens"] - t0 == 7 * 8
    chunks = eng.stats["prefill_chunks"] - c0
    dense_chunks = sum(-(-(len(p) - 1) // 4) for p, _ in reqs)
    assert chunks == dense_chunks - 7 * 2


def test_cow_on_fully_cached_block_aligned_prompt(eng, lms, shared_prefix):
    """A prompt that IS a cached block-aligned chain (8 tokens = 2
    blocks) decodes through a copy-on-write of the last shared block:
    the chain stays intact and the output is the sequential one."""
    jlm, _ = lms
    prompt = list(shared_prefix[:8])
    eng.submit(prompt + [3], 2).result(timeout=60)     # publish the chain
    [want] = jserving.sequential_generate(jlm, [(prompt, 5)])
    cow0 = eng.stats["cow_copies"]
    r1 = eng.submit(prompt, 5).result(timeout=60)
    r2 = eng.submit(prompt, 5).result(timeout=60)
    assert eng.stats["cow_copies"] >= cow0 + 2
    assert r1[0] == want[0] == r2[0]
    np.testing.assert_allclose(r1[1], want[1], rtol=1e-5, atol=1e-5)


# -- preemption-and-resume -------------------------------------------------

def _tiny_pool_engine(tlm):
    """9 blocks of 4 positions: two 24-token decodes (7 blocks each)
    cannot coexist, so the later-admitted request is preempted and
    resumed. Prefix cache off: pressure reaches the preemption rung."""
    return serving.Engine(tlm, slots=2, prefill_chunk=4, block_size=BS,
                          num_blocks=9, prefix_cache=False, device="cpu")


def test_preemption_and_resume_token_identical(lms):
    jlm, tlm = lms
    rng = np.random.RandomState(13)
    reqs = [([1] + rng.randint(3, VOCAB, 3).tolist(), 24)
            for _ in range(2)]
    seq = jserving.sequential_generate(jlm, reqs)
    with _tiny_pool_engine(tlm) as e:
        hs = [e.submit(p, m) for p, m in reqs]
        out = [h.result(timeout=120) for h in hs]
        _ident(seq, out)
        assert e.stats["preemptions"] >= 1
        assert sum(h.preemptions for h in hs) == e.stats["preemptions"]
        assert e._pool.used == 0          # no leak through the churn


def test_preempted_seeded_sampling_reproduces(lms):
    """The counter-keyed draws restart with the re-prefill, so two runs
    of the same preempting sampled workload emit the same tokens."""
    _, tlm = lms
    rng = np.random.RandomState(17)
    reqs = [([1] + rng.randint(3, VOCAB, 3).tolist(), 24)
            for _ in range(2)]
    sp = {"temperature": 0.8, "top_k": 12, "seed": 29}
    runs = []
    with _tiny_pool_engine(tlm) as e:
        for _ in range(2):
            hs = [e.submit(p, m, sampling=sp) for p, m in reqs]
            runs.append([h.result(timeout=120)[0] for h in hs])
        assert e.stats["preemptions"] >= 2
        assert e._pool.used == 0
    assert runs[0] == runs[1]
    greedy = serving.sequential_generate(tlm, reqs)
    assert runs[0] != [t for t, _ in greedy]


def test_zero_block_admission_yields_no_pingpong(lms):
    """The pool holds exactly one request's working set: the second
    admission reaches pressure holding zero blocks and yields rather
    than evicting the older request; admission priority is kept across
    preemption, so the pair cannot ping-pong."""
    jlm, tlm = lms
    rng = np.random.RandomState(31)
    reqs = [([1] + rng.randint(3, VOCAB, 3).tolist(), 29),
            ([1] + rng.randint(3, VOCAB, 3).tolist(), 24)]
    seq = jserving.sequential_generate(jlm, reqs)
    with serving.Engine(tlm, slots=2, prefill_chunk=4, block_size=BS,
                        num_blocks=8, prefix_cache=False,
                        device="cpu") as e:
        hs = [e.submit(p, m) for p, m in reqs]
        out = [h.result(timeout=120) for h in hs]
        _ident(seq, out)
        assert hs[0].preemptions == 0
        assert hs[1].preemptions >= 1
        assert e._pool.used == 0


# -- engine-level sampling contracts ---------------------------------------

def test_seeded_sampling_reproducible_and_temp0_bitwise_greedy(eng):
    prompt = [1, 5, 9]
    sp = {"temperature": 0.9, "top_k": 0, "top_p": 0.95, "seed": 7}
    t1, s1 = eng.submit(prompt, 8, sampling=sp).result(timeout=60)
    t2, s2 = eng.submit(prompt, 8, sampling=sp).result(timeout=60)
    assert t1 == t2 and s1 == s2          # same seed, same tokens
    other, _ = eng.submit(prompt, 8, sampling=dict(sp, seed=8)).result(
        timeout=60)
    g0, sc0 = eng.submit(prompt, 8).result(timeout=60)
    gt, sct = eng.submit(prompt, 8, sampling={"temperature": 0.0,
                                               "seed": 99}).result(
        timeout=60)
    assert g0 == gt and sc0 == sct        # temperature 0 is greedy
    assert t1 != g0 or other != g0        # sampling actually samples
    with pytest.raises(ValueError):
        eng.submit(prompt, 4, sampling={"temperature": -0.5})


def test_megastep_sampled_matches_single_step(eng, lms):
    """The draw counter rides the state, so a K=4 engine draws the K=1
    engine's tokens at the same seed."""
    sp = {"temperature": 0.9, "top_k": 8, "seed": 31}
    reqs = [([1, 6, 11], 12), ([1, 7], 10)]
    one = [eng.submit(p, m, sampling=sp).result(timeout=60)
           for p, m in reqs]
    with serving.Engine(lms[1], slots=2, prefill_chunk=4, block_size=BS,
                        megastep=4, device="cpu") as mega:
        fused = [mega.submit(p, m, sampling=sp).result(timeout=60)
                 for p, m in reqs]
        assert mega.stats["megastep_dispatches"] > 0
    assert [t for t, _ in fused] == [t for t, _ in one]
    for (_, sf), (_, so) in zip(fused, one):
        np.testing.assert_allclose(sf, so, rtol=1e-6, atol=1e-6)
