"""paddle_tpu_torch.models.transformer_infer against the JAX package.

A ``transformer_lm(vocab 64, max_len 48, 2 layers, 2 heads, d_model 32,
d_inner 64)`` is built and initialized by ``paddle_tpu``; its parameter
stream (``extract_params``, converted to numpy) is replayed into the
port with ``from_stream(device="cpu")``. The dense step, the paged
decode step (block-kernel and gather paths) and the paged chunk prefill
are held against the JAX methods on the same inputs: logits at atol
1e-4 (fp32; the two packages sum in different orders), pool contents
after masked writes at atol 1e-5 — the written K/V vectors are one
matmul each, and a masked row must leave its target untouched in both.
On the card the same code runs with TF32 off (``chip_smoke.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import transformer
from paddle_tpu.models.transformer_infer import (
    TransformerLMInfer as JaxLM, extract_params)
from paddle_tpu_torch.models import transformer_infer as TI

VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER = 64, 48, 2, 2, 32, 64
DK = D_MODEL // N_HEAD


@pytest.fixture(scope="module")
def lms():
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.scope_guard(scope):
        transformer.transformer_lm(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER)
        fluid.Executor(fluid.CPUPlace()).run(startup)
        jlm = JaxLM(main, scope, N_LAYER, N_HEAD, D_MODEL, MAX_LEN)
        stream = [(role, [np.asarray(a) for a in arrays])
                  for role, arrays in extract_params(main, scope)]
    tlm = TI.TransformerLMInfer.from_stream(
        stream, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, device="cpu")
    return jlm, tlm, stream


def _np(x):
    return np.asarray(x)


def test_stream_replay_checks_roles(lms):
    _, tlm, stream = lms
    np.testing.assert_array_equal(tlm.word_emb.numpy(), stream[0][1][0])
    bad = list(stream)
    bad[2], bad[6] = bad[6], bad[2]
    with pytest.raises(AssertionError, match="mismatch"):
        TI.params_from_stream(bad, N_LAYER)
    with pytest.raises(AssertionError, match="unconsumed"):
        TI.params_from_stream(stream + [stream[-1]], N_LAYER)


def test_init_stream_replays_like_the_builder(lms):
    """``init_stream`` yields the builder's stream layout (roles and
    shapes), so it replays through the same cursor."""
    _, _, stream = lms
    mine = TI.init_stream(VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL,
                          D_INNER, seed=0)
    assert [r for r, _ in mine] == [r for r, _ in stream]
    assert [[a.shape for a in arrs] for _, arrs in mine] == \
        [[a.shape for a in arrs] for _, arrs in stream]
    np.testing.assert_allclose(mine[1][1][0], stream[1][1][0], atol=1e-6)


def test_dense_step_matches_jax(lms):
    jlm, tlm, _ = lms
    rng = np.random.default_rng(0)
    toks = rng.integers(3, VOCAB, size=(6, 3))
    js, ts = jlm._init_state(3), tlm._init_state(3)
    for t in range(toks.shape[0]):
        jl, js = jlm._step_logits(jnp.asarray(toks[t], jnp.int32), js, t)
        tl, ts = tlm._step_logits(torch.from_numpy(toks[t]), ts, t)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
    for i in range(N_LAYER):
        np.testing.assert_allclose(ts["k%d" % i].numpy(),
                                   _np(js["k%d" % i]), atol=1e-5)


def _pools(rng, nb=20, bs=4):
    shape = (nb, N_LAYER, N_HEAD, bs, DK)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("block_kernel", [True, False],
                         ids=["kernel", "gather"])
def test_paged_step_matches_jax(lms, block_kernel):
    """One decode step over a random pool: 4 slots at ragged depths,
    one masked (its write must drop, its logits are never read). The
    port's pool carries one trash block past the JAX package's, which
    takes the masked write."""
    jlm, tlm, _ = lms
    rng = np.random.default_rng(1)
    bs, nbmax = 4, MAX_LEN // 4
    pk, pv = _pools(rng, nb=4 * nbmax + 4, bs=bs)
    btab = rng.permutation(pk.shape[0])[:4 * nbmax].reshape(
        4, nbmax).astype(np.int32)
    pos = np.array([3, 17, 40, 9], np.int32)
    mask = np.array([True, True, True, False])
    tok = rng.integers(3, VOCAB, size=4).astype(np.int32)
    jstate = {"pool_k": jnp.asarray(pk), "pool_v": jnp.asarray(pv)}
    jl, jstate = jlm._step_logits_paged(
        jnp.asarray(tok), jstate, jnp.asarray(pos), jnp.asarray(btab),
        write_mask=jnp.asarray(mask), block_kernel=block_kernel)
    trash = np.zeros((1,) + pk.shape[1:], np.float32)
    tstate = {"pool_k": torch.from_numpy(np.concatenate([pk, trash])),
              "pool_v": torch.from_numpy(np.concatenate([pv, trash]))}
    tl, tstate = tlm._step_logits_paged(
        torch.from_numpy(tok).long(), tstate,
        torch.from_numpy(pos).long(), torch.from_numpy(btab),
        write_mask=torch.from_numpy(mask), block_kernel=block_kernel)
    np.testing.assert_allclose(tl.numpy()[mask], _np(jl)[mask],
                               atol=1e-4)
    for name in ("pool_k", "pool_v"):
        np.testing.assert_allclose(tstate[name].numpy()[:-1],
                                   _np(jstate[name]), atol=1e-5)
    # the masked slot's target entry is untouched
    blk, off = btab[3, pos[3] // bs], pos[3] % bs
    np.testing.assert_array_equal(
        tstate["pool_k"].numpy()[blk, :, :, off], pk[blk, :, :, off])


@pytest.mark.parametrize("block_kernel", [True, False],
                         ids=["kernel", "gather"])
def test_paged_prefill_matches_jax(lms, block_kernel):
    """A chunk of 8 with 5 valid tokens at cache positions 13..17: the
    padded tail's writes drop in both packages."""
    jlm, tlm, _ = lms
    rng = np.random.default_rng(2)
    bs, nbmax = 4, MAX_LEN // 4
    pk, pv = _pools(rng, bs=bs)
    row = rng.permutation(pk.shape[0])[:nbmax].astype(np.int32)
    toks = rng.integers(3, VOCAB, size=8).astype(np.int32)
    start, n_valid = 13, 5
    jstate = {"pool_k": jnp.asarray(pk), "pool_v": jnp.asarray(pv)}
    jstate = jlm._prefill_chunk_paged(
        jstate, jnp.asarray(toks), jnp.int32(start), jnp.int32(n_valid),
        jnp.asarray(row), block_kernel=block_kernel)
    tstate = {"pool_k": torch.from_numpy(pk.copy()),
              "pool_v": torch.from_numpy(pv.copy())}
    tlm._prefill_chunk_paged(tstate, torch.from_numpy(toks).long(),
                             start, n_valid, torch.from_numpy(row),
                             block_kernel=block_kernel)
    for name in ("pool_k", "pool_v"):
        np.testing.assert_allclose(tstate[name].numpy(),
                                   _np(jstate[name]), atol=1e-5)
    changed = np.any(tstate["pool_k"].numpy() != pk, axis=(1, 2, 4))
    expect = np.zeros_like(changed)
    for p in range(start, start + n_valid):
        expect[row[p // bs], p % bs] = True
    np.testing.assert_array_equal(changed, expect)


def test_pool_write_indexing(lms):
    """Vector (s, c) of k_new [S, H, C, dk] lands at pool[phys[s, c],
    layer, :, off[s, c], :]; entries pointing at num_blocks land in the
    trash block and leave the pool's blocks as they were. The advanced
    index (tensor, slice, tensor) moves the indexed dims to the front
    in torch as in NumPy/JAX: checked, not assumed."""
    _, tlm, _ = lms
    nb, bs = 6, 4
    pools = tlm._init_paged_state(nb, bs)
    assert pools["pool_k"].shape[0] == nb + 1
    rng = np.random.default_rng(3)
    k_new = rng.normal(size=(2, N_HEAD, 3, DK)).astype(np.float32)
    wphys = np.array([[1, 4, nb], [nb, 0, 5]])
    off = np.array([[0, 3, 2], [1, 1, 2]])
    widx = tlm._write_index(torch.from_numpy(wphys),
                            torch.from_numpy(off))
    t = torch.from_numpy(k_new)
    tlm._pool_write(pools, 1, widx, t, t * 2)
    pk = pools["pool_k"].numpy()[:nb]
    want = np.zeros_like(pk)
    for s in range(2):
        for c in range(3):
            if wphys[s, c] < nb:
                want[wphys[s, c], 1, :, off[s, c], :] = k_new[s, :, c]
    np.testing.assert_array_equal(pk, want)
    np.testing.assert_array_equal(pools["pool_v"].numpy()[:nb], 2 * want)


def test_int8_pool_write_matches_jax(lms):
    """Quantize-on-write stores the JAX package's codes and scales."""
    jlm, tlm, _ = lms
    rng = np.random.default_rng(4)
    k_new = rng.normal(size=(2, N_HEAD, 1, DK)).astype(np.float32)
    wphys = np.array([[2], [5]], np.int32)
    off = np.array([[1], [3]], np.int32)
    jp = jlm._init_paged_state(6, 4, kv_quant="int8")
    jp = jlm._pool_write(jp, 0, jnp.asarray(wphys), jnp.asarray(off),
                         jnp.asarray(k_new), jnp.asarray(k_new))
    tp = tlm._init_paged_state(6, 4, kv_quant="int8")
    widx = tlm._write_index(torch.from_numpy(wphys).long(),
                            torch.from_numpy(off).long())
    t = torch.from_numpy(k_new)
    tlm._pool_write(tp, 0, widx, t, t)
    for name in ("pool_k", "pool_v"):         # [:6]: past the trash block
        np.testing.assert_array_equal(tp[name].numpy()[:6], _np(jp[name]))
    for name in ("pool_ks", "pool_vs"):
        np.testing.assert_allclose(tp[name].numpy()[:6], _np(jp[name]),
                                   rtol=1e-6)
