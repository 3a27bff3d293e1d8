"""paddle_tpu_torch.ops.paged_attention against the JAX package.

The port's plain version (``_attend_plain``, what every CPU tensor runs)
is held against ``paddle_tpu.ops.paged_attention`` on both of its CPU
paths: the lax reference (``force="lax"``) and the Pallas TPU kernel
executed in interpret mode (``force="interpret"``), for fp32, int8 and
fp8-e4m3 pools. So is ``_attend_splits_plain``, the plain emulation of
the CUDA kernel's split-and-merge arithmetic. Inputs are drawn with
numpy from fixed seeds and handed to both packages. Tolerance rtol 1e-5
/ atol 1e-6 on live rows: both sides run the same fp32 online softmax,
so they differ only in summation order. The CUDA kernel itself is
compared with ``_attend_plain`` on the card by ``chip_smoke.py`` (TF32
switched off there, so fp32 products stay fp32).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops import paged_attention as JP
from paddle_tpu_torch.ops import paged_attention as TP


def _case(seed, c, s=4, l=3, h=2, bs=8, dk=16, w=4):
    """A random 5-D pool problem with ragged chains (1..w blocks per
    slot; every row is live for nblk=w), as numpy arrays."""
    rng = np.random.default_rng(seed)
    nb = s * w + 2
    pk = rng.normal(size=(nb, l, h, bs, dk)).astype(np.float32)
    pv = rng.normal(size=(nb, l, h, bs, dk)).astype(np.float32)
    btab = rng.permutation(nb)[:s * w].reshape(s, w).astype(np.int32)
    chain = rng.integers(1, w + 1, size=s)
    chain[0] = w                       # one slot walks the whole table
    qpos = np.stack([rng.integers(0, ch * bs, size=c) for ch in chain])
    qpos[:, -1] = (chain - 1) * bs + rng.integers(0, bs, size=s)
    q = rng.normal(size=(s, h, c, dk)).astype(np.float32)
    return pk, pv, btab, qpos.astype(np.int32), q


def _jax(q, pk, pv, btab, qpos, layer, force, nblk=None, ks=None,
         vs=None):
    return np.asarray(JP.paged_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(btab), jnp.asarray(qpos), nblk=nblk,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
        layer=layer, force=force))


def _port(q, pk, pv, btab, qpos, layer, nblk=None, ks=None, vs=None,
          block_group=1):
    t = torch.from_numpy
    return TP.paged_attention(
        t(q), t(pk), t(pv), t(btab), t(qpos), nblk=nblk,
        k_scale=None if ks is None else t(ks),
        v_scale=None if vs is None else t(vs), layer=layer,
        block_group=block_group).numpy()


def _quantized(pk, pv, quant):
    """JAX's codes and scales for a pool (None scales for fp32). The
    codes stay JAX arrays: numpy has no fp8 type to carry them."""
    if quant == "fp32":
        return jnp.asarray(pk), jnp.asarray(pv), None, None
    dt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[quant]
    ck, sk = JP.quantize_kv(jnp.asarray(pk), dt)
    cv, sv = JP.quantize_kv(jnp.asarray(pv), dt)
    return ck, cv, np.array(sk), np.array(sv)


def _to_torch(codes):
    """A JAX pool (f32, int8 or fp8 codes) as a torch tensor, bitwise."""
    if codes.dtype == jnp.float8_e4m3fn:
        raw = np.asarray(codes).view(np.uint8)
        return torch.from_numpy(raw.copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(codes))


@pytest.mark.parametrize("quant", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("c", [1, 4, 5])
@pytest.mark.parametrize("force", ["lax", "interpret"])
def test_plain_matches_jax(force, c, quant):
    """Ragged chains, layer 1 of a 3-layer 5-D pool; fp32, int8 and fp8
    pools (the port reads JAX's codes bitwise)."""
    pk, pv, btab, qpos, q = _case(10 + c, c)
    ck, cv, ks, vs = _quantized(pk, pv, quant)
    ref = np.asarray(JP.paged_attention(
        jnp.asarray(q), ck, cv, jnp.asarray(btab), jnp.asarray(qpos),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), layer=1,
        force=force))
    t = torch.from_numpy
    got = TP.paged_attention(
        t(q), _to_torch(ck), _to_torch(cv), t(btab), t(qpos),
        k_scale=None if ks is None else t(ks),
        v_scale=None if vs is None else t(vs), layer=1).numpy()
    assert got.dtype == np.float32 and got.shape == q.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _split_case(seed, c, s=5, w=7, bs=8, dk=16):
    """Ragged chains of 1..w blocks in a 2-layer pool; slot 0 walks the
    whole table and the last slot holds one block, so that many splits
    start past its chain."""
    pk, pv, btab, qpos, q = _case(seed, c, s=s, l=2, bs=bs, dk=dk, w=w)
    qpos[-1] = np.minimum(qpos[-1], bs - 1)
    return pk, pv, btab, qpos, q


@pytest.mark.parametrize("quant", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("nblk,splits", [(7, 1), (7, 3), (7, 7), (7, 16),
                                         (4, 3)])
@pytest.mark.parametrize("c", [1, 5, 16])
def test_split_emulation_matches_plain_and_jax(c, nblk, splits, quant):
    """The kernel's split-and-merge arithmetic (``_attend_splits_plain``:
    per-range partials, key classes per warp, empty ranges past a
    chain, merged in split order) against ``_attend_plain`` and JAX's
    lax path on live rows: ragged chains, a slot of one block, splits
    past a chain (splits 7 and 16 > most chains), and an ``nblk`` cap
    (4) below the longest chain (7)."""
    pk, pv, btab, qpos, q = _split_case(20 + c, c)
    ck, cv, ks, vs = _quantized(pk, pv, quant)
    t = torch.from_numpy
    args = (t(q), _to_torch(ck), _to_torch(cv), t(btab), t(qpos), nblk,
            None if ks is None else t(ks), None if vs is None else t(vs))
    got = TP._attend_splits_plain(*args, splits, layer=1).numpy()
    plain = TP._attend_plain(*args, layer=1).numpy()
    lax = np.asarray(JP.paged_attention(
        jnp.asarray(q), ck, cv, jnp.asarray(btab), jnp.asarray(qpos),
        nblk=nblk, k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), layer=1,
        force="lax"))
    live = qpos.max(axis=1) // pk.shape[-2] + 1 <= nblk
    assert live.any() and (nblk == 7 or not live.all())
    for ref in (plain, lax):
        np.testing.assert_allclose(got[live], ref[live], rtol=1e-5,
                                   atol=1e-6)


def test_split_rule():
    """The host's split count: several blocks per SM of 132 at the
    serving shapes, a split per block at a prefill chunk, at least 16
    keys per split, no split a full chain leaves empty."""
    assert TP._splits(32, 8, 1, 16, 16) == 4        # decode: 1,024 blocks
    assert TP._splits(1, 8, 16, 16, 16) == 16       # prefill chunk
    assert TP._splits(8, 8, 5, 16, 16) == 16        # speculative width
    assert TP._splits(32, 8, 1, 128, 16) == 5       # long chains
    assert TP._splits(1, 8, 1, 128, 16) == 64       # at most 64
    assert TP._splits(1, 8, 16, 128, 16) == 64
    assert TP._splits(32, 8, 1, 16, 32) == 4
    assert TP._splits(1, 8, 16, 16, 32) == 16
    assert TP._splits(1, 8, 16, 16, 8) == 8         # 16 keys a split
    assert TP._splits(32, 8, 1, 1, 16) == 1
    assert TP._splits(256, 32, 1, 16, 16) == 1      # the grid is full
    for s, h, c, nbmax, bs in [(32, 8, 1, 16, 16), (1, 8, 16, 14, 16),
                               (3, 2, 7, 128, 4), (1, 1, 33, 9, 1)]:
        sp = TP._splits(s, h, c, nbmax, bs)
        per = -(-nbmax // sp)
        assert 1 <= sp <= min(nbmax, TP._MAX_SPLITS)
        assert (sp - 1) * per < nbmax
        assert per * bs >= 16 or sp == 1


def test_granule_and_shared_memory_rules():
    """cp.async copies 16 bytes where a K/V tile allows, else 8 (1-byte
    codes with bs odd and dk = 8 mod 16), and the wrapper's shared-
    memory reckoning uses the .cu's own constants."""
    assert TP._granule(16, 64, 4) == TP._granule(16, 64, 1) == 16
    assert TP._granule(3, 8, 1) == TP._granule(1, 24, 1) == 8
    assert TP._granule(3, 8, 2) == TP._granule(3, 16, 1) == 16
    src = open(TP._build._CSRC + "/paged_attention.cu").read()
    for name, value in (("NT", 32 * TP._NW), ("QT", TP._QT),
                        ("NS", TP._NS), ("KG", TP._KG),
                        ("SLOTS", TP._SLOTS), ("MAX_DK", TP._MAX_DK),
                        ("MAX_SPLITS", TP._MAX_SPLITS)):
        assert "constexpr int %s = %d;" % (name, value) in src, name
    # f32, bs 16, dk 64: three stages of an 8 KB K/V pair
    assert TP._smem_bytes(16, 64, 4, False) == 3 * 8192
    # int8, bs 16, dk 64: the merge's rows and weights outgrow the ring
    assert 3 * (2048 + 128) < TP._smem_bytes(16, 64, 1, True) == \
        (16 * 66 + 16 * 65) * 4
    assert TP._smem_bytes(1, 256, 1, True) == (16 * 258 + 16 * 65) * 4
    assert TP._smem_bytes(32, 256, 4, False) <= TP._SMEM_LIMIT
    assert TP._smem_bytes(64, 256, 4, False) > TP._SMEM_LIMIT


def test_nblk_bound_and_block_group():
    """A walk bound below the longest chain: rows it covers match JAX's
    lax path; grouping blocks per update changes nothing there."""
    pk, pv, btab, qpos, q = _case(3, 2, w=6)
    nblk = 3
    live = qpos.max(axis=1) // pk.shape[-2] + 1 <= nblk
    assert live.any() and not live.all()
    ref = _jax(q, pk, pv, btab, qpos, 2, "lax", nblk=nblk)
    for grp in (1, 2, 4):
        got = _port(q, pk, pv, btab, qpos, 2, nblk=nblk, block_group=grp)
        np.testing.assert_allclose(got[live], ref[live], rtol=1e-5,
                                   atol=1e-6)


def test_per_layer_slice_matches_full_pool():
    pk, pv, btab, qpos, q = _case(4, 3)
    full = _port(q, pk, pv, btab, qpos, 2)
    sliced = _port(q, np.ascontiguousarray(pk[:, 2]),
                   np.ascontiguousarray(pv[:, 2]), btab, qpos, None)
    np.testing.assert_array_equal(full, sliced)


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 3, 16)).astype(np.float32) * 3.0
    x[1, 2] = 0.0                       # all-zero vector: scale 1
    x[2, 0, :4] = [127.0, 0.5, 1.5, -2.5]   # half-way codes round even
    codes, scale = TP.quantize_kv(torch.from_numpy(x), torch.int8)
    jc, js = JP.quantize_kv(jnp.asarray(x), jnp.int8)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_allclose(scale.numpy(), np.asarray(js), rtol=1e-6)
    assert scale[1, 2].item() == 1.0
    back = TP.dequantize_kv(codes, scale).numpy()
    np.testing.assert_allclose(
        back, np.asarray(JP.dequantize_kv(jc, js)), rtol=1e-6)


def test_quantize_kv_fp8_matches_jax():
    """fp8 e4m3 codes equal JAX's bitwise (the scaled value cast with
    no rounding to an integer), scales equal, and dequantizing agrees."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(40, 5, 32)).astype(np.float32) * 3.0
    x[1, 2] = 0.0                       # all-zero vector: scale 1
    x[2, 0, :3] = [1e-6, -7.5, 448.0]   # subnormal codes, ties, the edge
    codes, scale = TP.quantize_kv(torch.from_numpy(x), torch.float8_e4m3fn)
    jc, js = JP.quantize_kv(jnp.asarray(x), jnp.float8_e4m3fn)
    assert codes.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(codes.view(torch.uint8).numpy(),
                                  np.asarray(jc).view(np.uint8))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    assert scale[1, 2].item() == 1.0
    np.testing.assert_array_equal(
        TP.dequantize_kv(codes, scale).numpy(),
        np.asarray(JP.dequantize_kv(jc, js)))


def test_kv_quant_spec():
    assert TP.kv_quant_spec("") is None
    assert TP.kv_quant_spec("int8") == (torch.int8, 127.0)
    assert TP.kv_quant_spec("fp8") == (torch.float8_e4m3fn, 448.0)
    with pytest.raises(ValueError, match="unknown"):
        TP.kv_quant_spec("int4")


def test_shape_validation_errors():
    pk, pv, btab, qpos, q = _case(6, 1)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="needs layer=<int>"):
        TP.paged_attention(t(q), t(pk), t(pv), t(btab), t(qpos))
    with pytest.raises(ValueError, match="layer=None"):
        TP.paged_attention(t(q), t(pk[:, 0].copy()), t(pv[:, 0].copy()),
                           t(btab), t(qpos), layer=0)


def test_cuda_wrapper_validates_before_launch():
    """The kernel wrapper's checks (dtype, scales, dk, index types) run
    before anything touches the card, so they are exercised here."""
    pk, pv, btab, qpos, q = _case(7, 1)
    t = torch.from_numpy
    nblk = torch.tensor([4], dtype=torch.int32)
    args = [t(q), t(pk), t(pv), t(btab), t(qpos), nblk, None, None]
    with pytest.raises(ValueError, match="int32"):
        TP._attend_cuda(*args[:3], t(btab).long(), *args[4:], layer=0)
    with pytest.raises(ValueError, match="q must be float32"):
        TP._attend_cuda(t(q).double(), *args[1:], layer=0)
    for qdt in (torch.int8, torch.float8_e4m3fn):
        with pytest.raises(ValueError, match="needs k_scale"):
            TP._attend_cuda(t(q), t(pk).to(qdt), t(pv).to(qdt),
                            *args[3:], layer=0)
    with pytest.raises(ValueError, match="only with an int8 or fp8"):
        TP._attend_cuda(*args[:6], t(pk[..., 0]), t(pv[..., 0]), layer=0)
    big = np.zeros((2, 1, 2, 64, 256), np.float32)
    with pytest.raises(ValueError, match="shared memory"):
        TP._attend_cuda(t(np.zeros((4, 2, 1, 256), np.float32)), t(big),
                        t(big), t(btab[:, :2].copy()), *args[4:], layer=0)
    q12 = np.zeros(q.shape[:-1] + (12,), np.float32)
    p12 = np.zeros(pk.shape[:-1] + (12,), np.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        TP._attend_cuda(t(q12), t(p12), t(p12), *args[3:], layer=0)


def test_cpu_tensors_take_the_plain_version():
    pk, pv, btab, qpos, q = _case(8, 1)
    before = TP.paged_attention.launches
    _port(q, pk, pv, btab, qpos, 0)
    assert TP.paged_attention.launches == before


def test_entry_points_raise_without_a_card():
    """Without ``device`` the port's entry points ask for the CUDA card
    and raise when there is none — never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from paddle_tpu_torch.models.transformer_infer import (
        TransformerLMInfer, init_stream)
    from paddle_tpu_torch.serving import Engine
    stream = init_stream(16, 8, 1, 2, 16, 32, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLMInfer.from_stream(stream, 1, 2, 16, 8)
    model = TransformerLMInfer.from_stream(stream, 1, 2, 16, 8,
                                           device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, slots=2)
