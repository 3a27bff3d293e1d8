"""paddle_tpu_torch.ops.paged_attention against the JAX package.

The port's plain version (``_attend_plain``, what every CPU tensor runs)
is held against ``paddle_tpu.ops.paged_attention`` on both of its CPU
paths: the lax reference (``force="lax"``) and the Pallas TPU kernel
executed in interpret mode (``force="interpret"``). Inputs are drawn
with numpy from fixed seeds and handed to both packages. Tolerance
rtol 1e-5 / atol 1e-6 on live rows: both sides run the same fp32 online
softmax, so they differ only in summation order. The CUDA kernel itself
is compared with ``_attend_plain`` on the card by ``chip_smoke.py``
(TF32 switched off there, so fp32 products stay fp32).
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


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("c", [1, 4, 5])
@pytest.mark.parametrize("force", ["lax", "interpret"])
def test_plain_matches_jax(force, c, quant):
    """Ragged chains, layer 1 of a 3-layer 5-D pool, fp32 and int8."""
    pk, pv, btab, qpos, q = _case(10 + c, c)
    ks = vs = None
    if quant:
        ck, sk = JP.quantize_kv(jnp.asarray(pk), jnp.int8)
        cv, sv = JP.quantize_kv(jnp.asarray(pv), jnp.int8)
        pk, pv = np.array(ck), np.array(cv)
        ks, vs = np.array(sk), np.array(sv)
    ref = _jax(q, pk, pv, btab, qpos, 1, force, ks=ks, vs=vs)
    got = _port(q, pk, pv, btab, qpos, 1, ks=ks, vs=vs)
    assert got.dtype == np.float32 and got.shape == q.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


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


def test_kv_quant_spec():
    assert TP.kv_quant_spec("") is None
    assert TP.kv_quant_spec("int8") == (torch.int8, 127.0)
    with pytest.raises(ValueError, match="ROADMAP"):
        TP.kv_quant_spec("fp8")
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
    with pytest.raises(ValueError, match="needs k_scale"):
        TP._attend_cuda(t(q), t(pk).to(torch.int8), t(pv).to(torch.int8),
                        *args[3:], layer=0)
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
