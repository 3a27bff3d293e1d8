"""paddle_tpu_torch.ops.flash_attention against the JAX package.

The port's plain version (what every CPU tensor runs: ``_dense_lse`` and
autograd through it) is held against ``paddle_tpu.ops.flash_attention``
with ``force="interpret"``: the Pallas TPU kernels — forward, dQ and
dK/dV — executed in interpret mode on the CPU, under their custom VJP.
Outputs and gradients (``jax.vjp`` against ``torch.autograd``) are
compared, including a nonzero cotangent on the LSE output. Inputs are
drawn with numpy from fixed seeds and handed to both packages.
Tolerance rtol 1e-5 / atol 2e-5: both sides compute in fp32 and differ
only in summation order (the kernels stream key blocks, the plain
version reduces whole rows). The CUDA kernels themselves are compared
with the plain version on the card by ``chip_smoke.py`` (TF32 switched
off there for matmuls and cuDNN, so fp32 products stay fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as JF
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as TF

RTOL, ATOL = 1e-5, 2e-5


def _inputs(seed, t, d, b=1, h=2):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=(b, h, t, d)).astype(np.float32)
                     for _ in range(4))
    dlse = rng.normal(size=(b, h, t)).astype(np.float32)
    return q, k, v, dout, dlse


def _jax(q, k, v, dout, dlse, causal, with_lse):
    args = [jnp.asarray(x) for x in (q, k, v)]
    if with_lse:
        (out, lse), vjp = jax.vjp(
            lambda *a: JF.flash_attention_lse(*a, causal=causal,
                                              force="interpret"), *args)
        grads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    else:
        out, vjp = jax.vjp(
            lambda *a: JF.flash_attention(*a, causal=causal,
                                          force="interpret"), *args)
        lse = None
        grads = vjp(jnp.asarray(dout))
    return [None if x is None else np.asarray(x)
            for x in (out, lse) + tuple(grads)]


def _port(q, k, v, dout, dlse, causal, with_lse):
    tq, tk, tv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    if with_lse:
        out, lse = TF.flash_attention_lse(tq, tk, tv, causal=causal)
        obj = (out * torch.from_numpy(dout)).sum() + \
            (lse * torch.from_numpy(dlse)).sum()
    else:
        out = TF.flash_attention(tq, tk, tv, causal=causal)
        lse = None
        obj = (out * torch.from_numpy(dout)).sum()
    grads = torch.autograd.grad(obj, [tq, tk, tv])
    return [None if x is None else x.detach().numpy()
            for x in (out, lse) + tuple(grads)]


@pytest.mark.parametrize("with_lse", [False, True], ids=["out", "lse"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_matches_jax_interpret(causal, t, d, with_lse):
    """Forward (O, and LSE for the lse variant) and dQ/dK/dV."""
    case = _inputs(t + d + causal, t, d)
    ref = _jax(*case, causal, with_lse)
    got = _port(*case, causal, with_lse)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
        if b is None:
            continue
        assert a.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def test_scale_default_and_explicit():
    q, k, v, _, _ = _inputs(1, 128, 32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    default = TF.flash_attention(*t, causal=True)
    explicit = TF.flash_attention(*t, causal=True, scale=32 ** -0.5)
    zero = TF.flash_attention(*t, causal=True, scale=0.0)
    assert torch.equal(default, explicit) and torch.equal(default, zero)
    ref = JF.flash_attention(*[jnp.asarray(x) for x in (q, k, v)],
                             causal=True, scale=0.3, force="interpret")
    got = TF.flash_attention(*t, causal=True, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """A CPU call runs the plain version: no launch is counted and the
    kernel library is never built or loaded."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path touched the kernel build")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "load_all", refuse)
    before = dict(TF.flash_attention.launches)
    got = _port(*_inputs(2, 128, 32), True, True)
    assert all(np.isfinite(x).all() for x in got)
    assert TF.flash_attention.launches == before
    assert TF.flash_attention_lse.launches is TF.flash_attention.launches


def test_other_devices_raise():
    q = torch.empty((1, 1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        TF.flash_attention(q, q, q)


def test_cuda_wrapper_validates_before_launch(monkeypatch):
    """The kernel wrappers' checks (rank, dtype, shapes, D, device) run
    before anything is built or launched, so they are exercised here."""
    def refuse(*a, **kw):
        raise AssertionError("validation let a bad call reach the build")
    monkeypatch.setattr(_build, "load", refuse)
    q, k, v, _, _ = [torch.from_numpy(x) for x in _inputs(3, 16, 16)]
    with pytest.raises(ValueError, match=r"\[B, H, T, D\]"):
        TF._fwd_cuda(q[0], k[0], v[0], True, 0.25)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TF._fwd_cuda(q.double(), k.double(), v.double(), True, 0.25)
    with pytest.raises(ValueError, match="like q"):
        TF._fwd_cuda(q, k[:, :, :8], v, True, 0.25)
    q12 = torch.zeros((1, 2, 16, 12))
    with pytest.raises(ValueError, match="multiple of 8"):
        TF._fwd_cuda(q12, q12, q12, True, 0.25)
    with pytest.raises(ValueError, match="CUDA device"):
        TF._fwd_cuda(q, k, v, True, 0.25)
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="CUDA device"):
        TF._bwd_dq_cuda(q, k, v, q, lse, lse, True, 0.25)
    with pytest.raises(ValueError, match="like q"):
        TF._bwd_dkv_cuda(q, k, v, q.to(torch.bfloat16), lse, lse, True,
                         0.25)


def test_delta_folds_the_lse_cotangent():
    """delta = rowsum(dO * O) - dLSE, the shared term of both backward
    kernels (computed in plain PyTorch, as the JAX package does in
    jnp)."""
    rng = np.random.default_rng(4)
    out, dout = (torch.from_numpy(rng.normal(size=(1, 2, 8, 16))
                                  .astype(np.float32)) for _ in range(2))
    dlse = torch.from_numpy(rng.normal(size=(1, 2, 8)).astype(np.float32))
    np.testing.assert_allclose(
        TF._delta(out, dout, dlse).numpy(),
        (dout * out).sum(-1).numpy() - dlse.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TF._delta(out, dout, None).numpy(),
                               (dout * out).sum(-1).numpy(), rtol=1e-6)
