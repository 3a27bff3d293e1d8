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

The kernels run their products on TF32 tensor cores as 3xTF32 (each
f32 operand split into a TF32 big and small part, three MMAs). The
numerics of that design are held here in plain PyTorch: TF32 rounding
emulated through an int32 view, the forward's two products (tiled over
keys with the kernel's online softmax) and the backward's five run
through it, and the results held to ``chip_smoke.py``'s fp32 tolerance
against a float64 reference, which one-pass TF32 does not meet.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as JF
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as TF
from paddle_tpu_torch.tools.tf32_numerics import (
    CHIP_ATOL, CHIP_RTOL, _banks_conflict_free, _mm_3xtf32, _mm_tf32, _tf32)

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
        TF._bwd_dq_cuda(q, k, v, q, q, lse, lse, True, 0.25)
    with pytest.raises(ValueError, match="like q"):
        TF._bwd_dq_cuda(q, k, v, q[..., :8], q, lse, None, True, 0.25)
    with pytest.raises(ValueError, match="like q"):
        TF._bwd_dkv_cuda(q, k, v, q.to(torch.bfloat16), lse, lse, True,
                         0.25)
    with pytest.raises(ValueError, match="per-row statistics"):
        TF._check_rows(q, lse, torch.zeros((1, 2, 8)))
    with pytest.raises(ValueError, match="per-row statistics"):
        TF._check_rows(q, lse.double())
    TF._check_rows(q, lse, None, lse)


def test_backward_hands_delta_from_dq_to_dkv(monkeypatch):
    """The backward is two launches, dQ then dK/dV, with no plain
    PyTorch between them: the dQ launch gets O and dLSE (made contiguous)
    and returns delta, which the dK/dV launch reads."""
    calls = []
    q, k, v, dout, dlse = [torch.from_numpy(x) for x in _inputs(5, 16, 8)]
    out, lse = TF._dense_lse(q, k, v, True, 0.25)
    dlse_t = dlse.transpose(0, 2).contiguous().transpose(0, 2)  # strided

    def dq_launch(*args):
        calls.append(("dq", args))
        return torch.zeros_like(q), TF._delta(args[3], args[4], args[6])

    def dkv_launch(*args):
        calls.append(("dkv", args))
        return torch.zeros_like(k), torch.ones_like(v)
    monkeypatch.setattr(TF, "_bwd_dq_cuda", dq_launch)
    monkeypatch.setattr(TF, "_bwd_dkv_cuda", dkv_launch)
    dq, dk, dv = TF._bwd_cuda(q, k, v, out, lse, dout, dlse_t, True, 0.25)
    assert [c[0] for c in calls] == ["dq", "dkv"]
    (_, a), (_, b) = calls
    assert a[3] is out and a[5] is lse and a[6].is_contiguous()
    assert torch.equal(a[6], dlse) and b[4] is lse
    np.testing.assert_allclose(b[5].numpy(),
                               TF._delta(out, dout, dlse).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(dv, torch.ones_like(v))


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


# -- 3xTF32 numerics of the kernels --------------------------------------
def _backward(q, k, v, out, lse, dout, dlse, scale, mm):
    """The causal backward's five products through ``mm``, the rest
    elementwise in the inputs' dtype, as the kernels order it."""
    t = q.shape[-2]
    keep = torch.ones((t, t), dtype=torch.bool).tril()
    s = mm(q, k.transpose(-1, -2))
    p = torch.where(keep, torch.exp(s * scale - lse[..., None]),
                    torch.zeros((), dtype=q.dtype))
    dp = mm(dout, v.transpose(-1, -2))
    delta = (dout * out).sum(-1) - dlse
    ds = p * (dp - delta[..., None]) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), dout))


def _tf32_case():
    """T=256, D=64, causal, drawn with numpy from a seed; O and LSE from
    the float64 forward, as the forward kernel hands them over in f32."""
    q, k, v, dout, dlse = [torch.from_numpy(x).double()
                           for x in _inputs(11, 256, 64)]
    scale = 64 ** -0.5
    out, lse = TF._dense_lse(q, k, v, True, scale)
    ref = _backward(q, k, v, out.double(), lse.double(), dout, dlse, scale,
                    torch.matmul)
    f32 = [x.float() for x in (q, k, v, out, lse, dout, dlse)]
    return f32, scale, ref


def _outside(got, ref):
    """Per gradient, the count of elements outside chip_smoke's fp32
    tolerance, and the worst error in units of that tolerance."""
    res = []
    for g, r in zip(got, ref):
        g = g.double()
        lim = CHIP_ATOL * r.abs().max() + CHIP_RTOL * r.abs()
        err = (g - r).abs()
        res.append((int((err > lim).sum()), float((err / lim).max())))
    return res


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                      # a TF32 value
    half = 2.0 ** -11                           # half its ulp
    x = torch.tensor([one, one + half * 0.99, one + half, -(one + half),
                      1.0 + half, 3.0e-40], dtype=torch.float32)
    got = _tf32(x).tolist()
    assert got[:2] == [one, one]
    assert got[2] == one + 2 * half and got[3] == -(one + 2 * half)
    assert got[4] == one                        # tie at 1 + half: away
    assert _tf32(_tf32(x)).tolist() == got      # idempotent
    assert (_tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()


def test_3xtf32_backward_holds_the_fp32_tolerance():
    """dQ, dK, dV from 3xTF32 products stay within chip_smoke.py's fp32
    tolerance of the float64 reference at the training path's T and D."""
    f32, scale, ref = _tf32_case()
    got = _backward(*f32, scale, _mm_3xtf32)
    for name, (bad, worst) in zip(("dq", "dk", "dv"), _outside(got, ref)):
        assert bad == 0, (name, bad, worst)
        assert worst < 0.5, (name, worst)       # with room to spare


def test_one_pass_tf32_backward_breaks_the_fp32_tolerance():
    """One-pass TF32 (~2^-11 relative per operand) puts many elements of
    each gradient outside the same tolerance: the reason for 3xTF32."""
    f32, scale, ref = _tf32_case()
    got = _backward(*f32, scale, _mm_tf32)
    for name, (bad, worst) in zip(("dq", "dk", "dv"), _outside(got, ref)):
        assert bad > 100 and worst > 2, (name, bad, worst)


# -- shared-memory layout of the kernels -----------------------------------
@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_fragment_reads_are_bank_conflict_free(d, itemsize):
    """csrc/flash_attention.cu pads each staged row by 16 bytes (ld = D+4
    f32, D+8 bf16). Lane 4g+t reads row g, column t of an A or n-major B
    fragment, and rows 2t, 2t+1 at column g of a k-major B fragment (the
    C-fragment-as-A trick); each read is one shared-memory wavefront."""
    ld = d + 16 // itemsize
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    reads = {
        "a_or_b_nrows": [g * ld + t for g, t in lanes],
        "a_or_b_nrows_+4": [g * ld + t + 4 for g, t in lanes],
        "b_krows": [2 * t * ld + g for g, t in lanes],
        "b_krows_+1": [(2 * t + 1) * ld + g for g, t in lanes],
    }
    assert (ld * itemsize) % 16 == 0           # cp.async row alignment
    for name, elems in reads.items():
        words = [e * itemsize // 4 for e in elems]
        assert _banks_conflict_free(words), (name, d, itemsize)


LOG2E = 1.4426950408889634


def _fwd_cfg(d):
    """(warps, keys per tile, blocks per SM) of csrc/flash_attention.cu's
    FwdCfg for head width ``d``, read from the source."""
    dc = 64 if d <= 64 else 128 if d <= 128 else 256
    with open(os.path.join(_build._CSRC, "flash_attention.cu")) as f:
        body = re.search(r"struct FwdCfg<%d> \{(.*?)\};" % dc, f.read(),
                         re.S).group(1)
    return tuple(int(re.search(r"\b%s = (\d+)" % key, body).group(1))
                 for key in ("NW", "COLS", "MINB"))


def _forward(q, k, v, scale, mm):
    """The causal forward as the kernel takes it, in f32: key tiles of
    the kernel's width for q's D (FwdCfg), S = Q K^T through ``mm``, the online softmax in the exp2 domain
    (running max m of S s log2e, P = exp2(S s log2e - m), O and the row
    sum rescaled per tile), O += P V through ``mm``; then O / l and
    LSE = m / log2e + log l."""
    t = q.shape[-2]
    cols = _fwd_cfg(q.shape[-1])[1]
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    rows = torch.arange(t)[:, None]
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros_like(q)
    for k0 in range(0, t, cols):
        s = mm(q, k[..., k0:k0 + cols, :].transpose(-1, -2))
        masked = torch.arange(k0, k0 + s.shape[-1])[None, :] > rows
        x = torch.where(masked, torch.tensor(-1e30), s * sl2)
        mn = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - mn)
        p = torch.where(masked, torch.zeros(()),
                        torch.exp2(x - mn[..., None]))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm(p, v[..., k0:k0 + cols, :])
        m = mn
    return acc / l[..., None], m / LOG2E + torch.log(l)


def _forward_outside(mm):
    """Per output (o, lse) of the T=256, D=64 causal forward through
    ``mm``: the count of elements outside chip_smoke's fp32 tolerance
    (per element) of the float64 reference, and the worst error in units
    of that tolerance."""
    q, k, v, _, _ = [torch.from_numpy(x) for x in _inputs(12, 256, 64)]
    scale = 64 ** -0.5
    ref = TF._dense_lse(q.double(), k.double(), v.double(), True, scale)
    got = _forward(q, k, v, scale, mm)
    res = []
    for g, r in zip(got, ref):
        lim = CHIP_ATOL + CHIP_RTOL * r.abs()
        err = (g.double() - r).abs()
        res.append((int((err > lim).sum()), float((err / lim).max())))
    return res


def test_3xtf32_forward_holds_the_fp32_tolerance():
    """O and LSE from 3xTF32 products, tiled as the forward kernel runs
    them at D = 64, stay within chip_smoke.py's fp32 tolerance of float64."""
    for name, (bad, worst) in zip(("o", "lse"),
                                  _forward_outside(_mm_3xtf32)):
        assert bad == 0, (name, bad, worst)
        assert worst < 0.5, (name, worst)       # with room to spare


def test_one_pass_tf32_forward_breaks_the_fp32_tolerance():
    """One-pass TF32 puts many elements of O outside the same tolerance."""
    (bad, worst), _ = _forward_outside(_mm_tf32)
    assert bad > 100 and worst > 2, (bad, worst)


@pytest.mark.parametrize("d", [8, 64, 128, 256])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
def test_forward_shared_memory_fits(d, itemsize):
    """The forward's staging (resident Q tile and a two-stage K/V ring,
    rows padded by 16 bytes) fits the card's 227 KB per block, and its
    blocks-per-SM target (MINB) fits the SM's 228 KB, for each head-width
    class: (warps, keys per tile, MINB) as csrc/flash_attention.cu's
    FwdCfg."""
    nw, cols, minb = _fwd_cfg(d)
    ld = d + 16 // itemsize
    smem = itemsize * (16 * nw + 4 * cols) * ld
    assert smem <= 232448
    assert minb * (smem + 1024) <= 233472
