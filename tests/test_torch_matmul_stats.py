"""The port's fused matmul + column statistics (``ops/matmul_stats.py``)
and the 1x1-conv + BN fusion it carries (``ops/conv.py``), against the
JAX package.

On the CPU ``matmul_colstats`` runs its plain version inside the same
autograd Function the CUDA kernel runs in on the card (the kernel itself
is held against the plain version on the card by ``chip_smoke.py``).
Inputs are drawn with numpy from fixed seeds and handed to both packages;
the JAX side runs its Pallas kernel in interpret mode and its dense path.
Tolerances, all fp32:

  * y at rtol 1e-5 / atol 1e-6: products of at most 72 terms, summed in
    another order by each library;
  * s1 and s2 at 1e-5 of sum|y - c| and sum (y - c)^2 per column (plus
    rtol 1e-5): sums of up to 512 terms in another order, whose rounding
    grows with the sum of the magnitudes, not with the result (which can
    cancel to near 0);
  * dX and dW at rtol 1e-5 and 1e-5 of the largest reference value;
  * the fused-vs-composed training runs at the tolerances of the JAX
    package's own ``tests/test_matmul_stats.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import matmul_stats as JMS
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import unique_name
from paddle_tpu_torch.ops import matmul_stats as TMS
from paddle_tpu_torch.tools.tf32_numerics import (
    _banks_conflict_free, _tf32)

# (M, K, N): the JAX package's test cases, then ragged M, K and N
CASES = [(512, 32, 128), (512, 16, 128), (300, 72, 200), (97, 67, 131)]


def _xwc(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 0.5).astype(np.float32)
    w = (rng.randn(k, n) * 0.2).astype(np.float32)
    c = (rng.randn(n) * 0.1).astype(np.float32)
    return x, w, c


def _close_stats(got, ref, yc_abs_sum, yc_sq_sum):
    s1, s2 = got
    r1, r2 = ref
    assert np.all(np.abs(s1 - r1) <= 1e-5 * yc_abs_sum + 1e-5 * np.abs(r1))
    assert np.all(np.abs(s2 - r2) <= 1e-5 * yc_sq_sum + 1e-5 * np.abs(r2))


@pytest.mark.parametrize("force", ["dense", "interpret"])
@pytest.mark.parametrize("m, k, n", CASES)
def test_plain_matches_jax(m, k, n, force):
    x, w, c = _xwc(m, k, n, seed=m + k + n)
    ref = JMS.matmul_colstats(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(c), force=force)
    ref = [np.asarray(r) for r in ref]
    got = [t.numpy() for t in TMS.matmul_colstats(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c))]
    assert got[0].dtype == np.float32 and got[0].shape == (m, n)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-6)
    yc = x.astype(np.float64) @ w - c[None, :]
    _close_stats(got[1:], ref[1:], np.abs(yc).sum(0), (yc * yc).sum(0))


def _three_output_loss(y, s1, s2, lib):
    """The JAX package's test loss: every cotangent path nonzero."""
    return (lib.sum(y ** 2) + lib.sum(s1 * 0.3)
            + lib.sum(lib.sqrt(s2 + 1.0)))


@pytest.mark.parametrize("force", ["dense", "interpret"])
@pytest.mark.parametrize("m, k, n", [(512, 16, 128), (300, 72, 200)])
def test_grads_match_jax(m, k, n, force):
    x, w, c = _xwc(m, k, n, seed=1)
    cj = jnp.asarray(c)

    def jloss(xj, wj):
        return _three_output_loss(
            *JMS.matmul_colstats(xj, wj, cj, force=force), jnp)

    rx, rw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = _three_output_loss(
        *TMS.matmul_colstats(xt, wt, torch.from_numpy(c)), torch)
    gx, gw = torch.autograd.grad(loss, [xt, wt])
    for got, ref in ((gx, rx), (gw, rw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("used", ["y", "s1", "s2", "s1+s2"])
def test_backward_matches_plain_autograd(used):
    """The Function's hand-written backward (the one that runs after the
    kernel on the card) against autograd through the plain version, with
    the outputs the loss does not reach left to autograd's zeros."""
    x, w, c = _xwc(200, 24, 40, seed=7)
    g = np.random.RandomState(8)
    gy = torch.from_numpy(g.randn(200, 40).astype(np.float32))
    g1 = torch.from_numpy(g.randn(40).astype(np.float32))
    g2 = torch.from_numpy(g.randn(40).astype(np.float32))
    grads = []
    for fn in (TMS.matmul_colstats, TMS._dense_matmul_stats):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        y, s1, s2 = fn(xt, wt, torch.from_numpy(c))
        terms = {"y": (y * gy).sum(), "s1": (s1 * g1).sum(),
                 "s2": (s2 * g2).sum()}
        loss = sum(terms[u] for u in used.split("+"))
        grads.append(torch.autograd.grad(loss, [xt, wt]))
    for got, ref in zip(*grads):
        scale = float(ref.abs().max())
        assert scale > 0
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)


def test_flop_counts_match_jax():
    for m, k, n in CASES:
        assert TMS.matmul_flops(m, k, n) == JMS.matmul_flops(m, k, n)
    dn = (((2,), (1,)), ((0,), (0,)))
    assert TMS.dot_general_flops((4, 8, 16), (4, 16, 32), dn) == \
        JMS.dot_general_flops((4, 8, 16), (4, 16, 32), dn) == \
        2.0 * 4 * 8 * 16 * 32


def test_other_devices_raise():
    x = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        TMS.matmul_colstats(x, torch.empty((3, 2), device="meta"),
                            torch.empty((2,), device="meta"))


# --------------------------------------------------------------------------
# the fusion inside the Executor: the port's fused route against its own
# composed route (the JAX package holds the same pair in
# tests/test_matmul_stats.py)

@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the conv lowering's calls of matmul_colstats."""
    calls = []
    real = TMS.matmul_colstats

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)
    monkeypatch.setattr(TMS, "matmul_colstats", spy)
    return calls


def _train_conv_bn(monkeypatch, fuse, stride=1, steps=3):
    """Tiny 1x1-conv + BN + loss net; returns per-step losses, the final
    conv filter and the BN running mean. Both packages read
    PADDLE_TPU_FUSE_CONV_BN."""
    monkeypatch.setenv("PADDLE_TPU_FUSE_CONV_BN", "1" if fuse else "0")
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 5
    scope = tfluid.Scope()
    with tfluid.program_guard(main, startup), \
            unique_name.guard("fz%d_" % (1 if fuse else 0)):
        x = tfluid.layers.data("x", [8, 8, 8])
        conv = tfluid.layers.conv2d(x, num_filters=16, filter_size=1,
                                    stride=stride, padding=0,
                                    bias_attr=False)
        bn = tfluid.layers.batch_norm(conv, act="relu")
        loss = tfluid.layers.mean(tfluid.layers.elementwise_mul(bn, bn))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    # one initial filter for both runs (each run's startup draws its own)
    wname = [v.name for v in main.global_block().vars.values()
             if v.persistable and ".w" in v.name][0]
    w0 = np.random.RandomState(11).randn(16, 8, 1, 1).astype(np.float32)
    tfluid.load_numpy_state(scope, {wname: w0 * 0.5}, "cpu")
    xv = np.random.RandomState(3).randn(4, 8, 8, 8).astype(np.float32)
    losses = [float(exe.run(main, feed={"x": xv}, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    mname = [op for op in main.global_block().ops
             if op.type == "batch_norm"][0].input("Mean")[0]
    return losses, scope.get_numpy(wname), scope.get_numpy(mname)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bn_fusion_parity(monkeypatch, fused_calls, stride):
    """The fused 1x1-conv+BN stat path trains as the composed path does:
    per-step losses, final weights and the BN running mean all match."""
    l0, w0, m0 = _train_conv_bn(monkeypatch, fuse=False, stride=stride)
    assert fused_calls == []
    l1, w1, m1 = _train_conv_bn(monkeypatch, fuse=True, stride=stride)
    side = 8 // stride
    assert fused_calls == [(4 * side * side, 8)] * 3
    np.testing.assert_allclose(l1, l0, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w1, w0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m1, m0, rtol=1e-4, atol=1e-6)
    assert not np.allclose(m1, 0.0)          # the running mean moved


@pytest.mark.parametrize("is_test", [False, True], ids=["3x3", "is_test"])
def test_fusion_leaves_3x3_and_test_mode_alone(monkeypatch, fused_calls,
                                               is_test):
    """Non-1x1 convs and inference-mode batch norms keep the composed
    path (no stash ever created)."""
    monkeypatch.setenv("PADDLE_TPU_FUSE_CONV_BN", "1")
    main, startup = tfluid.Program(), tfluid.Program()
    scope = tfluid.Scope()
    with tfluid.program_guard(main, startup), unique_name.guard():
        x = tfluid.layers.data("x", [4, 6, 6])
        conv = tfluid.layers.conv2d(x, num_filters=8,
                                    filter_size=1 if is_test else 3,
                                    padding=0 if is_test else 1,
                                    bias_attr=False)
        bn = tfluid.layers.batch_norm(conv, is_test=is_test)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(0).randn(2, 4, 6, 6).astype(np.float32)
    out, = exe.run(main, feed={"x": xv}, fetch_list=[bn], scope=scope)
    assert np.isfinite(out).all() and out.shape == (2, 8, 6, 6)
    assert fused_calls == []


# --------------------------------------------------------------------------
# numerics and shared-memory layout of the CUDA kernel (csrc/
# matmul_stats.cu), held here in plain PyTorch: its fp32 products run as
# 3xTF32 on the tensor cores with big = tf32(x) and small = tf32(x - big),
# both rounded to nearest, the three MMAs of each k8 step summed into a
# zeroed fragment that one f32 add carries into the accumulator

CHIP_RTOL, MM_STAT_TOL = 1e-4, 1e-5    # chip_smoke.py's _mm_case limits
RESNET_KS = (64, 128, 256, 512, 1024, 2048)   # K of ResNet-50's 1x1 convs


def _kernel_split(x):
    """(big, small) as the kernel's split() leaves them for the MMA, which
    reads the top 19 bits of an operand: big = (bits + 0x1000) with the 13
    low bits cleared; small = bits(x - big) + 0x1000, its low bits cleared
    by the MMA."""
    low = ~0x1FFF
    big = ((x.contiguous().view(torch.int32) + 0x1000) & low).view(
        torch.float32)
    small = (((x - big).view(torch.int32) + 0x1000) & low).view(
        torch.float32)
    return big, small


def _kernel_3xtf32(x, w):
    """y = x @ w.T (w [N, K]) as the kernel takes it, in f32: per k8 step
    small*big + big*small + big*big into a fresh fragment, added to y."""
    (xb, xs), (wb, ws) = _kernel_split(x), _kernel_split(w)
    y = torch.zeros(x.shape[0], w.shape[0])
    for k0 in range(0, x.shape[1], 8):
        sl = slice(k0, k0 + 8)
        y = y + ((xs[:, sl] @ wb[:, sl].T + xb[:, sl] @ ws[:, sl].T)
                 + xb[:, sl] @ wb[:, sl].T)
    return y


def _one_pass_tf32(x, w):
    return _tf32(x) @ _tf32(w).T


def test_kernel_split_rounds_both_parts_to_nearest():
    """The kernel's four-operation split leaves the MMA the same bits as
    rounding both parts to nearest TF32 (flash_attention.cu's to_tf32,
    five operations), on normal values, ties, powers of two and zero."""
    x = torch.from_numpy((np.random.RandomState(5).randn(4096) * 10.0 **
                          np.random.RandomState(6).randint(-30, 30, 4096)
                          ).astype(np.float32))
    ties = (torch.arange(1, 257, dtype=torch.int32) << 13 | 0x1000).view(
        torch.float32)
    x = torch.cat([x, ties, -ties, torch.tensor([0.0, -0.0, 1.0, 2.0 ** -20,
                                                 -3.0, 1.0 - 2.0 ** -24])])
    big, small = _kernel_split(x)
    assert torch.equal(big.view(torch.int32), _tf32(x).view(torch.int32))
    assert torch.equal(small, _tf32(x - _tf32(x)))
    assert torch.equal(big.double() + small.double(),
                       _tf32(x).double() + _tf32(x - _tf32(x)).double())


def _stats_outside(mm, m=512, k=2048, n=64, seed=21):
    """Per output (y, s1, s2) of the kernel's function at width ``k``
    through ``mm``: elements outside chip_smoke.py's limits against
    float64, and the worst error in units of the limit."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(n, k) * k ** -0.5).astype(np.float32)
    c = (0.1 * rng.randn(n)).astype(np.float32)
    y = mm(torch.from_numpy(x), torch.from_numpy(w))
    yc = y - torch.from_numpy(c)[None, :]
    got = (y, yc.sum(0), (yc * yc).sum(0))
    y64 = torch.from_numpy(x.astype(np.float64) @ w.astype(np.float64).T)
    yc64 = y64 - torch.from_numpy(c.astype(np.float64))[None, :]
    ref = (y64, yc64.sum(0), (yc64 * yc64).sum(0))
    lims = (1e-5 + CHIP_RTOL * y64.abs(),
            MM_STAT_TOL * yc64.abs().sum(0) + CHIP_RTOL * ref[1].abs(),
            MM_STAT_TOL * (yc64 * yc64).sum(0) + CHIP_RTOL * ref[2].abs())
    res = []
    for g, r, lim in zip(got, ref, lims):
        err = (g.double() - r).abs()
        res.append((int((err > lim).sum()), float((err / lim).max())))
    return res


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("k", RESNET_KS)
def test_3xtf32_kernel_products_hold_the_fp32_limits(k, seed):
    """y, s1 and s2 from the kernel's 3xTF32 products stay within
    chip_smoke.py's fp32 limits of float64 at every K of ResNet-50."""
    for name, (bad, worst) in zip(("y", "s1", "s2"),
                                  _stats_outside(_kernel_3xtf32, k=k,
                                                 seed=seed)):
        assert bad == 0, (name, bad, worst)
        assert worst < 0.5, (name, worst)       # with room to spare


def test_one_pass_tf32_breaks_the_fp32_limits():
    """One-pass TF32 puts most of y (by up to ~100x the limit) and some of
    s1 outside the same limits at K = 2,048: the reason for 3xTF32. (s2's
    limit, a share of a sum of squares, is the loosest of the three.)"""
    (ybad, yworst), (s1bad, s1worst), _ = _stats_outside(_one_pass_tf32)
    assert ybad > 10000 and yworst > 20, (ybad, yworst)
    assert s1bad > 0 and s1worst > 1, (s1bad, s1worst)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
def test_fragment_reads_are_bank_conflict_free(itemsize):
    """Each stage row holds 128 bytes of K padded by 16 (LD = 36 f32 or 72
    bf16). f32 (m16n8k8): lane 4g+t reads rows g, g+8 at columns t, t+4;
    bf16 (m16n8k16): the 32-bit word of columns 2t, 2t+1 and of 2t+8,
    2t+9. Each read is one shared-memory wavefront."""
    bk = 128 // itemsize
    ld = bk + 16 // itemsize
    assert (ld * itemsize) % 16 == 0            # cp.async row alignment
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for kk in range(bk * itemsize // 32):       # k8 (f32) / k16 (bf16) steps
        if itemsize == 4:
            base = [(g * ld + 8 * kk + t) for g, t in lanes]
            reads = [base, [e + 4 for e in base], [e + 8 * ld for e in base]]
        else:
            base = [(g * ld + 16 * kk + 2 * t) for g, t in lanes]
            reads = [base, [e + 8 for e in base], [e + 8 * ld for e in base]]
        for elems in reads:
            words = [e * itemsize // 4 for e in elems]
            assert _banks_conflict_free(words), (itemsize, kk)


@pytest.mark.parametrize("bm, bn, minb", [(128, 128, 2), (128, 64, 2),
                                          (64, 64, 3)])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
def test_tiles_fit_shared_memory(bm, bn, minb, itemsize):
    """Each tile class's three-stage ring (csrc: NS, Tile) fits a block's
    227 KB, and MINB of them fit the SM's 228 KB with 1 KB each reserved;
    its scratch rows fit the wrapper's part buffer (rows of 64)."""
    ld = 128 // itemsize + 16 // itemsize
    smem = itemsize * 3 * (bm + bn) * ld
    assert smem <= 232448 and minb * (smem + 1024) <= 233472
    m = 1000
    assert -(-m // bm) <= -(-m // TMS._BM)
