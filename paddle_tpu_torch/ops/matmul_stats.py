"""Fused matmul + per-column batch statistics: the 1x1-conv + BN kernel.

The counterpart of ``paddle_tpu/ops/matmul_stats.py``. A 1x1 convolution
is a matmul over [N*H*W, Cin]; when its output feeds a train-mode batch
norm, the matmul's epilogue also sums the SHIFTED column statistics
s1 = sum(y - c), s2 = sum((y - c)^2) that BN needs, so BN skips its own
pass over the conv output. The shift c (the BN running mean, treated as
a constant) keeps the one-pass variance var = s2/n - (s1/n)^2 stable,
as in ``ops/nn.py``.

Two versions of one function:

  * the hand-written CUDA kernel (``csrc/matmul_stats.cu``, built by
    ``_build``), taken for every CUDA tensor; what it cannot take raises,
    there is no fallback;
  * ``_dense_matmul_stats``, plain PyTorch with the JAX package's
    ``_dense_matmul_stats`` semantics, taken for CPU tensors;
    ``chip_smoke.py`` holds the kernel against it on the card.

Both run inside ``_MMStats``, the counterpart of the JAX package's
``custom_vjp``: its backward folds the statistics' cotangents into the
matmul's, dYtot = dY + ds1 + 2 (Y - c) ds2 (in f32, from the saved,
rounded Y, cast to x's dtype), and runs the two transposed products as
plain ``torch.matmul``, as the JAX package leaves them to XLA. Autograd
hands the backward zeros for any of y, s1, s2 the loss does not reach.

``matmul_colstats.launches`` counts kernel launches.
"""

import ctypes

import torch

from . import _build

__all__ = ["matmul_colstats", "matmul_flops", "dot_general_flops"]

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_BM = 64           # the fewest rows of y per block of the kernel's tiles


def matmul_flops(m, k, n):
    """FLOPs of an [M,K] @ [K,N] matmul (multiply-accumulate = 2 ops)."""
    return 2.0 * float(m) * float(k) * float(n)


def dot_general_flops(lhs_shape, rhs_shape, dimension_numbers):
    """FLOPs of a dot_general from its shapes + dimension_numbers
    ``((lhs_contract, rhs_contract), (lhs_batch, rhs_batch))``. Batch dims
    multiply, contracting dims form K, the rest form M / N."""
    (lc, rc), (lb, rb) = dimension_numbers
    batch = 1.0
    for i in lb:
        batch *= lhs_shape[i]
    k = 1.0
    for i in lc:
        k *= lhs_shape[i]
    m = 1.0
    for i in range(len(lhs_shape)):
        if i not in lb and i not in lc:
            m *= lhs_shape[i]
    n = 1.0
    for i in range(len(rhs_shape)):
        if i not in rb and i not in rc:
            n *= rhs_shape[i]
    return batch * matmul_flops(m, k, n)


def _dense_matmul_stats(x, w, c):
    """Plain PyTorch (y in x's dtype, s1 f32, s2 f32); x [M,K], w [K,N]."""
    y = torch.matmul(x.float(), w.float())
    yc = y - c.float()[None, :]
    return y.to(x.dtype), yc.sum(dim=0), (yc * yc).sum(dim=0)


# --------------------------------------------------------------------------
_loaded = []       # the bound library, once built and loaded


def _lib():
    if not _loaded:
        lib = _build.load("matmul_stats")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ptt_matmul_stats.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.ptt_matmul_stats.restype = i
        ip = ctypes.POINTER(i)
        lib.ptt_matmul_stats_tile.argtypes = [i, i, ip, ip]
        lib.ptt_matmul_stats_tile.restype = ctypes.c_longlong
        lib.ptt_matmul_stats_error_string.argtypes = [i]
        lib.ptt_matmul_stats_error_string.restype = ctypes.c_char_p
        _loaded.append(lib)
    return _loaded[0]


def _check(cond, msg, *args):
    if not cond:
        raise ValueError("matmul_stats CUDA kernel: " + msg % args)


def _validate(x, w, c):
    """Raise ValueError naming the first thing ``_fwd_cuda`` cannot take."""
    _check(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
           "need x [M, K] and w [K, N], got %s and %s", tuple(x.shape),
           tuple(w.shape))
    _check(x.dtype in _KIND and w.dtype == x.dtype,
           "x and w must both be float32 or both bfloat16, got %s and %s",
           x.dtype, w.dtype)
    n = w.shape[1]
    _check(c.shape == (n,), "c must be [%d], got %s", n, tuple(c.shape))
    _check(x.numel() > 0 and w.numel() > 0, "empty shape %s x %s",
           tuple(x.shape), tuple(w.shape))
    for name, t in (("x", x), ("w", w), ("c", c)):
        _check(t.device.type == "cuda" and t.device == x.device,
               "%s must be on x's CUDA device, got %s", name, t.device)
    _check(x.is_contiguous(), "x must be contiguous")
    _check(w.t().is_contiguous(), "w must be the transpose of a contiguous "
           "[N, K] tensor (a conv filter's [Co, Ci] layout)")


def _fwd_cuda(x, w, c):
    """Launch the kernel: (y in x's dtype, s1 f32 [N], s2 f32 [N]).

    x [M, K] contiguous; w [K, N] whose transpose is contiguous (the
    [N, K] storage of a 1x1 conv filter, taken without a copy); c [N].
    The host's share of a call is kept short (36 calls per ResNet-50
    step, some shorter on the card than a slow host's enqueue): the
    inputs are checked in one expression, ``_validate`` names the fault
    only when that fails, and no view is made that the call can do
    without."""
    dev = x.device
    if not (x.dim() == 2 and w.dim() == 2 and x.dtype in _KIND
            and w.dtype == x.dtype and x.shape[1] == w.shape[0]
            and c.shape == (w.shape[1],) and x.numel() > 0
            and w.numel() > 0 and dev.type == "cuda" and w.device == dev
            and c.device == dev and x.is_contiguous()
            and w.stride() == (1, w.shape[0])):
        _validate(x, w, c)
    m, k = x.shape
    n = w.shape[1]
    if c.dtype != torch.float32 or not c.is_contiguous():
        c = c.float().contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    part = torch.empty(2 * -(-m // _BM) * n, dtype=torch.float32, device=dev)
    s = torch.empty((2, n), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.ptt_matmul_stats(x.data_ptr(), w.data_ptr(), c.data_ptr(),
                              y.data_ptr(), part.data_ptr(), s.data_ptr(),
                              m, k, n, _KIND[x.dtype],
                              torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(
            "matmul_stats CUDA kernel failed to launch: %s (%d)"
            % (lib.ptt_matmul_stats_error_string(rc).decode(), rc))
    matmul_colstats.launches += 1
    return (y, *s.unbind(0))


def _tile(m, n):
    """(rows, columns, blocks) of the tile the kernel picks for an (M, N)
    on the current card."""
    bm, bn = ctypes.c_int(), ctypes.c_int()
    blocks = _lib().ptt_matmul_stats_tile(m, n, ctypes.byref(bm),
                                          ctypes.byref(bn))
    return bm.value, bn.value, blocks


def _mmstats_bwd(x, w, c, y, dy, ds1, ds2):
    """(dx, dw) from the cotangents of (y, s1, s2), as the JAX package's
    ``_mmstats_bwd``: dYtot = dY + ds1 + 2 (Y - c) ds2 in f32, cast to
    x's dtype, then dX = dYtot w^T and dW = X^T dYtot."""
    yc = y.float() - c.float()[None, :]
    dytot = (dy.float() + ds1[None, :] + 2.0 * yc * ds2[None, :]).to(x.dtype)
    return torch.matmul(dytot, w.t()), torch.matmul(x.t(), dytot)


class _MMStats(torch.autograd.Function):
    """Counterpart of the JAX package's ``_mmstats`` custom-vjp function:
    the kernel on CUDA tensors, the plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, x, w, c):
        if x.device.type == "cuda":
            y, s1, s2 = _fwd_cuda(x, w, c)
        else:
            y, s1, s2 = _dense_matmul_stats(x, w, c)
        ctx.save_for_backward(x, w, c, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, c, y = ctx.saved_tensors
        dx, dw = _mmstats_bwd(x, w, c, y, dy, ds1, ds2)
        return dx, dw, None


def matmul_colstats(x, w, c):
    """y = x @ w with fused shifted column stats.

    x [M, K], w [K, N], c [N] (per-column shift, treated as constant —
    pass the BN running mean; no gradient flows to it). Returns
    (y [M, N] in x.dtype, s1 [N] f32, s2 [N] f32) with
    s1 = sum_rows(y - c), s2 = sum_rows((y - c)^2) accumulated in f32.
    CUDA tensors launch the kernel (x contiguous, w the transpose of a
    contiguous [N, K] tensor); CPU tensors take the plain version."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("matmul_colstats runs on CPU or CUDA tensors, got "
                         "%s" % (x.device,))
    return _MMStats.apply(x, w, c)


matmul_colstats.launches = 0
