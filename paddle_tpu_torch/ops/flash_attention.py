"""Flash attention: softmax(Q K^T * scale [+ causal mask]) V.

The counterpart of ``paddle_tpu/ops/flash_attention.py``. Two versions of
one function:

  * the hand-written CUDA kernels (``csrc/flash_attention.cu``, built by
    ``_build``): a forward that writes O and the per-row log-sum-exp, and
    the two backward kernels that recompute P from it: dQ, which also
    computes delta, and dK/dV, which reads it. Taken for every CUDA
    tensor; a tensor they cannot take raises, there is no fallback.
  * ``_dense_lse`` — plain PyTorch with the JAX package's ``_dense_lse``
    semantics (f32 scores, the -1e30 mask, ``p / l``, LSE = m + log l),
    differentiated by autograd. Taken for CPU tensors; ``chip_smoke.py``
    holds the kernels against it on the card.

Surface: ``flash_attention(q, k, v, causal=False, scale=None)`` -> out and
``flash_attention_lse(...)`` -> (out, lse), the counterparts of the JAX
package's ``_flash`` / ``_flash_lse`` custom-vjp functions. q, k, v are
[B, H, T, D] (one T for all three), f32 or bf16; out is in q's dtype, lse
f32 [B, H, T]; ``scale`` defaults to D**-0.5. Both outputs of the lse
variant are differentiable: dLSE folds into delta = rowsum(dO * O) - dLSE,
which the dQ kernel computes for its own rows and hands to the dK/dV
kernel (the JAX package computes it in jnp; ``_delta`` is its plain
version here).

``flash_attention.launches`` counts kernel launches per kernel (``fwd``,
``bwd_dq``, ``bwd_dkv``); the lse variant shares the same counts.
"""

import ctypes

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_lse"]

_NEG_INF = -1e30
_MAX_D = 256
_KIND = {torch.float32: 0, torch.bfloat16: 1}


def _dense_lse(q, k, v, causal, scale):
    """Plain PyTorch (out, lse): the JAX package's ``_dense_lse``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = s.shape[-1]
        keep = torch.ones((t, t), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l, v.float()).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


# --------------------------------------------------------------------------
def _lib():
    lib = _build.load("flash_attention")
    if lib.ptt_flash_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i, i, i, f, i, i, p]     # bh, t, d, scale, causal, kind,
        lib.ptt_flash_fwd.argtypes = [p] * 5 + tail          # stream
        lib.ptt_flash_bwd_dq.argtypes = [p] * 9 + tail
        lib.ptt_flash_bwd_dkv.argtypes = [p] * 8 + tail
        for fn in (lib.ptt_flash_fwd, lib.ptt_flash_bwd_dq,
                   lib.ptt_flash_bwd_dkv):
            fn.restype = i
        lib.ptt_flash_error_string.argtypes = [i]
        lib.ptt_flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond, msg, *args):
    if not cond:
        raise ValueError("flash_attention CUDA kernel: " + msg % args)


def _check_inputs(*tensors):
    """What the kernels take: equal [B, H, T, D] shapes, f32 or bf16, D a
    multiple of 8 up to 256, contiguous 16-byte-aligned CUDA storage."""
    q = tensors[0]
    _check(q.dim() == 4, "q, k, v must be [B, H, T, D], got %s",
           tuple(q.shape))
    _check(q.dtype in _KIND, "q must be float32 or bfloat16, got %s",
           q.dtype)
    for t in tensors:
        _check(t.shape == q.shape and t.dtype == q.dtype,
               "every tensor must be %s %s like q, got %s %s",
               tuple(q.shape), q.dtype, tuple(t.shape), t.dtype)
    b, h, t_len, d = q.shape
    _check(d % 8 == 0 and 8 <= d <= _MAX_D,
           "D must be a multiple of 8 in [8, %d], got %d", _MAX_D, d)
    _check(t_len >= 1 and 1 <= b * h <= 65535,
           "need T >= 1 and 1 <= B*H <= 65535, got T=%d B*H=%d",
           t_len, b * h)
    for t in tensors:
        _check(t.device.type == "cuda" and t.device == q.device,
               "every tensor must be on one CUDA device, got %s", t.device)
        _check(t.is_contiguous(), "every tensor must be contiguous")
        _check(t.data_ptr() % 16 == 0, "storage must be 16-byte aligned")


def _launched(lib, rc, which):
    if rc != 0:
        raise RuntimeError(
            "flash_attention CUDA kernel %s failed to launch: %s (%d)"
            % (which, lib.ptt_flash_error_string(rc).decode(), rc))
    flash_attention.launches[which] += 1


def _fwd_cuda(q, k, v, causal, scale):
    """Launch the forward kernel: (out in q's dtype, lse f32 [B, H, T])."""
    _check_inputs(q, k, v)
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), b * h, t, d,
                           scale, int(causal), _KIND[q.dtype], stream)
    _launched(lib, rc, "fwd")
    return out, lse


def _delta(out, dout, dlse):
    """delta = rowsum(dO * O) - dLSE in f32 [B, H, T]: the plain version
    of what the dQ kernel computes for its rows."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _check_rows(q, *rows):
    """lse, dlse (when given) and delta: f32 [B, H, T] beside q."""
    for r in rows:
        if r is None:
            continue
        _check(r.shape == q.shape[:3] and r.dtype == torch.float32,
               "per-row statistics must be float32 %s, got %s %s",
               tuple(q.shape[:3]), r.dtype, tuple(r.shape))
        _check(r.device == q.device and r.is_contiguous(),
               "per-row statistics must be contiguous on %s", q.device)


def _bwd_dq_cuda(q, k, v, out, dout, lse, dlse, causal, scale):
    """Launch the dQ kernel: (dq in q's dtype, delta f32 [B, H, T]). It
    computes delta = rowsum(dO * O) - dLSE itself (dlse may be None)."""
    _check_inputs(q, k, v, out, dout)
    _check_rows(q, lse, dlse)
    b, h, t, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ptt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        None if dlse is None else dlse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b * h, t, d, scale, int(causal), _KIND[q.dtype],
        stream)
    _launched(lib, rc, "bwd_dq")
    return dq, delta


def _bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, scale):
    """Launch the dK/dV kernel: (dk, dv) in q's dtype; delta is the dQ
    kernel's, on the same stream."""
    _check_inputs(q, k, v, dout)
    _check_rows(q, lse, delta)
    b, h, t, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ptt_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), b * h, t, d, scale,
                               int(causal), _KIND[q.dtype], stream)
    _launched(lib, rc, "bwd_dkv")
    return dk, dv


def _bwd_cuda(q, k, v, out, lse, dout, dlse, causal, scale):
    """The backward as two launches: dQ (and delta), then dK/dV."""
    dout = dout.contiguous()
    if dlse is not None:
        dlse = dlse.float().contiguous()
    dq, delta = _bwd_dq_cuda(q, k, v, out, dout, lse, dlse, causal, scale)
    dk, dv = _bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Counterpart of the JAX package's ``_flash``: out only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _fwd_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_cuda(q, k, v, out, lse, dout, None, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


class _FlashLSE(torch.autograd.Function):
    """Counterpart of ``_flash_lse``: (out, lse), both differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.set_materialize_grads(False)
        out, lse = _fwd_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = _bwd_cuda(q, k, v, out, lse, dout, dlse, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def _route(q, scale):
    """(use the kernels?, resolved scale): CPU tensors take the plain
    version, CUDA tensors the kernels; anything else raises."""
    scale = float(scale) if scale else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return False, scale
    if q.device.type != "cuda":
        raise ValueError("flash_attention runs on CPU or CUDA tensors, "
                         "got %s" % (q.device,))
    return True, scale


def flash_attention(q, k, v, causal=False, scale=None):
    """Fused multi-head attention. q/k/v: [B, H, T, D] -> [B, H, T, D]."""
    kernel, scale = _route(q, scale)
    if not kernel:
        return _dense_lse(q, k, v, causal, scale)[0]
    return _Flash.apply(q, k, v, bool(causal), scale)


def flash_attention_lse(q, k, v, causal=False, scale=None):
    """Like flash_attention but returns (out, lse) with
    lse[b,h,i] = logsumexp_j(q_i·k_j*scale [+mask]); both outputs are
    differentiable."""
    kernel, scale = _route(q, scale)
    if not kernel:
        return _dense_lse(q, k, v, causal, scale)
    return _FlashLSE.apply(q, k, v, bool(causal), scale)


flash_attention.launches = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
flash_attention_lse.launches = flash_attention.launches
