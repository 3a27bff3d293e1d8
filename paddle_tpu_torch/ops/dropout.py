"""Dropout with counter-keyed Philox bits.

The port's dropout draw, which the ``dropout`` op lowers to. The JAX
package draws its mask with ``jax.random.bernoulli`` (threefry), which no
port can match bit for bit; the port keys its own draw so that it is a
pure function of (run seed, op key, element index):

  * element i takes 32-bit word i % 4 of Philox4x32-10 at counter
    (i // 4 low word, i // 4 high word, 0, 0) and key (seed mod 2**32,
    op key) (``core/philox.py``), and is kept when the word's top 24 bits
    are below ``keep_threshold(p)`` = ceil((1 - p) 2**24), i.e. when the
    uniform they make is below 1 - p;
  * Out = x * mask, times ``upscale(p)`` = f32(1 / f32(1 - p)) for
    ``upscale_in_train`` (the JAX package's ``x * mask / keep`` as XLA
    compiles it: a multiply by the f32 reciprocal), in f32 arithmetic
    rounded once to x's type; Mask (x's type) only when asked for.

The run seed is an int64 device scalar, so a CUDA graph replays whatever
seed was staged for its step; the op key is the op's ordinal among the
program's random ops (``registry.random_op_keys``), so a recompute region
replays the forward's mask. The gradient is the same function applied to
the incoming gradient with the same seed and key: the mask is drawn
again, never stored.

Two versions of one function:

  * the hand-written CUDA kernel (``csrc/dropout.cu``, built by
    ``_build``), taken for every CUDA tensor; a tensor it cannot take
    raises, there is no fallback;
  * ``_dropout_plain``, the same draw in int64 tensor ops, taken for CPU
    tensors; ``chip_smoke.py`` holds the kernel against it on the card,
    bit for bit.

``dropout.launches`` counts kernel launches (forward and backward alike).
"""

import ctypes
import math

import numpy as np
import torch

from . import _build
from ..core.philox import words as _bits

__all__ = ["dropout", "keep_threshold", "upscale"]

_KIND = {torch.float32: 0, torch.bfloat16: 1}


def keep_threshold(p):
    """The integer an element's top 24 random bits must be below for the
    element to be kept at drop probability ``p``."""
    return int(math.ceil((1.0 - float(p)) * (1 << 24)))


def upscale(p):
    """The f32 factor ``upscale_in_train`` multiplies kept elements by:
    the f32 reciprocal of the f32 keep probability, as a Python float."""
    return float(np.float32(1.0) / np.float32(1.0 - float(p)))


def _dropout_plain(x, seed, key, p, scale, want_mask):
    """Plain PyTorch (out, mask or None): the kernel's function."""
    bits = _bits(x.numel(), seed, key, x.device)
    mf = ((bits >> 8) < keep_threshold(p)).reshape(x.shape).float()
    out = x.float() * mf
    if scale:
        out = out * upscale(p)     # exact in f32: one rounded product
    return out.to(x.dtype), (mf.to(x.dtype) if want_mask else None)


# --------------------------------------------------------------------------
def _lib():
    lib = _build.load("dropout")
    if lib.ptt_dropout.argtypes is None:
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.ptt_dropout.argtypes = [p, p, p, ctypes.c_longlong, p, u, u,
                                    ctypes.c_float, i, i, p]
        lib.ptt_dropout.restype = i
        lib.ptt_dropout_error_string.argtypes = [i]
        lib.ptt_dropout_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond, msg, *args):
    if not cond:
        raise ValueError("dropout CUDA kernel: " + msg % args)


def _dropout_cuda(x, seed, key, p, scale, want_mask):
    """Launch the kernel: (out, mask or None) in x's dtype."""
    _check(x.dtype in _KIND, "x must be float32 or bfloat16, got %s",
           x.dtype)
    _check(x.device.type == "cuda" and x.is_contiguous()
           and x.data_ptr() % 16 == 0,
           "x must be contiguous 16-byte-aligned CUDA storage")
    _check(seed.device == x.device and seed.dtype == torch.int64
           and seed.numel() == 1,
           "the seed must be one int64 on x's device, got %s %s",
           seed.dtype, seed.device)
    _check(0 <= key < 2 ** 32, "the op key must fit 32 bits, got %d", key)
    out = torch.empty_like(x)
    mask = torch.empty_like(x) if want_mask else None
    if x.numel() == 0:
        return out, mask
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ptt_dropout(x.data_ptr(), out.data_ptr(),
                         None if mask is None else mask.data_ptr(),
                         x.numel(), seed.data_ptr(), int(key),
                         keep_threshold(p), upscale(p) if scale else 1.0,
                         int(bool(scale)), _KIND[x.dtype], stream)
    if rc != 0:
        raise RuntimeError("dropout CUDA kernel failed to launch: %s (%d)"
                           % (lib.ptt_dropout_error_string(rc).decode(),
                              rc))
    dropout.launches += 1
    return out, mask


def _draw(x, seed, key, p, scale, want_mask):
    if x.device.type == "cpu":
        return _dropout_plain(x, seed, key, p, scale, want_mask)
    if x.device.type != "cuda":
        raise ValueError("dropout runs on CPU or CUDA tensors, got %s"
                         % (x.device,))
    return _dropout_cuda(x.contiguous(), seed, key, p, scale, want_mask)


class _Dropout(torch.autograd.Function):
    """Out (and Mask, not differentiable); the backward draws the mask
    again from the same seed and key."""

    @staticmethod
    def forward(ctx, x, seed, key, p, scale, want_mask):
        out, mask = _draw(x, seed, key, p, scale, want_mask)
        ctx.draw = (seed, key, p, scale)
        if mask is None:
            mask = torch.empty(0, dtype=x.dtype, device=x.device)
        ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, dout, _dmask):
        seed, key, p, scale = ctx.draw
        dx, _ = _draw(dout, seed, key, p, scale, False)
        return dx, None, None, None, None, None


def dropout(x, seed, key, p, scale=False, want_mask=False):
    """(out, mask or None) of dropout at drop probability ``p`` over
    ``x``, drawn from ``seed`` (an int64 scalar tensor on x's device) and
    the op key ``key``; ``scale`` multiplies the kept elements by
    ``upscale(p)``. Differentiable in x."""
    out, mask = _Dropout.apply(x, seed, int(key), float(p), bool(scale),
                               bool(want_mask))
    return out, (mask if want_mask else None)


dropout.launches = 0
