"""Philox4x32-10 on int64 tensors: the port's one counter-based generator.

The sampler (``serving/sampling.py``) and dropout (``ops/dropout.py``)
draw from it. It holds no ``torch.Generator`` state: the bits are a pure
function of (counter, key), written with integer tensor ops, so the CPU
and the card give the same bits and a CUDA graph can hold a draw (there
is no generator offset to register). ``ops/csrc/dropout.cu`` computes the
same rounds in registers.
"""

__all__ = ["philox4x32", "MASK32"]

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments


def _mulhilo(a, m):
    """(high, low) 32-bit words of ``a * m`` for int64 tensors ``a`` <
    2**32 and a 32-bit constant ``m``. The full product would overflow
    int64, so ``m`` is split into 16-bit halves: both partial products
    stay under 2**48."""
    p0 = a * (m & 0xFFFF)
    p1 = a * (m >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (t >> 32) + (p1 >> 16), t & MASK32


def philox4x32(counter, key, rounds=10):
    """Philox4x32-``rounds`` (Salmon et al., SC'11; the generator of
    cuRAND and PyTorch): ``counter`` is four int64 tensors of 32-bit
    words, ``key`` two; returns the four 32-bit output words as int64
    tensors. Integer ops only, so the CPU and the card give the same
    bits."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3
