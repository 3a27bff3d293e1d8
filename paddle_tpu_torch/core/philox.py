"""Philox4x32-10 on int64 tensors: the port's one counter-based generator.

The sampler (``serving/sampling.py``), dropout (``ops/dropout.py``) and
the random ops (``ops/tensor_ops.py``'s uniform, gaussian and truncated
gaussian draws, ``ops/loss.py``'s ``nce`` negatives) draw from it. It
holds no ``torch.Generator`` state: the bits are a pure function of
(counter, key), written with integer tensor ops, so the CPU and the card
give the same bits and a CUDA graph can hold a draw (there is no
generator offset to register). ``ops/csrc/dropout.cu`` computes the
same rounds in registers.
"""

import torch

__all__ = ["philox4x32", "MASK32", "words", "unit24"]

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments


def philox4x32(counter, key, rounds=10):
    """Philox4x32-``rounds`` (Salmon et al., SC'11; the generator of
    cuRAND and PyTorch): ``counter`` is four int64 tensors of 32-bit
    words, ``key`` two (each may be a 0-dim tensor or a host int,
    broadcast against the others); returns the four 32-bit output words as int64 tensors.
    Integer ops only, so the CPU and the card give the same bits: a
    round's product of two 32-bit words is under 2**64, and int64
    multiplication keeps its low 64 bits (it wraps on both devices), so
    its high word is bits 32-63 of the wrapped product. A round makes
    four tensors and works on them in place (on the CPU the allocations
    cost more than the arithmetic)."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        p0 = c0 * _M0
        p1 = c2 * _M1
        hi1 = (p1 >> 32).bitwise_and_(MASK32).bitwise_xor_(c1)
        hi0 = (p0 >> 32).bitwise_and_(MASK32).bitwise_xor_(c3)
        c0, c1 = hi1.bitwise_xor_(k0), p1.bitwise_and_(MASK32)
        c2, c3 = hi0.bitwise_xor_(k1), p0.bitwise_and_(MASK32)
    return c0, c1, c2, c3


# counters a chunk of ``words``: bounds the int64 temporaries of a large
# draw (an embedding table's initializer) to a few MB, which the CPU's
# caches hold (2x faster there than 2**20 counters a chunk)
_CHUNK = 1 << 18


def words(n, seed, key, device):
    """The ``n`` 32-bit words of the draw keyed by (``seed``, ``key``), as
    int64 [n]: word i is word i % 4 of Philox4x32-10 at counter (i // 4
    low word, i // 4 high word, 0, 0) and key (seed mod 2**32, key), so
    a draw of n values costs n / 4 Philox calls. ``seed`` is an int64
    device scalar (the run's seed: a CUDA graph replays whatever seed
    was staged for its step), ``key`` a host int under 2**32 (the op's
    ordinal among the program's random ops). The seed and the counter's
    zero words stay 0-dim and the key a host int (no copy to the device,
    which a CUDA graph capture refuses); each chunk's words are written
    in place into the one output."""
    seed = seed.to(device=device, dtype=torch.int64).reshape(()) & MASK32
    zero = torch.zeros((), dtype=torch.int64, device=device)
    total = max((n + 3) // 4, 1)
    out = torch.empty((total, 4), dtype=torch.int64, device=device)
    for lo in range(0, total, _CHUNK):
        hi = min(total, lo + _CHUNK)
        ctr = torch.arange(lo, hi, dtype=torch.int64, device=device)
        ws = philox4x32((ctr & MASK32, ctr >> 32, zero, zero), (seed, key))
        for j, w in enumerate(ws):
            out[lo:hi, j] = w
    return out.reshape(-1)[:n]


def unit24(w):
    """Words as float64 uniforms in [0, 1): their top 24 bits times
    2**-24 (exact, and the same uniform dropout thresholds)."""
    return (w >> 8).to(torch.float64) * (1.0 / (1 << 24))
