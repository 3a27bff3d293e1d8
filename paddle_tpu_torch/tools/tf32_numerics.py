"""TF32 rounding and the 3xTF32 product in plain PyTorch, as the port's
CUDA kernels take their fp32 products on the tensor cores; and the bank
reckoning of their shared-memory fragment reads. These emulations hold
the kernels' numerics and layouts on a machine without a card (the
port's kernel tests use them); the kernels never call them."""

import torch

# chip_smoke.py's fp32 tolerance: atol 1e-5 (of the largest value, for
# gradients) plus rtol 1e-4 per element
CHIP_RTOL, CHIP_ATOL = 1e-4, 1e-5


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits; nearest, ties away from zero),
    as cvt.rna.tf32.f32 and the kernels' integer form round: add half a
    TF32 ulp to the magnitude bits, clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernels take it: small*big + big*small, then big*big.
    Products of TF32 values are exact in f32; sums are f32."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return (asm @ bb + ab @ bsm) + ab @ bb


def _mm_tf32(a, b):
    """a @ b in one pass of TF32 (big*big only)."""
    return _tf32(a) @ _tf32(b)


def _banks_conflict_free(words):
    """32 lanes' 32-bit word addresses: no two lanes on one bank with
    different words (lanes on one word are served by a broadcast)."""
    by_bank = {}
    for w in words:
        by_bank.setdefault(w % 32, set()).add(w)
    return all(len(ws) == 1 for ws in by_bank.values())
