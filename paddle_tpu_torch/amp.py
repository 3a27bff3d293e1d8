"""Automatic mixed precision: bf16 compute, fp32 accumulation and state.

The counterpart of ``paddle_tpu/amp.py``, with its policy: the inputs of
the matmul-class ops (``mul``, ``matmul``, the convolutions) are cast to
bfloat16, the products run on bfloat16 operands with fp32 accumulation
(cuBLAS and cuDNN on the card, tensor cores), and every parameter,
optimizer moment and batch-norm statistic stays fp32 (master weights).
The product's result stays bfloat16 (``amp_out``), so an op that reads it
next (the flash kernels behind ``sp_attention``, a batch norm) gets
bfloat16, as in the JAX package; an op that mixes it with an fp32 tensor
(a bias add, a residual) promotes back to fp32 by the type promotion both
packages share. Enable per process with ``enable_amp()`` or scoped with
``amp_guard()``; the lowerings read the flag as they run, and
``Executor.run_steps`` keys its CUDA graphs by it.
"""

import contextlib

import torch

_AMP = {"enabled": False}


def enable_amp(flag=True):
    _AMP["enabled"] = bool(flag)


def amp_enabled():
    return _AMP["enabled"]


@contextlib.contextmanager
def amp_guard(enable=True):
    old = _AMP["enabled"]
    _AMP["enabled"] = bool(enable)
    try:
        yield
    finally:
        _AMP["enabled"] = old


def maybe_bf16(*tensors):
    """Cast fp32 tensors to bf16 when AMP is on (the inputs of the
    matmul-class ops)."""
    if not _AMP["enabled"]:
        return tensors if len(tensors) > 1 else tensors[0]
    out = tuple(t.to(torch.bfloat16)
                if t is not None and t.dtype == torch.float32 else t
                for t in tensors)
    return out if len(out) > 1 else out[0]


def amp_out(out, orig_dtype):
    """Result-dtype policy of the matmul-class ops: without AMP, the
    op's input dtype; with AMP and an fp32 input, bfloat16 (the
    activation stays half width; a parameter's gradient comes back fp32
    through the cast's backward)."""
    if _AMP["enabled"] and orig_dtype == torch.float32:
        return out.to(torch.bfloat16)
    return out.to(orig_dtype)

