"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The package mirrors ``paddle_tpu``'s layout and names so each module's
counterpart is easy to find; it imports ``torch`` and never ``jax`` or
``paddle_tpu``. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.

Ported so far (the serving slice): ``serving.Engine`` over
``models.transformer_infer.TransformerLMInfer`` with the paged KV pool,
the radix prefix cache and the hand-written CUDA paged-attention kernel
(``ops/csrc/paged_attention.cu``).
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: ``cuda`` when
    ``device`` is None. Raises when a CUDA device is asked for (or
    defaulted to) and none is present — the port never falls back to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
