"""Device places.

The counterpart of ``paddle_tpu/core/places.py``. A Place answers one
question: which ``torch.device`` a program executes on.

  * ``CUDAPlace(i)`` is the accelerator place: ``cuda:i``. ``TPUPlace``
    is accepted as its alias, so scripts written for the JAX package
    (``fluid.TPUPlace(0)``) run unchanged — mirroring how the JAX package
    aliases ``CUDAPlace`` to its accelerator.
  * ``CPUPlace()`` is the CPU, taken only when the caller asks for it;
    ``CUDAPinnedPlace()`` is its alias, as in the JAX package (pinned
    staging is ``reader.DeviceLoader``'s business).

Resolving an accelerator place without a card raises: the port never
falls back to the CPU on its own.
"""

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "CUDAPinnedPlace",
           "resolve_device", "is_compiled_with_cuda", "is_compiled_with_tpu"]


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


class Place:
    """Base device identity."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (
            type(self) is type(other) and self.device_id == other.device_id
        )

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)

    def torch_device(self):
        raise NotImplementedError


class CPUPlace(Place):
    def __init__(self):
        super().__init__(0)

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    def torch_device(self):
        return resolve_device("cuda:%d" % self.device_id)


class TPUPlace(CUDAPlace):
    """Alias of the accelerator place for scripts written against the
    JAX package."""


class CUDAPinnedPlace(CPUPlace):
    """Reference-compat alias of the host place."""


def is_compiled_with_cuda():
    """Whether this PyTorch build has CUDA (a card may still be absent)."""
    return bool(torch.backends.cuda.is_built())


def is_compiled_with_tpu():
    return False
