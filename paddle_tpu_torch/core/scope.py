"""Scope: hierarchical name -> value store for runtime state.

The counterpart of ``paddle_tpu/core/scope.py``. Values are
``torch.Tensor``s on the executor's device: persistable state
(parameters, optimizer accumulators) lives here between ``Executor.run``
calls. ``load_numpy_state`` puts numpy values in (the JAX package's
startup values, for parity runs).
"""

import contextlib

import numpy as np
import torch

from .program import runtime_dtype
from .selected_rows import as_selected_rows

__all__ = ["Scope", "global_scope", "scope_guard", "load_numpy_state",
           "to_tensor"]


class Scope:
    def __init__(self, parent=None):
        self.parent = parent
        self._vars = {}      # name -> torch.Tensor (or None once declared)
        self._kids = []

    # -- reference API -------------------------------------------------------
    def var(self, name):
        """Find-or-create (returns current value holder name)."""
        if name not in self._vars:
            self._vars[name] = None
        return name

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def new_scope(self):
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids = []

    # -- value access --------------------------------------------------------
    def set(self, name, value):
        self._vars[name] = value

    def get(self, name, default=None):
        v = self.find_var(name)
        return default if v is None else v

    def get_numpy(self, name):
        v = self.find_var(name)
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    def erase(self, name):
        self._vars.pop(name, None)

    def local_var_names(self):
        return list(self._vars)

    def __contains__(self, name):
        return self.has_var(name)


_TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(dtype):
    """The torch dtype a Program dtype runs as (64-bit narrowed, as
    ``runtime_dtype`` says)."""
    name = runtime_dtype(dtype)
    if name not in _TORCH_DTYPES:
        raise TypeError("dtype %r has no torch counterpart in the port"
                        % (name,))
    return _TORCH_DTYPES[name]


def to_tensor(value, device):
    """A numpy array, scalar or tensor as a torch tensor on ``device``,
    64-bit types narrowed to 32-bit (what the JAX package holds). A
    SelectedRows (the port's or the JAX package's) becomes the port's on
    ``device``, its value narrowed the same way and its rows int64."""
    if hasattr(value, "rows") and hasattr(value, "height"):
        sr = as_selected_rows(value, device)
        sr.value = sr.value.to(torch_dtype(sr.value.dtype))
        return sr
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        t = torch.from_numpy(np.ascontiguousarray(arr)) if arr.ndim \
            else torch.tensor(arr.item(), dtype=torch_dtype(arr.dtype))
    t = t.to(device=device, dtype=torch_dtype(t.dtype))
    return t


def load_numpy_state(scope, arrays, device):
    """Put ``{name: ndarray}`` into ``scope`` as tensors on ``device``
    (copies; 64-bit types narrowed). The training counterpart of
    ``params_from_stream``: parity runs start the port from the JAX
    package's startup values."""
    device = torch.device(device)
    for name, arr in arrays.items():
        scope.set(name, to_tensor(np.array(arr), device))


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = old
