"""v2 Parameters (python/paddle/v2/parameters.py parity): a dict-like view
of a model's trainable parameters with the reference's tar-archive
save/load (`to_tar`/`from_tar`, v2/trainer.py:130 save_parameter_to_tar).

Here a Parameters object owns the fluid Scope the trainer runs in; values
are numpy arrays keyed by parameter name (read back from the tensors the
trainer leaves, wherever they live). The tar holds the same bytes as the
JAX package's: a tar written by either loads in the other."""

import io
import tarfile

import numpy as np

from ..core.executor import as_numpy
from ..core.scope import Scope


class Parameters:
    def __init__(self, scope=None):
        self._scope = scope or Scope()
        self._names = []

    # -- creation ----------------------------------------------------------
    @classmethod
    def create(cls, *topologies):
        """Track the parameters of the given cost layers' program(s)."""
        p = cls()
        for t in topologies:
            prog = t.block.program
            for param in prog.global_block().all_parameters():
                if param.name not in p._names:
                    p._names.append(param.name)
        return p

    # -- dict protocol -----------------------------------------------------
    def keys(self):
        return list(self._names)

    names = keys

    def has_key(self, key):
        return key in self._names

    def __contains__(self, key):
        return key in self._names

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __getitem__(self, key):
        v = self._scope.find_var(key)
        if v is None:
            raise KeyError("parameter %r has no value yet (run the trainer "
                           "or from_tar first)" % key)
        return as_numpy(v)

    def __setitem__(self, key, value):
        if key not in self._names:
            self._names.append(key)
        self._scope.set(key, np.asarray(value))

    def get(self, key):
        return self.__getitem__(key)

    def set(self, key, value):
        self.__setitem__(key, value)

    # -- tar round-trip ----------------------------------------------------
    def to_tar(self, f):
        """Write one .npy member per parameter into an (uncompressed) tar —
        the v2 `parameters.to_tar(open(path, 'wb'))` contract."""
        with tarfile.open(fileobj=f, mode="w") as tar:
            for name in self._names:
                buf = io.BytesIO()
                np.save(buf, self[name], allow_pickle=False)
                data = buf.getvalue()
                info = tarfile.TarInfo(name=name + ".npy")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))

    @classmethod
    def from_tar(cls, f):
        p = cls()
        with tarfile.open(fileobj=f, mode="r") as tar:
            for member in tar.getmembers():
                name = member.name
                if name.endswith(".npy"):
                    name = name[:-4]
                buf = io.BytesIO(tar.extractfile(member).read())
                p[name] = np.load(buf, allow_pickle=False)
        return p

    def init_from_tar(self, f):
        other = Parameters.from_tar(f)
        for name in other.keys():
            self[name] = other[name]


def create(*topologies):
    """Module-level alias: paddle.parameters.create(cost)."""
    return Parameters.create(*topologies)
