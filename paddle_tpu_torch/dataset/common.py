"""Dataset infrastructure.

Reference parity: python/paddle/dataset/common.py (cached download + reader
conventions). This environment has no network egress, so every dataset module
provides a deterministic *synthetic* generator with the same reader API,
shapes, and vocabulary sizes as the real dataset; if the real files are
already present under _data_home() they are used instead.
"""

import hashlib
import os

import numpy as np

def _data_home():
    # resolved per call through the central flag table so
    # flags.set_flag("data_home", ...) and late env changes are honored
    from .. import flags
    return os.path.expanduser(flags.get_flag("data_home"))


def data_path(module, filename):
    return os.path.join(_data_home(), module, filename)


def have_file(module, filename):
    return os.path.exists(data_path(module, filename))


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """No-egress stub: returns the cache path if the file exists, else raises
    with a clear message (synthetic readers never call this)."""
    path = data_path(module_name, save_name or url.split("/")[-1])
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "dataset file %s not present and downloads are disabled; "
        "synthetic data is used automatically by the reader API" % path)


def synthetic_rng(name, seed=0):
    """Deterministic per-dataset RNG so synthetic data is stable across runs."""
    h = int(hashlib.md5(name.encode()).hexdigest()[:8], 16)
    return np.random.RandomState((h + seed) % (2 ** 31))
