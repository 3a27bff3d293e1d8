"""Build and load the port's CUDA kernels at first use.

Each kernel source under ``ops/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface,
loaded with ``ctypes``. Libraries go to ``build/paddle_tpu_torch/`` at
the repository root, named by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one loads at once. ``load_all``
builds several sources at once, one ``nvcc`` process each. A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["load", "load_all", "build_log", "nvcc_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "paddle_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
build_log = {}      # kernel name -> nvcc's output (ptxas register report)


def nvcc_path():
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, then the
    one on ``PATH``, then ``/usr/local/cuda/bin/nvcc``. Raises when
    none exists."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels cannot be built")


def _target(name):
    """(source path, library path) of kernel ``name``."""
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        text = f.read()
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, "%s_%s.so" % (name, digest))


def load_all(names):
    """The loaded ``ctypes.CDLL`` of each kernel in ``names`` (sources
    ``ops/csrc/<name>.cu``). Libraries not built yet are compiled first,
    all ``nvcc`` processes started together and every one waited for."""
    with _lock:
        jobs = []
        for name in names:
            if name in _libs:
                continue
            src, so = _target(name)
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = "%s.%d.tmp" % (so, os.getpid())
                proc = subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                jobs.append((name, src, so, tmp, proc))
        failed = []
        for name, src, so, tmp, proc in jobs:
            build_log[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append("nvcc failed building %s (exit %d):\n%s"
                              % (src, proc.returncode, build_log[name]))
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(_target(name)[1])
        return [_libs[name] for name in names]


def load(name):
    """The loaded ``ctypes.CDLL`` of kernel ``name``, building it first
    when needed."""
    return load_all([name])[0]
