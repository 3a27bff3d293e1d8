"""Native (C++) runtime components of the port, built at first use.

The counterpart of ``paddle_tpu/native/__init__.py``. Each component's
source, ``native/<name>/<name>.cc``, is compiled by ``g++`` into a
shared library with a plain C interface and loaded with ``ctypes``:

  * ``librecordio`` — the chunked, CRC-checked, DEFLATE-compressed record
    file format (``recordio/recordio.cc``; zlib), read and written by
    ``paddle_tpu_torch.recordio``.

Libraries go to ``build/paddle_tpu_torch/native/`` at the repository
root (never into the source tree), named by a hash of the source and the
flags, so a changed source rebuilds and an unchanged one loads at once.
Several processes may build at once (the test suite runs in parallel
workers): each compiles to a name of its own and ``os.replace`` moves
the finished library into place, which is atomic. A missing compiler,
a missing ``zlib.h`` or any other failed build raises
``NativeBuildError`` with the compiler's output; there is no fallback.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["load", "NativeBuildError", "BUILD_DIR"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "paddle_tpu_torch", "native")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-lz",)

_LOCK = threading.Lock()
_LIBS = {}


class NativeBuildError(RuntimeError):
    pass


def _target(name):
    """(source path, library path) of component ``name``."""
    src = os.path.join(_DIR, name, name + ".cc")
    with open(src, "rb") as f:
        text = f.read()
    digest = hashlib.sha256(
        text + " ".join(CXX_FLAGS + LINK_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, digest))


def _build(src, so, link=LINK_FLAGS):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.%d.tmp" % (so, os.getpid(), threading.get_ident())
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, src, *link]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(
            "failed to build %s: %s (need g++ and zlib)" % (src, e)) from e
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise NativeBuildError(
            "failed to build %s (need g++ and zlib): %s\n%s"
            % (src, " ".join(cmd), proc.stderr.strip()[-2000:]))
    os.replace(tmp, so)


def load(name):
    """The loaded ``ctypes.CDLL`` of component ``name``, built first
    when its library is missing; cached per process."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src, so = _target(name)
        if not os.path.exists(so):
            _build(src, so)
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib
