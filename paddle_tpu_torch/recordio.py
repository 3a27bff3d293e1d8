"""RecordIO-equivalent durable data files.

Reference parity: paddle/fluid/recordio/ (chunk.h:26 chunked + checksummed
+ compressed records, scanner.h:26 sequential Scanner) and
python/paddle/fluid/recordio_writer.py (convert_reader_to_recordio_file).
The counterpart of ``paddle_tpu/recordio.py``, over the port's own copy
of the native library (``native/recordio/recordio.cc``, built with g++
and zlib into ``build/paddle_tpu_torch/native/`` at first use) and bound
via ctypes; this module adds the record<->sample codec (numpy-aware,
pickle-free for plain arrays) and the reader-creator that plugs recordio
files into the paddle.batch / DeviceLoader data plane. Files and records
are byte for byte the JAX package's: either package reads the other's.
"""

import ctypes
import io
import struct

import numpy as np

from . import native

COMPRESSOR_NONE = 0
COMPRESSOR_DEFLATE = 1


def _lib():
    lib = native.load("recordio")
    if not getattr(lib, "_rio_configured", False):
        lib.rio_writer_open.restype = ctypes.c_void_p
        lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_uint64]
        lib.rio_writer_write.restype = ctypes.c_int
        lib.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_uint64]
        lib.rio_writer_close.restype = ctypes.c_uint64
        lib.rio_writer_close.argtypes = [ctypes.c_void_p]
        lib.rio_scanner_open.restype = ctypes.c_void_p
        lib.rio_scanner_open.argtypes = [ctypes.c_char_p]
        lib.rio_scanner_next.restype = ctypes.POINTER(ctypes.c_char)
        lib.rio_scanner_next.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_uint64)]
        lib.rio_scanner_close.argtypes = [ctypes.c_void_p]
        lib.rio_last_error.restype = ctypes.c_char_p
        lib._rio_configured = True
    return lib


def _err(lib):
    return lib.rio_last_error().decode("utf-8", "replace")


class Writer:
    """Sequential record writer (recordio_writer.py Writer parity)."""

    def __init__(self, path, compressor=COMPRESSOR_DEFLATE,
                 max_chunk_bytes=1 << 20):
        self._lib = _lib()
        self._h = self._lib.rio_writer_open(
            path.encode(), int(compressor), int(max_chunk_bytes))
        if not self._h:
            raise IOError(_err(self._lib))
        self._closed = False

    def write(self, record):
        if self._closed:
            raise ValueError("writer is closed")
        if not isinstance(record, (bytes, bytearray)):
            raise TypeError("record must be bytes, got %r" % type(record))
        if self._lib.rio_writer_write(self._h, bytes(record),
                                      len(record)) != 0:
            raise IOError(_err(self._lib))

    def close(self):
        if not self._closed:
            self._closed = True
            total = self._lib.rio_writer_close(self._h)
            if total == (1 << 64) - 1:
                raise IOError(_err(self._lib))
            return int(total)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Scanner:
    """Sequential record reader (recordio scanner.h:26 parity); iterable."""

    def __init__(self, path):
        self._lib = _lib()
        self._h = self._lib.rio_scanner_open(path.encode())
        if not self._h:
            raise IOError(_err(self._lib))
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:                  # exhausted/closed: never touch
            raise StopIteration           # the freed native handle
        n = ctypes.c_uint64()
        p = self._lib.rio_scanner_next(self._h, ctypes.byref(n))
        if not p:
            if n.value == (1 << 64) - 1:
                self.close()
                raise IOError(_err(self._lib))
            self.close()
            raise StopIteration
        return ctypes.string_at(p, n.value)

    def close(self):
        if not self._closed:
            self._closed = True
            self._lib.rio_scanner_close(self._h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# --------------------------------------------------------------------------
# sample codec: tuples of numpy arrays / scalars <-> bytes. Arrays use the
# .npy wire format (allow_pickle=False — no arbitrary code execution from
# data files, unlike the reference's cPickle records).
_SCALAR = b"s"
_ARRAY = b"a"


def encode_sample(sample):
    if not isinstance(sample, (tuple, list)):
        sample = (sample,)
    buf = io.BytesIO()
    buf.write(struct.pack("<I", len(sample)))
    for field in sample:
        arr = np.asarray(field)
        kind = _SCALAR if arr.ndim == 0 and arr.dtype.kind in "if" \
            else _ARRAY
        sub = io.BytesIO()
        np.save(sub, arr, allow_pickle=False)
        data = sub.getvalue()
        buf.write(kind)
        buf.write(struct.pack("<I", len(data)))
        buf.write(data)
    return buf.getvalue()


def decode_sample(record):
    buf = io.BytesIO(record)
    n, = struct.unpack("<I", buf.read(4))
    fields = []
    for _ in range(n):
        kind = buf.read(1)
        ln, = struct.unpack("<I", buf.read(4))
        arr = np.load(io.BytesIO(buf.read(ln)), allow_pickle=False)
        fields.append(arr.item() if kind == _SCALAR else arr)
    return tuple(fields)


# --------------------------------------------------------------------------
# data-plane integration (recordio_writer.py / reader ops parity)
def convert_reader_to_recordio_file(filename, reader_creator,
                                    compressor=COMPRESSOR_DEFLATE,
                                    max_chunk_bytes=1 << 20,
                                    feeder=None):
    """Materialize a python reader into a recordio file; returns the
    record count (reference recordio_writer.py:convert_reader_to_recordio_file)."""
    if feeder is not None:
        raise NotImplementedError(
            "feeder-transformed serialization is not supported; samples "
            "are encoded with the numpy codec — pre-transform the reader "
            "instead")
    with Writer(filename, compressor, max_chunk_bytes) as w:
        count = 0
        for sample in reader_creator():
            w.write(encode_sample(sample))
            count += 1
        w.close()
    return count


def reader(filename):
    """Reader creator over a recordio file: plugs into paddle.batch /
    shuffle / DeviceLoader exactly like an in-memory reader (the role of
    the reference's create_recordio_file_reader op)."""
    def _reader():
        scanner = Scanner(filename)
        try:
            for record in scanner:
                yield decode_sample(record)
        finally:
            scanner.close()   # early-abandoned passes must not leak FILE*
    return _reader
