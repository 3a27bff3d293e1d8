"""The port's recordio files and multi-file ingestion against the JAX
package: twins of ``tests/test_recordio.py`` and
``tests/test_open_files.py``, on ``paddle_tpu_torch.recordio`` (the port's
copy of the native library, built with g++ and zlib into
``build/paddle_tpu_torch/native/``) and ``paddle_tpu_torch.reader``.

* Byte round trips over several chunks, both compressors, the sample
  codec, CRC and header corruption, truncation, an understated record
  count, scanner exhaustion and early abandon.
* A file written by either package is byte-identical to the other's for
  the same records and compressor, and each package reads the other's.
* The library builds under ``build/`` only, safely when several
  processes build it at once, and a failed build raises with the
  compiler's output.
* ``open_files``: threads, shards (explicit, and by default from a
  two-process ``torch.distributed`` gloo group), passes, shuffling,
  error propagation, thread reaping, the half-given shard spec's error,
  and training through ``DataFeeder`` and the Executor.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu.recordio as jrecordio
import paddle_tpu_torch as fluid
from paddle_tpu_torch import native
from paddle_tpu_torch import recordio
from paddle_tpu_torch.reader import open_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPRESSORS = [recordio.COMPRESSOR_DEFLATE, recordio.COMPRESSOR_NONE]


def _records(n=200, seed=0):
    return [os.urandom(np.random.RandomState(seed + i).randint(1, 4000))
            for i in range(n)]


def _write(mod, path, records, compressor, max_chunk_bytes=8192):
    with mod.Writer(path, compressor=compressor,
                    max_chunk_bytes=max_chunk_bytes) as w:
        for r in records:
            w.write(r)


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_bytes_roundtrip_multiple_chunks(tmp_path, compressor):
    path = str(tmp_path / "r.rio")
    records = _records()
    _write(recordio, path, records, compressor)
    assert list(recordio.Scanner(path)) == records
    assert os.path.getsize(path) > 8192        # several chunks


@pytest.mark.parametrize("compressor", COMPRESSORS)
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_files_identical_and_cross_readable(tmp_path, writer, compressor):
    """The same records and compressor give the same bytes from either
    package, and each package scans the file the other wrote."""
    records = _records(120, seed=7) + [b"", b"abc" * 1000]
    mine, theirs = (recordio, jrecordio) if writer == "torch" else \
        (jrecordio, recordio)
    a, b = str(tmp_path / "a.rio"), str(tmp_path / "b.rio")
    _write(mine, a, records, compressor)
    _write(theirs, b, records, compressor)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert list(theirs.Scanner(a)) == records
    assert list(mine.Scanner(b)) == records


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_samples_cross_readable(tmp_path, writer):
    """Samples converted by one package decode identically in the other
    (the codec's bytes too)."""
    rng = np.random.RandomState(1)
    samples = [(rng.rand(2, 3).astype(np.float32),
                rng.randint(0, 9, 4).astype(np.int64), int(i), 0.5 * i)
               for i in range(9)]
    mine, theirs = (recordio, jrecordio) if writer == "torch" else \
        (jrecordio, recordio)
    for s in samples:
        assert mine.encode_sample(s) == theirs.encode_sample(s)
    path = str(tmp_path / "s.rio")
    assert mine.convert_reader_to_recordio_file(
        path, lambda: iter(samples)) == 9
    back = list(theirs.reader(path)())
    for got, want in zip(back, samples):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:] and isinstance(got[2], int)


def test_compression_none_vs_deflate(tmp_path):
    comp = str(tmp_path / "c.rio")
    raw = str(tmp_path / "n.rio")
    data = [b"abc" * 1000] * 50
    for path, compressor in ((comp, recordio.COMPRESSOR_DEFLATE),
                             (raw, recordio.COMPRESSOR_NONE)):
        _write(recordio, path, data, compressor, 1 << 20)
    assert list(recordio.Scanner(comp)) == data
    assert list(recordio.Scanner(raw)) == data
    assert os.path.getsize(comp) < os.path.getsize(raw) / 5


def _corrupt_payload(blob):
    blob[-3] ^= 0xFF


def _corrupt_header_lengths(blob):
    blob[12] = 0xFF   # raw_len high byte
    blob[20] = 0xFF   # comp_len high byte


def _truncate(blob):
    del blob[len(blob) // 2:]


@pytest.mark.parametrize("damage", [_corrupt_payload,
                                    _corrupt_header_lengths, _truncate])
def test_damaged_file_raises_ioerror(tmp_path, damage):
    """A flipped payload byte (CRC), header lengths (no huge
    allocation) and a truncated file each raise IOError."""
    path = str(tmp_path / "x.rio")
    with recordio.Writer(path) as w:
        w.write(b"hello world" * 100)
    blob = bytearray(open(path, "rb").read())
    damage(blob)
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        list(recordio.Scanner(path))


def test_understated_record_count_detected(tmp_path):
    path = str(tmp_path / "cnt.rio")
    _write(recordio, path, [b"rec%d" % i for i in range(5)],
           recordio.COMPRESSOR_NONE)
    blob = bytearray(open(path, "rb").read())
    assert blob[6] == 5            # num_records low byte
    blob[6] = 3
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        list(recordio.Scanner(path))


def test_sample_codec_numpy_and_scalars():
    sample = (np.arange(6, dtype=np.float32).reshape(2, 3),
              np.array([1, 2, 3], np.int64), 7, 2.5)
    back = recordio.decode_sample(recordio.encode_sample(sample))
    np.testing.assert_array_equal(back[0], sample[0])
    np.testing.assert_array_equal(back[1], sample[1])
    assert back[2] == 7 and abs(back[3] - 2.5) < 1e-12
    assert isinstance(back[2], int)


def test_convert_reader_and_read_back(tmp_path):
    path = str(tmp_path / "ds.rio")
    rng = np.random.RandomState(0)
    xs = rng.rand(37, 4).astype(np.float32)
    ys = rng.randint(0, 3, 37).astype(np.int64)

    def creator():
        for i in range(37):
            yield xs[i], int(ys[i])

    assert recordio.convert_reader_to_recordio_file(path, creator) == 37
    back = list(recordio.reader(path)())
    assert len(back) == 37
    np.testing.assert_allclose(back[5][0], xs[5])
    assert back[5][1] == ys[5]
    batches = list(fluid.batch(
        fluid.reader.shuffle(recordio.reader(path), 37), batch_size=10)())
    assert sum(len(b) for b in batches) == 37
    with pytest.raises(NotImplementedError, match="feeder"):
        recordio.convert_reader_to_recordio_file(path, creator, feeder=1)


def test_writer_and_scanner_misuse(tmp_path):
    path = str(tmp_path / "m.rio")
    w = recordio.Writer(path)
    with pytest.raises(TypeError):
        w.write("not bytes")
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.write(b"x")
    with pytest.raises(IOError):
        recordio.Scanner(str(tmp_path / "missing.rio"))


def test_scanner_safe_after_exhaustion(tmp_path):
    path = str(tmp_path / "s.rio")
    with recordio.Writer(path) as w:
        w.write(b"one")
    s = recordio.Scanner(path)
    assert list(s) == [b"one"]
    assert list(s) == []
    with pytest.raises(StopIteration):
        next(s)


def test_reader_early_abandon_does_not_leak_fds(tmp_path):
    import gc
    path = str(tmp_path / "fd.rio")
    recordio.convert_reader_to_recordio_file(
        path, lambda: ((np.zeros(2, np.float32),) for _ in range(50)))
    n0 = len(os.listdir("/proc/self/fd"))
    for _ in range(20):
        it = recordio.reader(path)()
        next(it)
        it.close()
    gc.collect()
    assert len(os.listdir("/proc/self/fd")) <= n0 + 1


def test_train_from_recordio_file(tmp_path):
    """file -> reader -> DataFeeder -> Executor: the loss converges."""
    path = str(tmp_path / "train.rio")
    rng = np.random.RandomState(0)
    w_true = rng.rand(4, 1).astype(np.float32)

    def creator():
        for _ in range(64):
            x = rng.rand(4).astype(np.float32)
            yield x, float((x @ w_true).item() + 0.5)

    recordio.convert_reader_to_recordio_file(path, creator)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1])
        pred = fluid.layers.fc(x, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    feeder = fluid.DataFeeder([x, y], fluid.CPUPlace(), program=main)
    losses = []
    for _ in range(30):
        for batch in fluid.batch(recordio.reader(path), batch_size=16)():
            lv, = exe.run(main, feed=feeder.feed(batch), fetch_list=[loss],
                          scope=scope)
            losses.append(float(lv))
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])


def test_device_loader_prefetch_from_recordio(tmp_path):
    import torch
    from paddle_tpu_torch.reader import DeviceLoader
    path = str(tmp_path / "dl.rio")
    recordio.convert_reader_to_recordio_file(
        path, lambda: ((np.full((2, 2), i, np.float32),) for i in range(20)))
    feed_dicts = ({"x": np.stack([s[0] for s in b])}
                  for b in fluid.batch(recordio.reader(path), 4)())
    seen = list(DeviceLoader(feed_dicts, capacity=2, device="cpu"))
    assert len(seen) == 5
    assert isinstance(seen[0]["x"], torch.Tensor)
    np.testing.assert_allclose(seen[-1]["x"].numpy()[-1],
                               np.full((2, 2), 19.0))


# --------------------------------------------------------------------------
# the native build

def test_library_builds_under_build_dir():
    lib = native.load("recordio")
    path = lib._name
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR == os.path.join(
        REPO, "build", "paddle_tpu_torch", "native")
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(native.__file__)))
    assert native.load("recordio") is lib
    assert not os.path.realpath(path).startswith(
        os.path.join(REPO, "paddle_tpu") + os.sep)


_BUILDER = r"""
import sys
sys.path.insert(0, %(repo)r)
from paddle_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
lib = native.load("recordio")
print("BUILT", lib._name, flush=True)
"""


def test_concurrent_builds_are_safe(tmp_path):
    """Four processes building into one empty directory at once each
    load a whole library; one library is left and no temporary file."""
    script = tmp_path / "build.py"
    script.write_text(_BUILDER % {"repo": REPO})
    out_dir = str(tmp_path / "native")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, str(script), out_dir],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    built = {ln.split()[1] for o in outs for ln in o.splitlines()
             if ln.startswith("BUILT")}
    assert len(built) == 1
    assert os.listdir(out_dir) == [os.path.basename(built.pop())]


def test_failed_build_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "bad.cc"
    bad.write_text("int f() { return undeclared_name; }\n")
    with pytest.raises(native.NativeBuildError, match="undeclared_name"):
        native._build(str(bad), str(tmp_path / "libbad.so"), ())
    assert os.listdir(tmp_path) == ["bad.cc"]


# --------------------------------------------------------------------------
# open_files

def _write_files(tmp_path, n_files=4, per=5):
    """File f holds samples (f*100 + i, vec) for i < per."""
    paths = []
    for f in range(n_files):
        p = str(tmp_path / ("part-%02d.recordio" % f))

        def creator(f=f):
            for i in range(per):
                yield (np.int64(f * 100 + i),
                       np.full((3,), f, np.float32))
        recordio.convert_reader_to_recordio_file(p, creator)
        paths.append(p)
    return paths


def _ids(reader):
    return sorted(int(s[0]) for s in reader())


def test_open_files_reads_all_samples_threaded(tmp_path):
    paths = _write_files(tmp_path)
    want = sorted(f * 100 + i for f in range(4) for i in range(5))
    assert _ids(open_files(paths)) == want
    assert _ids(open_files(paths, thread_num=3, buffer_size=4)) == want
    r = open_files(paths, thread_num=2)
    assert _ids(r) == want
    assert _ids(r) == want
    with pytest.raises(ValueError, match="empty file list"):
        open_files([])


def test_open_files_shards_are_disjoint_and_cover(tmp_path):
    paths = _write_files(tmp_path)
    s0 = _ids(open_files(paths, shard_id=0, num_shards=2))
    s1 = _ids(open_files(paths, shard_id=1, num_shards=2))
    assert not (set(s0) & set(s1))
    assert sorted(s0 + s1) == sorted(
        f * 100 + i for f in range(4) for i in range(5))
    with pytest.raises(ValueError, match="no files"):
        open_files(paths[:1], shard_id=1, num_shards=2)


def test_open_files_pass_num_and_shuffle(tmp_path):
    paths = _write_files(tmp_path, n_files=2, per=3)
    ids = [int(s[0]) for s in open_files(paths, pass_num=2)()]
    assert sorted(ids) == sorted(2 * [f * 100 + i for f in range(2)
                                      for i in range(3)])
    r = fluid.layers.open_files(paths, shapes=[[3]], dtypes=["float32"],
                                thread_num=2)
    assert len(list(r())) == 6
    one = fluid.layers.open_recordio_file(paths[0])
    assert [int(s[0]) for s in one()] == [0, 1, 2]


def test_open_files_shuffle_matches_jax(tmp_path):
    """Seeded file shuffling gives the JAX package's order (one thread),
    and a new order each epoch."""
    from paddle_tpu.reader import open_files as jopen_files
    paths = _write_files(tmp_path, n_files=8, per=1)
    r = open_files(paths, shuffle_files=True, seed=4)
    j = jopen_files(paths, shuffle_files=True, seed=4)
    e1 = [int(s[0]) for s in r()]
    e2 = [int(s[0]) for s in r()]
    assert sorted(e1) == sorted(e2) and e1 != e2
    assert [e1, e2] == [[int(s[0]) for s in j()] for _ in range(2)]


def test_open_files_propagates_scan_errors(tmp_path):
    paths = _write_files(tmp_path, n_files=2)
    paths.append(str(tmp_path / "missing.recordio"))
    with pytest.raises(IOError):
        list(open_files(paths, thread_num=2)())


def test_open_files_early_abandon_reaps_threads(tmp_path):
    paths = _write_files(tmp_path, n_files=4, per=50)
    before = threading.active_count()
    it = open_files(paths, thread_num=4, buffer_size=2)()
    for _, s in zip(range(3), it):
        pass
    it.close()
    deadline = 50
    while threading.active_count() > before and deadline:
        time.sleep(0.1)
        deadline -= 1
    assert threading.active_count() <= before, "scan threads leaked"


def test_open_files_half_shard_spec_raises(tmp_path):
    paths = _write_files(tmp_path, n_files=2)
    with pytest.raises(ValueError, match="got shard_id without "
                                         "num_shards"):
        open_files(paths, shard_id=0)
    with pytest.raises(ValueError, match="got num_shards without "
                                         "shard_id"):
        open_files(paths, num_shards=2)
    with pytest.raises(ValueError, match="out of range"):
        open_files(paths, shard_id=2, num_shards=2)


def test_open_files_feeds_training(tmp_path):
    paths = _write_files(tmp_path)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [3])
        y = fluid.layers.data("y", [1], dtype="int64")
        pred = fluid.layers.fc(x, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    reader = fluid.reader.batch(
        fluid.reader.map_readers(
            lambda s: (s[1], np.int64(int(s[0]) % 4)),
            open_files(paths, thread_num=2)), batch_size=5)
    feeder = fluid.DataFeeder([x, y], fluid.CPUPlace(), program=main)
    seen = 0
    for batch in reader():
        feed = feeder.feed(batch)
        assert feed["y"].shape == (len(batch), 1)
        lv, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert np.isfinite(lv).all()
        seen += len(batch)
    assert seen == 20


_WORKER = r"""
import os, sys
sys.path.insert(0, %(repo)r)
import torch.distributed as dist
from paddle_tpu_torch.reader import open_files

rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://localhost:%(port)d",
                        world_size=2, rank=rank)
paths = sorted(os.path.join(%(data)r, f)
               for f in os.listdir(%(data)r) if f.endswith(".recordio"))
# no shard args: the default shard is this process's rank of the group
ids = sorted(int(s[0]) for s in open_files(paths, thread_num=2)())
print("RESULT rank=%%d ids=%%s" %% (rank, ",".join(map(str, ids))),
      flush=True)
dist.destroy_process_group()
"""


def test_open_files_default_shard_from_process_group(tmp_path):
    """Two processes in one torch.distributed gloo group: with no shard
    args each reads the shard of its rank, disjoint and jointly
    complete."""
    import socket
    _write_files(tmp_path)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER % {"repo": REPO, "data": str(tmp_path),
                                 "port": port})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    shards = {}
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
        kv = dict(tok.split("=") for tok in line.split()[1:])
        shards[int(kv["rank"])] = [int(t) for t in kv["ids"].split(",")]
    assert not (set(shards[0]) & set(shards[1]))
    assert sorted(shards[0] + shards[1]) == sorted(
        f * 100 + i for f in range(4) for i in range(5))
    assert shards[0] == _ids(open_files(
        [str(tmp_path / ("part-%02d.recordio" % f)) for f in range(4)],
        shard_id=0, num_shards=2))
