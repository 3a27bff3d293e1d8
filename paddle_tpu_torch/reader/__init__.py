"""Reader-decorator combinators + minibatching.

The counterpart of ``paddle_tpu/reader/__init__.py`` (a copy; only
``open_files``'s default shard differs: it reads the ``torch.distributed``
process group where the JAX package reads jax's process layout).
Reference parity: python/paddle/reader/decorator.py:29-236 (map_readers,
shuffle, chain, compose, buffered, firstn, xmap_readers) and
python/paddle/v2/minibatch.py (batch). A reader is a zero-arg callable
returning an iterator of samples.
"""

import itertools
import queue
import random as _random
import threading

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "batch", "cache", "open_files",
           "ComposeNotAligned"]


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf
    return data_reader


def chain(*readers):
    def reader():
        return itertools.chain(*[r() for r in readers])
    return reader


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum((make_tuple(x) for x in outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(x) for x in outputs), ())
    return reader


def buffered(reader, size):
    """Prefetch up to `size` samples on a background thread (the host half of
    the reference's double_buffer reader op)."""
    class _End:
        pass

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)

        def feed():
            try:
                for d in r:
                    q.put(d)
                q.put(_End)
            except BaseException as exc:   # propagate to the consumer
                q.put(exc)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            if isinstance(e, BaseException):
                raise e
            yield e
    return data_reader


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item
    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over samples with worker threads (decorator.py:236)."""
    end = object()

    def data_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def read_worker():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample) if order else sample)
            for _ in range(process_num):
                in_q.put(end)

        def map_worker():
            while True:
                sample = in_q.get()
                if sample is end:
                    out_q.put(end)
                    return
                if order:
                    i, s = sample
                    out_q.put((i, mapper(s)))
                else:
                    out_q.put(mapper(sample))

        threading.Thread(target=read_worker, daemon=True).start()
        workers = [threading.Thread(target=map_worker, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        if order:
            pending = {}
            want = 0
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                i, s = item
                pending[i] = s
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                yield item
    return data_reader


def cache(reader):
    all_data = []
    filled = []

    def data_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)
    return data_reader


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


def _process_layout():
    """(rank, world size) of the initialized torch.distributed process
    group; (0, 1) when there is none."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def open_files(filenames, thread_num=1, buffer_size=64, shard_id=None,
               num_shards=None, shuffle_files=False, seed=0,
               pass_num=1):
    """Multi-file recordio ingestion (reference layers/io.py:360
    open_files / operators/reader/open_files_op.cc parity, reshaped for
    the TPU data plane: a reader-creator instead of a graph reader op —
    feed it through paddle.batch / DataFeeder / DeviceLoader).

    * ``filenames``: list of recordio files (each written by
      recordio.convert_reader_to_recordio_file).
    * ``thread_num`` reader threads scan DISJOINT file subsets
      concurrently, decoding into one bounded queue (the reference's
      multi-threaded buffered reader). Samples interleave across files;
      order is nondeterministic when thread_num > 1, exactly like the
      reference's open_files without order preservation.
    * ``shard_id``/``num_shards``: keep only files [shard_id::num_shards]
      — the MULTI-HOST input story (each host reads its shard; defaults
      to torch.distributed's get_rank()/get_world_size() when either is
      None and a process group of more than one process is
      initialized; no sharding otherwise).
    * ``shuffle_files``: shuffle the file order each pass (seeded).
    * ``pass_num``: repeat the whole file set that many times.
    """
    from ..recordio import reader as _file_reader
    filenames = list(filenames)
    if not filenames:
        raise ValueError("open_files: empty file list")
    if shard_id is None or num_shards is None:
        rank, world = _process_layout()
        if world > 1:
            shard_id = rank if shard_id is None else shard_id
            num_shards = world if num_shards is None else num_shards
    if (shard_id is None) != (num_shards is None):
        # half a sharding spec on a single-process host would silently
        # read ALL files — in a multi-host launch that DUPLICATES the
        # data instead of sharding it
        raise ValueError(
            "open_files: got %s without %s — pass both shard_id and "
            "num_shards (or neither, to default from the torch.distributed "
            "process group)" % (("shard_id", "num_shards") if num_shards is None
                         else ("num_shards", "shard_id")))
    if shard_id is not None and not 0 <= int(shard_id) < int(num_shards):
        raise ValueError(
            "open_files: shard_id %s out of range for num_shards %s"
            % (shard_id, num_shards))
    if num_shards and num_shards > 1:
        mine = filenames[int(shard_id or 0)::int(num_shards)]
        if not mine:
            raise ValueError(
                "open_files: shard %s of %s gets no files out of %d"
                % (shard_id, num_shards, len(filenames)))
        filenames = mine

    end = object()
    invocation = [0]          # distinct shuffle order per epoch/call

    def data_reader():
        inv = invocation[0]
        invocation[0] += 1
        rng = _random.Random(seed + inv)
        for _ in range(max(1, int(pass_num))):
            files = list(filenames)
            if shuffle_files:
                rng.shuffle(files)
            n_thr = max(1, min(int(thread_num), len(files)))
            out_q = queue.Queue(buffer_size)
            stop = threading.Event()

            def _put(item):
                # bounded put that gives up when the consumer abandoned
                # the pass, so no worker blocks forever on a full queue
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            def scan_worker(my_files):
                try:
                    for f in my_files:
                        it = _file_reader(f)()
                        try:
                            for sample in it:
                                if not _put(sample):
                                    return      # pass abandoned
                        finally:
                            it.close()          # frees the scanner FILE*
                except BaseException as e:      # propagate, don't truncate
                    _put((end, e))
                    return
                _put((end, None))

            threads = [threading.Thread(
                target=scan_worker, args=(files[t::n_thr],), daemon=True)
                for t in range(n_thr)]
            for t in threads:
                t.start()
            try:
                done = 0
                while done < n_thr:
                    sample = out_q.get()
                    if isinstance(sample, tuple) and len(sample) == 2 \
                            and sample[0] is end:
                        if sample[1] is not None:
                            raise sample[1]     # a scan thread failed
                        done += 1
                    else:
                        yield sample
            finally:
                # early abandon (consumer break / error / .close()):
                # release blocked putters and reap the threads
                stop.set()
                try:
                    while True:
                        out_q.get_nowait()
                except queue.Empty:
                    pass
                for t in threads:
                    t.join(timeout=5.0)

    return data_reader


from .device_loader import DeviceLoader, repeat_feed  # noqa: F401,E402
__all__ += ["DeviceLoader", "repeat_feed"]
