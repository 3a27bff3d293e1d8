"""Device-prefetching data loader.

The counterpart of ``paddle_tpu/reader/device_loader.py``. Reference
parity: operators/reader/create_double_buffer_reader_op.cc:34,168 — a
prefetch thread keeping device-side batches ready so the host-to-device
copies overlap compute.

A worker thread normalizes each feed through a feed-plan cache
(``core/executor.FeedPlanCache``: a repeated signature skips the
derivation, and a frozen (``writeable=False``) numpy feed is committed to
the device once and reused), narrows 64-bit types to 32-bit as the
Executor does, and uploads the dense values ``capacity`` batches ahead.
LoD values pass through on the host, untouched: their bucketed form and
``@MAXLEN`` come from the consuming executor's own normalization.

On the card each upload goes through pinned host memory, copied with
``non_blocking=True`` on a side ``torch.cuda.Stream``:

  * an event recorded on the side stream after a batch's copies is
    waited on by the consumer's current stream before the batch is
    handed over, so no kernel reads a half-copied batch;
  * each handed-over tensor is marked used on the consumer's stream
    (``record_stream``), so the caching allocator does not give its
    memory to a later upload while the consumer's work on it is queued;
  * a batch's pinned staging buffers stay referenced until its event has
    passed, so none is rewritten before its copy has completed;
  * the worker sets the loader's device and works in its own stream
    context, and holds ``core/graphs.capture_lock`` while it enqueues
    work, so no copy of the loader lands inside a ``run_steps`` capture.

``megabatches(k)`` stacks k normalized batches on the worker, straight
into one pinned buffer a name, into the ``[k, ...]`` layout
``Executor.run_steps(feeds=stack, k=k)`` indexes, so the feeds of
megastep N+1 are staged while megastep N runs. ``run_steps`` then copies
the stack into its graph's own ``[k, ...]`` buffers, a device-to-device
copy: the loader cannot write those buffers itself, because the
dispatch before is still reading them while the next stack is staged.

``sharding=mesh`` (or ``(mesh, batch_dim)``) is the mesh-mode loader of
one process a rank: each rank stages only its ``dp`` block of every
batch's batch dim (0 by default) and yields it as a DTensor over the
mesh's ``dp`` x ``tp`` sub-mesh (Shard on ``dp``), the global view
``ParallelExecutor`` takes without a copy; ``megabatches(k)`` shards the
stack's dim ``batch_dim + 1``, as the JAX package's ``_stack_sharding``
remaps its spec. Over a mesh whose ``dp`` axis holds one rank the
batches stay whole plain tensors.

No workload yet shows the worker thread and the side stream buying
overlap: on ``chip_smoke.py`` phase 17's ResNet-cifar10, whose host
side only hands over ready arrays, the loader runs a few per cent behind
``run_steps`` given host lists (PERF.md). It is here for the JAX
package's API, and for feeds whose preparation costs host time.
"""

import collections
import queue
import threading

import numpy as np
import torch

from ..core import graphs as _graphs
from ..core.lod import LoDTensor
from ..core.places import resolve_device
from ..core.scope import torch_dtype

__all__ = ["DeviceLoader", "repeat_feed"]


class DeviceLoader:
    """Wrap an iterable of feed dicts; yields dicts of tensors on
    ``device`` (LoD values as the host LoDTensors they were), staging
    ``capacity`` batches ahead on a worker thread.

    ``device=None`` means ``cuda:0`` and raises without a card, as every
    entry point of the port does; ``device="cpu"`` runs the same path
    without streams or pinned memory. ``plan_cache=None`` builds a
    private feed-plan cache; pass an existing ``FeedPlanCache`` to share
    plans (e.g. the consuming Executor's ``_feed_plans``), or
    ``plan_cache=False`` to normalize every batch in full. ``sharding``:
    a ``parallel.Mesh`` or ``(mesh, batch_dim)``; each rank stages its
    ``dp`` block of every dense value (module docstring)."""

    def __init__(self, feed_iterable, capacity=2, device=None,
                 sharding=None, plan_cache=None):
        mesh, batch_dim = (sharding if isinstance(sharding, tuple)
                           else (sharding, 0))
        self._mesh, self._batch_dim = mesh, int(batch_dim)
        self._src = feed_iterable
        self._capacity = max(1, int(capacity))
        self._device = resolve_device("cuda:0" if device is None
                                      else device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        if plan_cache is None:
            from ..core.executor import FeedPlanCache
            plan_cache = FeedPlanCache(device_fn=lambda: self._device)
        self._plans = plan_cache or None

    def _normalize(self, feed, commit=True):
        """Plan-cached normalization of the dense values; LoD values pass
        through untouched, and a batch mixing both normalizes its dense
        subset alone."""
        if self._plans is None:
            return feed
        from ..core.executor import _normalize_feeds
        lod = {k: v for k, v in feed.items() if isinstance(v, LoDTensor)}
        dense = {k: v for k, v in feed.items() if k not in lod}
        if not dense:
            return feed
        arrays, _ = _normalize_feeds(dense, plan_cache=self._plans,
                                     commit=commit)
        out = dict(arrays)
        out.update(lod)
        return out

    def _upload(self, value, pinned):
        """One dense value, or a ``_Group`` of k to stack, as a tensor on
        the loader's device, narrowed: written once into a host buffer
        (pinned on the card, kept in ``pinned``) and, on the card, copied
        non-blocking on the current (side) stream. On the CPU the host
        buffer is the result: a copy, so it does not alias the caller's
        arrays."""
        if isinstance(value, torch.Tensor):
            return value.to(self._device, torch_dtype(value.dtype))
        stacked = isinstance(value, _Group)
        first = np.asarray(value[0] if stacked else value)
        shape = ((len(value),) if stacked else ()) + first.shape
        dtype = torch_dtype(first.dtype)
        cuda = self._device.type == "cuda"
        host = torch.empty(shape, dtype=dtype, pin_memory=cuda)
        view = host.numpy()
        if not stacked:
            view[...] = first
        for i, part in enumerate(value if stacked else ()):
            part = np.asarray(part)
            if part.shape != first.shape:
                raise ValueError(
                    "megabatch group mixes shapes: batch %d is %s, batch "
                    "0 is %s" % (i, part.shape, first.shape))
            view[i] = part
        if not cuda:
            return host
        pinned.append(host)
        out = torch.empty(shape, dtype=dtype, device=self._device)
        out.copy_(host, non_blocking=True)
        return out

    def _stage(self, feed, pinned):
        return {k: v if isinstance(v, LoDTensor) else
                self._sharded(v, pinned) for k, v in feed.items()}

    def _sharded(self, value, pinned):
        """``_upload`` of this rank's ``dp`` block of ``value``, as a
        DTensor over the mesh (no ``sharding``, or one ``dp`` rank: the
        whole value)."""
        mesh = self._mesh
        if mesh is None or mesh.shape.get("dp", 1) <= 1 or \
                mesh.dtensor_mesh is None or isinstance(value, torch.Tensor):
            return self._upload(value, pinned)
        from torch.distributed.tensor import DTensor, Replicate, Shard
        stacked = isinstance(value, _Group)
        dim = self._batch_dim
        n, idx = mesh.shape["dp"], mesh.axis_index("dp")

        def block(a):
            a = np.asarray(a)
            if a.ndim <= dim or a.shape[dim] % n:
                raise ValueError(
                    "DeviceLoader(sharding=): dim %d of a %s feed does "
                    "not split over dp=%d" % (dim, a.shape, n))
            c = a.shape[dim] // n
            return np.take(a, np.arange(idx * c, (idx + 1) * c), axis=dim)

        local = self._upload(_Group(block(a) for a in value) if stacked
                             else block(value), pinned)
        gdim = dim + 1 if stacked else dim
        shape = list(local.shape)
        shape[gdim] *= n
        axes = mesh.dtensor_axes
        pl = [Shard(gdim) if a == "dp" else Replicate() for a in axes]
        return DTensor.from_local(local, mesh.dtensor_mesh, pl,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(
                                      shape, device="meta").stride())

    def _prefetch(self, source, prepare):
        """Yield ``prepare(item)`` for each item of ``source``, staged on
        the device, up to ``capacity`` ahead, by a worker thread."""
        q = queue.Queue(maxsize=self._capacity)
        stop = object()
        err = []
        cuda = self._device.type == "cuda"
        abandoned = threading.Event()

        def put(item):
            # gives up when the consumer has left, so the worker never
            # blocks on a full queue nobody reads
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                stream = None
                if cuda:
                    with _graphs.capture_lock:
                        torch.cuda.set_device(self._device)
                        stream = torch.cuda.Stream(self._device)
                # (event, pinned buffers) of the batches still copying
                inflight = collections.deque()
                for item in source:
                    if abandoned.is_set():
                        return
                    if not cuda:
                        put((self._stage(prepare(item), []), None))
                        continue
                    with _graphs.capture_lock, torch.cuda.stream(stream):
                        pinned = []
                        staged = self._stage(prepare(item), pinned)
                        event = torch.cuda.Event()
                        event.record(stream)
                        inflight.append((event, pinned))
                        while len(inflight) > self._capacity + 1:
                            inflight.popleft()[0].synchronize()
                        while inflight and inflight[0][0].query():
                            inflight.popleft()
                    put((staged, event))
                with _graphs.capture_lock:
                    for event, _ in inflight:
                        event.synchronize()
            except BaseException as e:      # propagate to the consumer
                err.append(e)
            finally:
                put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                staged, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self._device)
                    consumer.wait_event(event)
                    for v in staged.values():
                        if isinstance(v, torch.Tensor) and v.is_cuda:
                            v.record_stream(consumer)
                yield staged
        finally:
            abandoned.set()
            t.join(timeout=5.0)
        if err:
            raise err[0]

    def __iter__(self):
        return self._prefetch(self._src, self._normalize)

    def megabatches(self, k):
        """Iterate ``[k, ...]`` megastep staging stacks: k consecutive
        source batches are normalized, stacked on the worker thread and
        uploaded as one dict, the pre-stacked layout
        ``Executor.run_steps(feeds=stack, k=k)`` indexes, so staging
        megastep N+1 overlaps megastep N on the device. A trailing group
        shorter than k is yielded at its true length (read k from the
        leading dim).

        LoD feeds cannot ride this path: their per-step normalization
        gives static_info (@MAXLEN, bucketing) only the executor's host
        path derives, so a LoD batch raises here; give ``run_steps`` a
        LIST of per-step feed dicts instead."""
        k = int(k)
        if k < 1:
            raise ValueError("megabatches needs k >= 1, got %d" % k)

        def stacked():
            group = []
            for feed in self._src:
                bad = sorted(n for n, v in feed.items()
                             if isinstance(v, LoDTensor))
                if bad:
                    raise ValueError(
                        "LoD feed(s) %s cannot ride the [k, ...] "
                        "megastep staging stack (their normalization "
                        "needs the executor's trace-time static_info); "
                        "pass run_steps a LIST of per-step feed dicts "
                        "instead" % bad)
                group.append(self._normalize(feed, commit=False))
                if len(group) == k:
                    yield self._stack(group)
                    group = []
            if group:
                yield self._stack(group)

        return self._prefetch(stacked(), lambda stack: stack)

    @staticmethod
    def _stack(group):
        """k normalized batches as ``{name: _Group}``: ``_upload`` stacks
        each group straight into its host buffer."""
        names = sorted(group[0])
        for i, g in enumerate(group[1:], 1):
            if sorted(g) != names:
                raise ValueError(
                    "megabatch group mixes feed names: batch %d has %s,"
                    " batch 0 has %s" % (i, sorted(g), names))
        return {n: _Group(g[n] for g in group) for n in names}


class _Group(list):
    """The k values of one feed name in a megabatch, to be stacked on a
    new leading axis."""


def repeat_feed(feed, n):
    """Iterator yielding the same feed dict n times (benchmark helper)."""
    for _ in range(n):
        yield feed
