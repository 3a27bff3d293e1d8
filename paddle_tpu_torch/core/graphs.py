"""CUDA graphs of step bodies: the megastep path on the card.

The JAX package compiles K steps into one program (``lax.scan``) and
dispatches it once. The port's counterpart is a ``torch.cuda.CUDAGraph``
that holds K step bodies, captured once and replayed: one launch from the
host runs every kernel of the K steps. ``Executor.run_steps`` and
``Engine(megastep=K)`` capture on the card; on the CPU they run the same
bodies in a loop.

A capture follows PyTorch's whole-network recipe: a warm-up runs eagerly
on a fresh side stream (kernels built and loaded, each kernel's
per-size attributes set, cuBLAS and autograd initialised), then the body
is captured on that stream. What a graph cannot hold raises, naming the
op or the call: a host read of a device value, a copy from pageable host
memory, an allocation outside the graph's pool. A replay that fails
raises too. There is no eager fallback.

The kernel wrappers count a launch when they are called, which under
capture records a launch instead of running one. ``StepGraph`` takes the
launches a capture recorded back out of the counts and adds them at every
replay, so the counts stay the number of launches that ran on the card.

A capture holds ``capture_lock`` from its start to its end, and runs in
the thread-local capture mode: a call that cannot be captured raises in
the capturing thread only. Work that enqueues on the card from another
thread holds the lock too (``reader.DeviceLoader``'s staging thread, and
each ``serving.Engine``'s iteration, so the cells of a fleet share one
card), so none of its launches, allocations, copies or waits can fall
inside a capture or its launch count. A CUDA graph freed during a
capture invalidates it (its ``reset`` is not permitted there), and the
cyclic garbage collector can free a dead engine's or executor's graph at
any allocation: so a capture collects garbage first, under the lock,
and keeps the collector off until it ends.
"""

import gc
import threading

import torch

__all__ = ["StepGraph", "launch_counts", "capture_lock"]

# held by every capture, and by other threads' device work meanwhile
capture_lock = threading.RLock()

# one side stream a device for every capture's warm-up and capture: a
# stream of its own per graph would leave cuBLAS a workspace per stream
# (kept for the process), and the captures are serialized by the lock
_STREAMS = {}


def _capture_stream(dev):
    with capture_lock:
        s = _STREAMS.get(dev)
        if s is None:
            s = _STREAMS[dev] = torch.cuda.Stream(dev)
        return s


def _kernel_modules():
    from ..ops import (dropout, flash_attention, lstm_cell, matmul_stats,
                       paged_attention)
    return flash_attention, matmul_stats, paged_attention, dropout, lstm_cell


def launch_counts():
    """{kernel: launches so far} over the port's kernel wrappers:
    ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``, ``matmul_stats``,
    ``paged_attention``, ``dropout`` and ``lstm_cell``."""
    fa, ms, pa, do, lc = _kernel_modules()
    out = {"flash_" + k: n for k, n in fa.flash_attention.launches.items()}
    out["matmul_stats"] = ms.matmul_colstats.launches
    out["paged_attention"] = pa.paged_attention.launches
    out["dropout"] = do.dropout.launches
    out["lstm_cell"] = lc.lstm_scan.launches
    return out


def _add_launches(delta):
    fa, ms, pa, do, lc = _kernel_modules()
    for name, n in delta.items():
        if name.startswith("flash_"):
            fa.flash_attention.launches[name[len("flash_"):]] += n
        elif name == "matmul_stats":
            ms.matmul_colstats.launches += n
        elif name == "dropout":
            do.dropout.launches += n
        elif name == "lstm_cell":
            lc.lstm_scan.launches += n
        else:
            pa.paged_attention.launches += n


class _collector_off:
    """Garbage collected now, and the cyclic collector off until the
    block ends (restored as it was): no CUDA graph is freed inside a
    capture. Entered under ``capture_lock``, so captures do not
    interleave their switching."""

    def __enter__(self):
        gc.collect()
        self._was = gc.isenabled()
        gc.disable()

    def __exit__(self, *exc):
        if self._was:
            gc.enable()


class StepGraph:
    """One CUDA graph of step bodies on ``device``. ``what`` names the
    call in errors; ``launches`` holds the kernel launches one replay
    runs and ``replays`` counts replays."""

    def __init__(self, device, what):
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.what = what
        self.launches = {}
        self.replays = 0
        self._graph = None
        self._keep = ()

    def capture(self, warmup, body):
        """Run ``warmup()`` eagerly on the device's capture side stream,
        then capture ``body()`` on the same stream. The paged-attention scratch the
        warm-up made is dropped, so the capture allocates its own in the
        graph's pool (its arrival counters zero-filled at every replay's
        start); the graph keeps it, and its stream, alive."""
        pa = _kernel_modules()[2]
        dev = self.device
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            warmup()
        torch.cuda.synchronize(dev)
        pa.take_workspace(dev, stream.cuda_stream)
        graph = torch.cuda.CUDAGraph()
        with capture_lock, torch.cuda.stream(stream), _collector_off():
            before = launch_counts()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                body()
                graph.capture_end()
            except BaseException as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass            # the capture was already invalidated
                _add_launches({k: before[k] - n
                               for k, n in launch_counts().items()})
                raise RuntimeError(
                    "CUDA graph capture of %s failed (no eager fallback): "
                    "%s: %s" % (self.what, type(e).__name__, e)) from e
            after = launch_counts()
            self.launches = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
            _add_launches({k: -n for k, n in self.launches.items()})
        self._graph = graph
        self._keep = (stream, pa.take_workspace(dev, stream.cuda_stream))

    def replay(self):
        """Launch the graph on the current stream."""
        try:
            self._graph.replay()
        except RuntimeError as e:
            raise RuntimeError("CUDA graph replay of %s failed: %s"
                               % (self.what, e)) from e
        _add_launches(self.launches)
        self.replays += 1
