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
"""

import torch

__all__ = ["StepGraph", "launch_counts"]


def _kernel_modules():
    from ..ops import flash_attention, matmul_stats, paged_attention
    return flash_attention, matmul_stats, paged_attention


def launch_counts():
    """{kernel: launches so far} over the port's kernel wrappers:
    ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``, ``matmul_stats``
    and ``paged_attention``."""
    fa, ms, pa = _kernel_modules()
    out = {"flash_" + k: n for k, n in fa.flash_attention.launches.items()}
    out["matmul_stats"] = ms.matmul_colstats.launches
    out["paged_attention"] = pa.paged_attention.launches
    return out


def _add_launches(delta):
    fa, ms, pa = _kernel_modules()
    for name, n in delta.items():
        if name.startswith("flash_"):
            fa.flash_attention.launches[name[len("flash_"):]] += n
        elif name == "matmul_stats":
            ms.matmul_colstats.launches += n
        else:
            pa.paged_attention.launches += n


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
        """Run ``warmup()`` eagerly on a fresh side stream, then capture
        ``body()`` on the same stream. The paged-attention scratch the
        warm-up made is dropped, so the capture allocates its own in the
        graph's pool (its arrival counters zero-filled at every replay's
        start); the graph keeps it, and its stream, alive."""
        _, _, pa = _kernel_modules()
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            warmup()
        torch.cuda.synchronize(dev)
        pa.take_workspace(dev, stream.cuda_stream)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin()
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
