"""Time the port's gloo collectives against PyTorch's tensor forms.

    python3 -m paddle_tpu_torch.tools.collective_forms [--device cuda|cpu]
        [--worlds 2,4] [--kib 16384,65536] [--reps 10]

For each world size it starts that many rank processes on one card (or
on the CPU) over a gloo group, a card's buffers staged through pinned
host memory as ``parallel/collective.py`` stages them, and times, on
the same buffers of each size:

  all_gather      the port's ``_raw_all_gather`` (gloo's list form and
                  a concatenation) against ``all_gather_into_tensor``
  psum_scatter    the port's ``_raw_psum_scatter`` (an all-reduce and
                  this rank's chunk) against ``reduce_scatter_tensor``

with the same staging around both. A call's time is the slowest rank's,
from a barrier to the result back on the device; the line printed for
each (world, size, collective) holds the median over ``--reps`` calls
of both forms, alternated call by call. The last line is all of them as
one JSON object.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _staged(C, x, group, call):
    """``call(host buffer)`` with the port's staging around it."""
    stage = C._stages(group, [x])
    out = call(C._host(x) if stage else x)
    return C._back(out, x) if stage else out


def _tensor_all_gather(dist, C, x, group):
    def call(h):
        n = dist.get_world_size(group)
        out = h.new_empty((n * h.shape[0],) + h.shape[1:])
        dist.all_gather_into_tensor(out, h, group=group)
        return out
    return _staged(C, x, group, call)


def _tensor_psum_scatter(dist, C, x, group):
    def call(h):
        n = dist.get_world_size(group)
        out = h.new_empty((h.shape[0] // n,) + h.shape[1:])
        dist.reduce_scatter_tensor(out, h, group=group)
        return out
    return _staged(C, x, group, call)


def _rank(args):
    """One rank: times every form, writes its times as JSON."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.parallel import collective as C
    torch.set_num_threads(1)
    launch.init_parallel_env("file://" + args.store, args.world, args.rank,
                             device=args.device, backend="gloo",
                             timeout=120)
    dev = launch.device()
    group = dist.group.WORLD
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    forms = {
        "all_gather": (
            lambda x: C._raw_all_gather(x, group, 0),
            lambda x: _tensor_all_gather(dist, C, x, group)),
        "psum_scatter": (
            lambda x: C._raw_psum_scatter(x, group, 0),
            lambda x: _tensor_psum_scatter(dist, C, x, group)),
    }
    out = {}
    try:
        for kib in args.kib:
            floats = kib * 1024 // 4
            floats -= floats % args.world
            x = torch.ones(floats, device=dev) * (args.rank + 1)
            for name, (port, tensor) in forms.items():
                # the forms agree before they are timed
                if not torch.equal(port(x), tensor(x)):
                    raise SystemExit("%s: the two forms differ" % name)
                times = {"port": [], "tensor": []}
                for _ in range(args.reps):
                    for form, fn in (("port", port), ("tensor", tensor)):
                        sync()
                        dist.barrier()
                        t0 = time.perf_counter()
                        fn(x)
                        sync()
                        times[form].append(1e3 * (time.perf_counter() - t0))
                out["%s/%d" % (name, kib)] = times
    finally:
        launch.shutdown()
    with open(os.path.join(args.out, "rank%d.json" % args.rank), "w") as f:
        json.dump(out, f)
    return 0


def _world(args, world, tmp):
    """Start ``world`` ranks, wait for them (bounded), and return each
    (collective, KiB): the median of the slowest rank's ms, both forms."""
    store = os.path.join(tmp, "store%d" % world)
    out = os.path.join(tmp, "out%d" % world)
    os.makedirs(out)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=_ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.collective_forms",
         "--device", args.device, "--kib", ",".join(map(str, args.kib)),
         "--reps", str(args.reps), "--_rank", str(r), "--_world",
         str(world), "--_store", store, "--_out", out], env=env, cwd=_ROOT)
        for r in range(world)]
    deadline = time.monotonic() + args.timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise SystemExit("collective_forms: ranks exited %s" % bad)
    ranks = []
    for r in range(world):
        with open(os.path.join(out, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    res = {}
    for key in ranks[0]:
        res[key] = {form: float(np.median(np.max(
            [rk[key][form] for rk in ranks], axis=0)))
            for form in ("port", "tensor")}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--worlds", default="2,4")
    ap.add_argument("--kib", default="16384,65536")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--timeout", type=float, default=300.0)
    for hidden in ("--_rank", "--_world"):
        ap.add_argument(hidden, type=int, default=None,
                        help=argparse.SUPPRESS)
    for hidden in ("--_store", "--_out"):
        ap.add_argument(hidden, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.kib = [int(k) for k in args.kib.split(",")]
    if args._rank is not None:
        args.rank, args.world = args._rank, args._world
        args.store, args.out = args._store, args._out
        return _rank(args)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("collective_forms: no CUDA device (--device cpu runs on "
                  "the CPU)", file=sys.stderr)
            return 2
    result = {}
    work = os.path.join(_ROOT, "build", "paddle_tpu_torch")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        for world in (int(w) for w in args.worlds.split(",")):
            for key, ms in _world(args, world, tmp).items():
                name, kib = key.split("/")
                print("world %d %s %s KiB: port %.3f ms, tensor form %.3f "
                      "ms (%.2fx)" % (world, name, kib, ms["port"],
                                      ms["tensor"],
                                      ms["tensor"] / ms["port"]),
                      flush=True)
                result["%d/%s" % (world, key)] = ms
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
