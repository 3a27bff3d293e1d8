"""Split a ParallelExecutor step's time between the host and the card.

    python3 -m paddle_tpu_torch.tools.parallel_step_split
        [--device cuda|cpu] [--combos dp_sp,dp_pp,dp_ep]
        [--trees DIR[,DIR...]] [--order ABBA] [--steps 3] [--small]
        [--out FILE]

For each tree (a directory holding a ``paddle_tpu_torch`` package; by
default the one this file belongs to) it starts 4 rank processes on one
card (or on the CPU) over gloo, each importing that tree's package, and
each runs the LM of ``transformer_lm_parallel`` at the flagship widths
(vocab 4096, 256 positions, 4 layers, 8 heads, d_model 512, d_inner
2048, batch 32, SGD; ``--small`` for a CPU check: 64, 16, 2, 4, 32, 64,
8) through ``ParallelExecutor`` over each combo of ``--combos``: one
first step with the timers below on (the program's first: its plan,
DTensor's cold sharding caches, gloo's first connections), ``--steps``
timed steps (wall, the card synchronized), one step with the timers on,
and, on a card, one traced step (``torch.profiler``, CUDA activity
only, after a warm-up cycle of its own). For each combo and rank:

  first_ms    the first step, its buckets ``first_buckets``
  step_ms     the median of the timed steps
  timed_ms    the step with the timers on
  buckets     the inclusive wall ms, on every thread (a card's backward
              runs on autograd's device thread), of: ``dispatch``
              (the Python side of DTensor's ``OpDispatcher``: all of
              ``dispatch`` where it is Python, the tail and slow paths
              of a C++ fast path where not), ``propagate`` (its
              sharding propagation), ``redistribute`` (its
              redistributions), ``collectives`` (the port's
              ``collective._raw_*`` and the pipeline's ``_exchange``:
              staging through host memory and gloo), ``held`` (the held
              blocks' gathers and slices, ``blocks.whole`` and
              ``block_of``), ``backward`` (``torch.autograd.backward``
              and ``grad``); a nested call of the same bucket counts
              once, and buckets nest in each other
  device_ms   the traced step's busy time on the card: the union of its
              kernel intervals, and of its copies (``kernel_ms``,
              ``copy_ms``, ``busy_ms``), beside its wall (``trace_wall_ms``)

Trees run in the order ``--order`` gives (``ABBA``: the first tree, the
second, the second, the first), each run one spawn of 4 ranks running
every combo. A line a (run, combo) is printed: the slowest rank's
first and steady steps, and the buckets and the card's busy time summed
over the ranks (they share the card); the last line is everything as
one JSON object (``--out`` writes it to a file too).
"""

import argparse
import collections
import glob
import inspect
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

COMBOS = {"dp_tp": {"dp": 2, "tp": 2}, "dp_sp": {"dp": 2, "sp": 2},
          "dp_pp": {"dp": 2, "pp": 2}, "dp_ep": {"dp": 2, "ep": 2}}
EXPERTS = {"dp_ep": 4}
SEEDS = {"dp_tp": 0, "dp_sp": 1, "dp_pp": 3, "dp_ep": 4}
WIDTHS = {"vocab": 4096, "max_len": 256, "n_layer": 4, "n_head": 8,
          "d_model": 512, "d_inner": 2048, "batch": 32}
SMALL = {"vocab": 64, "max_len": 16, "n_layer": 2, "n_head": 4,
         "d_model": 32, "d_inner": 64, "batch": 8}


class _Timers:
    """Inclusive wall time a bucket, over the functions wrapped into it,
    while ``on``; a call nested in one of its own bucket counts once."""

    def __init__(self):
        self.on = False
        self.ms = collections.Counter()
        self.calls = collections.Counter()
        self._inside = threading.local()

    def wrap(self, owner, attr, bucket):
        raw = inspect.getattr_static(owner, attr, None)
        if raw is None:
            return
        static = isinstance(raw, staticmethod)
        fn = raw.__func__ if static else raw
        timers = self

        def timed(*a, **k):
            if not timers.on or getattr(timers._inside, bucket, False):
                return fn(*a, **k)
            setattr(timers._inside, bucket, True)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                timers.ms[bucket] += 1e3 * (time.perf_counter() - t0)
                timers.calls[bucket] += 1
                setattr(timers._inside, bucket, False)
        setattr(owner, attr, staticmethod(timed) if static else timed)

    def install(self):
        import importlib
        import torch

        def mod(name):
            try:
                return importlib.import_module(name)
            except ImportError:
                return None
        disp = mod("torch.distributed.tensor._dispatch")
        prop = mod("torch.distributed.tensor._sharding_prop")
        redis = mod("torch.distributed.tensor._redistribute")
        # the Python side of DTensor's dispatch in the releases that have
        # one (later ones enter it from a C++ fast path, at its tail or
        # its slow paths)
        for name in ("dispatch", "_dispatch_fast_path_python_tail",
                     "_dispatch_get_local_results_slow_path"):
            if disp is not None:
                self.wrap(disp.OpDispatcher, name, "dispatch")
        if disp is not None:
            self.wrap(disp.OpDispatcher,
                      "_propagate_op_sharding_dispatch_slow_path",
                      "propagate")
        for name in ("propagate", "propagate_op_sharding_non_cached"):
            if prop is not None:
                self.wrap(prop.ShardingPropagator, name, "propagate")
        for m in (redis, disp):
            if m is not None and hasattr(m, "redistribute_local_tensor"):
                self.wrap(m, "redistribute_local_tensor", "redistribute")
        coll = mod("paddle_tpu_torch.parallel.collective")
        for name in ("_raw_all_reduce", "_raw_all_gather",
                     "_raw_psum_scatter", "_raw_all_to_all",
                     "_raw_ppermute"):
            self.wrap(coll, name, "collectives")
        pipe = mod("paddle_tpu_torch.parallel.pipeline")
        if pipe is not None:
            self.wrap(pipe, "_exchange", "collectives")
        blocks = mod("paddle_tpu_torch.parallel.blocks")
        if blocks is not None:
            self.wrap(blocks, "whole", "held")
            self.wrap(blocks, "block_of", "held")
        self.wrap(torch.autograd, "backward", "backward")
        self.wrap(torch.autograd, "grad", "backward")


def _device_ms(path):
    """(kernel ms, copy ms, busy ms): the unions of a chrome trace's
    kernel intervals, of its copy and set intervals, and of both."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])

    def union(cats):
        spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                       if e.get("ph") == "X" and e.get("cat") in cats)
        total, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e3
    return (union({"kernel"}), union({"gpu_memcpy", "gpu_memset"}),
            union({"kernel", "gpu_memcpy", "gpu_memset"}))


def _rank(args):
    """One rank: every combo of ``args.combos``, its results as JSON."""
    import numpy as np
    import torch
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.models import transformer as T
    launch.init_parallel_env("file://" + args.store, args.world, args.rank,
                             device=args.device, backend="gloo",
                             timeout=300)
    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    place = fluid.CUDAPlace(0) if cuda else fluid.CPUPlace()
    w = SMALL if args.small else WIDTHS
    timers = _Timers()
    timers.install()
    out = {}
    try:
        for combo in args.combos:
            axes = COMBOS[combo]
            st = parallel.DistributedStrategy(**{
                a: axes.get(a, 1) for a in ("dp", "tp", "sp", "pp", "ep")})
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup), \
                    fluid.unique_name.guard():
                avg_cost, _ = T.transformer_lm_parallel(
                    vocab_size=w["vocab"], max_len=w["max_len"],
                    n_layer=w["n_layer"], n_head=w["n_head"],
                    d_model=w["d_model"], d_inner=w["d_inner"],
                    strategy=st, num_experts=EXPERTS.get(combo, 0))
                fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
            scope = fluid.Scope()
            fluid.Executor(place).run(startup, scope=scope)
            pexe = fluid.ParallelExecutor(
                loss_name=avg_cost.name, main_program=main,
                mesh=parallel.make_mesh(axes, devices=args.device),
                scope=scope, strategy=st)
            n = 1 + args.steps + 1 + (2 if cuda else 0)
            batches = [T.make_lm_batch(
                np.random.RandomState(SEEDS[combo] + 100 * i), w["batch"],
                w["max_len"], w["vocab"]) for i in range(n)]
            feeds = iter(batches)

            def step():
                sync()
                t0 = time.perf_counter()
                loss = float(np.asarray(pexe.run([avg_cost],
                                                 feed=next(feeds))[0]))
                sync()
                return 1e3 * (time.perf_counter() - t0), loss

            def timed_step():
                timers.ms.clear()
                timers.calls.clear()
                timers.on = True
                ms, _ = step()
                timers.on = False
                return ms, dict(timers.ms), dict(timers.calls)
            first, first_buckets, _ = timed_step()
            times, losses = zip(*[step() for _ in range(args.steps)])
            timed, buckets, calls = timed_step()
            res = {"first_ms": first, "first_buckets": first_buckets,
                   "step_ms": float(np.median(times)), "steps_ms": times,
                   "losses": losses, "timed_ms": timed,
                   "buckets": buckets, "calls": calls}
            if cuda:
                from torch.profiler import (ProfilerActivity, profile,
                                            schedule)
                path = os.path.join(args.out, "%s_r%d.json"
                                    % (combo, args.rank))
                walls = []
                with profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1),
                             on_trace_ready=lambda p: p.export_chrome_trace(
                                 path)) as prof:
                    for _ in range(2):
                        walls.append(step()[0])
                        prof.step()
                if os.path.exists(path):
                    kernel, copy, busy = _device_ms(path)
                    os.remove(path)
                    res.update(trace_wall_ms=walls[-1], kernel_ms=kernel,
                               copy_ms=copy, busy_ms=busy)
            out[combo] = res
    finally:
        launch.shutdown()
    with open(os.path.join(args.out, "rank%d.json" % args.rank), "w") as f:
        json.dump(out, f)
    return 0


def _build(tree, env):
    """Build every kernel source of ``tree``'s package once, before its
    ranks start (each rank would build them otherwise)."""
    names = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(tree, "paddle_tpu_torch", "ops", "csrc", "*.cu")))
    subprocess.run([sys.executable, "-c",
                    "import sys; from paddle_tpu_torch.ops import _build; "
                    "_build.load_all(sys.argv[1:])"] + names,
                   env=env, cwd=tree, check=True)


def _run(args, tree, tmp, tag):
    """One spawn of ``tree``'s 4 ranks: each rank's results."""
    store = os.path.join(tmp, "store_" + tag)
    out = os.path.join(tmp, "out_" + tag)
    os.makedirs(out)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=tree + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    if args.device == "cuda":
        _build(tree, env)
    cmd = [sys.executable, os.path.abspath(__file__), "--device",
           args.device, "--combos", ",".join(args.combos), "--steps",
           str(args.steps), "--_world", "4", "--_store", store, "--_out",
           out] + (["--small"] if args.small else [])
    procs = [subprocess.Popen(cmd + ["--_rank", str(r)], env=env, cwd=tree)
             for r in range(4)]
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
        raise SystemExit("parallel_step_split: %s ranks exited %s"
                         % (tree, bad))
    ranks = []
    for r in range(4):
        with open(os.path.join(out, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    return ranks


def _summed(ranks, key):
    """The ranks' buckets of ``key`` summed, as text."""
    total = collections.Counter()
    for r in ranks:
        total.update(r[key])
    return ", ".join("%s %.1f" % kv for kv in sorted(total.items()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--combos", default="dp_sp,dp_pp,dp_ep")
    ap.add_argument("--trees", default=_ROOT)
    ap.add_argument("--order", default="A")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--_rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--_world", type=int, default=None,
                    help=argparse.SUPPRESS)
    for hidden in ("--_store", "--_out"):
        ap.add_argument(hidden, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.combos = args.combos.split(",")
    if args._rank is not None:
        args.rank, args.world = args._rank, args._world
        args.store, args.out = args._store, args._out
        return _rank(args)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("parallel_step_split: no CUDA device (--device cpu runs "
                  "on the CPU)", file=sys.stderr)
            return 2
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    result = []
    work = os.path.join(_ROOT, "build", "paddle_tpu_torch")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        for i, letter in enumerate(args.order):
            tree = trees[ord(letter) - ord("A")]
            ranks = _run(args, tree, tmp, "%d%s" % (i, letter))
            result.append({"tree": tree, "run": i, "ranks": ranks})
            for combo in args.combos:
                rs = [rk[combo] for rk in ranks]
                busy = sum(r.get("busy_ms", 0.0) for r in rs)
                print("run %d %s %s: first step %.1f ms (slowest rank), "
                      "ranks' ms %s; step %.1f ms (slowest rank's median), "
                      "timed %.1f, ranks' ms %s; card busy %s"
                      % (i, letter, combo, max(r["first_ms"] for r in rs),
                         _summed(rs, "first_buckets"),
                         max(r["step_ms"] for r in rs),
                         max(r["timed_ms"] for r in rs),
                         _summed(rs, "buckets"),
                         "%.1f ms of 4 x %.1f" % (busy, max(
                             r["trace_wall_ms"] for r in rs))
                         if "busy_ms" in rs[0] else "not measured"),
                      flush=True)
    text = json.dumps({"order": args.order, "trees": trees,
                       "runs": result})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
