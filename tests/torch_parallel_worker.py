"""One rank of the port's parallel tests (spawned by
``tests/torch_rank_harness.py``; imports only ``paddle_tpu_torch``).

    python tests/torch_parallel_worker.py --world N --rank R \\
        --store file://<path> --spec cases.json --out <dir>

Every rank runs every case of ``cases.json`` in order; rank 0 writes
each case's arrays to ``<dir>/<case id>.npz`` (a per-rank case writes
``<case id>.r<R>.npz`` too). Case kinds:

  lm      ``transformer_lm_parallel`` at the dryrun's widths over a mesh,
          N SGD (or Adam) steps, optionally with a global-norm clip,
          through ``ParallelExecutor`` from given initial parameters:
          per-step losses, the final weights (gathered), each
          persistable's shape on this rank, the
          collectives the run made (``collective.calls`` and
          ``sent_bytes`` by kind, and DTensor's own functional
          collectives by kind), and each ``sp_attention``'s Q and output
          as they entered and left (local and global shapes, placements);
          with ``run_steps``, the same steps again as one ``run_steps``
          call from the same state (``steps_`` results); with ``eval``,
          the trained scope's loss on the next batch through a plain
          ``Executor`` (``eval_loss``)
  attn    ring or Ulysses attention on whole tensors made from a seed
          (or, with ``blocks``, on each rank's block of them as DTensors):
          the output and the gradients of sum(out * w), and the
          collectives the call made
  loader  ``DeviceLoader(sharding=mesh)``: each rank's staged batches

An lm case with ``save`` also writes ``io.save_checkpoint`` from the
sharded scope.
"""

import argparse
import collections
import faulthandler
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import parallel  # noqa: E402
from paddle_tpu_torch.distributed import launch  # noqa: E402
from paddle_tpu_torch.models import transformer as T  # noqa: E402
from paddle_tpu_torch.parallel import collective as C  # noqa: E402

# DTensor's own functional collectives, by kind (its ops call them by
# module attribute)
FUNCOL = collections.Counter()


def _count_funcol():
    import torch.distributed._functional_collectives as funcol
    for name in ("all_reduce", "all_gather_tensor", "reduce_scatter_tensor",
                 "all_to_all_single", "all_gather_tensor_autograd",
                 "reduce_scatter_tensor_autograd", "all_reduce_coalesced"):
        fn = getattr(funcol, name, None)
        if fn is None:
            continue

        def counted(*a, _fn=fn, _name=name, **k):
            FUNCOL[_name] += 1
            return _fn(*a, **k)
        setattr(funcol, name, counted)


_count_funcol()


def _collectives():
    """A snapshot of the collectives made so far."""
    return (collections.Counter(C.calls), collections.Counter(C.sent_bytes),
            collections.Counter(FUNCOL))


def _since(snap, out, prefix=""):
    calls, sent, funcol = snap
    for kind, n in (collections.Counter(C.calls) - calls).items():
        out["%scalls/%s" % (prefix, kind)] = np.asarray(n)
    for kind, n in (collections.Counter(C.sent_bytes) - sent).items():
        out["%ssent/%s" % (prefix, kind)] = np.asarray(n)
    for kind, n in (collections.Counter(FUNCOL) - funcol).items():
        out["%sfuncol/%s" % (prefix, kind)] = np.asarray(n)


def _local_shape(v):
    """The shape of this rank's block of a scope value."""
    if hasattr(v, "placements"):
        return tuple(v.to_local().shape)
    return tuple(v.shape)


class _SpProbe:
    """Records each ``sp_attention``'s Q and output as they enter and
    leave the lowering."""

    def __init__(self):
        from paddle_tpu_torch.core import registry
        self.info = registry.lookup("sp_attention")
        self.lower, self.rows = self.info.lower, []

    def __enter__(self):
        def lower(ctx, op):
            q = ctx.in1(op, "Q")
            self.lower(ctx, op)
            o = ctx.get(op.output("Out")[0])
            self.rows.append([_local_shape(q), tuple(q.shape),
                              _local_shape(o), tuple(o.shape),
                              str(getattr(q, "placements", "")),
                              str(getattr(o, "placements", ""))])
        self.info.lower = lower
        return self

    def __exit__(self, *exc):
        self.info.lower = self.lower


def _mesh(case):
    return parallel.make_mesh(dict(case["axes"]), devices="cpu")


def _strategy(axes, case):
    return parallel.DistributedStrategy(
        dp=axes.get("dp", 1), tp=axes.get("tp", 1), sp=axes.get("sp", 1),
        pp=axes.get("pp", 1), ep=axes.get("ep", 1),
        gradient_accumulation_steps=case.get("accum", 1),
        pp_schedule=case.get("schedule", "gpipe"))


def _lm(case):
    axes = dict(case["axes"])
    mesh = _mesh(case)
    st = _strategy(axes, case)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _ = T.transformer_lm_parallel(
            vocab_size=64, max_len=16, n_layer=case.get("n_layer", 2),
            n_head=4, d_model=32, d_inner=64, strategy=st,
            num_experts=case.get("num_experts", 0))
        if case.get("clip"):
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(case["clip"]))
        if case.get("optimizer") == "adam":
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        else:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    scope = fluid.Scope()
    with np.load(case["init"]) as z:
        init = {k: z[k] for k in z.files}
    fluid.load_numpy_state(scope, init, "cpu")
    pexe = fluid.ParallelExecutor(loss_name=avg_cost.name,
                                  main_program=main, mesh=mesh, scope=scope,
                                  strategy=st)
    batches = [T.make_lm_batch(np.random.RandomState(case["seed"] + 100 * i),
                               4 * axes.get("dp", 1), 16, 64)
               for i in range(case.get("steps", 3))]
    snap = _collectives()
    with _SpProbe() as probe:
        losses = [float(np.asarray(pexe.run([avg_cost], feed=f)[0]))
                  for f in batches]
    out = {"losses": np.asarray(losses)}
    _since(snap, out)
    if probe.rows:
        out["sp_attention"] = np.asarray(json.dumps(probe.rows))
    names = sorted(v.name for v in main.global_block().vars.values()
                   if v.persistable and scope.find_var(v.name) is not None)
    for n in names:
        out["shape/" + n] = np.asarray(_local_shape(scope.find_var(n)))
        out["w/" + n] = fluid.core.executor.as_numpy(scope.find_var(n))
    if case.get("run_steps"):
        # the same steps as one run_steps call from the same state
        scope2 = fluid.Scope()
        fluid.load_numpy_state(scope2, init, "cpu")
        pexe2 = fluid.ParallelExecutor(loss_name=avg_cost.name,
                                       main_program=main, mesh=mesh,
                                       scope=scope2, strategy=st)
        outs = pexe2.run_steps([avg_cost], feeds=batches)
        out["steps_losses"] = np.asarray([float(np.asarray(o[0]))
                                          for o in outs])
        out["steps_megastep_dispatches"] = np.asarray(
            pexe2.stats["megastep_dispatches"])
        for n in names:
            out["steps_w/" + n] = fluid.core.executor.as_numpy(
                scope2.find_var(n))
    if case.get("save"):
        fluid.io.save_checkpoint(case["save"], len(losses),
                                 main_program=main, scope=scope)
    if case.get("eval"):
        # the trained scope read by a plain Executor on every rank (its
        # held blocks gathered whole), on the next batch
        feed = T.make_lm_batch(np.random.RandomState(
            case["seed"] + 100 * len(batches)), 4 * axes.get("dp", 1), 16,
            64)
        exe = fluid.Executor(fluid.CPUPlace())
        out["eval_loss"] = np.asarray(float(np.asarray(exe.run(
            main.clone(for_test=True), feed=feed, fetch_list=[avg_cost],
            scope=scope)[0])))
    return out


def _attn(case):
    mesh = _mesh(case)
    b, h, t, d = case["shape"]
    rng = np.random.RandomState(case["seed"])
    q, k, v, w = (torch.tensor(rng.randn(b, h, t, d).astype(np.float32))
                  for _ in range(4))
    fn = (parallel.ring_attention if case["variant"] == "ring"
          else parallel.ulysses_attention)
    ba = case.get("batch_axis")
    snap = _collectives()
    if case.get("blocks"):
        # each rank's [B/dp, H, T/sp, D] block, as DTensors
        from torch.distributed.tensor import DTensor, Replicate, Shard
        pl = [Shard(0) if a == "dp" else Shard(2) if a == "sp"
              else Replicate() for a in mesh.dtensor_axes]
        spec = (ba, None, "sp", None)
        leaves = [parallel.blocks.block_of(mesh, spec, x).requires_grad_(
            True) for x in (q, k, v)]
        glob = [DTensor.from_local(x, mesh.dtensor_mesh, pl,
                                   run_check=False, shape=q.shape,
                                   stride=q.stride()) for x in leaves]
        out = fn(*glob, mesh, axis_name="sp", causal=case["causal"],
                 batch_axis=ba)
        local = out.to_local()
        (local * parallel.blocks.block_of(mesh, spec, w)).sum().backward()
        res = {"out_local": np.asarray(local.shape)}
        _since(snap, res)
        whole = [C.global_value(DTensor.from_local(
            x, mesh.dtensor_mesh, pl, run_check=False, shape=q.shape,
            stride=q.stride())) for x in [local.detach()] +
            [x.grad for x in leaves]]
        res.update(zip(("out", "dq", "dk", "dv"),
                       (x.numpy() for x in whole)))
        return res
    for x in (q, k, v):
        x.requires_grad_(True)
    out = fn(q, k, v, mesh, axis_name="sp", causal=case["causal"],
             batch_axis=ba)
    (out * w).sum().backward()
    res = {"out": out.detach().numpy(), "dq": q.grad.numpy(),
           "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    _since(snap, res)
    return res


def _loader(case):
    mesh = _mesh(case)
    rng = np.random.RandomState(case["seed"])
    batches = [{"x": rng.randn(8, 3).astype(np.float32),
                "y": rng.randint(0, 9, (8, 1)).astype(np.int64)}
               for _ in range(4)]
    dim = case.get("batch_dim")
    sharding = mesh if dim is None else (mesh, dim)
    loader = fluid.reader.DeviceLoader(batches, device="cpu",
                                       sharding=sharding)
    out = {}
    it = (loader.megabatches(case["megabatch"]) if case.get("megabatch")
          else loader)
    for i, got in enumerate(it):
        for n, val in got.items():
            # each rank's block, and the global shape it belongs to
            out["%d/%s" % (i, n)] = val.to_local().numpy()
            out["%d/%s/global" % (i, n)] = np.asarray(val.shape)
    return out


KINDS = {"lm": _lm, "attn": _attn, "loader": _loader}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--hang-dump", type=float, default=200.0)
    args = ap.parse_args()
    with open(args.spec) as f:
        spec = json.load(f)
    # a hung rank prints every thread's stack before the harness kills it
    faulthandler.dump_traceback_later(args.hang_dump, exit=False, repeat=True)
    launch.init_parallel_env(args.store, args.world, args.rank,
                             device="cpu", timeout=120)
    try:
        for case in spec["cases"]:
            res = KINDS[case["kind"]](case)
            if case.get("per_rank"):
                np.savez(os.path.join(args.out, "%s.r%d.npz"
                                      % (case["id"], args.rank)), **res)
            if args.rank == 0:
                np.savez(os.path.join(args.out, "%s.npz" % case["id"]),
                         **res)
            print("case %s done" % case["id"], flush=True)
    finally:
        launch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
