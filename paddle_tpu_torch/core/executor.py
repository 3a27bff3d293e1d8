"""Executor: runs a Program op by op on torch tensors.

The counterpart of ``paddle_tpu/core/executor.py``. The JAX package traces
a block through the lowering registry into one jitted step; PyTorch runs
eagerly, so the port calls the same lowerings directly on tensors, in the
order ``_build`` traces them there, and one ``run`` is one step:

  * feeds become tensors on the executor's device (64-bit types narrowed
    to 32-bit, as the JAX package holds them);
  * persistable variables of the program found in the scope are the step
    state; the values the step leaves under those names, and any new
    persistable value (startup initializers), are committed back;
  * random ops draw from one ``torch.Generator`` per run, seeded with
    ``program.random_seed * 1000003 + run counter`` (the JAX package's
    per-run key derivation; the draws themselves differ from threefry's);
  * a ``backward_marker`` (``append_backward``) runs the forward segment
    under ``torch.autograd`` in place of ``jax.value_and_grad``, binds
    every ``P@GRAD``, then runs the optimizer ops without autograd.

What this slice leaves out raises, naming ROADMAP.md: ``run_steps``
(megastep), host (IO) ops, the marker's ``checkpoint`` attribute,
``calc_gradient``, NaN guards, the transform pipeline, the monitor, and
LoD feeds. Gradient accumulation is a ``ParallelExecutor`` build option
in the JAX package; that entry point is not ported, so nothing here can
ask for it.
"""

import numpy as np
import torch

from .. import flags
from . import registry
from .enforce import EnforceError, op_error
from .places import CUDAPlace, Place
from .program import Variable, default_main_program
from .scope import global_scope, to_tensor

__all__ = ["Executor", "as_numpy"]

# the JAX package's host (IO) ops: distributed send/recv/prefetch and the
# control-flow tensor arrays, which run outside its jitted step
_HOST_OPS = frozenset([
    "write_to_array", "read_from_array", "lod_array_length", "send",
    "send_barrier", "send_sparse", "recv", "prefetch", "listen_and_serv",
    "split_ids", "split_selected_rows", "merge_selected_rows",
    "lookup_sparse_table"])

# flags that switch on a JAX-package feature this slice does not port
# (flag name: what it switches on, ROADMAP.md queue 1 item)
_LEFT_OUT_FLAGS = {
    "check_nan_inf": ("NaN/Inf guards", "2"),
    "transform": ("the program-transform pipeline", "11"),
    "monitor": ("the runtime monitor", "10"),
}


def _left_out(what, item):
    return NotImplementedError(
        "%s is not ported to paddle_tpu_torch yet (ROADMAP.md, queue 1 "
        "item %s)" % (what, item))


def as_numpy(value):
    """A fetched value as a numpy array."""
    if isinstance(value, (list, tuple)):
        return [as_numpy(v) for v in value]
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class Executor:
    """Single-device executor: one CUDA card, or the CPU when asked.

    ``place=None`` means ``CUDAPlace(0)``; without a card that raises,
    as every entry point of the port does. ``CPUPlace()`` runs the plain
    PyTorch path on the CPU (the tests use it).
    """

    def __init__(self, place=None):
        if place is None:
            place = CUDAPlace(0)
        if not isinstance(place, Place):
            raise TypeError("place must be a Place, got %r" % (place,))
        self.place = place
        self.device = place.torch_device()
        self._rng_counter = 0

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = tuple(
            f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or []))
        for name, (what, item) in _LEFT_OUT_FLAGS.items():
            if flags.get_flag(name):
                raise _left_out("%s (PADDLE_TPU_%s)" % (what, name.upper()),
                                item)
        feeds = {k: self._feed_tensor(k, v) for k, v in (feed or {}).items()}
        persistable = [v.name for v in program.global_block().vars.values()
                       if v.persistable]
        state = {}
        for n in persistable:
            v = scope.find_var(n)
            if v is not None:
                state[n] = to_tensor(v, self.device)
        step = self._build(program, tuple(sorted(feeds)), fetch_names,
                           tuple(sorted(state)))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(program.random_seed * 1000003 + self._rng_counter)
        self._rng_counter += 1
        # cuDNN runs float32 convolutions in TF32 unless told otherwise;
        # the port holds them to float32, as the JAX package computes
        # them. The convolutions' backward runs inside the step too (in
        # torch.autograd.grad), so the setting covers the whole step and
        # is restored after it.
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            fetches, new_state = step(state, feeds, gen)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        for n, v in new_state.items():
            scope.set(n, v)
        if return_numpy:
            return [as_numpy(v) for v in fetches]
        return list(fetches)

    def run_steps(self, program=None, feeds=None, fetch_list=None,
                  scope=None, return_numpy=True, k=None,
                  use_program_cache=True):
        raise _left_out("Executor.run_steps (megastep)", "2")

    def _feed_tensor(self, name, value):
        if hasattr(value, "recursive_sequence_lengths"):
            raise _left_out("LoD feed %r" % name, "7")
        return to_tensor(value, self.device)

    # ------------------------------------------------------------------
    def _build(self, program, feed_names, fetch_names, state_keys):
        """The step function ``step(state, feeds, generator) -> (fetches,
        new_state)`` for one program, as the JAX package's ``_build``
        returns it (there it is traced and jitted; here it runs the
        lowerings eagerly each call)."""
        block = program.global_block()
        ops = list(block.ops)
        for op in ops:
            if op.type in _HOST_OPS:
                raise _left_out("host (IO) op %r" % op.type, "10")
        persistable_names = {v.name for v in block.vars.values()
                             if v.persistable}
        read_names = {n for op in ops for n in op.input_names}
        read_names.update(fetch_names)
        read_names.update(persistable_names)
        bwd_idx = None
        for i, op in enumerate(ops):
            if op.type == "calc_gradient_marker":
                raise _left_out("calc_gradient", "3")
            if op.type == "backward_marker":
                if op.attr("checkpoint"):
                    raise _left_out(
                        "append_backward(checkpoint=True) "
                        "rematerialization", "3")
                bwd_idx = i
                break

        def step(state, feeds, gen):
            env = {}
            env.update(state)
            env.update(feeds)
            ctx = registry.LowerContext(env, lambda: gen, self.device,
                                        executor=self, block=block,
                                        fetch_names=fetch_names,
                                        read_names=read_names)
            if bwd_idx is None:
                with torch.no_grad():
                    for op in ops:
                        _lower_op(ctx, op)
            else:
                self._lower_with_grad(ctx, ops, bwd_idx)
            fetches = tuple(_fetch_from_env(env, n).detach()
                            for n in fetch_names)
            new_state = {n: env[n].detach() for n in state_keys if n in env}
            # newly-created persistable values (startup initializers)
            for n in persistable_names:
                if n not in new_state and n in env:
                    new_state[n] = env[n].detach()
            return fetches, new_state

        return step

    @staticmethod
    def _lower_with_grad(ctx, ops, bwd_idx):
        """Run the forward ops with autograd, bind ``P@GRAD``, then run
        the remaining (optimizer) ops without it.

        The ``wrt`` parameters become fresh leaf tensors (detached views
        of the state: the optimizer lowerings write new tensors, never
        into these, so nothing the graph holds changes under it). The
        objective is the sum of the targets, each summed when not a
        scalar, as the JAX package's ``value_and_grad`` objective. A
        parameter the loss does not reach gets zeros, as ``jax.grad``
        gives; ``loss@GRAD`` is ones."""
        marker = ops[bwd_idx]
        wrt_names = marker.attr("param_names") or []
        target_names = [marker.attr("loss_name")]
        leaves = {n: ctx.env[n].detach().requires_grad_(True)
                  for n in wrt_names if n in ctx.env}
        ctx.env.update(leaves)
        with torch.enable_grad():
            for op in ops[:bwd_idx]:
                _lower_op(ctx, op)
            total = 0.0
            for tn in target_names:
                t = ctx.env[tn]
                total = total + (t if t.dim() == 0 else t.sum())
            names = list(leaves)
            grads = torch.autograd.grad(
                total, [leaves[n] for n in names], allow_unused=True)
        loss_val = ctx.env[target_names[0]]
        ctx.env[target_names[0] + "@GRAD"] = torch.ones_like(
            loss_val.detach())
        for n, g in zip(names, grads):
            ctx.env[n + "@GRAD"] = torch.zeros_like(leaves[n]) \
                if g is None else g
            ctx.env[n] = leaves[n].detach()
        with torch.no_grad():
            for op in ops[bwd_idx + 1:]:
                _lower_op(ctx, op)


def _lower_op(ctx, op):
    if op.type in ("feed", "fetch"):
        _lower_feed_fetch(ctx, op)
        return
    info = registry.lookup(op.type)
    if info is None:
        raise NotImplementedError(
            "no lowering registered for op %r in paddle_tpu_torch "
            "(registered: %d ops; ROADMAP.md queue 1 lists what remains)"
            % (op.type, len(registry.registered_ops())))
    try:
        info.lower(ctx, op)
    except (EnforceError, NotImplementedError):
        raise
    except Exception as e:  # annotate with op context (enforce.h:203 parity)
        raise op_error(op, ctx.env, e) from e


def _lower_feed_fetch(ctx, op):
    # Feeds are pre-bound into env by var name; a 'feed' op in a loaded
    # inference program is therefore a name passthrough, as is 'fetch'.
    if op.type == "feed":
        out = ctx.out_name(op, "Out")
        if out is not None and out not in ctx.env:
            raise KeyError("feed target %r was not provided in feed dict" % out)
    else:  # fetch
        src = op.input("X")
        out = ctx.out_name(op, "Out")
        if src and out:
            ctx.env[out] = ctx.get(src[0])


def _fetch_from_env(env, name):
    if name not in env:
        raise KeyError(
            "fetch var %r was not produced by the program; "
            "available: %s..." % (name, sorted(env)[:20]))
    return env[name]
