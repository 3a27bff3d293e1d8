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

``run_steps`` (megastep) runs K steps as one dispatch: on the card the
K step bodies are captured once into a CUDA graph (``core/graphs.py``)
over static feed, state and fetch buffers and replayed; on the CPU the
same bodies run in a loop over the same buffers.

What the port leaves out raises, naming ROADMAP.md: host (IO) ops, the
marker's ``checkpoint`` attribute, ``calc_gradient``, NaN guards, the
transform pipeline, the monitor, LoD feeds, and random draws inside a
``run_steps`` graph on the card. Gradient accumulation is a
``ParallelExecutor`` build option in the JAX package; that entry point
is not ported, so nothing here can ask for it.
"""

import contextlib
import weakref

import numpy as np
import torch

from .. import flags
from . import graphs as _graphs
from . import registry
from .enforce import EnforceError, op_error
from .places import CUDAPlace, Place
from .program import Variable, default_main_program
from .scope import global_scope, to_tensor, torch_dtype

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


def _refuse_left_out_flags():
    for name, (what, item) in _LEFT_OUT_FLAGS.items():
        if flags.get_flag(name):
            raise _left_out("%s (PADDLE_TPU_%s)" % (what, name.upper()),
                            item)


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
        self._megasteps = {}     # run_steps cache key -> _Megastep
        self._inflight = []      # un-fetched run_steps dispatches
        self.stats = {"megastep_dispatches": 0, "graph_captures": 0,
                      "graph_replays": 0}

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = tuple(
            f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or []))
        _refuse_left_out_flags()
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
        gen = self._generator(program, self._rng_counter)
        self._rng_counter += 1
        with _tf32_off():
            fetches, new_state = step(state, feeds, lambda: gen)
        for n, v in new_state.items():
            scope.set(n, v)
        if return_numpy:
            return [as_numpy(v) for v in fetches]
        return list(fetches)

    def _generator(self, program, counter):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(program.random_seed * 1000003 + counter)
        return gen

    # -- megastep -------------------------------------------------------
    def run_steps(self, program=None, feeds=None, fetch_list=None,
                  scope=None, return_numpy=True, k=None,
                  use_program_cache=True):
        """K logical training steps in one dispatch (the megastep path),
        the counterpart of the JAX package's ``run_steps``: numerically
        K sequential ``run()`` calls on the same feeds, with the RNG
        counter advanced by K.

        ``feeds``: a LIST of K per-step feed dicts (one signature), or
        ONE pre-stacked ``[k, ...]`` dict together with ``k``. Returns K
        per-step fetch lists. With ``return_numpy=False`` the fetches
        are device tensors and nothing waits for the card; at most
        ``megastep_inflight`` (flag, default 2) such dispatches are in
        flight before the next call waits on the oldest.

        On the card the K step bodies (forward, autograd backward,
        optimizer, state update) are captured once into a CUDA graph,
        cached per program, feed signature, fetch list, state and K, and
        replayed; on the CPU the same bodies run in a loop. The feeds are
        staged into ``[K, ...]`` buffers with one copy each, the state is
        the scope's own tensors (the graph's, lent to the scope: a scope
        tensor replaced since is copied in before the replay), updated in
        place at the end of each step, and each step's fetches are
        copied out so that no later dispatch overwrites what a caller
        holds. Refused: programs with host (IO) ops and steps that make
        new persistables (startup programs: ``run()`` those), and, on
        the card, random draws (ROADMAP.md, queue 1 item 3)."""
        feeds, k = self._check_run_steps_args(feeds, k)
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = tuple(
            f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or []))
        if any(op.type in _HOST_OPS for op in program.global_block().ops):
            raise NotImplementedError(
                "run_steps cannot fuse programs with host (IO) ops: "
                "send/recv/prefetch must hit the wire once per step; use "
                "run() per step")
        _refuse_left_out_flags()
        staged, feed_sig = _stack_feeds(feeds, k)
        state_sig = []
        for v in program.global_block().vars.values():
            value = scope.find_var(v.name) if v.persistable else None
            if value is not None:
                state_sig.append((v.name,) + _signature(value))
        state_sig = tuple(sorted(state_sig))
        # what picks the kernels a capture holds is part of the key too:
        # the conv fusion flag and cuDNN's algorithm switches
        key = (program, program._version, feed_sig, fetch_names,
               state_sig, k, bool(flags.get_flag("fuse_conv_bn")),
               torch.backends.cudnn.deterministic,
               torch.backends.cudnn.benchmark)
        mega = self._megasteps.get(key) if use_program_cache else None
        if mega is None:
            step = self._build(program, tuple(n for n, _, _ in feed_sig),
                               fetch_names, tuple(n for n, _, _ in
                                                  state_sig))
            mega = _Megastep(self.device, step, feed_sig, state_sig, k,
                             "Executor.run_steps(k=%d)" % k)
            if use_program_cache:
                self._megasteps[key] = mega
        base = self._rng_counter
        self._rng_counter += k
        window = max(1, int(flags.get_flag("megastep_inflight")))
        while len(self._inflight) >= window:
            done = self._inflight.pop(0)
            if done is not None:
                done.synchronize()
        mega.stage(staged)
        mega.bind(scope)
        with _tf32_off():
            if self.device.type == "cuda":
                if mega.graph is None:
                    mega.capture()
                    self.stats["graph_captures"] += 1
                mega.graph.replay()
                self.stats["graph_replays"] += 1
            else:
                mega.run(lambda i: self._generator(program, base + i))
        self.stats["megastep_dispatches"] += 1
        outs = [b.clone() for b in mega.fetches]
        if return_numpy:
            arrays = [as_numpy(o) for o in outs]
            return [[np.asarray(a[i]) for a in arrays] for i in range(k)]
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._inflight.append(event)
        else:
            self._inflight.append(None)     # the CPU has finished already
        return [[o[i] for o in outs] for i in range(k)]

    @staticmethod
    def _check_run_steps_args(feeds, k):
        if isinstance(feeds, dict):
            if k is None:
                raise ValueError(
                    "run_steps(feeds=<pre-stacked dict>) needs k= (the "
                    "leading staging dim); pass a list of per-step feed "
                    "dicts to infer it")
            k = int(k)
        else:
            feeds = list(feeds or [])
            if k is not None and int(k) != len(feeds):
                raise ValueError("run_steps got k=%r but %d per-step feeds"
                                 % (k, len(feeds)))
            k = len(feeds)
        if k < 1:
            raise ValueError("run_steps needs k >= 1, got %d" % k)
        return feeds, k

    def _feed_tensor(self, name, value):
        if hasattr(value, "recursive_sequence_lengths"):
            raise _left_out("LoD feed %r" % name, "7")
        return to_tensor(value, self.device)

    # ------------------------------------------------------------------
    def _build(self, program, feed_names, fetch_names, state_keys):
        """The step function ``step(state, feeds, rng) -> (fetches,
        new_state)`` for one program, as the JAX package's ``_build``
        returns it (there it is traced and jitted; here it runs the
        lowerings eagerly each call). ``rng()`` hands the random ops
        the step's ``torch.Generator``."""
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

        def step(state, feeds, rng):
            env = {}
            env.update(state)
            env.update(feeds)
            ctx = registry.LowerContext(env, rng, self.device,
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


@contextlib.contextmanager
def _tf32_off():
    """cuDNN runs float32 convolutions in TF32 unless told otherwise;
    the port holds them to float32, as the JAX package computes them.
    The convolutions' backward runs inside the step too (in
    torch.autograd.grad), so the setting covers the whole step (and a
    capture of it) and is restored after it."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _signature(value):
    """(shape, torch dtype as the port holds it) of a scope or feed
    value."""
    if not isinstance(value, torch.Tensor):
        value = np.asarray(value)
    return tuple(value.shape), torch_dtype(value.dtype)


def _stack_feeds(feeds, k):
    """(``{name: [k, ...] host or device tensor}``, the per-step feed
    signature ``((name, shape, dtype), ...)``) from K per-step feed
    dicts or one pre-stacked dict."""
    if isinstance(feeds, dict):
        stacked = {}
        for name, value in feeds.items():
            if hasattr(value, "recursive_sequence_lengths"):
                raise _left_out("LoD feed %r" % name, "7")
            t = value if isinstance(value, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(value))
            if t.dim() < 1 or t.shape[0] != k:
                raise ValueError(
                    "pre-stacked megastep feed %r must have leading dim "
                    "k=%d, got shape %s" % (name, k, tuple(t.shape)))
            stacked[name] = t
    else:
        sig0 = None
        for i, feed in enumerate(feeds):
            for name, value in feed.items():
                if hasattr(value, "recursive_sequence_lengths"):
                    raise _left_out("LoD feed %r" % name, "7")
            sig = tuple(sorted((n,) + _signature(v) for n, v in feed.items()))
            if sig0 is None:
                sig0 = sig
            elif sig != sig0:
                raise ValueError(
                    "run_steps feeds must share ONE step signature (the "
                    "K step bodies are captured once): feed %d is %s, "
                    "feed 0 is %s. Pad or re-bucket the odd batch, or "
                    "run() it separately." % (i, sig, sig0))
        stacked = {}
        for name in feeds[0]:
            values = [f[name] for f in feeds]
            if all(isinstance(v, torch.Tensor) for v in values):
                stacked[name] = torch.stack(values)
            else:
                stacked[name] = torch.from_numpy(np.ascontiguousarray(
                    np.stack([np.asarray(v) for v in values])))
    sig = tuple(sorted((n,) + _signature(t[0]) for n, t in stacked.items()))
    return stacked, sig


def _no_draws():
    raise NotImplementedError(
        "a random op inside an Executor.run_steps step on the card: the "
        "CUDA graph would replay one draw K times. Draws equal to K run() "
        "calls are not ported yet (ROADMAP.md, queue 1 item 3); use run() "
        "per step")


class _Megastep:
    """K step bodies of one program over static buffers: the feeds as
    ``[K, ...]`` tensors, the state (tensors of its own, lent to the
    scope it last ran for), and each step's fetches copied into ``[K,
    ...]`` tensors. On the CPU ``run`` runs the K bodies in a loop; on
    the card ``capture`` captures them once, unrolled into one CUDA
    graph, and ``graph.replay()`` runs them."""

    def __init__(self, device, step, feed_sig, state_sig, k, what):
        self.device = device
        self.step = step
        self.k = k
        self.what = what
        self.feeds = {n: torch.empty((k,) + shape, dtype=dt, device=device)
                      for n, shape, dt in feed_sig}
        self.state = {n: torch.empty(shape, dtype=dt, device=device)
                      for n, shape, dt in state_sig}
        self.fetches = None      # made at the first step, from its fetches
        self.graph = None
        self._owner = None       # weakref to the scope holding the state

    def stage(self, stacked):
        """One copy per feed into its ``[K, ...]`` buffer (narrowed on the
        host, then through pinned memory without a wait, on the card)."""
        for name, src in stacked.items():
            buf = self.feeds[name]
            if src.device.type == "cpu":
                src = src.to(buf.dtype)
                if self.device.type == "cuda":
                    src = src.pin_memory()
            buf.copy_(src, non_blocking=True)

    def bind(self, scope):
        """Lend the state tensors to ``scope``: a scope value that is not
        one of them (a first call, ``scope.set``, ``load_numpy_state``, a
        ``run()`` since) is copied in and replaced by it. A scope that
        last ran here and still holds them gets copies of its own
        first, so that two scopes never share state."""
        old = self._owner() if self._owner is not None else None
        if old is not None and old is not scope:
            for n, t in self.state.items():
                if old.find_var(n) is t:
                    old.set(n, t.clone())
        for n, t in self.state.items():
            value = scope.find_var(n)
            if value is not t:
                t.copy_(to_tensor(value, self.device))
                scope.set(n, t)
        self._owner = weakref.ref(scope)

    def run(self, gen_of_step):
        """The K bodies in a loop (the CPU path): step i draws from
        ``gen_of_step(i)``."""
        for i in range(self.k):
            gen = gen_of_step(i)
            self._body(self.state, i, lambda: gen)

    def capture(self):
        """Warm up on copies of the state (one step), then capture the K
        bodies over the state into one CUDA graph."""
        graph = _graphs.StepGraph(self.device, self.what)

        def warmup():
            state = {n: t.clone() for n, t in self.state.items()}
            self._body(state, 0, _no_draws)

        def body():
            for i in range(self.k):
                self._body(self.state, i, _no_draws)

        graph.capture(warmup, body)
        self.graph = graph

    def _body(self, state, i, rng):
        """Step ``i``: read feed row i, write fetch row i, update
        ``state`` in place."""
        fetches, new = self.step(
            state, {n: b[i] for n, b in self.feeds.items()}, rng)
        extra = sorted(set(new) - set(state))
        if extra:
            raise ValueError(
                "run_steps: the program makes new persistable vars %s "
                "inside the step; the state of the K steps must be "
                "stable. run() the startup program (or the first step) "
                "once, then run_steps." % extra)
        if self.fetches is None:
            self.fetches = [torch.empty((self.k,) + tuple(v.shape),
                                        dtype=v.dtype, device=self.device)
                            for v in fetches]
        for buf, v in zip(self.fetches, fetches):
            buf[i].copy_(v)
        _commit(state, new)


def _commit(state, new):
    """Write a step's new values into the state tensors in place. A value
    that still is its tensor is skipped; one that shares storage with a
    state tensor (a view the step passed through) is copied first, so
    that no write reads what an earlier write of the same commit left."""
    storages = {t.untyped_storage().data_ptr() for t in state.values()}
    writes = []
    for n, v in new.items():
        t = state[n]
        if v.shape != t.shape:
            raise ValueError(
                "run_steps: the step changes persistable %r from %s to %s"
                % (n, tuple(t.shape), tuple(v.shape)))
        if (v.data_ptr() == t.data_ptr() and v.stride() == t.stride()
                and v.dtype == t.dtype):
            continue
        if v.untyped_storage().data_ptr() in storages:
            v = v.clone()
        writes.append((t, v))
    for t, v in writes:
        t.copy_(v)


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
