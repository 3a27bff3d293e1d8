"""ParallelExecutor: data- and model-parallel program execution.

The counterpart of ``paddle_tpu/parallel/executor.py``. The JAX one is a
single controller: one process feeds the global batch and GSPMD places
state and feeds by their ``shard`` hints. The port runs one process a
rank (``distributed/launch.py``) and keeps the same contract: every rank
runs the same script with the same global feed and takes its own shard,
and every fetch is the global value on every rank.

DTensor and held blocks play GSPMD's part. Over a mesh of more than one
rank (``parallel/mesh.py`` says which axes are which):

  * state is placed by its hint. A persistable whose hint names only
    DTensor axes (``dp``, ``tp``, and ``sp`` where ``tp`` has one rank)
    becomes a DTensor over ``Mesh.dtensor_mesh`` (``spec_to_placements``:
    Shard on the named mesh dims, Replicate elsewhere). One whose hint
    names a manual axis (``pp``, ``ep``, or ``sp`` beside ``tp``) is
    held as this rank's block of the scope's global value
    (``parallel/blocks.py``): stage weights on ``pp``, expert weights on
    ``ep``, the pipeline's gates, and the accumulators of such a
    parameter (Adam's moments). Either way each rank takes its block of
    the global value the scope holds, and the block stays in the scope
    between steps (``io`` gathers it to save it). A held block's
    gradient and its optimizer update stay local;
  * a dense feed is sharded on ``dp`` along its batch dim (each rank's
    block of the global feed: no communication), and where ``sp`` is a
    DTensor axis, a feed of the program's sequence length along dim 1
    too, so the LM's activations are each rank's sequence block from the
    embedding lookup to the loss; LoD buffers, whose row counts are
    data, stay replicated;
  * the lowerings run on DTensors, and DTensor's sharding propagation
    inserts the reductions, so the flagship LM's ``reduce_sum(masked) /
    reduce_sum(mask)`` is global over the batch and the sequence, as in
    the JAX package. One hook in ``core/executor._lower_op_body``
    (``blocks.lower``) steps in before a lowering in two cases: an op
    that reads a held block (``parallel/blocks.py``), and an op with a
    sequence-block rule that meets a [B, T] block split on ``sp``
    (``parallel/seqblocks.py``). The parallel ops enter their kernels
    through ``shard_map`` (``ops/parallel_ops.py``), which takes a block
    as it is where its spec matches;
  * a fetch is the global value (``collective.global_value``:
    ``full_tensor`` through the port's collectives, a held block
    gathered the same way).

Where the lowerings and the layouts step around DTensor is listed in
one place, ``parallel/mesh.py``'s docstring.

A mesh of one rank places nothing: the step is ``Executor``'s on plain
tensors, with the mesh in ``ctx.mesh``.

``run_steps``: at one rank K steps are one CUDA graph on the card
(``Executor.run_steps``). Over several ranks, on any mesh axis, they run
as K ``run`` calls without capture: gloo's collectives (a blocking copy
through host memory and a CPU call) cannot be captured in a graph, and
capturing NCCL's is left out (it needs more than one card to try).

``DistributedStrategy(use_bf16_compute=True)`` pins AMP (``amp.py``) on
for this executor's steps, ``run`` and ``run_steps``, and restores the
ambient setting after each; False (the default) leaves the ambient AMP
setting alone, as in the JAX package.

The monitor and the tracer see it as the JAX package's: each ``run`` is a
``pexe.step`` root span (``run_steps`` one with ``k``), and with the
monitor armed a new step key is an ``on_compile(executor="pexe")`` (its
``compile`` row carries the mesh's device count), a known one a cache
hit, and each step an ``on_step(executor="pexe")`` row.
"""

import contextlib
import time

import numpy as np
import torch

from ..amp import amp_guard
from ..core.executor import (Executor, _is_lod, _normalize_feeds,
                             _raise_first_nan, _tf32_off, _trim_fetches,
                             as_numpy, FeedPlanCache)
from ..core.places import CPUPlace, CUDAPlace
from ..core.program import Variable, default_main_program
from ..core.scope import global_scope, to_tensor
from . import blocks
from .mesh import (default_mesh, make_mesh, set_default_mesh,
                   spec_to_placements)
from .. import flags
from ..monitor import runtime as _mon
from ..trace import runtime as _trace

_TOK = "@ACCUM_TOKENS"


def _is_dtensor(x):
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _distribute(mesh, t, placements):
    """A global tensor every rank holds -> its DTensor (each rank's
    block: no communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    from .collective import move_local
    t = t.contiguous()
    dm = mesh.dtensor_mesh
    local = move_local(t, [Replicate()] * dm.ndim, placements, dm)
    return DTensor.from_local(local, dm, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _held_spec(held, name):
    """The hint of fetch ``name`` where it is a held block (a held
    persistable or its gradient), else None."""
    if name.endswith("@GRAD"):
        name = name[:-len("@GRAD")]
    return held.get(name)


def _global(v, mesh=None, spec=None):
    """A fetched value as every rank's global tensor (``spec``: the hint
    of a held block)."""
    from .collective import global_value
    if spec is not None:
        return blocks.whole(mesh, spec, v)
    return global_value(v) if _is_dtensor(v) else v


class ParallelExecutor:
    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, num_trainers=1, trainer_id=0,
                 mesh=None, scope=None, use_tpu=True, strategy=None,
                 **kwargs):
        # `use_cuda` is the reference's legacy "use accelerator" flag;
        # the device is the mesh's. Anything else is rejected loudly.
        if kwargs:
            raise TypeError(
                "unsupported ParallelExecutor arguments: %r"
                % sorted(kwargs))
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
        if num_trainers != 1 and world != num_trainers:
            raise ValueError(
                "num_trainers=%d but this process group has %d processes; "
                "multi-trainer mode requires init_parallel_env() "
                "across exactly num_trainers processes"
                % (num_trainers, world))
        self.num_trainers = num_trainers
        self.trainer_id = trainer_id if num_trainers > 1 else \
            (dist.get_rank() if dist.is_initialized() else 0)
        self.mesh = mesh or default_mesh() or make_mesh()
        if default_mesh() is None:
            set_default_mesh(self.mesh)
        self._program = main_program or default_main_program()
        if share_vars_from is not None:
            # reuse the parameter scope of an existing executor (share
            # train params with a test ParallelExecutor)
            scope = share_vars_from._scope
        self._scope = scope or global_scope()
        dev = self.mesh.device()
        place = CPUPlace() if dev.type == "cpu" else \
            CUDAPlace(dev.index or 0)
        self._exe = Executor(place)
        self._exe._mesh = self.mesh     # the parallel lowerings read it
        self._exe._held = {}            # set a run by _placement
        self.device = self._exe.device
        # feed plans only: the feeds are placed per rank below
        self._feed_plans = FeedPlanCache(device_fn=None)
        self._loss_name = loss_name
        self._accum_steps = max(
            1, int(getattr(strategy, "gradient_accumulation_steps", 1)))
        # how the loss is normalized, for ragged-LoD accumulation: None
        # (reject ragged-unequal splits), "sequence", "token", or
        # "token:<feed_name>" — see _check_accum_weights
        self._accum_loss_norm = getattr(
            strategy, "gradient_accumulation_loss_norm", None)
        if self._accum_loss_norm is not None and not (
                self._accum_loss_norm == "sequence"
                or self._accum_loss_norm == "token"
                or self._accum_loss_norm.startswith("token:")):
            raise ValueError(
                "gradient_accumulation_loss_norm must be 'sequence', "
                "'token', or 'token:<feed_name>'; got %r"
                % (self._accum_loss_norm,))
        # use_bf16_compute=True pins AMP on for THIS executor's steps
        # (restored after each: the process-wide setting is not leaked)
        self._force_bf16 = bool(getattr(strategy, "use_bf16_compute",
                                        False))

    @property
    def device_count(self):
        return self.mesh.size

    @property
    def stats(self):
        """The inner Executor's counters (``graph_captures``,
        ``graph_replays``, ... of one-rank ``run_steps``)."""
        return self._exe.stats

    @property
    def _sharded(self):
        """Whether values are DTensors (the dp x tp sub-mesh has more than
        one rank); otherwise every rank holds every value whole."""
        return self.mesh.dtensor_mesh is not None

    def _check_accum_weights(self, feed_arrays):
        """Host-side guard for ragged gradient accumulation: unequal
        microbatch token totals need an explicit loss_norm, and 'token'
        with several disagreeing LoD feeds needs the feed named."""
        toks = {n[:-len(_TOK)]: np.asarray(v)
                for n, v in feed_arrays.items() if n.endswith(_TOK)}
        norm = self._accum_loss_norm
        if norm is None:
            ragged = sorted(n for n, t in toks.items()
                            if not np.all(t == t[0]))
            if ragged:
                raise ValueError(
                    "gradient accumulation with ragged LoD feeds: "
                    "microbatch token totals are unequal for %s. Equal "
                    "microbatch weighting is only exact for per-"
                    "sequence-mean losses. Set DistributedStrategy."
                    "gradient_accumulation_loss_norm='sequence' (loss "
                    "is a mean over sequences) or 'token' (loss is a "
                    "mean over tokens; microbatches are weighted by "
                    "their true token counts)." % ragged)
        elif norm == "token" and len(toks) > 1:
            rep = {tuple(t.tolist()) for t in toks.values()}
            if len(rep) > 1:
                raise ValueError(
                    "gradient_accumulation_loss_norm='token' is "
                    "ambiguous: LoD feeds %s have different microbatch "
                    "token totals. Name the feed the loss normalizes "
                    "over: 'token:<feed_name>'." % sorted(toks))

    # -- placement --------------------------------------------------------
    def _placement(self):
        """(``{name: hint}`` of the state held as blocks, the sequence
        lengths of ``_seq_lens``), memoized on the program's version; the
        step's lowerings read the first through ``ctx.held_spec``."""
        prog = self._program
        key = (prog, prog._version)
        if getattr(self, "_placement_key", None) != key:
            self._placement_key = key
            self._exe._held = blocks.held_specs(prog, self.mesh)
            self._seq = self._seq_lens()
        return self._exe._held, self._seq

    def _state_tensor(self, name, value):
        spec = self._exe._held.get(name)
        if spec is not None:
            if isinstance(value, blocks.Held):
                return value.local()
            t = to_tensor(value, self.device)
            if _is_dtensor(t):
                t = _global(t)
            return blocks.block_of(self.mesh, spec, t)
        t = to_tensor(value, self.device)
        if isinstance(t, blocks.Held):
            t = t.full_tensor()
        if not self._sharded:
            return t
        pl = spec_to_placements(self.mesh,
                                self._program._sharding_hints.get(name))
        if _is_dtensor(t):
            if tuple(t.placements) != tuple(pl):
                t = t.redistribute(self.mesh.dtensor_mesh, pl)
            return t
        return _distribute(self.mesh, t, pl)

    def _seq_lens(self):
        """The sequence lengths the program's sequence-parallel ops run
        over (``sp_attention``'s Q dim 2, ``pipeline_stack``'s X dim 1),
        where ``sp`` is a DTensor axis of this mesh; else empty."""
        mesh = self.mesh
        if mesh.shape.get("sp", 1) <= 1 or "sp" not in mesh.dtensor_axes:
            return set()
        block = self._program.global_block()
        out = set()
        for op in block.ops:
            slot, dim = {"sp_attention": ("Q", 2),
                         "pipeline_stack": ("X", 1)}.get(op.type, (0, 0))
            if slot and op.input(slot):
                shape = block.vars[op.input(slot)[0]].shape
                if len(shape) > dim and shape[dim] > 0:
                    out.add(int(shape[dim]))
        return out

    def _feed_tensor(self, name, value, replicated, batch_dim=0,
                     seq=()):
        """A feed on this rank: its ``dp`` block as a DTensor (a DTensor
        feed, a sharded ``DeviceLoader``'s, is laid out the same way),
        and its ``sp`` block along the dim after the batch where that dim
        is one of the sequence lengths ``seq``."""
        t = to_tensor(value, self.device)
        if not self._sharded:
            return _global(t)
        from torch.distributed.tensor import Replicate, Shard
        axes = self.mesh.dtensor_axes
        pl = [Replicate() for _ in axes]
        if not replicated and "dp" in axes and t.dim() > batch_dim:
            pl[axes.index("dp")] = Shard(batch_dim)
        if not replicated and "sp" in axes and t.dim() > batch_dim + 1 \
                and t.shape[batch_dim + 1] in seq \
                and t.shape[batch_dim + 1] % self.mesh.shape["sp"] == 0:
            pl[axes.index("sp")] = Shard(batch_dim + 1)
        if _is_dtensor(t):
            return t if tuple(t.placements) == tuple(pl) else \
                t.redistribute(self.mesh.dtensor_mesh, pl)
        return _distribute(self.mesh, t, pl)

    def _amp(self):
        """The AMP scope of this executor's steps: pinned on under
        ``use_bf16_compute=True``, else the ambient setting."""
        return amp_guard(True) if self._force_bf16 else \
            contextlib.nullcontext()

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        trc = _trace._TRACER
        with self._amp():
            if trc is None:
                return self._run_impl(fetch_list, feed, feed_dict,
                                      return_numpy)
            # the distributed-trace root span of the step
            with trc.span("pexe.step"):
                return self._run_impl(fetch_list, feed, feed_dict,
                                      return_numpy)

    def _run_impl(self, fetch_list, feed, feed_dict, return_numpy):
        feed = dict(feed or feed_dict or {})
        program = self._program
        scope = self._scope
        exe = self._exe
        fetch_names = tuple(
            f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or []))
        dp = self.mesh.shape.get("dp", 1)
        k_acc = self._accum_steps
        arrays, static_info = _normalize_feeds(
            feed, plan_cache=self._feed_plans, commit=False,
            accum_steps=k_acc)
        if k_acc > 1:
            self._check_accum_weights(arrays)
        # ragged token buffers stay replicated (their row count is data)
        lod_keys = {n for n in arrays
                    if n.endswith("@LOD") or n.endswith(_TOK)}
        lod_keys |= {n for n, v in feed.items() if _is_lod(v)}
        for n, v in arrays.items():
            if n in lod_keys:
                continue
            shape = tuple(getattr(v, "shape", np.shape(v)))
            if len(shape) >= 1 and shape[0] % dp != 0:
                raise ValueError(
                    "feed %r batch dim %d not divisible by dp=%d "
                    "(SplitLoDTensor parity requires equal chunks)"
                    % (n, shape[0], dp))
        if k_acc > 1:
            arrays = self._split_microbatches(arrays, lod_keys,
                                              static_info, k_acc)
        feeds = {}
        held, seq = self._placement()
        for n, v in arrays.items():
            stacked = k_acc > 1 and not n.endswith(_TOK)
            feeds[n] = self._feed_tensor(n, v, n in lod_keys,
                                         1 if stacked else 0, seq)
        persistable = [v.name for v in program.global_block().vars.values()
                       if v.persistable]
        state = {}
        for n in persistable:
            v = scope.find_var(n)
            if v is not None:
                state[n] = self._state_tensor(n, v)
        check_nan = bool(flags.get_flag("check_nan_inf"))
        mon_on = _mon.enabled()
        t_build = time.perf_counter() if mon_on else 0.0
        step = exe._build(program, tuple(sorted(feeds)), fetch_names,
                          tuple(sorted(state)), static_info,
                          check_nan=check_nan, accum_steps=k_acc,
                          accum_loss_norm=self._accum_loss_norm)
        key = None
        if mon_on:
            key = self._monitor_build(program, arrays, feeds, fetch_names,
                                      state, static_info, check_nan,
                                      time.perf_counter() - t_build)
            t0 = time.perf_counter()
            timer = _mon.step_timer(self)
            do_sync = timer.begin(t0)
        seed = exe._seed(program, exe._rng_counter)
        exe._rng_counter += 1
        seed_t = []

        def seed_fn():
            if not seed_t:
                seed_t.append(torch.full((), seed, dtype=torch.int64,
                                         device=self.device))
            return seed_t[0]

        with _tf32_off():
            fetches, new_state, fetch_lods, guards = step(state, feeds,
                                                          seed_fn)
        if mon_on:
            exe._monitor_step(key, arrays, timer, t0, do_sync, "pexe")
        block = program.global_block()
        for n, v in new_state.items():
            spec = held.get(n)
            if spec is not None:
                shape = tuple(block.vars[n].shape)
                if tuple(v.shape) == shape:   # a whole value the step made
                    v = blocks.block_of(self.mesh, spec, v)
                v = blocks.Held(v, spec, self.mesh, shape)
            scope.set(n, v)
        fetches = [_global(v, self.mesh, _held_spec(held, n))
                   for n, v in zip(fetch_names, fetches)]
        fetch_lods = {n: _global(v) for n, v in fetch_lods.items()}
        fetches = _trim_fetches(fetch_names, fetches, fetch_lods)
        if guards is not None:
            _raise_first_nan(guards[0],
                             exe._read_guards(_global(guards[1]))[None])
        if return_numpy:
            return [as_numpy(v) for v in fetches]
        return list(fetches)

    def _monitor_build(self, program, arrays, feeds, fetch_names, state,
                       static_info, check_nan, dt):
        """The monitor's compile hooks for one ``run()``: a new step key
        is an ``on_compile(executor="pexe")`` over the mesh's devices
        (its build time an ``on_compile_phase("plan_build")``), a known
        one a cache hit. Returns the key."""
        feed_sig = tuple(sorted((n, tuple(v.shape), str(v.dtype))
                                for n, v in feeds.items()))
        key = (program, program._version, feed_sig, fetch_names,
               tuple(sorted(state)), check_nan, self._accum_steps,
               bool(flags.get_flag("fuse_conv_bn")),
               tuple(sorted(static_info.items())))
        keys = self.__dict__.setdefault("_step_keys", set())
        if key in keys:
            _mon.on_cache_hit()
        else:
            keys.add(key)
            _mon.on_compile(program, key, feed_sig, executor="pexe",
                            tokens=_mon.tokens_in_feeds(arrays),
                            devices=self.mesh.size)
            _mon.on_compile_phase("plan_build", dt)
        return key

    @staticmethod
    def _split_microbatches(arrays, lod_keys, static_info, k):
        """Gradient accumulation's host split: a dense feed with a batch
        dim > 1 becomes [k, B/k, ...] (LoD feeds arrive [k, ...] from
        ``_normalize_feeds``; a scalar or leading-dim-1 feed repeats for
        every microbatch)."""
        out = {}
        for n, v in arrays.items():
            if n.endswith(_TOK) or static_info.get(n + "@ACCUM_LOD") \
                    or (n.endswith("@LOD")
                        and static_info.get(n[:-4] + "@ACCUM_LOD")):
                out[n] = v
                continue
            a = v if isinstance(v, torch.Tensor) else np.asarray(v)
            if a.ndim < 1 or a.shape[0] <= 1:
                out[n] = (a.expand((k,) + tuple(a.shape))
                          if isinstance(a, torch.Tensor)
                          else np.broadcast_to(a, (k,) + a.shape).copy())
                continue
            if a.shape[0] % k:
                raise ValueError(
                    "feed %r batch dim %s not divisible into %d "
                    "microbatches" % (n, tuple(a.shape), k))
            out[n] = a.reshape((k, a.shape[0] // k) + tuple(a.shape[1:]))
        return out

    def run_steps(self, fetch_list, feeds=None, return_numpy=True, k=None):
        """K logical steps: the ParallelExecutor twin of
        ``Executor.run_steps`` (a list of K feed dicts, or one
        pre-stacked ``[k, ...]`` dict plus ``k``). At one rank the K
        steps are one dispatch (one CUDA graph on the card); over
        several ranks they run as K ``run`` calls (module docstring).
        Returns K per-step fetch lists."""
        feeds, k = Executor._check_run_steps_args(feeds, k)
        trc = _trace._TRACER
        with self._amp():
            if trc is None:
                return self._run_steps_impl(fetch_list, feeds,
                                            return_numpy, k)
            with trc.span("pexe.step", k=k):
                return self._run_steps_impl(fetch_list, feeds,
                                            return_numpy, k)

    def _run_steps_impl(self, fetch_list, feeds, return_numpy, k):
        if self._accum_steps > 1:
            raise ValueError(
                "run_steps does not compose with gradient_"
                "accumulation_steps=%d: the megastep would nest the "
                "accumulation and change the optimizer cadence. Megastep "
                "K already amortizes dispatch; use one or the other."
                % self._accum_steps)
        if self.mesh.size == 1:
            return self._exe.run_steps(self._program, feeds=feeds,
                                       fetch_list=fetch_list,
                                       scope=self._scope,
                                       return_numpy=return_numpy, k=k)
        if isinstance(feeds, dict):
            feeds = [{n: v[i] for n, v in feeds.items()} for i in range(k)]
        return [self.run(fetch_list, feed=f, return_numpy=return_numpy)
                for f in feeds]
