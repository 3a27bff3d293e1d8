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
  * each run has a seed, ``program.random_seed * 1000003 + run
    counter`` (the JAX package's per-run key derivation). Every random op
    (dropout, the initializers, ``nce``) draws counter-keyed Philox bits
    (``core/philox.py``) from it (an int64 device scalar) and its op's
    key, the op's ordinal among the program's random ops
    (``registry.random_op_keys``). The draws differ from threefry's;
  * a ``backward_marker`` (``append_backward``) runs the forward segment
    under ``torch.autograd`` in place of ``jax.value_and_grad``, binds
    every ``P@GRAD``, then runs the optimizer ops without autograd. With
    ``checkpoint=True`` the whole forward runs under
    ``torch.utils.checkpoint`` (non-reentrant) and only the targets, the
    persistables, the ``wrt`` values and what the optimizer ops read
    survive it, as in the JAX package: fetching another forward
    intermediate raises ``KeyError``. A ``calc_gradient_marker``
    (``calc_gradient``) binds ``X@GRAD`` for its inputs, feeds included.

LoD feeds (``LoDTensor``) become flat row buffers zero-padded at the
tail to the next power of two (flag ``lod_bucketing``, on by default),
with ``<name>@LOD``, the sequence lengths as an int32 tensor on the
device, beside them, and ``<name>@MAXLEN``, the next power of two of the
longest length, a host int in the run's static table
(``LowerContext.static_info``), which bounds the RNN scans. Lengths and
the bound flow from an op's LoD input to each output with the same
leading dim (``_propagate_lod``), and a fetched LoD value is trimmed to
its real total. Every reduction drops the pad rows
(``ops/common.lod_valid_mask``).

``run_steps`` (megastep) runs K steps as one dispatch: on the card the
K step bodies are captured once into a CUDA graph (``core/graphs.py``)
over static feed, state, seed and fetch buffers and replayed; on the CPU
the same bodies run in a loop over the same buffers. The K run seeds are
staged into a ``[K]`` buffer with one copy a dispatch, so every random op
inside a graph draws what K ``run()`` calls draw.

With the ``check_nan_inf`` flag on, every float output of every op gets a
NaN/Inf guard, its minimum and maximum on the device (``_Guards``), and
every float fetch one more; a step turns them into one bool tensor,
read with one device-to-host copy a ``run()`` or a ``run_steps``
dispatch, and the first failing op in program order is named with the
JAX package's error text. With the ``debug_nans`` flag on (the JAX
package's ``jax_debug_nans``), every float output of every op is
checked for NaN as the op makes it, and every gradient an op's backward
hands its inputs likewise (``_NanTag``), so the first op that makes a
NaN, forward or backward, raises ``FloatingPointError`` naming it; each
check reads the device, and ``run_steps`` then runs K plain ``run``
calls with no capture, as the JAX flag de-optimises its programs too.
Under the profiler (``profiler.py``) a run is
one ``exe.run(compiled)`` event, a ``run_steps`` dispatch one
``exe.run_steps(compiled)`` event, each op one ``op:<type>`` event (and,
under a device trace, one ``record_function("<type>.<seq>")`` range);
with the profiler off none of this runs.

Host (IO) ops — the wire (``distributed/ops.py``: send, recv,
prefetch, listen_and_serv, ...), the SelectedRows ops and the tensor
arrays — run in ``run`` only, in line with the other ops; ``run_steps``
refuses them. A program that talks to parameter servers gets a round
tag each run (``t<trainer>:i<incarnation>:s<seq>``, the sequence per
program, advanced only when the run succeeds), so a retried send is
applied once. A ``prefetch`` output that the backward marker lists as
a gradient leaf (a distributed embedding's rows) becomes a leaf tensor
where the op makes it. With the monitor armed (``monitor.enable`` or
the ``monitor`` flag), ``run`` reports its step-plan build
(``on_compile``, classified against the step keys this executor has
seen, and ``on_compile_phase("plan_build")``), cache hits and each step
(``on_step``, the card synchronized every ``monitor_sync_every`` steps),
and ``run_steps`` its capture (``on_compile_phase("graph_capture")``)
and each dispatch (``on_megastep``); the NaN guards report their trips
(``on_nan_trip``). With tracing armed each ``run`` and ``run_steps``
is an ``exe.step`` root span, under which the wire's RPC spans nest.
The MFU gauge stays unset: no cost function is
passed until the cost model is ported (ROADMAP.md, queue 1 item 11(b)).
With the flag ``transform`` on, each step is built from the program the
transform tier's pass pipeline rewrote (``transform.passes.
maybe_transform_for_build``, memoized per program version; constant
folding runs on the executor's device), while every key stays the
caller's program. Under AMP (``amp.amp_guard``) the matmul-class
lowerings run in bfloat16; ``run_steps`` keys its CUDA graphs by the
AMP state. Gradient accumulation is a
``ParallelExecutor`` option, as in the JAX package: ``_build(...,
accum_steps=k)`` runs the forward and backward once a microbatch and the
optimizer ops once (``_lower_with_grad_accum``), and ``ParallelExecutor``
threads its mesh into every lowering's ``ctx.mesh`` (``_mesh``).

Feeds normalize through a ``FeedPlanCache`` (the JAX package's
zero-copy host feed path): a repeated feed
signature skips the derivation, and a frozen (``writeable=False``) dense
numpy feed is committed once to a tensor on the executor's device and
reused while it is the same object.
"""

import collections
import contextlib
import threading
import time
import uuid
import weakref

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

from .. import flags
from .. import profiler as _prof
from ..amp import amp_enabled
from ..monitor import runtime as _mon
from ..trace import runtime as _trace
from . import graphs as _graphs
from . import registry
from .enforce import EnforceError, op_error
from .lod import LoDTensor
from .places import CUDAPlace, Place
from .program import Variable, default_main_program
from .scope import global_scope, to_tensor, torch_dtype
from .selected_rows import SelectedRows

__all__ = ["Executor", "FeedPlanCache", "as_numpy"]

_is_host_op = registry.is_host_op

def _whole(value):
    """A scope value as a plain run reads it: a ``ParallelExecutor``'s
    DTensor or held block (``parallel/blocks.Held``) gathered whole, a
    collective every rank of its mesh makes; any other value as it is."""
    if isinstance(value, torch.Tensor) and hasattr(value, "full_tensor"):
        from ..parallel.collective import global_value
        return global_value(value)
    return value


def as_numpy(value):
    """A fetched value as a numpy array; a SelectedRows passes through,
    as in the JAX package. A bfloat16 value (an AMP activation) widens to
    float32 exactly: numpy holds no bfloat16."""
    if isinstance(value, SelectedRows):
        return value
    if isinstance(value, (list, tuple)):
        return [as_numpy(v) for v in value]
    if isinstance(value, torch.Tensor):
        value = _whole(value)
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _is_lod(value):
    """A LoDTensor, the port's or the JAX package's."""
    return isinstance(value, LoDTensor) or \
        hasattr(value, "recursive_sequence_lengths")


def _normalize_feeds(feed, plan_cache=None, commit=True, accum_steps=1):
    """Feeds as host values -> (``{name: array or tensor}``, static_info),
    the JAX package's ``_normalize_feeds``: a LoDTensor with a LoD
    becomes its flat rows, zero-padded at the tail to the next power of
    two under the ``lod_bucketing`` flag, and ``<name>@LOD``, its
    innermost lengths (int32); static_info gets ``<name>@MAXLEN``, the
    next power of two of the longest length. A LoDTensor without a LoD
    is its data; a dense value passes through.

    ``plan_cache`` (a ``FeedPlanCache``) skips the derivation on a feed
    signature it has seen, and commits a frozen dense numpy feed to a
    tensor on its device once (``commit=False`` leaves every value on
    the host).

    ``accum_steps`` > 1 (gradient accumulation): a LoD feed is split on
    the host into that many microbatches of equal sequence count, as the
    JAX package splits it: the flat rows become [k, bucket, ...] (every
    microbatch zero-padded to one shared bucketed total), the lengths
    [k, n_seqs/k], ``<name>@ACCUM_TOKENS`` the true token total of each
    microbatch (the weights of token-normalized losses), and static_info
    marks the feed ``<name>@ACCUM_LOD``."""
    if plan_cache is not None:
        return plan_cache.normalize(feed, commit=commit,
                                    accum_steps=accum_steps)
    return _apply_feed_plan(_derive_feed_plan(feed, accum_steps), feed,
                            None)


class _FeedPlan:
    """One cached ``_normalize_feeds`` derivation: the per-feed transform
    instructions, the static_info, the derived length vectors (valid
    because the LoD lengths are part of the cache key), and any
    committed device buffers."""

    __slots__ = ("instrs", "static_info", "lods", "buffers")

    def __init__(self):
        self.instrs = []       # (kind, feed_name, *params)
        self.static_info = {}
        self.lods = {}         # <name>@LOD arrays
        self.buffers = {}      # feed_name -> (source object, tensor)


def _derive_feed_plan(feed, accum_steps=1):
    """The full normalization derivation (the cache's miss path); see
    ``_normalize_feeds`` for what each instruction does."""
    plan = _FeedPlan()
    bucket_on = bool(flags.get_flag("lod_bucketing"))
    k_acc = max(1, int(accum_steps))
    for name, v in feed.items():
        if not _is_lod(v):
            plan.instrs.append(("dense", name))
        elif v.lod:
            lengths = np.asarray(v.recursive_sequence_lengths()[-1],
                                 np.int32)
            mx = max(1, int(lengths.max(initial=1)))
            plan.static_info[name + "@MAXLEN"] = 1 << (mx - 1).bit_length()
            if k_acc > 1:
                _plan_lod_accum(plan, name, lengths, k_acc, bucket_on)
                continue
            total = int(np.shape(v.data)[0])
            bucket = 1 << max(0, (total - 1).bit_length())
            plan.lods[name + "@LOD"] = lengths
            plan.instrs.append(("lod_pad", name, bucket
                                if bucket_on and bucket > total else None))
        else:
            plan.instrs.append(("lod_data", name))
    return plan


def _plan_lod_accum(plan, name, lengths, k_acc, bucket_on):
    """The accumulation split of one LoD feed (see ``_normalize_feeds``)."""
    if len(lengths) % k_acc:
        raise ValueError(
            "feed %r has %d sequences, not divisible into %d "
            "accumulation microbatches" % (name, len(lengths), k_acc))
    per = len(lengths) // k_acc
    offs = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    totals = [int(offs[(g + 1) * per] - offs[g * per])
              for g in range(k_acc)]
    bucket = max(1, max(totals))
    if bucket_on:
        bucket = 1 << max(0, int(bucket - 1).bit_length())
    plan.lods[name + "@LOD"] = lengths.reshape(k_acc, per)
    plan.lods[name + "@ACCUM_TOKENS"] = np.asarray(totals, np.float32)
    plan.static_info[name + "@ACCUM_LOD"] = True
    plan.instrs.append(("lod_accum", name, bucket, offs, per, totals))


def _apply_feed_plan(plan, feed, cache):
    """A plan's transforms over this call's values."""
    arrays = {}
    for instr in plan.instrs:
        kind, name = instr[0], instr[1]
        v = feed[name]
        if kind == "dense":
            dev = cache._committed(plan, name, v) \
                if cache is not None else None
            arrays[name] = v if dev is None else dev
        elif kind == "lod_data":
            arrays[name] = np.asarray(v.data)
        elif kind == "lod_accum":
            _, _, bucket, offs, per, totals = instr
            arr = np.asarray(v.data)
            stacked = np.zeros((len(totals), bucket) + arr.shape[1:],
                               arr.dtype)
            for g in range(len(totals)):
                stacked[g, :totals[g]] = \
                    arr[offs[g * per]:offs[(g + 1) * per]]
            arrays[name] = stacked
        else:                   # lod_pad
            arr, pad_to = np.asarray(v.data), instr[2]
            if pad_to is not None:
                arr = np.concatenate([arr, np.zeros(
                    (pad_to - arr.shape[0],) + arr.shape[1:], arr.dtype)])
            arrays[name] = arr
    arrays.update(plan.lods)
    return arrays, dict(plan.static_info)


class FeedPlanCache:
    """The JAX package's zero-copy host feed path: normalization plans
    cached by feed signature (names, shapes, dtypes, LoD lengths, the
    bucketing flag), least recently used first out past ``capacity``,
    and committed device buffers.

    On a plan hit only the per-call work runs. A dense numpy feed with
    ``writeable=False`` is committed once to a tensor on
    ``device_fn()``'s device and reused while it is the SAME object:
    freezing is the caller's contract that its contents are final
    (re-enabling writeable, mutating and freezing again serves the stale
    buffer, as with any zero-copy API). Writeable feeds are never
    committed, so an in-place mutation between calls is honored; a value
    that is a tensor already passes through.

    ``hits``, ``misses`` and ``buffer_reuses`` count for tests; the
    monitor's ``ptpu_feed_normalizations_total`` ticks for each
    derivation and ``ptpu_feed_plan_hits_total`` for each skipped one."""

    def __init__(self, capacity=64, device_fn=None):
        self._plans = collections.OrderedDict()
        self._lock = threading.Lock()
        self._capacity = int(capacity)
        self._device_fn = device_fn
        self.hits = 0
        self.misses = 0
        self.buffer_reuses = 0

    def normalize(self, feed, commit=True, accum_steps=1):
        key = (int(accum_steps), self._key(feed))
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.hits += 1
        plan_hit = plan is not None
        if plan is None:
            plan = _derive_feed_plan(feed, accum_steps)
            with self._lock:
                self.misses += 1
                self._plans[key] = plan
                while len(self._plans) > self._capacity:
                    self._plans.popitem(last=False)
        _mon.on_feed_plan(plan_hit)
        return _apply_feed_plan(plan, feed, self if commit else None)

    @staticmethod
    def _key(feed):
        # dtype objects, not their names: str(np.dtype) costs more than
        # the derivation a hit skips
        items = []
        for name, v in feed.items():
            if _is_lod(v):
                data = np.asarray(v.data)
                items.append((name, "lod" if v.lod else "lodd", data.shape,
                              data.dtype, tuple(
                                  v.recursive_sequence_lengths()[-1])
                              if v.lod else None))
            else:
                dt = getattr(v, "dtype", None)
                if dt is None:
                    v = np.asarray(v)
                    dt = v.dtype
                items.append((name, "d", tuple(v.shape), dt))
        return (bool(flags.get_flag("lod_bucketing")), tuple(sorted(
            items, key=lambda item: item[0])))

    def _committed(self, plan, name, src):
        """The device tensor of a frozen dense numpy feed, reused by
        identity; None when the value is not committable (writeable, not
        numpy, or no device)."""
        if not isinstance(src, np.ndarray) or src.flags.writeable \
                or self._device_fn is None:
            return None
        ent = plan.buffers.get(name)
        if ent is not None and ent[0] is src:
            with self._lock:
                self.buffer_reuses += 1
            return ent[1]
        # a copy: the tensor must not alias the caller's array
        dev = to_tensor(np.array(src), self._device_fn())
        plan.buffers[name] = (src, dev)
        return dev

    def clear(self):
        with self._lock:
            self._plans.clear()


def _trim_fetches(fetch_names, fetches, fetch_lods):
    """Fetched LoD values cut to their real total, the sum of their
    lengths (read on the host): the bucket's pad rows go."""
    out = []
    for n, v in zip(fetch_names, fetches):
        lod = fetch_lods.get(n)
        if lod is not None and v.dim() >= 1:
            total = int(lod.sum())
            if v.shape[0] > total:
                v = v[:total]
        out.append(v)
    return out


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
        # op -> {(shape, dtype): (values attr, tensor)}: the temporary
        # constants (assign_value) made on this executor's device
        self.constants = weakref.WeakKeyDictionary()
        self.stats = {"megastep_dispatches": 0, "graph_captures": 0,
                      "graph_replays": 0, "guard_reads": 0}
        # normalization plans of run()'s and run_steps' list feeds; a
        # frozen feed's tensor is committed on this executor's device
        self._feed_plans = FeedPlanCache(device_fn=lambda: self.device)
        # the step keys run() has built a step for (the monitor's
        # compile classification: a key seen before is a cache hit)
        self._step_keys = set()
        # per-PROGRAM round counters of the send tags (retry
        # idempotency): another host-op program run on this executor
        # (an eval recv) must not advance a training program's round
        # sequence. Entry: program -> [seq, program nonce].
        self._run_seqs = weakref.WeakKeyDictionary()
        # incarnation id: a RESTARTED trainer's seq restarts at 0 —
        # servers evict pending grads of the dead incarnation by it.
        # The 16-hex-digit time_ns prefix ORDERS incarnations, so a
        # server drops a dead incarnation's straggler instead of letting
        # it evict the live replacement's pending state; the nonce
        # suffix breaks ties.
        self._incarnation = "%016x" % time.time_ns() + uuid.uuid4().hex[:8]

    def _reincarnate(self, min_epoch):
        """A pserver judged our incarnation stale (possible after an
        elastic reschedule onto a host whose clock is behind the old
        one): mint a new incarnation with an epoch past the server's
        max, so retried sends are accepted instead of deadlocking."""
        epoch = max(time.time_ns(), int(min_epoch) + 1)
        self._incarnation = "%016x" % epoch + uuid.uuid4().hex[:8]
        return self._incarnation

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        trc = _trace._TRACER
        if trc is None:
            return self._run_impl(program, feed, fetch_list, scope,
                                  return_numpy, use_program_cache)
        # distributed-trace root span per step: RPC verb spans issued
        # while this step runs (pserver sends/gets, prefetches) nest
        # under it, making the step the unit of the fleet timeline
        with trc.span("exe.step"):
            return self._run_impl(program, feed, fetch_list, scope,
                                  return_numpy, use_program_cache)

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy,
                  use_program_cache):
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = tuple(
            f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or []))
        arrays, static_info = _normalize_feeds(feed or {},
                                               plan_cache=self._feed_plans)
        feeds = {k: self._feed_tensor(k, v) for k, v in arrays.items()}
        persistable = [v.name for v in program.global_block().vars.values()
                       if v.persistable]
        state = {}
        for n in persistable:
            v = scope.find_var(n)
            if v is not None:
                state[n] = to_tensor(_whole(v), self.device)
        check_nan = bool(flags.get_flag("check_nan_inf"))
        host = any(_is_host_op(op.type)
                   for op in program.global_block().ops)
        mon_on = _mon.enabled()
        t_build = time.perf_counter() if mon_on else 0.0
        step = self._build(program, tuple(sorted(feeds)), fetch_names,
                           tuple(sorted(state)), static_info,
                           check_nan=check_nan)
        key = None
        if mon_on and not host:
            key = self._monitor_build(program, arrays, feeds, fetch_names,
                                      state, static_info, check_nan,
                                      use_program_cache,
                                      time.perf_counter() - t_build)
        seed = self._seed(program, self._rng_counter)
        self._rng_counter += 1
        seed_t = []

        def seed_fn():
            # made at the first draw: a run without dropout makes none
            if not seed_t:
                seed_t.append(torch.full((), seed, dtype=torch.int64,
                                         device=self.device))
            return seed_t[0]

        round_ = None
        if host:
            # the send-tag sequence advances only on SUCCESS and is
            # per-program: a retried step reuses its tag, so the server
            # replaces (not doubles) the pending grad. The program nonce
            # keeps two programs' tags distinct. seq/incarnation travel
            # as arguments, not executor state: a shared Executor driven
            # from two threads must not cross-tag rounds
            entry = self._run_seqs.get(program)
            if entry is None:
                entry = self._run_seqs.setdefault(
                    program, [0, uuid.uuid4().hex[:4]])
            round_ = (entry[0], self._incarnation + entry[1])
        if mon_on:
            t0 = time.perf_counter()
            timer = _mon.step_timer(self)
            # with the profiler on every step ends synchronized anyway
            do_sync = timer.begin(t0) or _prof._enabled
        with _tf32_off(), _prof.run_event("exe.run(compiled)", self.device):
            out = step(state, feeds, seed_fn, round_)
        if host:
            entry[0] += 1
        if mon_on:
            self._monitor_step(key, arrays, timer, t0, do_sync,
                               "eager" if host else "exe")
        fetches, new_state, fetch_lods, guards = out
        for n, v in new_state.items():
            scope.set(n, v)
        fetches = _trim_fetches(fetch_names, fetches, fetch_lods)
        if guards is not None:
            _raise_first_nan(guards[0], self._read_guards(guards[1])[None])
        if return_numpy:
            return [as_numpy(v) for v in fetches]
        return list(fetches)

    def _monitor_build(self, program, arrays, feeds, fetch_names, state,
                       static_info, check_nan, use_program_cache, dt):
        """The monitor's compile hooks for one ``run()``: a step key
        this executor has not built before is a compile (classified by
        ``on_compile`` against the program's history, its build time an
        ``on_compile_phase("plan_build")``), a known one a cache hit.
        ``use_program_cache=False`` is a deliberate bypass: not counted
        as a compile. Returns the key."""
        feed_sig = tuple(sorted((n,) + _signature(v)
                                for n, v in feeds.items()))
        key = (program, program._version, feed_sig, fetch_names,
               tuple(sorted(state)), check_nan,
               bool(flags.get_flag("fuse_conv_bn")),
               tuple(sorted(static_info.items())))
        if key in self._step_keys:
            _mon.on_cache_hit()
        elif use_program_cache:
            self._step_keys.add(key)
            _mon.on_compile(program, key, feed_sig,
                            tokens=_mon.tokens_in_feeds(arrays))
            _mon.on_compile_phase("plan_build", dt)
        return key

    def _monitor_step(self, key, arrays, timer, t0, do_sync,
                      executor="exe", k=None):
        """The monitor's step hook for one ``run()`` (or, with ``k``, one
        ``run_steps`` dispatch of k steps): a synchronized step reports
        its window's average latency, the others their dispatch time."""
        if do_sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        dt = timer.end_synced(now, t0) if do_sync else now - t0
        kw = dict(feed_bytes=_mon.feed_nbytes(arrays, self.device),
                  tokens=_mon.tokens_in_feeds(arrays), executor=executor,
                  synced=do_sync)
        if k is None:
            _mon.on_step(key, dt, **kw)
        else:
            _mon.on_megastep(key, dt, k, **kw)

    @staticmethod
    def _seed(program, counter):
        """The run seed of the run at ``counter``."""
        return program.random_seed * 1000003 + counter

    def _read_guards(self, guards):
        """The one device-to-host copy of a run's or a dispatch's stacked
        NaN guards, counted in ``stats["guard_reads"]``."""
        self.stats["guard_reads"] += 1
        return guards.cpu().numpy()

    # -- megastep -------------------------------------------------------
    def run_steps(self, program=None, feeds=None, fetch_list=None,
                  scope=None, return_numpy=True, k=None,
                  use_program_cache=True):
        """K logical training steps in one dispatch (the megastep path),
        the counterpart of the JAX package's ``run_steps``: numerically
        K sequential ``run()`` calls on the same feeds, with the RNG
        counter advanced by K.

        ``feeds``: a LIST of K per-step feed dicts (one signature: LoD
        feeds must agree in bucketed total, sequence count and
        ``@MAXLEN``), or ONE pre-stacked ``[k, ...]`` dict together with
        ``k`` (dense feeds only). Returns K
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
        holds. The K run seeds go into a ``[K]`` buffer the same way, so
        every random op draws what K ``run()`` calls draw. With the
        ``check_nan_inf`` flag on, the K steps' guards fill a ``[K,
        n_guards]`` buffer, read once after the dispatch; a failure names
        its logical step, the state having advanced all K steps (the JAX
        package's semantics). Refused: programs with host (IO) ops and
        steps that make new persistables (startup programs: ``run()``
        those)."""
        feeds, k = self._check_run_steps_args(feeds, k)
        if flags.get_flag("debug_nans"):
            # every op reads the device to check its outputs: K plain
            # runs, no capture
            if isinstance(feeds, dict):
                feeds = [{n: v[i] for n, v in feeds.items()}
                         for i in range(k)]
            return [self.run(program, feed=f, fetch_list=fetch_list,
                             scope=scope, return_numpy=return_numpy,
                             use_program_cache=use_program_cache)
                    for f in feeds]
        trc = _trace._TRACER
        if trc is None:
            return self._run_steps_impl(program, feeds, fetch_list, scope,
                                        return_numpy, k, use_program_cache)
        with trc.span("exe.step", k=k):
            return self._run_steps_impl(program, feeds, fetch_list, scope,
                                        return_numpy, k, use_program_cache)

    def _run_steps_impl(self, program, feeds, fetch_list, scope,
                        return_numpy, k, use_program_cache):
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = tuple(
            f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or []))
        if any(_is_host_op(op.type) for blk in program.blocks
               for op in blk.ops):
            # the JAX package's message; a SelectedRows op's row count
            # changes from step to step, which a CUDA graph cannot hold
            raise NotImplementedError(
                "run_steps cannot fuse programs with host (IO) ops — "
                "send/recv/prefetch must hit the wire once per step; "
                "use run() per step")
        staged, feed_sig, static_info = _stack_feeds(feeds, k,
                                                     self._feed_plans)
        state_sig = []
        for v in program.global_block().vars.values():
            value = scope.find_var(v.name) if v.persistable else None
            if value is not None:
                state_sig.append((v.name,) + _signature(value))
        state_sig = tuple(sorted(state_sig))
        check_nan = bool(flags.get_flag("check_nan_inf"))
        # what picks the kernels a capture holds is part of the key too:
        # the conv fusion flag, the AMP state, the armed transform and
        # cuDNN's algorithm switches
        key = (program, program._version, feed_sig,
               tuple(sorted(static_info.items())), fetch_names,
               state_sig, k, check_nan, bool(flags.get_flag("fuse_conv_bn")),
               amp_enabled(), bool(flags.get_flag("transform")),
               flags.get_flag("transform_passes"),
               torch.backends.cudnn.deterministic,
               torch.backends.cudnn.benchmark)
        mega = self._megasteps.get(key) if use_program_cache else None
        mon_on = _mon.enabled()
        if mega is None:
            t_build = time.perf_counter()
            step = self._build(program, tuple(n for n, _, _ in feed_sig),
                               fetch_names, tuple(n for n, _, _ in
                                                  state_sig), static_info,
                               check_nan=check_nan)
            mega = _Megastep(self.device, step, feed_sig, state_sig, k,
                             "Executor.run_steps(k=%d)" % k)
            if use_program_cache:
                self._megasteps[key] = mega
                if mon_on:
                    _mon.on_compile(program, key, feed_sig,
                                    tokens=_mon.tokens_in_feeds(staged))
                    _mon.on_compile_phase("plan_build",
                                          time.perf_counter() - t_build)
        elif mon_on:
            _mon.on_cache_hit()
        base = self._rng_counter
        self._rng_counter += k
        window = max(1, int(flags.get_flag("megastep_inflight")))
        while len(self._inflight) >= window:
            done = self._inflight.pop(0)
            if done is not None:
                done.synchronize()
        mega.stage(staged, [self._seed(program, base + i)
                            for i in range(k)])
        mega.bind(scope)
        if mon_on:
            timer = _mon.step_timer(self)
        with _tf32_off(), _prof.run_event("exe.run_steps(compiled)",
                                          self.device):
            if self.device.type == "cuda":
                if mega.graph is None:
                    t_cap = time.perf_counter()
                    mega.capture()
                    self.stats["graph_captures"] += 1
                    if mon_on:
                        _mon.on_compile_phase(
                            "graph_capture", time.perf_counter() - t_cap)
                t0 = time.perf_counter()
                do_sync = mon_on and timer.begin(t0)
                mega.graph.replay()
                self.stats["graph_replays"] += 1
            else:
                t0 = time.perf_counter()
                do_sync = mon_on and timer.begin(t0)
                mega.run()
        self.stats["megastep_dispatches"] += 1
        if mon_on:
            self._monitor_step(key, staged, timer, t0, do_sync, k=k)
        if mega.guards is not None:
            _raise_first_nan(mega.guard_names,
                             self._read_guards(mega.guards), steps=k)
        outs = [b.clone() for b in mega.fetches]
        if mega.fetch_lods:
            # each step's LoD fetches cut to that step's real total (a
            # host read, as run() makes)
            steps = [_trim_fetches(fetch_names, [o[i] for o in outs],
                                   {n: b[i] for n, b in
                                    mega.fetch_lods.items()})
                     for i in range(k)]
        else:
            steps = [[o[i] for o in outs] for i in range(k)]
        if return_numpy:
            return [[as_numpy(v) for v in step] for step in steps]
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._inflight.append(event)
        else:
            self._inflight.append(None)     # the CPU has finished already
        return steps

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
        """A normalized feed (``_normalize_feeds``) as the step sees it:
        a tensor on the executor's device, 64-bit types narrowed."""
        return to_tensor(value, self.device)

    # ------------------------------------------------------------------
    def _build(self, program, feed_names, fetch_names, state_keys,
               static_info=None, check_nan=False, accum_steps=1,
               accum_loss_norm=None):
        """The step function ``step(state, feeds, seed, round_=None) ->
        (fetches, new_state, fetch_lods, guards)`` for one program, as
        the JAX package's ``_build`` returns it (there it is traced and
        jitted; here it runs the lowerings eagerly each call).
        ``seed()`` hands the random ops the step's seed, an int64 device
        scalar; ``round_`` the (sequence, incarnation) of the send tags
        of a program with host ops.
        ``static_info`` is the feeds' static table (``@MAXLEN``); each
        step works on a copy, which the lowerings extend.
        ``fetch_lods`` holds the lengths of each fetch that carries
        them. ``guards`` is None, or with ``check_nan`` (the guard
        names, one bool device tensor of the step's NaN guards).

        ``accum_steps`` > 1: gradient accumulation (``ParallelExecutor``
        asks for it): every feed arrives stacked [k, ...] (dense feeds
        split by the caller, LoD feeds by ``_normalize_feeds``), the
        forward and backward run once a microbatch and the optimizer ops
        once (``_lower_with_grad_accum``)."""
        # the armed transform (flag ``transform``): the step is built
        # from the rewritten clone, memoized on the caller's program
        from ..transform.passes import maybe_transform_for_build
        program = maybe_transform_for_build(program, fetch_names,
                                            self.device)
        static_info = dict(static_info or {})
        block = program.global_block()
        ops = list(block.ops)
        persistable_names = {v.name for v in block.vars.values()
                             if v.persistable}
        read_names = set()
        for blk in program.blocks:
            read_names.update(n for op in blk.ops for n in op.input_names)
        read_names.update(fetch_names)
        read_names.update(persistable_names)
        rng_keys = registry.random_op_keys(block)
        bwd_idx = None
        for i, op in enumerate(ops):
            if op.type in ("backward_marker", "calc_gradient_marker"):
                bwd_idx = i
                break
        if accum_steps > 1:
            if bwd_idx is None:
                raise ValueError(
                    "gradient_accumulation_steps=%d needs a grad marker "
                    "(append_backward/minimize) in the program"
                    % accum_steps)
            if ops[bwd_idx].type != "backward_marker":
                raise NotImplementedError(
                    "gradient accumulation supports loss training "
                    "(append_backward) only, not calc_gradient")
        mesh = getattr(self, "_mesh", None)

        def step(state, feeds, seed, round_=None):
            env = {}
            env.update(state)
            env.update(feeds)
            guards = _Guards() if check_nan else None
            ctx = registry.LowerContext(env, self.device,
                                        executor=self, block=block,
                                        mesh=mesh,
                                        fetch_names=fetch_names,
                                        read_names=read_names,
                                        seed_fn=seed, rng_keys=rng_keys,
                                        static_info=dict(static_info),
                                        guards=guards)
            ctx.debug_nans = bool(flags.get_flag("debug_nans"))
            # the send-tag round of a program that talks to pservers
            ctx.run_seq, ctx.incarnation = round_ or (None,
                                                      self._incarnation)
            if accum_steps > 1:
                self._lower_with_grad_accum(ctx, ops, bwd_idx, feeds,
                                            accum_steps, persistable_names,
                                            accum_loss_norm)
            elif bwd_idx is None:
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
            fetch_lods = {n: env[n + "@LOD"] for n in fetch_names
                          if env.get(n + "@LOD") is not None}
            if guards is not None:
                for n, v in zip(fetch_names, fetches):
                    guards.record_fetch(n, v, fetch_lods.get(n))
                guards = guards.stacked(self.device)
            return fetches, new_state, fetch_lods, guards

        return step

    @staticmethod
    def _parse_marker(marker):
        """A grad marker's (wrt names, target names)."""
        if marker.type == "backward_marker":
            return (marker.attr("param_names") or [],
                    [marker.attr("loss_name")])
        return (marker.attr("input_names") or [],
                marker.attr("target_names") or [])

    @staticmethod
    def _lower_with_grad(ctx, ops, bwd_idx):
        """Run the forward ops with autograd, bind ``X@GRAD``, then run
        the remaining (optimizer) ops without it.

        The ``wrt`` values (parameters, or any input of a
        ``calc_gradient``, feeds included) become fresh leaf tensors
        (detached views: the optimizer lowerings write new tensors,
        never into these, so nothing the graph holds changes under it).
        The objective is the sum of the targets, each summed when not a
        scalar, as the JAX package's ``value_and_grad`` objective. A
        value the targets do not reach gets zeros, as ``jax.grad``
        gives; ``loss@GRAD`` is ones.

        ``append_backward(..., checkpoint=True)`` runs the WHOLE forward
        under a non-reentrant ``torch.utils.checkpoint``: only the step
        inputs are saved and the forward runs again in the backward.
        Only the targets, the persistables, the ``wrt`` values and what
        the post-marker ops read leave it (the JAX package's rule), so
        fetching another forward intermediate raises ``KeyError``."""
        marker = ops[bwd_idx]
        wrt_names, target_names = Executor._parse_marker(marker)
        leaves = {n: ctx.env[n].detach().requires_grad_(True)
                  for n in wrt_names if n in ctx.env}
        ctx.env.update(leaves)
        # wrt values a host op makes (the rows a distributed embedding's
        # prefetch brings) become leaves where they are made, before
        # anything reads them, as the JAX package runs such ops before
        # its gradient trace; an intermediate a compute op makes stays
        # in the graph (the JAX package binds no gradient for it)
        made = [n for n in wrt_names if n not in leaves]
        use_ckpt = marker.type == "backward_marker" and \
            bool(marker.attr("checkpoint"))
        with torch.enable_grad():
            if use_ckpt:
                names = list(leaves)
                total = Executor._checkpointed_forward(
                    ctx, ops, bwd_idx, names, target_names,
                    [leaves[n] for n in names])
            else:
                for op in ops[:bwd_idx]:
                    _lower_op(ctx, op)
                    if not made or not _is_host_op(op.type):
                        continue
                    for n in made:
                        if n not in leaves and n in op.output_names:
                            leaves[n] = ctx.env[n].detach() \
                                .requires_grad_(True)
                            ctx.env[n] = leaves[n]
                total = _objective(ctx.env, target_names)
            names = list(leaves)
            # a recompute in the backward runs guarded ops again: they
            # were guarded once, in the forward
            with (ctx.guards.paused() if ctx.guards is not None
                  else contextlib.nullcontext()):
                grads = torch.autograd.grad(
                    total, [leaves[n] for n in names],
                    allow_unused=True) if names else ()
        if marker.type == "backward_marker":
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

    @staticmethod
    def _lower_with_grad_accum(ctx, ops, bwd_idx, feeds, accum_steps,
                               persistable_names, loss_norm=None):
        """Gradient accumulation, the JAX package's
        ``_lower_with_grad_accum`` (a ``lax.scan`` there, a loop here):
        each feed arrives [k, ...]; microbatch i runs the forward and
        backward on row i of every feed, persistable state streams from
        one microbatch to the next (batch-norm counters), and the grads
        and the loss are weighted sums over microbatches. The weights
        follow ``loss_norm``: 1/k for None and ``"sequence"``, the
        microbatches' true token totals over their sum for ``"token"``
        / ``"token:<feed>"`` (``<feed>@ACCUM_TOKENS``). The post-marker
        (optimizer) ops read forward values from microbatch 0 (the JAX
        package's probe), a counter they read advanced once a step.
        Microbatch i draws with the run's seed times 4099 plus i, its
        own stream."""
        marker = ops[bwd_idx]
        wrt_names, target_names = Executor._parse_marker(marker)
        base_env = dict(ctx.env)
        wrt = {n: base_env[n] for n in wrt_names if n in base_env}
        names = list(wrt)
        use_ckpt = bool(marker.attr("checkpoint"))
        post_in = {n for o in ops[bwd_idx + 1:] for n in o.input_names}
        k = int(accum_steps)
        _TOK = "@ACCUM_TOKENS"
        chunked = {n: base_env[n] for n in feeds if not n.endswith(_TOK)}
        for n, v in chunked.items():
            if v.dim() < 1 or v.shape[0] != k:
                raise ValueError(
                    "feed %r is not split into %d accumulation "
                    "microbatches (shape %s)" % (n, k, tuple(v.shape)))
        pstate = {n: v for n, v in base_env.items()
                  if n in persistable_names and n not in wrt}
        tok_arrays = {n[:-len(_TOK)]: base_env[n]
                      for n in feeds if n.endswith(_TOK)}
        norm = loss_norm or "sequence"
        if norm.startswith("token") and not tok_arrays:
            raise ValueError(
                "gradient_accumulation_loss_norm=%r: this program has no "
                "ragged LoD feeds, so per-microbatch token counts are "
                "unavailable; drop the knob (equal chunks weight equally) "
                "or feed the sequence data as LoDTensor" % (loss_norm,))
        if norm.startswith("token"):
            if ":" in norm:
                src = norm.split(":", 1)[1]
                if src not in tok_arrays:
                    raise ValueError(
                        "gradient_accumulation_loss_norm=%r: %r is not "
                        "a ragged LoD feed of this program (have %s)"
                        % (loss_norm, src, sorted(tok_arrays)))
                tok = tok_arrays[src]
            else:
                tok = next(iter(tok_arrays.values()))
            weights = [tok[i] / torch.sum(tok) for i in range(k)]
        else:
            weights = [1.0 / k] * k
        loss_name = target_names[0]
        gsum, lsum, probe = {}, 0.0, None
        for i in range(k):
            env = dict(base_env)
            env.update(pstate)
            env.update({n: c[i] for n, c in chunked.items()})
            seed_i = (lambda i=i: ctx._seed_fn() * 4099 + i)
            mctx = registry.LowerContext(
                env, ctx.device, is_test=ctx.is_test,
                executor=ctx.executor, block=ctx.block, mesh=ctx.mesh,
                fetch_names=ctx.fetch_names, read_names=ctx._read_names,
                seed_fn=seed_i, rng_keys=ctx.rng_keys,
                static_info=ctx.static_info, guards=ctx.guards)
            leaves = {n: wrt[n].detach().requires_grad_(True)
                      for n in names}
            env.update(leaves)
            with torch.enable_grad():
                if use_ckpt:
                    total = Executor._checkpointed_forward(
                        mctx, ops, bwd_idx, names, target_names,
                        [leaves[n] for n in names])
                else:
                    for op in ops[:bwd_idx]:
                        _lower_op(mctx, op)
                    total = env[loss_name]
                if total.dim() != 0:
                    raise ValueError(
                        "gradient accumulation requires a SCALAR "
                        "(mean-reduced) loss; %r has shape %s — "
                        "accumulating a per-element loss would silently "
                        "rescale gradients by 1/%d"
                        % (loss_name, tuple(total.shape), k))
                with (ctx.guards.paused() if ctx.guards is not None
                      else contextlib.nullcontext()):
                    grads = torch.autograd.grad(
                        total, [leaves[n] for n in names],
                        allow_unused=True) if names else ()
            w = weights[i]
            for n, g in zip(names, grads):
                if g is None:
                    g = torch.zeros_like(leaves[n])
                gsum[n] = g * w if n not in gsum else gsum[n] + g * w
            lsum = lsum + total.detach() * w
            pstate = {n: env.get(n, v).detach() for n, v in pstate.items()}
            if probe is None:
                probe = {n: (v.detach() if isinstance(v, torch.Tensor)
                             else v) for n, v in env.items()}
        ctx.env.update(pstate)
        # the post-marker ops' forward inputs (a computed learning rate)
        # and the counters their chain advances come from microbatch 0
        producers = {}
        for op in ops[:bwd_idx]:
            for n in op.output_names:
                producers[n] = op
        frontier = [n for n in post_in
                    if n in producers and n in probe and n not in base_env]
        seen, stack, counters = set(), list(frontier), set()
        while stack:
            op = producers.get(stack.pop())
            if op is None or id(op) in seen:
                continue
            seen.add(id(op))
            counters.update(n for n in op.output_names
                            if n in persistable_names)
            stack.extend(op.input_names)
        for n in list(frontier) + [n for n in counters if n in probe]:
            ctx.env[n] = probe[n]
        ctx.env[loss_name] = lsum
        ctx.env[loss_name + "@GRAD"] = torch.ones_like(lsum)
        for n in names:
            ctx.env[n + "@GRAD"] = gsum[n]
            ctx.env[n] = wrt[n].detach()
        with torch.no_grad():
            for op in ops[bwd_idx + 1:]:
                _lower_op(ctx, op)

    @staticmethod
    def _checkpointed_forward(ctx, ops, bwd_idx, names, target_names,
                              vals):
        """The forward ops under one non-reentrant checkpoint: returns
        the objective and leaves in ``ctx.env`` only what survives."""
        block = ctx.block
        keep = {v.name for v in block.vars.values() if v.persistable}
        keep.update(target_names)
        keep.update(names)
        keep.update(n for op in ops[bwd_idx + 1:] for n in op.input_names)
        base_env = dict(ctx.env)
        keep.update(n for n in base_env if n.endswith("@LOD"))

        def forward(*leaf_vals):
            env = dict(base_env)
            env.update(zip(names, leaf_vals))
            fctx = ctx.sub_context(env, block, guarded=True)
            for op in ops[:bwd_idx]:
                _lower_op(fctx, op)
            return (_objective(env, target_names),
                    {n: v for n, v in env.items()
                     if n in keep or n.endswith("@LOD")})

        total, kept = _checkpoint.checkpoint(
            forward, *vals, use_reentrant=False, preserve_rng_state=False)
        ctx.env.update(kept)
        return total


def _objective(env, target_names):
    """The sum of the targets, each summed when not a scalar."""
    total = 0.0
    for tn in target_names:
        t = env[tn]
        total = total + (t if t.dim() == 0 else t.sum())
    return total


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


def _stack_feeds(feeds, k, plan_cache=None):
    """(``{name: [k, ...] host or device tensor}``, the per-step feed
    signature ``((name, shape, dtype), ...)``, the static table) from K
    per-step feed dicts, each normalized as ``run()`` normalizes it (LoD
    feeds and their ``@LOD`` lengths included, through ``plan_cache``),
    or from one pre-stacked dict of dense feeds."""
    if isinstance(feeds, dict):
        stacked = {}
        for name, value in feeds.items():
            if _is_lod(value):
                # the JAX package's message
                raise ValueError(
                    "LoD feed %r cannot ride the pre-stacked [k, ...] "
                    "megastep staging path: its flat/bucketed form and "
                    "@LOD/@MAXLEN static_info must be derived per step by "
                    "the executor's own normalization. Pass run_steps a "
                    "LIST of per-step feed dicts instead (the host path "
                    "normalizes and stacks LoD feeds correctly)." % name)
            t = value if isinstance(value, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(value))
            if t.dim() < 1 or t.shape[0] != k:
                raise ValueError(
                    "pre-stacked megastep feed %r must have leading dim "
                    "k=%d, got shape %s" % (name, k, tuple(t.shape)))
            stacked[name] = t
        info0 = {}
    else:
        sig0 = info0 = None
        normed = []
        for i, feed in enumerate(feeds):
            arrays, info = _normalize_feeds(feed, plan_cache=plan_cache)
            normed.append(arrays)
            sig = tuple(sorted((n,) + _signature(v)
                               for n, v in arrays.items()))
            if sig0 is None:
                sig0, info0 = sig, info
            elif sig != sig0 or info != info0:
                raise ValueError(
                    "run_steps feeds must share ONE step signature (the "
                    "K step bodies are captured once): feed %d is %s / "
                    "static %s, feed 0 is %s / static %s. Pad or "
                    "re-bucket the odd batch, or run() it separately."
                    % (i, sig, sorted(info.items()), sig0,
                       sorted(info0.items())))
        stacked = {}
        for name in normed[0]:
            values = [a[name] for a in normed]
            tensors = [v for v in values if isinstance(v, torch.Tensor)]
            if tensors:
                # a committed (frozen) feed is a tensor already: the
                # others join it on its device, narrowed as it is
                stacked[name] = torch.stack(
                    [to_tensor(v, tensors[0].device) for v in values])
            else:
                stacked[name] = torch.from_numpy(np.ascontiguousarray(
                    np.stack([np.asarray(v) for v in values])))
    sig = tuple(sorted((n,) + _signature(t[0]) for n, t in stacked.items()))
    return stacked, sig, info0


class _Megastep:
    """K step bodies of one program over static buffers: the feeds as
    ``[K, ...]`` tensors, the state (tensors of its own, lent to the
    scope it last ran for), and each step's fetches copied into ``[K,
    ...]`` tensors. On the CPU ``run`` runs the K bodies in a loop; on
    the card ``capture`` captures them once, unrolled into one CUDA
    graph, and ``graph.replay()`` runs them. With NaN guards, step i
    writes its stacked guards into row i of ``guards``."""

    def __init__(self, device, step, feed_sig, state_sig, k, what):
        self.device = device
        self.step = step
        self.k = k
        self.what = what
        self.feeds = {n: torch.empty((k,) + shape, dtype=dt, device=device)
                      for n, shape, dt in feed_sig}
        self.state = {n: torch.empty(shape, dtype=dt, device=device)
                      for n, shape, dt in state_sig}
        # the K steps' run seeds; step i's draws read row i
        self.seeds = torch.empty((k,), dtype=torch.int64, device=device)
        self.fetches = None      # made at the first step, from its fetches
        self.fetch_lods = None   # {fetch name: [K, n] lengths}, likewise
        self.guards = None       # [K, n_guards] bool, likewise
        self.guard_names = None
        self.graph = None
        self._owner = None       # weakref to the scope holding the state

    def stage(self, stacked, seeds):
        """One copy per feed into its ``[K, ...]`` buffer, and one of the
        K run seeds into theirs."""
        for name, src in stacked.items():
            self._copy_in(self.feeds[name], src)
        self._copy_in(self.seeds, torch.tensor(seeds, dtype=torch.int64))

    def _copy_in(self, buf, src):
        """Narrowed on the host, then through pinned memory without a
        wait, on the card."""
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
                t.copy_(to_tensor(_whole(value), self.device))
                scope.set(n, t)
        self._owner = weakref.ref(scope)

    def run(self):
        """The K bodies in a loop (the CPU path)."""
        for i in range(self.k):
            self._body(self.state, i)

    def capture(self):
        """Warm up on copies of the state (one step), then capture the K
        bodies over the state into one CUDA graph."""
        graph = _graphs.StepGraph(self.device, self.what)

        def warmup():
            state = {n: t.clone() for n, t in self.state.items()}
            self._body(state, 0)

        def body():
            for i in range(self.k):
                self._body(self.state, i)

        graph.capture(warmup, body)
        self.graph = graph

    def _body(self, state, i):
        """Step ``i``: read feed row i, write fetch (and guard) row i,
        update ``state`` in place."""
        seed = self.seeds[i]
        fetches, new, lods, guards = self.step(
            state, {n: b[i] for n, b in self.feeds.items()},
            lambda: seed)
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
        if self.fetch_lods is None:
            self.fetch_lods = {
                n: torch.empty((self.k,) + tuple(v.shape), dtype=v.dtype,
                               device=self.device) for n, v in lods.items()}
        if guards is not None:
            if self.guards is None:
                self.guard_names = guards[0]
                self.guards = torch.empty((self.k,) + tuple(
                    guards[1].shape), dtype=torch.bool, device=self.device)
            self.guards[i].copy_(guards[1])
        for buf, v in zip(self.fetches, fetches):
            buf[i].copy_(v)
        for n, v in lods.items():
            self.fetch_lods[n][i].copy_(v)
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


# errors a lowering passes on as they are: its own, and the checkpoint's
# signal that a recompute has rebuilt every tensor the backward needs
_PASS_THROUGH = (EnforceError, NotImplementedError,
                 _checkpoint._StopRecomputationError)


def _lower_op(ctx, op):
    if op.type in ("feed", "fetch"):
        _lower_feed_fetch(ctx, op)
        return
    if ctx.debug_nans:
        _lower_op_debug_nans(ctx, op)
    else:
        with _prof.op_event(ctx, op):
            _lower_op_body(ctx, op)
    if ctx.guards is not None:
        ctx.guards.record(op, ctx.env)


class _NanTag(torch.autograd.Function):
    """Identity on an op's input whose backward checks the gradient the
    op's backward handed it (flag ``debug_nans``)."""

    @staticmethod
    def forward(ctx, x, op_type):
        ctx.op_type = op_type
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g is not None and bool(torch.isnan(g).any()):
            raise FloatingPointError(
                "invalid value (nan) encountered in the backward of op %r "
                "(PADDLE_TPU_DEBUG_NANS)" % ctx.op_type)
        return g, None


def _lower_op_debug_nans(ctx, op):
    """One op under the ``debug_nans`` flag: its float inputs that carry
    gradients are tagged (``_NanTag``) for the lowering alone, and each
    float output is checked for NaN once it is made."""
    tagged = {}
    if torch.is_grad_enabled():
        for n in set(op.input_names):
            t = ctx.env.get(n)
            if isinstance(t, torch.Tensor) and t.requires_grad \
                    and t.is_floating_point():
                tagged[n] = (t, _NanTag.apply(t, op.type))
                ctx.env[n] = tagged[n][1]
    try:
        with _prof.op_event(ctx, op):
            _lower_op_body(ctx, op)
    finally:
        for n, (t, tag) in tagged.items():
            if ctx.env.get(n) is tag:      # not an output of the op
                ctx.env[n] = t
    for n in op.output_names:
        t = ctx.env.get(n)
        if isinstance(t, torch.Tensor) and t.is_floating_point() \
                and bool(torch.isnan(t.detach()).any()):
            raise FloatingPointError(
                "invalid value (nan) encountered in output %r of op %r "
                "(PADDLE_TPU_DEBUG_NANS)" % (n, op.type))


def _lower_op_body(ctx, op):
    info = registry.lookup(op.type)
    if info is None:
        raise NotImplementedError(
            "no lowering registered for op %r in paddle_tpu_torch "
            "(registered: %d ops; ROADMAP.md queue 1 lists what remains)"
            % (op.type, len(registry.registered_ops())))
    try:
        if ctx.mesh is not None:
            # ParallelExecutor's held and sequence blocks
            # (parallel/blocks.py, parallel/seqblocks.py)
            from ..parallel import blocks
            blocks.lower(ctx, op, info.lower)
        else:
            info.lower(ctx, op)
    except _PASS_THROUGH:
        raise
    except Exception as e:  # annotate with op context (enforce.h:203 parity)
        raise op_error(op, ctx.env, e) from e
    _propagate_lod(ctx, op)


def _extremes(v, lod):
    """(min, max) of ``v`` as device scalars, one reduction: both are
    finite exactly when every element is (a NaN propagates through both,
    an inf shows in one). With LoD lengths the bucket's pad rows past
    sum(lengths) read as zero: they are filler, and may go non-finite
    downstream of a log or a division. Read off the autograd graph: a
    guard saves nothing for the backward, so a checkpointed forward saves
    the same tensors when the backward recomputes it unguarded, and no
    guarded activation is kept alive past its own use."""
    v = v.detach()
    with torch.no_grad():
        if lod is not None and v.dim() >= 1:
            valid = torch.arange(v.shape[0], device=v.device) < lod.sum()
            v = torch.where(valid.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                            v.new_zeros(()))
        return torch.aminmax(v)


class _Guards:
    """The NaN/Inf guards of one step (flag ``check_nan_inf``; the
    reference's every-op-output scan, executor.cc:27-94): the extremes of
    each float output of each op (``_extremes``), in program order
    (forward ops, then the ops after the grad marker), and of each float
    fetch, all kept on the device: one reduction a guard, and a few
    launches a step to turn them into one bool vector. ``paused`` while
    the backward recomputes a checkpointed forward or region, whose ops
    were guarded once."""

    def __init__(self):
        # (position, "op", op type, var) or (position, "fetch", var)
        self.names = []
        self.groups = {}     # dtype -> ([name index], [min, max, ...])
        self._paused = False

    def _add(self, name, v, lod):
        if v.numel() == 0:
            return           # nothing to check: all() of nothing holds
        idx, vals = self.groups.setdefault(v.dtype, ([], []))
        idx.append(len(self.names))
        vals.extend(_extremes(v, lod))
        self.names.append((len(self.names),) + name)

    def record(self, op, env):
        if self._paused:
            return
        for name in op.output_names:
            v = env.get(name)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                self._add(("op", op.type, name), v, env.get(name + "@LOD"))

    def record_fetch(self, name, v, lod):
        if v.is_floating_point():
            self._add(("fetch", name), v, lod)

    @contextlib.contextmanager
    def paused(self):
        self._paused = True
        try:
            yield
        finally:
            self._paused = False

    def stacked(self, device):
        """(the guard names, the guards as one bool [n] tensor in the
        names' order: grouped by dtype, each name led by its position in
        program order)."""
        order, parts = [], []
        for idx, vals in self.groups.values():
            order += idx
            parts.append(torch.isfinite(torch.stack(vals)).view(-1, 2)
                         .all(dim=1))
        if not parts:
            return (), torch.ones((0,), dtype=torch.bool, device=device)
        return (tuple(self.names[i] for i in order),
                parts[0] if len(parts) == 1 else torch.cat(parts))


def _raise_first_nan(names, rows, steps=None):
    """Raise the JAX package's FloatingPointError for the first failing
    guard of ``rows`` (host bool [n_steps, n]) in program order: an op
    output before any fetch, the first step first; under ``run_steps``
    (``steps`` = K) an op's error names its logical step."""
    by_pos = sorted(range(len(names)), key=lambda j: names[j][0])
    for kind in ("op", "fetch"):
        for i, row in enumerate(rows):
            for j in by_pos:
                name = names[j]
                if name[1] != kind or row[j]:
                    continue
                if kind == "fetch":
                    _mon.on_nan_trip("fetch", detail=name[2])
                    raise FloatingPointError(
                        "NaN/Inf detected in fetched var %r" % name[2])
                _mon.on_nan_trip("guard", detail="%s/%s" % (name[2],
                                                            name[3]))
                msg = ("NaN/Inf detected in output %r of op %r "
                       "(PADDLE_TPU_CHECK_NAN_INF)" % (name[3], name[2]))
                if steps is not None:
                    msg = ("%s (at megastep logical step %d of %d; state "
                           "has advanced the full megastep)"
                           % (msg, i, steps))
                raise FloatingPointError(msg)


def _propagate_lod(ctx, op):
    """LoD lengths flow through row-preserving ops, as in the JAX
    package: when a lowering did not set ``out@LOD`` itself (the
    sequence ops do), every output with the leading dim of the first
    LoD-carrying input inherits that input's lengths, and its
    ``@MAXLEN`` bound. This is what lets ``embedding -> fc ->
    dynamic_lstm -> sequence_pool`` see the sequence boundaries."""
    in_lod = lead = src = None
    for name in op.input_names:
        lod = ctx.env.get(name + "@LOD")
        if lod is not None:
            val = ctx.env.get(name)
            if isinstance(val, torch.Tensor) and val.dim() >= 1:
                in_lod, lead, src = lod, val.shape[0], name
                break
    if in_lod is None:
        return
    maxlen = ctx.static_info.get(src + "@MAXLEN")
    for name in op.output_names:
        if name + "@LOD" in ctx.env:
            continue        # the lowering set it
        val = ctx.env.get(name)
        if isinstance(val, torch.Tensor) and val.dim() >= 1 \
                and val.shape[0] == lead:
            ctx.env[name + "@LOD"] = in_lod
            if maxlen is not None:
                ctx.static_info.setdefault(name + "@MAXLEN", maxlen)


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
    val = env[name]
    if isinstance(val, list):       # a tensor array, stacked on fetch
        val = torch.stack(val)
    return val
