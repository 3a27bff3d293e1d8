"""Continuous-batching decode engine: slot state + iteration scheduler.

The counterpart of ``paddle_tpu/serving/engine.py`` in its default
configuration: the paged KV pool with per-slot block tables, the radix
prefix cache with copy-on-write, the allocation and preemption ladder,
chunked prefill, greedy decode through the block-chain attention kernel
(``ops/paged_attention``: the CUDA kernel on the card), and megastep
decode: with ``megastep=K`` an iteration with no queued admission and no
prefilling slot runs K decode steps as one dispatch (a CUDA graph of K
step bodies on the card, captured once; the same bodies in a loop on
the CPU), with token-identical output.

Not ported yet, and refused with a ``ValueError`` naming ROADMAP.md
when asked for: speculative decode, the dense ``paged=False`` layout.
Sampled (temperature > 0) requests raise ``NotImplementedError``. The
engine emits no telemetry.

Every piece of device state lives in one dict of tensors
(``self._state``) that the scheduler thread updates in place, so a
captured graph and the eager steps work on the same tensors. One host
fetch per decode dispatch carries the emitted tokens and retirement
flags of its K steps back.
"""

import collections
import itertools
import threading
import time

import numpy as np
import torch

from .. import flags, resolve_device
from ..core import graphs as _graphs
from ..ops import paged_attention as _paged_ops
from . import kvpool as _kvpool
from .sampling import SamplingParams

__all__ = ["Engine", "Request", "sequential_generate"]

_NOT_PORTED = "is not ported yet (see ROADMAP.md, queue 1: serving slice)"


class Request:
    """One submitted generation request; also the result handle.

    ``result()`` blocks until the engine retires the request and returns
    ``(tokens, score)`` — the greedy continuation (EOS included when hit,
    at most ``max_new`` tokens) and the sum of token log-probs. The
    engine stamps ``t_enqueue``/``t_admit``/``t_first_token``/
    ``t_retire`` (``time.perf_counter``) before resolving it."""

    __slots__ = ("prompt", "max_new", "tokens", "score", "_event",
                 "_error", "t_enqueue", "t_admit", "t_first_token",
                 "t_retire", "prefill_chunks", "rid", "preemptions",
                 "_seq")

    def __init__(self, prompt, max_new, request_id=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.preemptions = 0
        # admission priority: set at FIRST admission and kept across
        # preemption, so a preempted request re-admits at its priority
        self._seq = None
        self.rid = request_id
        self.tokens = []
        self.score = None
        self._event = threading.Event()
        self._error = None
        self.t_enqueue = time.perf_counter()
        self.t_admit = None
        self.t_first_token = None
        self.t_retire = None
        self.prefill_chunks = 0

    def _finish(self, score):
        self.score = score
        self._event.set()

    def _fail(self, err):
        self._error = err
        self._event.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                "request not finished within %r s" % (timeout,))
        if self._error is not None:
            raise RuntimeError(
                "serving engine failed: %r" % (self._error,))
        return list(self.tokens), self.score


class Engine:
    """Continuous-batching engine over ``TransformerLMInfer``.

    ``slots`` is the fixed decode batch; ``prefill_chunk`` the prompt
    tokens written per slot per iteration (flag
    ``serving_prefill_chunk``); ``admission_wait`` an idle engine's
    wait-for-batch window in seconds. The KV pool holds ``num_blocks``
    blocks of ``block_size`` positions (default ``slots *
    ceil(max_len / block_size)``); ``prefix_cache`` turns the radix
    prefix cache on (default). ``block_kernel`` selects the block-chain
    attention (default for fp32 or quantized pools) over the dense
    gather (default for a bf16 unquantized pool); ``kv_quant='int8'``
    or ``'fp8'`` (e4m3) quantizes the pool. ``megastep`` (flag
    ``serving_megastep``) is the decode steps one dispatch may run when
    no admission is queued and no slot is prefilling. ``device``
    defaults to the CUDA card and must be where the model lives; without
    a card the engine raises unless ``device='cpu'`` is passed."""

    def __init__(self, model, slots=8, prefill_chunk=None,
                 admission_wait=None, name="engine", megastep=None,
                 paged=None, block_size=None, num_blocks=None,
                 prefix_cache=None, speculative=None, block_kernel=None,
                 kv_quant=None, device=None):
        if slots < 1:
            raise ValueError("slots must be >= 1, got %r" % (slots,))
        dev = resolve_device(device)
        mdev = model.device
        if dev.type != mdev.type or (dev.index is not None
                                     and dev.index != mdev.index):
            raise ValueError("the model lives on %s but the engine was "
                             "asked to run on %s" % (mdev, dev))
        self._megastep = max(1, int(
            megastep if megastep is not None
            else flags.get_flag("serving_megastep")))
        if not bool(paged if paged is not None
                    else flags.get_flag("serving_paged")):
            raise ValueError("paged=False: the dense KV layout %s"
                             % _NOT_PORTED)
        if bool(speculative if speculative is not None
                else flags.get_flag("serving_speculative")):
            raise ValueError("speculative decode %s" % _NOT_PORTED)
        self.model = model
        self.device = mdev
        self.slots = int(slots)
        self.name = name
        self._chunk = int(prefill_chunk if prefill_chunk is not None
                          else flags.get_flag("serving_prefill_chunk"))
        self._chunk = max(1, min(self._chunk, model.max_len))
        self._admission_wait = float(
            admission_wait if admission_wait is not None
            else flags.get_flag("serving_admission_wait"))
        bs = int(block_size if block_size is not None
                 else flags.get_flag("serving_block_size"))
        self._block_size = max(1, min(bs, model.max_len))
        self._max_blocks = -(-model.max_len // self._block_size)
        nb = int(num_blocks if num_blocks is not None
                 else flags.get_flag("serving_kv_blocks"))
        if nb <= 0:
            nb = self.slots * self._max_blocks
        if nb < self._max_blocks:
            raise ValueError(
                "num_blocks %d cannot hold one max_len request "
                "(%d blocks of %d positions)"
                % (nb, self._max_blocks, self._block_size))
        self._pool = _kvpool.BlockPool(nb, self._block_size)
        use_prefix = bool(prefix_cache if prefix_cache is not None
                          else flags.get_flag("serving_prefix_cache"))
        self._prefix = (_kvpool.RadixCache(self._block_size, self._pool)
                        if use_prefix else None)
        self._attn_unroll = max(1, int(flags.get_flag("serving_attn_unroll")))
        kvq = (kv_quant if kv_quant is not None
               else flags.get_flag("serving_kv_quant"))
        kvq = str(kvq or "").strip().lower()
        self._kv_quant = kvq if kvq not in ("", "none", "off") else None
        _paged_ops.kv_quant_spec(self._kv_quant)       # validate
        # the kernel accumulates in fp32, a different reduction order
        # than the dense row math: a bf16 unquantized pool keeps the
        # gather path by default so it matches the bf16 dense baseline
        kern_ok = (self._kv_quant is not None
                   or model.dtype == torch.float32)
        self._block_kernel = bool(
            block_kernel if block_kernel is not None
            else (flags.get_flag("serving_block_kernel") and kern_ok))
        self._block_bytes = _kvpool.bytes_per_block(
            model.n_layer, model.n_head, self._block_size,
            model.d_model // model.n_head,
            dtype_bytes=model.dtype.itemsize, kv_quant=self._kv_quant)
        self._admit_seq = itertools.count()
        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._recs = [None] * self.slots   # loop-thread-only slot records
        self._stop = False
        self._error = None
        with torch.no_grad():
            self._state = self._init_state()
            # the block tables every decode dispatch reads, copied in
            # before it (a captured graph reads them at this address);
            # [2, K, S]: the emits and retirement flags of up to K steps
            self._btab = torch.zeros((self.slots, self._max_blocks),
                                     dtype=torch.int32, device=self.device)
            self._mega_out = torch.zeros((2, self._megastep, self.slots),
                                         dtype=torch.long,
                                         device=self.device)
        self._graph = None       # the K-step CUDA graph, on the card
        # decode_steps counts the steps whose emits were consumed;
        # decode_steps_run the steps the device ran (a megastep that
        # drains early runs more than it consumes)
        self.stats = {"steps": 0, "decode_steps": 0, "decode_steps_run": 0,
                      "tokens": 0, "admissions": 0, "retirements": 0,
                      "active_slot_steps": 0, "prefill_chunks": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_hit_tokens": 0, "prefix_evictions": 0,
                      "preemptions": 0, "cow_copies": 0,
                      "kv_peak_blocks": 0, "decode_seconds": 0.0,
                      "megastep_dispatches": 0, "graph_captures": 0,
                      "graph_replays": 0}
        self._ready = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ptt-" + name)
        self._thread.start()

    # -- public API --------------------------------------------------------
    def warmup(self):
        """Run one decode step over the all-inactive slot state — a
        no-op on the state (every pool write is masked into the trash
        block) that builds and loads the attention kernel and warms the
        allocator before traffic — and, with ``megastep`` > 1 on the
        card, capture the K-step CUDA graph (without it the first fused
        dispatch captures it mid-traffic). Call before submitting
        requests."""
        self._ready.wait()
        with self._cv:
            if self._queue or any(r is not None for r in self._recs):
                raise RuntimeError(
                    "warmup() must run before traffic is submitted")
            with torch.no_grad():
                self._set_btab(self._btab_all())
                self._step_impl(self._state, self._btab)
                if self._megastep > 1 and self.device.type == "cuda" \
                        and self._graph is None:
                    self._capture()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return self

    def submit(self, prompt, max_new_tokens, request_id=None,
               sampling=None):
        """Enqueue one request; returns its Request handle. ``prompt``
        is the token-id prefix (>= 1 token). ``sampling``: None or a
        greedy ``SamplingParams`` (or its dict form)."""
        prompt = [int(t) for t in (prompt or [self.model.bos_id])]
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(
                "max_new_tokens must be >= 1, got %d" % max_new)
        if len(prompt) + max_new - 1 > self.model.max_len:
            raise ValueError(
                "prompt len %d + max_new %d exceeds model max_len %d"
                % (len(prompt), max_new, self.model.max_len))
        sp = (SamplingParams.from_dict(sampling)
              if sampling is not None else None)
        if sp is not None and not sp.greedy:
            raise NotImplementedError(
                "sampled decoding (temperature > 0) %s" % _NOT_PORTED)
        with self._cv:
            if self._stop:
                if self._error is not None:
                    raise RuntimeError(
                        "engine is closed (loop died: %r)"
                        % (self._error,))
                raise RuntimeError("engine is closed")
            req = Request(prompt, max_new, request_id=request_id)
            self._queue.append(req)
            self._cv.notify_all()
        return req

    @staticmethod
    def result(request, timeout=None):
        return request.result(timeout)

    def generate_many(self, prompts, max_new_tokens):
        """Submit every prompt, block for all results (input order).
        ``max_new_tokens`` is a scalar or a per-prompt sequence."""
        n = len(prompts)
        if not hasattr(max_new_tokens, "__len__"):
            max_new_tokens = [max_new_tokens] * n
        reqs = [self.submit(p, m)
                for p, m in zip(prompts, max_new_tokens)]
        return [r.result() for r in reqs]

    def occupancy(self):
        """Mean active-slot fraction over the decode steps run so far."""
        d = self.stats["decode_steps"] * self.slots
        return self.stats["active_slot_steps"] / d if d else 0.0

    def close(self):
        """Stop the engine loop. Requests still queued or in flight are
        failed (their ``result()`` raises)."""
        with self._cv:
            already = self._stop
            self._stop = True
            self._cv.notify_all()
        if already:
            return
        self._thread.join()
        self._fail_all(RuntimeError("engine closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- device pieces (loop thread; warmup before it runs) ----------------
    def _init_state(self):
        s = self.model._init_paged_state(self._pool.num_blocks,
                                         self._block_size,
                                         kv_quant=self._kv_quant)

        def z(dt):
            return torch.zeros(self.slots, dtype=dt, device=self.device)

        s["tok"], s["pos"], s["count"] = z(torch.long), z(torch.long), \
            z(torch.long)
        s["active"] = z(torch.bool)
        s["score"] = z(torch.float32)
        s["max_new"] = torch.ones(self.slots, dtype=torch.long,
                                  device=self.device)
        return s

    def _step_impl(self, st, btab):
        """One greedy decode iteration over all slots of state ``st``:
        argmax every active slot, advance its cache position, flag
        retirements. Every state tensor is updated in place, and nothing
        is read back to the host, so a CUDA graph can hold the step.
        Returns (emit [S], fin [S]) device tensors."""
        tok, pos, active = st["tok"], st["pos"], st["active"]
        logits, _ = self.model._step_logits_paged(
            tok, st, pos, btab, write_mask=active,
            block_kernel=self._block_kernel,
            attn_unroll=self._attn_unroll)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nxt = torch.argmax(logp, dim=-1)
        tok_logp = logp.gather(1, nxt[:, None])[:, 0]
        end = int(self.model.end_id)
        emit = torch.where(active, nxt, end)
        count = st["count"] + active.long()
        fin = active & ((nxt == end) | (count >= st["max_new"]))
        st["score"] += torch.where(active, tok_logp, 0.0)
        tok.copy_(torch.where(active, nxt, tok))
        pos += active.long()
        st["count"].copy_(count)
        active.copy_(active & ~fin)
        return emit, fin

    def _megastep_impl(self, st, btab, out):
        """``out.shape[1]`` decode iterations over state ``st`` (the
        JAX package's ``lax.scan`` over ``_step_impl``), streaming each
        one's emits and retirement flags into ``out[0]`` and ``out[1]``
        ([K, S]). A slot that retires at step j goes inactive, so later
        steps emit end_id for it and write nothing; the host skips those
        rows. The host grows every live slot's table for all K write
        positions first, so one table serves the whole dispatch."""
        for j in range(out.shape[1]):
            emit, fin = self._step_impl(st, btab)
            out[0, j].copy_(emit)
            out[1, j].copy_(fin)

    def _capture(self):
        """Capture the K-step graph over the engine's state, the block
        tables and the emit buffer. The warm-up runs one step on copies
        of the state, so live requests are left as they are."""
        graph = _graphs.StepGraph(
            self.device, "Engine(megastep=%d) decode" % self._megastep)

        def warmup():
            self._step_impl({n: t.clone() for n, t in self._state.items()},
                            self._btab)

        graph.capture(warmup, lambda: self._megastep_impl(
            self._state, self._btab, self._mega_out))
        self._graph = graph
        self.stats["graph_captures"] += 1

    def _activate(self, slot, tok, pos, max_new):
        st = self._state
        st["tok"][slot] = tok
        st["pos"][slot] = pos
        st["active"][slot] = True
        st["score"][slot] = 0.0
        st["count"][slot] = 0
        st["max_new"][slot] = max_new

    def _copy_block(self, src, dst):
        """Copy-on-write: duplicate one physical block's K/V (every
        layer, scales included) in place."""
        for name in ("pool_k", "pool_v", "pool_ks", "pool_vs"):
            if name in self._state:
                a = self._state[name]
                a[dst] = a[src]

    # -- paged-KV host accounting (loop thread only) -----------------------
    def _btab_all(self):
        """The [slots, max_blocks] int32 block tables. Unassigned
        entries read block 0, masked by the causal predicate."""
        arr = np.zeros((self.slots, self._max_blocks), np.int32)
        for s, rec in enumerate(self._recs):
            if rec is not None:
                t = rec["table"]
                arr[s, :len(t)] = t
        return arr

    def _btab_row(self, rec):
        row = np.zeros((self._max_blocks,), np.int32)
        t = rec["table"]
        row[:len(t)] = t
        return row

    def _btab_dev(self, arr):
        return torch.from_numpy(arr).to(self.device)

    def _set_btab(self, arr):
        """Copy the [slots, max_blocks] tables into the decode buffer."""
        self._btab.copy_(torch.from_numpy(arr))

    def _ensure_blocks(self, rec, last_pos):
        """Grow ``rec``'s block table to cover cache position
        ``last_pos``, walking the pressure ladder on a dry pool (prefix
        LRU eviction, then preemption of the lowest-priority request).
        Returns False when ``rec`` itself was preempted."""
        last_pos = min(int(last_pos), self.model.max_len - 1)
        need = last_pos // self._block_size + 1 - len(rec["table"])
        for _ in range(need):
            b = self._alloc_one(rec)
            if b is None:
                return False
            rec["table"].append(b)
            rec["refs"].append(b)
        return True

    def _alloc_one(self, rec):
        """One block for ``rec``, or None when ``rec`` was preempted to
        make room: the pool cannot serve it without taking blocks from
        strictly higher-priority (earlier-admitted) requests, so it
        yields. With priorities kept across preemption this cannot
        ping-pong; the oldest request always keeps its blocks."""
        while True:
            got = self._pool.alloc(1)
            if got is not None:
                return got[0]
            if self._prefix is not None:
                freed = self._prefix.evict(1)
                if freed:
                    self.stats["prefix_evictions"] += freed
                    continue
            victim = self._pick_victim()
            if victim is None or victim["seq"] <= rec["seq"]:
                self._preempt(rec)
                return None
            self._preempt(victim)

    def _pick_victim(self):
        """The latest-admitted record AMONG those holding blocks (a
        zero-block record cannot relieve pool pressure)."""
        victim = None
        for r in self._recs:
            if r is not None and r["refs"] and (
                    victim is None or r["seq"] > victim["seq"]):
                victim = r
        return victim

    def _preempt(self, rec):
        """Free a record's blocks and re-queue its request at the FRONT
        of the queue for re-prefill. Greedy decode is deterministic, so
        the resumed output is identical; partial tokens are dropped."""
        slot = next(s for s, r in enumerate(self._recs) if r is rec)
        req = rec["req"]
        self._release_blocks(rec)
        self._recs[slot] = None
        if rec["live"]:
            # the write mask goes False: the slot's stale tok/pos can
            # never write again; the rest resets at re-activation
            self._state["active"][slot] = False
        del req.tokens[:]
        req.score = None
        req.preemptions += 1
        self.stats["preemptions"] += 1
        with self._cv:
            self._queue.appendleft(req)

    def _cow(self, rec, bi):
        """Copy-on-write of shared block ``bi`` in ``rec``'s table (the
        fully block-aligned prompt: activation writes the last prompt
        position into a block the prefix cache shares). Returns False
        when the allocation preempted ``rec``."""
        new = self._alloc_one(rec)
        if new is None:
            return False
        old = rec["table"][bi]
        self._copy_block(old, new)
        rec["table"][bi] = new
        rec["refs"][rec["refs"].index(old)] = new
        self._pool.free(old)           # drop the reader ref on the
        rec["shared"] = bi             # shared copy; cache keeps its own
        self.stats["cow_copies"] += 1
        return True

    def _publish_prefix(self, rec, req):
        """Publish a slot's full prompt blocks to the prefix cache after
        its first decode emit (every full prompt block is complete
        then). Refcounted; the request keeps its own refs."""
        if self._prefix is None or rec["inserted"]:
            return
        rec["inserted"] = True
        bs = self._block_size
        nfull = len(req.prompt) // bs
        if nfull:
            self._prefix.insert(req.prompt[:nfull * bs],
                                rec["table"][:nfull])

    def _release_blocks(self, rec):
        """Drop every pool ref the record holds."""
        for b in rec["refs"]:
            self._pool.free(b)
        rec["refs"] = []
        rec["table"] = []

    # -- scheduler loop ----------------------------------------------------
    def _loop(self):
        try:
            with torch.no_grad():
                try:
                    if self.device.type == "cuda":
                        torch.cuda.set_device(self.device)
                finally:
                    self._ready.set()      # warmup() may capture now
                while True:
                    with self._cv:
                        while (not self._stop and not self._queue
                               and all(r is None for r in self._recs)):
                            self._cv.wait()
                        if self._stop:
                            return
                    self._step_once()
        except BaseException as e:      # a dead loop must not hang callers
            with self._cv:
                self._stop = True
                self._error = e
            self._fail_all(e)

    def _step_once(self):
        """One engine iteration = admissions + one prefill chunk per
        prefilling slot + one decode dispatch over the active batch (K
        steps when ``_choose_k`` allows it, else one)."""
        finished = ()
        try:
            admitted = self._admit()
            self._advance_prefills()
            finished = self._decode(self._choose_k())
            self.stats["steps"] += 1
            self.stats["admissions"] += admitted
            self.stats["retirements"] += len(finished)
            self.stats["kv_peak_blocks"] = max(
                self.stats["kv_peak_blocks"], self._pool.used)
        finally:
            # resolve futures even if the iteration raised: a request
            # popped from its slot lives only in `finished` here
            for req, score in finished:
                req._finish(score)

    def _admit(self):
        admitted = 0
        with self._cv:
            if (self._admission_wait > 0 and self._queue
                    and all(r is None for r in self._recs)
                    and len(self._queue) < self.slots):
                self._cv.wait_for(
                    lambda: self._stop
                    or len(self._queue) >= self.slots,
                    timeout=self._admission_wait)
            for slot in range(self.slots):
                if not self._queue:
                    break
                if self._recs[slot] is None:
                    req = self._queue.popleft()
                    req.t_admit = time.perf_counter()
                    if req._seq is None:
                        req._seq = next(self._admit_seq)
                    rec = {"req": req, "cursor": 0, "live": False,
                           "seq": req._seq}
                    self._admit_paged(rec)
                    self._recs[slot] = rec
                    admitted += 1
        return admitted

    def _admit_paged(self, rec):
        """Look the prompt up in the radix prefix cache. A hit hands
        the record a refcounted chain of shared blocks and the prefill
        cursor jumps past them. Own blocks are allocated lazily."""
        req = rec["req"]
        rec["table"], rec["refs"] = [], []
        rec["shared"] = 0
        rec["inserted"] = False
        rec["next_pos"] = None
        if self._prefix is None:
            return
        blocks, ntok = self._prefix.match(req.prompt)
        hit = bool(blocks)
        self.stats["prefix_hits" if hit else "prefix_misses"] += 1
        if not hit:
            return
        rec["table"] = list(blocks)
        rec["refs"] = list(blocks)
        rec["shared"] = len(blocks)
        # the teacher-forced prefill covers positions 0..P-2; a chain
        # covering the WHOLE block-aligned prompt leaves cursor at
        # need, and activation copy-on-writes the last shared block
        rec["cursor"] = min(ntok, len(req.prompt) - 1)
        self.stats["prefix_hit_tokens"] += rec["cursor"]

    def _advance_prefills(self):
        """One prompt chunk per prefilling slot per iteration. A slot
        whose prefix is fully written activates: its LAST prompt token
        seeds the first decode step."""
        for slot, rec in enumerate(self._recs):
            if rec is None or rec["live"]:
                continue
            req = rec["req"]
            need = len(req.prompt) - 1      # teacher-forced prefix
            cur = rec["cursor"]
            if cur < need:
                toks = req.prompt[cur:min(cur + self._chunk, need)]
                if not self._ensure_blocks(rec, cur + len(toks) - 1):
                    continue               # rec preempted back to queue
                chunk = np.zeros((self._chunk,), np.int64)
                chunk[:len(toks)] = toks
                self.model._prefill_chunk_paged(
                    self._state, torch.from_numpy(chunk).to(self.device),
                    cur, len(toks),
                    self._btab_dev(self._btab_row(rec)),
                    block_kernel=self._block_kernel,
                    attn_unroll=self._attn_unroll)
                rec["cursor"] = cur + len(toks)
                req.prefill_chunks += 1
                self.stats["prefill_chunks"] += 1
            if rec["cursor"] >= need:
                # the first decode step writes position `need`
                if not self._ensure_blocks(rec, need):
                    continue
                bi = need // self._block_size
                if bi < rec["shared"] and not self._cow(rec, bi):
                    continue
                rec["next_pos"] = need
                self._activate(slot, req.prompt[-1], need, req.max_new)
                rec["live"] = True

    def _choose_k(self):
        """Megastep K for this iteration: fuse only when nothing needs a
        host decision between decode steps — no queued admission, no
        prefilling slot. A pending admission or prefill forces K = 1, so
        scheduling latency never stretches to K steps."""
        if self._megastep <= 1:
            return 1
        with self._cv:
            if self._queue:
                return 1
        if any(r is not None and not r["live"] for r in self._recs):
            return 1
        return self._megastep

    def _decode(self, k=1):
        """One decode dispatch over the active batch: a single eager
        step (k=1), or K steps in one dispatch (the CUDA graph on the
        card). First grow every live slot's table to cover the write
        positions it can consume in this dispatch (the pressure ladder
        may preempt here), then run, fetch the [K, S] emits and flags in
        one copy, and retire finished requests. A slot retired at step j
        consumes no later rows. Returns [(request, score)]."""
        for slot in range(self.slots):
            # re-read per slot: an earlier slot's allocation may have
            # preempted this one
            rec = self._recs[slot]
            if rec is not None and rec["live"]:
                # a request with fewer tokens left than k must not walk
                # the pressure ladder for positions it will never write
                rem = max(1, rec["req"].max_new - len(rec["req"].tokens))
                self._ensure_blocks(rec, rec["next_pos"] + min(k, rem) - 1)
        live = [s for s, r in enumerate(self._recs)
                if r is not None and r["live"]]
        if not live:
            return []
        t0 = time.perf_counter()
        self._set_btab(self._btab_all())
        if k > 1 and self.device.type == "cuda":
            if self._graph is None:
                self._capture()
            self._graph.replay()
            self.stats["graph_replays"] += 1
        else:                   # the CPU, or one eager step on the card
            self._megastep_impl(self._state, self._btab,
                                self._mega_out[:, :k])
        out = self._mega_out[:, :k].cpu().numpy()
        self.stats["megastep_dispatches"] += k > 1
        self.stats["decode_seconds"] += time.perf_counter() - t0
        self.stats["decode_steps_run"] += out.shape[1]
        scores = None
        finished = []
        now = time.perf_counter()
        for j in range(out.shape[1]):
            if not live:
                break
            emits, fins = out[0, j], out[1, j]
            self.stats["decode_steps"] += 1
            self.stats["active_slot_steps"] += len(live)
            self.stats["tokens"] += len(live)
            for slot in list(live):
                rec = self._recs[slot]
                req = rec["req"]
                req.tokens.append(int(emits[slot]))
                rec["next_pos"] += 1            # mirrors the device pos
                self._publish_prefix(rec, req)
                if req.t_first_token is None:
                    req.t_first_token = now
                if fins[slot]:
                    req.t_retire = now
                    if scores is None:          # one [S] fetch a dispatch
                        # a retired slot's score is frozen by its
                        # inactive mask for the rest of the dispatch
                        scores = self._state["score"].cpu().numpy()
                    finished.append((req, float(scores[slot])))
                    # retirement frees the request's refs; published
                    # prefix blocks survive on the cache's own refs
                    self._release_blocks(rec)
                    self._recs[slot] = None
                    live.remove(slot)
        return finished

    def _fail_all(self, err):
        with self._cv:
            slotted = [r for r in self._recs if r is not None]
            pending = [r["req"] for r in slotted]
            pending += list(self._queue)
            self._queue.clear()
            self._recs = [None] * self.slots
        for rec in slotted:                # pool accounting stays clean
            self._release_blocks(rec)
        for req in pending:
            if req.t_retire is None:
                req.t_retire = time.perf_counter()
            req._fail(err)


# -- sequential baseline ---------------------------------------------------

def sequential_generate(model, requests):
    """One-at-a-time greedy decode over the model's dense KV cache: one
    single-token step at batch 1, requests back to back. ``requests``:
    iterable of ``(prompt, max_new_tokens)``. Returns ``[(tokens,
    score), ...]``, token-identical to ``Engine`` output."""
    dev = model.device
    out = []
    with torch.no_grad():
        for prompt, max_new in requests:
            prompt = [int(t) for t in prompt]
            if len(prompt) + int(max_new) - 1 > model.max_len:
                raise ValueError(
                    "prompt len %d + max_new %d exceeds model max_len %d"
                    % (len(prompt), int(max_new), model.max_len))
            state = model._init_state(1)
            for t, tk in enumerate(prompt[:-1]):   # teacher-forced prefix
                model._step_logits(
                    torch.full((1,), tk, dtype=torch.long, device=dev),
                    state, t)
            tok, pos = prompt[-1], len(prompt) - 1
            toks, score = [], 0.0
            for _ in range(int(max_new)):
                logits, state = model._step_logits(
                    torch.full((1,), tok, dtype=torch.long, device=dev),
                    state, pos)
                logp = torch.log_softmax(logits.float(), dim=-1)
                nxt = torch.argmax(logp, dim=-1)
                lp = logp.gather(1, nxt[:, None])[0, 0]
                tok = int(nxt[0])
                score += float(lp)
                toks.append(tok)
                pos += 1
                if tok == model.end_id:
                    break
            out.append((toks, score))
    return out
