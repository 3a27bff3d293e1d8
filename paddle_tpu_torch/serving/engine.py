"""Continuous-batching decode engine: slot state + iteration scheduler.

The counterpart of ``paddle_tpu/serving/engine.py``: by default the
paged KV pool with per-slot block tables, the radix prefix cache with
copy-on-write, the allocation and preemption ladder, chunked prefill,
greedy and sampled decode through the block-chain attention kernel
(``ops/paged_attention``: the CUDA kernel on the card), megastep decode
and speculative decode:

  * Sampled requests (``SamplingParams`` with temperature > 0) draw
    through ``sampling.sample``, keyed on (seed, tokens generated), in a
    second variant of the decode step that runs only while a sampled
    request is live; temperature-0 slots keep the greedy argmax bit for
    bit.
  * ``megastep=K``: an iteration with no queued admission and no
    prefilling slot runs K decode steps as one dispatch (a CUDA graph
    of K step bodies on the card, captured once per variant, greedy and
    sampled; the same bodies in a loop on the CPU), with
    token-identical output.
  * ``speculative=True``: a drafter (``spec.NgramDrafter``, or gamma
    truncated-depth decode steps on the device) proposes up to gamma
    tokens per live slot, and one scoring dispatch
    (``_spec_logits_paged``: the paged kernel at C = gamma + 1 rows)
    accepts the longest prefix that matches the model's own tokens, so
    the output is the non-speculative engine's. An iteration with no
    draft runs the plain or megastep dispatch.
  * ``paged=False``: the dense layout, one ``[slots, H, max_len, dk]``
    cache per layer for K and for V (``_step_logits_slots``,
    ``_prefill_chunk_slot``): no pool, no prefix cache, no preemption,
    plain attention over all ``max_len`` keys (the JAX package's dense
    route runs no kernel either). Greedy, sampled and megastep decode
    run over it; speculative decode and ``kv_quant`` need the pool.
  * ``Engine(<artifact dir>)`` boots the model from a
    ``save_lm_artifact`` directory (``serving/artifact.py``).

Not ported yet, and refused naming ROADMAP.md when asked for: the
telemetry (flag ``monitor``, ``NotImplementedError``).

Every piece of device state lives in one dict of tensors
(``self._state``) that the scheduler thread updates in place, so a
captured graph and the eager steps work on the same tensors. One host
fetch per decode dispatch carries the emitted tokens and retirement
flags of its K steps (or of its scoring dispatch) back.
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
from . import artifact as _artifact
from . import kvpool as _kvpool
from . import sampling as _sampling
from . import spec as _spec
from .sampling import SamplingParams

__all__ = ["Engine", "Request", "sequential_generate"]

_NOT_PORTED = ("is not ported yet (see ROADMAP.md, queue 1 items 6 and 10: "
               "the serving telemetry is still to port)")

# the per-slot sampling state a greedy request activates with
_GREEDY = SamplingParams()


class Request:
    """One submitted generation request; also the result handle.

    ``result()`` blocks until the engine retires the request and returns
    ``(tokens, score)`` — the continuation (greedy, or drawn under
    ``sampling``; EOS included when hit, at most ``max_new`` tokens) and
    the sum of token log-probs. ``sampling`` is None for a greedy
    request. The engine stamps ``t_enqueue``/``t_admit``/
    ``t_first_token``/``t_retire`` (``time.perf_counter``) before
    resolving it."""

    __slots__ = ("prompt", "max_new", "tokens", "score", "_event",
                 "_error", "t_enqueue", "t_admit", "t_first_token",
                 "t_retire", "prefill_chunks", "rid", "preemptions",
                 "_seq", "sampling")

    def __init__(self, prompt, max_new, request_id=None, sampling=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.sampling = sampling
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

    @property
    def queue_wait(self):
        """Seconds from submit to decode-slot admission (None until
        admitted)."""
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_enqueue

    @property
    def ttft(self):
        """Time to first token: submit -> first decoded token."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_enqueue

    @property
    def tpot(self):
        """Mean per-token decode latency after the first token; 0.0 for
        single-token requests, None until retired."""
        if self.t_first_token is None or self.t_retire is None:
            return None
        n = len(self.tokens)
        if n <= 1:
            return 0.0
        return (self.t_retire - self.t_first_token) / (n - 1)

    def latency(self):
        """The request's lifecycle attribution as one JSON-able dict."""
        return {"queue_wait": self.queue_wait, "ttft": self.ttft,
                "tpot": self.tpot, "tokens": len(self.tokens),
                "prefill_chunks": self.prefill_chunks}

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

    ``model`` is a ``TransformerLMInfer`` or the path of a
    ``save_lm_artifact`` directory, booted on ``device``
    (``artifact.model_from_artifact``). ``slots`` is the fixed decode
    batch; ``prefill_chunk`` the prompt tokens written per slot per
    iteration (flag ``serving_prefill_chunk``); ``admission_wait`` an
    idle engine's wait-for-batch window in seconds. ``paged`` (flag
    ``serving_paged``, default on) selects the paged KV pool; off, the
    dense layout (no pool options apply). The KV pool holds ``num_blocks``
    blocks of ``block_size`` positions (default ``slots *
    ceil(max_len / block_size)``); ``prefix_cache`` turns the radix
    prefix cache on (default). ``block_kernel`` selects the block-chain
    attention (default for fp32 or quantized pools) over the dense
    gather (default for a bf16 unquantized pool); ``kv_quant='int8'``
    or ``'fp8'`` (e4m3) quantizes the pool. ``megastep`` (flag
    ``serving_megastep``) is the decode steps one dispatch may run when
    no admission is queued and no slot is prefilling. ``speculative``
    (flag ``serving_speculative``) turns speculative decode on, with
    ``spec_gamma`` drafts per slot (0 turns it off), drafter
    ``spec_drafter`` ('ngram' or 'truncated') and ``spec_layers``
    layers for the truncated drafter (0 = n_layer // 2); each defaults
    to its ``serving_spec_*`` flag. Requests may be greedy or sampled
    (``submit(sampling=...)``). ``device`` defaults to the CUDA card
    and must be where the model lives; without a card the engine raises
    unless ``device='cpu'`` is passed."""

    def __init__(self, model, slots=8, prefill_chunk=None,
                 admission_wait=None, name="engine", megastep=None,
                 paged=None, block_size=None, num_blocks=None,
                 prefix_cache=None, speculative=None, block_kernel=None,
                 kv_quant=None, device=None, spec_gamma=None,
                 spec_drafter=None, spec_layers=None):
        if slots < 1:
            raise ValueError("slots must be >= 1, got %r" % (slots,))
        if flags.get_flag("monitor"):
            raise NotImplementedError("serving telemetry (flag monitor) %s"
                                      % _NOT_PORTED)
        dev = resolve_device(device)
        if _artifact.is_artifact_path(model):
            # serving cold start: the artifact directory in place of a
            # live model object
            model = _artifact.model_from_artifact(model, device=dev)
        mdev = model.device
        if dev.type != mdev.type or (dev.index is not None
                                     and dev.index != mdev.index):
            raise ValueError("the model lives on %s but the engine was "
                             "asked to run on %s" % (mdev, dev))
        self._megastep = max(1, int(
            megastep if megastep is not None
            else flags.get_flag("serving_megastep")))
        self._paged = bool(paged if paged is not None
                           else flags.get_flag("serving_paged"))
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
        if self._paged:
            self._init_pool(block_size, num_blocks, prefix_cache, kv_quant,
                            block_kernel)
        else:
            if kv_quant:
                raise ValueError(
                    "kv_quant requires the paged KV layout (per-vector "
                    "scales live beside the block pool); pass paged=True "
                    "or drop kv_quant")
            self._pool = self._prefix = None
            self._block_kernel = False
            self._attn_unroll = 1
            self._kv_quant = None
            self._block_bytes = 0
        self._init_spec(speculative, spec_gamma, spec_drafter, spec_layers)
        self._admit_seq = itertools.count()
        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._recs = [None] * self.slots   # loop-thread-only slot records
        self._stop = False
        self._error = None
        with torch.no_grad():
            self._state = self._init_state()
            # the block tables every decode dispatch reads, copied in
            # before it (a captured graph reads them at this address;
            # None in the dense layout); [2, K, S]: the emits and
            # retirement flags of up to K steps
            self._btab = torch.zeros(
                (self.slots, self._max_blocks), dtype=torch.int32,
                device=self.device) if self._paged else None
            self._mega_out = torch.zeros((2, self._megastep, self.slots),
                                         dtype=torch.long,
                                         device=self.device)
            # a scoring dispatch's packed upload [S, gamma+1] (draft
            # counts, then drafts) and packed fetch [S, gamma+3] (emits,
            # emit count, retirement flag)
            g = self._spec_gamma
            self._spec_in = torch.zeros((self.slots, g + 1),
                                        dtype=torch.long, device=self.device)
            self._spec_out = torch.zeros((self.slots, g + 3),
                                         dtype=torch.long,
                                         device=self.device)
        # the K-step CUDA graphs on the card, one per variant of the
        # step (greedy, sampled)
        self._graphs = {False: None, True: None}
        # decode_steps counts the steps whose emits were consumed (a
        # scoring dispatch is one); decode_steps_run the plain steps the
        # device ran (a megastep that drains early runs more than it
        # consumes); spec_draft_steps the truncated drafter's steps
        self.stats = {"steps": 0, "decode_steps": 0, "decode_steps_run": 0,
                      "tokens": 0, "admissions": 0, "retirements": 0,
                      "active_slot_steps": 0, "prefill_chunks": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_hit_tokens": 0, "prefix_evictions": 0,
                      "preemptions": 0, "cow_copies": 0,
                      "kv_peak_blocks": 0, "decode_seconds": 0.0,
                      "megastep_dispatches": 0, "graph_captures": 0,
                      "graph_replays": 0, "spec_dispatches": 0,
                      "spec_drafted": 0, "spec_accepted": 0,
                      "spec_emitted": 0, "spec_draft_steps": 0}
        self._ready = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ptt-" + name)
        self._thread.start()

    def _init_pool(self, block_size, num_blocks, prefix_cache, kv_quant,
                   block_kernel):
        """The paged layout's settings (the JAX package's rules)."""
        model = self.model
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

    def _init_spec(self, speculative, gamma, drafter, layers):
        """Speculative decode's settings (the JAX package's rules):
        gamma 0 or ``speculative`` off leaves every existing program as
        it is."""
        self._spec_gamma = max(0, int(
            gamma if gamma is not None
            else flags.get_flag("serving_spec_gamma")))
        on = bool(speculative if speculative is not None
                  else flags.get_flag("serving_speculative"))
        self._speculative = on and self._spec_gamma > 0
        self._spec_kind = None
        self._drafter = None
        self._spec_layers = 0
        if not self._speculative:
            return
        if not self._paged:
            raise ValueError(
                "speculative decode requires the paged KV layout (per-slot "
                "ragged draft lengths ride the block tables); pass "
                "paged=True or drop speculative")
        kind = str(drafter if drafter is not None
                   else flags.get_flag("serving_spec_drafter"))
        if kind not in ("ngram", "truncated"):
            raise ValueError("serving_spec_drafter must be 'ngram' or "
                             "'truncated', got %r" % (kind,))
        self._spec_kind = kind
        self._drafter = _spec.NgramDrafter(
            max_n=flags.get_flag("serving_spec_ngram"),
            min_n=flags.get_flag("serving_spec_ngram_min"))
        if kind == "truncated":
            nl = int(layers if layers is not None
                     else flags.get_flag("serving_spec_layers"))
            if nl <= 0:
                nl = max(1, self.model.n_layer // 2)
            self._spec_layers = min(nl, self.model.n_layer)

    # -- public API --------------------------------------------------------
    def warmup(self, sampled=False):
        """Run one decode step over the all-inactive slot state — a
        no-op on the state (every pool write is masked into the trash
        block) that builds and loads the attention kernel and warms the
        allocator before traffic — and, with ``megastep`` > 1 on the
        card, capture the K-step CUDA graph (without it the first fused
        dispatch captures it mid-traffic). A speculative engine also
        runs its scoring step (and the truncated drafter) once.
        ``sampled=True`` does the same for the sampled variant of each
        step, capturing its graph too. Call before submitting
        requests."""
        self._ready.wait()
        with self._cv:
            if self._queue or any(r is not None for r in self._recs):
                raise RuntimeError(
                    "warmup() must run before traffic is submitted")
            with torch.no_grad():
                if self._paged:
                    self._set_btab(self._btab_all())
                self._spec_in.zero_()
                for variant in ((False, True) if sampled else (False,)):
                    self._step_impl(self._state, self._btab, variant)
                    if self._megastep > 1 and self.device.type == "cuda" \
                            and self._graphs[variant] is None:
                        self._capture(variant)
                    if self._speculative:
                        self._spec_step_impl(self._state, self._btab,
                                             self._spec_in, self._spec_out,
                                             variant)
                if self._spec_kind == "truncated":
                    self._draft_truncated_impl(self._state, self._btab,
                                               self._spec_in)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return self

    def submit(self, prompt, max_new_tokens, request_id=None,
               sampling=None):
        """Enqueue one request; returns its Request handle. ``prompt``
        is the token-id prefix (>= 1 token). ``sampling``: None (greedy)
        or a ``SamplingParams`` (or its dict form)."""
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
        if sp is not None and sp.greedy:
            sp = None                  # the greedy step serves it as is
        with self._cv:
            if self._stop:
                if self._error is not None:
                    raise RuntimeError(
                        "engine is closed (loop died: %r)"
                        % (self._error,))
                raise RuntimeError("engine is closed")
            req = Request(prompt, max_new, request_id=request_id,
                          sampling=sp)
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
        if self._paged:
            s = self.model._init_paged_state(self._pool.num_blocks,
                                             self._block_size,
                                             kv_quant=self._kv_quant)
        else:
            s = self.model._init_state(self.slots)

        def z(dt):
            return torch.zeros(self.slots, dtype=dt, device=self.device)

        s["tok"], s["pos"], s["count"] = z(torch.long), z(torch.long), \
            z(torch.long)
        s["active"] = z(torch.bool)
        s["score"] = z(torch.float32)
        s["max_new"] = torch.ones(self.slots, dtype=torch.long,
                                  device=self.device)
        # per-slot sampling state: zeros are the greedy request's
        s["temp"] = z(torch.float32)
        s["topk"] = z(torch.long)
        s["topp"] = torch.ones(self.slots, dtype=torch.float32,
                               device=self.device)
        s["seed"] = z(torch.long)
        return s

    def _step_impl(self, st, btab, sampled=False):
        """One decode iteration over all slots of state ``st``: argmax
        every active slot (or, with ``sampled``, draw each slot of
        temperature > 0 at its counter ``count``; temperature-0 slots
        keep the argmax), advance its cache position, flag
        retirements. Every state tensor is updated in place, and nothing
        is read back to the host, so a CUDA graph can hold the step.
        The sampled variant runs only while a sampled request is live,
        so the all-greedy step stays as it was. ``btab`` is the block
        tables (paged) or None (dense). Returns (emit [S], fin [S])
        device tensors."""
        tok, pos, active = st["tok"], st["pos"], st["active"]
        if self._paged:
            logits, _ = self.model._step_logits_paged(
                tok, st, pos, btab, write_mask=active,
                block_kernel=self._block_kernel,
                attn_unroll=self._attn_unroll)
        else:
            logits, _ = self.model._step_logits_slots(
                tok, st, pos, write_mask=active)
        logits32 = logits.float()
        logp = torch.log_softmax(logits32, dim=-1)
        nxt = torch.argmax(logp, dim=-1)
        if sampled:
            drawn = _sampling.sample(
                logits32, st["temp"], st["topk"], st["topp"],
                _sampling.step_keys(st["seed"], st["count"]))
            nxt = torch.where(st["temp"] > 0.0, drawn, nxt)
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

    def _megastep_impl(self, st, btab, out, sampled=False):
        """``out.shape[1]`` decode iterations over state ``st`` (the
        JAX package's ``lax.scan`` over ``_step_impl``), streaming each
        one's emits and retirement flags into ``out[0]`` and ``out[1]``
        ([K, S]). A slot that retires at step j goes inactive, so later
        steps emit end_id for it and write nothing; the host skips those
        rows. The host grows every live slot's table for all K write
        positions first, so one table serves the whole dispatch. A
        sampled slot's counter rides ``count``, so K steps here draw
        what K single steps draw."""
        for j in range(out.shape[1]):
            emit, fin = self._step_impl(st, btab, sampled)
            out[0, j].copy_(emit)
            out[1, j].copy_(fin)

    def _capture(self, sampled=False):
        """Capture the K-step graph of one variant (greedy or sampled)
        over the engine's state, the block tables and the emit buffer;
        the sampled graph reads the sampling state at its fixed
        addresses. The warm-up runs one step on copies of the state, so
        live requests are left as they are."""
        graph = _graphs.StepGraph(
            self.device, "Engine(megastep=%d) %s decode" % (
                self._megastep, "sampled" if sampled else "greedy"))

        def warmup():
            self._step_impl({n: t.clone() for n, t in self._state.items()},
                            self._btab, sampled)

        graph.capture(warmup, lambda: self._megastep_impl(
            self._state, self._btab, self._mega_out, sampled))
        self._graphs[sampled] = graph
        self.stats["graph_captures"] += 1

    def _spec_step_impl(self, st, btab, dn, out, sampled=False):
        """Speculative scoring and acceptance: one dispatch scores every
        slot's current token and its drafts (``_spec_logits_paged``),
        then accepts the longest prefix of drafts that matches the
        model's own next tokens: the argmax for temperature-0 slots, the
        counter-keyed draw at ``count + j`` for sampled slots (with
        ``sampled``), as j single steps would draw. Emission stops at
        EOS inside an accepted draft and at ``max_new``; the bonus token
        the scoring logits buy rides every dispatch.

        ``dn`` [S, gamma+1] packs each slot's draft count (column 0)
        with its drafts. ``out`` [S, gamma+3] receives the emits (end_id
        past each slot's count), the emit count (column gamma+1) and the
        retirement flag (column gamma+2). ``score``, ``tok``, ``pos``,
        ``count`` and ``active`` advance by the emit count, in place;
        nothing is read back to the host."""
        tok, pos, active, count = st["tok"], st["pos"], st["active"], \
            st["count"]
        c = dn.shape[1]
        toks = torch.cat([tok[:, None], dn[:, 1:]], dim=1)
        nd = torch.where(active, dn[:, 0], 0)
        logits, _ = self.model._spec_logits_paged(
            toks, st, pos, btab, nd, write_mask=active,
            block_kernel=self._block_kernel,
            attn_unroll=self._attn_unroll)
        logits32 = logits.float()                        # [S, C, V]
        logp = torch.log_softmax(logits32, dim=-1)
        target = torch.argmax(logp, dim=-1)
        jj = torch.arange(c, device=tok.device)[None]    # [1, C]
        if sampled:
            s = tok.shape[0]

            def rep(a):
                return a.repeat_interleave(c)
            keys = _sampling.step_keys(
                rep(st["seed"]), (count[:, None] + jj).reshape(-1))
            drawn = _sampling.sample(
                logits32.reshape(s * c, -1), rep(st["temp"]),
                rep(st["topk"]), rep(st["topp"]), keys).reshape(s, c)
            target = torch.where((st["temp"] > 0.0)[:, None], drawn,
                                 target)
        # accept-longest-prefix: draft j+1 must equal the model's own
        # token at position j (the running product stops at the first
        # mismatch)
        match = (toks[:, 1:] == target[:, :-1]) & (jj[:, :-1] < nd[:, None])
        m = torch.cumprod(match.long(), dim=1).sum(dim=1)
        ncap = torch.minimum(m + 1, st["max_new"] - count)
        end = int(self.model.end_id)
        is_end = (target == end) & (jj < ncap[:, None])
        end_pos = torch.where(is_end, jj, c).amin(dim=1)
        n_emit = torch.where(active, torch.minimum(ncap, end_pos + 1), 0)
        fin = active & ((end_pos < ncap) | (count + n_emit >= st["max_new"]))
        emit_mask = jj < n_emit[:, None]
        tok_logp = logp.gather(2, target[:, :, None])[:, :, 0]
        st["score"] += torch.where(emit_mask, tok_logp, 0.0).sum(dim=1)
        last = torch.clamp(n_emit - 1, min=0)
        new_tok = target.gather(1, last[:, None])[:, 0]
        tok.copy_(torch.where(active, new_tok, tok))
        pos += n_emit
        count += n_emit
        active.copy_(active & ~fin)
        out[:, :c].copy_(torch.where(emit_mask, target, end))
        out[:, c].copy_(n_emit)
        out[:, c + 1].copy_(fin)

    def _draft_truncated_impl(self, st, btab, dn):
        """The truncated drafter: gamma greedy decode steps through the
        first ``spec_layers`` layers (same weights, same pool), writing
        the drafts into ``dn[:, 1:]`` on the device, where the scoring
        step reads them. Draft K/V lands only at the truncated layers of
        positions the scoring dispatch rewrites at full depth; steps
        past a slot's draft count ``dn[:, 0]`` write into the trash
        block. Draft quality moves only the acceptance rate."""
        active, nd = st["active"], dn[:, 0]
        tok, pos = st["tok"], st["pos"]
        for j in range(self._spec_gamma):
            logits, _ = self.model._step_logits_paged(
                tok, st, pos, btab, write_mask=active & (j <= nd),
                n_layers=self._spec_layers,
                block_kernel=self._block_kernel,
                attn_unroll=self._attn_unroll)
            tok = torch.argmax(logits, dim=-1)
            dn[:, j + 1].copy_(tok)
            pos = pos + 1

    def _activate(self, slot, tok, pos, max_new, sp):
        st = self._state
        st["tok"][slot] = tok
        st["pos"][slot] = pos
        st["active"][slot] = True
        st["score"][slot] = 0.0
        st["count"][slot] = 0
        st["max_new"][slot] = max_new
        st["temp"][slot] = sp.temperature
        st["topk"][slot] = sp.top_k
        st["topp"][slot] = sp.top_p
        st["seed"][slot] = sp.seed

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

    def _alloc_one(self, rec, preempt=True):
        """One block for ``rec``, or None when ``rec`` was preempted to
        make room: the pool cannot serve it without taking blocks from
        strictly higher-priority (earlier-admitted) requests, so it
        yields. With priorities kept across preemption this cannot
        ping-pong; the oldest request always keeps its blocks.
        ``preempt=False`` stops the ladder after prefix eviction and
        returns None with ``rec`` untouched: optional draft positions
        never take committed work's blocks."""
        while True:
            got = self._pool.alloc(1)
            if got is not None:
                return got[0]
            if self._prefix is not None:
                freed = self._prefix.evict(1)
                if freed:
                    self.stats["prefix_evictions"] += freed
                    continue
            if not preempt:
                return None
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
        the resumed output is identical, and so is sampled decode: its
        draws are keyed on (seed, tokens generated), which restart with
        the request. Partial tokens are dropped."""
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

    def _grow_blocks_soft(self, rec, last_pos):
        """Best-effort table growth for speculative write positions:
        the allocation ladder without its preemption rung (drafts are
        optional work). Returns the highest position the table now
        covers; the caller shrinks the draft to fit."""
        last_pos = min(int(last_pos), self.model.max_len - 1)
        need = last_pos // self._block_size + 1 - len(rec["table"])
        for _ in range(max(0, need)):
            b = self._alloc_one(rec, preempt=False)
            if b is None:
                break
            rec["table"].append(b)
            rec["refs"].append(b)
        return len(rec["table"]) * self._block_size - 1

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
            if self._paged:
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
                    if self._paged:
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
        seeds the first decode step. The paged layout grows the slot's
        block table ahead of the chunk's writes (which may preempt)."""
        for slot, rec in enumerate(self._recs):
            if rec is None or rec["live"]:
                continue
            req = rec["req"]
            need = len(req.prompt) - 1      # teacher-forced prefix
            cur = rec["cursor"]
            if cur < need:
                toks = req.prompt[cur:min(cur + self._chunk, need)]
                if self._paged and not self._ensure_blocks(
                        rec, cur + len(toks) - 1):
                    continue               # rec preempted back to queue
                chunk = np.zeros((self._chunk,), np.int64)
                chunk[:len(toks)] = toks
                chunk = torch.from_numpy(chunk).to(self.device)
                if self._paged:
                    self.model._prefill_chunk_paged(
                        self._state, chunk, cur, len(toks),
                        self._btab_dev(self._btab_row(rec)),
                        block_kernel=self._block_kernel,
                        attn_unroll=self._attn_unroll)
                else:
                    self.model._prefill_chunk_slot(self._state, slot, chunk,
                                                   cur, len(toks))
                rec["cursor"] = cur + len(toks)
                req.prefill_chunks += 1
                self.stats["prefill_chunks"] += 1
            if rec["cursor"] >= need:
                if self._paged:
                    # the first decode step writes position `need`
                    if not self._ensure_blocks(rec, need):
                        continue
                    bi = need // self._block_size
                    if bi < rec["shared"] and not self._cow(rec, bi):
                        continue
                rec["next_pos"] = need
                self._activate(slot, req.prompt[-1], need, req.max_new,
                               req.sampling or _GREEDY)
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

    def _spec_cap(self, rec):
        """How many draft tokens this live slot can use: bounded by
        gamma, by its remaining ``max_new`` budget (n accepted drafts
        emit n+1 tokens) and by ``max_len`` (the scoring dispatch writes
        positions ``next_pos .. next_pos + n``)."""
        req = rec["req"]
        return min(self._spec_gamma,
                   req.max_new - len(req.tokens) - 1,
                   self.model.max_len - 1 - rec["next_pos"])

    def _build_drafts(self):
        """The drafting half of a speculative iteration: the draft count
        per live slot (the ngram drafter's proposals, or the truncated
        drafter's budget), then block coverage for the whole dispatch.
        Every live slot writes its next position even with no draft (it
        rides the scoring dispatch as a plain step), so that mandatory
        coverage walks the full pressure ladder as the plain path does;
        draft positions grow only best-effort (``_grow_blocks_soft``),
        and a draft shrinks to what its table covers. Returns
        ``(n_draft [S], drafts [S, gamma])`` int64 arrays (the truncated
        drafter's drafts are made on the device later: zeros here), or
        None when no slot drafted: the iteration then runs the plain or
        megastep dispatch."""
        nd = np.zeros((self.slots,), np.int64)
        drafts = np.zeros((self.slots, self._spec_gamma), np.int64)
        chains = None
        for slot, rec in enumerate(self._recs):
            if rec is None or not rec["live"]:
                continue
            cap = self._spec_cap(rec)
            if cap <= 0:
                continue
            if self._spec_kind == "truncated":
                nd[slot] = cap
                continue
            if chains is None:           # one trie walk per iteration
                chains = (self._prefix.token_chains()
                          if self._prefix is not None else ())
            req = rec["req"]
            prop = self._drafter.propose(req.prompt + req.tokens, cap,
                                         extra_chains=chains)
            drafts[slot, :len(prop)] = prop
            nd[slot] = len(prop)
        if not nd.any():
            return None
        # re-read each record per slot: an earlier slot's mandatory
        # growth may have preempted this one
        for slot in range(self.slots):
            rec = self._recs[slot]
            if rec is None or not rec["live"] \
                    or not self._ensure_blocks(rec, rec["next_pos"]):
                nd[slot] = 0
                continue
            if nd[slot]:
                covered = self._grow_blocks_soft(
                    rec, rec["next_pos"] + int(nd[slot]))
                nd[slot] = max(0, min(int(nd[slot]),
                                      covered - rec["next_pos"]))
        for slot, rec in enumerate(self._recs):
            # a later slot's mandatory growth may have preempted an
            # earlier drafted one
            if rec is None or not rec["live"]:
                nd[slot] = 0
        if not nd.any():
            return None
        return nd, drafts

    def _sampled(self, live):
        """Whether a live slot holds a sampled request: only then does a
        dispatch run the sampled variant of its step."""
        return any(self._recs[s]["req"].sampling is not None for s in live)

    def _decode_spec(self, nd, drafts):
        """One speculative scoring dispatch over the active batch: one
        packed upload (``dn`` [S, gamma+1] into a fixed buffer), the
        truncated drafter's steps when it drafts, the scoring step, one
        packed fetch (``out`` [S, gamma+3]); then the accepted prefix
        plus the bonus token are committed on the host. Counts as one
        decode step. Returns [(request, score)]."""
        live = [s for s, r in enumerate(self._recs)
                if r is not None and r["live"]]
        t0 = time.perf_counter()
        self._set_btab(self._btab_all())
        sampled = self._sampled(live)
        self._spec_in.copy_(torch.from_numpy(
            np.concatenate([nd[:, None], drafts], axis=1)))
        if self._spec_kind == "truncated":
            try:
                self._draft_truncated_impl(self._state, self._btab,
                                           self._spec_in)
            except RuntimeError as e:
                raise RuntimeError("speculative drafting dispatch failed "
                                   "(no fallback): %s" % (e,)) from e
            self.stats["spec_draft_steps"] += self._spec_gamma
        try:
            self._spec_step_impl(self._state, self._btab, self._spec_in,
                                 self._spec_out, sampled)
            out = self._spec_out.cpu().numpy()
        except RuntimeError as e:
            raise RuntimeError("speculative scoring dispatch failed (no "
                               "fallback): %s" % (e,)) from e
        self.stats["decode_seconds"] += time.perf_counter() - t0
        g1 = self._spec_gamma + 1
        emits, n_emit, fins = out[:, :g1], out[:, g1], out[:, g1 + 1]
        emitted = accepted = 0
        scores = None
        finished = []
        now = time.perf_counter()
        for slot in live:
            rec = self._recs[slot]
            req = rec["req"]
            ne = int(n_emit[slot])
            req.tokens.extend(int(t) for t in emits[slot, :ne])
            emitted += ne
            accepted += max(0, ne - 1)
            rec["next_pos"] += ne               # mirrors the device pos
            self._publish_prefix(rec, req)
            if ne and req.t_first_token is None:
                req.t_first_token = now
            if fins[slot]:
                req.t_retire = now
                if scores is None:              # one [S] fetch a dispatch
                    scores = self._state["score"].cpu().numpy()
                finished.append((req, float(scores[slot])))
                self._release_blocks(rec)
                self._recs[slot] = None
        self.stats["spec_dispatches"] += 1
        self.stats["spec_drafted"] += int(nd.sum())
        self.stats["spec_accepted"] += accepted
        self.stats["spec_emitted"] += emitted
        self.stats["decode_steps"] += 1
        self.stats["active_slot_steps"] += len(live)
        self.stats["tokens"] += emitted
        return finished

    def _decode(self, k=1):
        """One decode dispatch over the active batch: a single eager
        step (k=1), or K steps in one dispatch (the CUDA graph on the
        card). First grow every live slot's table to cover the write
        positions it can consume in this dispatch (the pressure ladder
        may preempt here), then run, fetch the [K, S] emits and flags in
        one copy, and retire finished requests. A slot retired at step j
        consumes no later rows. A speculative engine drafts first: when
        any live slot has a draft, one scoring dispatch
        (``_decode_spec``) takes the iteration's place. Returns
        [(request, score)]."""
        if self._speculative:
            got = self._build_drafts()
            if got is not None:
                return self._decode_spec(*got)
        for slot in range(self.slots):
            # re-read per slot: an earlier slot's allocation may have
            # preempted this one
            rec = self._recs[slot]
            if self._paged and rec is not None and rec["live"]:
                # a request with fewer tokens left than k must not walk
                # the pressure ladder for positions it will never write
                rem = max(1, rec["req"].max_new - len(rec["req"].tokens))
                self._ensure_blocks(rec, rec["next_pos"] + min(k, rem) - 1)
        live = [s for s, r in enumerate(self._recs)
                if r is not None and r["live"]]
        if not live:
            return []
        t0 = time.perf_counter()
        if self._paged:
            self._set_btab(self._btab_all())
        sampled = self._sampled(live)
        if k > 1 and self.device.type == "cuda":
            if self._graphs[sampled] is None:
                self._capture(sampled)
            self._graphs[sampled].replay()
            self.stats["graph_replays"] += 1
        else:                   # the CPU, or one eager step on the card
            self._megastep_impl(self._state, self._btab,
                                self._mega_out[:, :k], sampled)
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
                    if self._paged:
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
            if self._paged:
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
