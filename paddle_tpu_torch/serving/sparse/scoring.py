"""ScoringEngine: the serving Engine's scheduling shape, generalized
from LM decode slots to heterogeneous feature batches for dense
scoring (DeepFM / ResNet-style zoo programs).

The port's copy of ``paddle_tpu/serving/sparse/scoring.py`` (the scoring
dispatch runs the port's ``Executor``, on the card unless
``place=CPUPlace()`` is passed).

Where the decode Engine owns a KV cache and emits tokens, the scoring
engine owns nothing between requests — one request is one example
(ragged per-field sparse id lists + optional dense features), one
iteration is ONE compiled scoring dispatch over a fixed-size padded
batch:

  * **Iteration-level batching** — a thread-safe queue feeds
    admissions at step boundaries; up to ``batch`` requests score per
    dispatch, short batches PAD to the compiled shape (the compiled
    program never re-traces as traffic ebbs), padded rows' outputs are
    sliced off host-side.
  * **Featurizer** — raggedness never reaches the compiled program: a
    zoo-provided callback (e.g. ``models.deepfm.make_featurizer``)
    resolves every sparse id through the ``SparseClient`` hot-ID cache
    (ONE deduplicated batched prefetch across the whole admitted batch
    per table), pools multi-hot fields, and returns the fixed-shape
    feed dict.
  * **Determinism** — scoring is a pure function of (program weights,
    fetched rows), so at a pinned cache version a routed re-execution
    on a survivor replica is bitwise the direct run: the fleet's
    exactly-once journal composes unchanged (the handle protocol below
    is the decode ``Request``'s, scores riding the existing result
    wire as ``score`` with empty ``tokens``).
  * **Telemetry** — every iteration lands the standard
    ``serving_step`` row (+ the hot-ID cache's cumulative
    hits/misses/stale/evictions, the figures ``monitor watch`` renders
    as the sparse cache line) and every request the standard
    ``serving_request`` row: queue_wait is slot wait, the
    TTFT-analogue is the full request latency (submit -> score), so
    the existing histograms, SLO specs, flight recorder and trace
    spans serve both workloads without a new schema.
"""

import collections
import threading
import time

import numpy as np

from ...monitor import runtime as _monrt
from ...trace import runtime as _trc
from ..engine import _flag

__all__ = ["ScoringRequest", "ScoringEngine"]


class ScoringRequest:
    """One submitted scoring example; also the result handle — the
    decode ``Request`` protocol (``done()`` / ``result()`` / lifecycle
    stamps / ``rid`` / ``tokens``+``score``) so the fleet tier
    (ReplicaServer journal, Router dedup) serves it unchanged.
    ``result()`` returns ``([], score)``: the score rides the decode
    result wire's ``score`` field with an empty token list."""

    __slots__ = ("features", "tokens", "score", "versions", "rid",
                 "_event", "_error", "t_enqueue", "t_admit",
                 "t_first_token", "t_retire", "prefill_chunks",
                 "_span", "sampling", "preemptions")

    def __init__(self, features, request_id=None):
        if not isinstance(features, dict) or not features:
            raise ValueError(
                "scoring features must be a non-empty dict of "
                "field -> id list / dense value, got %r"
                % (type(features).__name__,))
        self.features = features
        self.rid = request_id
        self.tokens = []          # decode-wire compatibility (empty)
        self.score = None
        self.versions = None      # {table: {shard: {inc, round}}}
        self.sampling = None      # decode-protocol compatibility
        self.preemptions = 0
        self.prefill_chunks = 0
        self._event = threading.Event()
        self._error = None
        self.t_enqueue = time.perf_counter()
        self.t_admit = None
        self.t_first_token = None
        self.t_retire = None
        attrs = {"fields": len(features)}
        if request_id is not None:
            attrs["rid"] = str(request_id)
        self._span = _trc.detached_span("serving.request", **attrs)
        self._span.start()

    @property
    def queue_wait(self):
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_enqueue

    @property
    def ttft(self):
        """The TTFT-analogue: submit -> score delivered (scoring has
        no stream, so first token IS completion)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_enqueue

    @property
    def tpot(self):
        return None               # no inter-token interval to report

    def latency(self):
        return {"queue_wait": self.queue_wait, "ttft": self.ttft,
                "tpot": None, "tokens": len(self.tokens),
                "prefill_chunks": 0}

    def done(self):
        return self._event.is_set()

    def _finish(self, score):
        self.score = score
        self._event.set()

    def _fail(self, err):
        self._error = err
        self._event.set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                "scoring request not finished within %r s" % (timeout,))
        if self._error is not None:
            raise RuntimeError(
                "scoring engine failed: %r" % (self._error,))
        return list(self.tokens), self.score


class ScoringEngine:
    """Iteration-batched dense scoring over one compiled zoo program.

    ``program``/``scope``/``fetch_name``: the scoring Program (e.g.
    ``models.deepfm.build_scoring_net``), the scope holding its dense
    params, and the fetch to slice scores from. ``featurizer``:
    ``fn(features_list, batch) -> feed dict`` producing the FIXED
    [batch, ...] shapes (padding included) — the zoo side of the
    contract; it owns every SparseClient lookup. ``clients``: the
    SparseClients the featurizer reads through (the engine snapshots
    their cache versions / counters for telemetry and version
    pinning). ``batch``: the compiled batch capacity (flag
    ``serving_scoring_batch``). ``place``: where the scoring dispatch
    runs, the CUDA card (``CUDAPlace(0)``) unless ``CPUPlace()`` is
    passed."""

    def __init__(self, program, scope, fetch_name, featurizer,
                 clients=(), batch=None, name="scoring", place=None):
        from ...core.executor import Executor
        from ...core.places import CUDAPlace
        self.name = name
        self._program = program
        self._scope = scope
        self._fetch = fetch_name
        self._featurizer = featurizer
        self._clients = list(clients)
        self.batch = int(batch if batch is not None
                         else _flag("serving_scoring_batch", 8))
        if self.batch < 1:
            raise ValueError("batch must be >= 1, got %r"
                             % (self.batch,))
        # fleet-protocol surface: the ReplicaServer reads .slots for
        # STAT and .stats for steps/tokens/admissions
        self.slots = self.batch
        self._exe = Executor(place if place is not None
                             else CUDAPlace(0))
        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._stop = False
        self._error = None
        self.stats = {"steps": 0, "tokens": 0, "admissions": 0,
                      "retirements": 0, "scored": 0, "dispatches": 0,
                      "batch_failures": 0}
        self.on_retire = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ptpu-" + name)
        self._thread.start()

    @classmethod
    def from_artifact(cls, dirname, featurizer, fetch_name=None, **kw):
        """Serving cold-start: boot the scoring cell from a
        ``io.save_inference_model`` artifact directory — the verified
        (CRC-manifested, transform-specialized) Program + params load
        into a PRIVATE scope; the fetch defaults to the artifact's
        first fetch target. ``featurizer`` stays a caller argument
        (it owns the live SparseClient wiring an artifact cannot
        capture)."""
        from ... import io as _io
        from ...core.scope import Scope
        scope = Scope()
        program, _feeds, fetches = _io.load_inference_model(
            dirname, None, scope=scope)
        if fetch_name is None:
            if not fetches:
                raise _io.ArtifactError(
                    "artifact %s names no fetch targets and no "
                    "fetch_name was given" % (dirname,))
            fetch_name = fetches[0].name
        return cls(program, scope, fetch_name, featurizer, **kw)

    # -- public API --------------------------------------------------------
    def warmup(self):
        """Compile the fixed-shape scoring dispatch before traffic:
        one dispatch over an all-padding batch (scores discarded)."""
        feed = self._featurizer([], self.batch)
        self._exe.run(self._program, feed=feed,
                      fetch_list=[self._fetch], scope=self._scope)
        return self

    def submit(self, features, request_id=None, version_pin=None):
        """Enqueue one example; returns its handle. ``features``: dict
        field -> ragged id list (or dense value) — validated here so
        the fleet's BADR typed-reject covers malformed payloads.
        ``version_pin`` is advisory: the handle's ``versions`` records
        the cache version coordinates actually served, which the
        caller compares against its pin (scoring is deterministic
        GIVEN a version, so equal versions imply bitwise-equal
        scores)."""
        # schema validation happens HERE, not in the scheduler loop: a
        # featurizer exposing .validate (models.deepfm.make_featurizer
        # does) rejects malformed payloads at the submit/BADR surface,
        # so one bad request can never fail a co-admitted batch
        validate = getattr(self._featurizer, "validate", None)
        if validate is not None:
            validate(features)
        req = ScoringRequest(features, request_id=request_id)
        with self._cv:
            if self._stop:
                req._span.finish(error="engine closed")
                err = self._error
                if err is not None:
                    raise RuntimeError(
                        "scoring engine is closed (loop died: %r)"
                        % (err,))
                raise RuntimeError("scoring engine is closed")
            self._queue.append(req)
            self._cv.notify_all()
        return req

    def score_many(self, features_list, timeout=120.0):
        """Synchronous convenience: submit every example, block for
        all scores (input order)."""
        handles = [self.submit(f) for f in features_list]
        return [h.result(timeout=timeout)[1] for h in handles]

    def cache_stats(self):
        """Merged cumulative hot-ID cache counters across this
        engine's clients (distinct caches counted once)."""
        out = {"hits": 0, "misses": 0, "stale": 0, "evictions": 0}
        seen = set()
        for c in self._clients:
            if id(c.cache) in seen:
                continue
            seen.add(id(c.cache))
            for k in out:
                out[k] += c.cache.stats[k]
        return out

    def versions(self):
        """{table: {shard: {"inc", "round"}}} across the clients —
        the served cache version a request pin compares against.
        Shard keys are STRINGS: this dict travels the JSON result
        wire, and a locally computed pin must compare equal to a
        routed handle's ``versions`` without key juggling."""
        return {c.table: {str(s): v
                          for s, v in c.latest_versions().items()}
                for c in self._clients}

    def close(self):
        with self._cv:
            already = self._stop
            self._stop = True
            self._cv.notify_all()
        if already:
            return
        self._thread.join()
        self._fail_all(RuntimeError("scoring engine closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- scheduler loop ----------------------------------------------------
    def _loop(self):
        try:
            while True:
                with self._cv:
                    while not self._stop and not self._queue:
                        self._cv.wait()
                    if self._stop:
                        return
                self._step_once()
        except BaseException as e:
            with self._cv:
                self._stop = True
                self._error = e
            self._fail_all(e)

    def _step_once(self):
        reqs = []
        with self._cv:
            now = time.perf_counter()
            while self._queue and len(reqs) < self.batch:
                req = self._queue.popleft()
                req.t_admit = now
                reqs.append(req)
            depth = len(self._queue)
        if not reqs:
            return
        try:
            with _trc.span("engine.step") as sp:
                t0 = time.perf_counter()
                feed = self._featurizer([r.features for r in reqs],
                                        self.batch)
                outs = self._exe.run(self._program, feed=feed,
                                     fetch_list=[self._fetch],
                                     scope=self._scope)
                scores = np.asarray(outs[0]).reshape(-1)[:len(reqs)]
                versions = self.versions() if self._clients else None
                now = time.perf_counter()
                dt = now - t0
                for req, s in zip(reqs, scores):
                    req.score = float(s)
                    req.versions = versions
                    req.t_first_token = now
                    req.t_retire = now
                self.stats["steps"] += 1
                self.stats["dispatches"] += 1
                self.stats["admissions"] += len(reqs)
                self.stats["retirements"] += len(reqs)
                self.stats["scored"] += len(reqs)
                # "tokens" = scored examples: the STAT/watch tokens/s
                # figure reads as examples/s for a scoring replica
                self.stats["tokens"] += len(reqs)
                sp.annotate(active=len(reqs), admitted=len(reqs),
                            retired=len(reqs), queue=depth, dt=dt, k=1)
                cs = self.cache_stats()
                _monrt.on_serving_step(
                    active=len(reqs), slots=self.batch,
                    queue_depth=depth, emitted=len(reqs),
                    admitted=len(reqs), retired=len(reqs),
                    engine=self.name, dt=dt,
                    cache_hits=cs["hits"], cache_misses=cs["misses"],
                    cache_stale=cs["stale"],
                    cache_evictions=cs["evictions"])
                for req in reqs:
                    self._retire_telemetry(req)
        except Exception as e:
            # fail THIS batch with attribution but keep the engine
            # serving: scoring holds no cross-iteration device state
            # (unlike the decode engine's KV cache), so a transient
            # featurizer/wire error — a prefetch that died past the
            # retry deadline mid-pserver-respawn — must not become a
            # permanent engine death. The fleet tier's at-least-once
            # dispatch re-executes the failed ids on retry/requeue.
            self.stats["batch_failures"] += 1
            for req in reqs:
                if req.t_retire is None:
                    req.t_retire = time.perf_counter()
                self._retire_telemetry(req, error=e)
                req._fail(e)
            self._deliver(reqs)
        else:
            for req in reqs:
                req._finish(req.score)
            self._deliver(reqs)

    def _deliver(self, reqs):
        cb = self.on_retire
        if cb is None:
            return
        for req in reqs:
            try:
                cb(req)
            except Exception:
                pass

    def _retire_telemetry(self, req, error=None):
        try:
            lat = req.latency()
            ctx = req._span.ctx
            _monrt.on_serving_request(
                engine=self.name, queue_wait=lat["queue_wait"],
                ttft=lat["ttft"], tpot=None, tokens=1,
                prompt_len=len(req.features),
                trace_id=(ctx.trace_id
                          if ctx is not None and ctx.sampled else None),
                error=None if error is None else repr(error))
            req._span.annotate(
                **{k: v for k, v in lat.items() if v is not None})
        except Exception:
            pass
        try:
            req._span.finish(error=error)
        except Exception:
            pass

    def _fail_all(self, err):
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            if req.t_retire is None:
                req.t_retire = time.perf_counter()
            self._retire_telemetry(req, error=err)
            req._fail(err)
        self._deliver(pending)
