"""Online learning against live pservers, while serving reads.

The port's copy of ``paddle_tpu/serving/sparse/online.py`` (pure host
code over the port's ``distributed.rpc``).

The legacy async-SGD capability (ParameterServer2 async paths) recast
for the serving tier: a background updater pushes SelectedRows sparse
gradients to the SAME row shards the ScoringEngine's SparseClient
reads from — the pserver's server-side lazy sparse optimizer applies
them row-at-a-time, and the hot-ID cache's bounded staleness caps how
long a serve can keep returning the pre-update row.

Two pieces:

  * ``OnlineTrainer`` — routes deduplicated sparse grads per shard
    (global row ids, ``id % n`` placement — the ``send_sparse`` host
    op's wire shape) under ROUND-format idempotency tags, so the
    retry ``Policy`` may transparently re-issue a torn push without
    double-applying (the pserver's tag dedup is the same machinery
    the training tier rides). A per-push barrier closes the round on
    every shard (the pservers run ``fan_in`` = the updater count).
  * ``measure_staleness`` — the read-your-writes probe: land one
    update (push + barrier acked = t_land), then read the touched row
    THROUGH the serving cache until the value reflects it; the delta
    is the end-to-end staleness the SLO ``staleness_s`` objective
    gates (observed into ``ptpu_sparse_staleness_seconds`` + a
    ``sparse_staleness`` recorder row). By construction it is bounded
    by cache ``staleness_s`` + one pserver round + one wire trip —
    the contract the bound exists to give.
"""

import itertools
import os
import threading
import time
import uuid

import numpy as np

from ...core.selected_rows import SelectedRows
from ...distributed.rpc import RPCClient
from ...monitor import runtime as _monrt
from ...resilience.retry import default_policy

__all__ = ["OnlineTrainer", "measure_staleness"]


class OnlineTrainer:
    """Push sparse row gradients of ONE table to its live shards.

    ``grad_name`` defaults to ``<table>@GRAD`` (what the pserver's
    optimize block binds). ``update_fn``: optional callable returning
    ``(ids, grad_rows)`` per tick for the background loop; without it
    the trainer is push-driven (call ``push`` yourself)."""

    def __init__(self, table, endpoints, grad_name=None, height=None,
                 update_fn=None, interval=0.05, retry=None,
                 trainer_id=None, kv=None, role="ps"):
        self.table = table
        self.grad_name = grad_name or (table + "@GRAD")
        self.height = height
        self._eps = list(endpoints)
        if not self._eps:
            # an empty shard list would make push() report rounds as
            # landed while sending nothing — the config error must
            # fail HERE, not as a misleading staleness timeout later
            raise ValueError("OnlineTrainer needs >= 1 shard endpoint")
        self._kv = kv
        self._role = role
        self._retry = retry if retry is not None else default_policy()
        self._clients = {}
        self._update_fn = update_fn
        self._interval = float(interval)
        # ROUND-format tag prefix ('t<id>:i<inc>:s<seq>'): licenses
        # transparent retry re-issue — the pserver dedups by parsed
        # prefix + seq across rounds (rpc.py SEND/BARR)
        tid = trainer_id if trainer_id is not None \
            else "online%d" % os.getpid()
        self._pref = "t%s:i%016x%s" % (tid, int(time.time() * 1e6),
                                       uuid.uuid4().hex[:4])
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.stats = {"pushes": 0, "rows": 0, "rounds": 0,
                      "errors": 0}

    def _client(self, shard):
        cli = self._clients.get(shard)
        if cli is None:
            resolver = None
            if self._kv is not None:
                # membership-backed resolver per shard slot, like
                # SparseClient's: a replacement pserver recovered from
                # checkpoint on a new port is followed transparently
                from ...distributed import membership as _membership
                key = _membership.role_prefix(self._role) + str(shard)
                kv = self._kv

                def resolver(key=key):
                    ep = kv.get(key)
                    if ep and not ep.startswith(
                            _membership.EVICTED_PREFIX):
                        return ep
                    return None

            cli = self._clients[shard] = RPCClient(
                self._eps[shard], timeout=10.0, retry=self._retry,
                resolver=resolver)
        return cli

    def _drop_client(self, shard):
        cli = self._clients.pop(shard, None)
        if cli is not None:
            cli.close()

    def push(self, ids, grad_rows):
        """Route one batch of (global id, grad row) pairs to their
        shards and close the round with a barrier on EVERY shard (a
        shard that received no rows this round still needs the round
        signal — listen_and_serv fan_in semantics). Duplicate ids are
        summed first (lookup_table_grad SelectedRows semantics).
        Returns the wall-clock instant the round was fully applied
        (every barrier acked) — the 'update landed' stamp the
        staleness probe measures from."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        rows = np.asarray(grad_rows, np.float32).reshape(len(ids), -1)
        uniq, inv = np.unique(ids, return_inverse=True)
        acc = np.zeros((len(uniq), rows.shape[1]), rows.dtype)
        np.add.at(acc, inv, rows)
        n = max(1, len(self._eps))
        height = self.height if self.height is not None else 0
        with self._lock:
            tag = "%s:s%d" % (self._pref, next(self._seq))
            try:
                for i in range(len(self._eps)):
                    mask = (uniq % n) == i
                    if mask.any():
                        self._client(i).send_var(
                            self.grad_name,
                            SelectedRows(uniq[mask], acc[mask],
                                         height),
                            tag=tag)
                for i in range(len(self._eps)):
                    self._client(i).barrier(tag=tag)
            except BaseException:
                # a push that died past the retry deadline may leave a
                # cached client mid-stream on a replaced endpoint —
                # rebuild lazily so the NEXT round re-resolves fresh
                for i in range(len(self._eps)):
                    self._drop_client(i)
                raise
            self.stats["pushes"] += 1
            self.stats["rows"] += int(len(uniq))
            self.stats["rounds"] += 1
        return time.perf_counter()

    # -- background loop ---------------------------------------------------
    def start(self):
        if self._update_fn is None:
            raise ValueError("start() needs an update_fn")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ptpu-online")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                ids, rows = self._update_fn()
                if len(np.asarray(ids).reshape(-1)):
                    self.push(ids, rows)
            except Exception:
                # a torn push past the retry deadline (mid-respawn):
                # counted, retried next tick — the updater must not
                # die while the pserver recovers
                self.stats["errors"] += 1

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def close(self):
        self.stop()
        with self._lock:
            clients, self._clients = self._clients, {}
        for cli in clients.values():
            cli.close()


def measure_staleness(trainer, client, probe_id, delta=1.0,
                      timeout=30.0, poll_s=0.005):
    """End-to-end read-your-writes staleness for ONE update:

    1. read the probe row through the serving cache (pre-image),
    2. land an update moving it by ``delta`` (push + every barrier
       acked = t_land),
    3. poll the SAME serving read path until the returned row reflects
       the update; staleness = that instant - t_land.

    The serving path is the measured object: a cached pre-image row
    legitimately serves until the staleness bound stales it, so the
    measured figure ≈ cache residual age + one wire trip — the
    quantity the SLO ``staleness_s`` objective bounds. Observed into
    the ``ptpu_sparse_staleness_seconds`` histogram + a
    ``sparse_staleness`` recorder row."""
    probe_id = int(probe_id)
    before = np.asarray(client.lookup([probe_id])[0], np.float64)
    width = before.shape[-1]
    # the pserver applies -lr * grad; any sign works — we only need
    # the serve-visible value to MOVE
    grad = np.full((1, width), float(delta), np.float32)
    t_land = trainer.push([probe_id], grad)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        now_row = np.asarray(client.lookup([probe_id])[0], np.float64)
        if not np.allclose(now_row, before):
            staleness = time.perf_counter() - t_land
            _monrt.on_sparse_staleness(staleness, table=client.table)
            return staleness
        time.sleep(poll_s)
    raise TimeoutError(
        "update to id %d never became visible through the serving "
        "path within %.1fs (stale-forever row — the contract the "
        "staleness bound exists to forbid)" % (probe_id, timeout))
