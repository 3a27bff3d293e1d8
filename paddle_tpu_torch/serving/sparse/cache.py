"""Hot-ID embedding cache + batched pserver prefetch client.

The port's copy of ``paddle_tpu/serving/sparse/cache.py`` (pure host
code over the port's ``distributed.rpc``).

The trainer-side sparse path (distributed/ops.py ``_prefetch``) pulls
touched rows per STEP and throws them away; serving traffic is zipfian
— a small hot set of ids dominates every scoring batch — so the serving
tier fronts the live pserver shards with a per-process LRU keyed by
(table, id), the Monolith-style shape: collisionless rows, realtime
updates, bounded staleness.

Staleness contract (the part a naive cache gets wrong while training
keeps mutating the tables underneath):

  * every cached row carries the (round, incarnation) version
    coordinates its PRFT reply was stamped with (rpc.py serves them in
    the reply name; a pre-versioning server yields unversioned rows
    that only the time bound governs),
  * a row older than ``staleness_s`` re-fetches (bounded staleness —
    the time an online update can take to become visible through the
    cache is capped by construction),
  * an observed ROUND bump on a shard marks that shard's older-round
    rows stale (version-bump invalidation: one fresh fetch reveals the
    update round, and every colder row re-fetches on next touch
    instead of waiting out its clock),
  * an observed INCARNATION change drops the shard's rows outright — a
    replacement pserver recovered from checkpoint may have rolled back
    past rounds the cache has seen, so round arithmetic against it
    would be lying (the chaos gate pins "no stale-forever rows").

``SparseClient`` composes the cache with the existing wire machinery:
PRFT against the row shards (ids mod-sharded exactly like
``distributed/ops._prefetch``), DEDUPLICATED and batched per shard, the
resilience retry ``Policy`` underneath, and an optional membership
resolver per shard so a replacement pserver on a new port is followed
transparently. The measured miss-path cost (EWMA seconds/row) feeds the
autoparallel placement pricing hook
(``transform.autoparallel.recommend_embedding_placement``).
"""

import collections
import threading
import time

import numpy as np

from ...distributed import membership as _membership
from ...distributed.rpc import RPCClient
from ...monitor import runtime as _monrt
from ...resilience.retry import default_policy
from ..engine import _flag

__all__ = ["HotIDCache", "SparseClient"]


class HotIDCache:
    """Per-process LRU of embedding rows with bounded staleness.

    Keys are (table, id); values carry the row, its fetch time and its
    shard version coordinates. Thread-safe (the scoring loop and an
    online staleness probe may share one cache). ``capacity`` bounds
    ROWS, not bytes — rows of one table are same-width, and mixed
    tables stay comparable enough for an LRU."""

    def __init__(self, capacity=None, staleness_s=None):
        self.capacity = int(capacity if capacity is not None
                            else _flag("serving_sparse_cache_rows",
                                       65536))
        self.staleness_s = float(
            staleness_s if staleness_s is not None
            else _flag("serving_sparse_staleness_s", 5.0))
        self._lock = threading.Lock()
        self._rows = collections.OrderedDict()  # (table,id) -> entry
        # (table, shard) -> {"inc": str|None, "round": int}: the newest
        # version coordinates EVER OBSERVED for the shard — the bar a
        # cached row's own version is judged against
        self._latest = {}
        self.stats = {"hits": 0, "misses": 0, "stale": 0,
                      "evictions": 0, "invalidations": 0}

    # -- version observation ------------------------------------------------
    def observe_version(self, table, shard, ver):
        """Fold one PRFT reply's version coordinates into the shard's
        high-water mark. An incarnation CHANGE drops every cached row
        of the shard (a respawned server's store may have rolled back —
        round comparison against it is meaningless); a round advance
        just raises the bar, lazily staling colder rows."""
        if ver is None:
            return
        key = (table, int(shard))
        with self._lock:
            cur = self._latest.get(key)
            if cur is not None and cur["inc"] != ver["inc"]:
                self._invalidate_shard_locked(table, shard)
            if cur is None or cur["inc"] != ver["inc"] \
                    or ver["round"] > cur["round"]:
                self._latest[key] = {"inc": ver["inc"],
                                     "round": int(ver["round"])}

    def _invalidate_shard_locked(self, table, shard):
        n = 0
        for k in [k for k in self._rows
                  if k[0] == table and k[1] % self._nshards(table)
                  == shard]:
            del self._rows[k]
            n += 1
        if n:
            self.stats["evictions"] += n
            self.stats["invalidations"] += 1
            _monrt.on_sparse_evictions(n)

    def _nshards(self, table):
        # shard count inferred from observed shards (max index + 1);
        # only used to map cached ids back to shards on invalidation
        shards = [s for (t, s) in self._latest if t == table]
        return max(shards) + 1 if shards else 1

    # -- row access ---------------------------------------------------------
    def split(self, table, ids, nshards, now=None):
        """Partition deduplicated ``ids`` into (served, need_fetch):
        ``served`` maps id -> row for entries that are present, within
        the staleness bound AND not older than the shard's observed
        version; everything else lands in ``need_fetch``. Counters
        tick here (one batched lookup = one hook call)."""
        now = time.monotonic() if now is None else now
        served, need, stale = {}, [], 0
        with self._lock:
            for i in ids:
                key = (table, int(i))
                ent = self._rows.get(key)
                if ent is None:
                    need.append(int(i))
                    continue
                latest = self._latest.get((table, int(i) % nshards))
                ok = (now - ent["t"]) <= self.staleness_s
                if ok and latest is not None and ent["ver"] is not None:
                    if ent["ver"]["inc"] != latest["inc"] \
                            or ent["ver"]["round"] < latest["round"]:
                        ok = False
                if ok:
                    self._rows.move_to_end(key)
                    served[int(i)] = ent["row"]
                else:
                    del self._rows[key]
                    stale += 1
                    need.append(int(i))
        _monrt.on_sparse_lookup(hits=len(served), misses=len(need),
                                stale=stale)
        self.stats["hits"] += len(served)
        self.stats["misses"] += len(need)
        self.stats["stale"] += stale
        return served, need

    def insert(self, table, ids, rows, ver, now=None):
        """Publish freshly fetched rows (one shard's batch) with their
        version coordinates; LRU-evicts past capacity."""
        now = time.monotonic() if now is None else now
        evicted = 0
        with self._lock:
            for i, row in zip(ids, rows):
                self._rows[(table, int(i))] = {
                    "row": np.asarray(row), "t": now, "ver": ver}
                self._rows.move_to_end((table, int(i)))
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)
                evicted += 1
        if evicted:
            self.stats["evictions"] += evicted
            _monrt.on_sparse_evictions(evicted)

    def __len__(self):
        with self._lock:
            return len(self._rows)

    def clear(self):
        with self._lock:
            n = len(self._rows)
            self._rows.clear()
            self._latest.clear()
        if n:
            self.stats["evictions"] += n
            _monrt.on_sparse_evictions(n)


class SparseClient:
    """Batched, deduplicated, cache-fronted row reads of ONE sharded
    embedding table living on live pservers.

    ``endpoints``: the shard endpoints in shard order (id % n routing,
    the ``distributed/ops._prefetch`` placement). ``kv``: optional
    membership KVClient — each shard's RPCClient then gets a resolver
    following role-slot ``/<role>/<shard>``, so a replacement pserver
    that recovered from checkpoint after a lease expiry is found at its
    new port (PRs 3-4 machinery, reused verbatim). ``cache``: a shared
    ``HotIDCache`` (one per process, possibly shared across tables) or
    None for a private one."""

    def __init__(self, table, endpoints, kv=None, role="ps",
                 cache=None, retry=None, timeout=10.0):
        self.table = table
        self._eps = list(endpoints)
        if not self._eps:
            raise ValueError("SparseClient needs >= 1 shard endpoint")
        self._kv = kv
        self._role = role
        self._timeout = float(timeout)
        self._retry = retry if retry is not None else default_policy()
        self.cache = cache if cache is not None else HotIDCache()
        self._clients = [None] * len(self._eps)
        self._lock = threading.Lock()
        # EWMA per-row seconds of the MISS path (wire round trip /
        # rows fetched) — the measured figure the autoparallel
        # placement hook prices the pserver tier with
        self._miss_row_s = None
        self.stats = {"lookups": 0, "wire_rows": 0, "wire_bytes": 0,
                      "prefetches": 0}

    # -- wiring -------------------------------------------------------------
    def _client(self, shard):
        with self._lock:
            cli = self._clients[shard]
            if cli is not None:
                return cli
            resolver = None
            if self._kv is not None:
                key = _membership.role_prefix(self._role) + str(shard)
                kv = self._kv

                def resolver(key=key):
                    ep = kv.get(key)
                    if ep and not ep.startswith(
                            _membership.EVICTED_PREFIX):
                        return ep
                    return None

            cli = RPCClient(self._eps[shard], timeout=self._timeout,
                            retry=self._retry, resolver=resolver)
            self._clients[shard] = cli
            return cli

    def _drop_client(self, shard):
        with self._lock:
            cli, self._clients[shard] = self._clients[shard], None
        if cli is not None:
            cli.close()

    @property
    def num_shards(self):
        return len(self._eps)

    # -- the read path ------------------------------------------------------
    def lookup(self, ids):
        """ids (any int array/list, duplicates fine) -> rows [len, D]
        aligned with the request order. One deduplicated, per-shard
        batched PRFT per miss set; hits come straight from the hot-ID
        cache under the staleness contract."""
        ids_arr = np.asarray(ids, np.int64).reshape(-1)
        self.stats["lookups"] += 1
        n = len(self._eps)
        uniq = np.unique(ids_arr)
        served, need = self.cache.split(self.table, uniq, n)
        if need:
            need = np.asarray(need, np.int64)
            for shard in range(n):
                part = need[need % n == shard]
                if len(part) == 0:
                    continue
                sr, ver = self._prefetch_shard(shard, part)
                self.cache.observe_version(self.table, shard, ver)
                rows = sr.value.reshape(len(part), -1)
                self.cache.insert(self.table, part, rows, ver)
                for i, row in zip(part, rows):
                    served[int(i)] = row
        width = next(iter(served.values())).shape[-1] if served else 1
        if not len(ids_arr):
            return np.zeros((0, width), np.float32)
        return np.stack([np.asarray(served[int(i)], np.float32)
                         for i in ids_arr])

    def _prefetch_shard(self, shard, part):
        t0 = time.perf_counter()
        try:
            sr, ver = self._client(shard).prefetch(
                self.table, part, want_version=True)
        except BaseException:
            # the cached client may hold a dead socket to a replaced
            # endpoint — rebuild lazily so the NEXT attempt re-resolves
            self._drop_client(shard)
            raise
        dt = time.perf_counter() - t0
        nbytes = int(sr.value.nbytes + sr.rows.nbytes)
        self.stats["prefetches"] += 1
        self.stats["wire_rows"] += len(part)
        self.stats["wire_bytes"] += nbytes
        _monrt.on_sparse_prefetch(len(part), nbytes)
        per_row = dt / max(1, len(part))
        self._miss_row_s = per_row if self._miss_row_s is None \
            else 0.8 * self._miss_row_s + 0.2 * per_row
        return sr, ver

    def miss_row_seconds(self):
        """Measured miss-path cost (EWMA seconds per fetched row), or
        None before the first wire pull — feed it to
        ``transform.autoparallel.recommend_embedding_placement(...,
        measured_sparse_row_s=...)`` to price placement with THIS
        deployment's wire instead of the static constants."""
        return self._miss_row_s

    def latest_versions(self):
        """{shard: {"inc", "round"}} — the newest version coordinates
        observed per shard (the 'cache version' a scoring request is
        pinned against)."""
        with self.cache._lock:
            return {s: dict(v) for (t, s), v in
                    self.cache._latest.items() if t == self.table}

    def close(self):
        with self._lock:
            clients, self._clients = self._clients, \
                [None] * len(self._eps)
        for cli in clients:
            if cli is not None:
                cli.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
