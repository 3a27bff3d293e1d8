"""Paged KV management: a shared block pool + a radix prefix cache.

A copy of ``paddle_tpu/serving/kvpool.py`` (pure Python; the port keeps
its own so it imports nothing of the JAX package).

A dense-cache engine reserves one dense ``[slots, n_head, max_len, dk]``
cache stripe per decode slot — every admitted request pays ``max_len``
worth of KV memory no matter how short it is, and two requests sharing
the same system-prompt prefix each prefill and store their own copy.
At production scale KV memory, not compute, caps concurrency; the
fixes are the vLLM PagedAttention design (block-granular KV over a
shared pool, per-request block tables, copy-on-write for shared
blocks) and SGLang's RadixAttention (a prefix trie mapping prompt
token prefixes to refcounted block chains, so a shared prefix is
prefilled ONCE and referenced).

This module is the HOST-SIDE accounting half of that design — pure
Python, device-free, unit-testable:

  * ``BlockPool`` — free-list allocator + per-block refcounts over the
    ``num_blocks`` physical blocks of the device pool arrays
    (``models/transformer_infer._init_paged_state`` owns the actual
    ``[num_blocks, n_layer, n_head, block_size, dk]`` K and V arrays;
    the engine's block tables index into them).
  * ``RadixCache`` — a trie keyed by FULL-block token tuples; each
    node owns one pool ref on its block. ``match`` walks the longest
    cached prefix of a prompt (taking a reader ref per matched block),
    ``insert`` publishes a retiring request's full prompt blocks, and
    ``evict`` LRU-frees leaf chains nobody reads (``refcount == 1`` =
    only the cache) when the pool runs dry. Capacity is bounded by
    the pool size by construction — the cache never allocates.
  * ``bytes_per_block`` — the device-memory bytes one pool block holds.

Refcount protocol (the engine follows it, tests pin it):

  * every block a request references — freshly allocated OR matched
    from the cache — carries exactly one ref held by the request,
    dropped via ``BlockPool.free`` at retirement/preemption;
  * a trie node holds one extra ref on its block for the cache's own
    lifetime (dropped at eviction);
  * a block returns to the free list when its count reaches zero, so
    "in the cache but unreferenced" chains are exactly the evictable
    set and a chain an active request still reads can never be
    reclaimed under it.
"""

import collections

__all__ = ["BlockPool", "RadixCache", "bytes_per_block"]


def bytes_per_block(n_layer, n_head, block_size, head_dim,
                    dtype_bytes=4, kv_quant=None, scale_bytes=4):
    """Device-memory bytes ONE pool block holds: K and V for
    ``block_size`` cache positions across every layer and head.

    ``kv_quant`` prices a quantized pool (``"int8"``/``"fp8"``): one
    code byte per element plus one ``scale_bytes`` scale per
    (position, head) vector — the layout
    ``models/transformer_infer._init_paged_state`` allocates. A
    head_dim-64 fp32 pool drops to ~26% of its dense bytes."""
    kvq = str(kv_quant or "").strip().lower()
    if kvq in ("", "none", "off"):
        per_vec = int(head_dim) * int(dtype_bytes)
    else:
        # ops/paged_attention.kv_quant_spec validates the kind; both
        # supported kinds store 1-byte codes + a per-vector scale.
        per_vec = int(head_dim) * 1 + int(scale_bytes)
    return (2 * int(n_layer) * int(n_head) * int(block_size)
            * per_vec)


class BlockPool:
    """Free-list + refcount accounting over ``num_blocks`` physical KV
    blocks. Deterministic: blocks allocate lowest-id-first from the
    initial order and recycle FIFO, so a seeded run reproduces its
    block assignment exactly (the device content is content-addressed
    through block tables, so ids never affect tokens — determinism
    here is for reproducible tests and debuggable logs)."""

    def __init__(self, num_blocks, block_size):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1, got %r"
                             % (num_blocks,))
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = collections.deque(range(self.num_blocks))
        self._ref = {}                  # block id -> live refcount

    @property
    def used(self):
        """Blocks currently referenced (by requests and/or the cache)."""
        return self.num_blocks - len(self._free)

    @property
    def free_blocks(self):
        return len(self._free)

    def refcount(self, block):
        return self._ref.get(block, 0)

    def alloc(self, n=1):
        """Take ``n`` blocks (each with refcount 1), all-or-nothing.
        Returns the id list, or None when the pool cannot satisfy the
        request — the caller's pressure ladder (prefix-cache eviction,
        then preemption) decides what to free."""
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def share(self, block):
        """Take one more ref on a live block (a prefix-cache reader, a
        trie node publishing it, a COW source kept by the cache)."""
        if self._ref.get(block, 0) <= 0:
            raise ValueError("share of unreferenced block %r" % (block,))
        self._ref[block] += 1
        return block

    def free(self, block):
        """Drop one ref; the block returns to the free list at zero."""
        cur = self._ref.get(block, 0)
        if cur <= 0:
            raise ValueError("free of unreferenced block %r" % (block,))
        if cur == 1:
            del self._ref[block]
            self._free.append(block)
        else:
            self._ref[block] = cur - 1


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_use")

    def __init__(self, key, block, parent):
        self.key = key              # tuple of block_size token ids
        self.block = block          # physical pool block id
        self.children = {}
        self.parent = parent
        self.last_use = 0


class RadixCache:
    """Prefix trie over FULL prompt blocks -> refcounted block chains.

    Keys are ``block_size``-token tuples: only block-aligned prefixes
    are cached/matched, which is what makes reuse write-free — a
    matching request's own writes (its uncached prompt tail and every
    generated token) land in blocks PAST the shared chain, except the
    one fully-block-aligned-prompt case the engine resolves with a
    copy-on-write (see ``Engine._cow``).

    Counters (``hits``/``misses`` per lookup, ``hit_tokens``,
    ``evictions``) are the cache's OWN accounting — the unit-test and
    debugging surface. The engine keeps separate figures
    (``Engine.stats["prefix_*"]``):
    its ``prefix_hit_tokens`` counts prefill POSITIONS SKIPPED, which
    is one less than ``hit_tokens`` for a fully block-aligned prompt
    (the last matched position is re-written by activation via COW,
    not skipped)."""

    def __init__(self, block_size, pool):
        self.block_size = int(block_size)
        self._pool = pool
        self._root = _Node(None, None, None)
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    def _tick(self):
        self._clock += 1
        return self._clock

    def blocks_cached(self):
        n, stack = 0, [self._root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def match(self, tokens):
        """Longest cached chain of full blocks prefixing ``tokens``.
        Returns ``(blocks, n_tokens)``; every returned block carries a
        fresh reader ref the caller must ``pool.free`` when done (the
        engine frees at retirement/preemption). Counts one hit or miss
        per lookup."""
        bs = self.block_size
        node, blocks = self._root, []
        now = self._tick()
        for i in range(len(tokens) // bs):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = now
            self._pool.share(child.block)
            blocks.append(child.block)
            node = child
        if blocks:
            self.hits += 1
            self.hit_tokens += len(blocks) * bs
        else:
            self.misses += 1
        return blocks, len(blocks) * bs

    def token_chains(self, limit=64):
        """The published prompt chains as plain token tuples (root-to-
        leaf trie paths), most recently used first, at most ``limit``.

        This is the TEXT surface of the cache: the
        speculative drafter's prompt-lookup tier reads the token
        sequences other requests published and proposes continuations
        from them. Reading text takes NO pool refs — drafting can
        never pin a block the pressure ladder wants back, and a wrong
        chain costs nothing but a rejected draft."""
        out, stack = [], [(self._root, ())]
        while stack:
            node, toks = stack.pop()
            for child in node.children.values():
                ct = toks + child.key
                if child.children:
                    stack.append((child, ct))
                else:
                    out.append((child.last_use, ct))
        out.sort(key=lambda p: -p[0])
        return [toks for _, toks in out[:int(limit)]]

    def insert(self, tokens, blocks):
        """Publish a request's full-block prompt chain. ``tokens`` must
        be ``len(blocks) * block_size`` ids; ``blocks[i]`` holds the
        K/V of positions ``[i*bs, (i+1)*bs)``. New nodes take their own
        pool ref (the request keeps its ref until release — publishing
        never transfers ownership). A prefix another request already
        published keeps the FIRST copy; the caller's duplicate block
        simply stays private to it. Returns the number of new nodes."""
        bs = self.block_size
        if len(tokens) != len(blocks) * bs:
            raise ValueError(
                "insert needs len(tokens) == len(blocks) * block_size "
                "(%d != %d * %d)" % (len(tokens), len(blocks), bs))
        node, created = self._root, 0
        now = self._tick()
        for i, block in enumerate(blocks):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, self._pool.share(block), node)
                node.children[key] = child
                created += 1
            child.last_use = now
            node = child
        return created

    def _evictable_leaves(self):
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                elif self._pool.refcount(child.block) == 1:
                    out.append(child)      # only the cache holds it
        return out

    def evict(self, need=1):
        """LRU-free unreferenced leaf chains until ``need`` blocks
        returned to the pool (or no candidate remains). One trie walk
        collects the current evictable leaves and drains them in LRU
        order; the walk repeats only when interior nodes became new
        leaves and more blocks are still needed — so freeing N blocks
        costs O(chains-drained) walks, not one walk per block (the
        scheduler loop calls this on its allocation hot path)."""
        freed = 0
        while freed < need:
            leaves = sorted(self._evictable_leaves(),
                            key=lambda n: n.last_use)
            if not leaves:
                break
            for victim in leaves:
                if freed >= need:
                    break
                del victim.parent.children[victim.key]
                self._pool.free(victim.block)
                self.evictions += 1
                freed += 1
        return freed
