"""Block-granular KV-cache management (ref:
paddle_tpu/inference/kv_blocks.py; the port's own copy, host only).

The slot-paged decode cache reserves one contiguous `[max_cache_len, d]`
row per slot, so a beam reorder copies whole slot rows and two requests
with the same prompt prefix store and compute it once each. In the block
layout the cache is a pool of fixed-size blocks `[num_blocks, block_size,
d]`; each slot addresses it through a block table (logical position p
lives at `cache[table[p // bs], p % bs]`), and blocks are refcounted so
histories are shared instead of copied:

  * beam fork      = copy the parent's table and incref (no device work);
                     the first divergent write copies only the shared
                     partial tail block (copy on write)
  * prefix sharing = the full blocks of a prefilled prompt register in a
                     prefix cache keyed by a chained token-block hash
                     (a hit verifies exact token equality, so a hash
                     collision never aliases two prefixes); a request with
                     the same prefix maps those blocks into its table and
                     skips their storage and prefill compute
  * free list      = refcount-to-zero blocks return to the pool; under
                     pressure the least recently used prefix entries evict
                     first

`BlockManager` is host bookkeeping only (stdlib, no torch): the scheduler
(inference/decoding.py) owns the numpy block tables it feeds the block
programs and asks this class which physical block backs each logical
write. Physical block 0 is reserved as the trash block: idle and padded
rows scatter their garbage there, and no real table maps it, so stale
values never reach an active slot's attention window.
"""
import hashlib
import threading
from collections import OrderedDict, deque

__all__ = ['BlockManager', 'BlockPoolExhausted', 'TRASH_BLOCK']

# physical block 0: write target for idle/padded rows, never allocated,
# never read (attention masks it out and no table maps it)
TRASH_BLOCK = 0


class BlockPoolExhausted(RuntimeError):
    """No free block and nothing evictable: the pool is fully pinned by
    active requests. The scheduler sheds the youngest active request
    loudly rather than deadlocking (capacity pressure, not a bug: add
    blocks or admit less)."""


def _default_hash(token_bytes):
    return hashlib.sha1(token_bytes).hexdigest()


class _PrefixEntry(object):
    __slots__ = ('key', 'own', 'blocks', 'parent')

    def __init__(self, key, own, blocks, parent):
        self.key = key
        self.own = own                # THIS boundary's block tokens only
        self.blocks = list(blocks)    # one cache ref held per block
        self.parent = parent          # boundary m-1 entry: exact-token
        #   verification walks the chain one block per link, so the
        #   collision guard costs O(L) tokens per prompt, not O(L^2)


class BlockManager(object):
    """Refcounted allocator over `num_blocks` physical cache blocks of
    `block_size` token positions each (block 0 reserved as trash).

    alloc(n)                 -> n fresh blocks (evicts LRU prefix
                                entries under pressure; raises
                                BlockPoolExhausted when fully pinned)
    incref/decref(blocks)       share / release block references;
                                refcount-to-zero returns to the free list
    writable(block)          -> True when a table may write the block in
                                place (refcount 1, not trash)
    match_prefix(tokens)     -> (blocks, covered) longest verified
                                full-block prefix hit (incref'd)
    register_prefix(tokens, blocks)  publish a prompt's full blocks
    stats() / in_use()          pool and prefix-share accounting

    Thread-safe: the scheduler thread and stats snapshots race only on
    counters.
    """

    def __init__(self, num_blocks, block_size, hash_fn=None,
                 max_prefix_entries=1024):
        if num_blocks < 2:
            raise ValueError('need >= 2 blocks (block 0 is reserved), '
                             'got %d' % num_blocks)
        if block_size < 1:
            raise ValueError('block_size must be >= 1')
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._hash = hash_fn or _default_hash
        self._max_prefix = int(max_prefix_entries)
        self._lock = threading.Lock()
        self._ref = [0] * self.num_blocks
        self._free = deque(range(1, self.num_blocks))
        # prefix cache: hash key -> list of entries (collision buckets);
        # _lru orders entry ids oldest-first for eviction
        self._prefix = {}
        self._lru = OrderedDict()
        # bumped whenever a new prefix entry publishes: a waiting
        # request re-matches a cached miss only when this moved, so a
        # slow-to-admit prompt is not re-hashed every scheduler tick
        self.prefix_epoch = 0
        self._peak = 0
        self.allocs = 0
        self.frees = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_reused = 0
        self.evictions = 0

    # -- allocation --------------------------------------------------------
    def capacity(self):
        """Allocatable blocks (excludes the reserved trash block)."""
        return self.num_blocks - 1

    def in_use(self):
        with self._lock:
            return self.capacity() - len(self._free)

    def peak_in_use(self):
        with self._lock:
            return self._peak

    def free_blocks(self):
        with self._lock:
            return len(self._free)

    def blocks_for(self, n_tokens):
        """Blocks a span of n_tokens occupies."""
        return -(-int(n_tokens) // self.block_size)

    def alloc(self, n=1):
        """Allocate n blocks (refcount 1 each). Under pressure the LRU
        prefix entries evict until the pool covers the request; when
        every block is pinned by a live reference, raises
        BlockPoolExhausted WITHOUT allocating (all-or-nothing, so a
        failed multi-block alloc never leaks)."""
        n = int(n)
        with self._lock:
            if len(self._free) < n and \
                    len(self._free) + self._evictable_locked() >= n:
                while len(self._free) < n and self._lru:
                    self._evict_one_locked()
            if len(self._free) < n:
                raise BlockPoolExhausted(
                    'need %d block(s), %d free, eviction cannot cover '
                    'the rest (%d/%d pinned by live requests)'
                    % (n, len(self._free), self.in_use_locked(),
                       self.capacity()))
            out = [self._free.popleft() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            self.allocs += n
            self._peak = max(self._peak,
                             self.capacity() - len(self._free))
            return out

    def in_use_locked(self):
        return self.capacity() - len(self._free)

    def reserve(self, n):
        """Evict LRU prefix entries until >= n blocks are FREE, without
        allocating any. The scheduler preflights a decode step with the
        step's exact fresh-block demand (extensions + CoW targets), so
        row building never has to unwind a half-planned step: after a
        True reserve, that many alloc(1) calls cannot fail. False when
        the pool cannot cover n even with every prefix entry evicted —
        capacity pressure the scheduler resolves by shedding."""
        n = int(n)
        with self._lock:
            if len(self._free) < n and \
                    len(self._free) + self._evictable_locked() < n:
                return False
            while len(self._free) < n and self._lru:
                self._evict_one_locked()
            return len(self._free) >= n

    def _evictable_locked(self):
        """Blocks a full prefix-cache wipe could actually FREE: those
        whose every reference is a prefix entry's. The rest are pinned
        by live tables — evicting their entries frees nothing, so
        alloc/reserve check this BEFORE evicting and a doomed
        over-capacity request no longer wipes the cache for zero
        gain."""
        prefix_refs = {}
        for e in self._lru.values():
            for b in e.blocks:
                prefix_refs[b] = prefix_refs.get(b, 0) + 1
        return sum(1 for b, k in prefix_refs.items()
                   if self._ref[b] == k)

    def incref(self, blocks):
        with self._lock:
            for b in blocks:
                if b == TRASH_BLOCK:
                    continue
                if self._ref[b] <= 0:
                    raise RuntimeError(
                        'incref of unallocated block %d' % b)
                self._ref[b] += 1

    def decref(self, blocks):
        """Release references; refcount-to-zero blocks return to the
        free list immediately."""
        with self._lock:
            for b in blocks:
                if b == TRASH_BLOCK:
                    continue
                r = self._ref[b]
                if r <= 0:
                    raise RuntimeError(
                        'decref of free block %d (double free)' % b)
                self._ref[b] = r - 1
                if r == 1:
                    self._free.append(b)
                    self.frees += 1

    def rollback(self, table, n_tokens):
        """Truncate `table` (in place) to the blocks an n_tokens span
        occupies, releasing the tail. The speculative verify tick
        extends a table to cover its whole draft span BEFORE
        dispatch; after host-side acceptance, blocks covering ONLY
        rejected positions are dead weight — rolling back returns them
        to the pool immediately instead of stranding them until the
        request finishes. Returns the number of blocks released."""
        keep = self.blocks_for(n_tokens)
        if len(table) <= keep:
            return 0
        tail = list(table[keep:])
        del table[keep:]
        self.decref(tail)
        return len(tail)

    def refcount(self, block):
        with self._lock:
            return self._ref[block]

    def writable(self, block):
        """A table may write `block` in place only while it is the SOLE
        owner; shared blocks copy-on-write first."""
        if block == TRASH_BLOCK:
            return False
        with self._lock:
            return self._ref[block] == 1

    # -- prefix sharing ----------------------------------------------------
    def _block_keys(self, tokens, n_full):
        """Chained per-block keys: keys[m-1] identifies tokens[:m*bs]
        (each key hashes the PREVIOUS key + one block's bytes, rolling
        hash), so computing every boundary key of an L-token
        prompt hashes each token once — O(L), not O(L^2) as re-hashing
        the full prefix per boundary would be."""
        bs = self.block_size
        keys = []
        prev = b''
        for m in range(1, n_full + 1):
            blk = b','.join(b'%d' % t for t in tokens[(m - 1) * bs:
                                                      m * bs])
            key = self._hash(prev + b'|' + blk)
            keys.append(key)
            prev = key.encode() if isinstance(key, str) else bytes(key)
        return keys

    def match_prefix(self, tokens):
        """Longest verified full-block prefix of `tokens` present in the
        cache -> (blocks, covered_tokens), blocks already incref'd for
        the caller's table; ([], 0) on miss. At least the FINAL token of
        the prompt is always left uncovered — the admitting request must
        compute something to produce its first-token logits. Hash hits
        verify exact token equality (collision safety): a colliding key
        whose stored tokens differ is a miss, never an alias."""
        bs = self.block_size
        tokens = [int(t) for t in tokens]
        # cap below len(tokens): never cover the whole prompt
        max_full = (len(tokens) - 1) // bs
        keys = self._block_keys(tokens, max_full)
        for m in range(max_full, 0, -1):
            with self._lock:
                bucket = self._prefix.get(keys[m - 1])
                if not bucket:
                    continue          # no candidate: skip token compare
                for e in bucket:
                    if not self._chain_matches_locked(e, tokens, m):
                        continue      # hash collision: different tokens
                    for b in e.blocks:
                        self._ref[b] += 1
                    self._refresh_chain_locked(e)
                    self.prefix_hits += 1
                    self.prefix_tokens_reused += m * bs
                    return list(e.blocks), m * bs
        with self._lock:
            self.prefix_misses += 1
        return [], 0

    def _chain_matches_locked(self, e, tokens, m):
        """Exact-token verification of a boundary-m candidate: walk the
        parent chain comparing ONE block's tokens per link — the
        collision guard stays exact while storing and comparing O(L)
        tokens per prompt instead of a full prefix copy per boundary.
        The chain must be exactly m links long."""
        bs = self.block_size
        j = m
        while e is not None and j > 0:
            if e.own != tuple(tokens[(j - 1) * bs:j * bs]):
                return False
            e = e.parent
            j -= 1
        return e is None and j == 0

    def _refresh_chain_locked(self, e):
        """LRU-refresh a hit entry AND its parent chain, deepest first,
        so parents end NEWEST: under pressure the deepest (tail) entries
        evict before their parents. Evicting a parent while a child
        survives frees zero blocks (the child still refs every parent
        block) yet destroys the hot prefix's shorter-boundary matches;
        child-first eviction actually frees the tail blocks and degrades
        to the shorter shared prefix gracefully."""
        while e is not None:
            if id(e) in self._lru:   # parents may already be evicted
                self._lru.move_to_end(id(e))
            e = e.parent

    def register_prefix(self, tokens, blocks):
        """Publish a prompt's FULL blocks for reuse: `blocks` backs
        tokens[:len(blocks) * block_size] exactly. One entry registers
        per full-block boundary (so shorter prefixes of the same prompt
        also hit); each entry holds one cache reference per block,
        released on eviction. Idempotent for already-registered
        prefixes."""
        bs = self.block_size
        tokens = [int(t) for t in tokens]
        n_full = min(len(blocks), len(tokens) // bs)
        keys = self._block_keys(tokens, n_full)
        with self._lock:
            parent = None
            for m in range(1, n_full + 1):
                own = tuple(tokens[(m - 1) * bs:m * bs])
                bucket = self._prefix.setdefault(keys[m - 1], [])
                found = None
                for e in bucket:
                    # fast path: the boundary m-1 candidate was already
                    # verified this call, so `is parent` + own-block
                    # equality proves the whole chain in O(block_size)
                    if (e.own == own and e.parent is parent) or \
                            self._chain_matches_locked(e, tokens, m):
                        found = e
                        break
                if found is not None:
                    parent = found
                    continue
                e = _PrefixEntry(keys[m - 1], own, blocks[:m], parent)
                for b in e.blocks:
                    self._ref[b] += 1
                bucket.append(e)
                self._lru[id(e)] = e
                self.prefix_epoch += 1
                if len(self._lru) > self._max_prefix:
                    self._evict_one_locked()
                parent = e
            if parent is not None:
                self._refresh_chain_locked(parent)

    def _evict_one_locked(self):
        _, e = self._lru.popitem(last=False)
        bucket = self._prefix.get(e.key, [])
        if e in bucket:
            bucket.remove(e)
        if not bucket:
            self._prefix.pop(e.key, None)
        for b in e.blocks:
            r = self._ref[b]
            self._ref[b] = r - 1
            if r == 1:
                self._free.append(b)
                self.frees += 1
        self.evictions += 1

    def evict_all_prefixes(self):
        """Drop every cached prefix (an explicit cache clear)."""
        with self._lock:
            while self._lru:
                self._evict_one_locked()

    def prefix_entries(self):
        with self._lock:
            return len(self._lru)

    def reset_counters(self):
        """Zero the cumulative counters and re-base the peak gauge
        (A/B measurement arms). Allocation state and cached prefixes
        are untouched — pair with evict_all_prefixes() when the next
        arm must not inherit the previous arm's shared prefixes."""
        with self._lock:
            self._peak = self.in_use_locked()
            self.allocs = 0
            self.frees = 0
            self.prefix_hits = 0
            self.prefix_misses = 0
            self.prefix_tokens_reused = 0
            self.evictions = 0

    # -- accounting --------------------------------------------------------
    def stats(self):
        """Pool gauges and prefix-share counters (merged into
        DecodeStats.snapshot() by a block-layout DecodingPredictor)."""
        with self._lock:
            looked = self.prefix_hits + self.prefix_misses
            return {
                'num_blocks': self.capacity(),
                'block_size': self.block_size,
                'blocks_in_use': self.in_use_locked(),
                'blocks_peak': self._peak,
                'blocks_free': len(self._free),
                'allocs': self.allocs,
                'frees': self.frees,
                'prefix_entries': len(self._lru),
                'prefix_hits': self.prefix_hits,
                'prefix_misses': self.prefix_misses,
                'prefix_hit_rate': (self.prefix_hits / looked
                                    if looked else 0.0),
                'prefix_tokens_reused': self.prefix_tokens_reused,
                'evictions': self.evictions,
            }
