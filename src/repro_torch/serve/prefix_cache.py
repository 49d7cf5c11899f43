"""Refcounted prefix block cache — the ServeLoop's host-side allocator.

A host-side numpy copy of ``repro/serve/prefix_cache.py`` (the port keeps
its own copy; it imports numpy and hashlib only).

Millions of requests share system prompts and few-shot preambles, yet a
plain free-list allocator re-prefills every one of them through the
simulated crossbar pipeline — the most expensive matmul path in the
stack.  The paged KV arena (DESIGN.md §7) makes vLLM-style prefix
sharing natural: a physical block's *content* is fully determined by the
prompt tokens up to and including it, so blocks can be addressed by a
CHAINED hash (each block's key digests its own tokens plus the previous
block's key) and shared between requests whose prompts agree on that
prefix.

:class:`PrefixCache` partitions physical blocks ``1..n_blocks-1``
(block 0 is the reserved trash block, never handed out) into three
disjoint sets at all times:

* **live** — held by admitted requests, ``ref[b] >= 1``.  A block with
  ``ref > 1`` is SHARED and immutable: the write path must copy-on-write
  before touching it (the loop runs a block copy at admission).
* **parked** — refcount reached zero at retirement but the block holds
  registered (hashed) content; it waits in an LRU pool and can be
  resurrected by a later cache hit for free.
* **free** — never registered, or evicted.  Eviction drains the LRU pool
  only under allocation pressure (a fresh allocation finding the free
  list empty), oldest-parked first, and unregisters the hash.

Lookup, refcounts, hashing, and eviction are all host-side bookkeeping —
no device bytes move here.  The only device work prefix caching adds is
the COW block copy; everything else *removes* device work (the skipped
prefill chunks).

Correctness contract (tests/test_prefix_cache.py): serving is BITWISE
invariant to sharing on the fast path — a cache-hit request's logits
equal its own cold-start run exactly, because hit blocks hold exactly
the KV the request's own prefill would have written (chunk-size
invariance, DESIGN.md §7) and shared blocks are never mutated while
``ref > 1``.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

__all__ = ["AdmitPlan", "PrefixCache", "chain_hashes"]

TRASH_BLOCK = 0


def chain_hashes(tokens, block_size: int) -> list[bytes]:
    """Chained content keys for the prompt's FULL blocks.

    ``out[i]`` digests tokens ``[0 .. (i+1)*block_size)`` via the chain
    ``h_i = blake2b(h_{i-1} || tokens_of_block_i)``, so a key identifies
    a block's content *and* everything before it — two prompts that
    agree on key ``i`` agree on the whole prefix, which is exactly the
    condition under which the attention KV rows of block ``i`` are
    interchangeable.  The prompt's trailing partial block (if any) is
    never hashed: only complete, immutable blocks are shareable.
    """
    arr = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: list[bytes] = []
    h = b""
    for i in range(len(arr) // block_size):
        h = hashlib.blake2b(
            h + arr[i * block_size : (i + 1) * block_size].tobytes(),
            digest_size=16,
        ).digest()
        out.append(h)
    return out


@dataclass
class AdmitPlan:
    """Per-request allocation decision.

    ``blocks`` is the slot's physical block-table row (length = the
    request's full eager need); the first ``len(hashes)`` entries that
    came from cache hits already hold valid KV.  ``resume_pos`` is where
    prefill starts: ``cached_len`` for cold/partial-hit prompts, but
    ``prompt_len - 1`` on a FULL hit — at least one prompt token is
    always recomputed so the first-token logits come from a real forward
    pass, never from a stale cache.  ``cow`` is a ``(src, dst)`` physical
    block copy the loop must run before that recompute writes KV: the
    write at ``resume_pos`` lands in the last hit block, which is shared
    when another request holds a reference.  ``reg_upto`` is the
    registration cursor (full-block index) advanced by
    :meth:`PrefixCache.register_progress` as prefill completes blocks.
    """

    blocks: list[int]
    cached_len: int
    resume_pos: int
    cow: tuple[int, int] | None
    hashes: list[bytes] = field(repr=False, default_factory=list)
    reg_upto: int = 0
    prompt_len: int = 0


class PrefixCache:
    """Host-side refcounted block allocator with prefix sharing.

    With ``enabled=False`` it degrades to the plain LIFO free-list the
    loop used before prefix caching (no hashing, no parking) while
    keeping the same accounting surface — the loop never branches on the
    mode.
    """

    def __init__(self, n_blocks: int, block_size: int, *, enabled=True):
        if n_blocks < 2:
            raise ValueError("n_blocks must be >= 2 (block 0 is trash)")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.enabled = bool(enabled)
        self.reset()

    def reset(self) -> None:
        """Fresh allocator state (per ``ServeLoop.run``): all blocks
        free, all counters zero."""
        self._free: list[int] = list(range(1, self.n_blocks))
        self._ref: dict[int, int] = {}
        # parked refcount-0 registered blocks, insertion order = LRU
        self._lru: "OrderedDict[int, bytes]" = OrderedDict()
        self._block_of: dict[bytes, int] = {}  # hash -> physical block
        self._hash_of: dict[int, bytes] = {}  # physical block -> hash
        self._ever_freed: set[int] = set()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.cow_copies = 0
        self.blocks_reused = 0

    # -- residency probe ----------------------------------------------------

    def resident_prefix_len(self, tokens) -> int:
        """Prompt tokens covered by the longest chain of REGISTERED
        prefix blocks — live-shared or parked alike — without touching
        any state (no refcount bump, no LRU reordering, no counters).

        This is the scheduler's cache-awareness probe (DESIGN.md §7):
        among ready same-class requests it prefers the one whose prefix
        is already resident, turning parked blocks into hits before
        allocation pressure evicts them.  Pure lookup, so probing a
        candidate the scheduler then does NOT admit has no effect; a
        nonzero answer can still go stale (eviction between probe and
        admission), which costs only the preference, never correctness
        — admission re-runs the real lookup.  Returns 0 when the cache
        is disabled (every candidate ties; FIFO order decides)."""
        if not self.enabled:
            return 0
        n = 0
        for h in chain_hashes(tokens, self.block_size):
            if h not in self._block_of:
                break
            n += 1
        return n * self.block_size

    # -- allocation ---------------------------------------------------------

    def admit(self, tokens, need: int) -> AdmitPlan | None:
        """Plan an admission: map hit prefix blocks, allocate the cold
        tail, decide COW.  Returns ``None`` (state untouched) when the
        pool cannot cover the request — lookup and feasibility run
        before any mutation, so a refusal needs no rollback.
        """
        plen = len(tokens)
        hashes = chain_hashes(tokens, self.block_size) if self.enabled else []

        # phase 1: pure lookup — longest chain of already-registered
        # prefix blocks (a chain break ends the hit: later keys digest
        # the broken one, so they cannot match either)
        hit_blocks: list[int] = []
        for h in hashes:
            b = self._block_of.get(h)
            if b is None:
                break
            hit_blocks.append(b)
        hits = len(hit_blocks)
        cached_len = hits * self.block_size
        full_hit = hits > 0 and cached_len == plen
        # full hit: recompute the last prompt token for its logits; its
        # KV write targets the last hit block → COW iff shared (another
        # live holder).  A parked (ref 0) block is rewritten in place:
        # the recomputed KV is bitwise what the block already holds.
        cow_src = None
        if full_hit and self._ref.get(hit_blocks[-1], 0) >= 1:
            cow_src = hit_blocks[-1]
        n_fresh = need - hits + (1 if cow_src is not None else 0)

        hit_set = set(hit_blocks)
        evictable = sum(1 for b in self._lru if b not in hit_set)
        if len(self._free) + evictable < n_fresh:
            return None

        # phase 2: commit
        self.hits += hits
        self.misses += len(hashes) - hits
        for b in hit_blocks:
            if b in self._lru:  # resurrect parked content
                del self._lru[b]
                self._ref[b] = 1
            else:
                self._ref[b] += 1
        fresh = [self._take_block(hit_set) for _ in range(n_fresh)]
        if cow_src is not None:
            # replace the shared last hit block in OUR table only; the
            # loop copies src→dst on device before prefill writes
            dst = fresh.pop(0)
            self._ref[cow_src] -= 1  # still >= 1: the sharer keeps it
            blocks = hit_blocks[:-1] + [dst] + fresh
            self.cow_copies += 1
            cow = (cow_src, dst)
        else:
            blocks = hit_blocks + fresh
            cow = None
        return AdmitPlan(
            blocks=blocks,
            cached_len=cached_len,
            resume_pos=plen - 1 if full_hit else cached_len,
            cow=cow,
            hashes=hashes,
            reg_upto=hits,
            prompt_len=plen,
        )

    def _take_block(self, protect: set) -> int:
        """One fresh block: free list first, else evict the
        least-recently-parked block (never one the current admission is
        hitting).  Feasibility was checked, so this cannot fail."""
        if self._free:
            b = self._free.pop()
        else:
            b = next(c for c in self._lru if c not in protect)
            del self._lru[b]
            h = self._hash_of.pop(b)
            del self._block_of[h]
            self.evictions += 1
        if b in self._ever_freed:
            self.blocks_reused += 1
        self._ref[b] = 1
        return b

    # -- lifecycle ----------------------------------------------------------

    def register_progress(self, plan: AdmitPlan, prefill_pos: int) -> None:
        """Publish hash→block mappings for every prompt block whose
        prefill just COMPLETED (all ``block_size`` KV rows written).
        Called after each chunk: registering at admission would let a
        sharer attend over a block that is still being filled.  On a
        hash collision (same content prefilled concurrently in two
        lanes) the FIRST registration wins; the loser's block stays
        private and frees normally at retirement."""
        if not self.enabled:
            return
        done = min(prefill_pos // self.block_size, len(plan.hashes))
        while plan.reg_upto < done:
            i = plan.reg_upto
            h, blk = plan.hashes[i], plan.blocks[i]
            if h not in self._block_of:
                self._block_of[h] = blk
                self._hash_of[blk] = h
            plan.reg_upto = i + 1

    def release(self, plan: AdmitPlan) -> None:
        """Retire a request: drop one reference per table block.  Blocks
        reaching zero park in the LRU pool when they carry registered
        content, else return to the free list.  Deepest-chain blocks are
        released last → they park most recent → evict last; a shallow
        (more widely shareable) prefix outlives its deep extensions."""
        for blk in reversed(plan.blocks):
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                del self._ref[blk]
                self._ever_freed.add(blk)
                if self._hash_of.get(blk) is not None:
                    self._lru[blk] = self._hash_of[blk]
                else:
                    self._free.append(blk)

    # -- introspection ------------------------------------------------------

    @property
    def live_blocks(self) -> set:
        return set(self._ref)

    @property
    def parked_blocks(self) -> set:
        return set(self._lru)

    @property
    def free_blocks(self) -> set:
        return set(self._free)

    def check_partition(self) -> None:
        """Allocator invariant (tests/test_batching_props.py): live,
        parked, and free sets are disjoint, exactly cover blocks
        ``1..n_blocks-1``, never contain the trash block, and the
        hash registry is a consistent bijection over registered
        blocks."""
        live, parked, free = (
            self.live_blocks, self.parked_blocks, self.free_blocks,
        )
        assert len(self._free) == len(free), "duplicate block in free list"
        assert not live & parked, f"live∩parked: {live & parked}"
        assert not live & free, f"live∩free: {live & free}"
        assert not parked & free, f"parked∩free: {parked & free}"
        union = live | parked | free
        expect = set(range(1, self.n_blocks))
        assert union == expect, (
            f"leak/phantom: missing {expect - union}, extra {union - expect}"
        )
        assert TRASH_BLOCK not in union, "trash block handed out"
        assert all(c >= 1 for c in self._ref.values()), "refcount < 1"
        assert set(self._hash_of) == set(self._block_of.values())
        for h, b in self._block_of.items():
            assert self._hash_of[b] == h, "hash registry not a bijection"
        assert parked <= set(self._hash_of), "parked block without content"
