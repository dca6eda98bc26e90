"""Host-side allocator for the device KV block pools, with prefix caching.

Port of ``accelerate_tpu/serving/block_pool.py``: ``BlockPool`` (:43-388)
without its swap ledger (``swap_out``/``swap_in``/``swap_drop`` :222-279,
which belongs to preemption, and ``cached_chain_digest``, which belongs
to the HTTP plane; ROADMAP.md, queue A9), ``prefix_keys`` (:390) and
``PrefixCache`` (:427-509). Block 0 is the reserved garbage block: the
device routes every invalid write (bucket padding, empty decode slots)
there, so the allocator never hands it out. Ids come out lowest first,
and a freed block is the next one handed out, as in the reference.

Prefix caching makes the pool a refcounted, content-addressed KV store:

* every block carries a refcount; ``allocate`` takes a block at 1,
  ``free`` releases one reference, and a block leaves its holders only
  at 0, so two requests sharing a system-prompt block cannot pull it out
  from under each other;
* a full prompt block can be published under a content key (a rolling
  hash over the model fingerprint, the adapter id and the tokens of this
  block and every block before it: :func:`prefix_keys`), so a later
  request with the same prefix finds the whole chain by one dict walk;
* a published block whose refcount drops to 0 retires into an LRU of
  cached blocks, still indexed; allocation evicts from its cold end
  first, and only refcount-0 blocks are ever in it.

Shared blocks are never written: the engine copies a block before it
writes into it (copy-on-write) and the pool only swaps the bookkeeping, so
a warm request computes what a cold one does.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Iterable, Optional, Sequence

import numpy as np


class BlockPool:
    """Refcounted free list over ``num_blocks`` KV blocks of ``block_size``
    tokens, with a content index for prefix reuse. Allocation is all or
    nothing; a double free or a foreign block raises instead of corrupting
    a neighbour's cache.

    A block is in one of three states, and ``num_free + num_allocated +
    num_cached == num_blocks - 1`` always (the garbage block is in none):
    free (on the free list), allocated (refcount >= 1, perhaps published,
    perhaps shared) or cached (refcount 0 but published: in the LRU,
    reusable through :meth:`lookup`/:meth:`acquire`, evicted under
    allocation pressure)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved garbage "
                f"block), got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() -> lowest id
        self._ref: dict[int, int] = {}        # block -> refcount (>= 1)
        self._hash_of: dict[int, bytes] = {}  # published block -> content key
        self._index: dict[bytes, int] = {}    # content key -> block
        # refcount-0 published blocks, oldest first (the eviction end)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.evictions_total = 0

    # ------------------------------------------------------------------ #
    # occupancy
    # ------------------------------------------------------------------ #
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._ref)

    @property
    def num_cached(self) -> int:
        """Refcount-0 published blocks in the LRU (reusable and evictable)."""
        return len(self._lru)

    @property
    def num_shared(self) -> int:
        """Allocated blocks held by two requests or more."""
        return sum(1 for n in self._ref.values() if n >= 2)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def blocks_for_tokens(self, tokens: int) -> int:
        """ceil(tokens / block_size), the sizing formula: a request needs
        ``blocks_for_tokens(prompt_len + max_new_tokens)`` blocks."""
        return -(-max(tokens, 0) // self.block_size)

    def can_allocate(self, n: int) -> bool:
        """Cached refcount-0 blocks count as capacity: they are evicted on
        demand, so a hot prefix cache never blocks admission."""
        return n <= len(self._free) + len(self._lru)

    # ------------------------------------------------------------------ #
    # acquire / release
    # ------------------------------------------------------------------ #
    def allocate(self, n: int) -> list[int]:
        """Take ``n`` private blocks (refcount 1) or raise; the caller gates
        on :meth:`can_allocate` (the scheduler's admission check). The free
        list goes first, then cached blocks are evicted LRU first (their
        prefix must be prefilled again by its next user)."""
        if not self.can_allocate(n):
            raise RuntimeError(
                f"block pool exhausted: need {n}, have {len(self._free)} "
                f"free + {len(self._lru)} evictable cached of "
                f"{self.num_blocks - 1} allocatable"
            )
        blocks = []
        for _ in range(n):
            b = self._free.pop() if self._free else self._evict_lru()
            self._ref[b] = 1
            blocks.append(b)
        return blocks

    def _evict_lru(self) -> int:
        """Drop the coldest cached block's index entry and hand the block
        out. Only refcount-0 blocks are in the LRU, so a shared or
        in-flight block is never evicted."""
        block, _ = self._lru.popitem(last=False)
        del self._index[self._hash_of.pop(block)]
        self.evictions_total += 1
        return block

    def free(self, blocks: Iterable[int]) -> None:
        """Release one reference per block. At refcount 0 an unpublished
        block returns to the free list, a published one retires into the
        LRU's most recently used end, still indexed."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(
                    f"freeing block {b} that is not allocated (double free "
                    f"or foreign block)"
                )
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._hash_of:
                    self._lru[b] = None
                else:
                    self._free.append(b)

    def acquire(self, blocks: Sequence[int]) -> None:
        """Take one reference per block on live or cached blocks (the warm
        hit): a cached block leaves the LRU, an in-flight one gains a
        reference. A block that is neither (freed or evicted: the caller's
        :meth:`lookup` went stale) raises, and the references taken so far
        are released."""
        taken: list[int] = []
        try:
            for b in blocks:
                if b in self._ref:
                    self._ref[b] += 1
                elif b in self._lru:
                    del self._lru[b]
                    self._ref[b] = 1
                else:
                    raise ValueError(
                        f"acquiring block {b} that is neither allocated nor "
                        f"cached (stale lookup?)"
                    )
                taken.append(b)
        except ValueError:
            self.free(taken)
            raise

    # ------------------------------------------------------------------ #
    # content index
    # ------------------------------------------------------------------ #
    def publish(self, block: int, key: bytes) -> int:
        """Index an allocated block under ``key`` and return the canonical
        block for that key: if another block owns the key already (two
        identical prompts prefilled at once), the first writer wins and the
        caller's block stays private."""
        if block not in self._ref:
            raise ValueError(f"publishing block {block} that is not allocated")
        existing = self._index.get(key)
        if existing is not None and existing != block:
            return existing
        self._index[key] = block
        self._hash_of[block] = key
        return block

    def lookup(self, keys: Sequence[bytes]) -> list[int]:
        """The blocks of the longest indexed prefix of ``keys``, in chain
        order, without acquiring them (:meth:`acquire` them before any
        allocation can evict them). Keys are rolling hashes, so the walk
        stops at the first miss."""
        out: list[int] = []
        for k in keys:
            b = self._index.get(k)
            if b is None:
                break
            out.append(b)
        return out

    def unpublish(self, block: int) -> None:
        """Drop a block's index entry; a cached block becomes free. A no-op
        for an unpublished block."""
        key = self._hash_of.pop(block, None)
        if key is not None and self._index.get(key) == block:
            del self._index[key]
        if block in self._lru:
            del self._lru[block]
            self._free.append(block)

    def clear_cache(self) -> None:
        """Forget every cached prefix: LRU blocks return to the free list,
        in-flight published blocks lose their index entries and stay with
        their holders (the prefix toggle's off edge)."""
        for block in list(self._hash_of):
            self.unpublish(block)

    def stats(self) -> dict:
        """Occupancy; ``utilization`` counts only allocatable blocks."""
        usable = self.num_blocks - 1
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "free": len(self._free),
            "allocated": len(self._ref),
            "cached": len(self._lru),
            "shared": self.num_shared,
            "evictions_total": self.evictions_total,
            "utilization": len(self._ref) / usable if usable else 0.0,
        }


# ---------------------------------------------------------------------- #
# prefix keys and hit accounting
# ---------------------------------------------------------------------- #
def prefix_keys(fingerprint: str, adapter_id: Optional[str], tokens: Sequence[int],
                block_size: int) -> list[bytes]:
    """Rolling content keys for every full block of ``tokens``:
    ``key[i] = sha256(key[i-1] || tokens of block i)``, seeded with the
    model fingerprint and the adapter id, so a key commits to the model,
    the tenant and the whole prefix up to its block. The seed bytes and the
    int64 little-endian token bytes are the reference's, so the same
    fingerprint, adapter and tokens give the reference's keys."""
    h = hashlib.sha256(
        b"accelerate_tpu.prefix\x00"
        + fingerprint.encode()
        + b"\x00"
        + (adapter_id or "\x00base").encode()
    ).digest()
    n_full = len(tokens) // block_size
    raw = memoryview(np.asarray(tokens[:n_full * block_size], dtype="<i8").tobytes())
    keys: list[bytes] = []
    step = block_size * 8
    for i in range(n_full):
        h = hashlib.sha256(h + raw[i * step:(i + 1) * step]).digest()
        keys.append(h)
    return keys


class PrefixCache:
    """Prefix lookup and publish policy, and hit accounting, over a
    :class:`BlockPool`'s content index. Host state only: the device
    programs are the same with caching on or off."""

    def __init__(self, pool: BlockPool, fingerprint: str = ""):
        self.pool = pool
        self.fingerprint = fingerprint
        self.lookups = 0
        self.hits = 0
        self.hit_blocks_total = 0
        self.tokens_saved_total = 0
        self.cow_copies_total = 0

    def keys_for(self, tokens: Sequence[int], adapter_id: Optional[str]) -> list[bytes]:
        return prefix_keys(self.fingerprint, adapter_id, tokens, self.pool.block_size)

    def match(self, tokens: Sequence[int], adapter_id: Optional[str] = None,
              keys: Optional[Sequence[bytes]] = None) -> list[int]:
        """The longest cached chain prefix of ``tokens`` (block ids in chain
        order; empty on a miss); counts the lookup either way. ``keys``:
        :meth:`keys_for`'s result, which admission computes once a
        request."""
        self.lookups += 1
        if keys is None:
            keys = self.keys_for(tokens, adapter_id)
        blocks = self.pool.lookup(keys)
        if blocks:
            self.hits += 1
            self.hit_blocks_total += len(blocks)
        return blocks

    def publish(self, tokens: Sequence[int], adapter_id: Optional[str], blocks: Sequence[int],
                skip_indices: Iterable[int] = (),
                keys: Optional[Sequence[bytes]] = None) -> int:
        """Index every full prompt block of a freshly prefilled request;
        ``blocks`` is the slot's table in chain order, ``skip_indices`` the
        positions kept out (blocks already shared, copies written at
        another width). Returns how many blocks were newly published."""
        skip = set(skip_indices)
        published = 0
        if keys is None:
            keys = self.keys_for(tokens, adapter_id)
        for t, key in enumerate(keys):
            if t in skip:
                continue
            if self.pool.publish(blocks[t], key) == blocks[t]:
                published += 1
        return published

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hit_rate,
            "hit_blocks_total": self.hit_blocks_total,
            "prefill_tokens_saved_total": self.tokens_saved_total,
            "cow_copies_total": self.cow_copies_total,
        }
