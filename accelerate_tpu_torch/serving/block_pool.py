"""Host-side allocator for the device KV block pools.

Port of ``accelerate_tpu/serving/block_pool.py:BlockPool`` (:43) without
its prefix-caching and swap ledger (``PrefixCache``, ``prefix_keys``,
``publish``/``lookup``/``acquire``, ``swap_out``/``swap_in``; ROADMAP.md,
queue A9). Block 0 is the reserved garbage block: the device routes every
invalid write (bucket padding, empty decode slots) there, so the allocator
never hands it out. Ids come out lowest first, and a freed block is the
next one handed out, as in the reference.
"""

from __future__ import annotations

from typing import Iterable


class BlockPool:
    """Free list over ``num_blocks`` KV blocks of ``block_size`` tokens.
    Allocation is all or nothing; a double free or a foreign block raises
    instead of corrupting a neighbour's cache. ``num_free + num_allocated
    == num_blocks - 1`` always: the garbage block is in neither."""

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
        self._allocated: set[int] = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._allocated)

    def blocks_for_tokens(self, tokens: int) -> int:
        """ceil(tokens / block_size), the sizing formula: a request needs
        ``blocks_for_tokens(prompt_len + max_new_tokens)`` blocks."""
        return -(-max(tokens, 0) // self.block_size)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def allocate(self, n: int) -> list[int]:
        """Take ``n`` blocks or raise; the caller gates on
        :meth:`can_allocate` (the scheduler's admission check)."""
        if not self.can_allocate(n):
            raise RuntimeError(
                f"block pool exhausted: need {n}, have {len(self._free)} free of "
                f"{self.num_blocks - 1} allocatable"
            )
        blocks = [self._free.pop() for _ in range(n)]
        self._allocated.update(blocks)
        return blocks

    def free(self, blocks: Iterable[int]) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(
                    f"freeing block {b} that is not allocated (double free or foreign block)")
            self._allocated.remove(b)
            self._free.append(b)

    def stats(self) -> dict:
        """Occupancy; ``utilization`` counts only allocatable blocks."""
        usable = self.num_blocks - 1
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "free": len(self._free),
            "allocated": len(self._allocated),
            "utilization": len(self._allocated) / usable if usable else 0.0,
        }
