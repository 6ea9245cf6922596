"""Refcounted KV block pool accounting (the serving engine's memory layer).

Pure host-side (no torch): the physical pool tensors live in the model
cache (``models.registry.make_cache(layout="paged")``); this module owns WHICH
block belongs to WHOM.  A copy of the JAX package's allocator: ``alloc``
hands a block out at refcount 1, ``incref`` adds a holder (the prefix
cache, ``launch.prefix_cache``, shares blocks this way: a tree node
adopting a block, a slot mapping a cached prefix), and ``free`` is a
decref that only returns the block to the free list when the last holder
lets go.
"""

from __future__ import annotations


class BlockAllocator:
    """Refcounted free-list allocator over a global pool of KV blocks.

    Pure host-side.  Reservations are TRANSIENT: the scheduler
    reserves exactly the blocks an admission or grant is about to
    ``alloc`` (the reserve/alloc pair keeps the accounting honest), not
    a request's whole-lifetime budget — decode blocks are granted on
    demand as the sequence grows, and a grant the pool can't cover is
    the scheduler's problem (LRU-evict cached blocks, else preempt the
    slot), not an up-front admission tax.  ``available()`` is free minus
    outstanding reservations.

    Blocks carry per-block REFCOUNTS so the prefix cache can share them:
    ``alloc`` hands a block out at refcount 1, ``incref`` adds a holder
    (the radix tree adopting a block, a slot mapping a cached prefix),
    and ``free`` is a decref — the block returns to the free list only
    when the last holder lets go.  Freeing a block whose refcount is
    already 0 is the double-free error it always was.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("need at least one block of at least one "
                             "token")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks
        self._reserved = 0
        self.peak_in_use = 0

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` KV entries (ceil)."""
        return -(-tokens // self.block_size)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def available(self) -> int:
        return len(self._free) - self._reserved

    def utilization(self) -> float:
        """Fraction of the pool held or reserved — the pool-pressure
        signal risk-aware scheduling keys on (1.0 means the next
        admission/grant must evict, preempt or defer).  Traced per
        chunk in ``SlotScheduler.pool_stats``."""
        return (self.in_use + self._reserved) / self.num_blocks

    def reserve(self, n: int) -> bool:
        """Set aside ``n`` blocks for later alloc; False if they aren't
        there (the caller defers admission instead of crashing)."""
        if self.available() < n:
            return False
        self._reserved += n
        return True

    def unreserve(self, n: int) -> None:
        if n > self._reserved:
            raise ValueError(f"unreserve({n}) exceeds {self._reserved} "
                             "outstanding reservations")
        self._reserved -= n

    def alloc(self, n: int) -> list[int]:
        """Draw ``n`` physical blocks down from an existing reservation."""
        if n > self._reserved:
            raise ValueError(f"alloc({n}) without reservation "
                             f"({self._reserved} reserved)")
        self._reserved -= n
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return ids

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def incref(self, ids: list[int]) -> None:
        """Add a holder to live blocks (prefix-cache adoption/sharing)."""
        for i in ids:
            if self._ref[i] < 1:
                raise ValueError(f"incref of free block {i}")
            self._ref[i] += 1

    def free(self, ids: list[int]) -> None:
        """Decref; a block rejoins the free list when its last holder
        (slot or prefix-cache node) releases it.  No single holder ever
        releases one block twice in a call, so same-call duplicates are
        a caller bug caught here rather than a silent refcount steal."""
        if len(set(ids)) != len(ids):
            dupes = sorted({i for i in ids if ids.count(i) > 1})
            raise ValueError(f"double free of blocks {dupes}")
        for i in ids:
            if self._ref[i] < 1:
                raise ValueError(f"double free of blocks [{i}]")
            self._ref[i] -= 1
            if self._ref[i] == 0:
                self._free.append(i)
