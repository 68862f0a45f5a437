"""Refcounted fixed-pool block allocator for the paged KV cache.

Counterpart of ``repro.runtime.scheduler.allocator``, copied (it is pure
Python), with the victim cache's ``reclaim`` hook. Prefill writes a slot's K/V into blocks held at refcount >= 1,
prefix sharing maps one physical block into several tables (``share``),
and the prefill -> decode handoff is zero-copy because the blocks never
move: the decode step reads the same pool pages the prefill wrote.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

__all__ = ["BlockAllocator"]


class BlockAllocator:
    """Fixed pool of KV-cache blocks with per-block reference counts.

    Physical block 0 is reserved as the null block: free slots and
    unallocated block-table entries point at it, so their (masked,
    never-read) decode writes land somewhere harmless; it is never
    allocated and never freed. ``alloc`` hands out blocks at refcount 1
    and returns None when the request can't be satisfied — the scheduler
    queues or preempts instead of over-committing. ``share`` adds a
    reference to an already-held block (prefix sharing maps one physical
    block into several requests' tables); ``release`` drops one
    reference per block and returns a block to the free pool only when
    its count reaches zero. Releasing a block that isn't held raises, so
    a double-free is an error, not silent pool corruption.
    ``alloc(n, watermark=w)`` additionally refuses to dip into the last
    ``w`` free blocks — the admission-time damper that keeps headroom for
    the running requests' decode growth."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved null "
                             f"block), got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}     # block -> reference count
        self.hwm = 0                    # high-water mark, blocks in use

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1      # block 0 reserved

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._refs)

    def refcount(self, block: int) -> int:
        """Current reference count of ``block`` (0 = not held)."""
        return self._refs.get(block, 0)

    def state(self) -> tuple:
        """The free list in its order and every held block's count."""
        return tuple(self._free), tuple(sorted(self._refs.items()))

    def alloc(self, n: int, watermark: int = 0,
              reclaim: Optional[Callable[[int], None]] = None,
              ) -> Optional[List[int]]:
        """``n`` blocks at refcount 1, or None when fewer than
        ``n + watermark`` are free. ``reclaim``, when given, is called
        with the shortfall before giving up: the victim cache's hook,
        which evicts up to that many parked prefix blocks back into the
        free pool, so parked blocks never block an allocation and are
        evicted only under this pressure."""
        if n + watermark > len(self._free) and reclaim is not None:
            reclaim(n + watermark - len(self._free))
        if n + watermark > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._refs[b] = 1
        self.hwm = max(self.hwm, len(self._refs))
        return blocks

    def share(self, blocks: List[int]) -> None:
        """Add one reference to each (already-held) block — the prefix-
        sharing path, mapping a resident chain into another table."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"block {b} shared but not held")
            self._refs[b] += 1

    def reset_hwm(self) -> None:
        """Restart high-water tracking from the current occupancy (e.g.
        between a warmup drain and a measured run)."""
        self.hwm = len(self._refs)

    def release(self, blocks: List[int]) -> List[int]:
        """Drop one reference per block; blocks whose count reaches zero
        return to the free pool. Returns the blocks actually freed (the
        caller invalidates prefix-index entries for exactly those)."""
        freed: List[int] = []
        for b in blocks:
            count = self._refs.get(b)
            if count is None:
                raise ValueError(f"block {b} freed but not held "
                                 f"(double free or foreign block)")
            if count == 1:
                del self._refs[b]
                self._free.append(b)
                freed.append(b)
            else:
                self._refs[b] = count - 1
        return freed

    def check(self) -> None:
        assert len(self._free) + len(self._refs) == self.capacity, \
            (len(self._free), len(self._refs), self.capacity)
        assert 0 not in self._refs and 0 not in self._free
        assert all(c >= 1 for c in self._refs.values()), \
            "refcount dropped below 1 while held"
