"""Operations and bytes of the port's kernel calls, counted from shapes.

Each kernel's cost function sits beside its wrapper in ``ops.py`` and
gives what one call needs, counted as a roofline counts it: each input
byte read once and each output byte written once, whatever the kernel
reads again; live operations only, so a causal or windowed mask counts
the (query, key) pairs it keeps. ``chip_smoke.py``'s bounds and the dry
run (``repro_torch.launch.dryrun``) read the same functions, so one
count serves both.

On the meta device a wrapper launches nothing and moves no launch
counter: it returns empty outputs of the right shapes and dtypes and
adds its call's cost to the innermost active ``KernelCount``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Cost:
    """One call's operations and bytes."""
    flops: int
    bytes: int


@dataclass
class KernelCount:
    """The kernel calls made on the meta device while this is active
    (``with KernelCount() as kc:``): their summed operations and bytes
    and the calls by kernel name."""
    flops: int = 0
    bytes: int = 0
    calls: Dict[str, int] = field(default_factory=dict)

    def __enter__(self) -> "KernelCount":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def add(self, name: str, cost: Cost) -> None:
        self.flops += cost.flops
        self.bytes += cost.bytes
        self.calls[name] = self.calls.get(name, 0) + 1


# the counters entered and not yet left, innermost last: a wrapper's meta
# branch has no argument through which a caller could hand one down
_ACTIVE: List[KernelCount] = []


def count_meta_call(name: str, cost: Cost) -> None:
    """Add a meta-device call's cost to the innermost active counter
    (none active: the call is not counted)."""
    if _ACTIVE:
        _ACTIVE[-1].add(name, cost)


def live_pairs(sq: int, sk: int, *, causal: bool, window: int,
               q_offset: Optional[Sequence[int]] = None,
               kv_len: Optional[Sequence[int]] = None, batch: int = 1
               ) -> int:
    """(query, key) pairs the flash mask keeps, summed over the batch:
    query row i of sequence b sits at position ``q_offset[b] + i``; key
    k is live when k < ``kv_len[b]``, with ``causal`` k <= the query's
    position, and with ``window`` > 0 position - k < ``window`` (the
    mask of ``flash_attention/ref.py``). Absent, the offsets are 0 and
    the lengths ``sk``."""
    offs = list(q_offset) if q_offset is not None else [0] * batch
    lens = list(kv_len) if kv_len is not None else [sk] * batch
    if len(offs) != len(lens):
        raise ValueError(f"live_pairs: {len(offs)} offsets for "
                         f"{len(lens)} lengths")
    total = 0
    for off, n in zip(offs, lens):
        pos = np.arange(off, off + sq, dtype=np.int64)
        hi = np.minimum(pos + 1, min(n, sk)) if causal \
            else np.full(sq, min(n, sk), np.int64)
        lo = np.maximum(pos - window + 1, 0) if window > 0 \
            else np.zeros(sq, np.int64)
        total += int(np.maximum(hi - lo, 0).sum())
    return total
