"""KV-cache layouts of the port's scheduler, one object each.

Counterpart of ``repro.runtime.scheduler.layouts``: ``SlottedLayout``
gives every slot dense ``max_len`` rows; ``PagedLayout`` pools
global-attention K/V behind per-slot block tables, while local windows'
rings and recurrent state stay slot-indexed (allocator-backed,
prefix-sharing, copy-on-write, with the victim cache and its tenant
quotas). Caches are updated in place. The paged layout keeps its block
tables in numpy on the host, as the reference does, and uploads them to
the device only when a table changed (insert, growth, release), not on
every decode step. When ``SchedulerConfig.decode_stages > 1`` both
layouts decode through the stage-partitioned step
(``transformer.decode_step_staged``), whose contiguous layer groups are
what the execution core's ``DecodeExecutor`` pipeline charges its
per-stage clocks for; it runs the same kernels on the same values in
the same order, so tokens stay bit-identical to the single-stage step.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.scheduler.allocator import BlockAllocator
from repro_torch.runtime.scheduler.prefix_pool import VictimCache
from repro_torch.runtime.scheduler.types import (Request, SchedulerConfig,
                                                 cache_rows)

__all__ = ["SlottedLayout", "PagedLayout", "_PagedReservation"]


def _frozen(x):
    """A hashable copy of nested dicts, lists, tuples and arrays."""
    if isinstance(x, dict):
        return tuple(sorted((k, _frozen(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(map(_frozen, x))
    if isinstance(x, np.ndarray):
        return x.dtype.str, x.shape, x.tobytes()
    return x


def _decode(model: T.Transformer, s: SchedulerConfig, tokens: torch.Tensor,
            cache: T.Cache, cache_len: torch.Tensor,
            block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layouts' decode step: whole-model, or stage-partitioned when
    the config pipelines decode across units. Returns the logits; the
    cache updates in place."""
    if s.decode_stages > 1:
        logits, _, _ = T.decode_step_staged(
            model, tokens, cache, cache_len, num_stages=s.decode_stages,
            block_tables=block_tables)
    else:
        logits, _, _ = T.decode_step(model, tokens, cache, cache_len,
                                     block_tables=block_tables)
    return logits


class SlottedLayout:
    """Dense per-slot KV rows: slot ``i`` owns rows ``[i, :max_len]`` of
    every layer's cache, so admission needs no reservation, growth never
    happens and release frees nothing (a reused slot's rows are
    overwritten at insert)."""

    paged = False

    def __init__(self, cfg: ModelConfig, s: SchedulerConfig, max_len: int,
                 model: T.Transformer):
        self.max_len = max_len
        self.model = model
        self.sched = s
        self.cache = T.init_cache(cfg, s.max_slots, max_len,
                                  device=model.device)

    def validate(self, req: Request) -> None:
        pass

    def try_reserve(self, req: Request) -> Optional[List[int]]:
        return []

    def bind(self, slot: int, res) -> None:
        pass

    def register_prefix(self, slot: int, prompt: np.ndarray) -> None:
        pass                            # sharing is a paged-pool feature

    def insert(self, req_cache: T.Cache, slot: int) -> None:
        """Copy a batch=1 prefill cache into slot ``slot`` of the shared
        cache, in place: every leaf of every layer, so a reused slot's
        ring rows, recurrent state and cross K/V (with their length) are
        overwritten. A chunk-rounded
        scratch cache is longer than a slot: only the first rows that a
        slot holds are kept."""
        for big, small in zip(self.cache, req_cache):
            for key, leaf in big.items():
                row = small[key][0]
                leaf[slot].copy_(row[:leaf.shape[1]] if row.dim() else row)

    insert_scratch = insert

    def decode(self, tokens: torch.Tensor,
               cache_len: torch.Tensor) -> torch.Tensor:
        """One decode step over every slot; the cache updates in place."""
        return _decode(self.model, self.sched, tokens, self.cache, cache_len)

    def needs_block(self, slot: int, pos: int) -> bool:
        return False

    def grow_one(self, slot: int, pos: int) -> bool:
        raise RuntimeError("slotted layout never grows")

    def release(self, slot: int) -> None:
        pass

    def kv_stats(self, s: SchedulerConfig,
                 cfg: ModelConfig) -> Dict[str, float]:
        row = T.kv_row_bytes(cfg)
        return {"slotted_kv_reserved_bytes":
                float(s.max_slots * s.max_len * row)}

    def check(self, occupied_slots: set, max_slots: int) -> None:
        pass


@dataclass
class _PagedReservation:
    """Outcome of a paged admission reservation. ``blocks`` is the
    slot's table in page order: the first ``shared_pages`` entries are
    resident blocks mapped in by the prefix match (refcount already
    incremented), the rest freshly allocated private blocks.
    ``seed_blocks`` are the source blocks whose pool rows cover prompt
    positions ``[0, matched_rows)``: the scratch cache is seeded from
    them so ``prefill_extend`` can resume mid-prompt. The boundary page
    (the one containing row ``matched_rows``) is always private: its
    shared rows are copied through the scratch and written at insert
    time, copy-on-write realized at admission."""
    blocks: List[int]
    shared_pages: int = 0
    seed_blocks: List[int] = field(default_factory=list)
    matched_rows: int = 0
    tenant: str = ""                    # prefix-cache namespace


class PagedLayout:
    """Block-pool KV: each layer's K/V in shared fixed-size blocks
    addressed through per-slot block tables. Owns the allocator, the
    tables, the per-slot block bookkeeping (references released exactly
    once, whoever triggers it) and, with ``prefix_cache``, the
    tenant-scoped prefix index that lets admissions share resident block
    chains."""

    paged = True

    def __init__(self, cfg: ModelConfig, s: SchedulerConfig, max_len: int,
                 model: T.Transformer):
        if cfg.max_cache_len:
            raise ValueError(
                "paged KV cache is position-indexed; max_cache_len ring "
                "caps are a slotted-path feature")
        if all(k != "attn" for k in cfg.layer_kinds):
            raise ValueError(
                f"{cfg.name}: paged KV cache pages global-attention K/V, "
                "but this config has none (local windows and recurrent "
                "state are fixed-size per slot) — use the slotted layout; "
                "its memory is already bounded")
        self.cfg = cfg
        self.model = model
        self.sched = s
        self.max_len = max_len
        self.block_size = s.block_size
        self.watermark = s.watermark
        self.pages_per_slot = max_len // s.block_size
        num_blocks = s.num_blocks or (s.max_slots * self.pages_per_slot + 1)
        self.alloc = BlockAllocator(num_blocks, s.block_size)
        if self.watermark >= self.alloc.capacity:
            raise ValueError(
                f"watermark {self.watermark} leaves no admissible blocks "
                f"in a pool of {self.alloc.capacity}")
        self.block_tables = np.zeros((s.max_slots, self.pages_per_slot),
                                     np.int32)
        self._tables_dev: Optional[torch.Tensor] = None  # None = stale
        self._slot_blocks: Dict[int, List[int]] = {}
        self.cache = T.init_paged_cache(cfg, num_blocks, s.block_size,
                                        s.max_slots, max_len=max_len,
                                        device=model.device)
        # the mid-prompt resume runs through prefill_extend, so sharing
        # is gated on the same predicate as chunked prefill: a config
        # outside it is served paged without sharing, as in the reference
        self.prefix_cache = s.prefix_cache and T.supports_chunked_prefill(cfg)
        # tenant -> chained hash of a block-aligned prefix -> (resident
        # block holding its last page, that page's tokens, parent key).
        # A request probes only its own tenant's namespace, and a match
        # compares the tokens, so a hash collision degrades to a miss.
        self._prefix_full: Dict[str, Dict[int, Tuple[int, np.ndarray,
                                                     int]]] = {}
        # tenant -> chained hash of a prompt's full pages -> [(tail
        # block, prompt length, tail tokens), ...] for prompts whose
        # last page is partially filled
        self._prefix_partial: Dict[str, Dict[int, List[Tuple[
            int, int, np.ndarray]]]] = {}
        self._block_keys: Dict[int, List[Tuple[str, str, int]]] = {}
        self._block_tenant: Dict[int, str] = {}     # indexed block -> owner
        self._slot_tenant: Dict[int, str] = {}      # bound slot -> tenant
        self._shared_pages: Dict[int, int] = {}     # slot -> shared pages
        self._table_pending: Dict[int, List[int]] = {}  # bound, not inserted
        self.prefix_hits = 0            # admissions that matched a chain
        self.victim_hits = 0            # matches that touched pooled blocks
        self.victim_evictions = 0       # pooled blocks freed under pressure
        # victim cache: released refcount-1 indexed blocks park here
        # (still held, K/V resident, index entries alive) instead of
        # freeing, so the prefix index outlives requests and drain
        # epochs; evicted only under allocation pressure or a quota
        self.victim: Optional[VictimCache] = None
        self._protect: frozenset = frozenset()      # mid-reservation blocks
        if self.prefix_cache and s.victim_cache:
            self.victim = VictimCache(
                block_bytes=s.block_size * T.kv_row_bytes(cfg),
                policy=s.victim_eviction, quotas=s.prefix_cache_tenants)

    def _prompt_need(self, req: Request) -> int:
        """Blocks of the prefill's rows: a vision frontend's and the
        prompt's (``cache_rows``)."""
        return max(1, -(-cache_rows(self.cfg, req) // self.block_size))

    def _tables(self) -> torch.Tensor:
        """The block tables on the device, uploaded again only after a
        table changed."""
        if self._tables_dev is None:
            self._tables_dev = torch.tensor(self.block_tables,
                                            device=self.model.device)
        return self._tables_dev

    # -- prefix index -------------------------------------------------------

    # Keys are chained hashes: key_p = hash(key_{p-1}, page-p tokens), so
    # matching or registering a prompt hashes every token once.

    @staticmethod
    def _chain(key: int, tokens: np.ndarray) -> int:
        return hash((key, np.ascontiguousarray(tokens, np.int32).tobytes()))

    def match_prefix(self, prompt: np.ndarray,
                     tenant: str = "") -> Tuple[List[int], int]:
        """Longest resident match for ``prompt`` within ``tenant``'s
        namespace: (source blocks covering pages 0..ceil(matched/bs)-1,
        matched row count). Capped at ``len(prompt) - 1`` rows: the last
        prompt token is always recomputed so admission has logits to
        sample the first output token from."""
        bs = self.block_size
        full = self._prefix_full.get(tenant, {})
        partial = self._prefix_partial.get(tenant, {})
        cap = len(prompt) - 1
        src: List[int] = []
        key = 0
        while (len(src) + 1) * bs <= cap:
            page = prompt[len(src) * bs:(len(src) + 1) * bs]
            nxt = self._chain(key, page)
            entry = full.get(nxt)
            if entry is None or not np.array_equal(entry[1], page):
                break
            src.append(entry[0])
            key = nxt
        k = len(src)
        matched = k * bs
        # boundary extension into page k: (a) a full resident block whose
        # prefix covers this whole prompt (the capped exact-cover case),
        # else (b) a resident partial tail block with an identical fill
        if (k + 1) * bs == len(prompt):
            page = prompt[k * bs:]
            entry = full.get(self._chain(key, page))
            if entry is not None and np.array_equal(entry[1], page):
                return src + [entry[0]], cap
        best = None
        for blk, length, tail in partial.get(key, ()):
            if length <= cap and (best is None or length > best[1]) \
                    and np.array_equal(tail, prompt[k * bs:length]):
                best = (blk, length)
        if best is not None:
            return src + [best[0]], best[1]
        return src, matched

    def register_prefix(self, slot: int, prompt: np.ndarray) -> None:
        """Index ``slot``'s freshly inserted prompt K/V: one entry per
        block-aligned prefix (full blocks) plus a whole-prompt entry for
        a partially filled tail block. First writer wins; entries die
        with their block."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        tenant = self._slot_tenant.get(slot, "")
        table = self.block_tables[slot]
        key = 0
        for p in range(len(prompt) // bs):
            page = prompt[p * bs:(p + 1) * bs]
            nxt = self._chain(key, page)
            full = self._prefix_full.setdefault(tenant, {})
            if nxt not in full:
                blk = int(table[p])
                full[nxt] = (blk, np.array(page, np.int32), key)
                self._block_keys.setdefault(blk, []).append(
                    ("full", tenant, nxt))
                self._block_tenant[blk] = tenant
            key = nxt
        if len(prompt) % bs:
            tail = np.array(prompt[-(len(prompt) % bs):], np.int32)
            bucket = self._prefix_partial.setdefault(
                tenant, {}).setdefault(key, [])
            if not any(length == len(prompt) and np.array_equal(t, tail)
                       for _, length, t in bucket):
                blk = int(table[len(prompt) // bs])
                bucket.append((blk, len(prompt), tail))
                self._block_keys.setdefault(blk, []).append(
                    ("partial", tenant, key))
                self._block_tenant[blk] = tenant

    def _unregister(self, freed: List[int]) -> None:
        for b in freed:
            self._block_tenant.pop(b, None)
            for kind, tenant, key in self._block_keys.pop(b, ()):
                if kind == "full":
                    ns = self._prefix_full.get(tenant)
                    if ns is not None:
                        ns.pop(key, None)
                        if not ns:
                            del self._prefix_full[tenant]
                    continue
                tns = self._prefix_partial.get(tenant)
                bucket = tns.get(key) if tns is not None else None
                if bucket is not None:
                    bucket[:] = [e for e in bucket if e[0] != b]
                    if not bucket:
                        del tns[key]
                        if not tns:
                            del self._prefix_partial[tenant]

    # -- admission ----------------------------------------------------------

    def validate(self, req: Request) -> None:
        """Reject requests the pool can never serve: the worst case must
        fit the whole pool (decode growth bypasses the watermark, and
        a request left alone must be able to grow), and the
        prompt's rows (``cache_rows``: a vision frontend's among them)
        plus the watermark must fit at admission time."""
        rows = max(1, cache_rows(self.cfg, req)
                   + max(req.max_new_tokens - 1, 0))
        worst = -(-rows // self.block_size)
        if worst > self.alloc.capacity:
            raise ValueError(
                f"request {req.id}: needs {worst} KV blocks worst-case, "
                f"pool holds {self.alloc.capacity}")
        prompt_need = self._prompt_need(req)
        if prompt_need + self.watermark > self.alloc.capacity:
            raise ValueError(
                f"request {req.id}: prompt needs {prompt_need} KV blocks "
                f"but admission holds back watermark {self.watermark} of "
                f"{self.alloc.capacity} — can never be admitted")

    def try_reserve(self, req: Request) -> Optional[_PagedReservation]:
        """Reserve the prompt's blocks, sharing what the prefix index
        supplies: fully matched pages map resident blocks into the table
        (one more reference each) and only the rest is allocated. Returns
        None when the pool, less the watermark, cannot supply the private
        need: admission waits rather than over-commit. Victim-pooled
        blocks count as available (they are reclaimable on demand); a
        matched chain's pooled blocks are revived, the pool's reference
        becoming the slot's, rather than allocated again."""
        victims = len(self.victim) if self.victim is not None else 0
        if 1 + self.watermark > self.alloc.available + victims:
            # the boundary page is always private: no reservation can
            # succeed, so skip the prefix match
            return None
        need = self._prompt_need(req)
        while True:
            src: List[int] = []
            matched = 0
            if self.prefix_cache and req.embeds is None:
                src, matched = self.match_prefix(req.prompt, req.tenant)
            shared_pages = matched // self.block_size
            reclaim = None
            if self.victim is not None:
                # eviction under this allocation's pressure must not eat
                # the chain it is about to share or seed from
                self._protect = frozenset(src)
                reclaim = self._reclaim
            try:
                private = self.alloc.alloc(need - shared_pages,
                                           watermark=self.watermark,
                                           reclaim=reclaim)
            finally:
                self._protect = frozenset()
            if private is not None:
                break
            if self.victim is None:
                return None
            pooled = [b for b in src if b in self.victim]
            if not pooled:
                return None
            # every evictable block is protected by this very match:
            # sacrifice the deepest matched page and retry shorter
            self.victim.drop(pooled[-1:])
            self._free_blocks(pooled[-1:])
            self.victim_evictions += 1
        chain = src[:shared_pages]
        if matched:
            self.prefix_hits += 1
        if self.victim is None:
            self.alloc.share(chain)
        else:
            if matched and any(b in self.victim for b in src):
                self.victim_hits += 1
            share = []
            for b in chain:
                if b in self.victim:
                    self.victim.revive(b)
                else:
                    share.append(b)
            self.alloc.share(share)
            if matched:
                self.victim.record_match(src)
        return _PagedReservation(blocks=chain + private,
                                 shared_pages=shared_pages,
                                 seed_blocks=src, matched_rows=matched,
                                 tenant=req.tenant)

    def bind(self, slot: int, res: _PagedReservation) -> None:
        """Take ownership of the reservation's blocks for ``slot``. The
        table row stays zeroed (null block) until the insert commits it:
        decode steps interleave with a chunked prefill, and the batched
        decode writes every slot's (masked, never-read) K/V row through
        the table, which for a mid-prefill slot must name the null
        block, not a block another request shares."""
        self._slot_blocks[slot] = list(res.blocks)
        self._slot_tenant[slot] = res.tenant
        self._shared_pages[slot] = res.shared_pages
        self._table_pending[slot] = list(res.blocks)

    def _commit_table(self, slot: int) -> None:
        blocks = self._table_pending.pop(slot, None)
        if blocks is not None:
            self.block_tables[slot, :len(blocks)] = blocks
            self._tables_dev = None

    def _insert_ids(self, slot: int) -> np.ndarray:
        """Block ids for a prompt insert: shared pages go to the null
        block, so their rows are dropped instead of overwriting a block
        another request reads (the write half of copy-on-write)."""
        ids = self.block_tables[slot].copy()
        ids[:self._shared_pages.get(slot, 0)] = 0
        return ids

    def insert(self, req_cache: T.Cache, slot: int) -> None:
        self._commit_table(slot)
        T.paged_insert(self.cfg, self.cache, req_cache,
                       self._insert_ids(slot), slot,
                       block_size=self.block_size)

    # the chunk-rounded scratch cache inserts through the same table;
    # rows past the table's coverage are dropped
    insert_scratch = insert

    def seed_scratch(self, scratch_cache: T.Cache, res: _PagedReservation,
                     rows: int) -> T.Cache:
        """Copy the matched prefix's K/V out of the resident pool blocks
        into the head of a batch=1 scratch cache, so ``prefill_extend``
        can resume at ``rows``. Whole pages are copied."""
        pages = -(-rows // self.block_size)
        return T.paged_seed(self.cfg, scratch_cache, self.cache,
                            res.seed_blocks[:pages])

    def decode(self, tokens: torch.Tensor,
               cache_len: torch.Tensor) -> torch.Tensor:
        return _decode(self.model, self.sched, tokens, self.cache, cache_len,
                       block_tables=self._tables())

    # -- growth and release -------------------------------------------------

    def needs_block(self, slot: int, pos: int) -> bool:
        blk = int(self.block_tables[slot, pos // self.block_size])
        return not blk or self.alloc.refcount(blk) > 1

    def grow_one(self, slot: int, pos: int) -> bool:
        """Make the block covering ``pos`` privately writable for
        ``slot``: allocate it if the table entry is empty, or copy a
        block some other request still references into a fresh one
        first (copy-on-write; with prompt-only sharing this branch is
        unreachable, and kept as the invariant's safety net). Growth
        ignores the admission watermark, but reclaims victim-pooled
        blocks before failing into a preemption: idle cached prefixes
        never evict a live request."""
        page = pos // self.block_size
        blocks = self.alloc.alloc(
            1, reclaim=self._reclaim if self.victim is not None else None)
        if blocks is None:
            return False
        cur = int(self.block_tables[slot, page])
        if cur:                         # shared entry: copy before write
            T.paged_copy_block(self.cfg, self.cache, cur, blocks[0])
            held = self._slot_blocks[slot]
            held[held.index(cur)] = blocks[0]
            self._free_blocks([cur])
        else:
            self._slot_blocks[slot].append(blocks[0])
        self.block_tables[slot, page] = blocks[0]
        self._tables_dev = None
        return True

    def growth_state(self) -> Optional[tuple]:
        """The pool as the scheduler's livelock check reads it
        (``ContinuousScheduler._growth_state``): the free count and each
        slot's blocks; with a prefix cache, which blocks, their
        references, the free order and the prefix index too. None with a
        victim cache, whose LRU clock never repeats."""
        if self.victim is not None:
            return None
        held = tuple(len(self._slot_blocks.get(s, ()))
                     for s in range(self.sched.max_slots))
        if not self.prefix_cache:
            return self.alloc.available, held
        return _frozen((self.block_tables, self.alloc.state(),
                        self._slot_blocks, self._prefix_full,
                        self._prefix_partial, self._block_keys,
                        self._block_tenant, self._slot_tenant,
                        self._shared_pages, self._table_pending))

    def _free_blocks(self, blocks: List[int]) -> None:
        """Drop a reference per block; blocks that leave the pool take
        their prefix-index entries and their victim-cache hit history
        with them (block ids are reused)."""
        freed = self.alloc.release(blocks)
        self._unregister(freed)
        if self.victim is not None:
            self.victim.forget(freed)

    def _reclaim(self, shortfall: int) -> None:
        """Allocation-pressure hook (``BlockAllocator.alloc``): evict up
        to ``shortfall`` victim-pooled blocks, least valuable first, so
        the retried allocation can succeed. Blocks the in-flight
        reservation matched are protected."""
        picks = self.victim.pick(shortfall, exclude=self._protect)
        if picks:
            self.victim.drop(picks)
            self._free_blocks(picks)
            self.victim_evictions += len(picks)

    def enforce_quota(self, tenant: str) -> None:
        """Evict the tenant's own pooled blocks (never another's) until
        it is back under its byte budget."""
        evict = self.victim.over_quota(tenant)
        if evict:
            self.victim.drop(evict)
            self._free_blocks(evict)
            self.victim_evictions += len(evict)

    def release(self, slot: int) -> None:
        """Give back a slot's blocks. Without a victim cache every last
        reference frees its block and kills its index entries; with one,
        indexed blocks whose last reference this was pass to the victim
        pool instead (K/V resident, index alive), so the chain survives
        the request and the drain epoch until pressure or a quota
        reclaims it."""
        blocks = self._slot_blocks.pop(slot, [])
        self._shared_pages.pop(slot, None)
        self._table_pending.pop(slot, None)
        tenant = self._slot_tenant.pop(slot, "")
        if blocks:
            if self.victim is not None:
                keep = [(self._block_tenant.get(b, tenant), page, b)
                        for page, b in enumerate(blocks)
                        if self.alloc.refcount(b) == 1
                        and b in self._block_keys]
                keepset = {b for _, _, b in keep}
                rest = [b for b in blocks if b not in keepset]
            else:
                keep, rest = [], blocks
            if rest:
                self._free_blocks(rest)
            if keep:
                self.victim.admit(keep)
                for t in {t for t, _, _ in keep}:
                    self.enforce_quota(t)
        if self.block_tables[slot].any():
            self.block_tables[slot] = 0
            self._tables_dev = None

    # -- accounting ---------------------------------------------------------

    def kv_stats(self, s: SchedulerConfig,
                 cfg: ModelConfig) -> Dict[str, float]:
        row = T.kv_row_bytes(cfg)
        bs = s.block_size
        # the slotted baseline reserves the configured max_len, not the
        # paged path's block-rounded one
        out = {
            "slotted_kv_reserved_bytes": float(s.max_slots * s.max_len * row),
            "paged_kv_pool_bytes": float(self.alloc.capacity * bs * row),
            "paged_kv_hwm_bytes": float(self.alloc.hwm * bs * row),
            "paged_kv_hwm_blocks": float(self.alloc.hwm),
        }
        if self.victim is not None:
            out["victim_kv_blocks"] = float(len(self.victim))
            out["victim_kv_bytes"] = float(self.victim.total_bytes)
        return out

    def prefix_cache_stats(self) -> Dict[str, object]:
        """Cache-service gauges for ``Engine.snapshot`` and the server's
        /status: hit counters plus victim-pool occupancy per tenant."""
        out: Dict[str, object] = {
            "enabled": self.prefix_cache,
            "victim_cache": self.victim is not None,
            "prefix_hits": self.prefix_hits,
            "victim_hits": self.victim_hits,
            "victim_evictions": self.victim_evictions,
        }
        if self.victim is not None:
            out["victim_blocks"] = len(self.victim)
            out["victim_bytes"] = self.victim.total_bytes
            out["per_tenant_bytes"] = self.victim.per_tenant_bytes()
            out["tenant_quotas"] = dict(self.victim.quotas)
        return out

    def check(self, occupied_slots: set, max_slots: int) -> None:
        """Block books: every held block's reference count equals the
        number of table entries naming it across occupied slots (a slot
        never maps one block at two pages) plus one for victim-pool
        ownership (a block is never both live and pooled), free slots
        have zero tables, the prefix index names only held blocks, and
        the device copy of the tables, when current, equals the
        host's."""
        self.alloc.check()
        assert set(self._slot_blocks) == occupied_slots, \
            (set(self._slot_blocks), occupied_slots)
        refs: Counter = Counter()
        for slot, blocks in self._slot_blocks.items():
            assert len(blocks) == len(set(blocks)), \
                f"slot {slot} references a block at two pages"
            entries = self.block_tables[slot][self.block_tables[slot] > 0]
            if slot in self._table_pending:     # bound, prefill in flight
                assert not entries.size, \
                    f"slot {slot}: table committed before insert"
            else:
                assert sorted(entries.tolist()) == sorted(blocks), \
                    f"slot {slot}: table and block list disagree"
            refs.update(blocks)
        if self.victim is not None:
            for blk in self.victim.blocks:
                assert blk not in refs, \
                    f"block {blk} simultaneously live and in victim pool"
                assert blk in self._block_keys, \
                    f"victim pool holds unindexed block {blk}"
                refs[blk] += 1
        assert dict(refs) == self.alloc._refs, (dict(refs), self.alloc._refs)
        for slot in range(max_slots):
            if slot not in occupied_slots:
                assert not self.block_tables[slot].any(), \
                    f"slot {slot}: stale block table"
        for blk, keys in self._block_keys.items():
            assert blk in self.alloc._refs, \
                f"prefix index names freed block {blk}"
            assert all(t == self._block_tenant.get(blk) for _, t, _ in keys), \
                f"block {blk} indexed under two tenants"
        if self._tables_dev is not None:
            assert np.array_equal(self._tables_dev.cpu().numpy(),
                                  self.block_tables), "stale device tables"
