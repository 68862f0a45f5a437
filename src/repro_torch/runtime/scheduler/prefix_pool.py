"""Victim cache for the paged prefix index, plus its restart persistence.

The prefix index in ``layouts.PagedLayout`` maps token prefixes to
resident block chains; without this module an index entry dies the
moment its block's refcount reaches zero, so a shared prompt prefix is
gone as soon as the requests using it complete — every cold admission
(and every new drain epoch) re-prefills system prompts that thousands
of tenants share. ``VictimCache`` is the retention half of the cache
service: a completed request's refcount-1 indexed blocks transfer
ownership here (the pool holds their single reference, K/V stays
resident, the index entries stay valid) instead of freeing, and are
evicted — weighted-LRU order, quota-aware — only under allocation
pressure. ``save_victim_cache``/``restore_victim_cache`` serialize the
resident index (tokens + pool K/V rows) through ``runtime.checkpoint``
so a restarted engine starts warm: the fault-tolerant Edge-PRUNE
companion (arXiv:2206.08152) motivates cache state surviving restarts
the same way unacked frames do.

Ownership invariant (pinned by tests/test_prefix_cache_props.py in the
reference): a block is never simultaneously live (in a slot's table) and
in the victim pool. Admission happens only when the releasing slot held
the last reference; revival removes the block from the pool and hands
that reference to the matching slot.

Counterpart of ``repro.runtime.scheduler.prefix_pool``. ``VictimCache``
is copied as it is; the row surgery works on the port's cache (one
``{"k", "v"}`` pool per layer) in place, and the file format is the
reference's: a ``checkpoint.save`` artifact whose pool rows carry the
reference's leaf names (``s{i}.k`` stacked over periods, ``r{j}.v``),
so a file either package saves restores in the other. Rows of a bf16
pool are written as float32, which holds every bf16 value exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.runtime import checkpoint
from repro_torch.runtime.policies import make_victim_eviction

__all__ = ["VictimCache", "save_victim_cache", "restore_victim_cache",
           "export_chains", "gather_block_rows", "scatter_block_rows"]

CHECKPOINT_FORMAT = "prefix-victim-v1"


class EvictionView(NamedTuple):
    """What a victim-eviction policy sees per block (see
    policies.VICTIM_EVICTION_POLICIES): re-match count, admission stamp
    (monotonic per admitted chain), page depth within its chain, and
    owning tenant."""
    hits: int
    stamp: int
    page: int
    tenant: str


@dataclass
class _Entry:
    tenant: str
    page: int
    stamp: int


class VictimCache:
    """Reclaimable pool of refcount-1 prefix blocks.

    Every block here is still *held* in the allocator (refcount exactly
    1, owned by this pool), so its K/V rows and prefix-index entries
    stay valid; it just doesn't belong to any request. The layout moves
    blocks in at release time (``admit``), hands them back to a matching
    admission (``revive`` — the pool's reference becomes the slot's,
    with no allocator traffic), and evicts them (``pick``/``drop``)
    only when an allocation actually comes up short.

    Per-block hit counts persist across revive/re-admit cycles (a
    chain that keeps getting matched stays hot) and are forgotten only
    when the block is truly freed — ``forget`` guards block-id reuse.
    Quotas are per-tenant byte budgets over pool occupancy: a tenant
    over budget evicts its own least-valuable blocks, never another
    tenant's (``over_quota``)."""

    def __init__(self, block_bytes: int, policy: Any = "weighted-lru",
                 quotas: Optional[Dict[str, int]] = None):
        self.block_bytes = int(block_bytes)
        self.policy = make_victim_eviction(policy)
        self.quotas: Dict[str, int] = dict(quotas or {})
        self.blocks: Dict[int, _Entry] = {}
        self._hits: Dict[int, int] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self.blocks)

    def __contains__(self, block: int) -> bool:
        return block in self.blocks

    @property
    def total_bytes(self) -> int:
        return len(self.blocks) * self.block_bytes

    def tenant_bytes(self, tenant: str) -> int:
        return sum(self.block_bytes for e in self.blocks.values()
                   if e.tenant == tenant)

    def per_tenant_bytes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.blocks.values():
            out[e.tenant] = out.get(e.tenant, 0) + self.block_bytes
        return out

    def hits(self, block: int) -> int:
        return self._hits.get(block, 0)

    def _order(self, block: int):
        e = self.blocks[block]
        return self.policy.key(EvictionView(self._hits.get(block, 0),
                                            e.stamp, e.page, e.tenant))

    def admit(self, pairs: Iterable[Tuple[str, int, int]]) -> None:
        """Take ownership of ``(tenant, page, block)`` entries — one
        released chain, one shared LRU stamp."""
        self._clock += 1
        for tenant, page, block in pairs:
            assert block not in self.blocks, \
                f"block {block} admitted to the victim pool twice"
            self.blocks[block] = _Entry(tenant, page, self._clock)

    def admit_restored(self, block: int, tenant: str, page: int,
                       stamp: int, hits: int) -> None:
        """Checkpoint-restore admission: preserves the saved LRU stamp
        and hit count so eviction priority survives the restart."""
        self.blocks[block] = _Entry(tenant, page, stamp)
        if hits:
            self._hits[block] = hits
        self._clock = max(self._clock, stamp)

    def record_match(self, blocks: Iterable[int]) -> None:
        """A prefix match touched these blocks (live or pooled): bump
        their persistent hit counts — the weight in weighted-LRU."""
        for b in blocks:
            self._hits[b] = self._hits.get(b, 0) + 1

    def revive(self, block: int) -> None:
        """A matching admission takes the block back: the pool's single
        reference becomes the slot's. Hit counts persist."""
        self.blocks.pop(block, None)

    def pick(self, n: int, exclude: Set[int] = frozenset()) -> List[int]:
        """Up to ``n`` blocks in eviction order (policy key ascending =
        least valuable first), skipping ``exclude`` — the blocks the
        in-flight admission is about to share or seed from."""
        order = sorted((b for b in self.blocks if b not in exclude),
                       key=self._order)
        return order[:n]

    def drop(self, blocks: Iterable[int]) -> None:
        """Evict: forget the entries (the caller releases the blocks —
        the pool's reference — back to the allocator)."""
        for b in blocks:
            self.blocks.pop(b, None)

    def forget(self, freed: Iterable[int]) -> None:
        """Blocks were truly freed: clear their persistent hit counts so
        a reused block id doesn't inherit a dead chain's heat."""
        for b in freed:
            self._hits.pop(b, None)
            self.blocks.pop(b, None)

    def over_quota(self, tenant: str) -> List[int]:
        """The tenant's pooled blocks to evict — its own, least valuable
        first — to get back under its byte budget. Empty for unbudgeted
        tenants; never names another tenant's blocks."""
        budget = self.quotas.get(tenant)
        if budget is None:
            return []
        mine = sorted((b for b, e in self.blocks.items()
                       if e.tenant == tenant), key=self._order)
        spill = len(mine) * self.block_bytes - budget
        take = max(0, -(-spill // self.block_bytes)) if spill > 0 else 0
        return mine[:take]


# -- checkpoint serialization ---------------------------------------------
#
# The saved artifact is the *resident prefix index*, chain by chain:
# each maximal root-to-leaf path through a tenant's chained-hash index
# (full pages, plus one chain per partial-tail entry) with the token
# text and every page's pool K/V rows. Tokens are stored because the
# hash chain is not invertible; restore re-registers each page through
# the same ``_chain`` hashing, reusing already-restored entries where
# paths share a prefix, so shared preambles deduplicate on the way back
# in exactly as they did live.


def _pool_leaves(cfg):
    """(flat name, leaf key, decoder layers, stacked) for every pool leaf,
    named as the reference names them: global-attention K/V is the only
    state the paged pool holds; a scanned-period leaf ``s{i}.k`` stacks
    period slot ``i`` of every period ((P, bs, Hk, hd) a block), a
    remainder leaf ``r{j}.k`` is one layer ((bs, Hk, hd) a block)."""
    per = len(cfg.layer_pattern)
    for i, kind in enumerate(cfg.layer_pattern):
        if kind == "attn":
            for key in ("k", "v"):
                yield (f"s{i}.{key}", key,
                       [p * per + i for p in range(cfg.n_periods)], True)
    for j, kind in enumerate(cfg.remainder_kinds):
        if kind == "attn":
            for key in ("k", "v"):
                yield f"r{j}.{key}", key, [cfg.n_periods * per + j], False


def gather_block_rows(cfg, cache, block: int) -> Dict[str, np.ndarray]:
    """One block's K/V rows out of every pool leaf, as host arrays (a
    bf16 pool's rows as float32)."""
    out = {}
    for name, key, layers, stacked in _pool_leaves(cfg):
        rows = torch.stack([cache[i][key][block] for i in layers])
        out[name] = (rows if stacked else rows[0]).float().cpu().numpy()
    return out


def scatter_block_rows(cfg, cache, block: int,
                       rows: Dict[str, np.ndarray]):
    """Write ``gather_block_rows`` output (of either package) into
    ``block`` of a (possibly different) pool, in place on the pool's
    device: one host-to-device copy a leaf, then an ``index_copy_``
    into each layer's pool. Returns the cache."""
    for name, key, layers, stacked in _pool_leaves(cfg):
        pool = cache[layers[0]][key]
        val = torch.as_tensor(np.asarray(rows[name])).to(
            device=pool.device, dtype=pool.dtype)
        if not stacked:
            val = val[None]
        if tuple(val.shape) != (len(layers),) + tuple(pool.shape[1:]):
            raise ValueError(f"{name}: rows {tuple(val.shape)} do not fit "
                             f"{len(layers)} pool blocks of "
                             f"{tuple(pool.shape[1:])}")
        idx = torch.tensor([block], dtype=torch.long, device=pool.device)
        for p, i in enumerate(layers):
            cache[i][key].index_copy_(0, idx, val[p:p + 1])
    return cache


def export_chains(layout) -> List[Tuple[str, List[np.ndarray], List[int]]]:
    """Walk the tenant-scoped prefix index into maximal chains:
    ``(tenant, per-page token arrays, per-page blocks)``. Every indexed
    block is resident by construction (entries die with their block),
    and indexed rows are never overwritten (decode writes strictly
    above the registered prompt), so live and pooled blocks export
    alike."""
    chains: List[Tuple[str, List[np.ndarray], List[int]]] = []
    tenants = set(layout._prefix_full) | set(layout._prefix_partial)
    for tenant in sorted(tenants):
        full = layout._prefix_full.get(tenant, {})
        partial = layout._prefix_partial.get(tenant, {})
        children: Dict[int, List[int]] = {}
        for key, (_, _, parent) in full.items():
            children.setdefault(parent, []).append(key)
        stack: List[Tuple[int, List[np.ndarray], List[int]]] = [(0, [], [])]
        while stack:
            key, toks, blks = stack.pop()
            kids = children.get(key, ())
            tails = partial.get(key, ())
            for blk, _, tail in tails:
                chains.append((tenant, toks + [tail], blks + [blk]))
            if blks and not kids and not tails:
                chains.append((tenant, toks, blks))
            for k in kids:
                blk, page, _ = full[k]
                stack.append((k, toks + [page], blks + [blk]))
    return chains


def save_victim_cache(path: str, layout, cfg) -> int:
    """Serialize the resident prefix index + victim-pool LRU state to a
    ``checkpoint.save`` artifact (path-flattened .npz + JSON meta).
    Returns the number of chains saved."""
    if layout.victim is None:
        raise ValueError("victim cache not enabled on this layout "
                         "(EngineConfig(victim_cache=True))")
    chains = export_chains(layout)
    tree: Dict[str, np.ndarray] = {}
    meta_chains = []
    for ci, (tenant, parts, blks) in enumerate(chains):
        tokens = np.concatenate([np.asarray(p, np.int32) for p in parts])
        tree[f"c{ci}/tokens"] = tokens
        stamps, hits = [], []
        for p, blk in enumerate(blks):
            entry = layout.victim.blocks.get(blk)
            stamps.append(entry.stamp if entry is not None else 0)
            hits.append(layout.victim.hits(blk))
            for name, rows in gather_block_rows(cfg, layout.cache,
                                                blk).items():
                tree[f"c{ci}/p{p}/{name}"] = rows
        meta_chains.append({"tenant": tenant, "len": int(tokens.size),
                            "pages": len(blks), "stamps": stamps,
                            "hits": hits})
    checkpoint.save(path, tree, meta={
        "format": CHECKPOINT_FORMAT, "model": cfg.name,
        "block_size": layout.block_size, "chains": meta_chains})
    return len(chains)


def restore_victim_cache(path: str, layout, cfg) -> int:
    """Load a ``save_victim_cache`` artifact into a (typically fresh)
    layout: allocate pool blocks, write their K/V rows, re-register the
    index entries under the saved tenants, and admit everything to the
    victim pool with the saved LRU stamps/hit counts. Stops a chain
    early if the pool fills (the remaining pages simply stay cold).
    Returns the number of blocks restored."""
    victim = layout.victim
    if victim is None:
        raise ValueError("victim cache not enabled on this layout "
                         "(EngineConfig(victim_cache=True))")
    meta = checkpoint.load_meta(path)
    if meta.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path}: not a {CHECKPOINT_FORMAT} artifact")
    if meta["model"] != cfg.name or meta["block_size"] != layout.block_size:
        raise ValueError(
            f"{path}: saved for model={meta['model']} "
            f"block_size={meta['block_size']}, engine runs {cfg.name} "
            f"block_size={layout.block_size}")
    flat = checkpoint.load_flat(path)
    bs = layout.block_size
    restored = 0
    for ci, cm in enumerate(meta["chains"]):
        tenant = cm["tenant"]
        tokens = np.asarray(flat[f"c{ci}/tokens"], np.int32)
        full_pages = len(tokens) // bs
        key = 0
        dead = False
        for p in range(full_pages):
            page = tokens[p * bs:(p + 1) * bs]
            nxt = layout._chain(key, page)
            entry = layout._prefix_full.get(tenant, {}).get(nxt)
            if entry is not None:
                if not np.array_equal(entry[1], page):
                    dead = True     # hash collision: drop the rest
                    break
            else:
                got = layout.alloc.alloc(1)
                if got is None:
                    dead = True     # pool full: remaining pages stay cold
                    break
                blk = got[0]
                rows = {name: flat[f"c{ci}/p{p}/{name}"]
                        for name, *_ in _pool_leaves(cfg)}
                layout.cache = scatter_block_rows(cfg, layout.cache, blk,
                                                  rows)
                layout._prefix_full.setdefault(tenant, {})[nxt] = \
                    (blk, page.copy(), key)
                layout._block_keys.setdefault(blk, []).append(
                    ("full", tenant, nxt))
                layout._block_tenant[blk] = tenant
                victim.admit_restored(blk, tenant, page=p,
                                      stamp=cm["stamps"][p],
                                      hits=cm["hits"][p])
                restored += 1
            key = nxt
        if dead or not len(tokens) % bs:
            continue
        tail = tokens[full_pages * bs:]
        bucket = layout._prefix_partial.setdefault(
            tenant, {}).setdefault(key, [])
        if not any(length == len(tokens) and np.array_equal(t, tail)
                   for _, length, t in bucket):
            got = layout.alloc.alloc(1)
            if got is None:
                if not bucket:      # undo the empty bucket we created
                    del layout._prefix_partial[tenant][key]
                    if not layout._prefix_partial[tenant]:
                        del layout._prefix_partial[tenant]
                continue
            blk = got[0]
            rows = {name: flat[f"c{ci}/p{full_pages}/{name}"]
                    for name, *_ in _pool_leaves(cfg)}
            layout.cache = scatter_block_rows(cfg, layout.cache, blk, rows)
            bucket.append((blk, len(tokens), tail.copy()))
            layout._block_keys.setdefault(blk, []).append(
                ("partial", tenant, key))
            layout._block_tenant[blk] = tenant
            victim.admit_restored(blk, tenant, page=full_pages,
                                  stamp=cm["stamps"][full_pages],
                                  hits=cm["hits"][full_pages])
            restored += 1
    for tenant in {cm["tenant"] for cm in meta["chains"]}:
        layout.enforce_quota(tenant)
    return restored
