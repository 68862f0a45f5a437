"""Mixture-of-Experts MLP of the port: token-choice top-k routing with a
fixed capacity per group, the counterpart of ``repro.models.moe``.

Covers qwen2-moe (4 shared + 60 routed experts, top-4) and qwen3-moe
(128 routed, top-8). Groups are batch rows: each row's tokens compete
for ``_capacity(S)`` slots per expert, first choices before second
choices (k-major), then in token order; a (token, choice) past its
expert's capacity is dropped and its residual passes through. Two
dispatches compute the same function, as in the reference, chosen by
``cfg.moe_impl``: ``"einsum"`` (the config's default, Switch-style
one-hot dispatch and combine tensors of (G, T, E, C) in the compute
dtype) and ``"gather"`` (a slot -> token table and two gathers).

The expert products are ``torch.einsum`` over the stacked expert
weights, as the reference computes them in XLA outside any Pallas
kernel. Top-k breaks ties as ``jax.lax.top_k`` does, lowest index
first (a stable descending sort): in bf16 the router logits of 60 or
128 experts often tie exactly. The aux loss is the Switch load-balance
loss plus 1e-3 x the router z-loss.

Over a mesh (``ctx``, a ``sharding.ShardCtx``) the layer runs on the
part of the expert banks that ZeRO-3's per-layer gather leaves each
"model" rank, with no all-to-all: the banks cut by expert where the
expert count divides "model"
(qwen3-moe's 128: expert parallelism), else every expert over F / model
columns (qwen2-moe's 60 on 16: the per-expert tensor-parallel
fallback). The activations are whole on every rank, so each rank routes
its rows over all E experts exactly as the unsharded layer does (the
same top-k, queue positions, drops and aux loss), builds dispatch and
combine for its own experts only, runs them, and adds the shared
experts' column-parallel share; the partial outputs are summed over
"model" once per layer (``_Cut``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import act_fn, dense_init, rms_norm


class MoE(nn.Module):
    """``moe`` leaves: ln (d,), router (d, E) kept fp32, w_gate / w_up
    (E, d, f) and w_down (E, f, d), and ``shared`` (an MLP of width
    ``d_ff_expert * n_shared_experts``, built by the caller) when the
    config has shared experts."""

    def __init__(self, cfg, dtype, device, param, shared=None):
        super().__init__()
        d, m = cfg.d_model, cfg.moe
        e, f = m.n_experts, m.d_ff_expert
        self.ln = param((d,), dtype, device)
        self.router = param((d, e), torch.float32, device)
        self.w_gate = param((e, d, f), dtype, device)
        self.w_up = param((e, d, f), dtype, device)
        self.w_down = param((e, f, d), dtype, device)
        self.register_module("shared", shared)


@torch.no_grad()
def moe_init(p: MoE, cfg, gen: torch.Generator) -> None:
    """The reference ``moe_init``'s shapes and scales: the router and
    the experts N(0, 1) / sqrt(in_dim), drawn as (in, E, out) and
    transposed, as the reference draws them; the norm zero."""
    d, m = cfg.d_model, cfg.moe
    e, f = m.n_experts, m.d_ff_expert
    dev, dt = p.w_gate.device, p.w_gate.dtype
    p.router.copy_(dense_init(gen, d, (e,), torch.float32, dev))
    p.w_gate.copy_(dense_init(gen, d, (e, f), dt, dev).transpose(0, 1))
    p.w_up.copy_(dense_init(gen, d, (e, f), dt, dev).transpose(0, 1))
    p.w_down.copy_(dense_init(gen, f, (e, d), dt, dev).transpose(0, 1))


def _capacity(tokens_per_group: int, cfg) -> int:
    """Slots per expert and group: tokens x top_k x capacity_factor / E,
    rounded up to a multiple of 32, at least 32."""
    m = cfg.moe
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.n_experts)
    return max(c - c % -32, 32)


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lowest index (``torch.topk`` orders ties arbitrarily)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _assign(router_logits: torch.Tensor, cfg, capacity: int,
            experts: Optional[Tuple[int, int]] = None):
    """The routing both dispatches share. router_logits (G, T, E) fp32.
    Returns (top_idx (G,T,K) expert ids, pos (G,T,K) slot in the
    expert's queue, keep (G,T,K) bool, top_p (G,T,K) renormalized fp32,
    aux loss): queue positions by a cumsum over the choices flattened
    k-major, so first choices win capacity over second choices.

    ``experts`` = (lo, hi) restricts the queues to those experts (a
    rank's under expert parallelism; default all): a queue is a cumsum
    down its own expert's column, so the local columns give the local
    experts' positions unchanged, and a choice of any other expert has
    ``keep`` False here. Top-k, ``top_p`` and the aux loss always see
    every expert."""
    g, t, e = router_logits.shape
    lo, hi = experts or (0, e)
    k = cfg.moe.top_k
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_p, top_idx = _top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    mine = _local_onehot(top_idx, lo, hi).long()            # (G, T, K, El)
    pos = torch.cumsum(mine.transpose(1, 2).reshape(g, k * t, hi - lo),
                       dim=1) - 1                           # (G, K*T, El)
    pos = pos.reshape(g, k, t, hi - lo).transpose(1, 2)      # (G, T, K, El)
    pos = (pos * mine).sum(-1)                              # (G, T, K)
    keep = (pos < capacity) & (top_idx >= lo) & (top_idx < hi)
    frac_tokens = F.one_hot(top_idx, e).float().sum(2).mean(1)  # (G, E)
    aux = e * (frac_tokens * probs.mean(1)).sum(-1).mean()
    z = (torch.logsumexp(router_logits, dim=-1) ** 2).mean()
    return top_idx, pos, keep, top_p, aux + 1e-3 * z


def _local_onehot(top_idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """(G, T, K, hi - lo) bool: which of experts lo..hi-1 each choice
    names."""
    return top_idx[..., None] == torch.arange(lo, hi, device=top_idx.device)


def _slots(top_idx, pos, keep, top_p, capacity: int, compute_dtype,
           experts: Tuple[int, int]):
    """The one-hot dispatch (G, T, El, C) bool and combine (G, T, El, C)
    in ``compute_dtype`` over the experts lo..hi-1 alone. A token's K
    choices are distinct experts, so each (t, e, c) of ``combine`` holds
    one choice's renormalized probability, rounded once to
    ``compute_dtype``."""
    disp_f = (_local_onehot(top_idx, *experts)
              & keep[..., None]).to(compute_dtype)
    pos_oh = F.one_hot(torch.where(keep, pos, capacity), capacity + 1)[
        ..., :capacity].to(compute_dtype)                   # (G, T, K, C)
    dispatch = torch.einsum("gtke,gtkc->gtec", disp_f, pos_oh) > 0
    combine = torch.einsum("gtke,gtkc->gtec",
                           disp_f * top_p.to(compute_dtype)[..., None],
                           pos_oh)
    return dispatch, combine


def route(router_logits: torch.Tensor, cfg, capacity: int, *,
          compute_dtype=torch.float32
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """router_logits: (G, T, E). Returns (dispatch (G,T,E,C) bool,
    combine (G,T,E,C) in ``compute_dtype``, aux loss): the reference's
    one-hot dispatch over every expert."""
    top_idx, pos, keep, top_p, aux = _assign(router_logits, cfg, capacity)
    return (*_slots(top_idx, pos, keep, top_p, capacity, compute_dtype,
                    (0, router_logits.shape[-1])), aux)


def route_indices(router_logits: torch.Tensor, cfg, capacity: int):
    """Index-form routing with ``route``'s assignment: (top_idx, pos,
    keep, top_p, aux), no (G, T, E, C) tensor."""
    return _assign(router_logits, cfg, capacity)


def _router_logits(p, h: torch.Tensor) -> torch.Tensor:
    """The router product in the compute dtype (the fp32 router cast to
    h's dtype, as the reference casts it), then fp32 logits."""
    return (h @ p.router.to(h.dtype)).float()


def _experts(p, xe: torch.Tensor, cfg) -> torch.Tensor:
    """The routed experts' gated MLP over their slots. xe: (G, E, C, D)
    -> (G, E, C, D)."""
    act = act_fn(cfg.act)
    hidden = act(torch.einsum("gecd,edf->gecf", xe, p.w_gate)) \
        * torch.einsum("gecd,edf->gecf", xe, p.w_up)
    return torch.einsum("gecf,efd->gecd", hidden, p.w_down)


class _Cut:
    """How the "model" axis of a ``ctx`` (``sharding.ShardCtx``; None:
    unsharded) cuts an MoE layer's compute copy ``p``: ``experts`` the
    routed experts [lo, hi) this rank computes (E / model of them under
    expert parallelism, else all), ``routed`` / ``shared`` whether the
    routed experts' and the shared experts' outputs are this rank's
    partial sums (by expert, or over its F / model columns).

    Every rank routes its rows over all E experts (the router is whole
    on each); the gradient reaching ``top_p`` through the combine is
    then partial (the local experts', or their local columns') and is
    summed over "model" (``weights``), while the aux loss's, the same on
    every rank, is not. The experts' input takes the column-parallel
    gradient sum (``inputs``) and the partial outputs one sum over
    "model" (``output``)."""

    def __init__(self, p, cfg, ctx):
        e = cfg.moe.n_experts
        self.ctx = ctx
        self.experts = (0, e) if ctx is None else ctx.experts(p, e)
        self.routed = ctx is not None and ctx.split(p, "w_gate")
        self.shared = ctx is not None and p.shared is not None \
            and ctx.split(p.shared, "w_gate")

    def weights(self, top_p: torch.Tensor) -> torch.Tensor:
        return self.ctx.tp_in(top_p) if self.routed else top_p

    def inputs(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the routed experts' input, the shared experts')."""
        if not (self.routed or self.shared):
            return h, h
        ht = self.ctx.tp_in(h)
        return (ht if self.routed else h), (ht if self.shared else h)

    def output(self, p, hs: torch.Tensor, y: torch.Tensor, cfg
               ) -> torch.Tensor:
        """y (the routed experts' output) plus the shared experts run
        densely on every token of ``hs``, each partial sum summed over
        "model" once."""
        if p.shared is None:
            return self.ctx.tp_out(y) if self.routed else y
        sh, act = p.shared, act_fn(cfg.act)
        z = (act(hs @ sh.w_gate) * (hs @ sh.w_up)) @ sh.w_down
        if self.routed == self.shared:
            y = y + z
            return self.ctx.tp_out(y) if self.routed else y
        if self.routed:
            return self.ctx.tp_out(y) + z
        return y + self.ctx.tp_out(z)


def moe_apply_einsum(p, x: torch.Tensor, cfg, ctx=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (x + the MoE's output, aux loss), through the
    one-hot dispatch and combine tensors. Under a ``ctx`` whose "model"
    axis cuts the experts (``_Cut``), those tensors are (G, T, E / model,
    C): the rank's experts' columns alone."""
    s = x.shape[1]
    cut = _Cut(p, cfg, ctx)
    h = rms_norm(x, p.ln, cfg.norm_eps)
    cap = _capacity(s, cfg)
    top_idx, pos, keep, top_p, aux = _assign(_router_logits(p, h), cfg, cap,
                                             cut.experts)
    dispatch, combine = _slots(top_idx, pos, keep, cut.weights(top_p), cap,
                               h.dtype, cut.experts)
    hr, hs = cut.inputs(h)
    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(h.dtype), hr)
    ye = _experts(p, xe, cfg)
    y = torch.einsum("gtec,gecd->gtd", combine.to(h.dtype), ye)
    return x + cut.output(p, hs, y, cfg).to(x.dtype), aux


def moe_apply_gather(p, x: torch.Tensor, cfg, ctx=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The index-form dispatch: a slot -> token table (G, E, C) whose
    empty slots name the zero row ``s`` appended to h (a dropped choice
    writes past the last slot and is discarded), one gather into the
    (G, E, C, D) expert buffers, and the combine as a gather of each
    token's K slots weighted by its kept probabilities. Under a ``ctx``
    whose "model" axis cuts the experts the table is (G, E / model, C)
    over the rank's experts, and a choice of another rank's expert
    weighs zero here."""
    b, s, d = x.shape
    cut = _Cut(p, cfg, ctx)
    lo, hi = cut.experts
    h = rms_norm(x, p.ln, cfg.norm_eps)
    cap = _capacity(s, cfg)
    top_idx, pos, keep, top_p, aux = _assign(_router_logits(p, h), cfg, cap,
                                             cut.experts)
    local = (top_idx - lo).clamp(0, hi - lo - 1)   # others: dropped slot
    rows = torch.arange(b, device=x.device)[:, None, None]
    idx_token = torch.full((b, hi - lo, cap + 1), s, dtype=torch.int64,
                           device=x.device)
    idx_token[rows.expand_as(top_idx), local,
              torch.where(keep, pos, cap)] = torch.arange(
                  s, device=x.device)[None, :, None].expand_as(top_idx)
    hr, hs = cut.inputs(h)
    h_pad = torch.cat([hr, hr.new_zeros((b, 1, d))], dim=1)
    xe = h_pad[rows, idx_token[..., :cap]]                  # (G, E, C, D)
    ye = _experts(p, xe, cfg).reshape(b, (hi - lo) * cap, d)
    yk = ye[rows, local * cap + torch.where(keep, pos, 0)]  # (G,T,K,D)
    w = (cut.weights(top_p) * keep).to(h.dtype)
    y = torch.einsum("gtk,gtkd->gtd", w, yk)
    return x + cut.output(p, hs, y, cfg).to(x.dtype), aux


def moe_apply(p, x: torch.Tensor, cfg, ctx=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch ``cfg.moe_impl`` names: ``"gather"``, else the
    one-hot einsum dispatch, as the reference reads the switch. ``ctx``
    (``sharding.ShardCtx``): the layer's compute copy is this rank's
    cut (``_Cut``)."""
    if getattr(cfg, "moe_impl", "gather") == "gather":
        return moe_apply_gather(p, x, cfg, ctx)
    return moe_apply_einsum(p, x, cfg, ctx)


def moe_apply_dense_oracle(p, x: torch.Tensor, cfg
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token, weighted by the renormalized top-k
    router probabilities: no capacity, no dropping (the router product
    in fp32). For tests only."""
    m = cfg.moe
    h = rms_norm(x, p.ln, cfg.norm_eps)
    probs = torch.softmax(torch.einsum("gtd,de->gte", h.float(), p.router),
                          dim=-1)
    top_p, top_idx = _top_k(probs, m.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    weights = torch.zeros_like(probs).scatter(-1, top_idx, top_p)
    act = act_fn(cfg.act)
    hidden = act(torch.einsum("gtd,edf->gtef", h, p.w_gate)) \
        * torch.einsum("gtd,edf->gtef", h, p.w_up)
    ye = torch.einsum("gtef,efd->gted", hidden, p.w_down)
    y = torch.einsum("gte,gted->gtd", weights.to(h.dtype), ye)
    frac_tokens = F.one_hot(top_idx, m.n_experts).float().sum(2).mean(1)
    aux = m.n_experts * (frac_tokens * probs.mean(1)).sum(-1).mean()
    return x + _Cut(p, cfg, None).output(p, h, y, cfg).to(x.dtype), aux


__all__ = ["MoE", "moe_init", "route", "route_indices", "moe_apply",
           "moe_apply_einsum", "moe_apply_gather", "moe_apply_dense_oracle"]
