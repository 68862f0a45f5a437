"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin,
arXiv:2402.19427): the counterpart of ``repro.models.rglru`` for the
full-sequence (train) path.

    x -> RMSNorm -> { gate branch: W_gate -> GeLU            } -> * -> W_out -> +x
                    { rec branch:  W_rec -> causal conv(4)
                                   -> RG-LRU                 }

with, per channel, r_t = sigmoid(W_a h_t + b_a), i_t = sigmoid(W_x h_t +
b_x), a_t = exp(-c softplus(Lambda) r_t) (c = 8) and

    y_t = a_t y_{t-1} + sqrt(1 - a_t^2) (i_t h_t).

The recurrence runs through ``kernels.rglru_scan``: on the card the
hand-written scan kernel, forward and reverse; on the CPU its plain
versions. The leaves keep the reference's names and shapes.

Serving keeps a decode state per sequence: the recurrence's last output
``h`` (B, D), fp32 whatever the compute dtype, and the conv's tail, the
last ``W - 1`` inputs of the rec branch (B, W - 1, D) in the model's
dtype. ``rglru_prefill_cache`` runs the prompt through the scan kernel
and returns that state; ``rglru_decode`` advances it by one token in
place. A prompt shorter than ``W - 1`` leaves a tail padded with leading
zeros, the zero history ``_causal_conv`` assumes before a sequence (the
reference keeps only the rows it has there, and its decode then fails
on such a prompt).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models.layers import dense_init, rms_norm

_C = 8.0


class RGLRUBlock(nn.Module):
    """``rglru`` block params: ln (d,), w_in (d, 2d) as [gate | rec],
    conv_w (W, d) depthwise, conv_b (d,), w_gates (d, 2d) as [r | i],
    b_gates (2d,), lam (d,) (kept fp32), w_out (d, d)."""

    def __init__(self, cfg, dtype, device, param):
        super().__init__()
        d, w = cfg.d_model, cfg.rglru_conv_width
        self.ln = param((d,), dtype, device)
        self.w_in = param((d, 2 * d), dtype, device)
        self.conv_w = param((w, d), dtype, device)
        self.conv_b = param((d,), dtype, device)
        self.w_gates = param((d, 2 * d), dtype, device)
        self.b_gates = param((2 * d,), dtype, device)
        self.lam = param((d,), torch.float32, device)
        self.w_out = param((d, d), dtype, device)


@torch.no_grad()
def rglru_init(block: RGLRUBlock, cfg, gen: torch.Generator) -> None:
    """The reference ``rglru_init``'s shapes and scales: dense leaves
    N(0, 1) / sqrt(in_dim), norms and biases zero, and Lambda the
    inverse softplus of -log(u) / c for u ~ U(0.001, 0.1), so that a
    starts between 0.9 and 0.999."""
    d, w = cfg.d_model, cfg.rglru_conv_width
    dev, dt = block.w_in.device, block.w_in.dtype
    block.w_in.copy_(dense_init(gen, d, (2 * d,), dt, dev))
    block.conv_w.copy_(dense_init(gen, w, (d,), dt, dev))
    block.w_gates.copy_(dense_init(gen, d, (2 * d,), dt, dev))
    block.w_out.copy_(dense_init(gen, d, (d,), dt, dev))
    u = torch.rand((d,), generator=gen, device=dev) * (0.1 - 0.001) + 0.001
    block.lam.copy_(torch.log(torch.exp(-torch.log(u) / _C) - 1.0))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold (torch's
    ``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, D); w: (W, D); ``tail`` (B, W-1,
    D) the inputs before the sequence (streaming decode), zeros when
    absent. Summed over the taps i = 0 .. W-1 in the reference's
    order."""
    width, s = w.shape[0], x.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i:i + s] * w[i] for i in range(width))
    return out + b


def _gates(p, xc: torch.Tensor, xg: Optional[torch.Tensor] = None):
    """(a, b) of the recurrence, fp32: a = exp(log_a) and b = beta * (i *
    xc) with beta = sqrt(max(1 - exp(2 log_a), 1e-12)). ``xg``: the
    gates' input where it is not ``xc`` (every channel of it, when
    ``xc`` holds a rank's channels)."""
    gates = (xc if xg is None else xg) @ p.w_gates + p.b_gates
    r, i = torch.sigmoid(gates.float()).chunk(2, dim=-1)
    log_a = -_C * _softplus(p.lam) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * xc.float())


def _local_channels(p, ctx):
    """Under a ``ctx`` whose "model" axis cuts the channels: ``p`` with
    this rank's share of the leaves every rank holds whole (``conv_b``,
    and ``b_gates`` as its r and i halves), through ``ctx.tp_slice``.
    The cut leaves hold the rank's channels already (``w_in`` and
    ``w_gates`` by halves, see ``sharding.rules``)."""
    n = p.w_out.shape[0]
    lo = ctx.tp_index * n
    d = n * ctx.tp
    out = SimpleNamespace(**vars(p))
    for name in ("conv_b", "lam"):
        if not ctx.split(p, name):
            setattr(out, name, ctx.tp_slice(getattr(p, name), 0, lo,
                                            lo + n))
    bg = ctx.tp_in(p.b_gates)
    out.b_gates = torch.cat([bg[lo:lo + n], bg[d + lo:d + lo + n]])
    return out


def _block(p, x: torch.Tensor, cfg, ctx=None):
    """The full-sequence block: (x + its output, the rec branch's inputs
    to the conv, the recurrence's outputs y in fp32). Under a ``ctx``
    whose "model" axis cuts the channels, the rank's channels only: the
    scan sees (B, S, D / model), the conv's output is gathered for the
    gates' product, and w_out's partial output is summed over
    "model"."""
    split = ctx is not None and ctx.split(p, "w_out")
    if split and not (ctx.split(p, "w_in") and ctx.split(p, "w_gates")):
        raise ValueError("rglru: w_out's channels are cut over 'model' but "
                         "w_in's or w_gates' are not")
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if split:
        p = _local_channels(p, ctx)
        h = ctx.tp_in(h)
    gate, rec = (h @ p.w_in).chunk(2, dim=-1)
    gate = F.gelu(gate, approximate="tanh")
    xc = _causal_conv(rec, p.conv_w, p.conv_b)
    if split:
        from repro_torch.sharding import comm
        a, b = _gates(p, xc, comm.all_gather(xc, ctx.mesh, "model", -1))
    else:
        a, b = _gates(p, xc)
    y = rglru_scan(a, b, torch.zeros_like(a[:, 0]))
    out = (y.to(x.dtype) * gate) @ p.w_out
    return x + (ctx.tp_out(out) if split else out), rec, y


def rglru_apply(p, x: torch.Tensor, cfg, ctx=None) -> torch.Tensor:
    """Full-sequence recurrent block with residual. x: (B, S, D)."""
    return _block(p, x, cfg, ctx)[0]


def _split(p, ctx) -> bool:
    """Whether the layer runs on this rank's channels (``_block``)."""
    return ctx is not None and ctx.split(p, "w_out")


def rglru_prefill_cache(p, x: torch.Tensor, cfg, ctx=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``rglru_apply`` that also returns the decode state: {"h": the
    last output (B, D) fp32, "conv": the rec branch's last W - 1 inputs
    (B, W - 1, D) in x's dtype, leading zeros where the prompt is
    shorter}. Under a ``ctx`` (a sharded serving step) the block runs on
    the rank's channels and each leaf is placed as ``cache_spec`` says:
    ``conv`` cut over "model" as the channels are, ``h`` whole over
    "model" where the batch is cut over the batch axes (the channels
    gathered through ``comm``), else cut too."""
    out, rec, y = _block(p, x, cfg, ctx)
    keep = cfg.rglru_conv_width - 1
    tail = rec[:, -keep:]
    if tail.shape[1] < keep:
        tail = torch.cat([tail.new_zeros((tail.shape[0], keep - tail.shape[1],
                                          tail.shape[2])), tail], dim=1)
    state = {"h": y[:, -1].contiguous(),
             "conv": tail.to(x.dtype).contiguous()}
    if ctx is not None:
        from repro_torch.sharding.rules import held
        b, d = x.shape[0], cfg.d_model
        for name, shape in (("h", (b, d)), ("conv", (b, keep, d))):
            spec = ctx.cache_spec(name, shape)
            state[name] = held(ctx.to_held(state[name], spec,
                                           _split(p, ctx)).contiguous(), spec)
    return out, state


def rglru_decode(p, x: torch.Tensor, cfg, *,
                 cache: Dict[str, torch.Tensor], ctx=None) -> torch.Tensor:
    """One-token decode, the O(1) state update. x: (B, 1, D); ``cache``
    {"h", "conv"} is advanced IN PLACE (h <- y, the tail shifted by the
    new input). Returns the residual output. Under a ``ctx`` the step
    runs on the rank's channels as ``_block`` does (the gates read every
    channel of the conv output, gathered over "model"), reading and
    writing the state leaves in their placement (``ShardCtx.channels``,
    ``ShardCtx.to_held``)."""
    split = _split(p, ctx)
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if split:
        p = _local_channels(p, ctx)
        h = ctx.tp_in(h)
    state, conv = cache["h"], cache["conv"]
    if ctx is not None:
        state, conv = ctx.channels(state, split), ctx.channels(conv, split)
    gate, rec = (h @ p.w_in).chunk(2, dim=-1)
    gate = F.gelu(gate, approximate="tanh")
    xc = _causal_conv(rec, p.conv_w, p.conv_b, tail=conv)
    if split:
        from repro_torch.sharding import comm
        a, b = _gates(p, xc, comm.all_gather(xc, ctx.mesh, "model", -1))
    else:
        a, b = _gates(p, xc)
    y = a[:, 0] * state + b[:, 0]
    out = (y[:, None].to(x.dtype) * gate) @ p.w_out
    tail = torch.cat([conv, rec.to(conv.dtype)], dim=1)[:, 1:]
    if ctx is not None:
        tail = ctx.to_held(tail, cache["conv"].shard_spec, split)
        y = ctx.to_held(y, cache["h"].shard_spec, split)
    cache["conv"].copy_(tail)
    cache["h"].copy_(y)
    return x + (ctx.tp_out(out) if split else out)


__all__ = ["RGLRUBlock", "rglru_init", "rglru_apply", "rglru_prefill_cache",
           "rglru_decode"]
