"""xLSTM blocks of the port (arXiv:2405.04517): mLSTM (matrix memory)
and sLSTM (scalar memory with exponential gating), the counterpart of
``repro.models.ssm``.

mLSTM, per head, with state C (dh, dh), n (dh) and the stabilizer m::

    m_t = max(log f_t + m_{t-1}, log i_t)
    C_t = exp(log f_t + m_{t-1} - m_t) C_{t-1} + exp(log i_t - m_t) v_t k_t^T
    n_t = exp(log f_t + m_{t-1} - m_t) n_{t-1} + exp(log i_t - m_t) k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

A prompt runs chunkwise (``mlstm_chunkwise``): a masked quadratic decay
attention inside each chunk of ``min(attn_chunk, 256)`` positions and
the (C, n, m) state carried across chunks, in fp32, by a Python loop
where the reference scans. A decode step (``mlstm_decode``) applies the
recurrence once. sLSTM is a true recurrence (h_{t-1} feeds the gates
through block-diagonal R) and runs as a Python loop over time
(``slstm_scan``), one cell a position; each position is a handful of
small kernels, so a prompt's sLSTM layers cost the host S x that many
launches.

None of this is a Pallas kernel in the reference (its recurrences are
``lax`` code), so the plain PyTorch here is the port. The fp32 casts and
the order of operations are the reference's: q is scaled before the
chunk products and divided after the decode product, as there.

Serving keeps, per sequence, mLSTM's {C (H, dh, dh), n (H, dh), m (H,)}
in fp32 and its conv tail, the last 3 inputs of the conv (its width is
a fixed 4), in the compute dtype; sLSTM's {c, n, m, h} (H, dh) in fp32.
A prompt shorter than 3 tokens leaves a conv tail padded with leading
zeros, the zero history the conv assumes before a sequence (the
reference keeps only the rows it has, and its decode then fails on such
a prompt). Decode updates the state in place.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.rglru import _causal_conv, _softplus

CONV_WIDTH = 4          # mLSTM's conv width (fixed in the reference)
_NEG = -1e30            # the stabilizer's start and the padding's log_i


def _mlstm_dims(cfg) -> Tuple[int, int, int]:
    """(dm, heads, head dim) of an mLSTM block."""
    dm = int(cfg.mlstm_proj_factor * cfg.d_model)
    return dm, cfg.n_heads, dm // cfg.n_heads


def _slstm_dims(cfg) -> Tuple[int, int, int]:
    """(heads, head dim, up-projection width) of an sLSTM block."""
    d, nh = cfg.d_model, cfg.n_heads
    return nh, d // nh, int(cfg.slstm_proj_factor * d)


class MLSTMBlock(nn.Module):
    """``mlstm`` block params: ln (d,), w_up (d, 2 dm) as [x | z-gate],
    conv_w (4, dm), conv_b (dm,), wq / wk / wv (dm, H, dh), w_if (dm,
    2H) and b_if (2H,) kept fp32, gn (H, dh), w_down (dm, d)."""

    def __init__(self, cfg, dtype, device, param):
        super().__init__()
        d = cfg.d_model
        dm, nh, dh = _mlstm_dims(cfg)
        self.ln = param((d,), dtype, device)
        self.w_up = param((d, 2 * dm), dtype, device)
        self.conv_w = param((CONV_WIDTH, dm), dtype, device)
        self.conv_b = param((dm,), dtype, device)
        self.wq = param((dm, nh, dh), dtype, device)
        self.wk = param((dm, nh, dh), dtype, device)
        self.wv = param((dm, nh, dh), dtype, device)
        self.w_if = param((dm, 2 * nh), torch.float32, device)
        self.b_if = param((2 * nh,), torch.float32, device)
        self.gn = param((nh, dh), dtype, device)
        self.w_down = param((dm, d), dtype, device)


class SLSTMBlock(nn.Module):
    """``slstm`` block params: ln (d,), w (d, 4, H, dh) for the z, i, f,
    o gates, r (4, H, dh, dh), b (4, H, dh) kept fp32, gn (H, dh), w_up
    (d, 2 ds), w_down (ds, d)."""

    def __init__(self, cfg, dtype, device, param):
        super().__init__()
        d = cfg.d_model
        nh, dh, ds = _slstm_dims(cfg)
        self.ln = param((d,), dtype, device)
        self.w = param((d, 4, nh, dh), dtype, device)
        self.r = param((4, nh, dh, dh), dtype, device)
        self.b = param((4, nh, dh), torch.float32, device)
        self.gn = param((nh, dh), dtype, device)
        self.w_up = param((d, 2 * ds), dtype, device)
        self.w_down = param((ds, d), dtype, device)


@torch.no_grad()
def mlstm_init(p: MLSTMBlock, cfg, gen: torch.Generator) -> None:
    """The reference ``mlstm_init``'s scales: dense leaves N(0, 1) /
    sqrt(in_dim), norms and the conv bias zero, b_if [0] * H then [3] *
    H (a positive forget bias: long memory at init)."""
    d = cfg.d_model
    dm, nh, dh = _mlstm_dims(cfg)
    dev, dt = p.w_up.device, p.w_up.dtype
    p.w_up.copy_(dense_init(gen, d, (2 * dm,), dt, dev))
    p.conv_w.copy_(dense_init(gen, CONV_WIDTH, (dm,), dt, dev))
    for w in (p.wq, p.wk, p.wv):
        w.copy_(dense_init(gen, dm, (nh, dh), dt, dev))
    p.w_if.copy_(dense_init(gen, dm, (2 * nh,), torch.float32, dev))
    p.b_if[nh:] = 3.0
    p.w_down.copy_(dense_init(gen, dm, (d,), dt, dev))


@torch.no_grad()
def slstm_init(p: SLSTMBlock, cfg, gen: torch.Generator) -> None:
    """The reference ``slstm_init``'s scales: w, w_up and w_down N(0, 1)
    / sqrt(in_dim), r N(0, 1) / sqrt(dh), the forget gate's bias 3."""
    d = cfg.d_model
    nh, dh, ds = _slstm_dims(cfg)
    dev, dt = p.w.device, p.w.dtype
    p.w.copy_(dense_init(gen, d, (4, nh, dh), dt, dev))
    p.r.copy_(torch.randn((4, nh, dh, dh), generator=gen, device=dev)
              / math.sqrt(dh))
    p.b[2] = 3.0
    p.w_up.copy_(dense_init(gen, d, (2 * ds,), dt, dev))
    p.w_down.copy_(dense_init(gen, ds, (d,), dt, dev))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _gates(p, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log i, log f) of the conv's output, fp32: log f = log sigmoid."""
    log_i, f_raw = (xc.float() @ p.w_if + p.b_if).chunk(2, dim=-1)
    return log_i, -_softplus(-f_raw)


def _mlstm_prep(p, ctx):
    """(the block's leaves as this rank computes with them, whether on
    its heads). On its heads (where "model" cuts the heads' leaves, and
    ``w_up`` by halves: its x and z channels of those heads) ``conv_b``
    and ``gn`` are sliced to them (``ctx.tp_slice``), the gates' ``w_if``
    and ``b_if`` to their i and f columns (whole on every rank, their
    gradient summed over "model"). Where "model" does not divide the
    heads, every leaf it cuts is gathered (``ctx.whole``): the block
    runs whole on each rank."""
    if ctx is None:
        return p, False
    if not (all(ctx.split(p, n) for n in ("wq", "wk", "wv", "w_up",
                                          "conv_w", "w_down"))
            and "w_up" in getattr(p, "_halves", ())):
        return ctx.whole(p), False
    nh = p.gn.shape[0]
    lo, hi = ctx.heads(nh)
    n = p.w_down.shape[0]
    c0 = ctx.tp_index * n
    out = SimpleNamespace(**vars(p))
    out.conv_b = ctx.tp_slice(p.conv_b, 0, c0, c0 + n)
    out.gn = ctx.tp_slice(p.gn, 0, lo, hi)
    sel = torch.cat([torch.arange(lo, hi), torch.arange(nh + lo, nh + hi)]
                    ).to(p.w_if.device)
    out.w_if = ctx.tp_in(p.w_if).index_select(1, sel)
    out.b_if = ctx.tp_in(p.b_if).index_select(0, sel)
    return out, True


def _every_channel(ctx, xc: torch.Tensor, xm: torch.Tensor):
    """The conv's output and input over every channel, from this rank's:
    one all-gather over "model" (its backward sums the heads' partial
    gradients)."""
    from repro_torch.sharding import comm
    n = xc.shape[-1]
    g = comm.all_gather(torch.cat([xc, xm], dim=-1), ctx.mesh, "model", -1)
    g = g.reshape(*g.shape[:-1], ctx.tp, 2, n)
    return (g[..., 0, :].reshape(*g.shape[:-3], -1),
            g[..., 1, :].reshape(*g.shape[:-3], -1))


def _mlstm_qkvg(p, x: torch.Tensor, cfg, ctx=None, split: bool = False,
                tail: Optional[torch.Tensor] = None):
    """The block's projections: (q, k, v (B,S,H,dh), z (B,S,dm), log_i,
    log_f (B,S,H) fp32, xm (B,S,dm) the conv's input). On a rank's heads
    (``split``) xm, xc and z are its channels, and q, k, v and the gates
    its heads' of every channel of xc and xm (``_every_channel``)."""
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if split:
        h = ctx.tp_in(h)
    xm, z = (h @ p.w_up).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xm, p.conv_w, p.conv_b, tail=tail))
    xg, mg = _every_channel(ctx, xc, xm) if split else (xc, xm)
    log_i, log_f = _gates(p, xg)
    return (_heads(xg, p.wq), _heads(xg, p.wk), _heads(mg, p.wv), z,
            log_i, log_f, xm)


def _pad_time(x: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    if not n:
        return x
    return torch.cat([x, x.new_full((x.shape[0], n) + x.shape[2:], value)],
                     dim=1)


def _mlstm_chunk_out(qh, kh, vh, li, fc, C, n, m, mask):
    """One chunk's output (B, L, H, dh) of ``mlstm_chunkwise`` from the
    carried (C, n, m); ``fc`` the chunk's inclusive cumsum of log f."""
    intra_max = (li - fc).amax(dim=1, keepdim=True)
    m_pos = torch.maximum(m[:, None] + fc, fc + intra_max)   # (B,L,H)
    # D[i, j] = exp(li_j + F_i - F_j - m_i) for j <= i
    dmat = li[:, None] + fc[:, :, None] - fc[:, None] - m_pos[:, :, None]
    w = torch.exp(torch.where(mask, dmat, torch.full_like(dmat, _NEG)))
    scores = torch.einsum("bihd,bjhd->bijh", qh, kh) * w
    num = torch.einsum("bijh,bjhd->bihd", scores, vh)
    den = scores.sum(dim=2)                               # (B,L,H)
    inter_w = torch.exp(m[:, None] + fc - m_pos)          # (B,L,H)
    num = num + torch.einsum("bihd,bhde->bihe", qh, C) * inter_w[..., None]
    den = den + torch.einsum("bihd,bhd->bih", qh, n) * inter_w
    return num / torch.maximum(den.abs(), torch.exp(-m_pos))[..., None]


def _mlstm_chunk_state(kh, vh, li, fc, C, n, m):
    """The (C, n, m) a chunk hands on, from the ones it was handed."""
    ftot = fc[:, -1]                                      # (B,H)
    m_new = torch.maximum(m + ftot, (li + ftot[:, None] - fc).amax(dim=1))
    kw = torch.exp(li + ftot[:, None] - fc - m_new[:, None])
    decay = torch.exp(m + ftot - m_new)
    C = decay[..., None, None] * C + torch.einsum(
        "bjhd,bjhe->bhde", kh * kw[..., None], vh)
    n = decay[..., None] * n + torch.einsum("bjhd,bjh->bhd", kh, kw)
    return C, n, m_new


def _mlstm_meta(q, k, v, log_i, log_f, state, mask, size):
    """``mlstm_chunkwise``'s loop on the meta device, where no value
    flows from one chunk to the next: the state updates of all chunks
    but the last run as one batch from the handed-in state, and the
    outputs of all chunks but the first as one batch from the states
    those updates hand on; the first chunk's output and the last chunk's
    update run alone, as in the loop. The loop's operations, forward and
    backward, in a few chunks' ops."""
    b, s, nh, dh = q.shape
    nc = s // size
    fc = torch.cumsum(log_f.reshape(b, nc, size, nh), dim=2) \
        .reshape(b, s, nh)

    def chunks(t, lo, hi):
        return t[:, lo * size:hi * size].reshape(b * (hi - lo), size,
                                                 *t.shape[2:])

    def each(t, n):
        return t[:, None].expand(b, n, *t.shape[1:]) \
            .reshape(b * n, *t.shape[1:])
    ins = (q, k, v, log_i, fc)
    outs = [_mlstm_chunk_out(*(chunks(t, 0, 1) for t in ins), *state, mask)]
    if nc > 1:
        handed = _mlstm_chunk_state(*(chunks(t, 0, nc - 1) for t in ins[1:]),
                                    *(each(t, nc - 1) for t in state))
        outs.append(_mlstm_chunk_out(*(chunks(t, 1, nc) for t in ins),
                                     *handed, mask))
    last = _mlstm_chunk_state(*(chunks(t, nc - 1, nc) for t in ins[1:]),
                              *state)
    out = torch.cat([o.reshape(b, -1, nh, dh) for o in outs], dim=1)
    return out, last


def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, *, chunk: int = 256):
    """q, k, v: (B, S, H, dh); log_i, log_f: (B, S, H) fp32; ``state``
    (C, n, m) or None for the zero state. Returns (out (B, S, H, dh)
    fp32, (C, n, m)). The tail is padded to a whole chunk with log_i =
    -1e30 and log_f = 0 (no input, no decay), as in the reference. On
    the meta device the chunks run as one batch (``_mlstm_meta``: the
    dry run's count of a 32,768-position prompt)."""
    b, s, nh, dh = q.shape
    q = q.float() * (1.0 / math.sqrt(dh))
    k, v = k.float(), v.float()
    size = min(chunk, s)
    pad = -s % size
    q, k, v, log_f = (_pad_time(t, pad) for t in (q, k, v, log_f))
    log_i = _pad_time(log_i, pad, _NEG)
    if state is None:
        C = q.new_zeros((b, nh, dh, dh))
        n = q.new_zeros((b, nh, dh))
        m = q.new_full((b, nh), _NEG)
    else:
        C, n, m = state
    mask = torch.tril(torch.ones((size, size), dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    if q.device.type == "meta":
        out, state = _mlstm_meta(q, k, v, log_i, log_f, (C, n, m), mask,
                                 size)
        return out[:, :s], state
    outs = []
    for c0 in range(0, s + pad, size):
        qh, kh, vh = q[:, c0:c0 + size], k[:, c0:c0 + size], v[:, c0:c0 + size]
        li = log_i[:, c0:c0 + size]
        fc = torch.cumsum(log_f[:, c0:c0 + size], dim=1)   # inclusive decay
        outs.append(_mlstm_chunk_out(qh, kh, vh, li, fc, C, n, m, mask))
        C, n, m = _mlstm_chunk_state(kh, vh, li, fc, C, n, m)
    return torch.cat(outs, dim=1)[:, :s], (C, n, m)


def _mlstm_out(p, out: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
               cfg, ctx=None, split: bool = False) -> torch.Tensor:
    """The heads' output normed per head, gated by silu(z), projected
    down, plus the residual; on a rank's heads, its rows of ``w_down``
    and the partial outputs summed over "model"."""
    out = rms_norm(out.to(x.dtype), p.gn, cfg.norm_eps)
    out = (out.reshape(*out.shape[:-2], -1) * F.silu(z)) @ p.w_down
    return x + (ctx.tp_out(out) if split else out)


def _mlstm_prompt(p, x: torch.Tensor, cfg, ctx=None):
    p, split = _mlstm_prep(p, ctx)
    q, k, v, z, log_i, log_f, xm = _mlstm_qkvg(p, x, cfg, ctx, split)
    out, state = mlstm_chunkwise(q, k, v, log_i, log_f, None,
                                 chunk=min(cfg.attn_chunk, 256))
    return _mlstm_out(p, out, z, x, cfg, ctx, split), state, xm, split


def mlstm_apply(p, x: torch.Tensor, cfg, ctx=None) -> torch.Tensor:
    """Full-sequence mLSTM block with residual. x: (B, S, D). Under a
    ``ctx`` whose "model" axis cuts the heads, the rank's heads only
    (``_mlstm_prep``): one all-gather of its channels of the conv's
    input and output, one sum over "model" after ``w_down``."""
    return _mlstm_prompt(p, x, cfg, ctx)[0]


def _tail(xm: torch.Tensor, keep: int) -> torch.Tensor:
    """The last ``keep`` rows of xm, leading zeros where it is shorter."""
    tail = xm[:, -keep:]
    if tail.shape[1] < keep:
        tail = torch.cat([tail.new_zeros((tail.shape[0], keep - tail.shape[1],
                                          tail.shape[2])), tail], dim=1)
    return tail.contiguous()


# the heads (or, for the conv tail, channels) dim of each state leaf
_STATE_DIM = {"C": 1, "n": 1, "m": 1, "conv": -1, "c": 1, "h": 1}


def _place(state: Dict[str, torch.Tensor], kind: str, cfg, ctx,
           split: bool) -> Dict[str, torch.Tensor]:
    """A prefill's state leaves over the layer's heads (this rank's, or
    all) as ``cache_spec`` places them, each marked with its spec."""
    from repro_torch.sharding.rules import held
    b = next(iter(state.values())).shape[0]
    out = {}
    for name, (shape, _, _) in state_shapes(kind, cfg, b).items():
        spec = ctx.cache_spec(name, shape)
        out[name] = held(ctx.to_held(state[name], spec, split,
                                     _STATE_DIM[name]).contiguous(), spec)
    return out


def mlstm_prefill_cache(p, x: torch.Tensor, cfg, ctx=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``mlstm_apply`` that also returns the decode state {"C", "n", "m"
    (fp32), "conv" (B, 3, dm) in x's dtype}; under a ``ctx`` each leaf
    placed as ``cache_spec`` says (``C`` by heads over "model", ``conv``
    by channel, where they divide)."""
    out, (C, n, m), xm, split = _mlstm_prompt(p, x, cfg, ctx)
    state = {"C": C, "n": n, "m": m,
             "conv": _tail(xm, CONV_WIDTH - 1).to(x.dtype)}
    if ctx is not None:
        state = _place(state, "mlstm", cfg, ctx, split)
    return out, state


def _read(cache, names, ctx, split):
    """The state leaves ``names`` over the layer's heads."""
    if ctx is None:
        return [cache[k] for k in names]
    return [ctx.channels(cache[k], split, _STATE_DIM[k]) for k in names]


def _write(cache, new, ctx, split) -> None:
    """Advance the state leaves IN PLACE from ``new`` {name: value over
    the layer's heads}, each in its placement."""
    for k, v in new.items():
        if ctx is not None:
            v = ctx.to_held(v, cache[k].shard_spec, split, _STATE_DIM[k])
        cache[k].copy_(v)


def mlstm_decode(p, x: torch.Tensor, cfg, *,
                 cache: Dict[str, torch.Tensor], ctx=None) -> torch.Tensor:
    """One-token decode, the O(1) matrix-memory update. x: (B, 1, D);
    ``cache`` {"C", "n", "m", "conv"} is advanced IN PLACE. Returns the
    residual output. Under a ``ctx`` the step runs as ``mlstm_apply``
    does, reading and writing each state leaf in its placement."""
    p, split = _mlstm_prep(p, ctx)
    C, n, m, conv = _read(cache, ("C", "n", "m", "conv"), ctx, split)
    q, k, v, z, log_i, log_f, xm = _mlstm_qkvg(p, x, cfg, ctx, split,
                                                tail=conv)
    dh = q.shape[-1]
    q = q[:, 0].float() / math.sqrt(dh)
    k, v = k[:, 0].float(), v[:, 0].float()
    log_i, log_f = log_i[:, 0], log_f[:, 0]
    m_new = torch.maximum(log_f + m, log_i)
    decay = torch.exp(log_f + m - m_new)
    inw = torch.exp(log_i - m_new)
    C_new = decay[..., None, None] * C + inw[..., None, None] \
        * torch.einsum("bhd,bhe->bhde", k, v)
    n_new = decay[..., None] * n + inw[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n_new).abs(),
                        torch.exp(-m_new))
    out = _mlstm_out(p, (num / den[..., None])[:, None], z, x, cfg, ctx,
                     split)
    tail = torch.cat([conv, xm.to(conv.dtype)], dim=1)[:, 1:]
    _write(cache, {"conv": tail, "C": C_new, "n": n_new, "m": m_new}, ctx,
           split)
    return out


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_cell(p, wx_t: torch.Tensor, state):
    """One sLSTM step in fp32. wx_t: (B, 4, H, dh) the input's share of
    the gates; state (c, n, m, h), each (B, H, dh)."""
    c, n, m, h = state
    rec = torch.einsum("bhd,ghde->bghe", h.float(), p.r.float())
    raw = wx_t.float() + rec + p.b
    z = torch.tanh(raw[:, 0])
    log_i = raw[:, 1]
    log_f = -_softplus(-raw[:, 2])
    o = torch.sigmoid(raw[:, 3])
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = torch.clamp(f_s * n + i_s, min=1e-6)
    return c_new, n_new, m_new, o * c_new / n_new


def slstm_scan(p, wx: torch.Tensor, state):
    """wx: (B, S, 4, H, dh). One ``_slstm_cell`` a position, in order.
    Returns (hs (B, S, H, dh) fp32, the last state). On the meta device,
    where no value flows from one position to the next, the cell runs
    at position 0 and then once over the B x (S - 1) rows of the other
    positions, from position 0's state: the loop's operations, forward
    and backward, in two cells' ops instead of S (the dry run's count
    of a 32,768-position prompt)."""
    if wx.device.type == "meta":
        b, s = wx.shape[:2]
        first = _slstm_cell(p, wx[:, 0], state)
        if s == 1:
            return first[3][:, None], first
        rows = tuple(t[:, None].expand(b, s - 1, *t.shape[1:])
                     .reshape(b * (s - 1), *t.shape[1:]) for t in first)
        rest = _slstm_cell(p, wx[:, 1:].reshape(b * (s - 1), *wx.shape[2:]),
                           rows)
        rest = tuple(t.reshape(b, s - 1, *t.shape[1:]) for t in rest)
        return torch.cat([first[3][:, None], rest[3]], dim=1), \
            tuple(t[:, -1] for t in rest)
    hs = []
    for t in range(wx.shape[1]):
        state = _slstm_cell(p, wx[:, t], state)
        hs.append(state[3])
    return torch.stack(hs, dim=1), state


def _slstm_zero_state(b: int, nh: int, dh: int, device):
    z = torch.zeros((b, nh, dh), device=device)
    return z, torch.ones_like(z), torch.full_like(z, _NEG), z


def _slstm_prep(p, ctx):
    """(the block's leaves as this rank computes with them, whether on
    its heads, whether its GeGLU on its ff columns). On its heads (the
    block-diagonal ``r`` and ``w`` cut by heads over "model") ``b`` and
    ``gn`` are sliced to them (``ctx.tp_slice``), so the time loop runs
    on the rank's heads with no collective inside. On its ff columns
    ``w_up`` is cut by halves and ``w_down`` by rows. Any other leaf
    "model" cuts is gathered (``ctx.whole``)."""
    if ctx is None:
        return p, False, False
    heads = ctx.split(p, "w") and ctx.split(p, "r")
    ff = ctx.split(p, "w_up") and ctx.split(p, "w_down") \
        and "w_up" in getattr(p, "_halves", ())
    p = ctx.whole(p, ([] if heads else ["w", "r"])
                  + ([] if ff else ["w_up", "w_down"]))
    if heads:
        lo, hi = ctx.heads(p.gn.shape[0])
        p = SimpleNamespace(**vars(p))
        p.b = ctx.tp_slice(p.b, 1, lo, hi)
        p.gn = ctx.tp_slice(p.gn, 0, lo, hi)
    return p, heads, ff


def _slstm_wx(p, x: torch.Tensor, cfg, ctx=None, heads: bool = False
              ) -> torch.Tensor:
    """einsum("bsd,dghe->bsghe") of the normed input: (B, S, 4, H, dh),
    the rank's heads where ``heads``."""
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if heads:
        h = ctx.tp_in(h)
    d = p.w.shape[0]
    return (h @ p.w.reshape(d, -1)).reshape(*h.shape[:-1], *p.w.shape[1:])


def _slstm_out(p, hs: torch.Tensor, x: torch.Tensor, cfg, ctx=None,
               heads: bool = False, ff: bool = False) -> torch.Tensor:
    """hs normed per head, the GeGLU up/down projection (the tanh GELU
    of ``jax.nn.gelu``), plus the residual. From a rank's heads, hs is
    gathered over "model" once; on its ff columns, its halves of
    ``w_up`` and rows of ``w_down``, the partial outputs summed."""
    from repro_torch.sharding import comm
    hs = rms_norm(hs.to(x.dtype), p.gn, cfg.norm_eps)
    hs = hs.reshape(*hs.shape[:-2], -1)
    if heads:
        # the ff product's gradient of hs is partial on its columns,
        # and whole where every rank runs the product whole
        gather = comm.all_gather if ff else comm.all_gather_replicated
        hs = gather(hs, ctx.mesh, "model", -1)
    elif ff:
        hs = ctx.tp_in(hs)
    a, g = (hs @ p.w_up).chunk(2, dim=-1)
    out = (F.gelu(a, approximate="tanh") * g) @ p.w_down
    return x + (ctx.tp_out(out) if ff else out)


def _slstm_prompt(p, x: torch.Tensor, cfg, ctx=None):
    p, heads, ff = _slstm_prep(p, ctx)
    nh, dh = p.gn.shape
    hs, state = slstm_scan(p, _slstm_wx(p, x, cfg, ctx, heads),
                           _slstm_zero_state(x.shape[0], nh, dh, x.device))
    return _slstm_out(p, hs, x, cfg, ctx, heads, ff), state, heads


def slstm_apply(p, x: torch.Tensor, cfg, ctx=None) -> torch.Tensor:
    """Full-sequence sLSTM block with residual. x: (B, S, D). Under a
    ``ctx`` the rank's heads and ff columns where "model" cuts them
    (``_slstm_prep``)."""
    return _slstm_prompt(p, x, cfg, ctx)[0]


def slstm_prefill_cache(p, x: torch.Tensor, cfg, ctx=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``slstm_apply`` that also returns the decode state {"c", "n",
    "m", "h"} (B, H, dh) fp32; under a ``ctx`` each placed as
    ``cache_spec`` says."""
    out, (c, n, m, h), heads = _slstm_prompt(p, x, cfg, ctx)
    state = {"c": c, "n": n, "m": m, "h": h}
    if ctx is not None:
        state = _place(state, "slstm", cfg, ctx, heads)
    return out, state


def slstm_decode(p, x: torch.Tensor, cfg, *,
                 cache: Dict[str, torch.Tensor], ctx=None) -> torch.Tensor:
    """One-token decode. x: (B, 1, D); ``cache`` {"c", "n", "m", "h"} is
    advanced IN PLACE. Returns the residual output. Under a ``ctx`` as
    ``slstm_apply``, each state leaf read and written in its
    placement."""
    keys = ("c", "n", "m", "h")
    p, heads, ff = _slstm_prep(p, ctx)
    state = _slstm_cell(p, _slstm_wx(p, x, cfg, ctx, heads)[:, 0],
                        tuple(_read(cache, keys, ctx, heads)))
    _write(cache, dict(zip(keys, state)), ctx, heads)
    return _slstm_out(p, state[3][:, None], x, cfg, ctx, heads, ff)


def state_shapes(kind: str, cfg, batch: int) -> Optional[dict]:
    """The per-sequence state of an xLSTM layer as {leaf: (shape,
    fill, in the compute dtype?)}, or None for another kind."""
    if kind == "mlstm":
        dm, nh, dh = _mlstm_dims(cfg)
        return {"C": ((batch, nh, dh, dh), 0.0, False),
                "n": ((batch, nh, dh), 0.0, False),
                "m": ((batch, nh), _NEG, False),
                "conv": ((batch, CONV_WIDTH - 1, dm), 0.0, True)}
    if kind == "slstm":
        nh, dh, _ = _slstm_dims(cfg)
        return {"c": ((batch, nh, dh), 0.0, False),
                "n": ((batch, nh, dh), 1.0, False),
                "m": ((batch, nh, dh), _NEG, False),
                "h": ((batch, nh, dh), 0.0, False)}
    return None


__all__ = ["MLSTMBlock", "SLSTMBlock", "mlstm_init", "slstm_init",
           "mlstm_chunkwise", "mlstm_apply", "mlstm_prefill_cache",
           "mlstm_decode", "slstm_scan", "slstm_apply",
           "slstm_prefill_cache", "slstm_decode", "state_shapes"]
