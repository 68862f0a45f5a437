"""Qwen2 dense and MoE decoders in plain fp32 PyTorch, one layer at a
time.

Written from a configuration file of ``bench/configs`` (HF key names)
and the semantics it states: RMSNorm as x / rms(x) * (1 + scale), the
embedding scaled by sqrt(hidden_size), rotary embedding on the two
halves of each head (theta ``rope_theta``), grouped-query causal
attention with a bias on q, k and v, a SiLU-gated MLP, and for an MoE
configuration token-choice top-k routing with a fixed capacity per
group (see ``moe``), renormalised top-k probabilities and ungated
shared experts. No kernel, cache or batching: every sequence is run
whole, layer by layer, so that a layer's weights are the only ones
held.

Weights come from a ``source`` with ``embed()``, ``final_norm()``,
``head()`` (None when the embedding is tied) and ``layer(i)``, each
returning fp32 tensors named as ``LAYER_LEAVES`` lists them.

``quant`` switches every matrix product of the decoder and head to
rounded inputs and weights: ``"fp8"`` fake-quantised float8 (e4m3),
scaled per row of the input and per output column of the weight, the
lower-precision control of the comparison; ``"bf16"`` both rounded to
bfloat16, a witness of what rounding to the configuration's own
precision does, which rounds the router's product to bfloat16 as a
bf16 model computes it (its inputs and its output). The control keeps
the router in fp32, as the configuration holds its weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

F32 = torch.float32


def plain_fp32() -> None:
    """Matrix products in true fp32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def is_moe(cfg: Dict) -> bool:
    return bool(cfg.get("num_experts"))


def layer_leaves(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of one layer's weights. Projections are stored
    (in, out); experts (E, in, out)."""
    d, hd = cfg["hidden_size"], head_dim(cfg)
    h, hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    out = {"attn_norm": (d,), "wq": (d, h * hd), "wk": (d, hk * hd),
           "wv": (d, hk * hd), "wo": (h * hd, d)}
    if cfg.get("qkv_bias"):
        out.update(bq=(h * hd,), bk=(hk * hd,), bv=(hk * hd,))
    out["mlp_norm"] = (d,)
    if is_moe(cfg):
        e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
        fs = cfg.get("shared_expert_intermediate_size", 0)
        out.update(router=(d, e), e_gate=(e, d, f), e_up=(e, d, f),
                   e_down=(e, f, d))
        if fs:
            out.update(s_gate=(d, fs), s_up=(d, fs), s_down=(fs, d))
    else:
        f = cfg["intermediate_size"]
        out.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    return out


# ---------------------------------------------------------------------------
# precision of the matrix products
# ---------------------------------------------------------------------------

def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the largest magnitude maps to 448), back in fp32; under autograd
    the rounding passes the gradient straight through."""
    d = x.detach()
    scale = d.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
    q = (d / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - d) if x.requires_grad else q


def fake_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in fp32."""
    return x.to(torch.bfloat16).to(F32)


def mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]
       ) -> torch.Tensor:
    """a (..., in) @ w (in, out) in fp32, or with both rounded to
    ``quant`` ("fp8" or "bf16") first."""
    if not quant:
        return a @ w
    if quant == "bf16":
        return fake_bf16(a) @ fake_bf16(w)
    return fake_fp8(a, -1) @ fake_fp8(w, -2)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (S, H, D): rotate the two halves of each head by position."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=F32,
                                       device=x.device) / d)
    ang = positions.to(F32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 1024) -> torch.Tensor:
    """q (S, H, D), k and v (S, Hk, D): softmax(q k^T / sqrt(D)) v over
    the keys at or before each query, in blocks of queries."""
    s, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    kpos = torch.arange(s, device=q.device)
    for lo in range(0, s, block):
        hi = min(lo + block, s)
        sc = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) / math.sqrt(d)
        mask = kpos[None, :hi] > torch.arange(lo, hi, device=q.device)[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                  v[:hi])
    return out


def attention_block(cfg: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
                    quant: Optional[str] = None) -> torch.Tensor:
    """x (S, d) -> x + self-attention(rms_norm(x))."""
    s = x.shape[0]
    hd = head_dim(cfg)
    h = rms_norm(x, w["attn_norm"], cfg["rms_norm_eps"])
    q, k, v = (mm(h, w[n], quant) for n in ("wq", "wk", "wv"))
    if cfg.get("qkv_bias"):
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q, k, v = (t.reshape(s, -1, hd) for t in (q, k, v))
    pos = torch.arange(s, device=x.device)
    q = rope(q, pos, cfg["rope_theta"])
    k = rope(k, pos, cfg["rope_theta"])
    o = causal_attention(q, k, v).reshape(s, -1)
    return x + mm(o, w["wo"], quant)


def gated_mlp(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(h, wg, quant)) * mm(h, wu, quant),
              wd, quant)


def capacity(cfg: Dict, tokens: int) -> int:
    """Slots per expert for a group of ``tokens`` tokens."""
    c = int(tokens * cfg["num_experts_per_tok"] * cfg["capacity_factor"]
            / cfg["num_experts"])
    m = cfg.get("capacity_multiple", 1)
    return max(-(-c // m) * m, m)


def route(cfg: Dict, logits: torch.Tensor, groups: Sequence[Tuple[int, int]]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits (S, E) -> (expert ids (S, K), weights (S, K)): the
    top-k probabilities, ties to the lower expert id, renormalised to
    sum to 1, and zero where the choice is dropped. The tokens of each
    group [lo, hi) compete for ``capacity(hi - lo)`` slots per expert:
    the choices are queued first choices first (every token's first
    choice in token order, then every token's second), and a choice
    past its expert's capacity is dropped."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    if cfg.get("norm_topk_prob"):
        top_p = top_p / top_p.sum(-1, keepdim=True)
    keep = torch.zeros_like(top_p, dtype=torch.bool)
    e = cfg["num_experts"]
    for lo, hi in groups:
        cap = capacity(cfg, hi - lo)
        queue = top_i[lo:hi].t().reshape(-1)              # k-major
        onehot = torch.nn.functional.one_hot(queue, e)
        pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
        keep[lo:hi] = (pos < cap).reshape(k, hi - lo).t()
    return top_i, top_p * keep


def moe_block(cfg: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
              groups: Sequence[Tuple[int, int]], quant: Optional[str] = None
              ) -> torch.Tensor:
    """x (S, d) -> x + routed experts + shared experts of rms_norm(x)."""
    h = rms_norm(x, w["mlp_norm"], cfg["rms_norm_eps"])
    if quant == "bf16":
        router = fake_bf16(fake_bf16(h) @ fake_bf16(w["router"]))
    else:
        router = h @ w["router"]
    ids, wts = route(cfg, router, groups)
    out = torch.zeros_like(h)
    for e in torch.unique(ids[wts > 0]).tolist():
        tok, slot = torch.nonzero((ids == e) & (wts > 0), as_tuple=True)
        y = gated_mlp(h[tok], w["e_gate"][e], w["e_up"][e], w["e_down"][e],
                      quant)
        out.index_add_(0, tok, y * wts[tok, slot, None])
    if "s_gate" in w:
        out = out + gated_mlp(h, w["s_gate"], w["s_up"], w["s_down"], quant)
    return x + out


def mlp_block(cfg: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
              quant: Optional[str] = None) -> torch.Tensor:
    h = rms_norm(x, w["mlp_norm"], cfg["rms_norm_eps"])
    return x + gated_mlp(h, w["w_gate"], w["w_up"], w["w_down"], quant)


def layer(cfg: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
          groups: Sequence[Tuple[int, int]], quant: Optional[str] = None
          ) -> torch.Tensor:
    """One decoder layer over one sequence x (S, d)."""
    x = attention_block(cfg, w, x, quant)
    if is_moe(cfg):
        return moe_block(cfg, w, x, groups, quant)
    return mlp_block(cfg, w, x, quant)


def embed(cfg: Dict, table: torch.Tensor, tokens: torch.Tensor
          ) -> torch.Tensor:
    return table[tokens] * math.sqrt(cfg["hidden_size"])


def head_weights(source) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final norm scale, LM head (d, vocab)): the embedding's transpose
    when the head is tied."""
    head = source.head()
    return source.final_norm(), source.embed().t() if head is None else head


def logits(cfg: Dict, head: Tuple[torch.Tensor, torch.Tensor],
           x: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """Final norm and LM head: x (S, d) -> (S, vocab)."""
    x = rms_norm(x, head[0], cfg["rms_norm_eps"])
    return mm(x, head[1], quant)


def serving_groups(prompt_len: int, total: int) -> List[Tuple[int, int]]:
    """How a served sequence's tokens met the experts: the prompt
    prefilled as one group, then each decoded token alone."""
    return [(0, prompt_len)] + [(i, i + 1) for i in range(prompt_len, total)]


@torch.no_grad()
def served_logits(cfg: Dict, source, seqs: Sequence[torch.Tensor],
                  prompt_lens: Sequence[int],
                  quants: Sequence[Optional[str]] = (None,)
                  ) -> Dict[Optional[str], List[torch.Tensor]]:
    """For each sequence (a prompt followed by the tokens served for it,
    the last one left out), the logits at the positions that chose the
    served tokens: rows ``prompt_len - 1`` onwards, (n_served, vocab),
    for each precision of ``quants`` (None: fp32, or ``mm``'s). The
    sequences go through the layers together, one layer's weights at a
    time."""
    table = source.embed()
    xs = {q: [embed(cfg, table, s) for s in seqs] for q in quants}
    del table
    for i in range(cfg["num_hidden_layers"]):
        w = source.layer(i)
        for q in quants:
            xs[q] = [layer(cfg, w, x, serving_groups(p, x.shape[0]), q)
                     for x, p in zip(xs[q], prompt_lens)]
        del w
    head = head_weights(source)
    return {q: [logits(cfg, head, x[p - 1:], q)
                for x, p in zip(xs[q], prompt_lens)] for q in quants}


# ---------------------------------------------------------------------------
# training: loss, gradients, AdamW
# ---------------------------------------------------------------------------

def sequence_loss(cfg: Dict, params: Dict, tokens: torch.Tensor,
                  quant: Optional[str] = None) -> torch.Tensor:
    """Summed next-token cross-entropy of one sequence (S,) over its
    first S - 1 positions, each layer recomputed in the backward
    (``torch.utils.checkpoint``) so that one layer's activations are
    held at a time. ``params``: {"embed", "final_norm", "head" (None when
    tied), "layers": [dict of ``layer_leaves``]} with gradients on."""
    from torch.utils.checkpoint import checkpoint
    x = embed(cfg, params["embed"], tokens)
    s = x.shape[0]
    for w in params["layers"]:
        x = checkpoint(layer, cfg, w, x, [(0, s)], quant, use_reentrant=False)
    head = params["head"] if params["head"] is not None \
        else params["embed"].t()
    lg = logits(cfg, (params["final_norm"], head), x[:-1], quant)
    return torch.nn.functional.cross_entropy(lg, tokens[1:], reduction="sum")


def schedule(opt: Dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` x lr."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"])
                        * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(opt: Dict, leaves: List[torch.Tensor], state: Dict, step: int
          ) -> List[torch.Tensor]:
    """One AdamW step over ``leaves`` (their ``.grad`` set) at ``step``
    (from 1): the gradients clipped to ``grad_clip`` by their global
    norm, bias-corrected moments, decoupled weight decay. Returns the
    clipped gradients the moments took in."""
    gnorm = torch.sqrt(sum(torch.sum(p.grad.square()) for p in leaves))
    scale = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
    lr = schedule(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    clipped = []
    for i, p in enumerate(leaves):
        g = p.grad * scale
        clipped.append(g)
        m = state.setdefault(("m", i), torch.zeros_like(p))
        v = state.setdefault(("v", i), torch.zeros_like(p))
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"]) \
            + opt["weight_decay"] * p
        p.sub_(lr * u)
    return clipped
