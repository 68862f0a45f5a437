"""Weights made from the seed, on the card, in the type they are served
in, one group at a time: the embedding, the final norm, the LM head
(untied configurations) and each decoder layer.

Each group is drawn by one ``torch.randn`` call per dtype from a
``torch.Generator`` seeded by the run's seed and the group's name, so a
group can be drawn again, alone, with the same values: the program is
loaded with them once at set-up, and the reference draws each layer
again when it reaches it, after the program has been freed. Leaves are
named as the port names its parameters; ``reference_layer`` renames a
layer's leaves into the reference's names and shapes.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

BF16, F32 = torch.bfloat16, torch.float32
NORM_SCALE = 0.1        # norm scales and biases: N(0, NORM_SCALE^2)
EMBED_SCALE = 0.02      # the embedding: N(0, EMBED_SCALE^2)

Leaf = Tuple[str, Tuple[int, ...], torch.dtype, float]
# a leaf drawn N(shift, scale^2) rather than N(0, scale^2)
SHIFTS: Dict[str, str] = {"final_norm": "final_norm_mean"}


def _hd(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def layer_leaves(cfg: Dict) -> List[Leaf]:
    """One decoder layer's leaves: (port name, shape, dtype, scale)."""
    d, hd = cfg["hidden_size"], _hd(cfg)
    h, hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    out: List[Leaf] = [
        ("block.wq", (d, h, hd), BF16, d ** -0.5),
        ("block.wk", (d, hk, hd), BF16, d ** -0.5),
        ("block.wv", (d, hk, hd), BF16, d ** -0.5),
        ("block.wo", (h, hd, d), BF16, (h * hd) ** -0.5),
        ("block.ln", (d,), BF16, NORM_SCALE)]
    if cfg.get("qkv_bias"):
        out += [("block.bq", (h, hd), BF16, NORM_SCALE),
                ("block.bk", (hk, hd), BF16, NORM_SCALE),
                ("block.bv", (hk, hd), BF16, NORM_SCALE)]
    if cfg.get("num_experts"):
        e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
        out += [("moe.ln", (d,), BF16, NORM_SCALE),
                ("moe.router", (d, e), F32, d ** -0.5),
                ("moe.w_gate", (e, d, f), BF16, d ** -0.5),
                ("moe.w_up", (e, d, f), BF16, d ** -0.5),
                ("moe.w_down", (e, f, d), BF16, f ** -0.5)]
        fs = cfg.get("shared_expert_intermediate_size", 0)
        if fs:
            out += [("moe.shared.w_gate", (d, fs), BF16, d ** -0.5),
                    ("moe.shared.w_up", (d, fs), BF16, d ** -0.5),
                    ("moe.shared.w_down", (fs, d), BF16, fs ** -0.5)]
    else:
        f = cfg["intermediate_size"]
        out += [("mlp.w_gate", (d, f), BF16, d ** -0.5),
                ("mlp.w_up", (d, f), BF16, d ** -0.5),
                ("mlp.w_down", (f, d), BF16, f ** -0.5),
                ("mlp.ln", (d,), BF16, NORM_SCALE)]
    return out


def top_leaves(cfg: Dict) -> Dict[str, List[Leaf]]:
    """The groups outside the layers. The configuration's ``init`` may
    set the embedding's scale (``embed_std``) and the final norm's mean
    (``final_norm_mean``)."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    init = cfg.get("init", {})
    out = {"embed": [("embed", (v, d), BF16,
                      init.get("embed_std", EMBED_SCALE))],
           "final_norm": [("final_norm", (d,), BF16, NORM_SCALE)]}
    if not cfg.get("tie_word_embeddings"):
        out["lm_head"] = [("lm_head", (d, v), BF16, d ** -0.5)]
    return out


def _generator(seed: int, group: str, device) -> torch.Generator:
    h = hashlib.sha256(f"{seed}/{group}".encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h[:8], "little") >> 1)


def draw(leaves: List[Leaf], seed: int, group: str, device,
         shift: float = 0.0) -> Dict[str, torch.Tensor]:
    """A group's leaves, one ``randn`` call per dtype, each leaf a view
    of it scaled in place (and moved by ``shift``)."""
    gen = _generator(seed, group, device)
    out: Dict[str, torch.Tensor] = {}
    for dtype in (BF16, F32):
        mine = [lf for lf in leaves if lf[2] == dtype]
        if not mine:
            continue
        n = sum(math.prod(s) for _, s, _, _ in mine)
        flat = torch.randn(n, generator=gen, dtype=dtype, device=device)
        at = 0
        for name, shape, _, scale in mine:
            k = math.prod(shape)
            out[name] = flat[at:at + k].view(shape).mul_(scale)
            if shift:
                out[name].add_(shift)
            at += k
    return out


def draw_layer(cfg: Dict, seed: int, i: int, device
               ) -> Dict[str, torch.Tensor]:
    return draw(layer_leaves(cfg), seed, f"layer{i}", device)


def draw_top(cfg: Dict, seed: int, group: str, device) -> torch.Tensor:
    shift = cfg.get("init", {}).get(SHIFTS.get(group, ""), 0.0)
    return draw(top_leaves(cfg)[group], seed, group, device, shift)[group]


@torch.no_grad()
def load_program(model, cfg: Dict, seed: int, masters: bool = False) -> None:
    """Copy the seed's weights into the port's model by parameter name,
    group by group; every parameter the groups name must exist with its
    shape and dtype, or in fp32 with ``masters`` (a training model's
    master copy, which takes the same values)."""
    dev = next(model.parameters()).device

    def put(name: str, t: torch.Tensor) -> None:
        p = model.get_parameter(name)
        if masters and p.dtype == F32:
            t = t.to(F32)
        if p.shape != t.shape or p.dtype != t.dtype:
            raise ValueError(f"{name}: the program holds {tuple(p.shape)} "
                             f"{p.dtype}, the benchmark made "
                             f"{tuple(t.shape)} {t.dtype}")
        p.copy_(t)

    for group in top_leaves(cfg):
        put(group, draw_top(cfg, seed, group, dev))
    for i in range(cfg["num_hidden_layers"]):
        for name, t in draw_layer(cfg, seed, i, dev).items():
            put(f"layers.{i}.{name}", t)
        torch.cuda.synchronize() if dev.type == "cuda" else None


# port name -> (reference name, reference shape as a function of the leaf)
_RENAME = {
    "block.ln": "attn_norm", "block.wq": "wq", "block.wk": "wk",
    "block.wv": "wv", "block.wo": "wo", "block.bq": "bq", "block.bk": "bk",
    "block.bv": "bv", "mlp.ln": "mlp_norm", "moe.ln": "mlp_norm",
    "mlp.w_gate": "w_gate", "mlp.w_up": "w_up", "mlp.w_down": "w_down",
    "moe.router": "router", "moe.w_gate": "e_gate", "moe.w_up": "e_up",
    "moe.w_down": "e_down", "moe.shared.w_gate": "s_gate",
    "moe.shared.w_up": "s_up", "moe.shared.w_down": "s_down"}


def reference_layer(cfg: Dict, seed: int, i: int, device
                    ) -> Dict[str, torch.Tensor]:
    """Layer ``i`` drawn again, in fp32, under the reference's names and
    shapes: projections (in, out), biases flat."""
    return {_RENAME[n]: t for n, t in
            reference_layer_by_port_name(cfg, seed, i, device).items()}


def reference_layer_by_port_name(cfg: Dict, seed: int, i: int, device
                                 ) -> Dict[str, torch.Tensor]:
    """``reference_layer``'s tensors keyed by the port's names."""
    d = cfg["hidden_size"]
    out = {}
    for name, t in draw_layer(cfg, seed, i, device).items():
        t = t.to(F32)
        if name in ("block.wq", "block.wk", "block.wv"):
            t = t.reshape(d, -1)
        elif name == "block.wo":
            t = t.reshape(-1, d)
        elif name in ("block.bq", "block.bk", "block.bv"):
            t = t.reshape(-1)
        out[name] = t
    return out


def reference_name(port_name: str) -> str:
    return _RENAME[port_name]


class ReferenceSource:
    """The reference's view of the seed's weights, in fp32, drawn again
    group by group as the reference asks (``reference.qwen2``)."""

    def __init__(self, cfg: Dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device

    def embed(self) -> torch.Tensor:
        return draw_top(self.cfg, self.seed, "embed", self.device).to(F32)

    def final_norm(self) -> torch.Tensor:
        return draw_top(self.cfg, self.seed, "final_norm",
                        self.device).to(F32)

    def head(self):
        if self.cfg.get("tie_word_embeddings"):
            return None
        return draw_top(self.cfg, self.seed, "lm_head", self.device).to(F32)

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        return reference_layer(self.cfg, self.seed, i, self.device)
