"""Model configuration: one dataclass covering all 10 assigned architectures.

A verbatim copy of ``repro.models.config`` (pure Python), kept in the
port so that ``repro_torch`` imports nothing from ``repro``. The port
runs the decoder stack as a Python loop over an ``nn.ModuleList``; the
``lax.scan`` remark below describes the reference.

The architecture zoo spans six families (dense, MoE, SSM, hybrid, VLM,
audio enc-dec); a single config describes any of them through the
``layer_pattern`` — a repeating period of block kinds — plus family-
specific fields. Edge-PRUNE's technique (dataflow partitioning) is
architecture-agnostic, so every config here can also be exported as a
VR-PRUNE actor graph (see ``models.transformer.to_actor_graph``).

Block kinds
-----------
``attn``        global causal self-attention (GQA + RoPE)
``attn_local``  sliding-window causal self-attention (window = cfg.window)
``rglru``       RG-LRU gated linear recurrence block (RecurrentGemma)
``mlstm``       xLSTM matrix-memory LSTM block (linear-attention family)
``slstm``       xLSTM scalar-memory LSTM block (sequential exponential gating)
``enc_attn``    bidirectional encoder self-attention (enc-dec only)

``layer_pattern`` is tiled over ``n_layers``: e.g. gemma3's 5:1
local:global ratio is ``("attn_local",)*5 + ("attn",)`` and 26 layers =
4 full periods + 2 remainder layers. The remainder is unrolled; full
periods are executed under one ``lax.scan`` with stacked params, which
keeps HLO size (and therefore dry-run compile time) independent of depth.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    # Token-choice routing with fixed per-token-group capacity
    # (Switch-Transformer style dense dispatch; see models/moe.py).
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                   # sliding-window width for attn_local
    moe: Optional[MoEConfig] = None

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None   # gemma3: 1e6 on global layers
    rope_fraction: float = 1.0        # chatglm "RoPE 2d": rotary on half dims

    # encoder-decoder (audio): n_encoder_layers > 0 enables the encoder
    # stack + cross-attention in every decoder layer.
    n_encoder_layers: int = 0

    # multimodal frontend stub: the frontend (ViT / mel+conv codec) is NOT
    # implemented (the allowed carve-out) — input_specs() provides
    # precomputed embeddings of shape (batch, frontend_tokens, frontend_dim)
    # and the in-model projector maps frontend_dim -> d_model.
    frontend: Optional[str] = None    # "vision" | "audio"
    frontend_dim: int = 0
    frontend_tokens: int = 0

    # ssm / hybrid
    rglru_conv_width: int = 4         # RG-LRU temporal conv width
    mlstm_proj_factor: float = 2.0    # xLSTM mLSTM up-projection factor
    slstm_proj_factor: float = 4.0 / 3.0

    norm_eps: float = 1e-6
    act: str = "silu"                 # silu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"      # parameter dtype

    # implementation switches
    # "einsum" (Switch dense dispatch) wins on the collective-bound TPU
    # mesh; "gather" (index dispatch) trades 25% lower flops for 2.2x the
    # collective bytes under GSPMD — kept for ablation (§Perf iter 4).
    moe_impl: str = "einsum"
    attn_impl: str = "xla"            # "xla" (chunked lax flash) | "pallas"
    attn_chunk: int = 1024            # flash q/kv block size (xla impl)
    remat: bool = True                # checkpoint each scan period in train
    # Sub-quadratic decode support: archs whose every layer's decode cost
    # is O(window) or O(1) can run long_500k. Derived, but overridable.
    max_cache_len: int = 0            # 0 = no cap (full attention layers)

    def __post_init__(self):
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads must be divisible by n_kv_heads")
        for k in self.layer_pattern:
            if k not in ("attn", "attn_local", "rglru", "mlstm", "slstm"):
                raise ValueError(f"{self.name}: unknown block kind {k}")
        if any(k == "attn_local" for k in self.layer_pattern) and self.window <= 0:
            raise ValueError(f"{self.name}: attn_local requires window > 0")

    # ------------------------------------------------------------------
    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 128 (MXU lane alignment AND mesh
        divisibility: 256206 % 16 != 0 left seamless' logits unsharded —
        3 x 16.8 GB fp32 buffers; §Perf notes). Pad ids are masked to
        -1e30 in the head, so they are unsampleable and contribute
        nothing to the loss."""
        return -(-self.vocab_size // 128) * 128

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> Tuple[str, ...]:
        return self.layer_pattern

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def remainder_kinds(self) -> Tuple[str, ...]:
        r = self.n_layers % len(self.layer_pattern)
        return self.layer_pattern[:r]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """The full, flattened per-layer kind list (length n_layers)."""
        return self.layer_pattern * self.n_periods + self.remainder_kinds

    @property
    def is_subquadratic_decode(self) -> bool:
        """True iff per-token decode memory is bounded independently of the
        context length on every layer: recurrent blocks are O(1); local
        attention is O(window). Pure-full-attention archs are quadratic-
        family and skip long_500k (see DESIGN.md §4)."""
        return all(k != "attn" for k in self.layer_kinds)

    @property
    def decode_cache_token_bytes(self) -> int:
        """KV/state bytes per cached token per layer-average — used by the
        explorer's link model for decode partition points."""
        kd = self.resolved_head_dim * self.n_kv_heads
        itemsize = 2 if self.dtype == "bfloat16" else 4
        return 2 * kd * itemsize

    def param_count(self) -> int:
        """Analytic total parameter count N (for 6·N·D MODEL_FLOPS)."""
        d, hd = self.d_model, self.resolved_head_dim
        qkv_out = (self.n_heads + 2 * self.n_kv_heads) * hd
        n = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                 # lm head
        if self.frontend:
            n += self.frontend_dim * d + d * d       # 2-layer projector
        per_kind = {}
        per_kind["attn"] = d * qkv_out + self.n_heads * hd * d + 2 * d
        per_kind["attn_local"] = per_kind["attn"]
        per_kind["rglru"] = (d * (2 * d) + self.rglru_conv_width * d + 3 * d
                             + d * d + 2 * d)
        dm = int(self.mlstm_proj_factor * d)
        per_kind["mlstm"] = d * 2 * dm + 3 * dm * dm // max(self.n_heads, 1) \
            + dm * d + 2 * d
        ds = int(self.slstm_proj_factor * d)
        per_kind["slstm"] = 4 * d * d + 4 * d * d // max(self.n_heads, 1) \
            + d * ds + ds * d + 2 * d
        mlp = 3 * d * self.d_ff if self.d_ff else 0
        if self.moe:
            shared = 3 * d * self.moe.d_ff_expert * self.moe.n_shared_experts
            routed = 3 * d * self.moe.d_ff_expert * self.moe.n_experts
            router = d * self.moe.n_experts
            mlp = shared + routed + router
        for k in self.layer_kinds:
            n += per_kind[k]
            if k in ("attn", "attn_local", "rglru"):
                n += mlp
        # encoder stack (self-attn + mlp) + cross-attn in decoder layers
        if self.n_encoder_layers:
            enc = per_kind["attn"] + 3 * d * self.d_ff
            n += self.n_encoder_layers * enc
            n += self.n_layers * (per_kind["attn"])   # cross-attention
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        routed_all = self.n_layers * 3 * self.d_model * self.moe.d_ff_expert \
            * self.moe.n_experts
        routed_active = self.n_layers * 3 * self.d_model * self.moe.d_ff_expert \
            * self.moe.top_k
        return int(full - routed_all + routed_active)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests: 2 layers (one
        full period truncated to <=2 kinds), d_model <= 512, <= 4 experts."""
        pat = self.layer_pattern
        if len(pat) > 2:
            # keep kind diversity: one of each distinct kind, max 2
            kinds = list(dict.fromkeys(pat))[:2]
            pat = tuple(kinds) if len(kinds) == 2 else (kinds[0], kinds[0])
        elif len(pat) == 1:
            pat = pat * 2
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        moe = None
        if self.moe:
            # capacity_factor high enough that no token ever drops: keeps
            # the smoke decode-vs-forward consistency check exact.
            moe = replace(self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                          d_ff_expert=64, capacity_factor=4.0,
                          n_shared_experts=min(self.moe.n_shared_experts, 1))
        return replace(
            self, name=self.name + "-smoke", n_layers=2, d_model=d,
            n_heads=heads, n_kv_heads=kv, head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512), layer_pattern=pat,
            window=min(self.window, 8) if self.window else 0, moe=moe,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend else 0,
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend else 0,
            dtype="float32", param_dtype="float32", attn_chunk=8,
            remat=False)
