"""The port's architecture registry against the reference's, and the
dense configs it adds (llama3.2-3b, chatglm3-6b) against the reference
on the CPU.

The registry is the reference's, every architecture in its order; every
config equals the reference's field for field, and its full-width
shapes equal tests/test_arch_smoke.py's table (the MoE, xLSTM,
encoder-decoder and vision configs among them); the aliases resolve as
the reference's do; an unknown architecture is refused by name. llama3.2-3b's and chatglm3-6b's smoke variants
(the latter with QKV bias, a rotary half of each head and 16 query
heads a KV head at full width, the decode kernel's ``MAX_GROUP``) give
the reference's prefill and 4 decode-step logits and caches within
1e-5, in fp32 on seeded weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.kernels.decode_attention.ops import MAX_GROUP
from repro_torch.weights import flatten, from_jax_params
from test_torch_hybrid import (_close, jax_logits_run, port_logits_run,
                               shaped_params)

# tests/test_arch_smoke.py test_full_config_matches_assignment: (layers,
# d_model, heads, kv heads, d_ff, vocabulary)
SHAPES = {
    "seamless_m4t_medium": (12, 1024, 16, 16, 4096, 256206),
    "llava_next_mistral_7b": (32, 4096, 32, 8, 14336, 32000),
    "recurrentgemma_9b": (38, 4096, 16, 1, 12288, 256000),
    "gemma3_1b": (26, 1152, 4, 1, 6912, 262144),
    "llama3_2_3b": (28, 3072, 24, 8, 8192, 128256),
    "qwen2_1_5b": (28, 1536, 12, 2, 8960, 151936),
    "chatglm3_6b": (28, 4096, 32, 2, 13696, 65024),
    "qwen2_moe_a2_7b": (24, 2048, 16, 16, 0, 151936),
    "qwen3_moe_235b_a22b": (94, 4096, 64, 4, 0, 151936),
    "xlstm_350m": (24, 1024, 4, 4, 0, 50304),
}


def test_registry_is_the_references_less_the_later_families():
    """No family is left for a later slice: the port's registry is the
    reference's, in its order, and an unknown name is refused."""
    assert ARCH_IDS == JAX_ARCH_IDS
    assert sorted(ARCH_IDS) == sorted(SHAPES)
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("gpt2")


@pytest.mark.parametrize("arch", sorted(SHAPES))
def test_full_config_equals_the_reference(arch):
    cfg, want = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == SHAPES[arch]
    assert len(cfg.layer_kinds) == cfg.n_layers
    assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(want.smoke())
    assert cfg.n_heads // cfg.n_kv_heads <= MAX_GROUP


@pytest.mark.parametrize("alias,arch", [
    ("gemma3-1b", "gemma3_1b"), ("llama3.2-3b", "llama3_2_3b"),
    ("chatglm3-6b", "chatglm3_6b"), ("recurrentgemma-9b", "recurrentgemma_9b"),
    ("qwen2-1.5b", "qwen2_1_5b"), ("qwen2-moe-a2.7b", "qwen2_moe_a2_7b"),
    ("qwen3-moe-235b-a22b", "qwen3_moe_235b_a22b"),
    ("xlstm-350m", "xlstm_350m"),
    ("seamless-m4t-medium", "seamless_m4t_medium"),
    ("llava-next-mistral-7b", "llava_next_mistral_7b")])
def test_aliases_resolve_as_in_the_reference(alias, arch):
    from repro.configs import canonical as jax_canonical
    assert canonical(alias) == jax_canonical(alias) == arch
    assert get_config(alias) == get_config(arch)


def test_chatglm3_takes_the_decode_kernels_largest_group():
    cfg = get_config("chatglm3_6b")
    assert cfg.n_heads // cfg.n_kv_heads == MAX_GROUP == 16
    assert cfg.qkv_bias and cfg.rope_fraction == 0.5


@pytest.mark.parametrize("arch", ["llama3_2_3b", "chatglm3_6b"])
def test_dense_smoke_prefill_and_decode_match_jax(arch):
    jc, pc = jax_config(arch).smoke(), get_config(arch).smoke()
    params = shaped_params(jc, seed=1)
    model = from_jax_params(flatten(params), pc, device="cpu")
    prompt = np.random.RandomState(2).randint(
        0, jc.vocab_size, (2, 13)).astype(np.int32)
    fed, want, want_caches = jax_logits_run(params, jc, prompt)
    got, got_caches = port_logits_run(model, prompt, fed)
    _close(got, want)
    for gc, wc in zip(got_caches[-1], want_caches[-1]):
        for k in ("k", "v"):
            _close(gc[k], wc[k])
