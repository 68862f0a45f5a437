"""Fixtures of the benchmark's CPU tests: the checkout's root on the
path, and a copy of the benchmark with tiny cells added as files only
(configurations, traffic mixes, limits and manifest entries), which the
harness runs on the CPU with its look for a card skipped."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = {
    "registry": "qwen2-1.5b", "hidden_act": "silu", "hidden_size": 64,
    "intermediate_size": 128, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "tie_word_embeddings": True,
    "torch_dtype": "bfloat16", "vocab_size": 512, "qkv_bias": True,
    "init": {"final_norm_mean": 8.0}}
TINY_MOE = {
    "registry": "qwen2-moe-a2.7b", "hidden_act": "silu", "hidden_size": 64,
    "intermediate_size": 128, "moe_intermediate_size": 32,
    "norm_topk_prob": False, "num_attention_heads": 4, "num_experts": 8,
    "num_experts_per_tok": 2, "num_hidden_layers": 2,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "shared_expert_intermediate_size": 64, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "vocab_size": 512, "qkv_bias": True,
    "program": {"norm_topk_prob": True, "capacity_factor": 1.25,
                "capacity_multiple": 32}}
TINY_SERVE = {
    "kind": "serve", "clients": 4, "max_slots": 4, "max_len": 320,
    "prompt": {"dist": "loguniform", "lo": 16, "hi": 256},
    "output": {"dist": "uniform", "lo": 4, "hi": 24}}
TINY_TRAIN = {
    "kind": "train", "sequences": 4, "seq_len": 64, "microbatches": 2,
    "optimizer": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                  "weight_decay": 0.1, "grad_clip": 1.0, "warmup_steps": 100,
                  "total_steps": 10000, "min_lr_ratio": 0.1},
    "check_steps": 2}
# the tiny cells' limits, set from CPU readings of a few seeds: serving's
# widest logit gap over ~200 served tokens 0.01 to 0.04 sound, 0.30 to
# 0.69 for the fake-fp8 control; training's loss gap 0.0004 to 0.0018 sound, 0.008 to 0.016
# for the control, its gradient gap 0.0016 to 0.0076 sound, 0.016 to
# 0.059 for the control; the change gap (0.003 to 0.012 both) is held
# loosely, against a step that updates nothing (a gap of ~1); the MoE's
# median over the sampled requests of a request's mean logit gap 0 to
# 0.0009 sound, 0.022 to 0.077 for the control (eight seeds, two window
# lengths; its widest gap, 0.15 to 1.5 sound and 0.83 to 2.2 for the
# control, and its mean gap, to 0.034 sound and from 0.038 for the
# control, do not separate them: a routing choice flips on rounding)
TINY_LIMITS = {
    "tiny-dense.serve": {"logit_gap": {"limit": 0.1}},
    "tiny-moe.serve": {"request_median_gap": {"limit": 0.01}},
    "tiny-dense.train": {"loss_gap": {"limit": 0.005},
                         "grad_gap": {"limit": 0.012},
                         "change_gap": {"limit": 0.05}}}
# served tokens in a tiny serving cell's sample
TINY_SAMPLE = 200
# the training metrics, added for the tiny training cell where the
# manifest holds no training cell
TRAIN_METRICS = {
    "end_to_end": [{"name": "train_tok_s", "unit": "tokens/s",
                    "better": "higher", "bound": 0.05,
                    "source": "host_clock"}],
    "per_layer": [
        {"name": n, "unit": "%", "better": b, "source": src,
         "layer": layer, "moves": "train_tok_s"}
        for n, b, src, layer in (
            ("mfu.train", "higher", "host_clock", "model step"),
            ("flash_attention_roofline.train", "higher", "device_trace",
             "kernels"),
            ("idle_share.train", "lower", "device_trace", "device"))]}
TINY_CELLS = [("tiny-dense.serve", "tiny-dense", "tiny-serve"),
              ("tiny-moe.serve", "tiny-moe", "tiny-serve"),
              ("tiny-dense.train", "tiny-dense", "tiny-train")]


def add_tiny(root: Path) -> None:
    """Add the tiny cells to the benchmark at ``root`` as files only."""
    bench = root / "bench"
    for name, doc in (("tiny-dense", TINY_DENSE), ("tiny-moe", TINY_MOE)):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(doc))
    for name, doc in (("tiny-serve", TINY_SERVE), ("tiny-train", TINY_TRAIN)):
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(doc))
    for cell, doc in TINY_LIMITS.items():
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(
            {"sample_tokens": TINY_SAMPLE, "limits": doc}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"] += [
        {"name": n, "source": "https://huggingface.co/Qwen/Qwen2-1.5B",
         "file": f"bench/configs/{n}.json", "reduced": [], "why": "tiny"}
        for n in ("tiny-dense", "tiny-moe")]
    man["workloads"] += [{"name": c, "config": f, "traffic": t, "chips": 1,
                          "why": "tiny"} for c, f, t in TINY_CELLS]
    serve = [c for c, _, t in TINY_CELLS if t == "tiny-serve"]
    have = {m["name"] for m in man["end_to_end"] + man["per_layer"]}
    for key, ms in TRAIN_METRICS.items():
        man[key] += [dict(m, workloads=[]) for m in ms
                     if m["name"] not in have]
    train = {m["name"] for ms in TRAIN_METRICS.values() for m in ms}
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" not in m:
            continue
        if "qwen2-1.5b.chat64" in m["workloads"]:
            m["workloads"] += serve
        if m["name"] in train:
            m["workloads"] += ["tiny-dense.train"]
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A checkout-like directory: the manifest and a copy of the
    benchmark, with the tiny cells added."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_tiny(tmp_path)
    return tmp_path


def execute(root: Path, cell: str, trace: bool = False, seed: int = 2**31 + 7,
            seconds: float = 3.0):
    """A run of ``cell`` on the CPU, the harness's look for a card
    skipped."""
    from bench.harness import main
    return main.execute(root, cell, seed, seconds, trace, device="cpu",
                        bench=root / "bench", log=lambda m: None)
