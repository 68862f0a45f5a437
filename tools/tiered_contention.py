#!/usr/bin/env python3
"""Two engines of one process on one NVIDIA GPU, as the two tiers of a
``TieredEngine`` are: how long their work takes alone, together with a
step lock each, and together through the device's shared step lock
(``repro_torch.runtime.scheduler.device_step_lock``):

    python3 tools/tiered_contention.py [--repeats 2]

qwen2-1.5b at full width in bf16 (random weights, seed 0), one model
object: a 1-slot engine generates 2 requests and an 8-slot engine 8
(prompts of 128 to 512 tokens, 16 new tokens each), each on a thread of
its own. Every mode must give each engine the tokens it gives alone.
Prints the card's name and power limit, then one JSON line per repeat
with each mode's wall seconds (per engine, and both).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LENS = (128, 256, 384, 512)
NEW = 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: this measurement needs an NVIDIA GPU")
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.scheduler import Request

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    model = T.init_params(get_config("qwen2_1_5b"), 0, device="cuda")
    cfg = model.cfg
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, LENS[i % len(LENS)])
               .astype(np.int32) for i in range(8)]
    work = {1: prompts[:2], 8: prompts}

    def engine(slots: int, own_lock: bool):
        eng = Engine(cfg, model, EngineConfig(max_slots=slots, max_len=552),
                     device="cuda")
        if own_lock:
            eng.scheduler.step_lock = threading.RLock()
        return eng

    def run(eng, ps, out, key):
        t0 = time.perf_counter()
        comps = eng.generate([Request(i, p, max_new_tokens=NEW)
                              for i, p in enumerate(ps)])
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
        out[f"tokens{key}"] = [c.tokens for c in comps]

    def together(own_lock: bool) -> dict:
        out = {}
        threads = [threading.Thread(target=run, args=(
            engine(s, own_lock), work[s], out, s)) for s in (1, 8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        out["both"] = time.perf_counter() - t0
        return out

    for s in (1, 8):                    # warm-up
        run(engine(s, False), work[s][:1], {}, s)
    for _ in range(args.repeats):
        alone = {}
        for s in (1, 8):
            run(engine(s, False), work[s], alone, s)
        modes = {"alone": alone, "own_locks": together(True),
                 "shared_lock": together(False)}
        for name, m in modes.items():
            if any(m[f"tokens{s}"] != alone[f"tokens{s}"] for s in (1, 8)):
                print(f"FAIL: {name} changed the tokens")
                return 1
        print(json.dumps({name: {k: v for k, v in m.items()
                                 if not str(k).startswith("tokens")}
                          for name, m in modes.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
