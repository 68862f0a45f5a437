#!/usr/bin/env python3
"""chip_smoke.py phase 9's ``vs_plain`` readings for a served model
through its kernels and through control runs, on one NVIDIA GPU:

    python3 tools/vs_plain_control.py [--arch recurrentgemma_9b]
        [--seeds 1,2,3] [--controls bfloat16,float8_e5m2,float8_e4m3fn]
        [--dtype bfloat16|float32]

The full-width model (seed 0, the serving CLI's weights, in ``--dtype``)
is built once. For each input seed it prefills and decodes at phase 9's sizes
through the kernels, through the plain versions, and through the plain
versions with the RG-LRU scan run in each control dtype (its inputs and
state rounded at every step, ``chip_smoke.scan_in``). Prints one JSON
line per run held against the plain run (with its seconds): the
logits' max |err| over
their largest magnitude, the top-2 gaps of the rows whose argmax moved,
and every cache leaf's error at the end of the runs (``h`` the RG-LRU
state). The limits of ``chip_smoke.model_vs_plain`` are set from these
lines: the kernels' readings must fall inside, the controls' outside.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="recurrentgemma_9b")
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--controls",
                    default="bfloat16,float8_e5m2,float8_e4m3fn")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    from repro_torch.models import transformer as T
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(args.arch), dtype=args.dtype)
    model = T.init_params(cfg, 0, device="cuda")
    batch, prompt_len, steps = cs.HYBRID_VS_PLAIN[args.arch]
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = cs.vs_plain_inputs(torch, cfg, batch, prompt_len, steps,
                                    seed)
        versions = {"kernels": None, "plain": cs.PlainVersions(
            fa_ref, da_ref, scan_ref)}
        for name in args.controls.split(","):
            versions[f"control, scan in {name}"] = cs.PlainVersions(
                fa_ref, da_ref, scan_ref,
                scan=cs.scan_in(torch, getattr(torch, name)))
        runs = {}
        for run, ctx in versions.items():
            t0 = time.perf_counter()
            with torch.no_grad(), ctx or contextlib.nullcontext():
                runs[run] = cs.drive_model(torch, model, *inputs)
            torch.cuda.synchronize()
            runs[run] += (time.perf_counter() - t0,)
        want = runs.pop("plain")
        for run, (*res, secs) in runs.items():
            r = cs.vs_plain_readings(torch, res, want[:2])
            print(json.dumps({"arch": args.arch, "dtype": args.dtype,
                              "seed": seed, "run": run, "s": secs,
                              "plain_s": want[2], **r}, default=float),
                  flush=True)
    print(f"# {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
