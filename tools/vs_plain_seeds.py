#!/usr/bin/env python3
"""chip_smoke.py phase 9's ``model_vs_plain`` over several input seeds,
on one NVIDIA GPU, to see how far the bf16 kernels' agreement with
their plain versions spreads from draw to draw:

    python3 tools/vs_plain_seeds.py --arch chatglm3_6b --seeds 1,2,3,4 \\
        [--batch 8] [--prompt-len 256] [--steps 2]

The full-width model (bf16, seed 0, the serving CLI's weights) is built
once; each seed draws new prompts and fed tokens. Prints one JSON line
per seed: the logits' max |err| over their largest magnitude, the share
of rows whose argmax agrees, the top-2 gaps of the rows whose argmax
moved, and every cache leaf's error at the end of the two runs.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
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
    batch, prompt_len, steps = cs.HYBRID_VS_PLAIN[args.arch]
    batch, prompt_len, steps = (args.batch or batch,
                                args.prompt_len or prompt_len,
                                args.steps or steps)
    model = T.init_params(get_config(args.arch), 0, device="cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            out = cs.model_vs_plain(torch, model, batch, prompt_len, steps,
                                    fa_ref, da_ref, scan_ref, seed=seed)
        except cs.PhaseFailed as exc:
            out = {"failed": str(exc)}
        print(json.dumps({"arch": args.arch, "seed": seed, **out},
                         default=float), flush=True)
    print(f"# {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
