#!/usr/bin/env python3
"""Where a served model's kernels part from their plain versions, by
layer and by kernel, on one NVIDIA GPU:

    python3 tools/vs_plain_depth.py [--arch recurrentgemma_9b]
        [--batch 4] [--prompt-len 2080] [--steps 8]

The full-width model (bf16, seed 0) prefills a random batch and decodes
``--steps`` steps five times: through the kernels, through the plain
versions, through the plain versions but one kernel (the RG-LRU scan's
forward, then flash), and through the plain versions again. Each run is
held against the plain run: the logits of every step, and every cache
leaf (K/V rings, ``h``, ``conv``) after the prefill and after the last
step, as max |err| over the leaf's largest magnitude, listed by layer.
The repeat shows that the plain path itself is deterministic; the
one-kernel runs show how far the depth carries one kernel's rounding.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="recurrentgemma_9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2080)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    model = T.init_params(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device="cuda")
    fed = torch.randint(0, cfg.vocab_size, (args.steps, args.batch),
                        generator=gen, device="cuda")
    kern = (fa_ops.flash_attention, da_ops.decode_attention,
            scan_ops.rglru_scan_fwd)
    plain = (fa_ref.attention_ref, da_ref.decode_attention_ref,
             scan_ref.rglru_scan_seq_ref)

    def use(fa, da, scan):
        L.flash_attention, L.decode_attention = fa, da
        scan_ops.rglru_scan_fwd = scan

    def drive():
        logits, cache, clen = T.prefill(
            model, tokens, max_len=args.prompt_len + args.steps + 8)
        out = [logits.float()]
        after_prefill = [{k: v.clone() for k, v in c.items()} for c in cache]
        for tok in fed:
            logits, cache, clen = T.decode_step(model, tok, cache, clen)
            out.append(logits.float())
        return torch.stack(out), (after_prefill, cache)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp(min=1e-30)).item()
    runs = {}
    for name, fns in (("kernels", kern), ("plain", plain),
                      ("plain but the scan", (plain[0], plain[1], kern[2])),
                      ("plain but flash", (kern[0], plain[1], plain[2])),
                      ("plain again", plain)):
        use(*fns)
        t0 = time.perf_counter()
        runs[name] = drive()
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    use(*kern)
    want_logits, want_caches = runs["plain"]
    for name, (logits, caches) in runs.items():
        if name == "plain":
            continue
        print(f"== {name}: logits per step",
              [round(rel(g, w), 5) for g, w in zip(logits, want_logits)])
        for when, got, want in zip(("after prefill", "after decode"),
                                   caches, want_caches):
            by_leaf = {}
            for li, (g, w) in enumerate(zip(got, want)):
                for k in g:
                    by_leaf.setdefault(k, []).append((li, round(rel(g[k],
                                                                    w[k]), 4)))
            for k, errs in by_leaf.items():
                print(f"   {when} {k}: max {max(e for _, e in errs):.4f}; by "
                      f"layer {errs}")
    print(f"# {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
