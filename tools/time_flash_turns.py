#!/usr/bin/env python3
"""Time the attention and scan kernels at the main paths' shapes for two
checkouts of the repository, in turns (other, this, this, other), on one
NVIDIA GPU:

    python3 tools/time_flash_turns.py OTHER_CHECKOUT

e.g. ``mkdir -p build/parent && git archive PARENT | tar -x -C
build/parent`` (``build/`` is gitignored), then ``build/parent``.

``OTHER_CHECKOUT`` is a second checkout, e.g. the parent commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists. Each
turn runs in a fresh process from that checkout's root, builds that
checkout's kernels, and times them with that checkout's
``chip_smoke.py``: flash (``time_flash`` at the fifo and batch
prefills, ``time_flash_extend`` at the prefix-resume, chunk and ragged
extends, and ``time_flash_train`` at the training shape where the
checkout has it; its ``SERVE_FA`` shapes), slotted decode
(``time_decode`` at its ``SERVE_DEC`` shapes), paged decode
(``time_paged`` at its ``SERVE_PAGED`` shapes, or the fifo step) and the RG-LRU
scan forward and reverse (``time_scan`` at the training shape, where
the checkout has it), so that the two versions meet the same card in
one call. Prints one JSON line per turn, times in ms.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

TURN = r'''
import json, sys
sys.path.insert(0, "src")
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
import numpy as np
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref
from repro_torch.kernels.rglru_scan import ops as scan_ops, ref as scan_ref
_build.build_all(["flash_attention", "decode_attention", "rglru_scan"])
gen = torch.Generator(device="cuda").manual_seed(0)
rnd = lambda shape, dt: torch.randn(shape, generator=gen, device="cuda").to(dt)
out = {"flash " + p: cs.time_flash(torch, ops, ref, rnd, b)["ms"]
       for p, b in cs.SERVE_FA.items()}
out.update({"flash " + p: cs.time_flash_extend(torch, ops, ref, rnd, case)["ms"]
            for p, case in cs.SERVE_EXT.items()})
if hasattr(cs, "time_flash_train"):
    out["flash train"] = cs.time_flash_train(torch, ops, ref, rnd)["ms"]
out.update({"decode " + p: cs.time_decode(torch, da_ops, da_ref, rnd, lens)["ms"]
            for p, lens in cs.SERVE_DEC.items()})
if hasattr(cs, "SERVE_PAGED"):      # shapes, head_dim 256 among them
    out.update({"paged " + p: cs.time_paged(torch, np, da_ops, da_ref, rnd,
                                            shape)["ms"]
                for p, shape in cs.SERVE_PAGED.items()})
else:
    out["paged fifo"] = cs.time_paged(torch, np, da_ops, da_ref, rnd,
                                      cs.FIFO_LENS)["ms"]
if hasattr(cs, "time_scan"):
    for part in ("forward", "reverse"):
        out["scan " + part] = cs.time_scan(torch, scan_ops, scan_ref, rnd,
                                           reverse=part == "reverse")["ms"]
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    here = Path(__file__).resolve().parents[1]
    other = Path(sys.argv[1]).resolve()
    for root in (other, here, here, other):
        run = subprocess.run([sys.executable, "-c", TURN], cwd=root,
                             capture_output=True, text=True)
        got = [ln[7:] for ln in run.stdout.splitlines()
               if ln.startswith("RESULT ")]
        if run.returncode or not got:
            print(run.stdout[-2000:], run.stderr[-4000:])
            return 1
        print(json.dumps({"checkout": str(root), "ms": json.loads(got[0])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
