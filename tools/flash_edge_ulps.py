#!/usr/bin/env python3
"""Where the bf16 flash kernel misses ``tests/test_torch_cuda.py``'s
q_offset / kv_len limit, in units of the output's bf16 spacing.

Replays ``test_bf16_kernel_edges_match_plain_on_card``'s draws up to its
q_offset / kv_len case (B=3, Sq=70, Sk=200, 8/2 heads, D=128, bf16) on
the card and reports the outputs over the test's 5e-3 + 5e-3·|ref|
limit: their count, |ref| there, the error in ulps of |ref|, and where
they are (sequence, row, head, column). Needs one card::

    PYTHONPATH=src python3 tools/flash_edge_ulps.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from test_torch_cuda import _qkv  # noqa: E402

# the test's flash cases before the q_offset / kv_len one: their draws
# advance the generator
EARLIER = [(2, 100, 100, 4, 2, 16), (1, 130, 130, 8, 2, 64),
           (2, 77, 77, 6, 3, 96), (1, 150, 150, 4, 1, 192),
           (2, 37, 37, 4, 2, 12), (1, 70, 133, 4, 2, 128),
           (2, 90, 90, 4, 4, 128), (1, 200, 200, 16, 1, 128),
           (1, 40, 40, 128, 1, 64), (1, 300, 300, 16, 1, 256)]
TOL = 5e-3


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU")
        return 2
    rng = np.random.RandomState(0)
    for shape in EARLIER:
        _qkv(rng, *shape)
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in _qkv(rng, 3, 70, 200, 8, 2, 128))
    kw = dict(q_offset=torch.tensor([0, 30, 100], dtype=torch.int32).cuda(),
              kv_len=torch.tensor([70, 100, 170], dtype=torch.int32).cuda())
    got = fa_ops.flash_attention(q, k, v, **kw).float().cpu()
    want = fa_ref.attention_ref(q, k, v, **kw).float().cpu()
    err = (got - want).abs()
    over = err > TOL + TOL * want.abs()
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        want.abs().clamp_min(1e-30))) - 7)
    print(f"max |err| {err.max().item():.6g}; {int(over.sum())} of "
          f"{over.numel()} outputs over {TOL:g} + {TOL:g}·|ref|")
    print(f"  |ref| there: {want.abs()[over].tolist()}")
    print(f"  error in bf16 ulps of |ref|: {(err[over] / ulp[over]).tolist()}")
    print(f"  (sequence, row, head, column): {over.nonzero().tolist()}")
    print(f"  largest error anywhere, in ulps of |ref|: "
          f"{(err / ulp)[want.abs() > 1e-3].max().item():.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
