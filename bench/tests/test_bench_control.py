"""The control of the correctness comparison comes out as not correct:
the reference in the program's place, computed in fake float8, the
precision below the bf16 that the configurations state, judged by the
cell's own comparison (``main.checks``). On the CPU at a tiny size here;
at the cell's own size on the card (``cuda``)."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT

from bench.harness import main as H
from bench.harness import manifest


@pytest.mark.parametrize("seed", [2**31, 2**31 + 1, 2**31 + 2])
@pytest.mark.parametrize("cell", ["tiny-dense.serve", "tiny-moe.serve",
                                  "tiny-dense.train"])
def test_control_fails_the_tiny_limits(tiny_root, cell, seed):
    from bench.harness import serve, train
    c = manifest.load_cell(tiny_root, cell, tiny_root / "bench")
    mod = serve if c.mix["kind"] == "serve" else train
    r = mod.run(c, seed, 2.0, False, "cpu", time.perf_counter(),
                lambda m: None, quants=(None, "fp8")).check
    ok, compared = H.checks(c, r)
    assert ok is True, compared
    ok, compared = H.checks(c, H.control_readings(r))
    assert ok is False, compared


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["qwen2-1.5b.chat64",
                                  "qwen2-moe-a2.7b.chat64",
                                  "qwen2-1.5b.longdoc"])
def test_control_fails_at_the_cells_size(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    seconds = manifest.load_manifest(ROOT)["run_seconds"]
    out = subprocess.run(
        [sys.executable, "bench/control.py", "--workload", cell,
         "--seconds", str(seconds), "--seeds", str(2**31 + 11)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["control_correct"] is False, r
