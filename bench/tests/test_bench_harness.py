"""The harness end to end on the CPU at a tiny size: the result line's
keys, no run without a card, no result without the program, and the
check for JAX in the process."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, execute

E2E_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
TRACE_KEYS = ["correct", "attempted", "failed", "metrics", "device",
              "breakdown", "checks"]


@pytest.mark.parametrize("cell", ["tiny-dense.serve", "tiny-dense.train"])
def test_result_keys_are_exact(tiny_root, cell):
    res, lines = execute(tiny_root, cell)
    assert list(res) == E2E_KEYS
    assert res["correct"] is True
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    assert "setup_s" in res["metrics"]
    assert all(line.startswith("check ") for line in lines)
    assert len(lines) == len(res["checks"])


@pytest.mark.parametrize("cell", ["tiny-dense.serve", "tiny-dense.train"])
def test_traced_result_keys_are_exact(tiny_root, cell):
    res, _ = execute(tiny_root, cell, trace=True)
    assert list(res) == TRACE_KEYS
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "setup_s" not in res["metrics"]
    json.dumps(res)


@pytest.mark.parametrize("cell", ["tiny-dense.serve", "tiny-dense.train"])
def test_a_profile_with_no_kernel_is_taken_again(tiny_root, monkeypatch,
                                                 cell):
    """The profiler on the card now and then records no kernel in a
    sub-window: the traced run profiles again and reads that one."""
    from bench.harness import main, trace
    seen = []

    def second_time(self):
        seen.append(self)
        return len(seen) > 1
    monkeypatch.setattr(trace.Profile, "kernels_seen", second_time)
    logs = []
    res, _ = main.execute(tiny_root, cell, 2**31 + 7, 3.0, True,
                          device="cpu", bench=tiny_root / "bench",
                          log=logs.append)
    assert len(seen) == 2 and seen[0] is not seen[1]
    assert sum("holds no kernel" in m for m in logs) == 1
    assert res["correct"] is True and "idle_gaps" in res["breakdown"]


def test_moe_serves_and_is_checked(tiny_root):
    res, _ = execute(tiny_root, "tiny-moe.serve")
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] is True, res["checks"]
    assert list(res["checks"]) == ["request_median_gap"]


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen2-1.5b.chat64",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return out.returncode != 0 and not (lines and lines[-1].startswith("{"))


def test_no_card_no_run():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is of a machine without")
    assert _no_result(_run_py(ROOT))


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _no_result(_run_py(tmp_path))


def test_jax_in_the_process_is_found(monkeypatch):
    from bench.harness import main
    assert main.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert main.loaded_forbidden() == ["jax", "repro"]
