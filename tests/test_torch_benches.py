"""The port's serving, load, escalation and failover benches at their
``--tiny`` size on the CPU (``--device cpu``): each runs to the end, its
own assertions hold, and it writes its result where ``--out`` says.
The benches are ``benchmarks/torch_{serving,load,escalation,failover}
_bench.py``, the reference's four run on ``repro_torch``; every run
here is a few seconds.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import (torch_escalation_bench,  # noqa: E402
                        torch_failover_bench, torch_load_bench,
                        torch_serving_bench)

TINY = ["--tiny", "--device", "cpu"]


def _rows(path: Path) -> dict:
    return {r["name"]: r["value"] for r in json.loads(path.read_text())}


def test_serving_bench_tiny(tmp_path):
    """With every optional section: the paged pool, prefix sharing and
    the multi-tenant victim cache."""
    out = tmp_path / "serving.json"
    torch_serving_bench.main(TINY + [
        "--out", str(out), "--paged", "--prefix-cache", "--victim-cache",
        "--tenants", "2"])
    rows = _rows(out)
    assert rows["continuous_tokens_per_s"] > 0
    assert rows["disagg_modeled_speedup"] >= 1.3
    assert rows["pipelined_modeled_speedup"] > 1.0
    assert rows["paged_kv_hwm_bytes"] <= rows["paged_kv_pool_bytes"]
    assert rows["prefix_prefill_tokens_saved_frac"] >= 0.30
    assert rows["victim_hits"] > 0 and rows["victim_tenants"] == 2


def test_load_bench_tiny(tmp_path):
    out = tmp_path / "load.json"
    assert torch_load_bench.main(TINY + ["--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"] == {"platform": "cpu"}
    assert res["failed"] == 0 and res["completed"] > 0
    assert res["completed"] + res["shed_timeout"] + res["rejected_429"] \
        == res["requests"]


def test_escalation_bench_tiny(tmp_path):
    out, merged = tmp_path / "esc.json", tmp_path / "bench.json"
    merged.write_text(json.dumps({"ttft_s": {"p99": 1.0}}))
    assert torch_escalation_bench.main(
        TINY + ["--out", str(out), "--merge-bench", str(merged)]) == 0
    res = json.loads(out.read_text())
    modes = res["modes"]
    assert modes["local_only"]["escalated"] == 0
    assert modes["always_escalate"]["escalated_fraction"] == 1.0
    assert 0.0 < modes["confidence_gated"]["escalated_fraction"] < 1.0
    assert res["link_cut"]["lost"] == [] \
        and res["link_cut"]["failback_total"] >= 1
    assert json.loads(merged.read_text()) == {"ttft_s": {"p99": 1.0},
                                              "escalation": res}


def test_failover_bench_tiny(tmp_path):
    out, trace = tmp_path / "failover.json", tmp_path / "trace.json"
    torch_failover_bench.main(TINY + ["--out", str(out), "--trace-out",
                                      str(trace)])
    rows = _rows(out)
    assert rows["bit_identical"] == rows["sched_bit_identical"] == 1.0
    assert rows["frames_lost"] == 0 and rows["frames_replayed"] > 0
    assert rows["failovers"] == rows["obs_failovers_total"] == 1
    assert rows["sim_frames_replayed"] > 0
    assert json.loads(trace.read_text())["traceEvents"]
