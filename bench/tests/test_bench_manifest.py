"""The manifest against the benchmark's own rules, and a cell added as
files only."""
from __future__ import annotations

import json

from conftest import ROOT, execute

from bench.harness import manifest


def test_manifest_is_sound():
    man = manifest.load_manifest(ROOT)
    assert manifest.validate(man, ROOT) == []


def test_names_and_units_use_allowed_characters():
    man = manifest.load_manifest(ROOT)
    for m in man["end_to_end"] + man["per_layer"]:
        assert manifest.NAME.match(m["name"]), m["name"]
        assert manifest.UNIT.match(m["unit"]) and len(m["unit"]) <= 16
    for w in man["workloads"]:
        assert manifest.NAME.match(w["name"])
        cell = manifest.load_cell(ROOT, w["name"])
        assert cell.config["registry"] and cell.mix["kind"]


def test_every_cell_reports_what_its_metrics_move():
    man = manifest.load_manifest(ROOT)
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        for cell in m["workloads"]:
            assert manifest.reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_validate_finds_a_broken_manifest():
    man = manifest.load_manifest(ROOT)
    decode = next(m for m in man["per_layer"]
                  if m["name"] == "decode_step_ms")
    decode["moves"] = "ttft_p95_ms"   # not reported by the MoE cell
    man["workloads"][0]["traffic"] = "no such mix"
    errs = manifest.validate(man, ROOT)
    assert any("does not report ttft_p95_ms" in e for e in errs)
    assert any("no such mix" in e for e in errs)


def test_a_dummy_cell_added_as_files_only(tiny_root):
    """A configuration, a traffic mix, a per-layer metric and a limit,
    each a new file, and new manifest entries: the harness runs the new
    cell and reports the new metric, with no file of the harness
    edited."""
    bench = tiny_root / "bench"
    (bench / "metrics" / "dummy_tokens.py").write_text(
        "def read(run):\n    return float(run.e2e['tokens'])\n")
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "tiny-dense.dummy",
                             "config": "tiny-dense", "traffic": "dummy",
                             "chips": 1, "why": "a cell added as files"})
    mix = json.loads((bench / "traffic" / "tiny-serve.json").read_text())
    mix["clients"] = mix["max_slots"] = 2
    (bench / "traffic" / "dummy.json").write_text(json.dumps(mix))
    (bench / "limits" / "tiny-dense.dummy.json").write_text(
        json.dumps({"sample_tokens": 100,
                    "limits": {"logit_gap": {"limit": 0.05}}}))
    for m in man["end_to_end"]:
        if m["name"] in ("output_tok_s", "itl_p95_ms"):
            m["workloads"].append("tiny-dense.dummy")
    man["per_layer"].append({
        "name": "dummy_tokens", "unit": "tokens", "better": "higher",
        "source": "host_clock", "layer": "engine and scheduler",
        "moves": "output_tok_s", "workloads": ["tiny-dense.dummy"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.validate(man, tiny_root, bench) == []
    res, _ = execute(tiny_root, "tiny-dense.dummy", trace=False)
    assert set(res["metrics"]) == {"output_tok_s", "itl_p95_ms", "setup_s"}
    assert res["correct"] is True
    res, _ = execute(tiny_root, "tiny-dense.dummy", trace=True)
    assert res["metrics"]["dummy_tokens"]["value"] > 0


def test_a_mix_key_nothing_reads_is_refused(tiny_root):
    """A traffic mix may not carry a key the generator would not read:
    an open loop asked of the closed-loop harness fails, not runs."""
    import pytest
    bench = tiny_root / "bench"
    mix = json.loads((bench / "traffic" / "tiny-serve.json").read_text())
    (bench / "traffic" / "tiny-serve.json").write_text(
        json.dumps(dict(mix, loop="open")))
    man = manifest.load_manifest(tiny_root)
    assert any("unknown key 'loop'" in e
               for e in manifest.validate(man, tiny_root, bench))
    with pytest.raises(ValueError, match="loop"):
        manifest.load_cell(tiny_root, "tiny-dense.serve", bench)


def test_config_is_read_as_the_program_runs_it():
    """The MoE's file holds the published routing; the harness and the
    reference read the port's departures in its place."""
    man = manifest.load_manifest(ROOT)
    conf = next(c for c in man["configs"] if c["name"] == "qwen2-moe-a2.7b")
    doc = json.loads((ROOT / conf["file"]).read_text())
    assert doc["norm_topk_prob"] is False and "capacity_factor" not in doc
    cfg = manifest.load_cell(ROOT, "qwen2-moe-a2.7b.chat64").config
    assert cfg["norm_topk_prob"] is True and cfg["capacity_factor"] == 1.25
    assert all(c["reduced"] == [] for c in man["configs"])
