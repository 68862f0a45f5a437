"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<name>`` of ``workloads`` names a configuration (its file is
the configuration's ``file``), a traffic mix (``traffic/<mix>.json``
beside this package), and through ``per_layer`` the metric readers
(``metrics/<metric>.py``) it reports. The limits of its correctness
comparison, and for a serving cell the served tokens its sample holds,
sit in ``limits/<cell>.json``.

A configuration file holds the published configuration under its
published keys, and under ``program`` the values the port runs where it
departs from them; the harness and the reference read the two merged
(``as_run``). A traffic mix holds only the keys of its kind
(``MIX_KEYS``): one the generator would not read is refused, not
ignored.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# the keys a traffic mix of each kind holds, every one of them read: a
# serving mix is a closed loop of ``clients`` over ``max_slots`` slots
MIX_KEYS = {
    "serve": {"kind", "clients", "max_slots", "max_len", "prompt",
              "output"},
    "train": {"kind", "sequences", "seq_len", "microbatches", "optimizer",
              "check_steps"}}


@dataclass
class Cell:
    """One workload entry with everything it names, loaded."""
    name: str
    spec: Dict
    config: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    sample_tokens: int = 0


def as_run(doc: Dict) -> Dict:
    """A configuration file's keys as the port runs them: the published
    ones, with the ``program`` group's departures in their place."""
    return {**doc, **doc.get("program", {})}


def mix_errors(name: str, mix: Dict) -> List[str]:
    """What in a traffic mix the generator would not read, or misses."""
    keys = MIX_KEYS.get(mix.get("kind"))
    if keys is None:
        return [f"traffic {name}: kind {mix.get('kind')!r}"]
    return ([f"traffic {name}: unknown key {k!r}"
             for k in sorted(set(mix) - keys)]
            + [f"traffic {name}: no {k!r}" for k in sorted(keys - set(mix))])


def load_manifest(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: Dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed under the
    metric's ``workloads``, or the metric has none."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of the manifest at ``root``, with its files
    read from ``bench`` (the benchmark's folder)."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    spec = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    conf = configs[spec["config"]]
    config = as_run(json.loads((root / conf["file"]).read_text()))
    mix = json.loads((bench / "traffic" / f"{spec['traffic']}.json")
                     .read_text())
    errs = mix_errors(spec["traffic"], mix)
    if errs:
        raise ValueError("; ".join(errs))
    lim_path = bench / "limits" / f"{name}.json"
    lim = json.loads(lim_path.read_text()) if lim_path.exists() else {}
    return Cell(name, spec, config, mix, lim.get("limits", {}),
                [m for m in man["end_to_end"] if reports(m, name)],
                [m for m in man["per_layer"] if reports(m, name)],
                int(lim.get("sample_tokens", 0)))


def validate(man: Dict, root: Path, bench: Path = BENCH) -> List[str]:
    """What in the manifest breaks the benchmark's own rules: names and
    units of allowed characters, every file a cell names found, every
    per-layer metric's cells reporting the end-to-end metric it moves,
    and a reader for every per-layer metric. Empty when sound."""
    errs: List[str] = []
    names = ([m["name"] for m in man["end_to_end"] + man["per_layer"]]
             + [w["name"] for w in man["workloads"]]
             + [c["name"] for c in man["configs"]])
    for n in names:
        if not NAME.match(n):
            errs.append(f"name {n!r} has characters a name may not have")
    if len(set(names)) != len(names):
        errs.append("two entries share a name")
    for m in man["end_to_end"] + man["per_layer"]:
        if not UNIT.match(m["unit"]):
            errs.append(f"{m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"{m['name']}: better {m['better']!r}")
    configs = {c["name"]: c for c in man["configs"]}
    for c in man["configs"]:
        if not (root / c["file"]).exists():
            errs.append(f"config {c['name']}: no file {c['file']}")
        for k in c["reduced"]:
            if not NAME.match(k):
                errs.append(f"config {c['name']}: reduced key {k!r}")
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                errs.append(f"{w['name']}: {key} {w[key]!r}")
        if w["config"] not in configs:
            errs.append(f"{w['name']}: no config {w['config']!r}")
        mix_path = bench / "traffic" / f"{w['traffic']}.json"
        if not mix_path.exists():
            errs.append(f"{w['name']}: no traffic file for {w['traffic']!r}")
        else:
            errs += mix_errors(w["traffic"], json.loads(mix_path.read_text()))
        mine = [m for m in man["end_to_end"] if reports(m, w["name"])]
        if "setup_s" not in [m["name"] for m in mine] or len(mine) < 2:
            errs.append(f"{w['name']}: reports setup_s and no other "
                        f"end-to-end metric")
        if not any(reports(m, w["name"]) for m in man["per_layer"]):
            errs.append(f"{w['name']}: reports no per-layer metric")
    for m in man["per_layer"]:
        if m["moves"] not in e2e:
            errs.append(f"{m['name']}: moves unknown {m['moves']!r}")
            continue
        for w in man["workloads"]:
            if reports(m, w["name"]) and not reports(e2e[m["moves"]],
                                                     w["name"]):
                errs.append(f"{m['name']}: cell {w['name']} does not "
                            f"report {m['moves']}")
        if not (bench / "metrics" / f"{m['name']}.py").exists():
            errs.append(f"{m['name']}: no reader metrics/{m['name']}.py")
    return errs
