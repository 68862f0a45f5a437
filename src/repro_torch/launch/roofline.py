"""The roofline table of the port's dry run: reads the records that
``python -m repro_torch.launch.dryrun`` writes and prints, per arch x
shape, the one-card bounds and the per-device bytes on the pod meshes.
The counterpart of ``benchmarks/roofline.py`` + ``benchmarks/make_table.py``;
it reads counts, measures nothing, and is no benchmark.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir build/dryrun]

t_compute and t_memory are bounds from published H100 SXM peaks (989
TFLOP/s bf16, 67 fp32, 3.35 TB/s), never times.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Tuple

from repro_torch.launch.dryrun import OUTDIR


def load_all(path: str = OUTDIR) -> Dict[Tuple[str, str, str], Dict]:
    """(arch, shape, mesh name) -> record, for every record in ``path``."""
    out = {}
    for name in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(name) as fh:
            r = json.load(fh)
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def fmt_s(sec: float) -> str:
    if sec >= 1:
        return f"{sec:.2f} s"
    if sec >= 1e-3:
        return f"{sec * 1e3:.1f} ms"
    return f"{sec * 1e6:.0f} us"


def device_gb(r: Dict) -> float:
    """Parameters and (decode) cache each device holds, GB."""
    return (r["param_bytes_per_device"]
            + r.get("cache_bytes_per_device", 0)) / 1e9


def table(data: Dict[Tuple[str, str, str], Dict]) -> str:
    """The markdown table of the one-card records, with the pod meshes'
    per-device GB where their records exist."""
    lines = ["| arch | shape | t_compute | t_memory | bottleneck | useful | "
             "resident GB | fits 80 GB | GB/dev 16x16 | GB/dev 2x16x16 |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(data.items()):
        if m != "h100":
            continue
        pods = [data.get((a, s, mesh)) for mesh in ("16x16", "2x16x16")]
        uf = r.get("useful_flops_ratio")
        lines.append(
            f"| {a} | {s} | {fmt_s(r['t_compute_s'])} | "
            f"{fmt_s(r['t_memory_s'])} | {r['bottleneck'].split('_')[1]} | "
            f"{'-' if uf is None else f'{uf:.2f}'} | "
            f"{r['resident_bytes'] / 1e9:.1f} | "
            f"{'Y' if r['fits_80gb'] else 'N'} | "
            + " | ".join("-" if p is None else f"{device_gb(p):.2f}"
                         for p in pods) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=OUTDIR,
                    help="the dry run's records (its --outdir)")
    args = ap.parse_args(argv)
    data = load_all(args.dir)
    if not data:
        raise SystemExit(f"no dry-run records in {args.dir}; run "
                         f"python -m repro_torch.launch.dryrun first")
    print(table(data))


if __name__ == "__main__":
    main()
