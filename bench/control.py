"""Readings that set a cell's correctness limits, on the chip, in one
process: for each seed, the cell's own set-up and a window at its own
load, then the numbers the cell compares, of the program and of the
control (the reference computed in fake fp8): for a serving cell every
number ``serve.gap_stats`` gives of the served tokens' logit gaps
against the fp32 reference, and the same of the tokens the fake-fp8
reference ranks first, with every per-token gap; for a training cell
its three numbers, and with ``--half`` those of the half-batch fault.
Each line also says whether the cell's own comparison (``main.checks``)
judges the program's numbers correct (``correct``) and the control's,
put in the program's place (``control_correct``).

    python bench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

prints one JSON line per seed. The benchmark's own runs never run the
control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from bench.harness import main as H  # noqa: E402
from bench.harness import manifest  # noqa: E402


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true",
                    help="the program's readings alone")
    ap.add_argument("--witness", action="store_true",
                    help="also the reference with its products rounded "
                         "to bf16")
    ap.add_argument("--half", action="store_true",
                    help="training: also the reference with half of each "
                         "batch left out (a planted fault)")
    args = ap.parse_args(argv)
    root = manifest.BENCH.parent
    H.environment(root)
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    from bench.harness import serve, train
    cell = manifest.load_cell(root, args.workload)
    runner = serve if cell.mix["kind"] == "serve" else train
    quants = (None,) if args.no_control else (None, "fp8")
    if args.witness:
        quants += ("bf16",)
    if args.half:
        quants += ("half",)
    for seed in args.seeds:
        t = time.perf_counter()
        r = runner.run(cell, seed, args.seconds, False, "cuda", t,
                      lambda m: print(m, file=sys.stderr), quants=quants)
        judged = {"correct": H.checks(cell, r.check)[0]}
        if not args.no_control:
            judged["control_correct"] = H.checks(
                cell, H.control_readings(r.check))[0]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **r.check, **judged, "attempted": r.attempted,
                          "failed": r.failed,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
