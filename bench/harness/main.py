"""One run of one cell: set-up, window, comparison, result line.

``execute`` does the work and returns the result object and the lines
that close standard error; ``main`` is the command line: it refuses to
run without as many cards as the cell asks for (there is no fallback to
the CPU), refuses a result when JAX or the JAX package was loaded, and
prints the result object as the last line of standard output.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from bench.harness import manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start(fallback: float) -> float:
    """This process's start on the ``time.perf_counter`` clock, from
    ``/proc/self/stat`` (clock ticks since boot) and ``CLOCK_BOOTTIME``;
    ``fallback`` where those cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) \
            - start / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return fallback


def environment(root: Path) -> None:
    """The run's environment, set before torch is imported: fixed build
    and kernel-cache directories inside the checkout (the port builds
    its kernels into ``build/repro_torch`` there itself), no JAX for a
    library that would load it, few host threads, so that the host
    work of a run, which paces serving, varies less, and CUPTI torn
    down at each profile's stop: kept attached, as by default, it
    records the copies and no kernel in later profiles while another
    thread launches kernels (on the H100 with torch 2.11 and CUDA 12.8,
    21 and 54 of 60 profiles of 0.3 s; 0 of 180 torn down). The port
    captures no CUDA graph, which a teardown would break."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "4"
    os.environ["TEARDOWN_CUPTI"] = "1"


def loaded_forbidden() -> List[str]:
    """Modules of JAX or the JAX package in this process, by top-level
    name compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def reader(bench: Path, name: str):
    """The per-layer metric's reader, ``metrics/<name>.py``'s ``read``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def checks(cell: manifest.Cell, measured: Dict) -> Tuple[bool, Dict]:
    """Each number compared beside its limit (``limits/<cell>.json``);
    correct when there is at least one and each is within its limit."""
    out = {}
    ok = bool(cell.limits)
    for name, lim in cell.limits.items():
        value = measured.get(name)
        limit = lim["limit"]
        out[name] = {"value": value, "limit": limit}
        if value is None or value > limit:
            ok = False
    return ok, out


def control_readings(check: Dict) -> Dict:
    """The control's numbers in a run's readings (``bench/control.py``),
    under the names the program's go by, for ``checks`` to judge in the
    program's place: a serving check's ``fp8_<name>``, a training
    check's ``fp8``."""
    if "fp8" in check:
        return check["fp8"]
    return {k[len("fp8_"):]: v for k, v in check.items()
            if k.startswith("fp8_")}


def execute(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device: str = "cuda", t_proc: float = 0.0,
            bench: Path = manifest.BENCH, log=None) -> Tuple[Dict, List[str]]:
    """Run ``workload`` once; return (result object, closing stderr
    lines)."""
    import torch
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    cell = manifest.load_cell(root, workload, bench)
    kind = cell.mix["kind"]
    if kind == "serve":
        from bench.harness import serve as runner
    elif kind == "train":
        from bench.harness import train as runner
    else:
        raise ValueError(f"traffic kind {kind!r}")
    run = runner.run(cell, seed, seconds, trace, device, t_proc, log)
    metrics: Dict[str, Dict] = {}
    if trace:
        for m in cell.per_layer:
            v = reader(bench, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = run.setup_s if m["name"] == "setup_s" \
                else run.e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    ok, compared = checks(cell, run.check)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": int(cell.spec["chips"]),
           "memory_peak_bytes": int(run.memory_peak),
           "power_limit": power_limit() if device == "cuda" else None}
    result = {"correct": ok, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = compared
    lines = [f"check {n}: {c['value']} (limit {c['limit']})"
             for n, c in compared.items()]
    if not compared:
        lines = [f"check: none (no limits for {workload}; readings "
                 f"{json.dumps(run.check)})"]
    return result, lines


def main(argv=None, t_proc: float = 0.0) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = manifest.BENCH.parent
    t_proc = process_start(t_proc or time.perf_counter())
    environment(root)
    src = root / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import torch
    cell = manifest.load_cell(root, args.workload)
    need = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"bench: {args.workload} needs {need} CUDA card(s); this "
              f"machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no run, no result", file=sys.stderr)
        return 2
    result, lines = execute(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", t_proc)
    bad = loaded_forbidden()
    if bad:
        print(f"bench: the process loaded {bad}, which the benchmark's "
              f"program may not: no result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
