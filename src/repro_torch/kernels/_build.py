"""Build and bind the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source ``repro_torch/csrc/<name>.cu`` becomes
``build/repro_torch/lib<name>-<hash>.so`` under the repository root, where
``<hash>`` covers the source and the flags: a library is built at first
use and again only when its source changes. ``build_all()`` starts one
``nvcc`` per missing library, all at once. Nothing here runs at import
time, so the package imports on machines without ``nvcc`` or a card.

Thread-safe: a serving engine's drain thread and a server's warmup may
be the first to reach a kernel, so ``entry`` and ``build_all`` run under
one lock, each build writes a temporary library named for its process
and thread, and ``count_launch`` / ``reset_launches`` keep the
wrappers' ``.launches`` counters (and ``decode_attention``'s
``.lse_launches``) exact across threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> (source stem, argtypes); every one returns a
# cudaError_t code as int
SIGNATURES: Dict[str, Tuple[str, List]] = {
    "flash_attention_fwd": ("flash_attention",
                            [_P] * 7 + [_I] * 8 + [_F, _I, _P]),
    "decode_attention_fwd": ("decode_attention",
                             [_P] * 10 + [_I] * 6 + [_F, _I, _P]),
    "paged_decode_attention_fwd": ("decode_attention",
                                   [_P] * 9 + [_I] * 7 + [_F, _I, _P]),
    "rglru_scan_workspace": ("rglru_scan",
                             [_I] * 4 + [ctypes.POINTER(_L)]),
    "rglru_scan_fwd": ("rglru_scan", [_P] * 5 + [_L] + [_I] * 3 + [_P]),
    "rglru_scan_bwd": ("rglru_scan", [_P] * 8 + [_L] + [_I] * 3 + [_P]),
}

_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}
# guards building, loading and binding (re-entrant: entry builds)
_lock = threading.RLock()
# guards the wrappers' launch counters
_count_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(stem: str) -> Path:
    h = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{h}.so"


def build_all(stems: Optional[List[str]] = None) -> Dict[str, float]:
    """Build every missing library in parallel; returns seconds per
    library built (empty when all were cached). The compiler's output,
    ``-Xptxas -v`` register and shared-memory counts included, is kept
    beside each library as ``.log``."""
    with _lock:
        return _build_all(stems)


def _build_all(stems: Optional[List[str]]) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in (stems or sources()) if not lib_path(s).exists()]
    procs = []
    for stem in todo:
        out = lib_path(stem)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs.append((stem, tmp, log, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    times, failed = {}, []
    for stem, tmp, log, t0, proc in procs:
        rc = proc.wait()
        log.close()
        times[stem] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, lib_path(stem))
        else:
            failed.append(stem)
    if failed:
        logs = "\n".join(lib_path(s).with_suffix(".log").read_text()
                         for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return times


def entry(name: str):
    """The C function ``name`` with its argtypes bound, building its
    library first when needed."""
    fn = _entries.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _entries.get(name)
        if fn is not None:
            return fn
        stem, argtypes = SIGNATURES[name]
        lib = _loaded.get(stem)
        if lib is None:
            build_all([stem])
            lib = ctypes.CDLL(str(lib_path(stem)))
            _loaded[stem] = lib
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
        return fn


def count_launch(wrapper, also: str = "") -> None:
    """Add one to ``wrapper.launches``, and to ``wrapper.<also>`` where
    given (a counter of one kind of its launches): called by a wrapper
    where it launches its kernel, and nowhere else."""
    with _count_lock:
        wrapper.launches += 1
        if also:
            setattr(wrapper, also, getattr(wrapper, also) + 1)


# counters of one kind of a wrapper's launches, beside ``launches``
KIND_COUNTERS = ("lse_launches",)


def reset_launches(*wrappers) -> None:
    """Set the launch counters of ``wrappers`` to 0, those of one kind
    of their launches too."""
    with _count_lock:
        for w in wrappers:
            w.launches = 0
            for name in KIND_COUNTERS:
                if hasattr(w, name):
                    setattr(w, name, 0)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")
