#!/usr/bin/env python3
"""Sweep the attention kernels' and the scan's tile parameters on one
NVIDIA GPU:

    python3 tools/attention_sweep.py [--flash-tiles 64,2,32,2 32,3,32,3]
                                     [--flash-seqs 64 128 256 512]
                                     [--decode-chunks 32 64 128 576]
                                     [--scan-tiles 8,8,4,8 16,4,8,4]

``--flash-tiles``: each variant is ``BK128,NS128,BK256,NS256``, the KV
rows a tile and the tiles in the ring of the tensor-core flash body's
two instantiations (``Tile<128>`` and ``Tile<256>`` in
``src/repro_torch/csrc/flash_attention.cu``). Every variant is a copy of
that source with those two lines changed, built with the same ``nvcc``
flags into ``build/sweep/`` (all at once), bound in place of the
library the wrapper loads, and timed with ``chip_smoke.py``'s own
functions at the fifo and batch prefills, the prefix resume and the
training shape; its registers come from ``-Xptxas -v``.

``--flash-seqs``: flash at the fifo prefill's heads over prompt
lengths, inputs rotated over twice the L2 and L2-resident, with SDPA.

``--decode-chunks``: slotted decode at the fifo step's shape (B=8, S=552,
12/2 heads of 128, bf16) called with each number of rows a split walks,
the device time of its partial and combine kernels taken from
``torch.profiler``; the inputs stay in the L2, so this is the kernels'
latency, not their bytes.

``--scan-tiles``: each variant is ``FWD_ROWS,FWD_WARPS,BWD_ROWS,
BWD_WARPS`` of the chunked RG-LRU scan (rows a thread walks, warps a
CTA; a chunk is their product), a copy of ``csrc/rglru_scan.cu`` with
that line changed, built as the flash variants are and timed with
``chip_smoke.time_scan`` forward and reverse at the training shape
(B=1, S=4096, D=4096, fp32), with its registers and spills.

Prints one JSON line per variant or chunk.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
TILE = re.compile(r"template <> struct Tile<(128|256)> \{ static constexpr int "
                  r"BK = \d+, NS = \d+; \};")


SCAN_TILE = re.compile(r"constexpr int FWD_ROWS = \d+, FWD_WARPS = \d+, "
                       r"BWD_ROWS = \d+, BWD_WARPS = \d+;")


def build_variants(build, name, texts):
    """One shared library per variant source text, built all at once
    into ``build/sweep/``; returns [(path, registers and spills)]."""
    out = ROOT / "build" / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, text in enumerate(texts):
        cu, so = out / f"{name}_v{i}.cu", out / f"lib{name}_v{i}.so"
        cu.write_text(text)
        log = open(out / f"{name}_v{i}.log", "w")
        procs.append((so, log, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=log, stderr=subprocess.STDOUT)))
    built = []
    for so, log, proc in procs:
        if proc.wait():
            raise RuntimeError(f"nvcc failed: {Path(log.name).read_text()}")
        log.close()
        regs = [ln.split(":")[-1].strip()
                for ln in Path(log.name).read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        built.append((so, regs))
    return built


def build_flash_variants(build, variants):
    """One shared library per (bk128, ns128, bk256, ns256); returns
    [(path, registers)]."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert len(TILE.findall(src)) == 2, "Tile<128> and Tile<256> lines"
    texts = []
    for b1, n1, b2, n2 in variants:
        tiles = {"128": (b1, n1), "256": (b2, n2)}
        texts.append(TILE.sub(lambda m: (
            f"template <> struct Tile<{m.group(1)}> {{ static constexpr int "
            f"BK = {tiles[m.group(1)][0]}, NS = {tiles[m.group(1)][1]}; }};"),
            src))
    return build_variants(build, "flash", texts)


def bind(build, so, names):
    """Put the entries ``names`` of the library ``so`` in place of the
    ones the wrappers load."""
    lib = ctypes.CDLL(str(so))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = build.SIGNATURES[name][1]
        fn.restype = ctypes.c_int
        build._entries[name] = fn


def sweep_flash(torch, cs, build, variants) -> None:
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    for (so, regs), v in zip(build_flash_variants(build, variants), variants):
        bind(build, so, ["flash_attention_fwd"])
        ms = {p: cs.time_flash(torch, ops, ref, rnd, b)
              for p, b in cs.SERVE_FA.items()}
        ms["prefix"] = cs.time_flash_extend(torch, ops, ref, rnd,
                                            cs.SERVE_EXT["prefix"])
        ms["train"] = cs.time_flash_train(torch, ops, ref, rnd)
        print(json.dumps({
            "flash_tiles": v, "registers": regs,
            "ms": {p: m["ms"] for p, m in ms.items()},
            "max_abs_err": {p: m["max_abs_err"] for p, m in ms.items()}}),
            flush=True)
    build._entries.pop("flash_attention_fwd", None)


SCAN_ENTRIES = ["rglru_scan_workspace", "rglru_scan_fwd", "rglru_scan_bwd"]


def sweep_scan(torch, cs, build, variants) -> None:
    """Each (FWD_ROWS, FWD_WARPS, BWD_ROWS, BWD_WARPS) of the chunked
    scan: a copy of ``csrc/rglru_scan.cu`` with that line changed, timed
    with ``chip_smoke.time_scan`` forward and reverse at the training
    shape."""
    from repro_torch.kernels.rglru_scan import ops, ref
    src = (build.CSRC / "rglru_scan.cu").read_text()
    assert len(SCAN_TILE.findall(src)) == 1, "the FWD_ROWS ... line"
    texts = [SCAN_TILE.sub(
        f"constexpr int FWD_ROWS = {fr}, FWD_WARPS = {fw}, BWD_ROWS = {br}, "
        f"BWD_WARPS = {bw};", src) for fr, fw, br, bw in variants]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    for (so, regs), v in zip(build_variants(build, "scan", texts), variants):
        bind(build, so, SCAN_ENTRIES)
        ops._workspace_bytes.cache_clear()
        ms = {p: cs.time_scan(torch, ops, ref, rnd, reverse=p == "reverse")
              for p in ("forward", "reverse")}
        print(json.dumps({
            "scan_tiles": v, "registers": regs,
            "ms": {p: m["ms"] for p, m in ms.items()},
            "bound_ms": {p: m["bound_ms"] for p, m in ms.items()},
            "max_abs_err": {p: m["max_abs_err"] for p, m in ms.items()}}),
            flush=True)
    for name in SCAN_ENTRIES:
        build._entries.pop(name, None)
    ops._workspace_bytes.cache_clear()


def sweep_flash_seq(torch, cs, seqs) -> None:
    """Flash at the fifo prefill's heads (B=1, 12/2 heads of 128, bf16,
    causal) over prompt lengths: the longest q-tile walks S / 64 KV
    tiles, so the slope is one CTA's time a tile. Inputs rotated over
    twice the L2 and, apart, one L2-resident copy; SDPA beside."""
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    for s in seqs:
        nbytes = 2 * (2 * s * 12 * 128 + 2 * s * 2 * 128)
        copies = [tuple(torch.randn(shape, generator=gen, device="cuda")
                        .to(torch.bfloat16) for shape in
                        ((1, s, 12, 128), (1, s, 2, 128), (1, s, 2, 128)))
                  for _ in range(cs.n_copies(nbytes))]
        bhsd = [tuple(t.transpose(1, 2).contiguous() for t in c)
                for c in copies]
        nxt, nxt_l = cs.cycle(copies), cs.cycle(bhsd)
        print(json.dumps({
            "flash_seq": s,
            "ms": cs.cuda_ms(torch, lambda: ops.flash_attention(*nxt())),
            "ms_l2": cs.cuda_ms(torch, lambda: ops.flash_attention(
                *copies[0])),
            "sdpa_ms": cs.cuda_ms(torch, lambda: cs.sdpa(*nxt_l(),
                                                         causal=True))}),
            flush=True)


def sweep_decode(torch, cs, build, chunks) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, hk, d, s = 8, 12, 2, 128, cs.SERVE_S
    bf = torch.bfloat16
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(bf)
    kc = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(bf)
    vc = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(bf)
    lens = torch.tensor(cs.FIFO_LENS, dtype=torch.int32, device="cuda")
    want = ref.decode_attention_ref(q, kc, vc, lens).float()
    fn = build.entry("decode_attention_fwd")
    for chunk in chunks:
        nsplit = -(-s // chunk)
        pm = torch.empty((b, hk, nsplit, h // hk), device="cuda")
        pl = torch.empty_like(pm)
        pacc = torch.empty((b, hk, nsplit, h // hk, d), device="cuda")
        o = torch.empty_like(q)

        def call():
            code = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                      lens.data_ptr(), pm.data_ptr(), pl.data_ptr(),
                      pacc.data_ptr(), o.data_ptr(), None, None, b, s, h,
                      hk, d, chunk,
                      d ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
            build.check(code, "decode_attention")
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        err = (o.float() - want).abs().max().item()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        us = {("partial" if "partial" in e.key else "combine"):
              e.device_time_total / e.count
              for e in prof.key_averages() if e.device_time_total}
        print(json.dumps({"decode_chunk": chunk, "splits": nsplit,
                          "device_us": us, "max_abs_err": err}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flash-tiles", nargs="*", default=[],
                    help="variants BK128,NS128,BK256,NS256")
    ap.add_argument("--flash-seqs", nargs="*", type=int, default=[])
    ap.add_argument("--decode-chunks", nargs="*", type=int, default=[])
    ap.add_argument("--scan-tiles", nargs="*", default=[],
                    help="variants FWD_ROWS,FWD_WARPS,BWD_ROWS,BWD_WARPS")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: this sweep needs an NVIDIA GPU")
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.flash_tiles:
        sweep_flash(torch, cs, _build, [tuple(int(x) for x in v.split(","))
                                        for v in args.flash_tiles])
    if args.flash_seqs:
        sweep_flash_seq(torch, cs, args.flash_seqs)
    if args.decode_chunks:
        sweep_decode(torch, cs, _build, args.decode_chunks)
    if args.scan_tiles:
        sweep_scan(torch, cs, _build, [tuple(int(x) for x in v.split(","))
                                       for v in args.scan_tiles])
    return 0


if __name__ == "__main__":
    sys.exit(main())
