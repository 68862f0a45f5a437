"""The training window: ``runtime.trainstep.make_train_step`` with
AdamW over the port's fp32 master parameters.

Set-up builds one model (fp32 masters of the seed's weights), its
optimizer state and its step, and drives that same step through its
first ``check_steps`` steps, each on a batch of rows drawn from the seed
(``batch``), which the reference later follows. Then the window runs
further steps of the same objects, each ended by reading its loss, and
counts the steps that completed in it: the tokens of those steps over
the time from the window's start to the end of the last of them.

The comparison (``compare``) holds three numbers of the program against
the reference that followed the same first steps in fp32: the widest
gap of a step's loss, and, by the worst leaf, the gap between the
program's norm and the reference's of the first gradient as the
optimizer took it in (clipped; the program's worked out from its first
moment after one step) and of each parameter's change over the check
steps, each over the reference's norm of that leaf or of the median
leaf, whichever is larger. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the change.
"""
from __future__ import annotations

import gc
import hashlib
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from bench.harness import weights
from bench.harness.model import port_config
from bench.yardstick import flops as Y


def batch(mix: Dict, vocab: int, seed: int, step: int, device):
    """Step ``step``'s token rows (sequences, seq_len), drawn on the
    card from the seed: the same for the program and the reference."""
    import torch
    h = hashlib.sha256(f"{seed}/batch/{step}".encode()).digest()
    gen = torch.Generator(device=device).manual_seed(
        int.from_bytes(h[:8], "little") >> 1)
    return torch.randint(0, vocab, (int(mix["sequences"]),
                                    int(mix["seq_len"])),
                         generator=gen, device=device)


@dataclass
class TrainRun:
    setup_s: float
    window_s: float
    e2e: Dict
    attempted: int
    failed: int
    flops: int
    memory_peak: int
    trace: Optional[object] = None
    check: Dict = field(default_factory=dict)
    readings: Dict = field(default_factory=dict)
    kind: str = "train"


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> float:
    """The worst leaf's |program norm - reference norm| over the larger
    of the reference's norm of that leaf and of the median leaf."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def program_readings(model, opt_state, b1: float, first: bool) -> Dict:
    """Per-leaf norms of the program: after its first step the clipped
    gradient (its first moment over 1 - b1)."""
    import torch
    names = [n for n, _ in model.named_parameters()]
    if first:
        return {n: float(torch.linalg.vector_norm(m.float())) / (1 - b1)
                for n, m in zip(names, opt_state["m"])}
    return {}


def change_norms(model, cfg: Dict, seed: int) -> Dict[str, float]:
    """Per-leaf norm of each master's change from the seed's weights,
    the initial weights drawn again group by group."""
    import torch
    out = {}
    params = dict(model.named_parameters())
    dev = next(model.parameters()).device
    for g in weights.top_leaves(cfg):
        p0 = weights.draw_top(cfg, seed, g, dev).float()
        out[g] = float(torch.linalg.vector_norm(params[g].detach() - p0))
    for i in range(cfg["num_hidden_layers"]):
        for n, t in weights.draw_layer(cfg, seed, i, dev).items():
            name = f"layers.{i}.{n}"
            out[name] = float(torch.linalg.vector_norm(
                params[name].detach() - t.float()))
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_proc: float, log, quants=(None,)) -> TrainRun:
    import torch

    from bench.harness import trace as TR
    from repro_torch.models import transformer as T
    from repro_torch.runtime import optim
    from repro_torch.runtime.trainstep import make_train_step
    cfg, mix = cell.config, cell.mix
    pcfg = port_config(cfg)
    vocab, n_seq, s_len = cfg["vocab_size"], int(mix["sequences"]), \
        int(mix["seq_len"])
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    model = T.Transformer(pcfg, device=device, dtype=torch.float32)
    weights.load_program(model, cfg, seed, masters=True)
    model.requires_grad_(True)
    opt_cfg = optim.AdamWConfig(**mix["optimizer"])
    step = make_train_step(pcfg, opt_cfg,
                           microbatches=int(mix["microbatches"]))
    opt = optim.init(model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    probes = None
    if trace:
        TR.Profile.warm(device)
        probes = TR.Probes()
        probes.install_kernels()
    k_check = int(mix["check_steps"])
    losses, grads = [], {}
    try:
        for k in range(k_check):
            tok = batch(mix, vocab, seed, k, device)
            model, opt, m = step(model, opt, {"tokens": tok, "labels": tok})
            losses.append(float(m["loss"]))
            if k == 0:
                grads = program_readings(model, opt, opt_cfg.b1, True)
        change = change_norms(model, cfg, seed)
        t0 = time.perf_counter()
        done, last, k = 0, t0, k_check
        prof, tries = None, 0
        while True:
            tok = batch(mix, vocab, seed, k, device)
            profiled = trace and prof is None and done >= 1
            if profiled:
                prof = TR.Profile(device)
                prof.start()
                probes.on = True
            model, opt, m = step(model, opt, {"tokens": tok, "labels": tok})
            float(m["loss"])
            now = time.perf_counter()
            if profiled:
                probes.on = False
                prof.stop()
                tries += 1
                if not prof.kernels_seen() and tries < TR.PROFILE_TRIES:
                    log("trace: the profile holds no kernel; profiling "
                        "the next step")
                    prof = None
            k += 1
            if now > t0 + seconds and (prof is not None or not trace):
                break
            done, last = done + 1, now
    finally:
        if probes is not None:
            probes.remove()
    setup_s = t0 - t_proc
    window = last - t0
    tokens = done * n_seq * s_len
    out = TrainRun(setup_s, window,
                   {"train_tok_s": tokens / window if done else None},
                   done, 0, done * Y.train_step_flops(cfg, n_seq, s_len),
                   torch.cuda.max_memory_allocated()
                   if device == "cuda" else 0)
    if trace and prof is not None:
        out.trace = TR.reduce(prof, probes)
        log(f"trace: one step, {len(probes.calls)} kernel calls probed, "
            f"{out.trace.linked} kernels linked, busy "
            f"{out.trace.busy_s:.4f} s of {out.trace.window_s:.4f} s")
    del model, opt, step, m, prof
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out.readings = {"loss": losses, "grad": grads, "change": change}
    t = time.perf_counter()
    out.check = compare(cfg, mix, seed, device, out.readings, quants)
    log(f"reference: {k_check} steps in {time.perf_counter() - t:.1f} s")
    return out


def reference_steps(cfg: Dict, mix: Dict, seed: int, device, quant=None,
                    half: bool = False) -> Dict:
    """The reference through the first ``check_steps`` steps: each
    step's loss, the per-leaf norms of the first clipped gradient and of
    each leaf's change over the steps (keyed by the port's names).
    ``half`` plants a fault: half of each batch left out, the mean taken
    over the rest."""
    import torch

    from bench.reference import qwen2 as R
    R.plain_fp32()
    names: List[str] = list(weights.top_leaves(cfg))
    top = {g: weights.draw_top(cfg, seed, g, device).float()
           .requires_grad_(True) for g in names}
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        by_port = weights.reference_layer_by_port_name(cfg, seed, i, device)
        layers.append({weights.reference_name(n): t.requires_grad_(True)
                       for n, t in by_port.items()})
        names += [f"layers.{i}.{n}" for n in by_port]
    leaves = list(top.values()) + [t for w in layers for t in w.values()]
    init = [t.detach().clone() for t in leaves]
    params = {"embed": top["embed"], "final_norm": top["final_norm"],
              "head": top.get("lm_head"), "layers": layers}
    opt = mix["optimizer"]
    state: Dict = {}
    losses, grad = [], {}
    n_seq, s_len = int(mix["sequences"]), int(mix["seq_len"])
    if half:
        n_seq //= 2
    count = n_seq * (s_len - 1)
    for k in range(int(mix["check_steps"])):
        tok = batch(mix, cfg["vocab_size"], seed, k, device)[:n_seq]
        for t in leaves:
            t.grad = None
        total = 0.0
        for row in tok:
            loss = R.sequence_loss(cfg, params, row, quant) / count
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        clipped = R.adamw(opt, leaves, state, k + 1)
        if k == 0:
            grad = {n: float(torch.linalg.vector_norm(g))
                    for n, g in zip(names, clipped)}
    change = {n: float(torch.linalg.vector_norm(t.detach() - t0))
              for n, t, t0 in zip(names, leaves, init)}
    return {"loss": losses, "grad": grad, "change": change}


def compare(cfg: Dict, mix: Dict, seed: int, device, prog: Dict,
            quants=(None,)) -> Dict:
    """The three numbers of ``prog``, and of the reference in each
    further variant of ``quants`` ("fp8" the control, computed in fake
    float8; "half" the half-batch fault), against the fp32 reference."""
    ref = reference_steps(cfg, mix, seed, device)
    med = statistics.median(ref["grad"].values())
    moved = {n for n, g in ref["grad"].items() if g >= 1e-3 * med}

    def numbers(x: Dict) -> Dict:
        return {"loss_gap": max(abs(a - b) for a, b in
                                zip(x["loss"], ref["loss"])),
                "grad_gap": _leaf_gap(x["grad"], ref["grad"]),
                "change_gap": _leaf_gap(x["change"], ref["change"], moved)}
    out = numbers(prog)
    for q in quants:
        if q == "half":
            out[q] = numbers(reference_steps(cfg, mix, seed, device,
                                             half=True))
        elif q is not None:
            out[q] = numbers(reference_steps(cfg, mix, seed, device, q))
    out["reference_loss"] = ref["loss"]
    return out
