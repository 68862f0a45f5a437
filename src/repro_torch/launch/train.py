"""Training launcher of the port:

    python -m repro_torch.launch.train --arch <id> [--smoke] [--steps N]
        [--batch B] [--seq S] [--lr LR] [--microbatches M] [--ckpt PATH]
        [--log-every K] [--device cuda|cpu] [--data N --model M]

The counterpart of ``repro.launch.train``: fp32 master parameters from
``init_params`` (seed 0), AdamW with warmup over a tenth of the steps
and cosine decay, ``make_train_step`` with gradient accumulation over
``--microbatches``, the reference's ``lm_batches`` stream (with a
frontend config's stub inputs, ``with_frontend``), and the reference's
step line. Runs on the card unless ``--device cpu``.

``--data N --model M`` trains over an N x M mesh (ZeRO-3 over "data" x
tensor parallel over "model", ``runtime.trainstep``), one process a
rank, started by ``torchrun``::

    torchrun --standalone --nproc-per-node N*M -m repro_torch.launch.train \
        --arch recurrentgemma_9b --data 2 --model 2 ...

Every family trains so: an MoE config's experts go by expert over
"model" where their count divides it, else by their ff columns
(``models.moe``); an xLSTM block by heads where "model" divides them,
else whole on each rank (``models.ssm``); an encoder, the cross
attention and a frontend's projector by heads and columns. NCCL on the
cards (rank r on card
``LOCAL_RANK``), gloo with ``--device cpu``. Every rank builds the same
masters from the seed and keeps its shards; every rank draws the same
global batches and trains on its rows; rank 0 alone prints, and writes
``--ckpt`` (the gathered masters, the file an unsharded run writes).
``main(argv)`` parses the flags and calls ``run``, which ``chip_smoke.py``
also calls.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import checkpoint, data, optim
from repro_torch.runtime.trainstep import make_train_step
from repro_torch.sharding.rules import shard_params

DATA = {"lm": data.lm_batches, "copy": data.copy_task_batches}


def with_frontend(cfg: ModelConfig, batch: Dict) -> Dict:
    """A token batch with a frontend config's stub inputs, as the
    reference's CLI adds them: zero ``embeds`` of ``frontend_tokens``
    rows ahead of the tokens (vision; their labels -1) or one frame a
    token (audio, the encoder's source)."""
    b, s = batch["tokens"].shape
    if cfg.arch_type == "vlm":
        f = cfg.frontend_tokens
        return {**batch,
                "embeds": np.zeros((b, f, cfg.frontend_dim), np.float32),
                "labels": np.concatenate(
                    [np.full((b, f), -1, np.int32), batch["labels"]], 1)}
    if cfg.arch_type == "audio":
        return {**batch,
                "embeds": np.zeros((b, s, cfg.frontend_dim), np.float32)}
    return batch


def run(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
        lr: float = 1e-3, microbatches: int = 1, data_name: str = "lm",
        repeat: bool = False, ckpt: Optional[str] = None,
        log_every: int = 10, device="cuda", mesh=None,
        on_step: Optional[Callable[[int, Dict], None]] = None) -> Dict:
    """Train ``cfg`` for ``steps`` steps and print the reference's step
    lines. With ``mesh`` (``launch.mesh.make_debug_mesh``; every rank
    calls this) the model is cut into this rank's shards and trained by
    the sharded step, and rank 0 alone prints. ``data_name`` picks the
    synthetic stream (``"lm"``:
    ``lm_batches``; ``"copy"``: ``copy_task_batches``, cheap at any
    vocabulary); ``repeat`` trains every step on its first batch.
    ``on_step(i, metrics)`` is called after each step, with the step's
    metrics as floats (the device synchronised). Returns {"model",
    "metrics": [per step], "step_s": [per step, host clock around the
    synchronised step]}."""
    dev = T.resolve_device(device) if mesh is None else mesh.device
    say = print if mesh is None or not any(mesh.coords.values()) \
        else (lambda *a, **k: None)
    say(f"# arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
        f"params~{cfg.param_count()/1e6:.1f}M"
        + ("" if mesh is None else f" mesh={mesh.shape}"))
    model = T.init_params(cfg, 0, device=dev, dtype=torch.float32)
    if mesh is not None:
        model = shard_params(model, mesh)
    model.requires_grad_(True)
    opt = optim.init(model)
    oc = optim.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                           total_steps=steps)
    step = make_train_step(cfg, oc, mesh, microbatches=microbatches)
    gen = DATA[data_name](batch, seq, cfg.vocab_size)
    first = None
    history: List[Dict] = []
    step_s: List[float] = []
    t0 = time.time()
    for i in range(steps):
        if first is None or not repeat:
            first = with_frontend(cfg, next(gen))
        b = first
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ts = time.perf_counter()
        model, opt, m = step(model, opt, b)
        m = {k: float(v) for k, v in m.items()}     # waits for the device
        step_s.append(time.perf_counter() - ts)
        history.append(m)
        if on_step is not None:
            on_step(i, m)
        if i % log_every == 0 or i == steps - 1:
            say(f"step {i:5d} loss {m['loss']:.4f} "
                f"gnorm {m['grad_norm']:.3f} "
                f"lr {m['lr']:.2e} "
                f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if ckpt:
        checkpoint.save(ckpt, model,
                        meta={"arch": cfg.name, "steps": steps})
        say(f"# checkpoint -> {ckpt}")
    return {"model": model, "metrics": history, "step_s": step_s}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain path")
    ap.add_argument("--data", type=int, default=None,
                    help="ranks of the mesh's data axis (with --model; "
                         "one process a rank, under torchrun)")
    ap.add_argument("--model", type=int, default=None,
                    help="ranks of the mesh's model axis")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    mesh = None
    if args.data is not None or args.model is not None:
        import torch.distributed as dist
        if "RANK" in os.environ and not dist.is_initialized():
            mesh_lib.init_world_from_env(device=args.device)
        mesh = mesh_lib.make_debug_mesh(args.data or 1, args.model or 1,
                                        device=args.device)
    try:
        return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                   lr=args.lr, microbatches=args.microbatches,
                   ckpt=args.ckpt, log_every=args.log_every,
                   device=args.device, mesh=mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
