"""End-to-end training on the port: train a small decoder LM for a few
hundred steps on the synthetic bigram LM stream and show the loss
dropping toward the process entropy; finish with a checkpoint, a restore
into a fresh model (equal bit for bit) and a greedy sample through the
``batch`` admission.

The counterpart of ``examples/train_small.py``: the same config, stream,
optimizer settings and sampling prompt. ``main`` returns the first and
last losses, whether the model learned (last < 0.8 x first, the
reference's "LEARNED"), whether the restore is exact, and the tokens.

Run: PYTHONPATH=src python examples/torch_train_small.py [--steps 300] [--device cpu]
(Use --d-model 768 --layers 12 for a ~100M-param run.)
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import checkpoint, data, optim
from repro_torch.runtime.trainstep import make_train_step
from repro_torch.serving import Engine, EngineConfig, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = T.resolve_device(args.device)

    cfg = ModelConfig(
        name="train-small", arch_type="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=max(args.d_model // 32, 2),
        n_kv_heads=max(args.d_model // 64, 1), d_ff=args.d_model * 4,
        vocab_size=512, dtype="float32", param_dtype="float32",
        attn_chunk=32, remat=False)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens")

    model = T.init_params(cfg, 0, device=dev, dtype=torch.float32)
    model.requires_grad_(True)
    opt = optim.init(model)
    oc = optim.AdamWConfig(lr=3e-3, warmup_steps=30, total_steps=args.steps,
                           weight_decay=0.01)
    step = make_train_step(cfg, oc)
    gen = data.lm_batches(args.batch, args.seq, cfg.vocab_size, seed=0)
    t0 = time.time()
    first = last = None
    for i, batch in zip(range(args.steps), gen):
        model, opt, m = step(model, opt, batch)
        loss = float(m["loss"])
        first = first if first is not None else loss
        last = loss
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {loss:.4f} "
                  f"({(time.time()-t0)/(i+1)*1e3:.0f} ms/step)")
    learned = last < first * 0.8
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if learned else 'no progress?'})")

    path = os.path.join(tempfile.gettempdir(), "torch_train_small.npz")
    checkpoint.save(path, model, meta={"steps": args.steps})
    restored = checkpoint.restore(path, T.Transformer(cfg, device=dev))
    exact = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  restored.parameters()))
    print(f"checkpoint round-trip {'bit for bit' if exact else 'DIFFERS'} "
          f"-> {path}")

    eng = Engine(cfg, restored, EngineConfig(max_len=args.seq + 16,
                                             admission="batch"), device=dev)
    prompt = next(data.lm_batches(1, 16, cfg.vocab_size, seed=9))["tokens"][0]
    out = eng.generate([Request(0, prompt, max_new_tokens=12)])[0]
    print(f"sampled continuation of trained model: {out.tokens}")
    return {"first": first, "last": last, "learned": learned,
            "restored_exact": exact, "tokens": list(out.tokens),
            "finish_reason": out.finish_reason}


if __name__ == "__main__":
    main()
