"""Quickstart on the port: the Edge-PRUNE workflow end to end.

1. Express an application (the paper's vehicle-classification CNN) as a
   VR-PRUNE dataflow graph, its actors firing torch code on ``--device``.
2. Check it against the design rules (Analyzer).
3. Explore every endpoint/server partition point (Explorer) on the
   paper's calibrated N2-i7 platform: modeled times of the paper's
   devices, not a measurement of this one.
4. Synthesize the best privacy-preserving mapping into a staged program
   (TX/RX channels auto-inserted) and run real inference through it.
5. Serve an LLM workload through the ``repro_torch.serving`` surface:
   submit, stream tokens, get a ``Completion``.

The counterpart of ``examples/quickstart.py``. ``main`` returns the
Explorer's records, the chosen partition point, the class
probabilities and the streamed tokens.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (Explorer, Mapping, analyze, paper_platform,
                              synthesize)
from repro_torch.models import transformer as T
from repro_torch.models.cnn import vehicle_graph
from repro_torch.models.config import ModelConfig
from repro_torch.serving import Engine, EngineConfig, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = T.resolve_device(args.device)

    # 1. the application graph (actors = layer groups, edges = token FIFOs)
    g = vehicle_graph(device=dev)
    print(f"graph: {g}")
    for f in g.fifos.values():
        print(f"  edge {f.name}: token {f.token_bytes} B")

    # 2. consistency: deadlock/buffer-overflow freedom per VR-PRUNE rules
    report = analyze(g)
    print(f"analyzer: ok={report.ok} repetitions={report.repetition_vector}")

    # 3. partition-point exploration on the calibrated paper platform
    explorer = Explorer(g, paper_platform("N2", "ethernet"))
    result = explorer.evaluate_modeled()
    for rec in result.records:
        print(f"  pp{rec.pp}: endpoint {rec.endpoint_time_s*1e3:6.2f} ms, "
              f"boundary {rec.boundary_bytes} B")
    best = result.best(privacy=True)
    print(f"best privacy-preserving partition: pp{best.pp} "
          f"({best.endpoint_time_s*1e3:.1f} ms — paper: pp3, 14.9 ms)")

    # 4. synthesize + execute the chosen mapping
    mapping = Mapping.partition_point(g, best.pp)
    prog = synthesize(g, mapping)
    print(f"stages: {[s.unit for s in prog.stages]}, "
          f"channels: {[c.name for c in prog.channels]}")
    img = np.random.RandomState(0).rand(96, 96, 3).astype(np.float32)
    out = prog.run_local({"Input": torch.from_numpy(img).to(dev)})
    probs = out["L4-L5"][0].cpu().numpy()
    print(f"class probabilities: {probs.round(3)}")

    # 5. LLM serving through the repro_torch.serving surface: one Engine,
    # policy-configured (here the continuous scheduler, defaults); submit
    # returns a handle you can stream token by token
    cfg = ModelConfig(
        name="quickstart-tiny", arch_type="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
        param_dtype="float32", attn_chunk=16, remat=False)
    eng = Engine(cfg, T.init_params(cfg, 0, device=dev),
                 EngineConfig(max_len=48, max_slots=2), device=dev)
    prompt = np.random.RandomState(1).randint(0, 256, 16).astype(np.int32)
    handle = eng.submit(Request(id=0, prompt=prompt, max_new_tokens=8))
    streamed = list(handle.stream())        # pulls the engine step by step
    print(f"served {len(streamed)} tokens ({handle.finish_reason}): "
          f"{streamed}")
    return {"records": [(r.pp, r.endpoint_time_s, r.boundary_bytes)
                        for r in result.records],
            "best_pp": best.pp, "probs": probs, "tokens": streamed,
            "finish_reason": handle.finish_reason}


if __name__ == "__main__":
    main()
