"""Edge-PRUNE partitioned serving on the port: a small decoder exported as
a VR-PRUNE actor graph, split between an "endpoint" and a "server" at
several partition points, and a stream of frames pipelined over the
split.

The partitioned path is the paper's collaborative-inference scenario:
the model's early layer-group actors run on the "endpoint" unit, the
rest on the "server"; synthesis inserts the TX/RX channel at the
boundary and the prefill runs stage by stage. In process the channel
hands the tensor on where it lies, so the partitioned logits equal the
monolithic ``forward``'s bit for bit, and the boundary bytes per frame
are what a deployment would send. The pipelined stream shows the modeled
win of overlapping stage k of frame i with stage k-1 of frame i+1 on the
paper's N2 / i7 devices over WiFi (modeled clocks, not this device's).

Run: PYTHONPATH=src python examples/torch_distributed_serving.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Mapping, PlatformModel, paper_platform
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving import PartitionedServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(
        name="serve-demo-60m", arch_type="dense", n_layers=6, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=4096,
        dtype="float32", param_dtype="float32", attn_chunk=64, remat=False)
    model = T.init_params(cfg, 0, device=args.device)
    print(f"model: {cfg.name}, ~{cfg.param_count() / 1e6:.1f}M params on "
          f"{model.device}")
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, cfg.vocab_size, (1, 48)).astype(np.int32)

    # --- Edge-PRUNE partitioned inference ----------------------------------
    g = T.to_actor_graph(cfg, batch=1, seq=48, group_size=2)
    names = list(g.actors)
    print(f"\nactor graph: {names}")
    with torch.no_grad():
        mono, _ = T.forward(model, cfg, {"tokens": torch.as_tensor(
            prompt, device=model.device)}, train=False)
    for pp in (2, 3, 4):
        mapping = Mapping(f"pp{pp}", {n: ("endpoint" if i < pp else "server")
                                      for i, n in enumerate(names)})
        pse = PartitionedServeEngine(cfg, model, mapping, batch=1, seq=48,
                                     group_size=2)
        logits = pse.infer(prompt)
        same = torch.equal(logits, mono)
        print(f"pp={pp}: boundary {pse.comm_bytes():6d} B/frame, "
              f"logits equal monolithic bit for bit: {same}")
        assert same
    print("\npartitioned inference equals monolithic — the mapping is a "
          "pure deployment decision (Edge-PRUNE Sec III.B).")

    # --- pipelined multi-frame streaming over the partition ----------------
    mapping = Mapping("pp3", {n: ("endpoint" if i < 3 else "server")
                              for i, n in enumerate(names)})
    pse = PartitionedServeEngine(cfg, model, mapping, batch=1, seq=48,
                                 group_size=2)
    pm = PlatformModel(paper_platform("N2", "wifi"))
    frames = [rng.randint(0, cfg.vocab_size, (1, 48)).astype(np.int32)
              for _ in range(8)]
    piped, sched = pse.infer_pipelined(frames, platform=pm)
    for frame, out in zip(frames, piped):
        assert torch.equal(out, pse.infer(frame))
    assert sched.makespan_s < sched.sequential_s
    print(f"\npipelined stream of {len(frames)} frames on the modeled N2/i7 "
          f"over WiFi: makespan {sched.makespan_s * 1e3:.1f} ms vs "
          f"sequential {sched.sequential_s * 1e3:.1f} ms — "
          f"{sched.speedup:.2f}x from client/server overlap (the Fig 6 "
          f"effect); every frame's logits equal its run_local ones.")


if __name__ == "__main__":
    main()
