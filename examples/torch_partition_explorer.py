"""The Edge-PRUNE Explorer applied to a decoder LM on the port: export the
model as a VR-PRUNE actor graph, write the paper's artifact set (one
mapping-file pair per partition point plus a profiling script), sweep
the partition points on a modeled two-unit platform, then run the
chosen cut on the device.

This is Sec III.C's methodology with a decoder LM instead of a CNN: the
partition point is where the activation token crosses from the
"endpoint" to the "server". The sweep prices the full-size graph's
costs on the reference's modeled TPU-pod platform (``tpu_pod_platform``,
two pods over DCN: modeled rates, not a measurement of this device).
The chosen cut is then executed on ``--device`` with the config's
reduced smoke variant (random weights from seed 0): its partitioned
logits must equal the monolithic ``forward``'s bit for bit.

Run: PYTHONPATH=src python examples/torch_partition_explorer.py [--arch qwen2_1_5b] [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Explorer, Mapping, analyze, tpu_pod_platform
from repro_torch.models import transformer as T
from repro_torch.serving import PartitionedServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--group-size", type=int, default=2,
                    help="transformer layers per dataflow actor")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    g = T.to_actor_graph(cfg, batch=args.batch, seq=args.seq,
                         group_size=args.group_size)
    print(f"{cfg.name} as dataflow graph: {g}")
    print(f"analyzer: ok={analyze(g).ok}")

    platform = tpu_pod_platform(2)   # pod0 = 'endpoint', pod1 = 'server'
    explorer = Explorer(g, platform)
    outdir = os.path.join(tempfile.gettempdir(), f"edgeprune_{cfg.name}")
    artifacts = explorer.generate_artifacts(outdir)
    print(f"wrote {len(artifacts)} mapping files + profiling script "
          f"to {outdir}")

    res = explorer.evaluate_modeled()
    best = res.best(privacy=True)
    print(f"{'pp':>4} {'pod0 time':>12} {'boundary':>12}   (modeled pods)")
    for rec in res.records:
        print(f"{rec.pp:>4} {rec.endpoint_time_s * 1e6:>10.1f}us "
              f"{rec.boundary_bytes:>10d}B  "
              f"{'<- best' if rec.pp == best.pp else ''}")

    # the best cut that splits the graph (an interior point: neither raw
    # offload nor all on pod0), executed: the smoke variant's graph has
    # the same Input / Embed / Layers / Head shape, so the cut keeps its
    # place relative to the end of the graph, inside its interior
    inner = min((r for r in res.records if 1 < r.pp < len(res.records)),
                key=lambda r: r.endpoint_time_s)
    print(f"best interior cut: pp={inner.pp}, after "
          f"{inner.endpoint_actors[-1]}")
    small = cfg.smoke()
    model = T.init_params(small, 0, device=args.device)
    seq = 16
    names = list(T.to_actor_graph(small, batch=1, seq=seq,
                                  group_size=args.group_size).actors)
    pp = min(max(2, len(names) - (len(res.records) - inner.pp)),
             len(names) - 1)
    mapping = Mapping(f"pp{pp}", {n: ("endpoint" if i < pp else "server")
                                  for i, n in enumerate(names)})
    pse = PartitionedServeEngine(small, model, mapping, batch=1, seq=seq,
                                 group_size=args.group_size)
    tokens = np.random.RandomState(0).randint(
        0, small.vocab_size, (1, seq)).astype(np.int32)
    logits = pse.infer(tokens)
    with torch.no_grad():
        mono, _ = T.forward(model, small, {"tokens": torch.as_tensor(
            tokens, device=model.device)}, train=False)
    n = small.vocab_size    # the Head leaves a padded vocabulary unmasked
    same = torch.equal(logits[..., :n], mono[..., :n])
    print(f"\n{small.name} on {model.device}, cut after "
          f"{names[pp - 1]} (pp={pp} of {len(names)}): boundary "
          f"{pse.comm_bytes()} B; logits equal monolithic bit for bit: "
          f"{same}")
    assert same
    print("Every interior cut ships the same (B, S, d_model) activation "
          "token, so on homogeneous pods the Explorer's optimum is set by "
          "the compute split — unlike the paper's CNNs, whose token sizes "
          "shrink with depth.")


if __name__ == "__main__":
    main()
