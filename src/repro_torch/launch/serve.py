"""Serving CLI of the port:
``python -m repro_torch.launch.serve --arch qwen2_1_5b --no-smoke [...]``.

Counterpart of ``repro.launch.serve``'s synthetic-workload path. Builds
the model with the port's own seeded init (``--smoke``, the default,
takes the config's reduced ``.smoke()`` variant; ``--no-smoke`` serves
the full width and depth), makes ``--requests`` random prompts of
``--prompt-len`` tokens from ``--seed``, and serves them through the
``Engine``: ``--policy batch`` is the static-bucket oracle, ``fifo`` /
``priority`` / ``edf`` stream through the continuous scheduler (all
requests arrive at t=0). ``--paged`` serves from a paged KV pool
(``--block-size``, ``--num-blocks``, 0 blocks = slotted parity;
``--watermark`` holds that many blocks back at admission),
``--prefix-cache`` (implies ``--paged``) shares the resident blocks of a
common prompt prefix, and every synthetic prompt then opens with the
same first half; ``--prefill-chunk N`` prefills N prompt tokens per
scheduler step. Each of these implies fifo where the policy is batch.
Runs on ``--device`` (default ``cuda``). The engine flags are
``EngineConfig.add_cli_args``'s, as in the reference: also
``--victim-cache`` (implies ``--prefix-cache``), ``--units``,
``--prefill-units``, ``--decode-stages``, ``--placement``,
``--enforce-deadlines``, ``--preemption`` and ``--observability``;
``--trace PATH`` writes the engine's Chrome trace (``trace_json()``,
empty without ``--observability``) there after the run.

``--partition N`` then also runs the first prompt through the
Edge-PRUNE partitioned actor graph (``PartitionedServeEngine``, exported
at batch 1 and ``--prompt-len`` positions) with its first N actors on
the "endpoint" unit and the rest on the "server", and prints the
boundary bytes and the argmax of the last position, as the reference
CLI does.

``main(argv)`` returns a summary dict (completions, throughput, TTFT,
decode time per step, and the partitioned run's) so that scripts can
drive it. The HTTP front end is ``repro_torch.runtime.server``; the
reference CLI's replayed request traces, ``--serve`` and ``--mode`` come
with later slices (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.mapping import Mapping
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serving import PartitionedServeEngine


def synthetic_requests(cfg, n: int, prompt_len: int, max_new: int,
                       seed: int, shared_prefix: bool = False
                       ) -> List[Request]:
    """The reference CLI's synthetic workload: uniform random prompts.
    With ``shared_prefix`` every prompt opens with the same first half
    (the shared-preamble traffic a prefix cache exists for), drawn from
    the seed before the prompts."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, cfg.vocab_size,
                         prompt_len // 2).astype(np.int32) \
        if shared_prefix else None
    reqs = []
    for i in range(n):
        prompt = rng.randint(0, cfg.vocab_size, prompt_len).astype(np.int32)
        if shared is not None:
            prompt[:len(shared)] = shared
        reqs.append(Request(i, prompt, max_new_tokens=max_new))
    return reqs


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the config's reduced smoke variant "
                         "(--no-smoke: full width and depth)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--partition", type=int, default=None,
                    help="also run Edge-PRUNE partitioned inference with "
                         "this many actors on the 'endpoint' unit")
    # the engine flags, registered as the reference registers them;
    # --policy defaults to batch here
    EngineConfig.add_cli_args(ap)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the synthetic prompts")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the engine's Chrome trace JSON here after "
                         "the run (needs --observability to hold events)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    prefix = args.prefix_cache or args.victim_cache
    paged = args.paged or prefix
    policy = args.policy or "batch"
    multi_unit = (args.units != 1 or args.prefill_units
                  or args.decode_stages != 1)
    if policy == "batch" and (paged or args.prefill_chunk
                              or args.enforce_deadlines or multi_unit):
        policy = "fifo"
        print("# --paged/--prefix-cache/--victim-cache/--prefill-chunk/"
              "--enforce-deadlines/--units/--decode-stages imply a "
              "continuous admission policy (fifo)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    t_init = time.perf_counter()
    model = T.init_params(cfg, args.seed, device=args.device)
    reqs = synthetic_requests(cfg, args.requests, args.prompt_len,
                              args.max_new, args.seed,
                              shared_prefix=prefix)
    eng = Engine(cfg, model, EngineConfig.from_args(
        args, max_len=args.prompt_len + args.max_new + 8, admission=policy),
        device=args.device)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    wall_s = time.perf_counter() - t0
    toks = sum(len(o.tokens) for o in outs)
    st = eng.stats()
    if policy == "batch":
        # one bucket per prompt length; every request of a bucket gets its
        # first token when the bucket's prefill ends
        ttft = [o.prefill_s for o in outs]
        buckets: Dict[int, List[Any]] = {}
        for r, o in zip(reqs, outs):
            buckets.setdefault(len(r.prompt), []).append(o)
        steps = sum(max(len(o.tokens) for o in b) - 1
                    for b in buckets.values())
        decode_s = sum(b[0].decode_s for b in buckets.values())
    else:
        ttft = [o.ttft_s for o in outs]
        steps = st["steps"]
        decode_s = wall_s - sum(o.prefill_s for o in outs)
    summary = {
        "arch": cfg.name, "policy": policy, "device": str(eng.device),
        "kv_layout": eng.config.kv_layout, "kv_stats": eng.kv_stats(),
        "requests": len(outs), "tokens": toks, "wall_s": wall_s,
        "init_s": init_s, "tok_per_s": toks / wall_s,
        "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
        "decode_steps": steps,
        "decode_ms_per_step": decode_s / max(steps, 1) * 1e3,
        "stats": st, "completions": outs}
    for o in outs[:4]:
        print(f"req {o.id}: prefill {o.prefill_s * 1e3:.1f} ms, "
              f"{len(o.tokens)} tokens, {o.finish_reason}, "
              f"first: {o.tokens[:8]}")
    print(f"# {cfg.name} on {eng.device}, policy {policy}, "
          f"{eng.config.kv_layout} KV: "
          f"{len(outs)} requests / {toks} tokens in {wall_s:.3f} s "
          f"({summary['tok_per_s']:.1f} tok/s); TTFT p50 "
          f"{summary['ttft_p50_ms']:.1f} ms; {steps} decode steps at "
          f"{summary['decode_ms_per_step']:.2f} ms each (wall, host "
          f"included); init {init_s:.1f} s")
    if policy != "batch":
        print(f"# {st['preemptions']} preemptions; prefix cache: "
              f"{st['prefix_hits']} admissions matched a resident chain, "
              f"{st['prefill_tokens_saved']} of "
              f"{st['prefill_tokens_total']} prompt tokens skipped prefill")
    if paged:
        ks = summary["kv_stats"]
        print(f"# paged KV: pool {ks['paged_kv_pool_bytes'] / 1e6:.2f} MB, "
              f"high-water {ks['paged_kv_hwm_bytes'] / 1e6:.2f} MB "
              f"({ks['paged_kv_hwm_blocks']:.0f} blocks, watermark "
              f"{args.watermark}) vs slotted "
              f"reservation {ks['slotted_kv_reserved_bytes'] / 1e6:.2f} MB")
    if args.partition is not None:
        summary["partition"] = partitioned(cfg, model, reqs[0].prompt,
                                           args.partition)
    if args.trace:
        with open(args.trace, "w") as fh:
            json.dump(eng.trace_json(), fh)
        print(f"# trace -> {args.trace}")
    return summary


def partitioned(cfg, model: T.Transformer, prompt: np.ndarray,
                n_endpoint: int) -> Dict[str, Any]:
    """One prompt through the actor graph with its first ``n_endpoint``
    actors (clamped to 1..all) on the "endpoint" and the rest on the
    "server": the boundary bytes a frame and the last position's argmax."""
    names = list(T.to_actor_graph(cfg, batch=1, seq=len(prompt)).actors)
    pp = max(1, min(n_endpoint, len(names)))
    mapping = Mapping("cli", {n: ("endpoint" if i < pp else "server")
                              for i, n in enumerate(names)})
    pse = PartitionedServeEngine(cfg, model, mapping, batch=1,
                                 seq=len(prompt))
    logits = pse.infer(prompt[None])
    out = {"pp": pp, "boundary_bytes": pse.comm_bytes(),
           "argmax": int(logits[0, -1].argmax())}
    print(f"# partitioned inference @pp={pp}: boundary "
          f"{out['boundary_bytes']} B, argmax {out['argmax']}")
    return out


if __name__ == "__main__":
    main()
