"""Serving CLI of the port:
``python -m repro_torch.launch.serve --arch qwen2_1_5b --no-smoke [...]``.

Counterpart of ``repro.launch.serve``. Builds the model with the port's
own seeded init (``--smoke``, the default, takes the config's reduced
``.smoke()`` variant; ``--no-smoke`` serves the full width and depth),
makes ``--requests`` random prompts of ``--prompt-len`` tokens from
``--seed`` (with a frontend config's stub ``embeds``: 2,880 patch rows
of a vision frontend, a frame a token of an audio one), and serves them
through the ``Engine`` with ``max_len`` the rows a request needs, its
frontend rows among them, + 8: ``--policy batch``
is the static-bucket oracle, ``fifo`` / ``priority`` / ``edf`` stream
through the continuous scheduler against the real clock, each
completion printed the moment it finishes. The reference's ``--mode
static-bucket|continuous`` spelling maps onto ``--policy batch|fifo``.
``--paged`` serves from a paged KV pool (``--block-size``,
``--num-blocks``, 0 blocks = slotted parity; ``--watermark`` holds that
many blocks back at admission), ``--prefix-cache`` (implies
``--paged``) shares the resident blocks of a common prompt prefix, and
every synthetic prompt then opens with the same first half;
``--prefill-chunk N`` prefills N prompt tokens per scheduler step (a
config outside ``supports_chunked_prefill``, a ring or a recurrent
state, is served one-shot and shares no prefix, as in the reference).
Each of these, ``--trace`` and ``--serve`` imply fifo where the policy
is batch. Runs on ``--device`` (default ``cuda``). The engine flags are
``EngineConfig.add_cli_args``'s, as in the reference: also
``--victim-cache`` (implies ``--prefix-cache``), ``--units``,
``--prefill-units``, ``--decode-stages``, ``--placement``,
``--enforce-deadlines``, ``--preemption`` and ``--observability``.

``--trace <jsonl>`` replays a recorded request trace instead of the
synthetic workload, one JSON object a line, as the reference reads it::

    {"arrival_s": 0.00, "prompt": [17, 3, 99], "max_new": 8}
    {"arrival_s": 0.02, "prompt_len": 32, "max_new": 16, "priority": 2,
     "deadline_s": 0.5, "eos": 7}

``prompt`` gives token ids; ``prompt_len`` asks for that many random
tokens (from ``--seed``). ``priority`` and ``deadline_s`` feed the
priority / EDF policies. Arrivals are seconds from the start of the
run; lines may come out of order. ``--trace-out PATH`` writes the
engine's Chrome trace (``trace_json()``, empty without
``--observability``) there after the run.

``--serve`` starts the HTTP front end (``repro_torch.runtime.server``'s
``EngineServer``) over the CLI's engine on ``--port`` (0: an ephemeral
port) instead of running a workload, and blocks until interrupted.

``--partition N`` then also runs the first prompt through the
Edge-PRUNE partitioned actor graph (``PartitionedServeEngine``, exported
at batch 1 and ``--prompt-len`` positions) with its first N actors on
the "endpoint" unit and the rest on the "server", and prints the
boundary bytes and the argmax of the last position, as the reference
CLI does.

``main(argv)`` returns a summary dict (completions, throughput, TTFT,
decode time per step, and the partitioned run's) so that scripts can
drive it.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.mapping import Mapping
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.scheduler.types import cache_rows
from repro_torch.runtime.serving import PartitionedServeEngine


def stub_embeds(cfg, rng: np.random.RandomState, prompt_len: int):
    """A request's frontend stub, drawn as the reference's CLI draws it:
    ``frontend_tokens`` patch rows for a vision frontend, one frame a
    prompt token for an audio one, N(0, 1) from ``rng``; None without a
    frontend."""
    if cfg.arch_type == "vlm":
        return rng.randn(cfg.frontend_tokens,
                         cfg.frontend_dim).astype(np.float32)
    if cfg.arch_type == "audio":
        return rng.randn(prompt_len, cfg.frontend_dim).astype(np.float32)
    return None


def synthetic_requests(cfg, n: int, prompt_len: int, max_new: int,
                       seed: int, shared_prefix: bool = False
                       ) -> List[Request]:
    """The reference CLI's synthetic workload: uniform random prompts,
    each followed in the draw by its frontend stub (``stub_embeds``).
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
        reqs.append(Request(i, prompt, max_new_tokens=max_new,
                            embeds=stub_embeds(cfg, rng, prompt_len)))
    return reqs


def load_trace(path: str, cfg, rng: np.random.RandomState
               ) -> Tuple[List[Request], List[float]]:
    """Parse a JSONL request trace into (requests, arrival offsets), as
    the reference's ``load_trace`` does: request ``i`` is the ``i``-th
    non-empty line, ``prompt_len`` lines draw their tokens from ``rng``
    in line order, and a frontend config's requests get their stub
    ``embeds`` from ``rng`` after their prompt (``stub_embeds``): a
    trace records arrivals, prompts and budgets, not frontend
    tensors."""
    reqs: List[Request] = []
    arrivals: List[float] = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "prompt" in d:
                prompt = np.asarray(d["prompt"], np.int32)
            else:
                prompt = rng.randint(0, cfg.vocab_size,
                                     int(d.get("prompt_len", 32))
                                     ).astype(np.int32)
            reqs.append(Request(i, prompt,
                                max_new_tokens=int(d.get("max_new", 16)),
                                eos=d.get("eos"),
                                priority=int(d.get("priority", 0)),
                                deadline_s=d.get("deadline_s"),
                                embeds=stub_embeds(cfg, rng, len(prompt))))
            arrivals.append(float(d.get("arrival_s", 0.0)))
    if not reqs:
        raise ValueError(f"trace {path} contains no requests")
    return reqs, arrivals


def resolve_policy(args) -> str:
    """``--policy``, else ``--mode``'s spelling of it (static-bucket =
    batch, continuous = fifo), else batch; batch turns fifo where a flag
    needs the continuous scheduler, as in the reference."""
    policy = args.policy
    if policy is None and args.mode is not None:
        policy = "batch" if args.mode == "static-bucket" else "fifo"
    policy = policy or "batch"
    multi_unit = (args.units != 1 or args.prefill_units
                  or args.decode_stages != 1)
    if policy == "batch" and (args.paged or args.prefix_cache
                              or args.victim_cache or args.prefill_chunk
                              or args.trace or args.serve
                              or args.enforce_deadlines or multi_unit):
        policy = "fifo"
        print("# --paged/--prefix-cache/--victim-cache/--prefill-chunk/"
              "--trace/--serve/--enforce-deadlines/--units/--decode-stages "
              "imply a continuous admission policy (fifo)")
    return policy


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
    ap.add_argument("--mode", default=None,
                    choices=("static-bucket", "continuous"),
                    help="the reference's spelling of --policy: "
                         "static-bucket = batch, continuous = fifo")
    ap.add_argument("--serve", action="store_true",
                    help="instead of running a workload, serve HTTP "
                         "(repro_torch.runtime.server) over this engine "
                         "and block until interrupted")
    ap.add_argument("--port", type=int, default=8800,
                    help="--serve listen port (0 = ephemeral)")
    ap.add_argument("--trace", default=None, metavar="JSONL",
                    help="request trace to replay against the real clock "
                         "(continuous policies; see the module docstring)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, of the synthetic prompts "
                         "and of a trace's prompt_len lines")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the engine's Chrome trace JSON here after "
                         "the run (needs --observability to hold events)")
    return ap.parse_args(argv)


def serve_http(eng: Engine, port: int, *,
               stop: Optional[threading.Event] = None,
               listening: Optional[Callable[[Any], None]] = None) -> None:
    """``--serve``: the HTTP front end over ``eng`` on 127.0.0.1:``port``
    until ``stop`` is set or the process is interrupted; ``listening``
    is called with the started ``EngineServer`` (its ``.port`` is the
    bound one when ``port`` is 0)."""
    from repro_torch.runtime.server import EngineServer, ServerConfig
    with EngineServer(eng, ServerConfig(port=port)) as srv:
        print(f"# serving {eng.cfg.name} on {srv.url} (policy="
              f"{eng.admission.name}, layout={eng.config.kv_layout}); POST "
              f"/generate, GET /health/ready, GET /status", flush=True)
        if listening is not None:
            listening(srv)
        waiter = stop or threading.Event()      # never set: until ^C
        try:
            while not waiter.wait(3600):
                pass
        except KeyboardInterrupt:
            pass


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
    """Run the CLI. With ``--serve`` it returns None once the server has
    been interrupted."""
    args = parse_args(argv)
    prefix = args.prefix_cache or args.victim_cache
    paged = args.paged or prefix
    policy = resolve_policy(args)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    t_init = time.perf_counter()
    model = T.init_params(cfg, args.seed, device=args.device)
    arrivals = None
    if args.trace is not None:
        reqs, arrivals = load_trace(args.trace, cfg,
                                    np.random.RandomState(args.seed))
    else:
        reqs = synthetic_requests(cfg, args.requests, args.prompt_len,
                                  args.max_new, args.seed,
                                  shared_prefix=prefix)
    # rows a slot needs: a vision frontend's, the prompt's and the new
    # tokens', + 8 (the reference counts the prompt alone, and its cache
    # then drops most of a vision request's rows)
    max_len = max(cache_rows(cfg, r) + r.max_new_tokens for r in reqs) + 8
    eng = Engine(cfg, model, EngineConfig.from_args(
        args, max_len=max_len, admission=policy), device=args.device)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    if args.serve:
        serve_http(eng, args.port)
        return None

    summary = run(eng, reqs, arrivals)
    summary.update(arch=cfg.name, init_s=init_s)
    outs, st, steps = (summary["completions"], summary["stats"],
                       summary["decode_steps"])
    toks, wall_s = summary["tokens"], summary["wall_s"]
    if policy == "batch":
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
    if args.trace_out:
        with open(args.trace_out, "w") as fh:
            json.dump(eng.trace_json(), fh)
        print(f"# trace -> {args.trace_out}")
    return summary


def run(eng: Engine, reqs: List[Request],
        arrivals: Optional[List[float]] = None) -> Dict[str, Any]:
    """Serve ``reqs`` through ``eng`` (at their ``arrivals`` on the real
    clock under a continuous policy, each completion printed as it
    finishes) and summarize: completions, throughput, TTFT p50 and
    decode time a step. Under batch admission each bucket (one prompt
    length) gets its first tokens when its prefill ends, and decodes
    its longest request's budget."""
    batch = eng.batch_mode

    def stream(c) -> None:
        print(f"t={c.finish_s:8.3f}s req {c.id}: ttft "
              f"{c.ttft_s * 1e3:7.1f} ms, latency "
              f"{c.latency_s * 1e3:7.1f} ms, {len(c.tokens)} tokens, "
              f"{c.finish_reason}, first: {c.tokens[:8]}", flush=True)
    t0 = time.perf_counter()
    outs = eng.generate(reqs, arrivals=arrivals,
                        on_completion=None if batch else stream)
    wall_s = time.perf_counter() - t0
    toks = sum(len(o.tokens) for o in outs)
    st = eng.stats()
    if batch:
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
    return {
        "policy": eng.admission.name, "device": str(eng.device),
        "kv_layout": eng.config.kv_layout, "kv_stats": eng.kv_stats(),
        "requests": len(outs), "tokens": toks, "wall_s": wall_s,
        "tok_per_s": toks / wall_s,
        "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
        "decode_steps": steps,
        "decode_ms_per_step": decode_s / max(steps, 1) * 1e3,
        "stats": st, "completions": outs}


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
