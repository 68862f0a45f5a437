"""Failover benchmark on the port: collaborative inference under
injected failures.

``benchmarks/failover_bench.py`` run on ``repro_torch``: the same
sections, flags, configurations and assertions, the actor graph's frames
and the serving engine on ``--device`` (default ``cuda``; ``cpu`` runs
without a card). The rows are written to
``benchmarks/results/torch_failover.json`` unless ``--out`` says where.

Reproduces the scenario shape of *Fault-Tolerant Collaborative Inference
through the Edge-PRUNE Framework* (arXiv 2206.08152): an LLM actor graph
served endpoint+server on the paper's N2/i7 WiFi platform, with the
server killed mid-stream. Because the application graph never changes —
only the mapping does — recovery is a mapping switch: the failover
controller detects the loss via heartbeat timeout, re-synthesizes the
staged program on the surviving unit from its precomputed ranked fallback
list, and replays the unacknowledged frames from its checkpoint buffer.

Three layers are measured:

* **controller** — recovery latency (detection + re-synthesis), frames
  replayed, degraded vs nominal modeled throughput, and a bit-identity
  check: every served frame's logits must equal the failure-free run's.
* **scheduler** — continuous-batching slot loss mid-decode: affected
  requests are re-queued (not dropped) and every request's greedy tokens
  stay bit-identical to the failure-free run.
* **simulator** — token-accurate kill/revive of the server: lost frames
  re-fired from the last consistent frame boundary.

    PYTHONPATH=src:. python benchmarks/torch_failover_bench.py --tiny --device cpu
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.common import HEADER, Row, emit  # noqa: E402
from repro_torch.core import (Explorer, Mapping, PlatformModel,  # noqa: E402
                              Simulator, paper_platform)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.runtime.observability import (  # noqa: E402
    Observability, simulator_trace)
from repro_torch.runtime.resilience import (  # noqa: E402
    FailoverController, FailureTrace, HeartbeatConfig)
from repro_torch.runtime.scheduler import (  # noqa: E402
    ContinuousScheduler, SchedulerConfig, SlotFailure)
from repro_torch.runtime.serving import Request  # noqa: E402

SEQ_LEN = 32


def _cfg(tiny: bool = False) -> ModelConfig:
    if tiny:
        return ModelConfig(
            name="failover-tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
            dtype="float32", param_dtype="float32", attn_chunk=32,
            remat=False)
    return ModelConfig(
        name="failover-120m", arch_type="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=2048,
        dtype="float32", param_dtype="float32", attn_chunk=64, remat=False)


def _controller_rows(cfg, params, *, n_frames: int, fail_frac: float,
                     seed: int,
                     obs: Optional[Observability] = None) -> List[Row]:
    # The companion paper's scenario needs collaboration to *win*
    # nominally so that losing the server genuinely degrades service:
    # the N270 endpoint is far too weak for full on-device inference
    # (paper Fig. 5), hence endpoint+server is the best collaborative
    # mapping and the post-failure all-endpoint fallback is the degraded
    # mode.
    g = T.to_actor_graph(cfg, params, batch=1, seq=SEQ_LEN, group_size=2)
    pg = paper_platform("N270", "ethernet")
    pm = PlatformModel(pg)
    # Precomputed ranked fallback list (the deployment-time artifact):
    # every partition point plus the single-unit recovery mappings. The
    # controller walks it for the first mapping viable on the survivors.
    ranked = Explorer(g, pg).rank_fallbacks()
    primary = next(m for m in ranked if len(m.units_used()) == 2)
    fallbacks = ranked
    rng = np.random.RandomState(seed)
    frames = [{"Input": torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (1, SEQ_LEN)).astype(np.int32),
        device=params.device)} for _ in range(n_frames)]

    def controller(hb=None, obs_=None):
        return FailoverController(g, primary, fallbacks, platform=pm,
                                  heartbeat=hb,
                                  checkpoint_frames=max(2, n_frames // 3),
                                  obs=obs_)

    nominal, nom_rep = controller().serve(frames)
    assert nom_rep.num_failovers == 0
    frame_gap = nom_rep.makespan_s / n_frames
    hb = HeartbeatConfig(interval_s=frame_gap / 2, timeout_s=frame_gap)

    t_fail = fail_frac * nom_rep.makespan_s
    trace = FailureTrace().kill_unit("server", at=t_fail)
    ctl = controller(hb, obs)
    outs, rep = ctl.serve(frames, failures=trace)

    assert rep.num_failovers >= 1 and not rep.exhausted, \
        "mid-stream server loss must recover via a fallback mapping"
    assert rep.mapping_history[-1] != primary.name
    assert "server" not in ctl.mapping.units_used(), \
        "recovery mapping must avoid the dead server"
    served = sum(o is not None for o in outs)
    assert served == n_frames and not rep.frames_unserved, \
        "every frame must be served after failover"
    for f, (a, b) in enumerate(zip(nominal, outs)):
        assert torch.equal(a["Head"], b["Head"]), \
            f"frame {f} diverged after failover — bit-identity broken"

    ev = rep.events[0]
    nominal_fps = n_frames / nom_rep.makespan_s
    degraded_fps = served / rep.makespan_s
    return [
        Row("failover", "nominal_modeled_makespan_s", nom_rep.makespan_s, "s"),
        Row("failover", "degraded_modeled_makespan_s", rep.makespan_s, "s"),
        Row("failover", "nominal_throughput_fps", nominal_fps, "frame/s"),
        Row("failover", "degraded_throughput_fps", degraded_fps, "frame/s"),
        Row("failover", "degraded_vs_nominal", degraded_fps / nominal_fps,
            "x"),
        Row("failover", "recovery_latency_ms", rep.recovery_latency_s * 1e3,
            "ms"),
        Row("failover", "detection_ms", (ev.t_detect_s - ev.t_fail_s) * 1e3,
            "ms"),
        Row("failover", "resynthesis_ms", ev.resynth_s * 1e3, "ms"),
        Row("failover", "frames_replayed", float(len(rep.frames_replayed)),
            "frames"),
        Row("failover", "frames_lost", float(len(rep.frames_unserved)),
            "frames"),
        Row("failover", "failovers", float(rep.num_failovers), ""),
        Row("failover", "bit_identical", 1.0, "bool"),
    ]


def _scheduler_rows(cfg, params, *, n_requests: int, seed: int) -> List[Row]:
    def reqs():
        rng = np.random.RandomState(seed)
        lens = (8, 12, 16, 10)
        return [Request(i, rng.randint(0, cfg.vocab_size,
                                       lens[i % len(lens)]).astype(np.int32),
                        max_new_tokens=4 + i % 5)
                for i in range(n_requests)]

    def drain(failures=None):
        sch = ContinuousScheduler(
            cfg, params, SchedulerConfig(max_slots=max(2, n_requests // 2),
                                         max_len=64),
            failures=failures)
        for r in reqs():
            sch.submit(r)
        return sch, sch.run()

    _, ref = drain()
    sch, out = drain([SlotFailure(step=2, slots=None)])  # whole-unit loss
    fails = [e for e in sch.events if e.kind == "fail"]
    assert fails, "slot failure was not applied"
    identical = all(a.id == b.id and a.tokens == b.tokens
                    for a, b in zip(ref, out))
    assert identical, "re-queued requests must decode bit-identically"
    return [
        Row("failover", "sched_requeued_requests", float(len(fails)), "req"),
        Row("failover", "sched_bit_identical", 1.0, "bool"),
    ]


def _simulator_rows(cfg, params, *, n_frames: int, seed: int,
                    obs: Optional[Observability] = None) -> List[Row]:
    g = T.to_actor_graph(cfg, params, batch=1, seq=SEQ_LEN, group_size=2)
    pg = paper_platform("N270", "ethernet")
    pm = PlatformModel(pg)
    names = list(g.actors)
    mapping = Mapping("half", {nm: ("endpoint" if i < len(names) // 2
                                    else "server")
                               for i, nm in enumerate(names)}, pg)
    rng = np.random.RandomState(seed)
    feed = [torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (1, SEQ_LEN)).astype(np.int32),
        device=params.device) for _ in range(n_frames)]
    nom = Simulator(g, mapping=mapping, platform=pm).run(
        n_frames, source_inputs={"Input": feed})
    # Kill the server in the middle of its nominal activity window so
    # in-flight tokens are genuinely lost; revive it at the window's end
    # so the lost frames can replay onto the same mapping.
    sv = [f for f in nom.firings if f.unit == "server"]
    t_kill = (sv[0].start_s + sv[-1].finish_s) / 2
    trace = FailureTrace().kill_unit("server", at=t_kill) \
        .revive_unit("server", at=sv[-1].finish_s)
    res = Simulator(g, mapping=mapping, platform=pm).run(
        n_frames, source_inputs={"Input": feed}, failures=trace)
    if obs is not None and obs.enabled:
        # modeled-clock unit tracks: every firing of the failure run as
        # a complete slice, so the kill/replay gap is visible next to
        # the controller's detection/resynthesis spans
        simulator_trace(obs.tracer, res)
    assert res.frames_replayed, \
        "a mid-activity server kill must lose (and replay) frames"
    assert not res.frames_lost, "revived server must allow full replay"
    for nm_ in nom.outputs:
        assert len(res.outputs[nm_]) == len(nom.outputs[nm_])
        for a, b in zip(nom.outputs[nm_], res.outputs[nm_]):
            assert torch.equal(a, b)
    return [
        Row("failover", "sim_frames_replayed", float(len(res.frames_replayed)),
            "frames"),
        Row("failover", "sim_downtime_overhead",
            res.modeled_makespan_s / nom.modeled_makespan_s, "x"),
    ]


def run(*, tiny: bool = False, n_frames: Optional[int] = None,
        fail_frac: float = 0.4, seed: int = 0,
        trace_out: Optional[str] = None, device="cuda") -> List[Row]:
    if not 0.0 < fail_frac < 1.0:
        raise ValueError(f"--fail-frac must be in (0, 1), got {fail_frac}")
    cfg = _cfg(tiny)
    n = n_frames or (6 if tiny else 16)
    params = T.init_params(cfg, 0, device=device)
    obs = Observability(enabled=True)
    rows = _controller_rows(cfg, params, n_frames=n, fail_frac=fail_frac,
                            seed=seed, obs=obs)
    rows += _scheduler_rows(cfg, params, n_requests=min(n, 8), seed=seed)
    rows += _simulator_rows(cfg, params, n_frames=min(n, 6), seed=seed,
                            obs=obs)
    # the controller's observability view of the same run: detection /
    # recovery latency histogram summaries as rows (modeled seconds)
    snap = obs.registry.snapshot()
    det = snap["histograms"].get("repro_failover_detection_seconds", {})
    rec = snap["histograms"].get("repro_failover_recovery_seconds", {})
    rows += [
        Row("failover", "obs_failovers_total",
            float(snap["counters"].get("repro_failovers_total", 0)), ""),
        Row("failover", "obs_detection_p50_ms",
            det.get("p50", 0.0) * 1e3, "ms"),
        Row("failover", "obs_recovery_p50_ms",
            rec.get("p50", 0.0) * 1e3, "ms"),
    ]
    if trace_out:
        n_ev = obs.write_trace(trace_out)
        print(f"wrote {trace_out} ({n_ev} trace events, modeled clocks)")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke config (small model, few frames)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--fail-frac", type=float, default=0.4,
                    help="inject the server kill at this fraction of the "
                         "nominal modeled makespan")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cpu runs without a card)")
    ap.add_argument("--out", default="benchmarks/results/torch_failover.json",
                    help="write rows as JSON to this path")
    ap.add_argument("--trace-out", default=None,
                    help="write a modeled-clock Chrome trace (simulator "
                         "unit tracks + failover detection/resynthesis "
                         "spans) here")
    args = ap.parse_args(argv)
    rows = run(tiny=args.tiny, n_frames=args.frames,
               fail_frac=args.fail_frac, seed=args.seed,
               trace_out=args.trace_out, device=args.device)
    print(HEADER)
    emit(rows, out_path=args.out)


if __name__ == "__main__":
    main()
