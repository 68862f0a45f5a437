"""Legacy serving surface of the port: the deprecated ``ServeEngine`` shim
plus the Edge-PRUNE partitioned engine.

Counterpart of ``repro.runtime.serving``. The serving API is
``repro_torch.runtime.engine.Engine``, configured by an ``EngineConfig``;
``ServeEngine`` is the reference's thin deprecation shim over it, with
the same kwarg mapping, the same ``DeprecationWarning`` and the same
mode-conditional ``ValueError``s:

* ``ServeEngine(mode="static-bucket")`` → ``EngineConfig(admission="batch")``
* ``ServeEngine(mode="continuous")``    → ``EngineConfig(admission="fifo")``
* ``ServeEngine(paged=True, ...)``      → ``EngineConfig(kv_layout="paged")``
* ``prefill_chunk`` / ``max_slots`` / sampling kwargs keep their names.

``PartitionedServeEngine`` — the paper's collaborative-inference path
(prefill through a synthesized ``StagedProgram``) — is not deprecated.
Both take the port's ``Transformer`` where the reference takes a params
pytree, and run where the model lives.
"""
from __future__ import annotations

import warnings
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.scheduler import Completion, Request, SlotFailure

__all__ = ["Request", "Completion", "ServeEngine", "PartitionedServeEngine",
           "SlotFailure", "Engine", "EngineConfig"]

MODES = ("static-bucket", "continuous")


class ServeEngine:
    """Deprecated: the pre-policy engine facade. Construct an
    ``Engine`` with an ``EngineConfig`` instead (see module docstring
    for the kwarg mapping). The shim builds the same Engine the new API
    would, on ``device``."""

    def __init__(self, cfg: ModelConfig, model: T.Transformer, *,
                 max_len: int = 512, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 mode: str = "static-bucket", max_slots: int = 8,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: int = 0, prefill_chunk: int = 0,
                 watermark: int = 0, device="cuda"):
        warnings.warn(
            "ServeEngine is deprecated; use repro.runtime.engine.Engine "
            "with EngineConfig (mode='static-bucket' -> admission='batch', "
            "mode='continuous' -> admission='fifo', paged=True -> "
            "kv_layout='paged'). See README 'Serving architecture'.",
            DeprecationWarning, stacklevel=2)
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if mode != "continuous" and (paged or prefill_chunk):
            raise ValueError("paged KV cache / chunked prefill require "
                             "mode='continuous'")
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.greedy = greedy
        self.temperature = temperature
        self.mode = mode
        self.engine = Engine(cfg, model, EngineConfig(
            max_slots=max_slots, max_len=max_len, greedy=greedy,
            temperature=temperature, seed=seed,
            kv_layout="paged" if paged else "slotted",
            block_size=block_size, num_blocks=num_blocks,
            watermark=watermark, prefill_chunk=prefill_chunk,
            admission="batch" if mode == "static-bucket" else "fifo"),
            device=device)
        self.scheduler = self.engine.scheduler

    def generate(self, requests: List[Request], *,
                 arrivals: Optional[List[float]] = None,
                 on_completion=None) -> List[Completion]:
        """Serve ``requests`` to completion (legacy signature; delegates
        to ``Engine.generate``). The legacy mode-conditional errors are
        preserved verbatim."""
        if self.mode != "continuous":
            if arrivals is not None:
                raise ValueError("arrivals requires mode='continuous' — the "
                                 "static-bucket path has no admission queue")
            if on_completion is not None:
                raise ValueError("on_completion requires mode='continuous' — "
                                 "the static path completes buckets, not a "
                                 "stream")
            return self.engine.generate(requests)
        return self.engine.generate(requests, arrivals=arrivals,
                                    on_completion=on_completion)


# ---------------------------------------------------------------------------
# Edge-PRUNE collaborative-inference serving (the paper's technique)
# ---------------------------------------------------------------------------

class PartitionedServeEngine:
    """Serves prefill through a VR-PRUNE StagedProgram: the model's actor
    graph split by a mapping (endpoint/server), TX/RX channels
    auto-inserted at the boundary — Edge-PRUNE Sec III.B applied to LLMs.

    In process, a channel hands the producer's tensor to the consumer on
    the model's device: the stages run the same kernels on the same
    shapes in the same order as ``forward``, so the logits equal the
    monolithic ones bit for bit, and ``comm_bytes`` is what a
    distributed deployment would send.

    A unit may appear in several pipeline segments (endpoint → server →
    endpoint offload mappings): ``synthesize`` opens a new stage per
    revisit, ``run_pipelined`` keys its clocks by *physical* unit so the
    revisits contend for it, and ``comm_bytes`` counts only channels
    that actually cross units."""

    def __init__(self, cfg: ModelConfig, model: T.Transformer, mapping, *,
                 batch: int = 1, seq: int = 8, group_size: int = 1):
        from repro_torch.core.synthesis import synthesize
        self.cfg = cfg
        self.device = model.device
        self.graph = T.to_actor_graph(cfg, model, batch=batch, seq=seq,
                                      group_size=group_size)
        self.program = synthesize(self.graph, mapping)

    def _tokens(self, tokens: Any) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device)
        return torch.as_tensor(np.asarray(tokens), device=self.device)

    def infer(self, tokens: np.ndarray) -> torch.Tensor:
        sinks = self.program.run_local({"Input": self._tokens(tokens)})
        return sinks["Head"]

    def infer_pipelined(self, token_frames: List[np.ndarray], *,
                        platform=None, arrivals: Optional[List[float]] = None):
        """Serve a stream of frames through the staged pipeline: stage k
        of frame i overlaps stage k-1 of frame i+1 on the modeled
        per-unit clocks. Returns (logits per frame, PipelineSchedule)."""
        frames = [{"Input": self._tokens(t)} for t in token_frames]
        sinks, sched = self.program.run_pipelined(frames, platform=platform,
                                                  arrivals=arrivals)
        return [s["Head"] for s in sinks], sched

    def comm_bytes(self) -> int:
        return self.program.comm_bytes_per_iteration()
