"""Prompt prefill at admission: the one-shot path.

Counterpart of ``repro.runtime.scheduler.prefill``; prefix-resume and
chunked admission come with later slices (queue 1, items 5 and 6).
"""
from __future__ import annotations

import time

import torch

from repro_torch.models import transformer as T
from repro_torch.runtime.scheduler.types import _Ticket

__all__ = ["admit_one_shot"]


def admit_one_shot(sched, ticket: _Ticket, slot: int, t0: float) -> None:
    """Whole-prompt prefill at admission: compute, insert into the
    shared cache, sample the first token (which waits for the device)."""
    r = ticket.req
    tokens = torch.as_tensor(r.prompt[None], dtype=torch.int64,
                             device=sched.device)
    tp = time.perf_counter()
    logits, req_cache, clen = T.prefill(sched.model, tokens,
                                        max_len=sched.max_len)
    sched.layout.insert(req_cache, slot)
    first = int(sched.sampler(logits)[0])
    ticket.prefill_s += time.perf_counter() - tp
    sched.core.prefill(slot, len(r.prompt))
    sched._activate(ticket, slot, first, int(clen[0]), t0)
