"""Prompt prefill at admission: one-shot, prefix-resume and chunked.

Counterpart of ``repro.runtime.scheduler.prefill``: free functions over
the ``ContinuousScheduler``, the prefill half of its admission
machinery. Every compute burst is also charged to the execution core's
placement-chosen prefill unit (``sched.core.prefill``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.runtime.scheduler.types import _Ticket

__all__ = ["admit_one_shot", "admit_prefix_resume", "advance_chunked"]


def _lengths(sched, n: int) -> torch.Tensor:
    return torch.full((1,), n, dtype=torch.int32, device=sched.device)


def _charge(sched, ticket: _Ticket, slot: int, tp: float, tokens: int,
            label: str) -> None:
    """Account one prefill burst that started at ``tp``: the ticket's
    prefill time, the execution core's prefill unit and, with
    observability on, the prefill phase and span (after waiting for the
    device, so that the span times the burst and not its enqueue)."""
    if sched.obs is not None and sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    dt = time.perf_counter() - tp
    ticket.prefill_s += dt
    sched.core.prefill(slot, tokens, label=label)
    if sched.obs is not None:
        sched._obs_prefill(slot, label, tp, dt, tokens)


def admit_one_shot(sched, ticket: _Ticket, slot: int, t0: float) -> None:
    """Whole-prompt prefill at admission (with the request's ``embeds``):
    compute, insert into the shared cache, register the prefix, sample
    the first token (which waits for the device)."""
    r = ticket.req
    tokens = torch.as_tensor(r.prompt[None], dtype=torch.int64,
                             device=sched.device)
    embeds = None if r.embeds is None else torch.as_tensor(
        np.asarray(r.embeds, np.float32)[None], device=sched.device)
    tp = time.perf_counter()
    logits, req_cache, clen = T.prefill(sched.model, tokens,
                                        max_len=sched.max_len, embeds=embeds)
    sched.layout.insert(req_cache, slot)
    if sched._prefix and r.embeds is None:
        sched.layout.register_prefix(slot, r.prompt)
    first = int(sched.sampler(logits)[0])
    _charge(sched, ticket, slot, tp, len(r.prompt), "prefill")
    sched._activate(ticket, slot, first, int(clen[0]), t0)


def admit_prefix_resume(sched, ticket: _Ticket, slot: int, res,
                        matched: int, t0: float) -> None:
    """Prefix-cache hit on the one-shot path: the matched prompt rows'
    K/V already sit in resident pool blocks (now mapped into this slot's
    table), so prefill runs only over the unmatched tail: a scratch
    cache is seeded with the matched rows and one ``prefill_extend``
    resumes mid-prompt. The insert then writes only the private pages."""
    r = ticket.req
    tp = time.perf_counter()
    scratch = T.init_cache(sched.cfg, 1, sched._scratch_len,
                           device=sched.device)
    scratch = sched.layout.seed_scratch(scratch, res, matched)
    tail = torch.as_tensor(np.ascontiguousarray(r.prompt[matched:])[None],
                           dtype=torch.int64, device=sched.device)
    logits, scratch, _ = T.prefill_extend(sched.model, tail, scratch,
                                          _lengths(sched, matched))
    sched.layout.insert_scratch(scratch, slot)
    sched.layout.register_prefix(slot, r.prompt)
    first = int(sched.sampler(logits[:, -1])[0])
    _charge(sched, ticket, slot, tp, len(r.prompt) - matched,
            "prefill (prefix resume)")
    sched.prefill_tokens_saved += matched
    sched._activate(ticket, slot, first, len(r.prompt), t0)


def advance_chunked(sched, t0: float) -> None:
    """Run ONE prefill chunk of the in-flight chunked admission, so
    prefill work interleaves with decode steps instead of stalling them.
    On the last chunk the scratch K/V is inserted into the shared cache
    and the request joins the decode batch."""
    st = sched._chunking
    if st is None:
        return
    r = st.ticket.req
    c = sched._chunk
    real = min(c, len(r.prompt) - st.pos)
    chunk = np.zeros((1, c), np.int64)
    chunk[0, :real] = r.prompt[st.pos:st.pos + real]
    tp = time.perf_counter()
    logits, st.cache, _ = T.prefill_extend(
        sched.model, torch.as_tensor(chunk, device=sched.device), st.cache,
        _lengths(sched, st.pos))
    st.pos += real
    done = st.pos >= len(r.prompt)
    if done:
        sched.layout.insert_scratch(st.cache, st.slot)
        if sched._prefix and r.embeds is None:
            sched.layout.register_prefix(st.slot, r.prompt)
        first = int(sched.sampler(logits[:, real - 1])[0])
    _charge(sched, st.ticket, st.slot, tp, real, "prefill chunk")
    if done:
        sched._chunking = None
        sched._activate(st.ticket, st.slot, first, len(r.prompt), t0)
