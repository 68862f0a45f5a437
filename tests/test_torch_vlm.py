"""llava-next-mistral-7b's smoke config on the port against the
reference, on the CPU, in fp32: the vision frontend's projected rows
ahead of the prompt. The cases are tests/test_torch_encdec.py's (whose
docstring describes them, and which also holds seamless-m4t-medium's
and writes the fixture), split out so that each file stays quick on one
core, and the admission of a vision request: its frontend rows count
against ``max_len``.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.scheduler import Request
from test_torch_encdec import (BLOCK, _smoke, check_clis, check_golden,
                               check_graph_refusal, check_smoke_model,
                               load_golden)


def test_smoke_model_matches_jax():
    check_smoke_model("llava")


def test_actor_graph_export_refuses_the_frontend():
    check_graph_refusal("llava")


def test_serve_and_train_clis_take_the_config():
    check_clis("llava")


def test_golden_fixture_replays_through_the_port():
    check_golden(load_golden(), "llava")


@pytest.mark.parametrize("prompt_len,max_new", [(16, 1), (9, 5)])
def test_vision_rows_count_at_admission(prompt_len, max_new):
    """(b): 8 frontend rows + the prompt (+ the new tokens) past a
    ``max_len`` of 20 are refused on both layouts, as is a request
    without embeds; 8 + 9 + 4 rows fit."""
    cfg, model = _smoke("llava")
    emb = np.zeros((cfg.frontend_tokens, cfg.frontend_dim), np.float32)
    for kw in ({}, dict(kv_layout="paged", block_size=BLOCK)):
        eng = Engine(cfg, model, EngineConfig(max_len=20, max_slots=2,
                                              admission="fifo", **kw),
                     device="cpu")
        with pytest.raises(ValueError, match=r"frontend \(8\) \+ prompt"):
            eng.generate([Request(0, np.arange(prompt_len, dtype=np.int32),
                                  max_new_tokens=max_new, embeds=emb)])
        with pytest.raises(ValueError, match="carries none"):
            eng.generate([Request(1, np.arange(5, dtype=np.int32),
                                  max_new_tokens=2)])
        out = eng.generate([Request(2, np.arange(9, dtype=np.int32),
                                    max_new_tokens=4, embeds=emb)])
        assert len(out[0].tokens) == 4
