"""Plain PyTorch versions of the RG-LRU scan, forward and reverse: the
sequential scan of ``repro.kernels.rglru_scan.ref.rglru_scan_seq_ref``
and the gradient recurrence run backwards over time. The CPU path of
``ops.rglru_scan_fwd`` / ``ops.rglru_scan_bwd`` and the yardstick the
CUDA kernel is held against on the card."""
from __future__ import annotations

from typing import Tuple

import torch


def rglru_scan_seq_ref(a: torch.Tensor, b: torch.Tensor,
                       h0: torch.Tensor) -> torch.Tensor:
    """y_t = a_t * y_{t-1} + b_t with y_{-1} = h0. a, b: (B, S, D);
    h0: (B, D). Returns y (B, S, D)."""
    h, ys = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1)


def rglru_scan_reverse_ref(a: torch.Tensor, dy: torch.Tensor,
                           y: torch.Tensor, h0: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The gradient of ``rglru_scan_seq_ref`` given dy = dL/dy and the
    forward's y: the same recurrence from t = S-1 down to 0 with a
    shifted by one step,

        g_t = dy_t + a_{t+1} g_{t+1},  db_t = g_t,
        da_t = g_t y_{t-1} (y_{-1} = h0),  dh0 = a_0 g_0.

    Returns (da, db, dh0)."""
    s = a.shape[1]
    g = dy[:, s - 1]
    gs = [g]
    for t in range(s - 2, -1, -1):
        g = dy[:, t] + a[:, t + 1] * g
        gs.append(g)
    db = torch.stack(gs[::-1], dim=1)
    y_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
    return db * y_prev, db, a[:, 0] * db[:, 0]
