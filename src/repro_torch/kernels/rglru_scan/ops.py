"""Checked wrappers of the RG-LRU scan kernel
(``repro_torch/csrc/rglru_scan.cu``) and its gradient.

``rglru_scan_fwd`` runs the forward scan and ``rglru_scan_bwd`` the
reverse pass; each counts its own launches (``.launches``). The kernel
is a chunked single-pass scan whose CTAs hand their chunks' carries on
through a small workspace (a few MB at the training shape), taken from
torch's caching allocator on the call's stream; its flags are zeroed by
the C entry, so nothing here waits on the device. CPU tensors
take the plain versions (``ref.py``); CUDA tensors launch the kernel or
raise — there is no fallback from the card. ``rglru_scan`` is the
differentiable entry the model calls: a ``torch.autograd.Function``
whose forward is ``rglru_scan_fwd`` and whose backward is
``rglru_scan_bwd``. Meta tensors launch nothing: each entry returns
empty outputs and adds ``rglru_scan_cost`` to the active
``kernels.cost.KernelCount``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cost import Cost, count_meta_call
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_reverse_ref,
                                                rglru_scan_seq_ref)


def _check(name: str, seq, state) -> Tuple[int, int, int]:
    """Shapes (B, S, D) of ``seq`` and (B, D) of ``state``, float32, on
    one device; returns (B, S, D)."""
    first = seq[0]
    if first.dim() != 3 or any(t.shape != first.shape for t in seq):
        raise ValueError(f"{name}: want (B, S, D) sequences of one shape, "
                         f"got {[tuple(t.shape) for t in seq]}")
    b, s, d = first.shape
    if any(t.shape != (b, d) for t in state):
        raise ValueError(f"{name}: want ({b}, {d}) states, got "
                         f"{[tuple(t.shape) for t in state]}")
    if any(t.dtype != torch.float32 for t in (*seq, *state)):
        raise TypeError(f"{name}: the scan runs in float32, got "
                        f"{[t.dtype for t in (*seq, *state)]}")
    if any(t.device != first.device for t in (*seq, *state)):
        raise ValueError(f"{name}: tensors on different devices")
    if first.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: no kernel for {first.device}")
    if first.device.type == "cuda" and (
            0 in (b, s, d)
            or not all(t.is_contiguous() for t in (*seq, *state))):
        raise ValueError(f"{name}: the kernel takes contiguous, non-empty "
                         f"tensors")
    return b, s, d


@functools.lru_cache(maxsize=64)
def _workspace_bytes(shape: Tuple[int, int, int], reverse: bool) -> int:
    """Bytes of workspace the kernel needs at (B, S, D)."""
    n = ctypes.c_longlong()
    _build.check(_build.entry("rglru_scan_workspace")(*shape, int(reverse),
                                                      ctypes.byref(n)),
                 "rglru_scan_workspace")
    return n.value


def _workspace(a: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The kernel's scratch for a scan over ``a``: from torch's caching
    allocator, ordered on the current stream."""
    return torch.empty(_workspace_bytes(tuple(a.shape), reverse),
                       dtype=torch.uint8, device=a.device)


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """y_t = a_t * y_{t-1} + b_t from y_{-1} = h0. a, b: (B, S, D)
    float32; h0: (B, D). Returns y (B, S, D)."""
    bsz, s, d = _check("rglru_scan_fwd", (a, b), (h0,))
    if a.device.type == "cpu":
        return rglru_scan_seq_ref(a, b, h0)
    if a.device.type == "meta":
        count_meta_call("rglru_scan_fwd", rglru_scan_cost(bsz, s, d))
        return torch.empty_like(a)
    y = torch.empty_like(a)
    fn = _build.entry("rglru_scan_fwd")
    with torch.cuda.device(a.device):
        ws = _workspace(a, reverse=False)
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
                  ws.data_ptr(), ws.numel(), bsz, s, d, stream)
    _build.check(code, "rglru_scan_fwd")
    _build.count_launch(rglru_scan_fwd)
    return y


rglru_scan_fwd.launches = 0


def rglru_scan_bwd(a: torch.Tensor, dy: torch.Tensor, y: torch.Tensor,
                   h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's gradient from dy = dL/dy and the forward's y, in one
    reverse pass over time. Returns (da, db, dh0)."""
    bsz, s, d = _check("rglru_scan_bwd", (a, dy, y), (h0,))
    if a.device.type == "cpu":
        return rglru_scan_reverse_ref(a, dy, y, h0)
    if a.device.type == "meta":
        count_meta_call("rglru_scan_bwd",
                        rglru_scan_cost(bsz, s, d, reverse=True))
        return torch.empty_like(a), torch.empty_like(a), \
            torch.empty_like(h0)
    db, da = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    fn = _build.entry("rglru_scan_bwd")
    with torch.cuda.device(a.device):
        ws = _workspace(a, reverse=True)
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(a.data_ptr(), dy.data_ptr(), y.data_ptr(), h0.data_ptr(),
                  db.data_ptr(), da.data_ptr(), dh0.data_ptr(), ws.data_ptr(),
                  ws.numel(), bsz, s, d, stream)
    _build.check(code, "rglru_scan_bwd")
    _build.count_launch(rglru_scan_bwd)
    return da, db, dh0


rglru_scan_bwd.launches = 0


def rglru_scan_cost(b: int, s: int, d: int, *, reverse: bool = False
                    ) -> Cost:
    """One scan call's least work over (B, S, D) fp32, n = B S D.
    Forward: 2 operations a step (a y + b); a and b read and y written
    (12 n bytes), and 8 B D bytes of (B, D) state around h0. Reverse: 3
    operations a step; a, dy and y read, da and db written (20 n), and
    12 B D of state around h0 and dh0."""
    n = b * s * d
    if reverse:
        return Cost(3 * n, 20 * n + 12 * b * d)
    return Cost(2 * n, 12 * n + 8 * b * d)


class RGLRUScan(torch.autograd.Function):
    """The scan with its gradient: forward ``rglru_scan_fwd``, backward
    ``rglru_scan_bwd`` (each looked up when called, so a caller may put
    the plain versions in their place)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        a, b, h0 = a.contiguous(), b.contiguous(), h0.contiguous()
        y = rglru_scan_fwd(a, b, h0)
        ctx.save_for_backward(a, y, h0)
        return y

    @staticmethod
    def backward(ctx, dy):
        a, y, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_bwd(a, dy.contiguous(), y, h0)
        return da, db, dh0


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """Differentiable scan: y (B, S, D) of a, b (B, S, D) from h0 (B, D),
    float32."""
    return RGLRUScan.apply(a, b, h0)
