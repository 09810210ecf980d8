"""CUDA ``window_score``: fused Stars window scoring (``csrc/window_score.cu``).

The Hopper counterpart of ``repro.kernels.window_score.window_score``; see
``ref.window_score_ref`` for the argument and return contract and the CUDA
source for the design.  This wrapper validates its inputs, allocates the
outputs and launches on PyTorch's current stream without synchronising.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# Launches of the kernel since the last reset (a plain count: set it to 0
# to measure a run).
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load("window_score").window_score_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 14 + [_I] * 10 + [ctypes.c_float, _P]
        fn.restype = _I
    return fn


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
             device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"window_score: {name} is on {t.device}, "
                         f"leaders on {device}")
    if t.dtype != dtype:
        raise TypeError(f"window_score: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"window_score: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"window_score: {name} must be contiguous")


def window_score(leaders: torch.Tensor, members: torch.Tensor,
                 leader_slot: torch.Tensor, lead_gid: torch.Tensor,
                 gid: torch.Tensor, leader_ok: torch.Tensor,
                 member_ok: torch.Tensor, lead_bucket: torch.Tensor,
                 bucket: torch.Tensor, keep: torch.Tensor, *,
                 normalized: bool = True, allpairs: bool = False,
                 match_bucket: bool = False, new_from: int = 0,
                 refresh_below: int = 0, r1: Optional[float] = None):
    """Launch the fused kernel on CUDA tensors; see ``ref.window_score_ref``."""
    global launches
    dev = leaders.device
    if dev.type != "cuda":
        raise ValueError(f"window_score kernel needs CUDA tensors, got {dev}")
    nw, s, d = leaders.shape
    w = members.shape[1]
    i32, f32, b = torch.int32, torch.float32, torch.bool
    for t, name, dtype, shape in (
            (leaders, "leaders", f32, (nw, s, d)),
            (members, "members", f32, (nw, w, d)),
            (leader_slot, "leader_slot", i32, (nw, s)),
            (lead_gid, "lead_gid", i32, (nw, s)),
            (gid, "gid", i32, (nw, w)),
            (leader_ok, "leader_ok", b, (nw, s)),
            (member_ok, "member_ok", b, (nw, w)),
            (lead_bucket, "lead_bucket", i32, (nw, s)),
            (bucket, "bucket", i32, (nw, w)),
            (keep, "keep", b, (nw,))):
        _require(t, name, dtype, shape, dev)
    fn = _fn()
    sims = torch.empty((nw, s, w), dtype=f32, device=dev)
    emit = torch.empty((nw, s, w), dtype=b, device=dev)
    comparisons = torch.empty((nw,), dtype=i32, device=dev)
    emitted = torch.empty((nw,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(leaders.data_ptr(), members.data_ptr(),
                 leader_slot.data_ptr(), lead_gid.data_ptr(), gid.data_ptr(),
                 leader_ok.data_ptr(), member_ok.data_ptr(),
                 lead_bucket.data_ptr(), bucket.data_ptr(), keep.data_ptr(),
                 sims.data_ptr(), emit.data_ptr(), comparisons.data_ptr(),
                 emitted.data_ptr(), nw, s, w, d, int(normalized),
                 int(allpairs), int(match_bucket), int(new_from),
                 int(refresh_below), int(r1 is not None),
                 0.0 if r1 is None else float(r1), stream)
    _build.check(err, "window_score")
    launches += 1
    return sims, emit, comparisons, emitted
