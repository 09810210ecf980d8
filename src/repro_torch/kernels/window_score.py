"""CUDA ``window_score``: fused Stars window scoring (``csrc/window_score.cu``),
in two designs picked by the tile's shape alone (:func:`_design`).

- ``"pipe"``: tiles of s x W >= 256 with d % 4 == 0 and d <= 512 (the
  main path's 25 x 250 at d = 128).  ``csrc/pipe.cuh``'s staging, shared
  with ``leader_score``: persistent blocks walking (window, leader tile,
  member tile) items through a ring of shared-memory stages filled by
  TMA, warps that normalise the next item's rows (and stage its mask
  inputs) beside warps that score this one and run the mask chain.
- ``"tile"``: the other tiles (d not a multiple of 4, d > 512 as the LM
  path's embeddings, or s x W < 256).  One block per window, the tiles
  staged synchronously (``csrc/tiles.cuh``).

The Hopper counterpart of ``repro.kernels.window_score.window_score``; see
``ref.window_score_ref`` for the argument and return contract.  This
wrapper validates its inputs, allocates the outputs and launches on
PyTorch's current stream without synchronising.  A design that cannot
launch raises; none stands in for another.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# Launches of the kernel since the last reset, in all, by design and by
# the mask the launch applied: "new" for an extension round's
# (new_from > 0), "refresh" for a refresh round's (refresh_below > 0, with
# the sampled window keep), "none" otherwise (plain counts: set them to 0
# to measure a run).
launches = 0
design_launches = {"pipe": 0, "tile": 0}
mask_launches = {"none": 0, "new": 0, "refresh": 0}

# Widest row of the pipe design: one stage of the ring must fit a block.
PIPE_MAX_D = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_DESIGNS = {"tile": 1, "pipe": 2}


def _design(s: int, w: int, d: int) -> str:
    """The design that serves (s, W, d) tiles: ``"pipe"`` for tiles of at
    least 256 similarities with rows of whole float4s up to
    ``PIPE_MAX_D`` wide, ``"tile"`` for the rest."""
    if s * w >= 256 and d % 4 == 0 and d <= PIPE_MAX_D:
        return "pipe"
    return "tile"


def _fn():
    fn = _build.load("window_score").window_score_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 14 + [_I] * 10 + [ctypes.c_float, _I, _P]
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
    design = _design(s, w, d)
    out = _launch(design, leaders, members, leader_slot, lead_gid, gid,
                  leader_ok, member_ok, lead_bucket, bucket, keep,
                  normalized=normalized, allpairs=allpairs,
                  match_bucket=match_bucket, new_from=new_from,
                  refresh_below=refresh_below, r1=r1)
    launches += 1
    design_launches[design] += 1
    mask_launches[_mask_kind(new_from, refresh_below)] += 1
    return out


def _mask_kind(new_from: int, refresh_below: int) -> str:
    """The ``mask_launches`` key of a launch's round masks."""
    if refresh_below > 0:
        return "refresh"
    return "new" if new_from > 0 else "none"


def _launch(design: str, leaders, members, leader_slot, lead_gid, gid,
            leader_ok, member_ok, lead_bucket, bucket, keep, *,
            normalized: bool = True, allpairs: bool = False,
            match_bucket: bool = False, new_from: int = 0,
            refresh_below: int = 0, r1: Optional[float] = None):
    """Launch one design on validated inputs; counts nothing."""
    nw, s, d = leaders.shape
    w = members.shape[1]
    if design == "pipe" and (leaders.data_ptr() % 16
                             or members.data_ptr() % 16):
        raise ValueError("window_score: the pipe design needs 16-byte "
                         "aligned leaders and members")
    dev = leaders.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    sims = torch.empty((nw, s, w), dtype=f32, device=dev)
    emit = torch.empty((nw, s, w), dtype=b, device=dev)
    comparisons = torch.empty((nw,), dtype=i32, device=dev)
    emitted = torch.empty((nw,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(leaders.data_ptr(), members.data_ptr(),
                    leader_slot.data_ptr(), lead_gid.data_ptr(),
                    gid.data_ptr(), leader_ok.data_ptr(),
                    member_ok.data_ptr(), lead_bucket.data_ptr(),
                    bucket.data_ptr(), keep.data_ptr(), sims.data_ptr(),
                    emit.data_ptr(), comparisons.data_ptr(),
                    emitted.data_ptr(), nw, s, w, d, int(normalized),
                    int(allpairs), int(match_bucket), int(new_from),
                    int(refresh_below), int(r1 is not None),
                    0.0 if r1 is None else float(r1), _DESIGNS[design],
                    stream)
    _build.check(err, f"window_score ({design})")
    return sims, emit, comparisons, emitted
