"""CUDA ``leader_score``: masked similarity tiles (``csrc/leader_score.cu``),
in three designs picked by the tile's shape alone (:func:`_design`).

- ``"pipe"``: tiles of s x W >= 256 with d % 4 == 0 and d <= 512 (the
  Hamming-prefilter path's 25 x 250 at d = 128).  Persistent blocks
  walking (window, leader tile, member tile) items through a ring of
  shared-memory stages filled by TMA; warps that normalise the next
  item's rows beside warps that score this one.
- ``"tile"``: the other tiles of s x W >= 256 (d not a multiple of 4, or
  d > 512).  One block per window, the tiles staged synchronously
  (``csrc/tiles.cuh``).
- ``"rows"``: s x W < 256 (LSH-Stars' 1 x 1 tiles).  One warp per
  (window, leader), lanes over d.

The Hopper counterpart of ``repro.kernels.leader_score.leader_score``;
every design computes ``ref.leader_score_ref`` (the oracle's division by
the row norm, not the Pallas kernel's rsqrt).  This wrapper validates its
inputs, allocates the output and launches on PyTorch's current stream
without synchronising.  A design that cannot launch raises; none stands
in for another.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Launches of the kernel since the last reset, in all and by design (plain
# counts: set them to 0 to measure a run).
launches = 0
design_launches = {"pipe": 0, "tile": 0, "rows": 0}

# Widest row of the pipe design: one stage of the ring must fit a block.
PIPE_MAX_D = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_DESIGNS = {"tile": 1, "rows": 2, "pipe": 3}


def _design(s: int, w: int, d: int) -> str:
    """The design that serves (s, W, d) tiles: ``"rows"`` below 256
    similarities a window, else ``"pipe"`` for rows of whole float4s up to
    ``PIPE_MAX_D`` wide and ``"tile"`` for the rest."""
    if s * w < 256:
        return "rows"
    return "pipe" if d % 4 == 0 and d <= PIPE_MAX_D else "tile"


def _fn():
    fn = _build.load("leader_score").leader_score_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [ctypes.c_longlong] + [_I] * 5 + [_P]
        fn.restype = _I
    return fn


def _launch(design: str, leaders: torch.Tensor, members: torch.Tensor,
            leader_ok: torch.Tensor, member_ok: torch.Tensor,
            normalized: bool) -> torch.Tensor:
    """Launch one design on validated inputs; counts nothing."""
    nw, s, d = leaders.shape
    w = members.shape[1]
    if design == "pipe" and (leaders.data_ptr() % 16
                             or members.data_ptr() % 16):
        raise ValueError("leader_score: the pipe design needs 16-byte "
                         "aligned leaders and members")
    dev = leaders.device
    sims = torch.empty((nw, s, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(leaders.data_ptr(), members.data_ptr(),
                    leader_ok.data_ptr(), member_ok.data_ptr(),
                    sims.data_ptr(), nw, s, w, d, int(normalized),
                    _DESIGNS[design], stream)
    _build.check(err, f"leader_score ({design})")
    return sims


def leader_score(leaders: torch.Tensor, members: torch.Tensor,
                 leader_ok: torch.Tensor, member_ok: torch.Tensor, *,
                 normalized: bool = True) -> torch.Tensor:
    """Launch on CUDA tensors; see ``ref.leader_score_ref``."""
    global launches
    dev = leaders.device
    if dev.type != "cuda":
        raise ValueError(f"leader_score kernel needs CUDA tensors, got {dev}")
    nw, s, d = leaders.shape
    w = members.shape[1]
    for t, name, dtype, shape in (
            (leaders, "leaders", torch.float32, (nw, s, d)),
            (members, "members", torch.float32, (nw, w, d)),
            (leader_ok, "leader_ok", torch.bool, (nw, s)),
            (member_ok, "member_ok", torch.bool, (nw, w))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"leader_score: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    design = _design(s, w, d)
    sims = _launch(design, leaders, members, leader_ok, member_ok,
                   normalized)
    launches += 1
    design_launches[design] += 1
    return sims
