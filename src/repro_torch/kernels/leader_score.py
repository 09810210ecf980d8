"""CUDA ``leader_score``: masked similarity tiles (``csrc/leader_score.cu``).

The Hopper counterpart of ``repro.kernels.leader_score.leader_score``; it
computes ``ref.leader_score_ref`` (the oracle's division by the row norm,
not the Pallas kernel's rsqrt).  This wrapper validates its inputs,
allocates the output and launches on PyTorch's current stream without
synchronising.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Launches of the kernel since the last reset (a plain count: set it to 0
# to measure a run).
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    lib = _build.load("leader_score")
    fn = lib.leader_score_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [ctypes.c_longlong] + [_I] * 4 + [_P]
        fn.restype = _I
        lib.leader_score_auto_path.argtypes = [_I, _I]
        lib.leader_score_auto_path.restype = _I
    return lib, fn


def auto_path(s: int, w: int) -> str:
    """The design the kernel picks for (s, W) tiles: 'tile' or 'rows'."""
    lib, _ = _fn()
    return {1: "tile", 2: "rows"}[lib.leader_score_auto_path(s, w)]


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
    _, fn = _fn()
    sims = torch.empty((nw, s, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(leaders.data_ptr(), members.data_ptr(),
                 leader_ok.data_ptr(), member_ok.data_ptr(), sims.data_ptr(),
                 nw, s, w, d, int(normalized), stream)
    _build.check(err, "leader_score")
    launches += 1
    return sims
