"""CUDA ``topk_merge``: per-node top-k degree-slab merge (``csrc/topk_merge.cu``).

A warp a row: cross-input duplicates through a table of the row's ids,
then a merge path over the two weight-sorted lists, the order the
accumulator's rows have.  A row that breaks that order (see the CUDA
source) is counted on the device (:func:`violations`) and merged by two
bitonic sorts in the same launch, so the output is ``ref.topk_merge_ref``'s
bit for bit on any input, for any k and kin.  The Hopper counterpart of
``repro.kernels.topk_merge.topk_merge``.  This wrapper validates its
inputs, allocates the outputs and the scratch the launch asks for, and
launches on PyTorch's current stream without synchronising.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

# Launches of the kernel since the last reset (a plain count: set it to 0
# to measure a run).
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_violations: Dict[torch.device, torch.Tensor] = {}


def _fns():
    lib = _build.load("topk_merge")
    launch, scratch = lib.topk_merge_launch, lib.topk_merge_scratch_bytes
    if launch.argtypes is None:
        launch.argtypes = [_P] * 6 + [_L, _I, _I, _P, _L, _P, _P]
        launch.restype = _I
        scratch.argtypes = [_L, _I, _I]
        scratch.restype = _L
    return launch, scratch


def violations(device) -> torch.Tensor:
    """The device's count of rows that reached the kernel breaking the
    merge's preconditions (an int64 tensor of one element on that device; the
    kernel adds to it, nothing synchronises).  Zero it to measure a run."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _violations:
        _violations[dev] = torch.zeros((1,), dtype=torch.int64, device=dev)
    return _violations[dev]


def topk_merge(slab_nbr: torch.Tensor, slab_w: torch.Tensor,
               inc_nbr: torch.Tensor, inc_w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the merge on CUDA tensors; see ``ref.topk_merge_ref``."""
    global launches
    dev = slab_nbr.device
    if dev.type != "cuda":
        raise ValueError(f"topk_merge kernel needs CUDA tensors, got {dev}")
    n, k = slab_nbr.shape
    kin = inc_nbr.shape[1]
    for t, name, dtype, shape in (
            (slab_nbr, "slab_nbr", torch.int32, (n, k)),
            (slab_w, "slab_w", torch.float32, (n, k)),
            (inc_nbr, "inc_nbr", torch.int32, (n, kin)),
            (inc_w, "inc_w", torch.float32, (n, kin))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"topk_merge: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    out_nbr = torch.empty((n, k), dtype=torch.int32, device=dev)
    out_w = torch.empty((n, k), dtype=torch.float32, device=dev)
    launch, scratch_bytes = _fns()
    with torch.cuda.device(dev):
        need = scratch_bytes(n, k, kin)
        if need < 0:
            _build.check(int(-need), "topk_merge planning")
        scratch = torch.empty((max(need, 1),), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(slab_nbr.data_ptr(), slab_w.data_ptr(),
                     inc_nbr.data_ptr(), inc_w.data_ptr(), out_nbr.data_ptr(),
                     out_w.data_ptr(), n, k, kin, scratch.data_ptr(), need,
                     violations(dev).data_ptr(), stream)
    _build.check(err, "topk_merge")
    launches += 1
    return out_nbr, out_w
