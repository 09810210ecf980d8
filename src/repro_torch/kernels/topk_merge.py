"""CUDA ``topk_merge``: per-node top-k degree-slab merge (``csrc/topk_merge.cu``).

The Hopper counterpart of ``repro.kernels.topk_merge.topk_merge``; it
computes ``ref.topk_merge_ref`` exactly.  This wrapper validates its
inputs, allocates the outputs and launches on PyTorch's current stream
without synchronising.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

# Launches of the kernel since the last reset (a plain count: set it to 0
# to measure a run).
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    lib = _build.load("topk_merge")
    fn = lib.topk_merge_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 3 + [_P]
        fn.restype = _I
        lib.topk_merge_max_entries.argtypes = []
        lib.topk_merge_max_entries.restype = _I
    return lib, fn


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
    lib, fn = _fn()
    if k + kin > lib.topk_merge_max_entries():
        raise ValueError(f"topk_merge: k + kin = {k + kin} exceeds the "
                         f"kernel's {lib.topk_merge_max_entries()} entries "
                         "per row")
    out_nbr = torch.empty((n, k), dtype=torch.int32, device=dev)
    out_w = torch.empty((n, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(slab_nbr.data_ptr(), slab_w.data_ptr(), inc_nbr.data_ptr(),
                 inc_w.data_ptr(), out_nbr.data_ptr(), out_w.data_ptr(),
                 n, k, kin, stream)
    _build.check(err, "topk_merge")
    launches += 1
    return out_nbr, out_w
