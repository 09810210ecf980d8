"""CUDA ``simhash_packed``: SimHash bits packed to words (``csrc/simhash_packed.cu``).

The Hopper counterpart of ``repro.kernels.simhash.simhash_packed``; it
computes ``ref.simhash_packed_ref`` bit for bit (both sum the product in
fp64, the kernel on the fp64 tensor cores for every (n, d, m)).  This
wrapper validates its inputs, allocates the output and launches on
PyTorch's current stream without synchronising.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Launches of the kernel since the last reset (a plain count: set it to 0
# to measure a run).
launches = 0

_P = ctypes.c_void_p


def _fn():
    fn = _build.load("simhash_packed").simhash_packed_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2 \
            + [_P]
        fn.restype = ctypes.c_int
    return fn


def simhash_packed(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """(n, d) x (d, m) float32 on CUDA -> (n, ceil(m/32)) int32 words
    (uint32 bit patterns); see ``ref.simhash_packed_ref``."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"simhash_packed kernel needs CUDA tensors, got {dev}")
    n, d = x.shape
    m = proj.shape[1]
    for t, name, shape in ((x, "x", (n, d)), (proj, "proj", (d, m))):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"simhash_packed: {name} must be a contiguous float32 tensor "
                f"of shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    out = torch.empty((n, (m + 31) // 32), dtype=torch.int32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), proj.data_ptr(), out.data_ptr(), n, d, m,
                 stream)
    _build.check(err, "simhash_packed")
    launches += 1
    return out
