"""CUDA ``flash_attention``: blocked online-softmax GQA attention, in two
designs picked by dtype and head dim (:func:`_design`).

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 at head dims 64,
  128 and 256, every head dim of the repo's configs.  Tensor cores fed by
  TMA; P @ V keeps the fp32 contract by splitting P into two bf16 terms.
- ``"fma"`` (``csrc/flash_attention.cu``): fp32 inputs, and bf16 at any
  other head dim up to 512.  fp32 FMA outside the tensor cores.

The Hopper counterpart of ``repro.kernels.flash_attention.flash_attention``;
see ``ref.mha_ref`` for the contract and the CUDA sources for the designs.
This wrapper validates its inputs, allocates the output and launches on
PyTorch's current stream without synchronising.  A design that cannot
build or launch raises; neither stands in for the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# Launches of the kernel since the last reset, in all and by design (plain
# counts: set them to 0 to measure a run).
launches = 0
design_launches = {"wgmma": 0, "fma": 0}

# Head dims of the tensor-core design: d * 2 bytes is a multiple of the
# 128-byte TMA box row, as its 16-byte stride rule and swizzle need.
WGMMA_HEAD_DIMS = (64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = {"wgmma": "flash_attention_wgmma", "fma": "flash_attention"}


def _design(dtype: torch.dtype, d: int) -> str:
    """The design that serves q's dtype and head dim: ``"wgmma"`` for bf16
    at 64, 128 and 256, ``"fma"`` for everything else."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS \
        else "fma"


def _fn(design: str):
    lib = _build.load(_SOURCES[design])
    if design == "wgmma":
        fn = lib.flash_attention_wgmma_launch
        if fn.argtypes is None:
            fn.argtypes = [_P] * 4 + [_I] * 6 + [ctypes.c_float] \
                + [_I] * 3 + [_P]
            fn.restype = _I
        return lib, fn
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 6 + [ctypes.c_float] + [_I] * 4 \
            + [_P]
        fn.restype = _I
        lib.flash_attention_max_head_dim.argtypes = []
        lib.flash_attention_max_head_dim.restype = _I
    return lib, fn


def _launch(design: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int],
            scale: Optional[float]) -> torch.Tensor:
    """Launch one design on validated inputs; counts nothing."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    lib, fn = _fn(design)
    if design == "fma" and d > lib.flash_attention_max_head_dim():
        raise ValueError(f"flash_attention: head dim {d} is above the "
                         f"kernel's {lib.flash_attention_max_head_dim()}")
    if design == "wgmma" and any(t.data_ptr() % 16
                                 for t in (q, k, v)):
        raise ValueError("flash_attention: the tensor-core design needs "
                         "16-byte aligned q, k and v")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, sk, d, float(scale), int(causal),
            int(window is not None), 0 if window is None else int(window)]
    if design == "fma":
        args.append(_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"flash_attention ({design})")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, hq, sq, d); k, v: (b, hkv, sk, d), hq % hkv == 0, all
    contiguous fp32 or all bf16 on one CUDA device.  Returns
    (b, hq, sq, d) in q's dtype; see ``ref.mha_ref``."""
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-d "
                         "(batch, heads, seq, head_dim)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not float32 "
                        "or bfloat16")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: hq={hq} is not a multiple of "
                         f"hkv={hkv}")
    for t, name, shape in ((q, "q", (b, hq, sq, d)),
                           (k, "k", (b, hkv, sk, d)),
                           (v, "v", (b, hkv, sk, d))):
        if t.device != dev or t.dtype != q.dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"flash_attention: {name} must be a contiguous {q.dtype} "
                f"tensor of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    design = _design(q.dtype, d)
    out = _launch(design, q, k, v, causal, window, scale)
    launches += 1
    design_launches[design] += 1
    return out
