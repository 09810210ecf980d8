"""CUDA ``flash_attention``: blocked online-softmax GQA attention
(``csrc/flash_attention.cu``).

The Hopper counterpart of ``repro.kernels.flash_attention.flash_attention``;
see ``ref.mha_ref`` for the contract and the CUDA source for the design.
This wrapper validates its inputs, allocates the output and launches on
PyTorch's current stream without synchronising.
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
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 6 + [ctypes.c_float] + [_I] * 4 \
            + [_P]
        fn.restype = _I
        lib.flash_attention_max_head_dim.argtypes = []
        lib.flash_attention_max_head_dim.restype = _I
    return lib, fn


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
    lib, fn = _fn()
    if d > lib.flash_attention_max_head_dim():
        raise ValueError(f"flash_attention: head dim {d} is above the "
                         f"kernel's {lib.flash_attention_max_head_dim()}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, hq, hkv, sq, sk, d, float(scale), int(causal),
                 int(window is not None), 0 if window is None else int(window),
                 _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
