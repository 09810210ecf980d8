"""CUDA ``flash_attention``: blocked online-softmax GQA attention, in two
designs picked by dtype and head dim (:func:`_design`), its backward
``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``), and the
``FlashAttention`` autograd Function that joins them.

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 at head dims 64,
  128 and 256, every head dim of the repo's configs.  Tensor cores fed by
  TMA; P @ V keeps the fp32 contract by splitting P into two bf16 terms.
- ``"fma"`` (``csrc/flash_attention.cu``): fp32 inputs, and bf16 at any
  other head dim up to 512.  fp32 FMA outside the tensor cores.

Both designs write each row's log-sum-exp when asked (``return_lse``),
which the backward reads instead of the scores.  The backward has one
design: fp32 FMA, fp32 and bf16 inputs, head dims up to 256.

The Hopper counterpart of ``repro.kernels.flash_attention.flash_attention``
(the JAX package has no backward kernel: it differentiates ``ref.mha_ref``);
see ``ref.mha_lse_ref`` and ``ref.mha_bwd_ref`` for the contracts and the
CUDA sources for the designs.  The wrappers validate their inputs,
allocate the outputs and launch on PyTorch's current stream without
synchronising.  A design that cannot build or launch raises; neither
stands in for the other, and nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# Launches of the forward kernel since the last reset, in all and by
# design, and of the backward (plain counts: set them to 0 to measure a
# run).
launches = 0
design_launches = {"wgmma": 0, "fma": 0}
bwd_launches = 0

# Largest head dim the backward kernel takes.
BWD_MAX_HEAD_DIM = 256

# Head dims of the tensor-core design: d * 2 bytes is a multiple of the
# 128-byte TMA box row, as its 16-byte stride rule and swizzle need.
WGMMA_HEAD_DIMS = (64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = {"wgmma": "flash_attention_wgmma", "fma": "flash_attention",
            "bwd": "flash_attention_bwd"}


def _design(dtype: torch.dtype, d: int) -> str:
    """The design that serves q's dtype and head dim: ``"wgmma"`` for bf16
    at 64, 128 and 256, ``"fma"`` for everything else."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS \
        else "fma"


def _fn(design: str):
    lib = _build.load(_SOURCES[design])
    if design == "bwd":
        fn = lib.flash_attention_bwd_launch
        if fn.argtypes is None:
            fn.argtypes = [_P] * 10 + [_I] * 6 + [ctypes.c_float] \
                + [_I] * 4 + [_P]
            fn.restype = _I
        return lib, fn
    if design == "wgmma":
        fn = lib.flash_attention_wgmma_launch
        if fn.argtypes is None:
            fn.argtypes = [_P] * 5 + [_I] * 6 + [ctypes.c_float] \
                + [_I] * 3 + [_P]
            fn.restype = _I
        return lib, fn
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 6 + [ctypes.c_float] + [_I] * 4 \
            + [_P]
        fn.restype = _I
        lib.flash_attention_max_head_dim.argtypes = []
        lib.flash_attention_max_head_dim.restype = _I
    return lib, fn


def _launch(design: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int], scale: Optional[float],
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch one design on validated inputs; counts nothing.  With
    ``lse`` (fp32 (b, hq, sq)) the kernel also writes each row's
    log-sum-exp there."""
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
            None if lse is None else lse.data_ptr(),
            b, hq, hkv, sq, sk, d, float(scale), int(causal),
            int(window is not None), 0 if window is None else int(window)]
    if design == "fma":
        args.append(_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"flash_attention ({design})")
    return out


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **same_as_q: torch.Tensor) -> None:
    """Raise unless q (b, hq, sq, d), k and v (b, hkv, sk, d) and the
    tensors of q's shape in ``same_as_q`` are contiguous, of one dtype
    (fp32 or bf16), on one CUDA device, with hq % hkv == 0."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what}: q, k and v must be 4-d "
                         "(batch, heads, seq, head_dim)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} is not float32 "
                        "or bfloat16")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{what}: hq={hq} is not a multiple of hkv={hkv}")
    for t, name, shape in ((q, "q", (b, hq, sq, d)),
                           (k, "k", (b, hkv, sk, d)),
                           (v, "v", (b, hkv, sk, d)),
                           *((t, n, (b, hq, sq, d))
                             for n, t in same_as_q.items())):
        if t.device != dev or t.dtype != q.dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {q.dtype} "
                f"tensor of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """q: (b, hq, sq, d); k, v: (b, hkv, sk, d), hq % hkv == 0, all
    contiguous fp32 or all bf16 on one CUDA device.  Returns
    (b, hq, sq, d) in q's dtype, and with ``return_lse`` also the fp32
    (b, hq, sq) log-sum-exp of each row; see ``ref.mha_lse_ref``."""
    global launches
    _check("flash_attention", q, k, v)
    design = _design(q.dtype, q.shape[3])
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) \
        if return_lse else None
    out = _launch(design, q, k, v, causal, window, scale, lse)
    launches += 1
    design_launches[design] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """The backward kernel: q, o, do (b, hq, sq, d), k, v (b, hkv, sk, d),
    all contiguous fp32 or all bf16 on one CUDA device, head dim up to
    256; lse the forward's fp32 (b, hq, sq).  Returns dq, dk, dv in q's
    dtype; see ``ref.mha_bwd_ref``."""
    global bwd_launches
    _check("flash_attention_bwd", q, k, v, o=o, do=do)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > BWD_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dim {d} is above the "
                         f"kernel's {BWD_MAX_HEAD_DIM}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq) \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         f"float32 tensor of shape {(b, hq, sq)} on "
                         f"{q.device}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _, fn = _fn("bwd")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, hq, hkv, sq, sk, d, float(scale), int(causal),
                 int(window is not None),
                 0 if window is None else int(window), _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


def backward_supported(q: torch.Tensor) -> bool:
    """Whether :func:`flash_attention_bwd` takes q's dtype and head dim."""
    return q.dtype in _DTYPES and q.shape[-1] <= BWD_MAX_HEAD_DIM


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is :func:`flash_attention` and whose
    backward is :func:`flash_attention_bwd`: the kernels' output gets a
    ``grad_fn``, so a loss reaches q, k and v (and the projections
    before them).  With ``with_grad`` false (no gradient wanted) the
    forward asks for no log-sum-exp and saves nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                scale: Optional[float], with_grad: bool):
        if not with_grad:
            return flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
        if not backward_supported(q):
            raise ValueError(
                f"flash_attention: no backward kernel for {q.dtype} at head "
                f"dim {q.shape[-1]} (fp32 or bf16, up to "
                f"{BWD_MAX_HEAD_DIM}); a gradient was asked for")
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), lse,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None
