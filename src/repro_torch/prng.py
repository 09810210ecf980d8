"""threefry2x32 random draws, bit-equal to ``jax.random`` (partitionable mode).

The Stars build is edge-for-edge reproducible only if every repetition
draws the same randomness as the JAX package: the sort tiebreak, the
SortingLSH window shift, the leader priorities and the SimHash
projections.  This module reproduces ``jax.random``'s default generator
(threefry2x32 with ``jax_threefry_partitionable=True``, the default since
jax 0.5) on torch tensors:

  * a key is a pair of 32-bit words, held here as a tuple of Python ints;
    key derivation (``key`` / ``fold_in`` / ``split``) hashes one counter
    and runs on the host with no device work;
  * bulk draws (``bits`` / ``uniform`` / ``randint`` / ``normal``) hash
    the flat element index as a 64-bit counter on the target device.

uint32 arithmetic is carried in int64 tensors masked to 32 bits: torch's
CPU kernels do not implement shifts on ``torch.uint32``.

``uniform`` / ``randint`` / ``bits`` are bit-equal to JAX.  ``normal`` is
``sqrt(2) * erfinv(u)`` with XLA's single-precision inverse-erf polynomial
(Giles); it agrees with JAX to a few ulp (about 1% of draws differ), not
bitwise, because ``log1p`` differs by an ulp between libraries.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Key = Tuple[int, int]
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k1: int, k2: int, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The threefry2x32 block function (20 rounds) on uint32 words.

    ``x0`` / ``x1`` are Python ints or int64 tensors holding uint32 values.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed in [0, 2**32)."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must lie in [0, 2**32): {seed}")
    return (0, int(seed))


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: ``data`` is taken as its uint32 bit pattern."""
    return _threefry2x32(k[0], k[1], 0, int(data) & _MASK)


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(k, num)`` (the fold-like partitionable split)."""
    return [_threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def _numel(shape: Sequence[int]) -> int:
    return math.prod(shape)


def bits(k: Key, shape: Sequence[int], *,
         device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int64 values in [0, 2**32)."""
    shape = tuple(shape)
    device = resolve_device(device)
    count = torch.arange(_numel(shape), dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32(k[0], k[1], count >> 32, count & _MASK)
    return (b0 ^ b1).reshape(shape)


def uniform(k: Key, shape: Sequence[int], *, minval: float = 0.0,
            maxval: float = 1.0, dtype: torch.dtype = torch.float32,
            device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.uniform`` in float32 or bfloat16: the top 23 bits of
    a draw fill a float32 mantissa; for bfloat16 JAX draws 8 bits (its
    mantissa has 7), so the top 7 of the draw's low byte fill it."""
    device = resolve_device(device)
    b = bits(k, shape, device=device)
    if dtype == torch.float32:
        floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.bfloat16:
        floats = (((b & 0xFF) >> 1) | 0x3F80).to(torch.int16) \
            .view(torch.bfloat16)
    else:
        raise TypeError(f"uniform: dtype {dtype} is not float32 or bfloat16")
    floats = floats - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(k: Key, shape: Sequence[int], minval: int, maxval: int, *,
            device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds: two split draws reduced
    modulo the span with JAX's wrap-around uint32 arithmetic."""
    if not (-2**31 <= minval and maxval <= 2**31 - 1):
        raise ValueError("randint bounds must be int32")
    k1, k2 = split(k)
    higher = bits(k1, shape, device=device)
    lower = bits(k2, shape, device=device)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (2**16) % span
    mult = (mult * mult & _MASK) % span
    offset = ((((higher % span) * mult) & _MASK) + (lower % span)) & _MASK
    return (minval + offset % span).to(torch.int32)


# XLA's ErfInv32: Giles, "Approximating the erfinv function" (GPU Gems
# 4); the coefficient pairs apply below / at-or-above w = 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Single-precision inverse error function, XLA's polynomial."""
    x = x.to(torch.float32)
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = lambda c: torch.tensor(c, dtype=torch.float32, device=x.device)
    p = torch.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    w64 = w.double()
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # XLA contracts c + p * w into one FMA: the float32 product is
        # exact in float64, so one rounding of the float64 sum matches it
        c = torch.where(lt, f32(c_lt), f32(c_ge))
        p = (c.double() + p.double() * w64).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(k: Key, shape: Sequence[int], *,
           device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with u
    uniform on [nextafter(-1, 0), 1)."""
    device = resolve_device(device)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, minval=lo, maxval=1.0, device=device)
    return torch.tensor(math.sqrt(2), dtype=torch.float32,
                        device=device) * erf_inv(u)
