"""Counter-based integer hashing (``repro.core.hashing``).

uint32 values are carried in int64 tensors, as in :mod:`repro_torch.prng`
(torch's CPU shifts refuse uint32), and every result is masked back to 32
bits.  A product of two 32-bit values would overflow int64, and signed
overflow is undefined in the C++ that torch's kernels are written in, so
:func:`_mul32` multiplies by the 16-bit halves of the constant: no partial
product exceeds 2**48.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF

# murmur3 / splitmix-style 32-bit finalizer constants.
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2**32 for uint32 ``x`` (int64 tensor) and int ``c``."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return ((x * lo) + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _u32(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.to(torch.int64) & _MASK


def mix32(x) -> torch.Tensor:
    """murmur3 fmix32: a bijective 32-bit mixer."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def hash_u32(x, seed) -> torch.Tensor:
    """Hash ``x`` (any integers, taken as uint32) with a uint32 seed."""
    return mix32(_u32(x) ^ _mul32(_u32(seed), _GOLDEN))


def hash_combine(a, b) -> torch.Tensor:
    """Order-dependent combination of two uint32 hash words."""
    a, b = _u32(a), _u32(b)
    return mix32(a ^ ((b + _GOLDEN + ((a << 6) & _MASK) + (a >> 2)) & _MASK))


def fold_words(words) -> torch.Tensor:
    """Fold the trailing axis of uint32 words into one uint32 digest."""
    words = _u32(words)
    out = torch.full(words.shape[:-1], 0x811C9DC5, dtype=torch.int64,
                     device=words.device)
    for i in range(words.shape[-1]):
        out = hash_combine(out, words[..., i])
    return out


def uniform01_from_u32(bits) -> torch.Tensor:
    """Map uint32 bits to float32 in (0, 1], as the JAX package does (the
    float32 rounding takes the largest words to exactly 1.0)."""
    f = _u32(bits).to(torch.float32)
    return (f + 0.5) * torch.tensor(2.0**-32, dtype=torch.float32,
                                    device=f.device)
