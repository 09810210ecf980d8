"""SimHash sketches (the SimHash half of ``repro.core.lsh``).

h(x) = sign(<x, z>), z ~ N(0, I), M slots per repetition.  The projection
is drawn with :mod:`repro_torch.prng` from the same key as the JAX
package, so the sketch words agree bit for bit.  LSH mode folds a sketch
into one bucket id (:func:`bucket_key`); the Hamming prefilter compares
packed sketches (:func:`hamming_pairwise`).  MinHash, weighted MinHash
and the mixture family come with the non-dense measures in a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.core import hashing
from repro_torch.similarity.measures import PointFeatures


@dataclasses.dataclass(frozen=True)
class HashFamilyConfig:
    """Sketching family: ``kind`` and sketch dimension ``m`` (M).

    Same fields and defaults as ``repro.core.lsh.HashFamilyConfig``;
    only ``kind='simhash'`` is ported so far.
    """

    kind: str = "simhash"
    m: int = 16
    mixture_sim_prob: float = 0.5


def simhash_bits(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """(n, d) x (d, m) -> (n, m) bool sign bits.

    The product runs in float64: its sign then no longer depends on the
    order the device sums in, so CUDA and CPU builds sketch identically
    (a float32 product flips a sign wherever |<x, z>| is within rounding
    of zero, which at n = 10**6 happens every few repetitions).
    """
    return (x.double() @ proj.double()) > 0


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (n, m) bool -> (n, ceil(m/32)) words, little-endian bits.

    The words are uint32 values carried in int64.
    """
    n, m = bits.shape
    n_words = (m + 31) // 32
    pad = n_words * 32 - m
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(n, n_words, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (b << shifts).sum(-1)


def hamming_pairwise(packed_a: torch.Tensor,
                     packed_b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distance between packed sketches.

    packed_a: (..., A, w); packed_b: (..., B, w) uint32 words carried in
    int64 -> (..., A, B) int32.  The JAX package's popcount bit trick; in
    int64 the byte sum ``(x * 0x01010101) >> 24`` keeps the bits above 32,
    so it is masked to 8 bits.
    """
    x = packed_a[..., :, None, :] ^ packed_b[..., None, :, :]
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) >> 24) & 0xFF
    return x.sum(-1, dtype=torch.int32)


def sketch(features: PointFeatures, cfg: HashFamilyConfig, *,
           rep_seed: int) -> torch.Tensor:
    """One repetition's sketch: (n, M) bool SimHash bits.

    ``rep_seed`` distinguishes repetitions, exactly as in the JAX package
    (the key is ``fold_in(key(0), rep_seed)``).
    """
    if cfg.kind != "simhash":
        raise NotImplementedError(
            f"hash family {cfg.kind!r} is not ported yet (only 'simhash'); "
            "MinHash and the mixture family come with the non-dense "
            "measures")
    k = prng.fold_in(prng.key(0), rep_seed)
    proj = prng.normal(k, (features.dense.shape[-1], cfg.m),
                       device=features.device)
    return simhash_bits(features.dense, proj)


def bucket_key(bits: torch.Tensor, cfg: HashFamilyConfig) -> torch.Tensor:
    """Fold an (n, M) SimHash sketch into one uint32 bucket id per point
    (LSH mode, Stars 1), carried in int64: equal sketches, equal ids."""
    if cfg.kind != "simhash":
        raise NotImplementedError(
            f"bucket_key for hash family {cfg.kind!r} is not ported yet "
            "(only 'simhash')")
    return hashing.fold_words(pack_bits(bits.to(torch.bool)))
