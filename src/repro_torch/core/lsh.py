"""Locality-sensitive hash families (``repro.core.lsh``).

  * SimHash for cosine / angular similarity: h(x) = sign(<x, z>),
    z ~ N(0, I).
  * MinHash for Jaccard similarity over sets: h(A) = min_{u in A}
    mix32(u ^ seed).
  * Weighted MinHash by the Moulton-Jiang exponential race:
    h(x) = argmin_u -log(r_u) / w_u, the winning element id.
  * Mixture (the paper's D.2, Amazon2m): each of the M slots is a SimHash
    bit or the low bit of a MinHash word, by a coin per slot.

Every family's sketch is (n, M) uint32 words carried in int64; SimHash and
mixture words are 0 or 1.  Draws come from :mod:`repro_torch.prng` and
:mod:`repro_torch.core.hashing` with the JAX package's keys, so the words
agree bit for bit.  LSH mode folds a sketch into one bucket id
(:func:`bucket_key`); the Hamming prefilter compares packed SimHash
sketches (:func:`hamming_pairwise`).
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

    Same fields and defaults as ``repro.core.lsh.HashFamilyConfig``:
    ``kind`` is 'simhash', 'minhash', 'wminhash' or 'mixture';
    ``mixture_sim_prob`` is the chance that a mixture slot is SimHash.
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


def word_bits(cfg: HashFamilyConfig) -> int:
    """Significant bits of one sketch word: 1 for the bit-valued families
    (SimHash, mixture), 32 for the MinHash words."""
    return 1 if cfg.kind in ("simhash", "mixture") else 32


def _slot_seeds(m: int, rep_seed: int, device) -> torch.Tensor:
    return hashing.hash_u32(torch.arange(m, dtype=torch.int64,
                                         device=device), rep_seed)


def minhash_words(set_idx: torch.Tensor, set_mask: torch.Tensor,
                  seeds: torch.Tensor) -> torch.Tensor:
    """Unweighted MinHash: (n, nnz) sets x (m,) seeds -> (n, m) words.

    h_s(A) = min_{u in A} mix32(u ^ seed_s); an empty set hashes to
    0xFFFFFFFF.  One slot at a time, so the (n, nnz) hash is the largest
    temporary.
    """
    cols = [torch.where(set_mask, hashing.hash_u32(set_idx, seed),
                        0xFFFFFFFF).amin(dim=1) for seed in seeds]
    return torch.stack(cols, dim=1)


def weighted_minhash_words(set_idx: torch.Tensor, set_w: torch.Tensor,
                           set_mask: torch.Tensor,
                           seeds: torch.Tensor) -> torch.Tensor:
    """Moulton-Jiang exponential-race weighted MinHash: the winning element
    id of ``-log(r_u) / w_u`` per slot, r_u consistent across points (a
    tie goes to the first position, as ``jnp.argmin``); an empty set
    hashes to 0xFFFFFFFF."""
    w = set_w.clamp_min(1e-12)
    inf = torch.tensor(float("inf"), dtype=w.dtype, device=w.device)
    cols = []
    for seed in seeds:
        r = hashing.uniform01_from_u32(hashing.hash_u32(set_idx, seed))
        race = torch.where(set_mask, -torch.log(r) / w, inf)
        win = race.argmin(dim=1, keepdim=True)
        cols.append(set_idx.gather(1, win)[:, 0].to(torch.int64)
                    & 0xFFFFFFFF)
    won = torch.stack(cols, dim=1)
    return torch.where(set_mask.any(dim=1, keepdim=True), won, 0xFFFFFFFF)


def sketch(features: PointFeatures, cfg: HashFamilyConfig, *,
           rep_seed: int) -> torch.Tensor:
    """One repetition's sketch: (n, M) uint32 words carried in int64.

    ``rep_seed`` distinguishes repetitions, as in the JAX package (the
    SimHash key is ``fold_in(key(0), rep_seed)``, the mixture's
    ``fold_in(key(1), rep_seed)``).
    """
    m = cfg.m
    rep_seed = int(rep_seed) & 0xFFFFFFFF
    if cfg.kind == "simhash":
        k = prng.fold_in(prng.key(0), rep_seed)
        proj = prng.normal(k, (features.dense.shape[-1], m),
                           device=features.device)
        return simhash_bits(features.dense, proj).to(torch.int64)
    if cfg.kind == "minhash":
        return minhash_words(features.set_idx, features.set_mask,
                             _slot_seeds(m, rep_seed, features.device))
    if cfg.kind == "wminhash":
        return weighted_minhash_words(
            features.set_idx, features.set_w, features.set_mask,
            _slot_seeds(m, rep_seed, features.device))
    if cfg.kind == "mixture":
        kc, kp = prng.split(prng.fold_in(prng.key(1), rep_seed))
        dev = features.device
        coin = prng.uniform(kc, (m,), device=dev) < torch.tensor(
            cfg.mixture_sim_prob, dtype=torch.float32, device=dev)
        proj = prng.normal(kp, (features.dense.shape[-1], m), device=dev)
        sim = simhash_bits(features.dense, proj).to(torch.int64)
        mh = minhash_words(features.set_idx, features.set_mask,
                           _slot_seeds(m, rep_seed, dev))
        # one bit of each MinHash word: the paper mixes bits of the two
        return torch.where(coin[None, :], sim & 1, mh & 1)
    raise ValueError(f"unknown hash family kind: {cfg.kind!r}")


def bucket_key(words: torch.Tensor, cfg: HashFamilyConfig) -> torch.Tensor:
    """Fold an (n, M) sketch into one uint32 bucket id per point (LSH mode,
    Stars 1), carried in int64: equal sketches, equal ids.  Bit-valued
    words are packed first, MinHash words fold directly."""
    if cfg.kind in ("simhash", "mixture"):
        return hashing.fold_words(pack_bits(words != 0))
    return hashing.fold_words(words)
