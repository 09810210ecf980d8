"""Synthetic stand-ins for the paper's datasets (``repro.data.synthetic``).

  * ``gaussian_mixture_points``: the Random1B/10B generator (Appendix
    D.1): mode i has mean e_(i mod d) and per-coordinate std 0.1;
  * ``mnist_like_points``: well-separated classes around unit centres;
  * ``products_like_points``: the Amazon2m analogue, a dense embedding and
    a padded "co-purchase" set biased to the point's class;
  * ``wikipedia_like_sets``: weighted word sets (Zipf-ish weights) with
    topical classes;
  * ``token_stream_batch``: deterministic, seekable LM token batches,
    batch t a pure function of (seed, t), so a restarted training run
    resumes the stream exactly.

All draw through :mod:`repro_torch.prng` with the JAX package's keys, so
the integer fields (set ids, labels, the near-duplicate choices, tokens)
equal JAX's bit for bit and the floats agree to a few ulp (the normal
draw is not bitwise: ``prng.normal``).  They run on the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.similarity.measures import PointFeatures


def _below(draw: torch.Tensor, p: float) -> torch.Tensor:
    """``uniform < p`` with ``p`` in float32, as JAX compares it."""
    return draw < torch.tensor(p, dtype=torch.float32, device=draw.device)


def _dup_sets(key: prng.Key, idx: torch.Tensor, n: int, dup_frac: float,
              dev: torch.device):
    """The near-duplicate injection: which points copy an earlier one,
    which, and the copied set with a fifth of its elements kept apart."""
    is_dup = _below(prng.uniform(prng.fold_in(key, 0), (n,), device=dev),
                    dup_frac)
    src_pt = prng.randint(prng.fold_in(key, 1), (n,), 0, n,
                          device=dev).long()
    keep_el = _below(prng.uniform(prng.fold_in(key, 2), (n, idx.shape[1]),
                                  device=dev), 0.8)
    idx = torch.where(is_dup[:, None],
                      torch.where(keep_el, idx[src_pt], idx), idx)
    return is_dup, src_pt, idx


def gaussian_mixture_points(n: int, *, d: int = 100, modes: int = 100,
                            std: float = 0.1, seed: int = 0,
                            device: DeviceLike = None
                            ) -> Tuple[PointFeatures, torch.Tensor]:
    """Appendix D.1's Random1B/10B generator, scaled to n points: N(0,
    std^2) noise plus 1 at coordinate (mode mod d).  Returns the features
    and the (n,) int32 modes."""
    dev = resolve_device(device)
    km, kx = prng.split(prng.key(seed))
    mode = prng.randint(km, (n,), 0, modes, device=dev).long()
    x = prng.normal(kx, (n, d), device=dev) * std
    x[torch.arange(n, device=dev), mode % d] += 1.0
    return PointFeatures(dense=x), mode.to(torch.int32)


def mnist_like_points(n: int = 20_000, *, d: int = 64, classes: int = 10,
                      spread: float = 0.15, seed: int = 0,
                      device: DeviceLike = None
                      ) -> Tuple[PointFeatures, torch.Tensor]:
    """Clustered dense points with cosine-separable classes: a unit
    centre per class plus ``spread`` times N(0, 1) noise.  Returns the
    features and the (n,) int32 labels."""
    dev = resolve_device(device)
    kc, km, kx = prng.split(prng.key(seed), 3)
    centers = prng.normal(kc, (classes, d), device=dev)
    centers = centers / torch.linalg.vector_norm(centers, dim=-1,
                                                 keepdim=True)
    label = prng.randint(km, (n,), 0, classes, device=dev).long()
    x = centers[label] + spread * prng.normal(kx, (n, d), device=dev)
    return PointFeatures(dense=x), label.to(torch.int32)


def products_like_points(n: int = 20_000, *, d: int = 100, classes: int = 47,
                         nnz: int = 16, universe: int = 100_000,
                         dup_frac: float = 0.0, seed: int = 0,
                         device: DeviceLike = None
                         ) -> Tuple[PointFeatures, torch.Tensor]:
    """Amazon2m analogue: a dense embedding and a co-purchase set a point.

    Sets draw about 80 % of their elements from a per-class pool of 64 and
    the rest from the whole universe; ``dup_frac`` of the points copy a
    random point (80 % of its set, its embedding plus 0.08 noise, its
    label).  Returns the features and the (n,) int32 labels.
    """
    dev = resolve_device(device)
    root = prng.key(seed)
    kc, km, kx, kp, kn, kb = prng.split(root, 6)
    centers = prng.normal(kc, (classes, d), device=dev)
    centers = centers / torch.linalg.vector_norm(centers, dim=-1,
                                                 keepdim=True)
    label = prng.randint(km, (n,), 0, classes, device=dev).long()
    dense = centers[label] + 0.4 * prng.normal(kx, (n, d), device=dev)
    pool_size = 64
    class_pool = prng.randint(kp, (classes, pool_size), 0, universe,
                              device=dev)
    pick = prng.randint(kn, (n, nnz), 0, pool_size, device=dev).long()
    from_pool = class_pool[label[:, None], pick]
    noise = prng.randint(kb, (n, nnz), 0, universe, device=dev)
    coin = _below(prng.uniform(prng.fold_in(kb, 1), (n, nnz), device=dev),
                  0.8)
    idx = torch.where(coin, from_pool, noise).to(torch.int32)
    if dup_frac > 0:
        kd = prng.fold_in(root, 7)
        is_dup, src_pt, idx = _dup_sets(kd, idx, n, dup_frac, dev)
        jitter = 0.08 * prng.normal(prng.fold_in(kd, 3), (n, d), device=dev)
        dense = torch.where(is_dup[:, None], dense[src_pt] + jitter, dense)
        label = torch.where(is_dup, label[src_pt], label)
    feats = PointFeatures(
        dense=dense.contiguous(), set_idx=idx.contiguous(),
        set_w=torch.ones((n, nnz), dtype=torch.float32, device=dev),
        set_mask=torch.ones((n, nnz), dtype=torch.bool, device=dev))
    return feats, label.to(torch.int32)


def wikipedia_like_sets(n: int = 20_000, *, classes: int = 20, nnz: int = 32,
                        universe: int = 200_000, dup_frac: float = 0.0,
                        seed: int = 0, device: DeviceLike = None
                        ) -> Tuple[PointFeatures, torch.Tensor]:
    """Weighted-set points (a word multiset analogue) with topical classes.

    Sets draw about 75 % of their elements from a per-class pool of 128;
    weights are log-normal over a Zipf-ish factor of the element id.
    ``dup_frac`` of the points copy 80 % of a random point's set and its
    label.  Returns the set-only features and the (n,) int32 labels.
    """
    dev = resolve_device(device)
    root = prng.key(seed)
    km, kp, kn, kb, kw = prng.split(root, 5)
    label = prng.randint(km, (n,), 0, classes, device=dev).long()
    pool_size = 128
    class_pool = prng.randint(kp, (classes, pool_size), 0, universe,
                              device=dev)
    pick = prng.randint(kn, (n, nnz), 0, pool_size, device=dev).long()
    from_pool = class_pool[label[:, None], pick]
    noise = prng.randint(kb, (n, nnz), 0, universe, device=dev)
    coin = _below(prng.uniform(prng.fold_in(kb, 1), (n, nnz), device=dev),
                  0.75)
    idx = torch.where(coin, from_pool, noise).to(torch.int32)
    if dup_frac > 0:
        is_dup, src_pt, idx = _dup_sets(prng.fold_in(root, 9), idx, n,
                                        dup_frac, dev)
        label = torch.where(is_dup, label[src_pt], label)
    w = torch.exp(prng.normal(kw, (n, nnz), device=dev) * 0.5) \
        / (1.0 + torch.remainder(idx.to(torch.float32), 97.0) / 10.0)
    feats = PointFeatures(
        set_idx=idx.contiguous(), set_w=w.to(torch.float32).contiguous(),
        set_mask=torch.ones((n, nnz), dtype=torch.bool, device=dev))
    return feats, label.to(torch.int32)


def token_stream_batch(step: int, *, batch: int, seq_len: int, vocab: int,
                       seed: int = 0, device: DeviceLike = None
                       ) -> torch.Tensor:
    """Deterministic seekable token batch (batch, seq_len) int32, a pure
    function of (seed, step), bit-equal to the JAX package's.

    Tokens follow a mixed bigram process so that an LM's loss decreases:
    with probability 0.85 token t is (token[t-1] * 31 + 7) mod vocab,
    else a uniform draw.  The recurrence runs as a loop over the
    sequence in int32, wrapping as XLA's scan does."""
    dev = resolve_device(device)
    k0, k1, _ = prng.split(prng.fold_in(prng.key(seed), step), 3)
    base = prng.randint(k0, (batch, seq_len), 0, vocab, device=dev)
    coin = _below(prng.uniform(k1, (batch, seq_len), device=dev), 0.85)
    out = base.clone()
    for t in range(1, seq_len):
        out[:, t] = torch.where(coin[:, t], (out[:, t - 1] * 31 + 7) % vocab,
                                base[:, t])
    return out
