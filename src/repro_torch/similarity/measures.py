"""Point features and the closed-form similarity measures
(``repro.similarity.measures``).

``PointFeatures`` carries a dense float block and / or a padded sparse
"set" block (element ids, weights, validity mask), as in the JAX package:
MNIST-like data is dense only, Wikipedia-like data set only, and
Amazon2m-like data both (the mixture and learned measures).

Every pairwise function is batched: A-side features ``(..., A, d)`` (or
``(..., A, nnz)``) against B-side ``(..., B, ...)`` give ``(..., A, B)``
similarity blocks.

Two choices keep a pair's score bitwise the same wherever it is scored
(the pair-score cache relies on it, ``similarity/pair_cache.py``):

  * a row's squared norm is summed in float64 and rounded once, so it does
    not depend on the shape of the tile the row was gathered into (the
    order of a float32 reduction can);
  * Jaccard sums a pair's matched min-weights over the set positions in a
    fixed pairwise order, so its result does not depend on the tile's
    shape either (and chunking the A axis is bit-identical to not
    chunking).

Matmuls run in IEEE fp32 (:func:`ieee_fp32_matmul`), never TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def ieee_fp32_matmul():
    """fp32 matmuls in IEEE single precision inside the block, whatever
    the process set through ``torch.set_float32_matmul_precision`` (TF32
    would round the products to a 10-bit mantissa); the setting is
    restored after."""
    prior = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prior)


_FIELDS = ("dense", "set_idx", "set_w", "set_mask")


@dataclasses.dataclass(frozen=True)
class PointFeatures:
    """Features for a batch of points.

    Attributes:
      dense:    (n, d) float tensor, or None.
      set_idx:  (n, nnz) int32 padded element ids, or None.
      set_w:    (n, nnz) float32 weights (1.0 for unweighted sets), or None.
      set_mask: (n, nnz) bool validity of each padded slot, or None.
    """

    dense: Optional[torch.Tensor] = None
    set_idx: Optional[torch.Tensor] = None
    set_w: Optional[torch.Tensor] = None
    set_mask: Optional[torch.Tensor] = None

    def _first(self) -> torch.Tensor:
        return self.dense if self.dense is not None else self.set_idx

    @property
    def n(self) -> int:
        return self._first().shape[0]

    @property
    def device(self) -> torch.device:
        return self._first().device

    def map(self, fn) -> "PointFeatures":
        """Apply ``fn`` to every present block."""
        return PointFeatures(**{f: None if getattr(self, f) is None
                                else fn(getattr(self, f)) for f in _FIELDS})

    def take(self, indices: torch.Tensor) -> "PointFeatures":
        """Gather rows; each block gets shape ``indices.shape + (...)``."""
        return self.map(lambda x: x[indices])

    def concat(self, other: "PointFeatures") -> "PointFeatures":
        """Append another batch of points (``GraphBuilder.extend``).

        Both batches must carry the same blocks with equal trailing shapes
        and dtypes: a cast row would score differently from the caller's
        original while its gid refers to it, so a mismatch raises.
        """
        out = {}
        for name in _FIELDS:
            x, y = getattr(self, name), getattr(other, name)
            if (x is None) != (y is None):
                raise ValueError(
                    f"cannot concat: {name} present on one side only")
            if x is None:
                out[name] = None
                continue
            if x.shape[1:] != y.shape[1:]:
                raise ValueError(f"{name} trailing shapes differ: "
                                 f"{tuple(x.shape[1:])} vs "
                                 f"{tuple(y.shape[1:])}")
            if x.dtype != y.dtype:
                raise ValueError(f"{name} dtypes differ: {x.dtype} vs "
                                 f"{y.dtype} (concat never silently casts)")
            out[name] = torch.cat([x, y.to(x.device)]).contiguous()
        return PointFeatures(**out)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows over sqrt(sum x^2 + 1e-12), the JAX package's cosine rows; the
    sum of squares in float64 (see the module docstring)."""
    x64 = x.double()
    sq = (x64 * x64).sum(-1, keepdim=True).to(x.dtype)
    return x / torch.sqrt(sq + 1e-12)


def dot_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a_i, b_j> for all pairs: (..., A, d) x (..., B, d) -> (..., A, B)."""
    with ieee_fp32_matmul():
        return torch.matmul(a, b.transpose(-1, -2))


def cosine_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return dot_pairwise(normalize(a), normalize(b))


def angular_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mu(x, y) = 1 - theta / pi (the paper's Prop 3.3)."""
    c = cosine_pairwise(a, b).clamp(-1.0, 1.0)
    return 1.0 - torch.arccos(c) / math.pi


# Caps on the elements of one scoring block outside the kernels, on the
# CPU and on the card: jaccard_pairwise chunks the A axis of its (..., A,
# B, Na, Nb) match grid under them, and core.stars sizes its chunks of
# windows by them.  Chunking is bit-identical (each output element reduces
# the same values in the same order however the A axis is split).
# Module-level so tests can monkeypatch them small.
_MAX_BLOCK_ELEMS = 1 << 24
_MAX_BLOCK_ELEMS_CUDA = 1 << 26


def max_block_elems(device: torch.device) -> int:
    """The cap on one scoring block's elements on ``device``."""
    return (_MAX_BLOCK_ELEMS_CUDA if torch.device(device).type == "cuda"
            else _MAX_BLOCK_ELEMS)


def _fold_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order (halves added
    elementwise, an odd last position carried), so each output's order
    depends on the axis length alone; log2(len) additions."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        pairs = x[..., :half] + x[..., half:2 * half]
        x = torch.cat([pairs, x[..., 2 * half:]], dim=-1) \
            if x.shape[-1] % 2 else pairs
    return x[..., 0]


def _jaccard_block(idx_a, wa, mask_a, idx_b, wb, mask_b) -> torch.Tensor:
    """One unchunked Jaccard block (weights already masked to zero)."""
    eq = (idx_a[..., :, None, :, None] == idx_b[..., None, :, None, :])
    eq = eq & mask_a[..., :, None, :, None] & mask_b[..., None, :, None, :]
    pair_min = torch.minimum(wa[..., :, None, :, None],
                             wb[..., None, :, None, :])
    matched = torch.where(eq, pair_min, torch.zeros(
        (), dtype=pair_min.dtype, device=pair_min.device))
    inter = _fold_last(matched.flatten(-2))
    tot_a = _fold_last(wa)[..., :, None]
    tot_b = _fold_last(wb)[..., None, :]
    union = tot_a + tot_b - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12),
                       torch.zeros((), dtype=inter.dtype,
                                   device=inter.device))


def jaccard_pairwise(idx_a: torch.Tensor, w_a: torch.Tensor,
                     mask_a: torch.Tensor, idx_b: torch.Tensor,
                     w_b: torch.Tensor, mask_b: torch.Tensor) -> torch.Tensor:
    """Exact (weighted) Jaccard over padded sparse sets.

    For each pair (i, j): sum_u min(a_u, b_u) / sum_u max(a_u, b_u), by a
    broadcast index-equality match, O(nnz_a * nnz_b) a pair.  The
    broadcast is capped at :func:`max_block_elems` of its device by
    chunking the A axis; the result is bit-identical to the unchunked
    form.

    Shapes: idx_a (..., A, Na); idx_b (..., B, Nb) -> (..., A, B).
    """
    zero = torch.zeros((), dtype=w_a.dtype, device=w_a.device)
    wa = torch.where(mask_a, w_a, zero)
    wb = torch.where(mask_b, w_b, zero)
    a_rows = idx_a.shape[-2]
    batch = math.prod(torch.broadcast_shapes(idx_a.shape[:-2],
                                             idx_b.shape[:-2]))
    per_row = batch * idx_b.shape[-2] * idx_a.shape[-1] * idx_b.shape[-1]
    rows = max(1, max_block_elems(idx_a.device) // max(1, per_row))
    if rows >= a_rows:
        return _jaccard_block(idx_a, wa, mask_a, idx_b, wb, mask_b)
    return torch.cat([
        _jaccard_block(idx_a[..., lo:lo + rows, :], wa[..., lo:lo + rows, :],
                       mask_a[..., lo:lo + rows, :], idx_b, wb, mask_b)
        for lo in range(0, a_rows, rows)], dim=-2)


def set_jaccard(fa: PointFeatures, fb: PointFeatures) -> torch.Tensor:
    """:func:`jaccard_pairwise` of two feature batches' set blocks."""
    return jaccard_pairwise(fa.set_idx, fa.set_w, fa.set_mask,
                            fb.set_idx, fb.set_w, fb.set_mask)


def mixture_pairwise(fa: PointFeatures, fb: PointFeatures,
                     alpha: float = 0.5) -> torch.Tensor:
    """alpha * cosine(dense) + (1 - alpha) * jaccard(sets) (the paper's
    §5, Amazon2m)."""
    cos = cosine_pairwise(fa.dense, fb.dense)
    return alpha * cos + (1.0 - alpha) * set_jaccard(fa, fb)


SimilarityFn = Callable[[PointFeatures, PointFeatures], torch.Tensor]


def pairwise_similarity(measure: str, *, alpha: float = 0.5,
                        learned_apply: Optional[Callable] = None
                        ) -> SimilarityFn:
    """A batched pairwise similarity function by name: the legacy closure
    factory; ``similarity.measure.make_measure`` wraps the same functions
    as ``Measure`` objects."""
    if learned_apply is not None and measure != "learned":
        raise ValueError(
            f"learned_apply passed with measure={measure!r}; only "
            "measure='learned' consumes it (silently ignoring it would "
            "score with a different function than the caller supplied)")
    if measure == "dot":
        return lambda fa, fb: dot_pairwise(fa.dense, fb.dense)
    if measure == "cosine":
        return lambda fa, fb: cosine_pairwise(fa.dense, fb.dense)
    if measure == "angular":
        return lambda fa, fb: angular_pairwise(fa.dense, fb.dense)
    if measure == "jaccard":
        return set_jaccard
    if measure == "mixture":
        return lambda fa, fb: mixture_pairwise(fa, fb, alpha=alpha)
    if measure == "learned":
        if learned_apply is None:
            raise ValueError("measure='learned' requires learned_apply")
        return learned_apply
    raise ValueError(f"unknown similarity measure: {measure!r}")
