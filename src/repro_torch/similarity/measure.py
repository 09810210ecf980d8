"""Similarity as a layer: the two-phase Measure contract
(``repro.similarity.measure``).

  * ``precompute(features) -> per-point state``: once per point per build
    or extend.  None for the closed-form measures; the two-tower
    embeddings for the learned measure.
  * ``score_tile(fa, fb, state_a, state_b) -> sims``: once per candidate
    tile.  The learned measure then pays only the pair head.

``expensive`` marks a measure whose tiles run a model: its comparisons are
metered as ``expensive_comparisons`` and the pair-score cache
(``similarity/pair_cache.py``) can skip them.  ``state_width`` is the
state table's width (None: stateless); ``state_complete`` says a tile
needs the state only, no raw features.

The fingerprint differs from the JAX package's: that one hashes the
``repr`` of a JAX pytree definition, which has no torch counterpart, so
the port hashes the config and each parameter's name, dtype, shape and
bytes, in name order.  ``core.convert.checkpoint_from_reference`` stamps
it onto a JAX checkpoint.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.similarity.measures import (PointFeatures, angular_pairwise,
                                             cosine_pairwise, dot_pairwise,
                                             mixture_pairwise, set_jaccard)

# Rows a precompute call embeds at a time: every block has this shape (the
# last one padded), so a row's state is bitwise the same whatever the
# number of rows embedded with it (a first build, an extend's tail or a
# restore's full re-embed).
EMBED_BLOCK_ROWS = 4096


class Measure:
    """Base contract: see the module docstring for the two phases."""

    name: str = "?"
    expensive: bool = False
    state_width: Optional[int] = None
    state_complete: bool = False
    # elements a pair takes in the widest intermediate of score_tile
    # beyond the sets' match grid (core.stars sizes its chunks by it)
    pair_width: int = 1

    def fingerprint(self) -> Optional[str]:
        """Stable digest of the measure's parameters, or None if unkeyed;
        ``GraphBuilder.restore`` refuses a checkpoint under another one."""
        return None

    def to(self, device: torch.device) -> "Measure":
        """The measure with its parameters on ``device``."""
        return self

    def precompute(self, features: PointFeatures) -> Optional[torch.Tensor]:
        """Per-point state table (n, state_width), or None if stateless."""
        return None

    def score_tile(self, fa: Optional[PointFeatures],
                   fb: Optional[PointFeatures],
                   state_a: Optional[torch.Tensor] = None,
                   state_b: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, fa, fb, state_a=None, state_b=None) -> torch.Tensor:
        return self.score_tile(fa, fb, state_a, state_b)


class CheapMeasure(Measure):
    """Stateless closed-form measure: the score is a function of the rows."""

    def __init__(self, name: str,
                 fn: Callable[[PointFeatures, PointFeatures], torch.Tensor]):
        self.name = name
        self._fn = fn

    def score_tile(self, fa, fb, state_a=None, state_b=None):
        return self._fn(fa, fb)


class OpaqueLearnedMeasure(Measure):
    """A legacy ``learned_apply`` closure as a Measure: no precompute, no
    state, no fingerprint; every tile pays the whole model."""

    name = "learned"
    expensive = True
    pair_width = 256        # an unknown model: a layer of 256 a pair

    def __init__(self, fn: Callable[[PointFeatures, PointFeatures],
                                    torch.Tensor]):
        self._fn = fn

    def score_tile(self, fa, fb, state_a=None, state_b=None):
        return self._fn(fa, fb)


def params_fingerprint(cfg: Any, params: Dict[str, torch.Tensor]) -> str:
    """sha256 over ``repr(cfg)`` and each parameter's name, dtype, shape
    and bytes, in name order."""
    h = hashlib.sha256()
    h.update(repr(cfg).encode())
    for name in sorted(params):
        arr = params[name].detach().cpu().contiguous()
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(tuple(arr.shape)).encode())
        h.update(arr.view(torch.uint8).numpy().tobytes()
                 if arr.numel() else b"")
    return h.hexdigest()


class LearnedMeasure(Measure):
    """Two-tower learned similarity with a cached embed phase.

    ``precompute`` runs the tower once a point, in blocks of
    ``EMBED_BLOCK_ROWS`` rows; ``score_tile`` pays the pair head on the
    cached embeddings.  With ``pair_features`` ``"embed"`` or ``"none"``
    a tile needs no raw features (``state_complete``).  Without state it
    embeds inline: the same scores, no cache.
    """

    name = "learned"
    expensive = True

    def __init__(self, model: Any, params: Dict[str, torch.Tensor]):
        self.model = model
        self.params = params
        self.state_width = int(model.cfg.embed_dim)
        # the pair head's input (hadamard + pair features) or hidden layer
        self.pair_width = max(int(model.cfg.head_hidden),
                              int(model.cfg.embed_dim) + 2)
        self.state_complete = model.cfg.pair_features in ("embed", "none")

    def fingerprint(self) -> str:
        return params_fingerprint(self.model.cfg, self.params)

    def to(self, device: torch.device) -> "LearnedMeasure":
        if all(p.device == torch.device(device)
               for p in self.params.values()):
            return self
        return LearnedMeasure(self.model, {k: v.to(device) for k, v in
                                           self.params.items()})

    def precompute(self, features: PointFeatures) -> torch.Tensor:
        dense = features.dense
        n = dense.shape[0]
        blocks = []
        for lo in range(0, n, EMBED_BLOCK_ROWS):
            rows = dense[lo:lo + EMBED_BLOCK_ROWS]
            pad = EMBED_BLOCK_ROWS - rows.shape[0]
            if pad:
                rows = torch.cat([rows, rows.new_zeros((pad,)
                                                       + rows.shape[1:])])
            blocks.append(self.model.embed(self.params, rows))
        if not blocks:
            return dense.new_zeros((0, self.state_width))
        return torch.cat(blocks)[:n].contiguous()

    def score_tile(self, fa, fb, state_a=None, state_b=None):
        if state_a is None or state_b is None:
            return self.model.pairwise(self.params, fa, fb)
        pair_feats = self.model.pair_feats_from(fa, fb, state_a, state_b)
        return self.model.pair_score_from_embed(
            self.params, state_a, state_b, pair_feats)


def _learned_factory(*, learned: Any = None, **_: Any) -> Measure:
    if learned is None:
        raise ValueError(
            "measure='learned' requires a LearnedMeasure (or a legacy "
            "learned_apply callable)")
    if isinstance(learned, Measure):
        return learned
    return OpaqueLearnedMeasure(learned)


# StarsConfig.measure name -> Measure factory (keyword arguments: alpha for
# the mixture, learned for the learned measure; the rest ignored)
MEASURES: Dict[str, Callable[..., Measure]] = {
    "dot": lambda **kw: CheapMeasure(
        "dot", lambda fa, fb: dot_pairwise(fa.dense, fb.dense)),
    "cosine": lambda **kw: CheapMeasure(
        "cosine", lambda fa, fb: cosine_pairwise(fa.dense, fb.dense)),
    "angular": lambda **kw: CheapMeasure(
        "angular", lambda fa, fb: angular_pairwise(fa.dense, fb.dense)),
    "jaccard": lambda **kw: CheapMeasure("jaccard", set_jaccard),
    "mixture": lambda alpha=0.5, **kw: CheapMeasure(
        "mixture", functools.partial(mixture_pairwise, alpha=alpha)),
    "learned": _learned_factory,
}


def make_measure(measure: str, *, alpha: float = 0.5,
                 learned: Any = None) -> Measure:
    """A Measure by registry name.  ``learned`` (a ``LearnedMeasure``, any
    Measure, or a legacy ``(fa, fb) -> sims`` callable) with a name other
    than ``'learned'`` raises."""
    if learned is not None and measure != "learned":
        raise ValueError(
            f"a learned measure/apply was passed with measure={measure!r}; "
            "only measure='learned' consumes it")
    try:
        factory = MEASURES[measure]
    except KeyError:
        raise ValueError(f"unknown similarity measure: {measure!r}") from None
    return factory(alpha=alpha, learned=learned)
