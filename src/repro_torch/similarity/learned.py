"""The learned pairwise similarity model (``repro.similarity.learned``; the
paper's Appendix C.2 / D.3, after Grale).

  * a shared embedding tower maps a point's dense features to an
    embedding (two hidden layers of ``tower_hidden``, ReLU);
  * the pair's embedding is the Hadamard product of the two;
  * it is concatenated with hand-crafted pair features (``pair_features``:
    cosine of the raw dense rows and Jaccard of the sets, or cosine of the
    embeddings, or none);
  * a head MLP (two hidden layers of ``head_hidden``, ReLU) gives one
    unthresholded score.

The model is symmetric by construction.  Parameters are a dict of float32
tensors under the JAX package's names (``tower_w0`` ... ``head_b2``);
``core.convert.learned_params_from_reference`` carries the JAX arrays
across.  Every matmul runs in IEEE fp32.  ``loss`` is the training
objective (``examples/train_embedder.py`` trains it with plain SGD):
sigmoid binary cross-entropy on aligned pairs, same-category pairs the
positives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.similarity.measures import (PointFeatures, cosine_pairwise,
                                             ieee_fp32_matmul, set_jaccard)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """Two-tower model shape; the fields and defaults of the JAX package's.

    ``pair_features``: ``"raw"`` (cosine of the raw dense rows, plus
    Jaccard of the sets when ``use_set_features``), ``"embed"`` (cosine
    of the two embeddings) or ``"none"``.
    """

    in_dim: int
    tower_hidden: int = 100
    embed_dim: int = 32
    head_hidden: int = 100
    use_set_features: bool = True
    pair_features: str = "raw"
    dtype: Any = torch.float32


def _mlp_init(gen: torch.Generator, dims, dtype, name, device) -> Params:
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((a, b), generator=gen, dtype=dtype, device=device)
        params[f"{name}_w{i}"] = w * (2.0 / a) ** 0.5
        params[f"{name}_b{i}"] = torch.zeros((b,), dtype=dtype, device=device)
    return params


def _mlp_apply(params: Params, name: str, x: torch.Tensor,
               n_layers: int) -> torch.Tensor:
    with ieee_fp32_matmul():
        for i in range(n_layers):
            x = torch.matmul(x, params[f"{name}_w{i}"]) \
                + params[f"{name}_b{i}"]
            if i < n_layers - 1:
                x = torch.relu(x)
    return x


class LearnedSimilarity:
    """Two-tower + Hadamard-product pairwise similarity model."""

    def __init__(self, cfg: TwoTowerConfig):
        if cfg.pair_features not in ("raw", "embed", "none"):
            raise ValueError(
                f"TwoTowerConfig.pair_features={cfg.pair_features!r}: "
                "expected 'raw', 'embed' or 'none'")
        self.cfg = cfg
        if cfg.pair_features == "raw":
            self._n_pair_feats = 1 + (1 if cfg.use_set_features else 0)
        elif cfg.pair_features == "embed":
            self._n_pair_feats = 1
        else:
            self._n_pair_feats = 0

    @property
    def head_in(self) -> int:
        return self.cfg.embed_dim + self._n_pair_feats

    def init(self, gen: torch.Generator,
             device: Optional[torch.device] = None) -> Params:
        """He-normal weights and zero biases drawn from ``gen`` (the JAX
        package's initialiser, not its draws: parity tests convert the
        JAX parameters instead)."""
        cfg = self.cfg
        device = gen.device if device is None else device
        params = _mlp_init(gen, [cfg.in_dim, cfg.tower_hidden,
                                 cfg.tower_hidden, cfg.embed_dim],
                           cfg.dtype, "tower", device)
        params.update(_mlp_init(gen, [self.head_in, cfg.head_hidden,
                                      cfg.head_hidden, 1],
                                cfg.dtype, "head", device))
        return params

    def embed(self, params: Params, dense: torch.Tensor) -> torch.Tensor:
        """Tower embedding of dense features; shape (..., embed_dim)."""
        return _mlp_apply(params, "tower", dense, n_layers=3)

    def pair_score_from_embed(self, params: Params, emb_a: torch.Tensor,
                              emb_b: torch.Tensor,
                              pair_feats: torch.Tensor) -> torch.Tensor:
        """Score pairs from embeddings: emb_a (..., A, E), emb_b (..., B,
        E), pair_feats (..., A, B, F) -> (..., A, B)."""
        had = emb_a[..., :, None, :] * emb_b[..., None, :, :]
        x = torch.cat([had, pair_feats.to(had.dtype)], dim=-1)
        return _mlp_apply(params, "head", x, n_layers=3)[..., 0]

    def pair_feats_from(self, fa: Optional[PointFeatures],
                        fb: Optional[PointFeatures], emb_a: torch.Tensor,
                        emb_b: torch.Tensor) -> torch.Tensor:
        """Hand-crafted (..., A, B, F) pair features per
        ``cfg.pair_features``; ``"embed"`` and ``"none"`` never touch the
        raw features (``fa`` / ``fb`` may be None)."""
        mode = self.cfg.pair_features
        if mode == "raw":
            feats = [cosine_pairwise(fa.dense, fb.dense)[..., None]]
            if self.cfg.use_set_features:
                feats.append(set_jaccard(fa, fb)[..., None])
            return torch.cat(feats, dim=-1)
        if mode == "embed":
            return cosine_pairwise(emb_a, emb_b)[..., None]
        batch = torch.broadcast_shapes(emb_a.shape[:-2], emb_b.shape[:-2])
        return torch.zeros(batch + (emb_a.shape[-2], emb_b.shape[-2], 0),
                           dtype=self.cfg.dtype, device=emb_a.device)

    def pairwise(self, params: Params, fa: PointFeatures,
                 fb: PointFeatures) -> torch.Tensor:
        """Full batched pairwise scores (the towers run inline)."""
        emb_a = self.embed(params, fa.dense)
        emb_b = self.embed(params, fb.dense)
        pair_feats = self.pair_feats_from(fa, fb, emb_a, emb_b)
        return self.pair_score_from_embed(params, emb_a, emb_b, pair_feats)

    def loss(self, params: Params, fa: PointFeatures, fb: PointFeatures,
             labels: torch.Tensor) -> torch.Tensor:
        """Sigmoid BCE on aligned pairs: fa[i] against fb[i], labels (n,)
        (1 for a positive pair).  Each pair is scored as a 1 x 1 block of
        ``pairwise``, through the same IEEE fp32 products."""
        logits = self.pairwise(params, fa.map(lambda t: t[:, None]),
                               fb.map(lambda t: t[:, None]))[:, 0, 0]
        labels = labels.to(logits.dtype)
        return -torch.mean(labels * F.logsigmoid(logits)
                           + (1.0 - labels) * F.logsigmoid(-logits))
