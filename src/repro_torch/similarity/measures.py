"""Point features (the dense block of ``repro.similarity.measures``).

This slice of the port carries dense float features only; the padded
sparse "set" block (Jaccard / mixture measures) comes with the non-dense
measures in a later slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PointFeatures:
    """Features for a batch of points.

    Attributes:
      dense: (n, d) float tensor; its device is where the build runs.
    """

    dense: torch.Tensor

    @property
    def n(self) -> int:
        return self.dense.shape[0]

    @property
    def device(self) -> torch.device:
        return self.dense.device

    def take(self, indices: torch.Tensor) -> "PointFeatures":
        """Gather rows; the result has shape ``indices.shape + (d,)``."""
        return PointFeatures(dense=self.dense[indices])
