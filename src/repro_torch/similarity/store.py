"""The -1-sentinel gather (``repro.similarity.store.masked_take``).

Candidate index grids use -1 for empty and padding slots.  Those slots
clamp to row 0 so the gather stays in bounds; every consumer masks them
out downstream (window validity, ``leader_ok``), so what they read does
not matter.  The paged and mesh feature stores come in later slices.
"""

from __future__ import annotations

import torch

from repro_torch.similarity.measures import PointFeatures


def masked_take(features: PointFeatures, idx: torch.Tensor) -> PointFeatures:
    """Gather rows for a -1-sentinel index grid (sentinels read row 0)."""
    return features.take(idx.clamp_min(0))
