"""Approximate k-single-linkage clustering via two-hop spanners, a numpy
copy of ``repro.graph.single_linkage``.

Theorem 2.5 / A.3: for r < OPT_k / c, any (r/c, r)-two-hop spanner has at
least k connected components, and distinct components are separated by
similarity >= r.  Taking connected components of spanners at
geometrically spaced thresholds gives a 2-approximation to
k-single-linkage.  :func:`single_linkage_from_spanners` re-thresholds ONE
graph built at the smallest threshold and returns the clustering whose
component count first reaches k.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.spanner import Graph
from repro_torch.graph.components import connected_components_np


def single_linkage_from_spanners(graph: Graph, k: int, *,
                                 r_min: float, r_max: float,
                                 levels: int = 16
                                 ) -> Tuple[np.ndarray, float]:
    """Geometric threshold sweep; returns (labels, chosen_r).

    Labels are those of the first level, from the highest threshold down,
    whose component count drops to <= k, densified to 0..c-1.
    """
    if r_min <= 0:
        # shift to a positive range for the geometric sweep
        shift = 1e-6 - r_min
        r_lo, r_hi = 1e-6, r_max + shift
    else:
        shift, r_lo, r_hi = 0.0, r_min, r_max
    rs = np.geomspace(r_lo, r_hi, levels) - shift

    best = None
    for r in rs[::-1]:
        g = graph.threshold(float(r))
        labels = connected_components_np(g.n, g.src, g.dst)
        ncomp = np.unique(labels).size
        best = (labels, float(r), ncomp)
        if ncomp <= k:
            break
    labels, r, _ = best
    _, labels = np.unique(labels, return_inverse=True)
    return labels, r
