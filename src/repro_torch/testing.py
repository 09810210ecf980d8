"""Edge-for-edge comparison of two builds, for the tests and ``chip_smoke.py``.

Two builds of one config agree on every discrete choice (windows, leaders,
masks, comparison counts), but their similarity floats may differ by an
ulp or two (another summation order on another device or library).  Such
a difference can swap two candidates whose weights tie to within an ulp
at a node's slab boundary, and only there.  :func:`compare_builds`
counts edges present in one build only, and explains each by such a
near-tie or reports it as unexplained.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.spanner import Graph


def slab_boundary(nbr: np.ndarray, w: np.ndarray) -> np.ndarray:
    """(n,) weight of the last slot of each full slab row; -inf otherwise."""
    nbr = np.asarray(nbr)
    w = np.asarray(w, np.float32)
    return np.where(nbr[:, -1] >= 0, w[:, -1], -np.inf)


def compare_builds(g_a: Graph, g_b: Graph, bound_a: np.ndarray,
                   bound_b: np.ndarray, *, tol: float = 1e-6) -> dict:
    """Compare two graphs of one config; ``bound_*`` from :func:`slab_boundary`.

    An edge of one build missing from the other is a boundary near-tie if
    its weight lies within ``tol`` of the other build's slab boundary at
    one of its endpoints.  Returns counts and the largest weight
    difference over the common edges.
    """
    n = g_a.n
    key_a = g_a.src.astype(np.int64) * n + g_a.dst
    key_b = g_b.src.astype(np.int64) * n + g_b.dst
    _, ia, ib = np.intersect1d(key_a, key_b, assume_unique=True,
                               return_indices=True)

    def one_sided(g, key, common_idx, other_bound):
        alone = np.ones(key.shape[0], bool)
        alone[common_idx] = False
        w = g.w[alone].astype(np.float64)
        near = np.minimum(np.abs(w - other_bound[g.src[alone]]),
                          np.abs(w - other_bound[g.dst[alone]])) <= tol
        return int(alone.sum()), int(near.sum())

    only_a, ties_a = one_sided(g_a, key_a, ia, bound_b)
    only_b, ties_b = one_sided(g_b, key_b, ib, bound_a)
    dw = np.abs(g_a.w[ia].astype(np.float64) - g_b.w[ib])
    return {"edges_a": int(key_a.shape[0]), "edges_b": int(key_b.shape[0]),
            "only_a": only_a, "only_b": only_b,
            "boundary_ties": ties_a + ties_b,
            "unexplained": only_a + only_b - ties_a - ties_b,
            "max_weight_diff": float(dw.max()) if dw.size else 0.0}
