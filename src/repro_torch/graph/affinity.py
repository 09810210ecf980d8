"""Average Affinity clustering [5] — the paper's downstream evaluator (§5),
a numpy copy of ``repro.graph.affinity``.

Affinity clustering is Boruvka's MST algorithm run on the *similarity* graph:
every round, each current cluster picks its highest-average-similarity
incident inter-cluster edge and merges along it; rounds repeat until the
target number of clusters (or edge exhaustion).  "Average" linkage means the
weight between two clusters is the mean of the original edge weights
crossing them, recomputed after each contraction.

Host-side numpy implementation (the clustering itself is not the paper's
contribution; the paper runs it as a downstream job).  Each round is a
vectorised group-by over the contracted edge list — the same dataflow the
distributed version would shard.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.spanner import Graph


def _contract_edges(cu: np.ndarray, cv: np.ndarray, w: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group parallel edges between clusters; weight = mean (average linkage)."""
    lo = np.minimum(cu, cv)
    hi = np.maximum(cu, cv)
    keep = lo != hi
    lo, hi, w = lo[keep], hi[keep], w[keep]
    if lo.size == 0:
        return lo, hi, w
    # Group by the (lo, hi) pair directly.  The composite key this replaces
    # (lo * (hi.max()+1) + hi in int64) silently wraps once lo * hi
    # approaches 2^63 — distinct cluster pairs alias and their weights get
    # averaged together (tera-scale ids make that reachable: hi ~ 2^33,
    # lo ~ 2^31 is already a wrap).  lexsort needs no product, so there is
    # nothing to overflow.
    order = np.lexsort((hi, lo))
    lo, hi, w = lo[order], hi[order], w[order]
    first = np.ones(lo.size, bool)
    first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    seg = np.cumsum(first) - 1
    nseg = seg[-1] + 1
    wsum = np.zeros(nseg); np.add.at(wsum, seg, w)
    cnt = np.zeros(nseg); np.add.at(cnt, seg, 1.0)
    return lo[first], hi[first], (wsum / cnt).astype(np.float32)


def affinity_clustering(graph: Graph, *, target_clusters: int = 1,
                        max_rounds: int = 32,
                        min_similarity: Optional[float] = None
                        ) -> np.ndarray:
    """Run average-Affinity; returns (n,) cluster labels.

    Stops when #clusters <= target_clusters, when no inter-cluster edges
    remain, or when every best edge falls below ``min_similarity``.
    """
    n = graph.n
    labels = np.arange(n, dtype=np.int64)
    cu = graph.src.astype(np.int64).copy()
    cv = graph.dst.astype(np.int64).copy()
    w = graph.w.astype(np.float32).copy()

    for _ in range(max_rounds):
        cu, cv, w = _contract_edges(cu, cv, w)
        if cu.size == 0:
            break
        live = np.unique(labels)
        if live.size <= target_clusters:
            break
        if min_similarity is not None:
            keep = w >= min_similarity
            cu, cv, w = cu[keep], cv[keep], w[keep]
            if cu.size == 0:
                break
        # Boruvka step: best incident edge per cluster.
        ends = np.concatenate([cu, cv])
        mates = np.concatenate([cv, cu])
        ww = np.concatenate([w, w])
        order = np.lexsort((-ww, ends))
        ends_s, mates_s = ends[order], mates[order]
        first = np.ones(ends_s.size, bool)
        first[1:] = ends_s[1:] != ends_s[:-1]
        best_src = ends_s[first]
        best_dst = mates_s[first]
        # Contract chosen edges by hooking the larger id onto the smaller
        # (parent strictly decreases -> no cycles), then pointer-jump.
        parent = np.arange(labels.max() + 1, dtype=np.int64)
        hi_e = np.maximum(best_src, best_dst)
        lo_e = np.minimum(best_src, best_dst)
        np.minimum.at(parent, hi_e, lo_e)
        for _ in range(64):
            new = parent[parent]
            if np.array_equal(new, parent):
                break
            parent = new
        labels = parent[labels]
        cu, cv = parent[cu], parent[cv]

    # Densify labels to 0..k-1
    _, labels = np.unique(labels, return_inverse=True)
    return labels
