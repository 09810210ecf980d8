"""Evaluation metrics from the paper's empirical study (§5), a numpy copy
of ``repro.graph.metrics``.

  * ``v_measure``             — VMeasure [36]: harmonic mean of homogeneity
                                and completeness (Fig. 4).
  * ``neighbor_recall``       — fraction of (approximate) k-nearest
                                neighbours found in 1 or 2 hops (Fig. 2,
                                SortingLSH variants).
  * ``two_hop_threshold_recall`` — fraction of true near neighbours
                                (sim >= r2) reachable in two hops over
                                edges of weight >= r1 (Def. 2.1).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.spanner import Graph


def v_measure(labels_true: np.ndarray, labels_pred: np.ndarray) -> dict:
    """VMeasure score [36] via the contingency table. Returns h, c, v."""
    labels_true = np.asarray(labels_true)
    labels_pred = np.asarray(labels_pred)
    n = labels_true.size
    _, t = np.unique(labels_true, return_inverse=True)
    _, p = np.unique(labels_pred, return_inverse=True)
    nt, npred = t.max() + 1, p.max() + 1
    cont = np.zeros((nt, npred))
    np.add.at(cont, (t, p), 1.0)
    pij = cont / n
    pi = pij.sum(1)
    pj = pij.sum(0)

    def _ent(px):
        nz = px[px > 0]
        return -np.sum(nz * np.log(nz))

    h_c = _ent(pi)          # H(C)
    h_k = _ent(pj)          # H(K)
    nz = pij > 0
    h_c_given_k = -np.sum(pij[nz] * (np.log(pij[nz])
                                     - np.log(np.broadcast_to(pj, pij.shape)[nz])))
    h_k_given_c = -np.sum(pij[nz] * (np.log(pij[nz])
                                     - np.log(np.broadcast_to(pi[:, None], pij.shape)[nz])))
    h = 1.0 if h_c == 0 else 1.0 - h_c_given_k / h_c
    c = 1.0 if h_k == 0 else 1.0 - h_k_given_c / h_k
    v = 0.0 if (h + c) == 0 else 2 * h * c / (h + c)
    return {"homogeneity": float(h), "completeness": float(c), "v": float(v)}


def neighbor_recall(graph: Graph, queries: np.ndarray,
                    true_neighbors: Sequence[np.ndarray], *,
                    hops: int = 2, k_cap: Optional[int] = None) -> float:
    """Mean over queries of |found within `hops`| / |true| (paper Fig. 2).

    ``true_neighbors[i]`` are the ground-truth (approximate) nearest
    neighbours of ``queries[i]``.  If ``k_cap`` is given and at least k_cap
    neighbours are found, the ratio is clamped to 1 (paper: "if we can find
    more than 100 approximate 100-nearest neighbors, we regard the ratio
    as 1").
    """
    indptr, nbrs, _ = graph.to_csr()
    ratios = []
    for q, truth in zip(np.asarray(queries), true_neighbors):
        truth = np.asarray(truth)
        if truth.size == 0:
            continue
        one = nbrs[indptr[q]:indptr[q + 1]]
        if hops == 1:
            found = one
        else:
            parts = [one]
            for z in one:
                parts.append(nbrs[indptr[z]:indptr[z + 1]])
            found = np.unique(np.concatenate(parts)) if parts else one
        inter = np.intersect1d(found, truth, assume_unique=False).size
        if k_cap is not None and inter >= k_cap:
            ratios.append(1.0)
        else:
            ratios.append(inter / truth.size)
    return float(np.mean(ratios)) if ratios else 0.0


def two_hop_threshold_recall(graph: Graph, queries: np.ndarray,
                             true_neighbors: Sequence[np.ndarray], *,
                             min_edge_w: float) -> float:
    """Fraction of ground-truth near neighbours (sim >= r2) reachable within
    two hops where every edge on the path has weight >= min_edge_w."""
    g = graph.threshold(min_edge_w)
    two_hop = g.two_hop_sets(np.asarray(queries))
    ratios = []
    for found, truth in zip(two_hop, true_neighbors):
        truth = np.asarray(truth)
        if truth.size == 0:
            continue
        inter = np.intersect1d(found, truth).size
        ratios.append(inter / truth.size)
    return float(np.mean(ratios)) if ratios else 0.0
