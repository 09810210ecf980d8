"""Edge-set container (host side), a numpy copy of ``repro.core.spanner``.

The device-side builders (core/stars.py) emit fixed-shape candidate tensors
with validity masks; this module compacts them into a deduplicated edge list
and provides the spanner-level queries used by the paper's evaluation:
one-hop / two-hop neighbour recall, degree capping ("keep the 250 closest
points for each node", §5), and CSR adjacency for the clustering algorithms.

Everything here is plain numpy: at benchmark scale (n <= ~10^5) this is the
equivalent of the paper's final "write edges" MapReduce stage, and at
tera-scale it would itself be a data-parallel pass (it is embarrassingly
parallel over edge shards).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    """Undirected weighted graph as a deduplicated edge list."""

    n: int
    src: np.ndarray          # (E,) int64, src < dst (canonical orientation)
    dst: np.ndarray          # (E,) int64
    w: np.ndarray            # (E,) float32
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    # ------------------------------------------------------------------ #
    # Construction
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_candidates(n: int, src, dst, w, valid,
                        stats: Optional[Dict[str, float]] = None) -> "Graph":
        """Compact masked candidate arrays into a deduplicated edge list.

        Duplicate (u, v) pairs keep their maximum weight (repetitions of the
        same true similarity may differ only through masking, but learned
        measures can be asymmetric in float error; max is deterministic).
        """
        src = np.asarray(src).ravel()
        dst = np.asarray(dst).ravel()
        w = np.asarray(w, np.float32).ravel()
        valid = np.asarray(valid, bool).ravel()
        keep = valid & (src >= 0) & (dst >= 0) & (src != dst)
        src, dst, w = src[keep].astype(np.int64), dst[keep].astype(np.int64), w[keep]
        lo, hi = np.minimum(src, dst), np.maximum(src, dst)
        key = lo * np.int64(n) + hi
        order = np.lexsort((-w, key))
        key, w = key[order], w[order]
        first = np.ones(key.shape[0], bool)
        first[1:] = key[1:] != key[:-1]
        key, w = key[first], w[first]
        return Graph(n=n, src=key // n, dst=key % n, w=w,
                     stats=dict(stats or {}))

    @staticmethod
    def from_degree_slabs(n: int, nbr, w,
                          stats: Optional[Dict[str, float]] = None) -> "Graph":
        """Compact per-node top-k degree slabs into a deduplicated Graph.

        This is the single host-side pass of an accumulator build
        (graph/accumulator.py): ``nbr``/``w`` are (n, k) per-node tables
        (-1 / -inf on empty slots); an edge appears in the result iff it sits
        in at least one endpoint's slab.  Duplicates (an edge present in both
        endpoints' slabs) keep their max weight via ``from_candidates``.
        """
        nbr = np.asarray(nbr)
        w = np.asarray(w, np.float32)
        k = nbr.shape[1]
        node = np.repeat(np.arange(n, dtype=np.int64), k)
        nbr_f = nbr.ravel().astype(np.int64)
        w_f = w.ravel()
        valid = (nbr_f >= 0) & np.isfinite(w_f)
        return Graph.from_candidates(n, node, nbr_f, w_f, valid, stats)

    def merged_with(self, other: "Graph") -> "Graph":
        """The union of two graphs on the same points (max weight on a
        shared edge; stats summed key by key)."""
        assert self.n == other.n
        g = Graph.from_candidates(
            self.n,
            np.concatenate([self.src, other.src]),
            np.concatenate([self.dst, other.dst]),
            np.concatenate([self.w, other.w]),
            np.ones(self.num_edges + other.num_edges, bool))
        g.stats = {k: self.stats.get(k, 0) + other.stats.get(k, 0)
                   for k in set(self.stats) | set(other.stats)}
        return g

    # ------------------------------------------------------------------ #
    # Transformations
    # ------------------------------------------------------------------ #
    def threshold(self, r: float) -> "Graph":
        """The edges of weight at least ``r``."""
        keep = self.w >= r
        return Graph(self.n, self.src[keep], self.dst[keep], self.w[keep],
                     dict(self.stats))

    def degree_cap(self, k: int) -> "Graph":
        """Keep an edge iff it is among the k heaviest of *either* endpoint
        (the paper's "keep the 250 closest points for each node")."""
        e = self.num_edges
        ends = np.concatenate([self.src, self.dst])
        wts = np.concatenate([self.w, self.w])
        eid = np.concatenate([np.arange(e), np.arange(e)])
        order = np.lexsort((-wts, ends))
        ends_s, eid_s = ends[order], eid[order]
        # rank within each endpoint's sorted incidence list
        start = np.zeros(ends_s.shape[0], bool)
        start[0:1] = True
        start[1:] = ends_s[1:] != ends_s[:-1]
        seg_start_pos = np.flatnonzero(start)
        seg_id = np.cumsum(start) - 1
        rank = np.arange(ends_s.shape[0]) - seg_start_pos[seg_id]
        keep_edge = np.zeros(e, bool)
        keep_edge[eid_s[rank < k]] = True
        return Graph(self.n, self.src[keep_edge], self.dst[keep_edge],
                     self.w[keep_edge], dict(self.stats))

    # ------------------------------------------------------------------ #
    # Queries
    # ------------------------------------------------------------------ #
    def to_csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Symmetric CSR: returns (indptr, indices, weights)."""
        ends = np.concatenate([self.src, self.dst])
        nbrs = np.concatenate([self.dst, self.src])
        wts = np.concatenate([self.w, self.w])
        order = np.argsort(ends, kind="stable")
        ends, nbrs, wts = ends[order], nbrs[order], wts[order]
        indptr = np.zeros(self.n + 1, np.int64)
        np.add.at(indptr, ends + 1, 1)
        indptr = np.cumsum(indptr)
        return indptr, nbrs, wts

    def two_hop_sets(self, queries: np.ndarray, *,
                     min_edge_w: float = -np.inf) -> list:
        """For each query p: the nodes within two hops over edges of
        weight >= min_edge_w, p itself excluded."""
        indptr, nbrs, wts = self.to_csr()
        out = []
        for p in queries:
            a = slice(indptr[p], indptr[p + 1])
            one = nbrs[a][wts[a] >= min_edge_w]
            if one.size == 0:
                out.append(np.empty(0, np.int64))
                continue
            parts = [one]
            for z in one:
                b = slice(indptr[z], indptr[z + 1])
                parts.append(nbrs[b][wts[b] >= min_edge_w])
            two = np.unique(np.concatenate(parts))
            out.append(two[two != p])
        return out
