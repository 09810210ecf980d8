"""Edge-set container (host side), a numpy copy of ``repro.core.spanner``.

The device-side builders (core/stars.py) emit fixed-shape candidate tensors
with validity masks; this module compacts them into a deduplicated edge list
and provides the spanner-level queries used by the paper's evaluation:
one-hop / two-hop neighbour recall, degree capping ("keep the 250 closest
points for each node", §5), and CSR adjacency for the clustering algorithms.

The compaction runs in torch where its inputs lie (on the card for an
accumulator's slabs); the queries are plain numpy: at benchmark scale (n <= ~10^5) this is the
equivalent of the paper's final "write edges" MapReduce stage, and at
tera-scale it would itself be a data-parallel pass (it is embarrassingly
parallel over edge shards).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _flat(a, device) -> torch.Tensor:
    """``a`` as a flat tensor, on ``device`` where one is given (a numpy
    array becomes a CPU tensor over its memory where it can)."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        a = torch.from_numpy(a if a.flags.writeable else a.copy())
    a = a.reshape(-1)
    return a if device is None else a.to(device)


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
        The inputs are numpy arrays or tensors; the compaction runs where
        they lie (tensors on the card: their sorts run there and only the
        kept edges, 12 bytes each, are fetched).  The pairs are sorted by
        the packed (min, max) key and, among a key's copies, by weight
        descending (two stable sorts, ``np.lexsort((-w, key))``'s order),
        and the first copy of each key is kept.  (On the card a key whose
        copies weigh 0.0 and -0.0 may keep the other sign: its radix sort
        orders the two.)
        """
        src = _flat(src, None)
        dev = src.device
        dst, valid = _flat(dst, dev), _flat(valid, dev).to(torch.bool)
        w = _flat(w, dev).to(torch.float32)
        keep = valid & (src >= 0) & (dst >= 0) & (src != dst)
        src, dst, w = src[keep], dst[keep], w[keep]
        del keep, valid
        key = (torch.minimum(src, dst).to(torch.int64) * n
               + torch.maximum(src, dst))
        del src, dst
        order = torch.sort(-w, stable=True).indices
        key = key[order]
        key, by_key = torch.sort(key, stable=True)
        order = order[by_key]
        del by_key
        w = w[order]
        del order
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        key = key[first].cpu().numpy()
        w = w[first].cpu().numpy()
        return Graph(n=n, src=key // n, dst=key % n, w=w,
                     stats=dict(stats or {}))

    @staticmethod
    def from_degree_slabs(n: int, nbr, w,
                          stats: Optional[Dict[str, float]] = None) -> "Graph":
        """Compact per-node top-k degree slabs into a deduplicated Graph.

        This is the single edge pass of an accumulator build
        (graph/accumulator.py): ``nbr``/``w`` are (n, k) per-node tables
        (-1 / -inf on empty slots), numpy arrays or tensors, compacted
        where they lie; an edge appears in the result iff it sits in at
        least one endpoint's slab.  Duplicates (an edge present in both
        endpoints' slabs) keep their max weight via ``from_candidates``.
        """
        k = nbr.shape[1]
        nbr = _flat(nbr, None)
        w = _flat(w, nbr.device)
        node = torch.arange(n, dtype=torch.int32, device=nbr.device) \
            .repeat_interleave(k)
        valid = (nbr >= 0) & torch.isfinite(w)
        return Graph.from_candidates(n, node, nbr, w, valid, stats)

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
