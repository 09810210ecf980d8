"""Connected components on the host, a numpy copy of the host half of
``repro.graph.components``.

Theorem 2.5 / A.3 reduce approximate single-linkage clustering to the
connected components of (r/c, r)-two-hop spanners.  The device version
(label propagation with pointer jumping on the mesh) comes with the
multi-device slice.
"""

from __future__ import annotations

import numpy as np


def connected_components_np(n: int, src: np.ndarray,
                            dst: np.ndarray) -> np.ndarray:
    """Union-find with path halving: (n,) int64 labels, each point's
    component's smallest id."""
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in zip(np.asarray(src, np.int64), np.asarray(dst, np.int64)):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    for i in range(n):
        parent[i] = find(i)
    return parent


def num_components(labels) -> int:
    return int(np.unique(np.asarray(labels)).size)
