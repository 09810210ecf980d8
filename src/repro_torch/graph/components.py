"""Connected components (``repro.graph.components``): the host union-find
and its device counterpart.

Theorem 2.5 / A.3 reduce approximate single-linkage clustering to the
connected components of (r/c, r)-two-hop spanners.
:func:`connected_components_device` is the port of the JAX package's
``connected_components_jax``: min-label propagation with pointer jumping,
in PyTorch on the edges' device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, as_tensor, resolve_device

_INT32_MAX = 2**31 - 1


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


def label_dtype(n: int) -> torch.dtype:
    """Device labels are node ids: int32 while ids fit, int64 past that
    (the JAX package raises there without x64; torch has int64)."""
    return torch.int32 if n - 1 <= _INT32_MAX else torch.int64


def connected_components_device(n: int, src, dst, max_iters: int = 64, *,
                                return_converged: bool = False,
                                device: DeviceLike = None):
    """Min-label propagation and pointer jumping on the device.

    Each round: ``label[u] <- min`` over u's edges of both endpoints'
    labels (a scatter-min at both ends), then eight pointer jumps
    ``label = label[label]``; rounds repeat until a round changes nothing,
    as in the JAX package.  ``src`` / ``dst`` are arrays or tensors; the
    labels live on their device (or ``device`` for arrays: CUDA unless
    ``"cpu"``) and are the components' smallest ids.

    Hitting ``max_iters`` rounds before the labels settle raises
    RuntimeError (unconverged labels are not a partition); with
    ``return_converged=True`` it returns ``(labels, converged)`` instead.
    """
    dev = (src.device if isinstance(src, torch.Tensor)
           else resolve_device(device))
    dtype = label_dtype(n)
    src = as_tensor(src, device=dev, dtype=torch.int64)
    dst = as_tensor(dst, device=dev, dtype=torch.int64)
    labels = torch.arange(n, dtype=dtype, device=dev)
    changed, iters = True, 0
    while changed and iters < max_iters:
        m = torch.minimum(labels[src], labels[dst])
        new = labels.scatter_reduce(0, src, m, reduce="amin")
        new.scatter_reduce_(0, dst, m, reduce="amin")
        for _ in range(8):
            new = new[new.long()]
        changed = bool((new != labels).any())
        labels, iters = new, iters + 1
    converged = not changed
    if return_converged:
        return labels, converged
    if not converged:
        raise RuntimeError(
            f"connected_components_device: labels still changing after "
            f"max_iters={max_iters} rounds ({iters} run): raise max_iters, "
            "or pass return_converged=True to handle partial labels")
    return labels


def num_components(labels) -> int:
    return int(np.unique(np.asarray(labels)).size)
