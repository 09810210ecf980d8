"""Clustering on the device over the live degree slabs: the single-device
programs of ``repro.distributed.cluster_dist``.

``GraphBuilder.cluster`` runs these on the session's (n, k) slabs, so
features -> graph -> labels never fetches the slab image: only the final
(n,) label vector crosses to the host, metered under
``transfer_stats['cluster_label_*']``, plus one scalar a round for the
stop conditions.  The JAX package runs its mesh programs on a one-device
mesh there; with one shard every all_to_all is local (and meters 0
bytes), so this module writes the one-device program with no exchange.

  * :func:`connected_components_slabs`: min-label propagation over the
    slabs' symmetric closure.  A round pulls each slab neighbour's label,
    takes the row minimum, pushes it to every neighbour by scatter-min,
    then pointer-jumps ``label = min(label, label[label])`` to a fixpoint;
    rounds repeat until stable.  Labels are component minima, the host
    union-find's roots.
  * :func:`affinity_slabs`: average-linkage Affinity (Boruvka).  A round
    takes every slab entry whose endpoints lie in different clusters,
    dedups the doubled entries (one in each endpoint's row) by node pair,
    takes each cluster pair's mean over the ORIGINAL slab weights, picks
    each cluster's best pair (max mean, smallest mate on a tie) and hooks
    ``parent[max] <- min`` by scatter-min, then pointer-jumps.  A pair's
    weights are summed sequentially in (node pair) order, as the JAX
    package's segment sum does on the CPU, so the means and the labels
    are its labels, bit for bit, on either device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph import accumulator as acc_lib

_BIG = 2**31 - 1


def _pointer_jump(vec: torch.Tensor, max_iters: int = 64
                  ) -> Tuple[torch.Tensor, int]:
    """``vec = min(vec, vec[vec])`` to a fixpoint (``vec[i] <= i``, so
    each step halves the chains); returns it and the steps taken."""
    for it in range(max_iters):
        nxt = torch.minimum(vec, vec[vec.long()])
        if torch.equal(nxt, vec):
            return nxt, it + 1
        vec = nxt
    return vec, max_iters


def _labels_to_host(labels: torch.Tensor, n: int) -> np.ndarray:
    """The one device-to-host transfer of a clustering: the (n,) int32
    label vector, metered."""
    out = labels[:n].cpu().numpy().astype(np.int64)
    acc_lib.transfer_stats["cluster_label_fetches"] += 1
    acc_lib.transfer_stats["cluster_label_bytes"] += n * 4
    return out


def connected_components_slabs(nbr: torch.Tensor, *, n: int,
                               max_rounds: int = 64
                               ) -> Tuple[np.ndarray, Dict]:
    """Connected components of the slab graph, on the slabs' device.

    Args:
      nbr: (n, k) int32 slab neighbours, -1 on empty slots; the component
        graph is the slabs' symmetric closure, as ``Graph.from_degree_slabs``
        + ``connected_components_np`` see it.
      n: the point count.
    Returns:
      ((n,) int64 labels, each the smallest id of its component; info
      with the rounds, the pointer-jump steps and ``converged``).  Raises
      RuntimeError if ``max_rounds`` rounds do not settle the labels.
    """
    rows, k = nbr.shape
    dev = nbr.device
    ok = nbr >= 0
    idx = nbr.long().clamp_min(0)
    push_to = idx[ok]
    push_from = torch.arange(rows, device=dev)[:, None].expand(rows, k)[ok]
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    labels = torch.arange(rows, dtype=torch.int32, device=dev)
    rounds, jumps, converged = 0, 0, False
    for _ in range(max_rounds):
        prev = labels
        row_min = torch.where(ok, labels[idx], big).amin(1)
        labels = torch.minimum(labels, row_min)
        labels = labels.scatter_reduce(0, push_to, labels[push_from],
                                       reduce="amin")
        labels, steps = _pointer_jump(labels)
        rounds += 1
        jumps += steps
        if torch.equal(labels, prev):
            converged = True
            break
    if not converged:
        raise RuntimeError(
            f"connected_components_slabs: labels still changing after "
            f"max_rounds={max_rounds}")
    return _labels_to_host(labels, n), {"rounds": rounds,
                                        "jump_pulls": jumps,
                                        "converged": converged}


def _affinity_hooks(c_u: torch.Tensor, c_v: torch.Tensor,
                    node_key: torch.Tensor, w: torch.Tensor, rows: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Boruvka selection over the inter-cluster entries (cluster ids
    ``c_u``, ``c_v``, packed node pair ``node_key``, weight ``w``): the
    hook edges ``(max(c, mate), min(c, mate))`` of every cluster c with a
    best pair."""
    dev = w.device
    lo_c = torch.minimum(c_u, c_v).long()
    hi_c = torch.maximum(c_u, c_v).long()
    pair_key = (lo_c << 32) | hi_c
    # entries by (cluster pair, node pair); stable sorts keep the slab
    # order on exact ties, so the order is the same on every device
    order = torch.sort(node_key, stable=True).indices
    order = order[torch.sort(pair_key[order], stable=True).indices]
    pk, nk, ww = pair_key[order], node_key[order], w[order]
    first_pair = torch.ones_like(pk, dtype=torch.bool)
    first_pair[1:] = pk[1:] != pk[:-1]
    first_node = first_pair.clone()
    first_node[1:] |= nk[1:] != nk[:-1]
    starts = torch.nonzero(first_pair).reshape(-1)
    lengths = torch.diff(starts, append=starts.new_tensor([pk.shape[0]]))
    # the mean of each pair's deduplicated ORIGINAL weights: a sequential
    # float32 sum in the sorted order (the JAX package's CPU segment sum;
    # a duplicate adds 0.0), over the exact count.  segment_reduce folds
    # (rows, 1) data sequentially, on the card as on the CPU
    # (chip_smoke.py holds the two bit for bit)
    vals = torch.where(first_node, ww, torch.zeros_like(ww))
    wsum = torch.segment_reduce(vals[:, None], "sum", lengths=lengths,
                                axis=0, unsafe=True)[:, 0]
    cnt = torch.cumsum(first_node.long(), 0)
    cnt = torch.diff(cnt[starts + lengths - 1],
                     prepend=cnt.new_zeros(1)).to(torch.float32)
    mean = wsum / cnt.clamp_min(1.0)
    p_lo, p_hi = pk[starts] >> 32, pk[starts] & 0xFFFFFFFF
    cand_c = torch.cat([p_lo, p_hi])
    cand_m = torch.cat([p_hi, p_lo])
    cand_w = torch.cat([mean, mean])
    neg = float("-inf")
    best = torch.full((rows,), neg, device=dev).scatter_reduce(
        0, cand_c, cand_w, reduce="amax")
    is_best = (cand_w == best[cand_c]) & (cand_w > neg)
    mate = torch.full((rows,), _BIG, dtype=torch.int64,
                      device=dev).scatter_reduce(
        0, cand_c[is_best], cand_m[is_best], reduce="amin")
    has = (best > neg) & (mate != _BIG)
    c = torch.arange(rows, device=dev)[has]
    return torch.maximum(c, mate[has]), torch.minimum(c, mate[has])


def affinity_slabs(nbr: torch.Tensor, w: torch.Tensor, *, n: int,
                   target_clusters: int = 1, max_rounds: int = 32,
                   min_similarity: Optional[float] = None
                   ) -> Tuple[np.ndarray, Dict]:
    """Average-linkage Affinity clustering of the slab graph, on the
    slabs' device (the module docstring has the round).

    Stops when the live clusters are at most ``target_clusters``, when no
    inter-cluster entry is left (entries below ``min_similarity`` do not
    count, when given), or after ``max_rounds``.  Returns ((n,) densified
    int64 labels, info with the rounds and the clusters).
    """
    rows, k = nbr.shape
    dev = nbr.device
    keep = nbr >= 0
    if min_similarity is not None:
        keep &= w >= torch.tensor(min_similarity, dtype=torch.float32,
                                  device=dev)
    e_u = torch.arange(rows, device=dev)[:, None].expand(rows, k)[keep]
    e_v = nbr.long()[keep]
    e_w = w[keep]
    node_key = (torch.minimum(e_u, e_v) << 32) | torch.maximum(e_u, e_v)
    labels = torch.arange(rows, dtype=torch.int32, device=dev)
    marks = torch.zeros(rows, dtype=torch.int32, device=dev)
    rounds = 0
    for _ in range(max_rounds):
        live = int(marks.zero_().index_fill_(0, labels[:n].long(), 1).sum())
        if live <= target_clusters:
            break
        c_u, c_v = labels[e_u], labels[e_v]
        inter = c_u != c_v
        if not bool(inter.any()):
            break
        hook_idx, hook_val = _affinity_hooks(
            c_u[inter], c_v[inter], node_key[inter], e_w[inter], rows)
        parent = torch.arange(rows, dtype=torch.int32, device=dev)
        parent.scatter_reduce_(0, hook_idx, hook_val.to(torch.int32),
                               reduce="amin")
        parent, _ = _pointer_jump(parent)
        labels = parent[labels.long()]
        rounds += 1
    host = _labels_to_host(labels, n)
    _, dense = np.unique(host, return_inverse=True)
    dense = dense.reshape(-1).astype(np.int64)
    return dense, {"rounds": rounds,
                   "clusters": int(dense.max()) + 1 if dense.size else 0}
