"""Clustering on the mesh's row-sharded slabs (``repro.distributed.cluster_dist``).

Labels are an (n_pad,) int32 vector sharded like the slab rows (row
``i`` on rank ``i // (n_pad / p)``); nothing O(n k) leaves the ranks.
Every exchange is the owner-keyed pattern of :mod:`stars_dist`, exact
size and metered as an all-to-all; only the final (n,) label vector
crosses to the host (``transfer_stats['cluster_label_*']``), plus one
scalar a round for the stop conditions, so ``edge_fetches`` and
``bytes`` stay untouched.

  * :func:`connected_components_mesh`: min-label propagation.  A round
    pulls the labels of each row's slab neighbours from their owners
    (:func:`_pull`), takes the row minimum, pushes it to every
    neighbour's owner by scatter-min (:func:`_scatter_exchange`), then
    pointer-jumps ``label = min(label, label[label])`` to a fixpoint;
    labels end as component minima, the host union-find's roots.
  * :func:`affinity_mesh`: average-linkage Affinity (Boruvka).  A round
    ships each inter-cluster slab entry, (lo cluster, hi cluster, lo
    node, hi node, w), to the owner of its lo cluster, which dedups the
    doubled entries by node pair, sums each cluster pair's original
    weights sequentially in (cluster pair, node pair, slab position)
    order, ships each pair's mean to the hi cluster's owner too, and
    picks each local cluster's best pair (max mean, smaller mate on a
    tie); the hooks ``parent[max] <- min`` go out by scatter-min, then
    pointer jumping and a relabel pull.

The summation order is the single-device program's
(``graph.cluster.affinity_slabs``) at any p, so the labels are its
labels, bit for bit, and the JAX package's ``affinity_mesh``'s.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import comm
from repro_torch.distributed.comm import Mesh
from repro_torch.distributed.stars_dist import fetch_rows_all_to_all
from repro_torch.graph import accumulator as acc_lib

_BIG = 2**31 - 1


def _iota_labels(rows: int, mesh: Mesh) -> torch.Tensor:
    """Identity labels of this rank's rows (pad rows stay singletons:
    they have no slab entries)."""
    return torch.arange(mesh.rank * rows, (mesh.rank + 1) * rows,
                        dtype=torch.int32, device=mesh.device)


def _pull(labels: torch.Tensor, gids: torch.Tensor, mesh: Mesh):
    """``labels[gids]`` over the mesh (the 1-column fetch); -1 ids read
    0 with ``ok`` False."""
    got, ok, _ = fetch_rows_all_to_all(labels[:, None], gids.reshape(-1),
                                       mesh=mesh)
    return got.reshape(gids.shape), ok.reshape(gids.shape)


def _scatter_exchange(vec: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor, mesh: Mesh, op: str) -> torch.Tensor:
    """Send (idx, val) pairs to the owner of ``idx`` and fold them into
    its rows of ``vec`` by min or max; ``idx`` -1 is a dead slot."""
    rows = vec.shape[0]
    keep = idx >= 0
    idx, val = idx[keep].to(torch.int64), val[keep]
    owner = idx // rows
    loc = (idx - owner * rows).to(torch.int32)
    _, _, _, (got,) = comm.exchange(
        mesh, owner, torch.stack([loc, val.to(torch.int32)], dim=1))
    return vec.scatter_reduce(0, got[:, 0].long(), got[:, 1],
                              reduce="amin" if op == "min" else "amax")


def _pointer_jump(vec: torch.Tensor, mesh: Mesh, max_iters: int = 64
                  ) -> Tuple[torch.Tensor, int]:
    """``vec = min(vec, vec[vec])`` over the mesh to a fixpoint (vec[i] <=
    i: each step halves the chains); returns it and the steps taken."""
    for it in range(max_iters):
        got, _ = _pull(vec, vec, mesh)
        nxt = torch.minimum(vec, got)
        if not comm.any_rank(mesh, (nxt != vec).any()):
            return nxt, it + 1
        vec = nxt
    return vec, max_iters


def _labels_to_host(labels: torch.Tensor, n: int, mesh: Mesh) -> np.ndarray:
    """The one device-to-host transfer of a clustering, metered: the label
    vector gathered to every rank."""
    out = comm.all_gather_rows(mesh, labels)[:n].cpu().numpy()
    acc_lib.transfer_stats["cluster_label_fetches"] += 1
    acc_lib.transfer_stats["cluster_label_bytes"] += n * 4
    return out.astype(np.int64)


def connected_components_mesh(nbr: torch.Tensor, *, n: int, mesh: Mesh,
                              max_rounds: int = 64
                              ) -> Tuple[np.ndarray, Dict]:
    """Connected components of the slab graph, labels never gathered
    before the end.

    Args:
      nbr: this rank's (n_pad / p, k) int32 slab rows, -1 on empty slots.
      n: the real point count (pad rows are trimmed).
    Returns:
      ((n,) int64 labels, each its component's smallest id, the same on
      every rank; info with the rounds, the pointer-jump steps and
      ``converged``).  Raises RuntimeError if ``max_rounds`` rounds do not
      settle the labels.
    """
    rows, k = nbr.shape
    labels = _iota_labels(rows, mesh)
    ok = nbr >= 0
    rounds, jumps, converged = 0, 0, False
    for _ in range(max_rounds):
        prev = labels
        got, _ = _pull(labels, nbr, mesh)
        row_min = torch.where(ok, got, torch.full_like(got, _BIG)).amin(1)
        labels = torch.minimum(labels, row_min)
        push = labels[:, None].expand(rows, k)
        labels = _scatter_exchange(labels, torch.where(ok, nbr, -1)
                                   .reshape(-1), push.reshape(-1), mesh,
                                   "min")
        labels, steps = _pointer_jump(labels, mesh)
        rounds += 1
        jumps += steps
        if not comm.any_rank(mesh, (labels != prev).any()):
            converged = True
            break
    if not converged:
        raise RuntimeError(
            f"connected_components_mesh: labels still changing after "
            f"max_rounds={max_rounds}")
    return _labels_to_host(labels, n, mesh), {"rounds": rounds,
                                              "jump_pulls": jumps,
                                              "converged": converged}


def _live_clusters(labels: torch.Tensor, n: int, mesh: Mesh) -> int:
    """Distinct labels among the real rows: a scatter-mark at the labels'
    owners and one summed count."""
    rows = labels.shape[0]
    gid = _iota_labels(rows, mesh)
    marks = _scatter_exchange(torch.zeros_like(labels),
                              torch.where(gid < n, labels, -1),
                              torch.ones_like(labels), mesh, "max")
    return int(comm.all_reduce_sum(mesh, marks.sum(dtype=torch.int64)))


def _to_owner(mesh: Mesh, key: torch.Tensor, rows: int, cols):
    """Ship the rows of ``cols`` (int32 columns) to the owner of ``key``;
    returns the received columns, grouped by source rank, each source's
    rows in their order there."""
    _, _, _, (got,) = comm.exchange(mesh, key.long() // rows,
                                    torch.stack(cols, dim=1))
    return got.unbind(1)


def _affinity_select(labels, nbr, w, nl, ok, mesh: Mesh,
                     min_similarity: Optional[float]):
    """One Boruvka selection on the mesh: records to the lo cluster's
    owner, means there, each pair's candidate to the hi cluster's owner,
    each local cluster's best pair.  Returns the hook stream (hi, lo) of
    this rank's clusters and this rank's inter-cluster entry count."""
    rows, k = nbr.shape
    dev = nbr.device
    row0 = mesh.rank * rows
    u = torch.arange(row0, row0 + rows, dtype=torch.int32,
                     device=dev)[:, None].expand(rows, k)
    cu = labels[:, None].expand(rows, k)
    valid = ok & (nbr >= 0) & (cu != nl)
    if min_similarity is not None:
        valid &= w >= torch.tensor(min_similarity, dtype=torch.float32,
                                   device=dev)
    n_rec = valid.sum(dtype=torch.int64)
    lo_c = torch.minimum(cu, nl)[valid]
    # exchange 1: records to the lo cluster's owner; they arrive in global
    # slab order (ranks hold row blocks in rank order), the single-device
    # program's order on ties
    rlo, rhi, rln, rhn, rwb = _to_owner(
        mesh, lo_c, rows,
        [lo_c, torch.maximum(cu, nl)[valid], torch.minimum(u, nbr)[valid],
         torch.maximum(u, nbr)[valid], w[valid].view(torch.int32)])
    pair_key = (rlo.long() << 32) | rhi.long()
    node_key = (rln.long() << 32) | rhn.long()
    # by (cluster pair, node pair), stable: ties keep the slab order
    order = torch.sort(node_key, stable=True).indices
    order = order[torch.sort(pair_key[order], stable=True).indices]
    pk, nk = pair_key[order], node_key[order]
    ww = rwb[order].view(torch.float32)
    m = pk.shape[0]
    if m:
        first_pair = torch.ones_like(pk, dtype=torch.bool)
        first_pair[1:] = pk[1:] != pk[:-1]
        first_node = first_pair.clone()
        first_node[1:] |= nk[1:] != nk[:-1]
        starts = torch.nonzero(first_pair).reshape(-1)
        lengths = torch.diff(starts, append=starts.new_tensor([m]))
        # a sequential float32 sum a pair (a duplicate adds 0.0), as the
        # single-device program sums
        vals = torch.where(first_node, ww, torch.zeros_like(ww))
        wsum = torch.segment_reduce(vals[:, None], "sum", lengths=lengths,
                                    axis=0, unsafe=True)[:, 0]
        cnt = torch.cumsum(first_node.long(), 0)
        cnt = torch.diff(cnt[starts + lengths - 1],
                         prepend=cnt.new_zeros(1)).to(torch.float32)
        mean = wsum / cnt.clamp_min(1.0)
        p_lo = (pk[starts] >> 32).to(torch.int32)
        p_hi = (pk[starts] & 0xFFFFFFFF).to(torch.int32)
    else:
        mean = torch.zeros((0,), dtype=torch.float32, device=dev)
        p_lo = p_hi = torch.zeros((0,), dtype=torch.int32, device=dev)
    # exchange 2: each pair's candidate to the hi cluster's owner
    q_hi, q_lo, q_wb = _to_owner(mesh, p_hi, rows,
                                 [p_hi, p_lo, mean.view(torch.int32)])
    cand_c = torch.cat([p_lo, q_hi]).long() - row0
    cand_m = torch.cat([p_hi, q_lo]).long()
    cand_w = torch.cat([mean, q_wb.view(torch.float32)])
    neg = float("-inf")
    best = torch.full((rows,), neg, device=dev).scatter_reduce(
        0, cand_c, cand_w, reduce="amax")
    is_best = (cand_w == best[cand_c]) & (cand_w > neg)
    mate = torch.full((rows,), _BIG, dtype=torch.int64,
                      device=dev).scatter_reduce(
        0, cand_c[is_best], cand_m[is_best], reduce="amin")
    has = (best > neg) & (mate != _BIG)
    c = torch.arange(row0, row0 + rows, device=dev)[has]
    return torch.maximum(c, mate[has]), torch.minimum(c, mate[has]), n_rec


def affinity_mesh(nbr: torch.Tensor, w: torch.Tensor, *, n: int, mesh: Mesh,
                  target_clusters: int = 1, max_rounds: int = 32,
                  min_similarity: Optional[float] = None
                  ) -> Tuple[np.ndarray, Dict]:
    """Average-linkage Affinity clustering of the row-sharded slabs (the
    module docstring has the round).

    Stops when the live clusters are at most ``target_clusters``, when no
    inter-cluster entry is left (entries below ``min_similarity`` do not
    count, when given), or after ``max_rounds``.  Returns ((n,) densified
    int64 labels, the same on every rank; info with the rounds and the
    clusters).
    """
    rows, _ = nbr.shape
    labels = _iota_labels(rows, mesh)
    rounds = 0
    for _ in range(max_rounds):
        if _live_clusters(labels, n, mesh) <= target_clusters:
            break
        nl, ok = _pull(labels, nbr, mesh)
        hook_idx, hook_val, n_rec = _affinity_select(
            labels, nbr, w, nl, ok, mesh, min_similarity)
        if int(comm.all_reduce_sum(mesh, n_rec)) == 0:
            break
        parent = _scatter_exchange(_iota_labels(rows, mesh), hook_idx,
                                   hook_val, mesh, "min")
        parent, _ = _pointer_jump(parent, mesh)
        labels, _ = _pull(parent, labels, mesh)
        rounds += 1
    host = _labels_to_host(labels, n, mesh)
    _, dense = np.unique(host, return_inverse=True)
    dense = dense.reshape(-1).astype(np.int64)
    return dense, {"rounds": rounds,
                   "clusters": int(dense.max()) + 1 if dense.size else 0}
