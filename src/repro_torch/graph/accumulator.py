"""Device-resident streaming edge accumulator (``repro.graph.accumulator``).

State is a fixed-capacity per-node top-k table: (n, k) slabs of (nbr, w)
pairs plus a per-row version.  Each repetition's masked candidate stream
is folded in by :func:`accumulate`: doubled (one instance per endpoint),
deduplicated and bucketed into per-node candidate rows with device sorts,
then merged into the slabs by ``topk_merge`` (the CUDA kernel on the card,
the plain version on the CPU).  The host sees edges once per build, in
:func:`to_graph`, compacted on the device first.

Where the JAX package sorts on several operands at once, the port packs
keys into one int64 or chains stable sorts; ``.at[...].set(mode="drop")``
becomes a masked ``index_put_``.  Per-row results are those of the JAX
fold: the same survivors reach the same rows, and ``topk_merge`` computes
``topk_merge_ref``.  (The JAX CPU build merges with
``topk_merge_sorted_ref``, which orders cross-input exact weight ties
slab-first instead of by neighbour id; real-valued similarities make such
ties rare.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import f32_sort_key

_BIG = 2**31 - 1

# Host-transfer accounting: every fetch of edge payload off the device goes
# through to_graph(), so "one device-to-host edge transfer per build" is
# checkable; to_host() snapshots (checkpoints) and the delta stream's
# fetches of changed rows (GraphBuilder.finalize(delta=True)) count
# separately.  ``cluster_label_*`` meters GraphBuilder.cluster: its rounds
# run on the device and only the (n,) int32 label vector crosses, so
# ``edge_fetches`` / ``bytes`` stay untouched by any clustering.
# ``feature_page_*`` meters the paged feature store
# (similarity/store.py): host-to-device page faults and their bytes
# (faults x page bytes), pool re-uses, and the high-water resident pool
# bytes (feature and measure-state pages together); ``embed_page_*`` the
# measure-state pages' share of the traffic.  ``all_to_all_*`` and the
# other collective keys meter the mesh build's exchanges, this rank's
# cross-rank share (:mod:`repro_torch.distributed.comm`).
transfer_stats: Dict[str, int] = {"edge_fetches": 0, "bytes": 0,
                                  "checkpoint_fetches": 0,
                                  "checkpoint_bytes": 0,
                                  "delta_fetches": 0, "delta_bytes": 0,
                                  "delta_rows": 0,
                                  "cluster_label_fetches": 0,
                                  "cluster_label_bytes": 0,
                                  "feature_page_bytes": 0,
                                  "feature_page_faults": 0,
                                  "feature_page_hits": 0,
                                  "feature_page_peak_bytes": 0,
                                  "embed_page_bytes": 0,
                                  "embed_page_faults": 0,
                                  "embed_page_hits": 0,
                                  "all_to_all_calls": 0,
                                  "all_to_all_bytes": 0,
                                  "all_to_all_count_calls": 0,
                                  "all_to_all_count_bytes": 0,
                                  "slot_scatter_calls": 0,
                                  "slot_scatter_bytes": 0,
                                  "reshard_calls": 0,
                                  "reshard_bytes": 0,
                                  "all_gather_calls": 0,
                                  "all_gather_bytes": 0,
                                  "state_gather_calls": 0,
                                  "state_gather_bytes": 0,
                                  "all_reduce_calls": 0,
                                  "all_reduce_bytes": 0}


def reset_transfer_stats() -> None:
    for k in transfer_stats:
        transfer_stats[k] = 0


@dataclasses.dataclass(frozen=True)
class EdgeAccumulator:
    """Per-node top-k edge table.

    Attributes:
      nbr: (n, k) int32 neighbour ids, sorted by weight desc; -1 = empty.
      w:   (n, k) float32 edge weights; -inf on empty slots.
      ver: (n,) int32 per-row version, bumped by every fold that changes
           the row.
    """

    nbr: torch.Tensor
    w: torch.Tensor
    ver: torch.Tensor

    @property
    def n(self) -> int:
        return self.nbr.shape[0]

    @property
    def capacity(self) -> int:
        return self.nbr.shape[1]

    @staticmethod
    def create(n: int, capacity: int, *,
               device: DeviceLike = None) -> "EdgeAccumulator":
        dev = resolve_device(device)
        return EdgeAccumulator(
            nbr=torch.full((n, capacity), -1, dtype=torch.int32, device=dev),
            w=torch.full((n, capacity), float("-inf"), dtype=torch.float32,
                         device=dev),
            ver=torch.zeros((n,), dtype=torch.int32, device=dev))


def grow(state: EdgeAccumulator, n: int,
         capacity: Optional[int] = None) -> EdgeAccumulator:
    """Grow the slab table to ``n`` rows (and optionally more columns);
    new slots start empty and existing entries are kept verbatim."""
    n0, cap0 = state.nbr.shape
    capacity = cap0 if capacity is None else capacity
    if n < n0 or capacity < cap0:
        raise ValueError(f"cannot shrink slabs: ({n0},{cap0})->({n},{capacity})")
    if (n, capacity) == (n0, cap0):
        return state
    pad = (0, capacity - cap0, 0, n - n0)
    return EdgeAccumulator(
        nbr=torch.nn.functional.pad(state.nbr, pad, value=-1),
        w=torch.nn.functional.pad(state.w, pad, value=float("-inf")),
        ver=torch.nn.functional.pad(state.ver, (0, n - n0)))


def to_host(state: EdgeAccumulator):
    """Snapshot the slabs and row versions to host numpy arrays."""
    nbr, w, ver = (t.cpu().numpy() for t in (state.nbr, state.w, state.ver))
    transfer_stats["checkpoint_fetches"] += 1
    transfer_stats["checkpoint_bytes"] += nbr.nbytes + w.nbytes + ver.nbytes
    return nbr, w, ver


def from_host(nbr, w, ver=None, *, device: DeviceLike = None
              ) -> EdgeAccumulator:
    """Slabs on ``device`` from a host snapshot (this package's
    :func:`to_host` or the JAX package's).  ``ver`` defaults to zeros."""
    dev = resolve_device(device)
    nbr = as_tensor(np.asarray(nbr), device=dev, dtype=torch.int32)
    return EdgeAccumulator(
        nbr=nbr.contiguous(),
        w=as_tensor(np.asarray(w), device=dev,
                    dtype=torch.float32).contiguous(),
        ver=(torch.zeros((nbr.shape[0],), dtype=torch.int32, device=dev)
             if ver is None else
             as_tensor(np.asarray(ver), device=dev, dtype=torch.int32)))


def capacity_for(degree_cap: Optional[int], n: int, *,
                 reps: int = 1, per_rep_bound: int = 0) -> int:
    """Slab capacity: the degree cap clamped to n - 1, or without a cap the
    worst case ``reps * per_rep_bound`` distinct neighbours."""
    if degree_cap is not None:
        return max(1, min(degree_cap, n - 1))
    bound = reps * per_rep_bound if per_rep_bound > 0 else n - 1
    return max(1, min(n - 1, bound))


def accumulate(state: EdgeAccumulator, src: torch.Tensor, dst: torch.Tensor,
               w: torch.Tensor, valid: torch.Tensor) -> EdgeAccumulator:
    """Fold one masked candidate stream into the degree slabs.

    src/dst/w/valid: equally shaped tensors (flattened).  Invalid,
    negative-id and self-loop entries are ignored.  Each surviving
    candidate is inserted under both endpoints.
    """
    src = src.reshape(-1).to(torch.int64)
    dst = dst.reshape(-1).to(torch.int64)
    w = w.reshape(-1).to(torch.float32)
    ok = valid.reshape(-1) & (src >= 0) & (dst >= 0) & (src != dst)
    return _fold_triples(state, torch.cat([src, dst]), torch.cat([dst, src]),
                         torch.cat([w, w]), torch.cat([ok, ok]))


def _fold_triples(state: EdgeAccumulator, node: torch.Tensor,
                  nbr: torch.Tensor, ww: torch.Tensor,
                  ok2: torch.Tensor) -> EdgeAccumulator:
    """Fold directed (node, nbr, w) insertion triples into the slabs.

    Rows whose content changes get their ``ver`` bumped by one.
    """
    n, cap = state.nbr.shape
    dev = state.nbr.device
    node = node.to(torch.int64)
    nbr = nbr.to(torch.int64)
    ww = ww.to(torch.float32)
    ok2 = ok2 & (node >= 0) & (nbr >= 0)
    m2 = node.shape[0]
    kin = min(cap, m2)
    big = torch.full_like(node, _BIG)
    node_k = torch.where(ok2, node, big)
    nbr_k = torch.where(ok2, nbr, big)
    negw = torch.where(ok2, -ww, torch.full_like(ww, float("inf")))

    # 1) dedup within the batch: order by (node, nbr, -w) -- a stable
    #    presort on -w, then a stable sort on the packed (node, nbr) key --
    #    and drop all but the first (heaviest) instance of each pair
    perm = torch.sort(f32_sort_key(negw), stable=True).indices
    pair = ((node_k << 32) | nbr_k)[perm]
    pair, order = torch.sort(pair, stable=True)
    perm = perm[order]
    node_s, nbr_s, negw_s = node_k[perm], nbr_k[perm], negw[perm]
    first = torch.ones_like(ok2)
    first[1:] = pair[1:] != pair[:-1]
    keep = first & (node_s != _BIG)

    # 2) bucket: rank each node's survivors by (-w, nbr) -- the stable
    #    sort on the packed (node, -w) key keeps step 1's nbr order on
    #    ties -- and scatter the top kin into (n, kin) candidate rows;
    #    a candidate past rank kin >= cap can never enter the top cap
    node_k2 = torch.where(keep, node_s, big)
    negw2 = torch.where(keep, negw_s, torch.full_like(negw_s, float("inf")))
    nbr_k2 = torch.where(keep, nbr_s, big)
    order = torch.sort((node_k2 << 32) | f32_sort_key(negw2),
                       stable=True).indices
    node_f, negw_f, nbr_f = node_k2[order], negw2[order], nbr_k2[order]
    starts = torch.searchsorted(
        node_f, torch.arange(n, dtype=torch.int64, device=dev))
    live = node_f != _BIG
    node_c = torch.where(live, node_f, torch.zeros_like(node_f))
    rank = torch.arange(m2, dtype=torch.int64, device=dev) - starts[node_c]
    sel = live & (rank < kin)
    rows, slots = node_c[sel], rank[sel]
    inc_nbr = torch.full((n, kin), -1, dtype=torch.int32, device=dev)
    inc_w = torch.full((n, kin), float("-inf"), dtype=torch.float32,
                       device=dev)
    inc_nbr.index_put_((rows, slots), nbr_f[sel].to(torch.int32))
    inc_w.index_put_((rows, slots), -negw_f[sel])

    # 3) merge into the running slabs (CUDA kernel on the card): both
    #    inputs' rows are (-w, nbr)-sorted and deduplicated, the slab as a
    #    merge output (or the empty start) and inc by steps 1 and 2, the
    #    order in which the kernel merges without sorting
    new_nbr, new_w = kernel_ops.topk_merge(state.nbr, state.w, inc_nbr, inc_w)
    changed = ((new_nbr != state.nbr) | (new_w != state.w)).any(1)
    return EdgeAccumulator(nbr=new_nbr, w=new_w,
                           ver=state.ver + changed.to(torch.int32))


def to_graph(state: EdgeAccumulator, *,
             stats: Optional[Dict[str, float]] = None):
    """THE device-to-host edge transfer: ``Graph.from_degree_slabs`` on
    the slabs where they lie, so that only the deduplicated edges cross.
    ``bytes`` counts the slab bytes it reads, as the JAX package counts
    the slabs it fetches."""
    from repro_torch.core.spanner import Graph

    transfer_stats["edge_fetches"] += 1
    transfer_stats["bytes"] += (state.nbr.numel() * state.nbr.element_size()
                                + state.w.numel() * state.w.element_size())
    return Graph.from_degree_slabs(state.n, state.nbr, state.w, stats=stats)
