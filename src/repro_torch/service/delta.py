"""Z-set slab deltas, a numpy copy of ``repro.service.delta``.

A :class:`SlabDelta` is one step of a session's delta stream
(``GraphBuilder.finalize(delta=True)``): the slab rows whose per-row
version advanced since the last ship, as Z-set records ``(node, nbr, w,
sign)`` with ``sign`` +1 for an entry that appeared in ``node``'s row and
-1 for one that was retracted (a weight change is a retraction and an
addition).  Slab rows hold distinct neighbours, so every (node, nbr,
w-bits) triple appears at most once on each side of a diff and
cancellation is the elimination of adjacent pairs.

A consumer applies deltas to a host replica (:func:`apply_delta`) to track
the device slabs row for row, and a delta checkpoint
(``BuilderCheckpoint(delta_chain=...)``) replays its chain onto a full
snapshot (:func:`replay_chain`).  Replay rebuilds each touched row as the
stable weight-descending sort of [surviving old entries in slot order ++
added entries in record order]: bit for bit the device row whenever the
weights within a row are distinct.

Everything here is host numpy and runs the JAX package's algorithm (one
sort of all entries of the changed rows), so records and images are its
own on the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SlabDelta:
    """One step of a delta stream: Z-set records + changed-row metadata.

    Attributes:
      seq:     1-based position in the emitting session's delta stream
               (chains must be applied in seq order, no gaps).
      n_old/n_new: row-count transition — apply grows the replica to
               ``n_new`` rows (new rows start empty).
      k_old/k_new: slab-capacity transition — apply pads replica columns.
      rows:    (R,) int32 ids of the rows this delta touches.
      row_ver: (R,) int64 logical versions of those rows AFTER this delta.
      node/nbr/w/sign: (m,) Z-set records; ``sign`` int8 ±1.  Records are
               grouped by node; within a node retractions precede
               additions, additions arrive in the new row's slot
               (weight-descending) order.
    """

    seq: int
    n_old: int
    n_new: int
    k_old: int
    k_new: int
    rows: np.ndarray
    row_ver: np.ndarray
    node: np.ndarray
    nbr: np.ndarray
    w: np.ndarray
    sign: np.ndarray

    @property
    def nbytes(self) -> int:
        """Serialized payload size — the compressed-checkpoint economics:
        O(records + touched rows), vs O(n * k) for a full image."""
        return int(self.rows.nbytes + self.row_ver.nbytes + self.node.nbytes
                   + self.nbr.nbytes + self.w.nbytes + self.sign.nbytes)

    @property
    def num_records(self) -> int:
        return int(self.node.shape[0])


def diff_rows(rows: np.ndarray, old_nbr: np.ndarray, old_w: np.ndarray,
              new_nbr: np.ndarray, new_w: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Z-set diff of R changed rows: old image vs new image.

    Both images are (R, k_old/k_new) slab rows (nbr -1 / w -inf on empty
    slots).  Returns (node, nbr, w, sign) record arrays: entries only in
    the old image retract (-1), entries only in the new image add (+1),
    entries present in both with IDENTICAL weight bits cancel and emit
    nothing.  Weights match on their float32 bit pattern — the replica
    tracks the device image bit-exactly, so a 1-ulp weight change is a
    real change and ships as retract+add.

    Vectorized both-tag cancellation: tag old entries -1 and new entries
    +1, sort by (row, nbr, w-bits, tag); a key appearing on both sides
    forms an adjacent ±1 pair (rows hold distinct nbrs, so at most one
    instance per side) and both members are dropped.
    """
    R = rows.shape[0]
    k_old = old_nbr.shape[1] if old_nbr.ndim == 2 else 0
    k_new = new_nbr.shape[1] if new_nbr.ndim == 2 else 0
    rid = np.concatenate([np.repeat(rows.astype(np.int32), k_old),
                          np.repeat(rows.astype(np.int32), k_new)])
    nbr = np.concatenate([old_nbr.ravel(), new_nbr.ravel()])
    w = np.concatenate([old_w.ravel(), new_w.ravel()]).astype(np.float32)
    tag = np.concatenate([np.full(R * k_old, -1, np.int8),
                          np.full(R * k_new, 1, np.int8)])
    live = nbr >= 0
    rid, nbr, w, tag = rid[live], nbr[live], w[live], tag[live]
    wbits = w.view(np.int32)
    order = np.lexsort((tag, wbits, nbr, rid))
    rid, nbr, w, wbits, tag = (rid[order], nbr[order], w[order],
                               wbits[order], tag[order])
    m = rid.shape[0]
    same_next = np.zeros(m, bool)
    if m > 1:
        same_next[:-1] = ((rid[1:] == rid[:-1]) & (nbr[1:] == nbr[:-1])
                          & (wbits[1:] == wbits[:-1]))
    # tag sorts -1 before +1, so a both-sides key is an adjacent (-1, +1)
    # pair: drop the pair (the entry did not change)
    cancel = same_next.copy()
    cancel[1:] |= same_next[:-1]
    keep = ~cancel
    rid, nbr, w, tag = rid[keep], nbr[keep], w[keep], tag[keep]
    # canonical record order: by node; retractions first, additions in the
    # new row's weight-descending slot order (replay relies on this)
    neg_w = np.where(np.isneginf(w), np.float32(np.inf), -w)
    order = np.lexsort((neg_w, tag, rid))
    return (rid[order].astype(np.int32), nbr[order].astype(np.int32),
            w[order].astype(np.float32), tag[order].astype(np.int8))


def apply_delta(nbr: np.ndarray, w: np.ndarray, delta: SlabDelta
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Apply one delta to a host slab replica -> new (nbr, w) arrays.

    The replica must be at the delta's pre-state shape (``n_old`` rows or
    fewer only if the delta is a from-empty snapshot, ``k_old`` columns);
    it is first grown to (n_new, k_new) with empty slots, then every
    touched row is rebuilt: retracted (nbr, w-bits) entries leave, added
    records join, and the row is stable-sorted weight-descending back into
    slot order.  Returns new arrays; the inputs are not mutated.
    """
    n_new, k_new = delta.n_new, delta.k_new
    out_nbr = np.full((n_new, k_new), -1, np.int32)
    out_w = np.full((n_new, k_new), -np.inf, np.float32)
    n0 = min(nbr.shape[0], n_new)
    k0 = min(nbr.shape[1] if nbr.ndim == 2 else 0, k_new)
    out_nbr[:n0, :k0] = nbr[:n0, :k0]
    out_w[:n0, :k0] = w[:n0, :k0]

    add = delta.sign > 0
    # retract: both-tag cancellation of the touched rows' current entries
    # against the retraction records (same trick as diff_rows)
    tr = delta.rows.astype(np.int32)
    cur_rid = np.repeat(tr, k_new)
    cur_nbr = out_nbr[tr].ravel()
    cur_w = out_w[tr].ravel()
    cur_slot = np.tile(np.arange(k_new, dtype=np.int32), tr.shape[0])
    live = cur_nbr >= 0
    cur_rid, cur_nbr, cur_w, cur_slot = (cur_rid[live], cur_nbr[live],
                                         cur_w[live], cur_slot[live])
    ret_rid = delta.node[~add]
    ret_nbr = delta.nbr[~add]
    ret_w = delta.w[~add]
    rid = np.concatenate([cur_rid, ret_rid])
    nb = np.concatenate([cur_nbr, ret_nbr])
    ww = np.concatenate([cur_w, ret_w]).astype(np.float32)
    tag = np.concatenate([np.ones(cur_rid.shape[0], np.int8),
                          np.full(ret_rid.shape[0], -1, np.int8)])
    slot = np.concatenate([cur_slot,
                           np.zeros(ret_rid.shape[0], np.int32)])
    wbits = ww.view(np.int32)
    order = np.lexsort((tag, wbits, nb, rid))
    rid, nb, ww, wbits, tag, slot = (rid[order], nb[order], ww[order],
                                     wbits[order], tag[order], slot[order])
    m = rid.shape[0]
    same_next = np.zeros(m, bool)
    if m > 1:
        same_next[:-1] = ((rid[1:] == rid[:-1]) & (nb[1:] == nb[:-1])
                          & (wbits[1:] == wbits[:-1]))
    cancel = same_next.copy()
    cancel[1:] |= same_next[:-1]
    if np.any(tag[~cancel] < 0):
        raise ValueError(
            "delta retracts an entry the replica does not hold — replica "
            "is not at the delta's pre-state (wrong order / missing delta "
            f"in the chain? seq={delta.seq})")
    surv = ~cancel & (tag > 0)
    s_rid, s_nbr, s_w, s_slot = rid[surv], nb[surv], ww[surv], slot[surv]

    # survivors (old slot order) ++ additions (record order), stable
    # weight-descending sort back into rows
    a_rid = delta.node[add]
    a_nbr = delta.nbr[add]
    a_w = delta.w[add].astype(np.float32)
    # arrival index: survivors keyed by their old slot, additions after
    arr = np.concatenate([s_slot,
                          k_new + np.arange(a_rid.shape[0], dtype=np.int64)])
    rid2 = np.concatenate([s_rid, a_rid]).astype(np.int64)
    nbr2 = np.concatenate([s_nbr, a_nbr])
    w2 = np.concatenate([s_w, a_w])
    neg_w = np.where(np.isneginf(w2), np.float32(np.inf), -w2)
    order = np.lexsort((arr, neg_w, rid2))
    rid2, nbr2, w2 = rid2[order], nbr2[order], w2[order]
    # rank within row = position - row start
    starts = np.searchsorted(rid2, tr)
    touched = np.zeros(n_new, np.int64)
    touched[tr] = starts
    rank = np.arange(rid2.shape[0], dtype=np.int64) - touched[rid2]
    if rid2.shape[0] and int(rank.max(initial=0)) >= k_new:
        raise ValueError(
            f"delta seq={delta.seq} overfills a row past capacity "
            f"{k_new} — replica is not at the delta's pre-state")
    out_nbr[tr] = -1
    out_w[tr] = -np.inf
    out_nbr[rid2, rank] = nbr2
    out_w[rid2, rank] = w2
    return out_nbr, out_w


def replay_chain(nbr: np.ndarray, w: np.ndarray,
                 chain: Sequence[SlabDelta]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Apply a seq-contiguous delta chain to a base slab image.

    The delta-checkpoint restore path (``GraphBuilder.restore`` with a
    ``delta_chain`` checkpoint): base image -> state after every delta, on
    the host, mesh-size-agnostic by construction (the image is already the
    unpadded (n, k) view).  Seqs must be strictly consecutive — a gap
    means a missing delta and a silently-wrong replay, so it raises.
    """
    prev = None
    for delta in chain:
        if prev is not None and delta.seq != prev + 1:
            raise ValueError(f"delta chain gap: seq {prev} -> {delta.seq}")
        prev = delta.seq
        nbr, w = apply_delta(nbr, w, delta)
    return np.asarray(nbr, np.int32), np.asarray(w, np.float32)
