"""The always-on serving loop (``repro.service.session``): batched
absorption and device queries over a live :class:`GraphBuilder`.

Requests enter a BOUNDED queue (a full queue rejects the submit and counts
it) and the loop serves them in FIFO order:

  * **extend requests** coalesce: consecutive inserts (up to
    ``ServeConfig.batch_window``) are concatenated and absorbed by ONE
    ``builder.extend()``; after each absorb round the session can emit the
    Z-set delta (``finalize(delta=True)``) to its ``on_delta`` consumer.
  * **two-hop neighbour queries** are answered between rounds from the
    device slabs (:func:`two_hop_neighbors`): no edge fetch, only the
    (m, q_cap) answer crosses to the host (``stats['query_bytes']``).
  * **clustering requests** run ``builder.cluster(...)`` between rounds on
    the same slabs; only the (n,) label vector crosses
    (``stats['cluster_label_bytes']``).

``ServeSession.stats`` meters the session as the JAX package's does:
absorb rounds, points, queries, truncations, deltas, rejections, the
queue's high-water mark, and the page traffic a paged store's absorbs
drove.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import as_tensor
from repro_torch.graph import accumulator as acc_lib
from repro_torch.similarity.measures import PointFeatures

if TYPE_CHECKING:       # the builder imports service.delta
    from repro_torch.core.builder import GraphBuilder

# Device bytes a group of two-hop queries may take for its (g, n, k)
# temporaries, and the bytes a query takes per slab entry at their peak
# (float32 bottleneck weights beside their int64 scatter index).
QUERY_GROUP_BYTES = 4 << 30
_QUERY_BYTES_PER_ENTRY = 16


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of one serving session.

    Attributes:
      batch_window: most consecutive extend requests coalesced into one
        ``builder.extend()`` absorb round.
      max_queue: bounded-queue depth; submits beyond it are rejected
        (``stats['rejections']``) and return None.
      reps_per_absorb: repetitions an absorb round (None = ``cfg.r``).
      query_capacity: top-q answer size a queried node; larger two-hop
        neighbourhoods truncate (``stats['query_truncations']``).
      emit_deltas: emit a Z-set delta after every absorb round.
    """

    batch_window: int = 64
    max_queue: int = 1024
    reps_per_absorb: Optional[int] = None
    query_capacity: int = 128
    emit_deltas: bool = True


class Ticket:
    """Handle for one submitted request; ``result`` is set when served."""

    __slots__ = ("kind", "done", "result")

    def __init__(self, kind: str):
        self.kind = kind
        self.done = False
        self.result: Any = None

    def _resolve(self, result: Any) -> None:
        self.result = result
        self.done = True


def _two_hop_group(nbr, w, tgt, q, q_cap: int):
    """:func:`two_hop_neighbors` for one group of queries."""
    n, k = nbr.shape
    m = q.shape[0]
    dev = nbr.device
    neg = float("-inf")
    qc = q.clamp(0, n - 1)
    valid_q = (q >= 0) & (q < n)
    base = (torch.arange(m, device=dev) * (n + 1))[:, None]

    def scatter_max(index, vals):
        out = torch.full((m * (n + 1),), neg, device=dev)
        out.scatter_reduce_(0, index.reshape(-1), vals.reshape(-1),
                            reduce="amax")
        return out.view(m, n + 1)[:, :n]

    # symmetric one-hop weights (m, n): the query rows' entries, and the
    # reverse scan for edges kept only in the other endpoint's row
    row_n, row_w = nbr[qc], w[qc]
    fwd = scatter_max(torch.where(row_n >= 0, row_n.long(), n) + base,
                      row_w)
    rev = torch.where(nbr[None] == qc[:, None, None], w[None],
                      neg).amax(2)
    one_w = torch.where(valid_q[:, None], torch.maximum(fwd, rev), neg)
    del fwd, rev
    # second hop through every one-hop u, scored by the bottleneck weight
    # min(w(q, u), w(u, v)): forward through row[u], reverse through the
    # rows that hold u
    two_f = scatter_max(tgt[None] + base[:, :, None],
                        torch.minimum(one_w[:, :, None], w[None]))
    one_pad = torch.cat([one_w, one_w.new_full((m, 1), neg)], 1)
    two_r = torch.minimum(one_pad[:, tgt], w[None]).amax(2)
    score = torch.maximum(one_w, torch.maximum(two_f, two_r))
    del two_f, two_r, one_pad
    score[torch.arange(m, device=dev), qc] = neg
    count = (score > neg).sum(1, dtype=torch.int32)
    # jax.lax.top_k: value descending, the lower index first on a tie
    top_w, top_i = torch.sort(score, dim=1, descending=True, stable=True)
    top_w, top_i = top_w[:, :q_cap], top_i[:, :q_cap]
    ids = torch.where(top_w > neg, top_i.to(torch.int32), -1)
    return ids, top_w, count, (count > q_cap).sum(dtype=torch.int32)


def two_hop_neighbors(nbr: torch.Tensor, w: torch.Tensor, q, *,
                      q_cap: int, group_bytes: int = QUERY_GROUP_BYTES):
    """Two-hop neighbourhoods of the query nodes ``q``, on the slabs'
    device.

    The edge set is the slabs' symmetric closure (an edge exists if it
    sits in either endpoint's row), as ``Graph.from_degree_slabs`` +
    ``two_hop_sets`` see it.  A member is scored by its best bottleneck
    weight (its own weight for a one-hop member, ``max_u min(w(q, u),
    w(u, v))`` for a two-hop one) and the top ``q_cap`` are kept.  The
    JAX package computes all m queries in one program with (m, n, k)
    temporaries; here queries go in groups whose temporaries fit
    ``group_bytes``, each query's answer the same as in one call.

    Returns (ids (m, q_cap) int32 with -1 fill, weights (m, q_cap)
    float32, member counts (m,) int32, truncated queries (int32 scalar)).
    """
    n, k = nbr.shape
    q = as_tensor(q, device=nbr.device, dtype=torch.int64).reshape(-1)
    tgt = torch.where(nbr >= 0, nbr.long(), n)
    group = max(1, group_bytes // (_QUERY_BYTES_PER_ENTRY * n * k))
    parts = [_two_hop_group(nbr, w, tgt, q[g0:g0 + group], q_cap)
             for g0 in range(0, q.shape[0], group)]
    if not parts:
        parts = [_two_hop_group(nbr, w, tgt, q, q_cap)]
    ids, weights, counts, truncated = zip(*parts)
    return (torch.cat(ids), torch.cat(weights), torch.cat(counts),
            torch.stack(truncated).sum(dtype=torch.int32))


def _as_point_features(payload) -> PointFeatures:
    """An extend payload as PointFeatures: dense float64 taken as float32,
    as the JAX package's ``as_point_features`` does without x64."""
    if isinstance(payload, PointFeatures):
        return payload
    dense = as_tensor(payload, device=payload.device
                      if isinstance(payload, torch.Tensor)
                      else torch.device("cpu"))
    if dense.dtype == torch.float64:
        dense = dense.to(torch.float32)
    return PointFeatures(dense=dense)


_PAGE_KEYS = ("feature_page_bytes", "feature_page_faults",
              "embed_page_bytes", "embed_page_faults")


class ServeSession:
    """Always-on loop over a bounded request queue (module docstring).

    Args:
      builder: a GraphBuilder that has run at least one repetition.
      config: ServeConfig knobs.
      on_delta: optional callback receiving each emitted SlabDelta.

    ``submit_*`` are safe from any thread (a lock-guarded deque); the loop
    (``step`` / ``run_until_idle`` / ``serve_forever``) runs on one
    thread, one absorb or answer at a time.
    """

    def __init__(self, builder: "GraphBuilder",
                 config: Optional[ServeConfig] = None,
                 on_delta: Optional[Callable] = None):
        if builder.reps_done == 0:
            raise ValueError(
                "serve over an unscored builder: run add_reps() first "
                "(extension rounds only score new-vs-all pairs)")
        self.builder = builder
        self.config = config or ServeConfig()
        self._on_delta = on_delta
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._shutdown = False
        self._stats: Dict[str, int] = {
            "extends_absorbed": 0, "absorb_rounds": 0, "points_absorbed": 0,
            "queries_served": 0, "query_bytes": 0, "query_truncations": 0,
            "deltas_emitted": 0, "delta_rows_shipped": 0, "delta_bytes": 0,
            "clusterings_served": 0, "cluster_label_bytes": 0,
            "rejections": 0, "queue_depth_hwm": 0,
            **dict.fromkeys(_PAGE_KEYS, 0)}

    # -- submission (any thread) ---------------------------------------- #
    def _submit(self, kind: str, payload) -> Optional[Ticket]:
        ticket = Ticket(kind)
        with self._lock:
            if len(self._queue) >= self.config.max_queue:
                self._stats["rejections"] += 1
                return None
            self._queue.append((kind, payload, ticket))
            self._stats["queue_depth_hwm"] = max(
                self._stats["queue_depth_hwm"], len(self._queue))
        return ticket

    def submit_extend(self, features) -> Optional[Ticket]:
        """Queue points for insertion; None if rejected (queue full).  The
        resolved ticket carries ``{'first_gid', 'count'}``: gids are
        assigned at absorb time in queue order."""
        return self._submit("extend", features)

    def submit_query(self, node_ids) -> Optional[Ticket]:
        """Queue a two-hop query for ``node_ids``; None if rejected.  The
        resolved ticket carries ``{'nodes', 'ids', 'weights', 'counts'}``
        (host numpy, -1-padded top-q rows)."""
        return self._submit("query", np.asarray(node_ids, np.int32).ravel())

    def submit_cluster(self, method: str = "affinity",
                       **params) -> Optional[Ticket]:
        """Queue a clustering of the graph as of serving time
        (``builder.cluster(method, **params)``); None if rejected.  The
        resolved ticket carries ``{'labels', 'info'}``."""
        return self._submit("cluster", (method, dict(params)))

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def stats(self) -> Dict[str, int]:
        """A snapshot of the session's accounting."""
        with self._lock:
            return dict(self._stats)

    # -- the loop (one thread) ------------------------------------------ #
    def step(self) -> bool:
        """Serve the next request group; False when the queue is empty.

        Consecutive extends at the head coalesce into one absorb round
        (up to ``batch_window``); a query or clustering is served alone,
        between rounds, so it sees every insert queued before it.
        """
        batch: List = []
        request = None
        with self._lock:
            if not self._queue:
                return False
            if self._queue[0][0] == "extend":
                while (self._queue and self._queue[0][0] == "extend"
                       and len(batch) < self.config.batch_window):
                    batch.append(self._queue.popleft())
            else:
                request = self._queue.popleft()
        if batch:
            self._absorb(batch)
        else:
            self._answer(request)
        return True

    def run_until_idle(self) -> Dict[str, int]:
        """Drain the queue; returns the stats snapshot."""
        while self.step():
            pass
        return self.stats

    def serve_forever(self, poll_s: float = 0.005) -> None:
        """Loop until :meth:`shutdown`."""
        while not self._shutdown:
            if not self.step():
                time.sleep(poll_s)

    def shutdown(self) -> None:
        self._shutdown = True

    # -- internals ------------------------------------------------------ #
    def _absorb(self, batch: List) -> None:
        feats = [_as_point_features(payload) for _, payload, _ in batch]
        merged = feats[0]
        for f in feats[1:]:
            merged = merged.concat(f)
        first_gid = self.builder.n
        before = {k: acc_lib.transfer_stats[k] for k in _PAGE_KEYS}
        self.builder.extend(merged, reps=self.config.reps_per_absorb)
        with self._lock:
            self._stats["absorb_rounds"] += 1
            self._stats["extends_absorbed"] += len(batch)
            self._stats["points_absorbed"] += merged.n
            for k in _PAGE_KEYS:
                self._stats[k] += acc_lib.transfer_stats[k] - before[k]
        gid = first_gid
        for (_, _, ticket), f in zip(batch, feats):
            ticket._resolve({"first_gid": gid, "count": f.n})
            gid += f.n
        if self.config.emit_deltas:
            before = acc_lib.transfer_stats["delta_bytes"]
            delta = self.builder.finalize(delta=True)
            with self._lock:
                self._stats["deltas_emitted"] += 1
                self._stats["delta_rows_shipped"] += int(delta.rows.shape[0])
                self._stats["delta_bytes"] += (
                    acc_lib.transfer_stats["delta_bytes"] - before)
            if self._on_delta is not None:
                self._on_delta(delta)

    def _answer(self, request) -> None:
        kind, payload, ticket = request
        if kind == "cluster":
            method, params = payload
            labels, info = self.builder.cluster(method, return_info=True,
                                                **params)
            with self._lock:
                self._stats["clusterings_served"] += 1
                self._stats["cluster_label_bytes"] += int(labels.size) * 4
            ticket._resolve({"labels": labels, "info": info})
            return
        node_ids = payload
        state = self.builder.slab_state()
        q_cap = min(self.config.query_capacity, self.builder.n)
        ids, weights, counts, truncated = (
            t.cpu().numpy() for t in two_hop_neighbors(
                state.nbr, state.w, node_ids, q_cap=q_cap))
        with self._lock:
            self._stats["queries_served"] += int(node_ids.shape[0])
            self._stats["query_bytes"] += int(ids.nbytes) + int(
                weights.nbytes)
            self._stats["query_truncations"] += int(truncated)
        ticket._resolve({"nodes": node_ids, "ids": ids,
                         "weights": weights, "counts": counts})
