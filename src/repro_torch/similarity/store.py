"""Feature stores: the one interface every feature gather goes through
(``repro.similarity.store``).

  * :class:`ResidentFeatureStore`: the (n, d) table (dense and / or set
    blocks) on the session's device, the default.  ``gather`` is
    :func:`masked_take`.
  * :class:`PagedFeatureStore`: the dense table in HOST memory as pages
    of ``page_rows`` rows; ``gather`` faults the pages an index grid
    touches into a device page pool bounded by ``pool_bytes`` (least
    recently used pages go first) and serves the rows from there, so the
    device holds at most ``pool_bytes`` of features however large n grows
    (slabs, sketch words and window grids are O(n) and stay on the
    device).  Page traffic is metered in
    ``graph.accumulator.transfer_stats['feature_page_*']``.

The -1-sentinel contract: candidate index grids use -1 for empty and
padding slots; a resident store reads row 0 there, a paged store a zero
row, and every consumer masks those slots out downstream, so what they
read does not matter.

The paged store's device side is the port's own.  On a card the host
table lives in pinned memory, and a fault is one ``non_blocking`` copy
of a page slice into a slot of a preallocated device arena, one arena a
page kind (feature pages, and the measure-state pages of a learned
measure, whose page size differs).  A gather walks its page set in groups
that fit the pool and serves each group's rows with one index into the
arena: no per-group concatenation of the group's pages.  The LRU order,
its byte-accurate eviction over both kinds and the counters are the JAX
package's.  Each arena holds a whole pool of its kind, since either kind
may fill the budget alone, so a store with measure-state pages allocates
up to twice ``pool_bytes`` of device memory, of which at most
``pool_bytes`` holds resident pages at a time.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.graph import accumulator as acc_lib
from repro_torch.similarity.measures import PointFeatures


def masked_take(features: PointFeatures, idx: torch.Tensor) -> PointFeatures:
    """Gather rows for a -1-sentinel index grid (sentinels read row 0)."""
    return features.take(idx.clamp_min(0))


def _host_tensor(x) -> torch.Tensor:
    """A CPU tensor of ``x`` (a tensor on any device or an array-like),
    float64 taken as float32 as the session's resident table is."""
    t = as_tensor(x, device=torch.device("cpu"))
    if t.is_floating_point() and t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t


class FeatureStore:
    """Protocol base for feature access.

    Implementations provide ``n``; ``d`` (dense width or None) and
    ``dtype`` (dense dtype or None); ``device``; ``gather(idx)``, the rows
    at ``idx`` (any shape, -1 a sentinel) as a PointFeatures whose blocks
    have shape ``idx.shape + (...)``; ``append(rows)``, which raises on a
    dtype mismatch and never casts; ``checkpoint_view()``, the logical
    (n, ...) PointFeatures (a host view for a paged store).  A stateful
    measure keeps its per-point state table beside the features:
    ``attach_state(table)``, ``gather_state(idx)`` (the same sentinel
    contract), ``append_state(rows)`` for appended points, and
    ``state_width``.
    """

    n: int
    d: Optional[int]
    dtype = None
    state_width: Optional[int] = None

    def gather(self, idx) -> PointFeatures:
        raise NotImplementedError

    def append(self, rows: PointFeatures) -> None:
        raise NotImplementedError

    def checkpoint_view(self) -> PointFeatures:
        raise NotImplementedError

    def attach_state(self, table) -> None:
        raise NotImplementedError

    def gather_state(self, idx) -> torch.Tensor:
        raise NotImplementedError

    def append_state(self, rows) -> None:
        raise NotImplementedError


class ResidentFeatureStore(FeatureStore):
    """The table on the session's device: the JAX package's semantics, the
    default.  Wraps a PointFeatures (dense and / or set blocks) and, for a
    stateful measure, its (n, state_width) state table beside it."""

    def __init__(self, features: PointFeatures):
        self._features = features
        self._state: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self._features.n

    @property
    def d(self) -> Optional[int]:
        dense = self._features.dense
        return None if dense is None else int(dense.shape[1])

    @property
    def dtype(self) -> Optional[torch.dtype]:
        dense = self._features.dense
        return None if dense is None else dense.dtype

    @property
    def device(self) -> torch.device:
        return self._features.device

    @property
    def features(self) -> PointFeatures:
        return self._features

    def gather(self, idx) -> PointFeatures:
        return masked_take(self._features, as_tensor(idx, device=self.device))

    def append(self, rows: PointFeatures) -> None:
        self._features = self._features.concat(rows)

    def checkpoint_view(self) -> PointFeatures:
        return self._features

    @property
    def state_width(self) -> Optional[int]:
        return None if self._state is None else int(self._state.shape[1])

    @property
    def state_table(self) -> Optional[torch.Tensor]:
        """The device (n, state_width) table, or None."""
        return self._state

    def attach_state(self, table) -> None:
        self._state = as_tensor(table, device=self.device)

    def gather_state(self, idx) -> torch.Tensor:
        return self._state[as_tensor(idx, device=self.device).clamp_min(0)]

    def append_state(self, rows) -> None:
        if self._state is None:
            raise ValueError("append_state before attach_state")
        self._state = torch.cat(
            [self._state, as_tensor(rows, device=self.device)])


class _Arena:
    """``slots`` device pages of ``rows`` x ``width`` rows, and the free
    slots."""

    def __init__(self, slots: int, rows: int, width: int,
                 dtype: torch.dtype, device: torch.device):
        self.table = torch.empty((slots * rows, width), dtype=dtype,
                                 device=device)
        self.free = list(range(slots - 1, -1, -1))


class PagedFeatureStore(FeatureStore):
    """Out-of-core dense features: host row pages and a bounded device
    page pool (see the module docstring).

    Args:
      dense: the (n, d) table, any array-like or tensor; it is copied to
        host memory (pinned when ``device`` is CUDA), float64 as float32.
      page_rows: rows a page.
      pool_bytes: the device budget of resident pages, feature and state
        pages together (the arenas behind it take up to twice this once
        state pages are attached; see the module docstring).
      device: where gathers deliver (CUDA unless ``"cpu"``).

    Metering (``graph.accumulator.transfer_stats``), exactly the JAX
    package's: ``feature_page_bytes`` (faults x page bytes),
    ``feature_page_faults`` / ``_hits`` per page touch,
    ``feature_page_peak_bytes`` (high-water resident pool bytes, both
    kinds), and ``embed_page_bytes`` / ``_faults`` / ``_hits`` for the
    measure-state pages.
    """

    def __init__(self, dense, *, page_rows: int = 512,
                 pool_bytes: int = 64 << 20, device: DeviceLike = None):
        if page_rows < 1:
            raise ValueError(f"page_rows must be >= 1: {page_rows}")
        self.device = resolve_device(device)
        dense = _host_tensor(dense)
        if dense.dim() != 2:
            raise ValueError(f"paged store needs an (n, d) dense table, "
                             f"got shape {tuple(dense.shape)}")
        self._n = int(dense.shape[0])
        self._d = int(dense.shape[1])
        self.page_rows = int(page_rows)
        self.pool_bytes = int(pool_bytes)
        self.page_bytes = self.page_rows * self._d * dense.element_size()
        if self.page_bytes > self.pool_bytes:
            raise ValueError(
                f"one page ({self.page_rows} rows x {self._d} cols = "
                f"{self.page_bytes} B) exceeds pool_bytes={self.pool_bytes}"
                f" — lower StarsConfig.feature_page_rows or raise "
                f"feature_pool_bytes")
        self.pool_pages = max(1, self.pool_bytes // self.page_bytes)
        self._host = self._padded(dense)
        # (kind, page) -> arena slot; insertion order is recency (LRU).
        # kind is "feat" or "state"; both share the pool_bytes budget
        self._pages: "collections.OrderedDict[tuple, int]" = \
            collections.OrderedDict()
        self._arenas: Dict[str, _Arena] = {}
        self._res_bytes = 0
        self._state_host: Optional[torch.Tensor] = None
        self._state_page_bytes = 0
        self._state_pool_pages = 0

    def _padded(self, table: torch.Tensor) -> torch.Tensor:
        """``table`` padded with zero rows to a page multiple, contiguous,
        in pinned memory when the pages go to a card."""
        pad = (-table.shape[0]) % self.page_rows
        if pad:
            table = torch.cat([table, table.new_zeros(
                (pad,) + tuple(table.shape[1:]))])
        table = table.contiguous()
        if self.device.type == "cuda":
            table = table.pin_memory()
        return table

    @property
    def n(self) -> int:
        return self._n

    @property
    def d(self) -> int:
        return self._d

    @property
    def dtype(self) -> torch.dtype:
        return self._host.dtype

    @property
    def resident_bytes(self) -> int:
        """Resident pool bytes now (<= pool_bytes), both kinds."""
        return self._res_bytes

    def _clear_pool(self) -> None:
        self._pages.clear()
        self._arenas = {}
        self._res_bytes = 0

    # -- the pool -------------------------------------------------------- #
    def _arena(self, kind: str) -> _Arena:
        arena = self._arenas.get(kind)
        if arena is None:
            host = self._host if kind == "feat" else self._state_host
            slots = (self.pool_pages if kind == "feat"
                     else self._state_pool_pages)
            arena = self._arenas[kind] = _Arena(
                slots, self.page_rows, int(host.shape[1]), host.dtype,
                self.device)
        return arena

    def _touch(self, kind: str, page: int) -> int:
        """Fault or re-use one page; returns its arena slot.

        A gather touches at most a pool's worth of distinct pages of one
        kind between its reads, and a touched page moves to the recent
        end, so the evicted least recent page is never one of the current
        group.  Eviction is byte-accurate: feature and state pages differ
        in size but drain from the one LRU order until the new page fits.
        """
        stats = acc_lib.transfer_stats
        prefix = "feature_page" if kind == "feat" else "embed_page"
        key = (kind, page)
        slot = self._pages.get(key)
        if slot is not None:
            self._pages.move_to_end(key)
            stats[prefix + "_hits"] += 1
            return slot
        host, pbytes = ((self._host, self.page_bytes) if kind == "feat"
                        else (self._state_host, self._state_page_bytes))
        while self._pages and self._res_bytes + pbytes > self.pool_bytes:
            (old_kind, _), old_slot = self._pages.popitem(last=False)
            self._arenas[old_kind].free.append(old_slot)
            self._res_bytes -= (self.page_bytes if old_kind == "feat"
                                else self._state_page_bytes)
        arena = self._arena(kind)
        slot = arena.free.pop()
        r0 = page * self.page_rows
        base = slot * self.page_rows
        arena.table[base:base + self.page_rows].copy_(
            host[r0:r0 + self.page_rows], non_blocking=True)
        self._pages[key] = slot
        self._res_bytes += pbytes
        stats[prefix + "_faults"] += 1
        stats[prefix + "_bytes"] += pbytes
        stats["feature_page_peak_bytes"] = max(
            stats["feature_page_peak_bytes"], self._res_bytes)
        return slot

    def _gather_table(self, idx, kind: str, width: int, dtype: torch.dtype,
                      group_pages: int) -> torch.Tensor:
        """The host-driven page-group gather behind ``gather`` and
        ``gather_state``: the page set of ``idx`` in groups of
        ``group_pages``, each group's pages made resident, then its rows
        read with one index into the kind's arena."""
        if isinstance(idx, torch.Tensor):
            idx = idx.cpu().numpy()
        idx = np.asarray(idx)
        shape = idx.shape
        flat = idx.reshape(-1).astype(np.int64)
        out = torch.zeros((flat.size, width), dtype=dtype,
                          device=self.device)
        valid = np.flatnonzero(flat >= 0)
        if valid.size:
            rows = flat[valid]
            if rows.max() >= self._n:
                raise IndexError(f"gather index {int(rows.max())} out of "
                                 f"range for {self._n} rows")
            needed, rank = np.unique(rows // self.page_rows,
                                     return_inverse=True)
            rank = rank.reshape(-1)
            group = rank // group_pages
            order = np.argsort(group, kind="stable")
            cuts = np.searchsorted(group[order], np.arange(
                -(-needed.size // group_pages) + 1))
            for g, g0 in enumerate(range(0, needed.size, group_pages)):
                slots = np.array([self._touch(kind, int(p)) for p in
                                  needed[g0:g0 + group_pages]], np.int64)
                take = order[cuts[g]:cuts[g + 1]]
                loc = (slots[rank[take] - g0] * self.page_rows
                       + rows[take] % self.page_rows)
                out[self._index(valid[take])] = \
                    self._arenas[kind].table[self._index(loc)]
        return out.reshape(shape + (width,))

    def _index(self, arr: np.ndarray) -> torch.Tensor:
        """A host index array on the device; through pinned memory on a
        card, so the copy does not wait for the page copies before it."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def gather(self, idx) -> PointFeatures:
        return PointFeatures(dense=self._gather_table(
            idx, "feat", self._d, self._host.dtype, self.pool_pages))

    def append(self, rows: PointFeatures) -> None:
        if rows.dense is None:
            raise ValueError("paged store append: new rows carry no dense "
                             "block (the paged store is dense-only)")
        new = as_tensor(rows.dense, device=torch.device("cpu"))
        if new.dim() != 2 or new.shape[1] != self._d:
            raise ValueError(f"paged store append: shape "
                             f"{tuple(new.shape)} vs (*, {self._d})")
        if new.dtype != self._host.dtype:
            raise ValueError(
                f"paged store append: dense dtype {new.dtype} does not "
                f"match the store's {self._host.dtype} (append never "
                f"silently casts)")
        self._host = self._padded(torch.cat([self._host[:self._n], new]))
        self._n += int(new.shape[0])
        # the old tail page changed: start from a cold pool (appends are
        # rare)
        self._clear_pool()

    def checkpoint_view(self) -> PointFeatures:
        """The logical (n, d) table as a HOST view."""
        return PointFeatures(dense=self._host[:self._n])

    # -- measure state ---------------------------------------------------- #
    @property
    def state_width(self) -> Optional[int]:
        return (None if self._state_host is None
                else int(self._state_host.shape[1]))

    def attach_state(self, table) -> None:
        tab = as_tensor(table, device=torch.device("cpu"))
        if tab.dim() != 2 or tab.shape[0] != self._n:
            raise ValueError(f"attach_state: shape {tuple(tab.shape)} vs "
                             f"({self._n}, state_width)")
        width = int(tab.shape[1])
        self._state_page_bytes = self.page_rows * width * tab.element_size()
        if self._state_page_bytes > self.pool_bytes:
            raise ValueError(
                f"one state page ({self.page_rows} rows x {width} cols = "
                f"{self._state_page_bytes} B) exceeds pool_bytes="
                f"{self.pool_bytes}")
        self._state_pool_pages = max(
            1, self.pool_bytes // self._state_page_bytes)
        self._state_host = self._padded(tab)
        # state pages replace any earlier table's pages
        for key in [k for k in self._pages if k[0] == "state"]:
            del self._pages[key]
        self._arenas.pop("state", None)
        self._res_bytes = self.page_bytes * len(self._pages)

    def gather_state(self, idx) -> torch.Tensor:
        if self._state_host is None:
            raise ValueError("gather_state before attach_state")
        return self._gather_table(
            idx, "state", int(self._state_host.shape[1]),
            self._state_host.dtype, self._state_pool_pages)

    def append_state(self, rows) -> None:
        if self._state_host is None:
            raise ValueError("append_state before attach_state")
        new = as_tensor(rows, device=torch.device("cpu"))
        width = int(self._state_host.shape[1])
        if new.dim() != 2 or new.shape[1] != width:
            raise ValueError(f"append_state: shape {tuple(new.shape)} vs "
                             f"(*, {width})")
        # called after append() counted the new rows in n
        self._state_host = self._padded(torch.cat(
            [self._state_host[:self._n - new.shape[0]],
             new.to(self._state_host.dtype)]))
        self._clear_pool()


def make_feature_store(features: PointFeatures, kind: str = "resident", *,
                       page_rows: int = 512, pool_bytes: int = 64 << 20,
                       device: DeviceLike = None) -> FeatureStore:
    """The store ``StarsConfig.feature_store`` names: 'resident' wraps the
    features as they are (on their device); 'paged' moves the dense block
    to host pages (dense-only) that fault into a pool on ``device``."""
    if kind == "resident":
        return ResidentFeatureStore(features)
    if kind == "paged":
        if features.dense is None:
            raise ValueError(
                "cfg.feature_store='paged' requires dense features: the "
                "features= argument carries no dense block (supported "
                "stores: 'resident' for dense and/or set blocks, 'paged' "
                "for dense-only out-of-core tables)")
        return PagedFeatureStore(features.dense, page_rows=page_rows,
                                 pool_bytes=pool_bytes, device=device)
    raise ValueError(f"unknown feature store {kind!r}; supported: "
                     f"'resident', 'paged'")
