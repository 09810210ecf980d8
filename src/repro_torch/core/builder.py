"""``GraphBuilder``: a graph-build session on one device (``repro.core.builder``).

    builder = GraphBuilder(features, StarsConfig())   # on the card
    builder.add_reps(cfg.r)                           # run repetitions
    graph = builder.finalize()                        # THE device->host fetch

The degree slabs live on the session's device; each repetition folds its
candidate stream into them, and ``finalize`` fetches them once and compacts
them into a :class:`Graph`.  The session runs on CUDA unless the caller
passes ``device="cpu"``, where every kernel runs as its plain version.

Ported so far: the single-device backend with the windowed LSH and
SortingLSH sources (Stars and all-pairs scoring, with or without the
Hamming prefilter), ``add_reps``, ``finalize`` and ``stats``.
``extend`` / ``refresh_reps``, checkpoints, delta finalize, the
brute-force 'allpairs' source, paged feature stores, the pair-score cache
and the mesh come in later slices; configs that need them raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.spanner import Graph
from repro_torch.core.stars import (StarsConfig, _prefilter_sketch,
                                    _rep_candidates)
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.graph import accumulator as acc_lib
from repro_torch.similarity.measures import PointFeatures

_COUNTERS = ("comparisons", "emitted", "prefilter_ops", "scored_windows")


class RepetitionSource:
    """Windowed LSH / SortingLSH repetitions (Stars 1/2 and non-Stars).

    One round is one repetition: sketch with a fresh hash draw, sort and
    window, score the leader tiles and fold the masked candidate stream
    into the slabs.  The prefilter's packed sketch is computed once per
    bind, as in the JAX package.
    """

    def __init__(self, cfg: StarsConfig):
        self.cfg = cfg

    def bind(self, features: PointFeatures) -> Callable:
        cfg = self.cfg
        prefilter = (
            _prefilter_sketch(features, cfg.hamming_prefilter_bits, cfg.seed)
            if cfg.hamming_prefilter_bits > 0 else None)

        def round_step(state: acc_lib.EdgeAccumulator, rep_index: int):
            out = _rep_candidates(cfg, features, prefilter, rep_index)
            state = acc_lib.accumulate(state, out["src"], out["dst"],
                                       out["w"], out["emit"])
            return state, {k: out[k] for k in _COUNTERS}

        return round_step


CANDIDATE_SOURCES: Dict[str, Callable] = {
    "lsh-stars": RepetitionSource,
    "lsh-allpairs": RepetitionSource,
    "sorting-stars": RepetitionSource,
    "sorting-allpairs": RepetitionSource,
}


class _SingleDeviceBackend:
    """Feature table and slab state on one device."""

    def __init__(self, features: PointFeatures, cfg: StarsConfig):
        name = cfg.source_name
        if name not in CANDIDATE_SOURCES:
            raise NotImplementedError(
                f"candidate source {name!r} is not ported yet; ported: "
                f"{sorted(CANDIDATE_SOURCES)}")
        self.features = features
        self._round = CANDIDATE_SOURCES[name](cfg).bind(features)

    @property
    def n(self) -> int:
        return self.features.n

    def init_state(self, capacity: int) -> acc_lib.EdgeAccumulator:
        return acc_lib.EdgeAccumulator.create(
            self.n, capacity, device=self.features.device)

    def grow_state(self, state, n: int, capacity: int):
        return acc_lib.grow(state, n, capacity)

    def run_round(self, state, rep_index: int):
        return self._round(state, rep_index)


def _check_ported(cfg: StarsConfig) -> None:
    """Reject configs whose paths this port does not run yet, up front."""
    unported = {
        "refresh_rate": (cfg.refresh_rate, 0.0),
        "feature_store": (cfg.feature_store, "resident"),
        "pair_cache_slots": (cfg.pair_cache_slots, 0),
    }
    for field, (value, default) in unported.items():
        if value != default:
            raise NotImplementedError(
                f"StarsConfig.{field}={value!r} is not ported yet (only "
                f"{default!r}): it comes with a later slice of the port")
    if cfg.measure not in ("cosine", "dot"):
        raise NotImplementedError(
            f"measure={cfg.measure!r} is not ported yet (only dense "
            "'cosine' and 'dot')")
    if cfg.family.kind != "simhash":
        raise NotImplementedError(
            f"hash family {cfg.family.kind!r} is not ported yet (only "
            "'simhash')")


class GraphBuilder:
    """A graph-build session owning device-resident degree slabs.

    Args:
      features: PointFeatures, a tensor or an (n, d) array of dense
                features (float64 is taken as float32, as the JAX package
                does without x64).
      cfg:      StarsConfig; ``cfg.source_name`` selects the candidate
                source, ``cfg.degree_cap`` sizes the slabs.
      device:   where the session runs: ``None`` means CUDA, and raises
                without a card; ``"cpu"`` runs the plain versions.
    """

    # Per-round counters stay on the device and are summed to host ints
    # every few rounds, so rounds are not held up by a sync each.
    COUNTER_ROLLUP_EVERY = 8

    def __init__(self, features, cfg: StarsConfig, *,
                 device: DeviceLike = None):
        _check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        dense = features.dense if isinstance(features, PointFeatures) \
            else features
        dense = as_tensor(dense, device=self.device)
        if dense.is_floating_point() and dense.dtype != torch.float32:
            dense = dense.to(torch.float32)
        self._backend = _SingleDeviceBackend(
            PointFeatures(dense=dense.contiguous()), cfg)
        self._reps_done = 0
        self._counters: List[Dict] = []
        self._stats_base: Dict[str, int] = {}
        self._capacity = cfg.slab_capacity(self.n, reps=max(cfg.r, 1))
        self._state: Optional[acc_lib.EdgeAccumulator] = None

    @property
    def n(self) -> int:
        """Number of points in the session."""
        return self._backend.n

    @property
    def stats(self) -> Dict[str, int]:
        """Running session totals (comparisons, emitted, ...) as host ints."""
        return self._merged_stats()

    def add_reps(self, reps: Optional[int] = None) -> "GraphBuilder":
        """Run ``reps`` more repetitions (default cfg.r) into the slabs."""
        reps = self.cfg.r if reps is None else reps
        self._grow(self.n, self._reps_done + reps)
        for _ in range(reps):
            self._state, counters = self._backend.run_round(
                self._state, self._reps_done)
            self._counters.append(counters)
            if len(self._counters) >= self.COUNTER_ROLLUP_EVERY:
                self._roll_up_counters()
            self._reps_done += 1
        return self

    def _grow(self, n: int, reps_total: int) -> None:
        cap = max(self._capacity,
                  self.cfg.slab_capacity(n, reps=max(reps_total, 1)))
        if self._state is None:
            self._capacity = cap
            self._state = self._backend.init_state(cap)
        elif n > self._state.n or cap > self._capacity:
            self._state = self._backend.grow_state(self._state, n, cap)
            self._capacity = cap

    def _ensure_state(self) -> acc_lib.EdgeAccumulator:
        if self._state is None:
            self._state = self._backend.init_state(self._capacity)
        return self._state

    def _merged_stats(self) -> Dict[str, int]:
        totals = dict(self._stats_base)
        for counters in self._counters:
            for key, val in counters.items():
                total = (int(val.to(torch.int64).sum())
                         if isinstance(val, torch.Tensor)
                         else int(np.sum(np.asarray(val, np.int64))))
                totals[key] = totals.get(key, 0) + total
        totals["reps"] = self._reps_done
        totals["refresh_reps"] = 0
        totals.setdefault("refresh_comparisons", 0)
        return totals

    def _roll_up_counters(self) -> Dict[str, int]:
        stats = self._merged_stats()
        self._counters = []
        self._stats_base = dict(stats)
        return stats

    def slab_state(self) -> acc_lib.EdgeAccumulator:
        """The live device-resident (n, k) slabs (no host transfer)."""
        return self._ensure_state()

    def finalize(self, *, delta: bool = False) -> Graph:
        """Fetch the slabs off the device once and compact them to a Graph."""
        if delta:
            raise NotImplementedError(
                "finalize(delta=True) is not ported yet: it comes with the "
                "session-lifecycle slice")
        return acc_lib.to_graph(self._ensure_state(),
                                stats=self._roll_up_counters())

