"""``GraphBuilder``: a graph-build session on one device (``repro.core.builder``).

    builder = GraphBuilder(features, StarsConfig())   # on the card
    builder.add_reps(cfg.r)                           # run repetitions
    builder.extend(new_points, reps=cfg.r)            # insert points, score
                                                      #   new-vs-all only
    builder.refresh_reps(2)                           # rescore a sample of
                                                      #   old-old windows
    ckpt = builder.checkpoint()                       # slabs + counters
    builder = GraphBuilder.restore(feats, cfg, ckpt)  #   -> host and back
    graph = builder.finalize()                        # THE device->host fetch
    delta = builder.finalize(delta=True)              # or only what changed

The degree slabs live on the session's device; each round folds its
candidate stream into them.  The session runs on CUDA unless the caller
passes ``device="cpu"``, where every kernel runs as its plain version.

Candidate sources: the windowed LSH / SortingLSH repetitions of
``core/stars.py`` (Stars and all-pairs scoring, with or without the
Hamming prefilter) and the exact blocked 'allpairs' sweep (the paper's
AllPair baseline).  Extension rounds score only pairs that touch a new
point; refresh rounds rescore old-old pairs in a sampled set of windows,
weighted by how long a window went unsampled (a host age ledger that
replays the device's draw).  Checkpoints are full slab images or chains
of :class:`repro_torch.service.delta.SlabDelta` records.

Scoring goes through a :class:`repro_torch.similarity.measure.Measure`:
the closed-form measures (cosine, dot, angular, Jaccard, mixture) by name,
or a learned two-tower measure passed as ``measure=`` (its embeddings are
computed once a point and kept beside the features) or as a legacy
``learned_apply=`` closure.  ``cfg.pair_cache_slots`` > 0 keeps a
device-resident pair-score cache for an expensive measure
(:mod:`repro_torch.similarity.pair_cache`).

Features go through a :mod:`repro_torch.similarity.store` feature store:
resident on the device (the default), or ``feature_store='paged'``: host
pages faulted into a bounded device pool, so n is bounded by host memory
(:class:`_PagedBackend`).  ``cluster`` runs connected components or
average-linkage Affinity on the live slabs on the device
(:mod:`repro_torch.graph.cluster`); only the label vector crosses to the
host.  Not ported yet: the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import lsh as lsh_lib
from repro_torch.core import windows as win_lib
from repro_torch.core.spanner import Graph
from repro_torch.core.stars import (StarsConfig, _emit, _prefilter_sketch,
                                    _rep_candidates, _rep_keys, _rep_seed,
                                    _rep_window_grid, _score_windows)
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.graph import accumulator as acc_lib
from repro_torch.service.delta import SlabDelta, diff_rows, replay_chain
from repro_torch.similarity import pair_cache as pc_lib
from repro_torch.similarity.measure import Measure, make_measure
from repro_torch.similarity.measures import PointFeatures
from repro_torch.similarity.store import (FeatureStore, PagedFeatureStore,
                                          ResidentFeatureStore,
                                          make_feature_store)

_COUNTERS = ("comparisons", "emitted", "prefilter_ops", "scored_windows")

Progress = Optional[Callable[[int], None]]


class RepetitionSource:
    """Windowed LSH / SortingLSH repetitions (Stars 1/2 and non-Stars).

    One round is one repetition: sketch with a fresh hash draw, sort and
    window, score the leader tiles through the measure and fold the
    masked candidate stream into the slabs.  The prefilter's packed
    sketch is computed once per bind, over all points, as in the JAX
    package.  ``measure_state`` is the measure's per-point state table
    (the cached embeddings).  With a pair cache the round looks every
    comparison lane up (``cmp``), takes cached scores on hits and
    re-derives the emit mask from the weights after the cache
    (``cmp & (w > r1)``, the in-stream formula), so cache-on builds equal
    cache-off builds while ``expensive_comparisons`` counts only misses.
    """

    def __init__(self, cfg: StarsConfig, measure: Measure):
        self.cfg = cfg
        self.measure = measure

    def bind(self, store: ResidentFeatureStore, new_from: int,
             refresh_below: int = 0,
             refresh_fraction: float = 1.0) -> Callable:
        cfg = self.cfg
        measure = self.measure
        features, measure_state = store.features, store.state_table
        prefilter = (
            _prefilter_sketch(features, cfg.hamming_prefilter_bits, cfg.seed)
            if cfg.hamming_prefilter_bits > 0 else None)

        def round_step(state: acc_lib.EdgeAccumulator, rep_index: int,
                       probs: Optional[np.ndarray] = None,
                       cache: Optional[pc_lib.PairCache] = None):
            out = _rep_candidates(cfg, features, prefilter, rep_index,
                                  new_from=new_from,
                                  refresh_below=refresh_below,
                                  refresh_fraction=refresh_fraction,
                                  refresh_probs=probs, measure=measure,
                                  state=measure_state)
            counters = {k: out[k] for k in _COUNTERS}
            w, emit = out["w"], out["emit"]
            if cache is not None:
                w, cache, hits, misses, evictions = pc_lib.lookup_insert(
                    cache, out["src"], out["dst"], w, out["cmp"])
                # a hit is the bit-identical score the tile computed, so
                # the in-stream emit lanes come back exactly
                emit = _emit(out["cmp"], w, cfg.r1)
                counters.update(emitted=emit.sum(dtype=torch.int64),
                                expensive_comparisons=misses,
                                cache_hits=hits, cache_misses=misses,
                                cache_evictions=evictions)
            state = acc_lib.accumulate(state, out["src"], out["dst"], w,
                                       emit)
            return state, counters, cache

        return round_step


class AllPairsSource:
    """The exact *AllPair* sweep: all n (n - 1) / 2 pairs, in blocks.

    One round is one sweep over (block x block) tiles a0 <= b0, each
    scored through the measure (with the rows' state for a stateful one)
    and folded into the slabs by ``accumulate`` (so through
    ``topk_merge``) at once.  The rows are read through the feature store,
    the A block once per outer step and the B block per tile, at ids
    clamped to n - 1 (the pair mask drops the clamped ones), so a paged
    store reads its pages in order.  The JAX package scores them outside
    any kernel; here cosine / dot are one ``torch.matmul`` of the
    (normalised) rows in IEEE fp32, never TF32, whatever the process's
    matmul precision.  On an extension
    round only tiles that touch a new point are visited and the pair mask
    keeps new-vs-all pairs: C(n, 2) - C(n_old, 2) comparisons.
    """

    def __init__(self, cfg: StarsConfig, measure: Measure):
        self.cfg = cfg
        self.measure = measure

    def bind(self, store: FeatureStore, new_from: int,
             refresh_below: int = 0,
             refresh_fraction: float = 1.0) -> Callable:
        if refresh_below > 0:
            raise ValueError("the exact 'allpairs' source has no sampling "
                             "staleness to refresh")
        cfg = self.cfg
        measure = self.measure
        n = store.n
        block = min(cfg.allpairs_block, max(n, 1))
        span = torch.arange(block, dtype=torch.int64, device=store.device)
        stateful = measure.state_width is not None

        def rows(lo: int):
            ids = (lo + span).clamp_max(n - 1)
            return (store.gather(ids),
                    store.gather_state(ids) if stateful else None)

        def block_step(state, a0: int, b0: int, fa, sa):
            fb, sb = rows(b0)
            sims = (measure(fa, fb) if sa is None
                    else measure(fa, fb, sa, sb)).to(torch.float32)
            ids_a, ids_b = a0 + span, b0 + span
            keep = (ids_a[:, None] < ids_b[None, :]) & (ids_b[None, :] < n)
            if new_from > 0:
                keep &= ids_b[None, :] >= new_from   # the new side
            keep = _emit(keep, sims, cfg.r1)
            aa = ids_a[:, None].expand(block, block)
            bb = ids_b[None, :].expand(block, block)
            return acc_lib.accumulate(state, aa, bb, sims, keep)

        def round_step(state, rep_index: int, probs=None, cache=None):
            del rep_index, probs, cache              # the sweep is exact
            for a0 in range(0, n, block):
                fa, sa = rows(a0)
                for b0 in range(a0, n, block):
                    if new_from > 0 and b0 + block <= new_from:
                        continue                     # both endpoints old
                    state = block_step(state, a0, b0, fa, sa)
            comps = n * (n - 1) // 2 - new_from * (new_from - 1) // 2
            return state, {"comparisons": comps}, None

        return round_step


CANDIDATE_SOURCES: Dict[str, Callable] = {
    "lsh-stars": RepetitionSource,
    "lsh-allpairs": RepetitionSource,
    "sorting-stars": RepetitionSource,
    "sorting-allpairs": RepetitionSource,
    "allpairs": AllPairsSource,
}


class _SingleDeviceBackend:
    """The features and the slab state on one device.

    The features ride in a :class:`ResidentFeatureStore`; a stateful
    measure's per-point state (the learned measure's tower embeddings) is
    computed once per build and, after an ``extend``, for the appended
    rows only (``ensure_measure_state``), and kept in the store beside
    them.  With ``cfg.pair_cache_slots`` > 0 the windowed rounds thread a
    pair-score cache (expensive measures only); gids are append-only, so
    it stays valid across an ``extend``.
    """

    def __init__(self, store: ResidentFeatureStore, cfg: StarsConfig,
                 measure: Measure):
        name = cfg.source_name
        if name not in CANDIDATE_SOURCES:
            raise ValueError(f"unknown candidate source {name!r}; "
                             f"known: {sorted(CANDIDATE_SOURCES)}")
        self.store = store
        self.measure = measure
        self.source = CANDIDATE_SOURCES[name](cfg, measure)
        # GraphBuilder admits the cache for an expensive measure over the
        # windowed sources only
        self.pair_cache = (
            pc_lib.create(cfg.pair_cache_slots, device=store.device)
            if cfg.pair_cache_slots > 0 else None)
        self._embedded = 0          # rows whose measure state is current
        # (new_from, refresh_below, refresh_fraction) -> bound round;
        # cleared by extend() (the table changed)
        self._bound: Dict = {}

    @property
    def features(self) -> PointFeatures:
        return self.store.features

    @property
    def n(self) -> int:
        return self.store.n

    def init_state(self, capacity: int) -> acc_lib.EdgeAccumulator:
        return acc_lib.EdgeAccumulator.create(
            self.n, capacity, device=self.store.device)

    def grow_state(self, state, n: int, capacity: int):
        return acc_lib.grow(state, n, capacity)

    def ensure_measure_state(self) -> int:
        """Run the measure's precompute over the rows not yet embedded
        (all of them first, then an extend's tail); returns how many rows
        it embedded (0 for a stateless measure)."""
        if self.measure.state_width is None:
            return 0
        n, lo = self.n, self._embedded
        if n <= lo:
            return 0
        if lo == 0:
            self.store.attach_state(self.measure.precompute(self.features))
        else:
            tail = self.features.map(lambda x: x[lo:n])
            self.store.append_state(self.measure.precompute(tail))
        self._embedded = n
        self._bound = {}
        return n - lo

    def run_round(self, state, rep_index: int, new_from: int,
                  refresh_below: int = 0, refresh_fraction: float = 1.0,
                  refresh_probs: Optional[np.ndarray] = None):
        key = (new_from, refresh_below, refresh_fraction)
        if key not in self._bound:
            self._bound[key] = self.source.bind(
                self.store, new_from, refresh_below, refresh_fraction)
        state, counters, self.pair_cache = self._bound[key](
            state, rep_index, refresh_probs, self.pair_cache)
        return state, counters

    def extend(self, new_features: PointFeatures) -> None:
        """Append rows to the table on its device (set blocks in the
        session's canonical dtypes; the dense dtype was checked equal)."""
        self.store.append(_as_features(new_features, self.store.device))
        self._bound = {}


def _refresh_window_count(cfg: StarsConfig, n: int) -> int:
    """Window rows of the current grid: the length of the refresh keep
    probabilities and of the host's refresh-age ledger."""
    return win_lib.window_slot_count(cfg.mode, n, cfg.window) // cfg.window


def _padded_ids(lo: int, hi: int, count: int, n: int) -> np.ndarray:
    """Row ids ``lo .. hi - 1`` padded with -1 to ``count`` entries, and
    -1 for ids past ``n``: one shape for every chunk of a stream."""
    ids = np.full(count, -1, np.int64)
    ids[:hi - lo] = np.arange(lo, hi)
    ids[ids >= n] = -1
    return ids


def _stream_sketch_words(store: PagedFeatureStore, cfg: StarsConfig,
                         rep_seed: int) -> torch.Tensor:
    """One repetition's (n, M) sketch words, streamed through a paged
    store in row chunks of the pool's size (each padded to one shape with
    -1 sentinels, which read zero rows and are dropped).

    Equal to the one-shot sketch of the resident table: the SimHash
    product is a row's own (float64, so its sign does not depend on the
    chunk's shape).  Only one chunk of features is on the device at a
    time; the words are an O(n) summary outside the feature budget.
    """
    n = store.n
    chunk = max(store.page_rows, min(store.pool_pages * store.page_rows, n))
    parts = []
    for c0 in range(0, n, chunk):
        rows = store.gather(_padded_ids(c0, min(c0 + chunk, n), chunk, n))
        parts.append(lsh_lib.sketch(rows, cfg.family, rep_seed=rep_seed))
    return torch.cat(parts)[:n]


def _stream_embed_rows(store: PagedFeatureStore, measure: Measure,
                       lo: int, hi: int) -> torch.Tensor:
    """Measure-state rows ``lo .. hi - 1`` streamed through a paged store
    in pool-sized chunks of one shape (sentinels read zero rows), each
    embedded on the device and landed on the HOST, where the store pages
    them back in under ``transfer_stats['embed_page_*']``.  A row's state
    is the resident precompute's bit for bit (the measure embeds in fixed
    blocks, ``similarity.measure.EMBED_BLOCK_ROWS``)."""
    count = hi - lo
    chunk = max(store.page_rows,
                min(store.pool_pages * store.page_rows, count))
    parts = []
    for c0 in range(lo, hi, chunk):
        rows = store.gather(_padded_ids(c0, min(c0 + chunk, hi), chunk,
                                        hi))
        parts.append(measure.precompute(rows).cpu())
    return torch.cat(parts)[:count]


class _PagedBackend:
    """A single-device build over a host-paged feature table: ``n`` is
    bounded by host memory, the device's feature bytes by the store's
    page pool (``StarsConfig.feature_pool_bytes``).

    A windowed repetition runs in three stages:

      1. sketch: the hash words streamed through the store in pool-sized
         row chunks (:func:`_stream_sketch_words`),
      2. grid: the window grid built on the device from the words (gids,
         validity and buckets are O(n) and stay there),
      3. score: the grid walked in chunks of window rows sized so that a
         chunk's gathered member block fits the pool (:meth:`_chunk_rows`);
         each chunk's gids cross to the host (one sync a chunk, counted in
         ``host_syncs``) to drive the store's gather, and the chunk goes
         through the same ``_score_windows`` as a resident build, in its
         row-subset mode (``row_offset=chunk start, total_rows=window
         rows``), folded into the slabs chunk by chunk.

    Sentinel slots of the padded last chunk gather zero rows and are not
    valid, so they never score.  The per-chunk counters sum to the
    resident totals.  The exact 'allpairs' source is ``AllPairsSource``'s
    sweep, which reads its blocks through the store.
    """

    def __init__(self, store: PagedFeatureStore, cfg: StarsConfig,
                 measure: Measure):
        windowed = ("lsh-stars", "sorting-stars",
                    "lsh-allpairs", "sorting-allpairs")
        if cfg.source_name not in windowed + ("allpairs",):
            raise ValueError(
                f"unknown candidate source {cfg.source_name!r}; "
                f"known: {sorted(CANDIDATE_SOURCES)}")
        if cfg.hamming_prefilter_bits > 0:
            raise NotImplementedError(
                "feature_store='paged' does not support the Hamming "
                "prefilter (its packed words would need their own paging); "
                "unset hamming_prefilter_bits or use feature_store="
                "'resident'")
        self.store = store
        self.cfg = cfg
        self.measure = measure
        self._embedded = 0           # rows whose measure state is current
        self.host_syncs = 0          # chunk gids copied to the host

    @property
    def n(self) -> int:
        return self.store.n

    # the slabs: as on the resident backend (O(n k) device tensors,
    # outside the feature pool's budget)
    def init_state(self, capacity: int) -> acc_lib.EdgeAccumulator:
        return acc_lib.EdgeAccumulator.create(
            self.n, capacity, device=self.store.device)

    def grow_state(self, state, n: int, capacity: int):
        return acc_lib.grow(state, n, capacity)

    def ensure_measure_state(self) -> int:
        """Stream-embed the rows not yet in the store's state table (all
        of them first, then an extend's tail); returns how many rows it
        embedded (0 for a stateless measure)."""
        if self.measure.state_width is None:
            return 0
        n, lo = self.n, self._embedded
        if n <= lo:
            return 0
        rows = _stream_embed_rows(self.store, self.measure, lo, n)
        if lo == 0:
            self.store.attach_state(rows)
        else:
            self.store.append_state(rows)
        self._embedded = n
        return n - lo

    def _chunk_rows(self, nw: int) -> int:
        """Window rows a scoring chunk: the most whose gathered (C x
        window, d [+ state width]) block fits the pool's budget."""
        width = self.store.d + (self.measure.state_width or 0)
        itemsize = torch.empty((), dtype=self.store.dtype).element_size()
        row_bytes = self.cfg.window * width * itemsize
        return int(max(1, min(nw, self.store.pool_bytes // max(row_bytes,
                                                               1))))

    def run_round(self, state, rep_index: int, new_from: int,
                  refresh_below: int = 0, refresh_fraction: float = 1.0,
                  refresh_probs: Optional[np.ndarray] = None):
        if self.cfg.source_name == "allpairs":
            state, counters, _ = AllPairsSource(self.cfg, self.measure).bind(
                self.store, new_from, refresh_below)(state, rep_index)
            return state, counters
        cfg, store = self.cfg, self.store
        dev = store.device
        k_tie, k_shift, k_lead, k_refresh = _rep_keys(cfg, rep_index)
        words = _stream_sketch_words(store, cfg, _rep_seed(cfg, rep_index))
        win = _rep_window_grid(cfg, words, k_tie, k_shift)
        del words
        nw, w_sz = win.gid.shape
        c_rows = self._chunk_rows(nw)
        pad = (-nw) % c_rows

        def padded(t, fill):
            return torch.cat([t, t.new_full((pad, w_sz), fill)])

        gid = padded(win.gid, -1)
        valid = padded(win.valid, False)
        bucket = padded(win.bucket, win_lib.PAD_BUCKET)
        probs = None
        if refresh_below > 0:
            probs = as_tensor(
                np.full(nw, refresh_fraction, np.float32)
                if refresh_probs is None else refresh_probs,
                device=dev, dtype=torch.float32)
        member_index = torch.arange(c_rows * w_sz, device=dev).reshape(
            c_rows, w_sz)
        stateful = self.measure.state_width is not None
        per_chunk = []
        for c0 in range(0, nw, c_rows):
            gid_c = gid[c0:c0 + c_rows]
            gid_np = gid_c.cpu().numpy()
            self.host_syncs += 1
            block = store.gather(gid_np).dense.reshape(c_rows * w_sz, -1)
            mstate = (store.gather_state(gid_np).reshape(c_rows * w_sz, -1)
                      if stateful else None)
            out = _score_windows(
                cfg, PointFeatures(dense=block), None,
                win_lib.Windows(gid=gid_c, valid=valid[c0:c0 + c_rows],
                                bucket=bucket[c0:c0 + c_rows]),
                k_lead, new_from=new_from, refresh_below=refresh_below,
                refresh_fraction=refresh_fraction, k_refresh=k_refresh,
                refresh_probs=probs, measure=self.measure, state=mstate,
                row_offset=c0, total_rows=nw, member_index=member_index)
            state = acc_lib.accumulate(state, out["src"], out["dst"],
                                       out["w"], out["emit"])
            per_chunk.append({k: out[k] for k in _COUNTERS})
        counters = {}
        for key in _COUNTERS:
            vals = [c[key] for c in per_chunk]
            counters[key] = (torch.cat([v.reshape(-1) for v in vals])
                             if isinstance(vals[0], torch.Tensor)
                             else sum(vals))
        return state, counters

    def extend(self, new_features: PointFeatures) -> None:
        self.store.append(new_features)


def as_feature_store(features, cfg: StarsConfig,
                     device: torch.device) -> FeatureStore:
    """The session's FeatureStore: one passed in as it is, or the store
    ``cfg.feature_store`` names around raw features (a paged store takes a
    host array or tensor straight into its host pages, with no round trip
    through the device)."""
    if isinstance(features, FeatureStore):
        return features
    if cfg.feature_store == "paged":
        if not isinstance(features, PointFeatures):
            features = PointFeatures(dense=features)
        return make_feature_store(features, "paged",
                                  page_rows=cfg.feature_page_rows,
                                  pool_bytes=cfg.feature_pool_bytes,
                                  device=device)
    return make_feature_store(_as_features(features, device),
                              cfg.feature_store)


def _as_features(features, device: torch.device) -> PointFeatures:
    """The session's PointFeatures on ``device``: a PointFeatures or a bare
    (n, d) dense array or tensor.  Dense float64 is taken as float32 (as
    the JAX package does without x64), set ids as int32, set weights as
    float32, the set mask as bool."""
    if not isinstance(features, PointFeatures):
        features = PointFeatures(dense=features)
    dense = None
    if features.dense is not None:
        dense = as_tensor(features.dense, device=device)
        if dense.is_floating_point() and dense.dtype != torch.float32:
            dense = dense.to(torch.float32)
    block = lambda x, dt: (None if x is None
                           else as_tensor(x, device=device, dtype=dt))
    return PointFeatures(
        dense=dense, set_idx=block(features.set_idx, torch.int32),
        set_w=block(features.set_w, torch.float32),
        set_mask=block(features.set_mask, torch.bool)).map(
            lambda x: x.contiguous())


@dataclasses.dataclass
class BuilderCheckpoint:
    """Host snapshot of a build session, the fields of the JAX package's.

    Numpy payloads.  Restoring into a session with the same features and
    config and running the remaining rounds equals never having
    checkpointed, bit for bit (a round's randomness derives from
    ``cfg.seed`` and its index alone); ``restore`` refuses another config.

      * full (``checkpoint()``): ``nbr`` / ``w`` hold the (n, k) slab
        image, ``ver`` the int64 logical row versions, ``base_seq`` the
        delta stream's position; ``delta_chain`` is None.
      * delta (``checkpoint(delta=True)``): ``nbr`` / ``w`` are None and
        ``delta_chain`` holds the :class:`SlabDelta` records emitted since
        the full checkpoint cut at ``base_seq``;
        ``restore(..., base=that_checkpoint)`` replays it.

    ``refresh_*`` carry the staleness-repair state (watermark, refresh
    rounds run, the automatic policy's fractional credit, the per-window
    ages), so a restored session refreshes as the uncheckpointed one.
    ``measure_fingerprint`` is the session measure's
    :meth:`Measure.fingerprint` (None for the closed-form measures);
    ``restore`` refuses a session under another one.
    """

    n: int
    capacity: int
    reps_done: int
    nbr: Optional[np.ndarray]
    w: Optional[np.ndarray]
    stats: Dict[str, int]
    cfg: StarsConfig
    refresh_watermark: int = 0
    refresh_reps: int = 0
    refresh_credit: float = 0.0
    refresh_age: Optional[np.ndarray] = None
    ver: Optional[np.ndarray] = None
    base_seq: int = 0
    delta_chain: Optional[tuple] = None
    measure_fingerprint: Optional[str] = None


class GraphBuilder:
    """A graph-build session owning device-resident degree slabs.

    Args:
      features: PointFeatures (dense and / or set blocks), or a tensor or
                an (n, d) array of dense features (float64 is taken as
                float32, as the JAX package does without x64), or a
                :class:`FeatureStore`; ``cfg.feature_store='paged'`` keeps
                the dense table in host pages.
      cfg:      StarsConfig; ``cfg.source_name`` selects the candidate
                source, ``cfg.degree_cap`` sizes the slabs.
      device:   where the session runs: ``None`` means CUDA, and raises
                without a card; ``"cpu"`` runs the plain versions.
      measure:  for ``cfg.measure='learned'``: a
                :class:`repro_torch.similarity.measure.LearnedMeasure`
                (embeddings cached a point, the checkpoint fingerprint)
                or any Measure; its parameters move to ``device``.
      learned_apply: a legacy ``(fa, fb) -> sims`` closure for
                ``measure='learned'``: every tile pays the whole model.
    """

    # Per-round counters stay on the device and are summed to host ints
    # every few rounds, so rounds are not held up by a sync each.
    COUNTER_ROLLUP_EVERY = 8

    def __init__(self, features, cfg: StarsConfig, *,
                 device: DeviceLike = None,
                 learned_apply: Optional[Callable] = None,
                 measure: Optional[Measure] = None):
        if measure is not None and learned_apply is not None:
            raise ValueError(
                "pass either measure= or the legacy learned_apply=, not "
                "both (they would name two different scoring functions)")
        if cfg.refresh_rate < 0:
            raise ValueError(f"refresh_rate must be >= 0: {cfg.refresh_rate}")
        if cfg.refresh_rate > 0 and not cfg.refresh_fraction > 0:
            raise ValueError(
                f"refresh_rate > 0 needs a positive refresh_fraction (got "
                f"{cfg.refresh_fraction}): automatic refresh rounds would "
                "sample no window and repair nothing")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._measure = make_measure(
            cfg.measure, alpha=cfg.mixture_alpha,
            learned=measure if measure is not None else learned_apply
        ).to(self.device)
        self._cache_on = cfg.pair_cache_slots > 0
        store = as_feature_store(features, cfg, self.device)
        self._store = store
        paged = isinstance(store, PagedFeatureStore)
        if self._cache_on:
            if not self._measure.expensive:
                raise ValueError(
                    f"pair_cache_slots={cfg.pair_cache_slots} only pays "
                    f"for an expensive (learned) measure; "
                    f"measure={cfg.measure!r} is closed-form")
            if paged:
                raise NotImplementedError(
                    "the pair-score cache is device-resident state; it does "
                    "not combine with feature_store='paged' (set "
                    "pair_cache_slots=0)")
            if cfg.source_name == "allpairs":
                raise ValueError(
                    "the exact 'allpairs' sweep scores every pair once: "
                    "a pair cache cannot hit (set pair_cache_slots=0)")
        self._embed_rows = 0
        self._backend = (_PagedBackend(store, cfg, self._measure) if paged
                         else _SingleDeviceBackend(store, cfg,
                                                   self._measure))
        self._reps_done = 0
        self._counters: List[Dict] = []
        self._stats_base: Dict[str, int] = {}
        # staleness repair: gids below the watermark are "old"; their
        # mutual pairs left the round stream when it last moved
        self._refresh_below = 0
        self._refresh_reps = 0
        self._refresh_credit = 0.0
        self._refresh_age: Optional[np.ndarray] = None
        # versioned slabs: logical row version = _ver_base + state.ver; the
        # ship shadow is the host image of what the delta stream shipped
        self._ver_base = 0
        self._shadow_nbr: Optional[np.ndarray] = None
        self._shadow_w: Optional[np.ndarray] = None
        self._shipped_ver: Optional[np.ndarray] = None
        self._delta_seq = 0
        self._delta_log: List[SlabDelta] = []
        self._last_full_seq: Optional[int] = None
        self._capacity = cfg.slab_capacity(self.n, reps=max(cfg.r, 1))
        self._state: Optional[acc_lib.EdgeAccumulator] = None

    @property
    def n(self) -> int:
        """Number of points in the session."""
        return self._backend.n

    @property
    def feature_store(self) -> FeatureStore:
        """The session's FeatureStore (resident or paged)."""
        return self._store

    @property
    def measure(self) -> Measure:
        """The session's similarity Measure (two-phase contract)."""
        return self._measure

    @property
    def reps_done(self) -> int:
        return self._reps_done

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def refresh_watermark(self) -> int:
        """Points with a gid below this are "old" (0 before any extend)."""
        return self._refresh_below

    @property
    def stats(self) -> Dict[str, int]:
        """Running session totals (comparisons, emitted, ...) as host ints."""
        return self._merged_stats()

    def add_reps(self, reps: Optional[int] = None, *,
                 progress: Progress = None) -> "GraphBuilder":
        """Run ``reps`` more repetitions (default cfg.r) into the slabs.

        The exact 'allpairs' source runs one sweep per point set.
        """
        if self.cfg.source_name == "allpairs":
            reps = 1 if reps is None else reps
            if reps != 1 or self._reps_done > 0:
                raise ValueError(
                    "the 'allpairs' source is exact: one sweep per point "
                    "set (use extend() to cover inserted points)")
        else:
            reps = self.cfg.r if reps is None else reps
        self._run_rounds(reps, new_from=0, progress=progress)
        return self

    def _validate_extend(self, nf: PointFeatures) -> None:
        """Refuse a batch the store cannot take, naming the argument."""
        table = self._store.checkpoint_view()
        for name in ("dense", "set_idx", "set_w", "set_mask"):
            have, new = getattr(table, name), getattr(nf, name)
            if (have is None) != (new is None):
                raise ValueError(
                    f"extend(new_features=...): the {name} block is "
                    f"{'missing' if new is None else 'not in the table'}; "
                    "the rows must carry the session's blocks")
        dense = nf.dense
        if dense is None:
            return
        dtype = dense.dtype if isinstance(dense, torch.Tensor) else \
            torch.from_numpy(np.empty(0, np.asarray(dense).dtype)).dtype
        if dtype != table.dense.dtype:
            raise ValueError(
                f"extend(new_features=...): dense dtype {dtype} does not "
                f"match the session's {table.dense.dtype} table (append "
                "never casts: cast rows would score differently from the "
                "caller's originals)")
        if tuple(dense.shape[1:]) != tuple(table.dense.shape[1:]):
            raise ValueError(
                f"extend(new_features=...): rows of shape "
                f"{tuple(dense.shape[1:])}, the session's are "
                f"{tuple(table.dense.shape[1:])}")

    def extend(self, new_features, reps: Optional[int] = None, *,
               progress: Progress = None) -> "GraphBuilder":
        """Append points and run ``reps`` new-vs-all repetitions.

        The slabs grow by the new rows (old edges untouched); the
        extension rounds window all points but score only pairs with a
        new endpoint (LSH-Stars rescores every sub-bucket a new point
        lands in).  The staleness watermark moves to the old point count,
        and with ``cfg.refresh_rate`` > 0 the extend banks ``reps *
        refresh_rate`` refresh credit and runs its whole rounds as
        refresh rounds (:meth:`refresh_reps`).
        """
        if self._reps_done == 0:
            raise ValueError(
                "extend() before any repetitions: the original points "
                "would never be scored against each other (extension "
                "rounds mask old-old pairs); run add_reps() first")
        if self.cfg.source_name == "allpairs":
            reps = 1 if reps is None else reps
            if reps != 1:
                raise ValueError("the 'allpairs' source is exact: one "
                                 "new-vs-all sweep per extension")
        else:
            reps = self.cfg.r if reps is None else reps
        nf = new_features
        if not isinstance(nf, PointFeatures):
            nf = PointFeatures(dense=nf if isinstance(nf, torch.Tensor)
                               else np.asarray(nf))
        if nf.n == 0:
            # nothing to score, and the watermark must not move
            return self
        self._validate_extend(nf)
        old_n = self.n
        self._backend.extend(nf)
        self._refresh_below = old_n
        self._run_rounds(reps, new_from=old_n, progress=progress)
        if self.cfg.refresh_rate > 0 and self.cfg.source_name != "allpairs":
            self._refresh_credit += reps * self.cfg.refresh_rate
            auto = int(self._refresh_credit)
            if auto:
                self._refresh_credit -= auto
                self._run_rounds(auto, new_from=0,
                                 refresh_below=self._refresh_below,
                                 refresh_fraction=self.cfg.refresh_fraction,
                                 progress=progress)
        return self

    def refresh_reps(self, reps: int = 1, *, fraction: Optional[float] = None,
                     progress: Progress = None) -> "GraphBuilder":
        """Run ``reps`` staleness-repair repetitions over old-old windows.

        A refresh round is the inverse of an extension round: it sketches
        and windows all points with a fresh draw and scores only pairs
        whose endpoints both lie below the watermark, inside a sampled
        ``fraction`` of the windows (``cfg.refresh_fraction`` by default),
        windows that went unsampled longer being likelier.  Counted in
        ``stats['refresh_reps']`` and ``stats['refresh_comparisons']``
        (and in ``comparisons``).
        """
        if self.cfg.source_name == "allpairs":
            raise ValueError("the exact 'allpairs' source scores every "
                             "pair once: it has no sampling staleness to "
                             "refresh")
        if self._refresh_below <= 0:
            raise ValueError(
                "nothing to refresh: no extend() has run, so no old-old "
                "pair is masked out of the repetition stream yet")
        fraction = (self.cfg.refresh_fraction if fraction is None
                    else fraction)
        if not 0.0 < fraction:
            raise ValueError(f"refresh fraction must be positive: {fraction}")
        self._run_rounds(reps, new_from=0, refresh_below=self._refresh_below,
                         refresh_fraction=fraction, progress=progress)
        return self

    def _run_rounds(self, reps: int, new_from: int, *,
                    refresh_below: int = 0, refresh_fraction: float = 1.0,
                    progress: Progress = None) -> None:
        # embed before any round binds: after an extend() only its rows
        self._embed_rows += self._backend.ensure_measure_state()
        self._grow(self.n, self._reps_done + reps)
        refresh = refresh_below > 0
        for _ in range(reps):
            rep = self._reps_done
            probs = (self._next_refresh_probs(rep, refresh_fraction)
                     if refresh else None)
            self._state, counters = self._backend.run_round(
                self._state, rep, new_from, refresh_below=refresh_below,
                refresh_fraction=refresh_fraction, refresh_probs=probs)
            self._note_round(counters, refresh, progress)

    def _note_round(self, counters: Dict, refresh: bool,
                    progress: Progress) -> None:
        if refresh:
            counters = dict(counters)
            counters["refresh_comparisons"] = counters["comparisons"]
            self._refresh_reps += 1
        self._counters.append(counters)
        if len(self._counters) >= self.COUNTER_ROLLUP_EVERY:
            self._roll_up_counters()
        if progress is not None:
            progress(self._reps_done)
        self._reps_done += 1

    def _next_refresh_probs(self, rep_index: int,
                            fraction: float) -> np.ndarray:
        """Window keep probabilities of one refresh round, advancing the
        host age ledger past it.

        A window's probability scales with 1 + the rounds since it was
        last sampled, normalised so the expected sampled share stays
        ``fraction``.  The ledger replays the round's draw on the host
        (the same ``k_refresh`` uniform the device draws), so the ages
        follow exactly the windows the device sampled.
        """
        nw = _refresh_window_count(self.cfg, self.n)
        ages = self._refresh_age
        if ages is None:
            ages = np.zeros(nw, np.int64)
        elif ages.shape[0] < nw:           # extend() grew the grid
            ages = np.concatenate(
                [ages, np.zeros(nw - ages.shape[0], np.int64)])
        if fraction >= 1.0:
            probs = np.full(nw, fraction, np.float32)
        else:
            weight = 1.0 + ages.astype(np.float64)
            probs = (fraction * weight / weight.mean()).astype(np.float32)
        k_refresh = _rep_keys(self.cfg, rep_index)[3]
        draw = prng.uniform(k_refresh, (nw,), device="cpu").numpy()
        self._refresh_age = np.where(draw < probs, 0, ages + 1)
        return probs

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
        # session-absolute values: overwrite what a roll-up left
        totals["reps"] = self._reps_done
        totals["refresh_reps"] = self._refresh_reps
        totals.setdefault("refresh_comparisons", 0)
        if self._measure.expensive and not self._cache_on:
            # without the cache every comparison pays the model; mirrored,
            # not summed, so roll-ups cannot count it twice
            totals["expensive_comparisons"] = totals.get("comparisons", 0)
        if self._measure.state_width is not None:
            # rows this session embedded (a restored session re-embeds all)
            totals["embed_rows"] = self._embed_rows
        return totals

    def _roll_up_counters(self) -> Dict[str, int]:
        stats = self._merged_stats()
        self._counters = []
        self._stats_base = dict(stats)
        return stats

    # -- versioned slabs and the delta stream ------------------------- #
    def slab_state(self) -> acc_lib.EdgeAccumulator:
        """The live device-resident (n, k) slabs (no host transfer)."""
        return self._ensure_state()

    def cluster(self, method: str = "affinity", *, target_clusters: int = 1,
                max_rounds: int = 32, min_similarity: Optional[float] = None,
                return_info: bool = False):
        """Cluster the current slab graph on the device, with no edge fetch.

        ``"components"``: the connected components of the slabs'
        symmetric closure, each labelled by its smallest id (the host
        union-find's labels on the finalized graph).  ``"affinity"``:
        average-linkage Affinity (Boruvka rounds over the slabs' original
        weights), densified labels; stops at ``target_clusters`` live
        clusters, when no inter-cluster edge is left (at least
        ``min_similarity``, when given), or after ``max_rounds``.  Only
        the (n,) label vector crosses to the host, metered under
        ``transfer_stats['cluster_label_*']``.  Returns (n,) int64 numpy
        labels, or (labels, info) with ``return_info``.
        """
        from repro_torch.graph import cluster as cluster_lib
        state = self._ensure_state()
        if method == "components":
            labels, info = cluster_lib.connected_components_slabs(
                state.nbr, n=self.n, max_rounds=max_rounds)
        elif method == "affinity":
            labels, info = cluster_lib.affinity_slabs(
                state.nbr, state.w, n=self.n,
                target_clusters=target_clusters, max_rounds=max_rounds,
                min_similarity=min_similarity)
        else:
            raise ValueError(f"unknown clustering method {method!r}; "
                             f"known: 'components', 'affinity'")
        return (labels, info) if return_info else labels

    def row_versions(self) -> np.ndarray:
        """The (n,) int64 logical row versions (fetches only the int32
        version vector; not metered as a delta fetch)."""
        ver = self._ensure_state().ver.cpu().numpy()
        return self._ver_base + ver.astype(np.int64)

    @property
    def delta_seq(self) -> int:
        """How many deltas this session's delta stream has emitted."""
        return self._delta_seq

    def _ensure_shadow(self, n: int, k: int) -> None:
        """Create or grow the host ship shadow to (n, k).

        It starts empty with shipped version 0 (logical version 0 means
        empty since creation), so the first delta ships every row that
        ever changed; rows added later start at ``_ver_base``.
        """
        if self._shadow_nbr is None:
            self._shadow_nbr = np.full((n, k), -1, np.int32)
            self._shadow_w = np.full((n, k), -np.inf, np.float32)
            self._shipped_ver = np.zeros((n,), np.int64)
            return
        n0, k0 = self._shadow_nbr.shape
        if n > n0 or k > k0:
            nbr = np.full((n, k), -1, np.int32)
            w = np.full((n, k), -np.inf, np.float32)
            nbr[:n0, :k0] = self._shadow_nbr
            w[:n0, :k0] = self._shadow_w
            sv = np.full((n,), self._ver_base, np.int64)
            sv[:n0] = self._shipped_ver
            self._shadow_nbr, self._shadow_w, self._shipped_ver = nbr, w, sv

    def _emit_delta(self) -> SlabDelta:
        """One step of the delta stream: fetch the changed rows and diff.

        THE delta transfer: the (n,) int32 version vector, then only the
        rows whose logical version passed the ship shadow's, metered
        under ``transfer_stats['delta_*']``; the Z-set diff against the
        shadow gives the records, and the shadow moves past them.
        """
        state = self.slab_state()
        n, k = state.n, state.capacity
        logical = self._ver_base + state.ver.cpu().numpy().astype(np.int64)
        acc_lib.transfer_stats["delta_fetches"] += 1
        acc_lib.transfer_stats["delta_bytes"] += n * 4
        n_old = 0 if self._shadow_nbr is None else self._shadow_nbr.shape[0]
        k_old = 0 if self._shadow_nbr is None else self._shadow_nbr.shape[1]
        self._ensure_shadow(n, k)
        changed = np.flatnonzero(logical > self._shipped_ver[:n])
        if changed.size:
            idx = torch.from_numpy(changed).to(state.nbr.device)
            new_nbr = state.nbr[idx].cpu().numpy()
            new_w = state.w[idx].cpu().numpy()
            acc_lib.transfer_stats["delta_bytes"] += (new_nbr.nbytes
                                                      + new_w.nbytes)
        else:
            new_nbr = np.zeros((0, k), np.int32)
            new_w = np.zeros((0, k), np.float32)
        acc_lib.transfer_stats["delta_rows"] += int(changed.size)
        node, nbr_r, w_r, sign = diff_rows(
            changed.astype(np.int32), self._shadow_nbr[changed],
            self._shadow_w[changed], new_nbr, new_w)
        self._delta_seq += 1
        delta = SlabDelta(
            seq=self._delta_seq, n_old=n_old, n_new=n, k_old=k_old, k_new=k,
            rows=changed.astype(np.int32), row_ver=logical[changed].copy(),
            node=node, nbr=nbr_r, w=w_r, sign=sign)
        self._shadow_nbr[changed] = new_nbr
        self._shadow_w[changed] = new_w
        self._shipped_ver[changed] = logical[changed]
        self._delta_log.append(delta)
        return delta

    def _snapshot(self, **payload) -> BuilderCheckpoint:
        return BuilderCheckpoint(
            n=self.n, capacity=self._capacity, reps_done=self._reps_done,
            stats=self._roll_up_counters(), cfg=self.cfg,
            refresh_watermark=self._refresh_below,
            refresh_reps=self._refresh_reps,
            refresh_credit=self._refresh_credit,
            refresh_age=(None if self._refresh_age is None
                         else self._refresh_age.copy()),
            measure_fingerprint=self._measure.fingerprint(), **payload)

    def checkpoint(self, delta: bool = False) -> BuilderCheckpoint:
        """Snapshot the session to host arrays (resumable builds).

        Full (default): the (n, k) slab image and row versions; it also
        syncs the delta stream's ship shadow to that image, so delta
        checkpoints chain from it.  Delta (``delta=True``): the chain of
        :class:`SlabDelta` records since the last full checkpoint (one cut
        now for unshipped changes included), O(changed rows); it needs a
        prior full checkpoint of this session.
        """
        if delta:
            if self._last_full_seq is None:
                raise ValueError(
                    "checkpoint(delta=True) needs a prior full "
                    "checkpoint() in this session to chain from")
            self._emit_delta()             # capture unshipped changes
            return self._snapshot(
                nbr=None, w=None, ver=self._shipped_ver[:self.n].copy(),
                base_seq=self._last_full_seq,
                delta_chain=tuple(self._delta_log))
        nbr, w, ver_dev = acc_lib.to_host(self._ensure_state())
        logical = self._ver_base + ver_dev.astype(np.int64)
        k = nbr.shape[1]
        self._ensure_shadow(self.n, k)
        self._shadow_nbr[:self.n, :k] = nbr
        self._shadow_w[:self.n, :k] = w
        self._shipped_ver[:self.n] = logical
        self._delta_log = []
        self._last_full_seq = self._delta_seq
        return self._snapshot(nbr=nbr, w=w, ver=logical,
                              base_seq=self._delta_seq)

    @classmethod
    def restore(cls, features, cfg: StarsConfig, ckpt: BuilderCheckpoint, *,
                base: Optional[BuilderCheckpoint] = None,
                device: DeviceLike = None,
                learned_apply: Optional[Callable] = None,
                measure: Optional[Measure] = None) -> "GraphBuilder":
        """Resume a session from a checkpoint (same features and config),
        on ``device`` (CUDA unless ``"cpu"``).

        A delta checkpoint also needs ``base=``, the full checkpoint its
        chain starts from, and restores by replaying the chain onto that
        image.  The restored session's delta stream is re-anchored at the
        restored image.  The measure (``measure=`` / ``learned_apply=`` as
        for the constructor) must have the checkpoint's fingerprint: a
        session resumed under other tower parameters would mix differently
        scored edges.  A JAX package checkpoint goes through
        :func:`repro_torch.core.convert.checkpoint_from_reference` first.
        """
        if cfg != ckpt.cfg:
            raise ValueError(
                "checkpoint was built under a different StarsConfig: "
                "resuming would mix hash draws and slab sizing: "
                f"{ckpt.cfg} vs {cfg}")
        if ckpt.delta_chain is not None:
            if base is None:
                raise ValueError(
                    "delta checkpoint: pass base=<the full checkpoint its "
                    f"chain starts from> (base_seq {ckpt.base_seq})")
            if base.delta_chain is not None or base.nbr is None:
                raise ValueError("base= must be a FULL checkpoint")
            if base.cfg != cfg:
                raise ValueError("base checkpoint has a different "
                                 "StarsConfig")
            if base.base_seq != ckpt.base_seq:
                raise ValueError(
                    f"delta chain starts at stream seq {ckpt.base_seq}, "
                    f"but base checkpoint was cut at seq {base.base_seq}")
            nbr, w = replay_chain(base.nbr, base.w, ckpt.delta_chain)
            ver = ckpt.ver
        else:
            nbr, w, ver = ckpt.nbr, ckpt.w, ckpt.ver
        builder = cls(features, cfg, device=device,
                      learned_apply=learned_apply, measure=measure)
        fp_now = builder._measure.fingerprint()
        if ckpt.measure_fingerprint != fp_now:
            raise ValueError(
                "checkpoint was built under a different similarity "
                f"measure (fingerprint {ckpt.measure_fingerprint!r} vs "
                f"{fp_now!r}): resuming would mix differently scored "
                "edges into the same slabs")
        if builder.n != ckpt.n:
            raise ValueError(f"checkpoint holds {ckpt.n} points, features "
                             f"have {builder.n}")
        if ver is None:                    # a snapshot without versions
            ver = np.zeros((ckpt.n,), np.int64)
        ver = np.asarray(ver, np.int64)
        # int64 logical -> host base + device int32 offset
        vbase = int(ver.min()) if ckpt.n else 0
        builder._ver_base = vbase
        builder._capacity = ckpt.capacity
        builder._state = acc_lib.from_host(
            nbr, w, (ver - vbase).astype(np.int32), device=builder.device)
        builder._shadow_nbr = np.array(nbr, np.int32)
        builder._shadow_w = np.array(w, np.float32)
        builder._shipped_ver = ver.copy()
        builder._delta_seq = ckpt.base_seq + len(ckpt.delta_chain or ())
        builder._reps_done = ckpt.reps_done
        builder._stats_base = dict(ckpt.stats)
        builder._refresh_below = ckpt.refresh_watermark
        builder._refresh_reps = ckpt.refresh_reps
        builder._refresh_credit = ckpt.refresh_credit
        builder._refresh_age = (None if ckpt.refresh_age is None
                                else np.asarray(ckpt.refresh_age, np.int64))
        return builder

    def finalize(self, *, delta: bool = False):
        """Fetch edges off the device: the whole graph, or what changed.

        Default: the slabs cross to the host once
        (``accumulator.to_graph``) and compact into a :class:`Graph`; the
        session stays usable.  ``delta=True``: only the rows whose version
        advanced since the last ship, as a :class:`SlabDelta` that a
        consumer applies to its replica (``service.delta.apply_delta``);
        metered under ``transfer_stats['delta_*']``.
        """
        if delta:
            return self._emit_delta()
        return acc_lib.to_graph(self._ensure_state(),
                                stats=self._roll_up_counters())
