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
host.

``mesh=`` (a :class:`repro_torch.distributed.Mesh` over a
``torch.distributed`` group, one rank a process) runs the build over the
ranks (:class:`_MeshBackend`, :mod:`repro_torch.distributed`): dense
features, resident or paged, the four windowed sources, cosine or dot
(the prefilter on the resident store) or a state-complete learned
measure, which ships embeddings instead of features; extend, refresh,
checkpoints restored across rank counts, and both clusterings on the
row-sharded slabs.  Refused on a mesh (naming the argument): the pair
cache, the exact sweep, the set measures, a learned measure that needs
raw features or the prefilter, the paged store with the prefilter.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import lsh as lsh_lib
from repro_torch.core import windows as win_lib
from repro_torch.core.spanner import Graph
from repro_torch.core.stars import (TIEBREAK_BITS, StarsConfig, _emit,
                                    _prefilter_sketch, _rep_candidates,
                                    _rep_keys, _rep_seed, _rep_window_grid,
                                    _score_windows)
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.distributed import cluster_dist, comm
from repro_torch.distributed.sorter import (distributed_window_blocks,
                                            from_wire, pack_bit_fields,
                                            to_wire)
from repro_torch.distributed.stars_dist import (accumulate_all_to_all,
                                                fetch_rows_all_to_all)
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


class _Backend:
    """What a session asks of its backend, with the one-device answers:
    the (n, k) slabs on the store's device (outside a paged store's pool
    budget), rounds one at a time, the one-device clustering programs."""

    pairs_rounds = False        # run_round_pair shares one exchange a pair

    def init_state(self, capacity: int) -> acc_lib.EdgeAccumulator:
        return acc_lib.EdgeAccumulator.create(
            self.n, capacity, device=self.store.device)

    def grow_state(self, state, n: int, capacity: int):
        return acc_lib.grow(state, n, capacity)

    def trim(self, state: acc_lib.EdgeAccumulator) -> acc_lib.EdgeAccumulator:
        """The (n, k) slab image of ``state``."""
        return state

    def state_from_host(self, nbr, w, ver) -> acc_lib.EdgeAccumulator:
        return acc_lib.from_host(nbr, w, ver, device=self.store.device)

    def cluster_programs(self):
        """(components, affinity): the programs that cluster the slabs."""
        from repro_torch.graph import cluster as cluster_lib
        return (cluster_lib.connected_components_slabs,
                cluster_lib.affinity_slabs)


class _SingleDeviceBackend(_Backend):
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
                         rep_seed: int, lo: int = 0,
                         hi: Optional[int] = None) -> torch.Tensor:
    """One repetition's sketch words of table rows ``lo .. hi - 1`` (all
    rows by default), streamed through a paged store in row chunks of the
    pool's size (each padded to one shape with -1 sentinels, which read
    zero rows and are dropped).  Rows at or past ``store.n`` (a mesh
    rank's pad rows) read zero rows too.

    Equal to the one-shot sketch of the resident table: the SimHash
    product is a row's own (float64, so its sign does not depend on the
    chunk's shape).  Only one chunk of features is on the device at a
    time; the words are an O(n) summary outside the feature budget.
    """
    hi = store.n if hi is None else hi
    count = hi - lo
    chunk = max(store.page_rows, min(store.pool_pages * store.page_rows,
                                     count))
    parts = []
    for c0 in range(lo, max(hi, lo + 1), chunk):
        rows = store.gather(_padded_ids(c0, min(c0 + chunk, hi), chunk,
                                        store.n))
        parts.append(lsh_lib.sketch(rows, cfg.family, rep_seed=rep_seed))
    return torch.cat(parts)[:count]


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


def _pool_chunk_rows(store: PagedFeatureStore, cfg: StarsConfig, width: int,
                     nw: int) -> int:
    """Window rows a scoring chunk over a paged store: the most whose
    gathered (C x window, ``width``) block fits the pool's budget."""
    itemsize = torch.empty((), dtype=store.dtype).element_size()
    row_bytes = cfg.window * width * itemsize
    return int(max(1, min(nw, store.pool_bytes // max(row_bytes, 1))))


def _paged_chunks(cfg: StarsConfig, store: PagedFeatureStore,
                  measure: Measure, win: win_lib.Windows, rep_index: int,
                  c_rows: int, *, new_from: int, refresh_below: int,
                  refresh_fraction: float, refresh_probs,
                  feature_rows: bool = True, row0: int = 0, stride: int = 1,
                  total_rows: Optional[int] = None):
    """Score window rows ``win`` (global rows ``row0 + stride * [0, nw)``
    of a ``total_rows`` grid) through a paged store, ``c_rows`` rows a
    chunk; yields each chunk's ``_score_windows`` output.

    A chunk's gids cross to the host (one sync a chunk) to drive the
    store's gather of its member rows (``feature_rows``) and, for a
    stateful measure, of their state rows; the chunk goes through
    ``_score_windows``' row-subset mode with slot ids into the gathered
    block.  The last chunk is padded with empty rows (gid -1, not valid),
    which read zero rows and lie past the grid, so they never score.
    """
    _, _, k_lead, k_refresh = _rep_keys(cfg, rep_index)
    nw, w_sz = win.gid.shape
    dev = win.gid.device
    pad = (-nw) % c_rows

    def padded(t, fill):
        return torch.cat([t, t.new_full((pad, w_sz), fill)])

    gid = padded(win.gid, -1)
    valid = padded(win.valid, False)
    bucket = padded(win.bucket, win_lib.PAD_BUCKET)
    if refresh_below > 0 and refresh_probs is not None:
        refresh_probs = as_tensor(refresh_probs, device=dev,
                                  dtype=torch.float32)
    member_index = torch.arange(c_rows * w_sz, device=dev).reshape(
        c_rows, w_sz)
    stateful = measure.state_width is not None
    for c0 in range(0, nw, c_rows):
        gid_c = gid[c0:c0 + c_rows]
        gid_np = gid_c.cpu().numpy()
        feats = (PointFeatures(dense=store.gather(gid_np).dense.reshape(
            c_rows * w_sz, -1)) if feature_rows else None)
        mstate = (store.gather_state(gid_np).reshape(c_rows * w_sz, -1)
                  if stateful else None)
        yield _score_windows(
            cfg, feats, None,
            win_lib.Windows(gid=gid_c, valid=valid[c0:c0 + c_rows],
                            bucket=bucket[c0:c0 + c_rows]),
            k_lead, new_from=new_from, refresh_below=refresh_below,
            refresh_fraction=refresh_fraction, k_refresh=k_refresh,
            refresh_probs=refresh_probs, measure=measure, state=mstate,
            row_offset=row0 + stride * c0, total_rows=total_rows,
            stride=stride, member_index=member_index)


def _chunk_counters(outs) -> Dict:
    """The counters of a repetition's scoring chunks, joined: per-window
    tensors concatenated, counts summed."""
    counters = {}
    for key in _COUNTERS:
        vals = [o[key] for o in outs]
        counters[key] = (torch.cat([v.reshape(-1) for v in vals])
                         if isinstance(vals[0], torch.Tensor) else sum(vals))
    return counters


class _PagedBackend(_Backend):
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
        return _pool_chunk_rows(
            self.store, self.cfg,
            self.store.d + (self.measure.state_width or 0), nw)

    def run_round(self, state, rep_index: int, new_from: int,
                  refresh_below: int = 0, refresh_fraction: float = 1.0,
                  refresh_probs: Optional[np.ndarray] = None):
        if self.cfg.source_name == "allpairs":
            state, counters, _ = AllPairsSource(self.cfg, self.measure).bind(
                self.store, new_from, refresh_below)(state, rep_index)
            return state, counters
        cfg, store = self.cfg, self.store
        k_tie, k_shift, _, _ = _rep_keys(cfg, rep_index)
        words = _stream_sketch_words(store, cfg, _rep_seed(cfg, rep_index))
        win = _rep_window_grid(cfg, words, k_tie, k_shift)
        del words
        nw = win.gid.shape[0]
        per_chunk = []
        for out in _paged_chunks(
                cfg, store, self.measure, win, rep_index,
                self._chunk_rows(nw), new_from=new_from,
                refresh_below=refresh_below,
                refresh_fraction=refresh_fraction,
                refresh_probs=refresh_probs, total_rows=nw):
            self.host_syncs += 1
            state = acc_lib.accumulate(state, out["src"], out["dst"],
                                       out["w"], out["emit"])
            per_chunk.append({k: out[k] for k in _COUNTERS})
        return state, _chunk_counters(per_chunk)

    def extend(self, new_features: PointFeatures) -> None:
        self.store.append(new_features)


def _sketch_keys(cfg: StarsConfig, n: int, words: torch.Tensor,
                 rep_index: int, gid0: int):
    """A rank's sketch words -> bit-packed sort keys and gids.

    The key is the big-endian field stream (the LSH bucket id, or the M
    sketch words at ``lsh.word_bits`` each; the top ``TIEBREAK_BITS`` of
    the repetition's (n,) tiebreak draw, looked up by gid; a zero pad; the
    gid in ``n.bit_length()`` bits) packed into ``ceil(bits / 32)`` words
    (``sorter.pack_bit_fields``), so the packed keys sort as the
    single-device sort orders the points, the gid last.  The rows past
    ``n`` (the mesh's padding) are left out.
    """
    rows = words.shape[0]
    dev = words.device
    gids = gid0 + torch.arange(rows, dtype=torch.int64, device=dev)
    real = gids < n
    words, gids = words[real], gids[real]
    k_tie = _rep_keys(cfg, rep_index)[0]
    tie = prng.bits(k_tie, (n,), device=dev)[gids] >> (32 - TIEBREAK_BITS)
    if cfg.mode == "lsh":
        # word 0 is the 32-bit bucket id (distributed_window_blocks'
        # bucket_word=0)
        fields, widths = [lsh_lib.bucket_key(words, cfg.family)], [32]
    else:
        fields = list(words.unbind(1))
        widths = [lsh_lib.word_bits(cfg.family)] * len(fields)
    gid_bits = int(n).bit_length()
    pad = (-(sum(widths) + TIEBREAK_BITS + gid_bits)) % 32
    fields += [tie, torch.zeros_like(gids), gids]
    widths += [TIEBREAK_BITS, pad, gid_bits]
    return pack_bit_fields(fields, widths), gids.to(torch.int32)


class _MeshBackend(_Backend):
    """The build on a mesh of p ranks, one process each: features, slabs
    and scoring partitioned over the ranks.

    Row layout: the point count is padded to ``n_pad = ceil(n / p) * p``
    and rank r holds rows ``[r, r + 1) * n_pad / p`` of the feature table
    and of the slabs; row ``gid`` lives on rank ``gid // (n_pad / p)``.
    Every rank is handed the same full features (or, on ``restore``, the
    host slab image) and copies only its block to its device.  An
    ``extend`` re-pads and reshards: the old rows move to their new
    owners in one all-to-all (``comm.reshard_rows``), each rank copies
    its share of the new rows, and the slabs follow in ``grow_state``.
    ``trim`` gathers the real rows of the slabs to every rank:
    ``finalize`` and ``checkpoint`` see the (n, k) image, so a checkpoint
    restores onto any p or one device.

    A repetition (``stars_dist`` has the data path): each rank sketches
    its block into bit-packed keys (:func:`_sketch_keys`); the sample
    sort hands it its striped window rows
    (``sorter.distributed_window_blocks``, after the sorting-mode shift
    is drawn); it fetches those rows' features (and prefilter words,
    bitcast beside them) from their owners
    (``stars_dist.fetch_rows_all_to_all``), scores its rows with
    ``stars._score_windows`` in its row-subset mode (``row_offset=rank,
    stride=p``: leader and refresh draws keyed by global row), and the
    emit routes every insertion triple to its row's owner
    (``stars_dist.accumulate_all_to_all``).  Two repetitions share one
    fetch and one emit (:meth:`run_round_pair`).  The counters are summed
    over the ranks with one all-reduce a round (or pair), so ``stats``
    are the global totals on every rank; ``rank_scored_windows`` keeps
    this rank's scored window rows.

    ``cfg.feature_store='paged'``: every rank keeps a
    :class:`PagedFeatureStore` over the whole host table (its own pinned
    copy) and no device feature table.  It sketches its row block
    streamed through its store (:func:`_stream_sketch_words`), and its
    store serves the member rows of its window slots, a chunk of window
    rows at a time (:func:`_paged_chunks`, the single-device paged walk):
    no fetch exchange, page traffic under ``feature_page_*``.  The
    chunks' candidate streams go out in one emit a repetition, and
    rounds are not paired (there is no fetch to share), so row versions
    move once a repetition.

    A learned measure (state-complete: its tiles need the tower
    embeddings only) ships E-float embeddings instead of d-float
    features, the embedding wire diet.  Resident: each rank embeds its
    own rows (``measure.precompute``) into its (n_pad / p, E) state
    block, which is the fetch table; an ``extend`` moves the old state
    rows to their new owners and embeds only the new rows (old rows are
    never re-embedded).  Paged: each rank stream-embeds its rows through
    its store, one all-gather (metered as ``state_gather_*``) lands the
    whole (n, E) table in every rank's host store, and the scoring
    chunks page state rows in under ``embed_page_*``.
    """

    pairs_rounds = True

    def __init__(self, features, cfg: StarsConfig, mesh, measure: Measure):
        windowed = ("lsh-stars", "sorting-stars",
                    "lsh-allpairs", "sorting-allpairs")
        if cfg.source_name not in windowed:
            raise NotImplementedError(
                f"the mesh backend runs the windowed repetition sources "
                f"{windowed}, got {cfg.source_name!r}")
        if cfg.measure not in ("cosine", "dot", "learned"):
            raise NotImplementedError(
                f"StarsConfig.measure={cfg.measure!r} on a mesh: the mesh "
                "scores cosine, dot or a state-complete learned measure")
        if cfg.measure == "learned":
            if not measure.state_complete:
                raise NotImplementedError(
                    "measure='learned' on a mesh ships tower embeddings "
                    "instead of feature rows, so the measure must be "
                    "state-complete (a LearnedMeasure with "
                    "TwoTowerConfig.pair_features 'embed' or 'none'); "
                    "pair_features='raw' or a learned_apply= closure needs "
                    "the raw feature rows at every tile")
            if cfg.hamming_prefilter_bits > 0:
                raise NotImplementedError(
                    "measure='learned' on a mesh does not combine with "
                    "hamming_prefilter_bits > 0: the prefilter words ride "
                    "the feature fetch that the embedding fetch replaces")
        self.cfg = cfg
        self.mesh = mesh
        self.p = mesh.size
        self.measure = measure
        dense = _dense_source(features)
        if dense is None:
            raise ValueError(
                "the mesh backend needs dense features: the features= "
                "argument carries no dense block")
        self._n = int(dense.shape[0])
        self._paged = cfg.feature_store == "paged"
        # a paged mesh's fetch is no exchange: nothing for a pair to share
        self.pairs_rounds = not self._paged
        if self._paged:
            self.store = as_feature_store(dense, cfg, self.device)
        else:
            self._place_features(self._block(dense, self._n))
        self._slab_n = self._n          # the n the slab layout was made for
        self.rank_scored_windows = 0
        self.host_syncs = 0             # paged: chunk gids copied to host
        self._tables: Dict = {}         # n -> the fetch table block
        self._state_tab: Optional[torch.Tensor] = None   # resident learned
        self._embedded = 0              # rows whose measure state is current

    @property
    def n(self) -> int:
        return self._n

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def stateful(self) -> bool:
        return self.measure.state_width is not None

    def _rows(self, n: int) -> int:
        """Rows a rank of the padded layout for ``n`` points."""
        return comm.layout_rows(n, self.p)

    def _block(self, rows: torch.Tensor, n: int, fill=0, *, base: int = 0,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """This rank's row block of the padded layout for ``n`` points, in
        storage of its own on the mesh's device.  Table rows ``[base, base
        + len(rows))`` come from ``rows`` (host or device; only this
        rank's share is copied), the others are ``fill`` or, with ``out``,
        kept from it.  Floating rows are taken as float32."""
        size = self._rows(n)
        lo = self.mesh.rank * size
        if out is None:
            dtype = torch.float32 if rows.is_floating_point() else rows.dtype
            out = torch.full((size,) + tuple(rows.shape[1:]), fill,
                             dtype=dtype, device=self.device)
        a, b = max(lo, base), min(lo + size, n, base + rows.shape[0])
        if b > a:
            out[a - lo:b - lo] = rows[a - base:b - base].to(self.device)
        return out

    def _place_features(self, block: torch.Tensor) -> None:
        self.store = ResidentFeatureStore(PointFeatures(dense=block))

    # -- slab state ----------------------------------------------------- #
    def init_state(self, capacity: int) -> acc_lib.EdgeAccumulator:
        self._slab_n = self._n
        return acc_lib.EdgeAccumulator.create(self._rows(self._n), capacity,
                                              device=self.device)

    def state_from_host(self, nbr, w, ver) -> acc_lib.EdgeAccumulator:
        """This rank's block of an (n, k) host slab image (only its rows
        reach the device)."""
        host = lambda a, dt: as_tensor(np.asarray(a), device="cpu", dtype=dt)
        n = self._slab_n = int(np.shape(nbr)[0])
        return acc_lib.EdgeAccumulator(
            nbr=self._block(host(nbr, torch.int32), n, -1),
            w=self._block(host(w, torch.float32), n, float("-inf")),
            ver=self._block(host(ver, torch.int32), n))

    def grow_state(self, state, n: int, capacity: int):
        """Regrow the slabs for ``n`` points and ``capacity`` columns: when
        the layout moves, the rows go to their new owners
        (``comm.reshard_rows``); new slots start empty."""
        n_old, self._slab_n = self._slab_n, n
        if n != n_old:
            move = lambda t, fill: comm.reshard_rows(self.mesh, t, n_old, n,
                                                     fill)
            state = acc_lib.EdgeAccumulator(
                nbr=move(state.nbr, -1), w=move(state.w, float("-inf")),
                ver=move(state.ver, 0))
        return acc_lib.grow(state, state.n, capacity)

    def trim(self, state: acc_lib.EdgeAccumulator) -> acc_lib.EdgeAccumulator:
        """The real rows of the slabs, gathered to every rank."""
        n = self._slab_n
        return acc_lib.EdgeAccumulator(
            nbr=comm.all_gather_rows(self.mesh, state.nbr)[:n],
            w=comm.all_gather_rows(self.mesh, state.w)[:n],
            ver=comm.all_gather_rows(self.mesh, state.ver)[:n])

    def cluster_programs(self):
        return (functools.partial(cluster_dist.connected_components_mesh,
                                  mesh=self.mesh),
                functools.partial(cluster_dist.affinity_mesh, mesh=self.mesh))

    # -- measure state (the learned measure's embeddings) --------------- #
    def ensure_measure_state(self) -> int:
        """Embed the rows not yet embedded (all of them first, then an
        extend's tail), each rank its own: into its state block
        (resident), or streamed through its store and all-gathered into
        every rank's host store (paged).  Returns how many rows the mesh
        embedded (0 for a stateless measure)."""
        if not self.stateful:
            return 0
        n, done = self._n, self._embedded
        if n <= done:
            return 0
        size = self._rows(n)
        lo = self.mesh.rank * size
        a = max(lo, done)
        b = max(a, min(lo + size, n))       # this rank's new rows [a, b)
        if self._paged:
            self._gather_state_rows(done, a, b)
        else:
            rows = self.measure.precompute(PointFeatures(
                dense=self.store.features.dense[a - lo:b - lo]))
            if self._state_tab is None:
                self._state_tab = rows.new_zeros((size, rows.shape[1]))
            self._state_tab[a - lo:b - lo] = rows
        self._embedded = n
        return n - done

    def _gather_state_rows(self, done: int, a: int, b: int) -> None:
        """Paged: stream-embed this rank's new rows ``[a, b)``, gather
        every rank's (one all-gather of equal blocks, metered as
        ``state_gather_*``) and land rows ``[done, n)`` in the host
        store."""
        n, size = self._n, self._rows(self._n)
        width = self.measure.state_width
        new = [max(0, min((q + 1) * size, n) - max(q * size, done))
               for q in range(self.p)]
        rows = (_stream_embed_rows(self.store, self.measure, a, b) if b > a
                else torch.zeros((0, width)))
        block = torch.zeros((max(new), width), dtype=rows.dtype,
                            device=self.device)
        block[:b - a] = rows.to(self.device)
        parts = comm.all_gather(self.mesh, block, kind="state_gather")
        table = torch.cat([t[:m] for t, m in zip(parts, new)]).cpu()
        if done == 0:
            self.store.attach_state(table)
        else:
            self.store.append_state(table)

    # -- one repetition ------------------------------------------------- #
    def _fetch_table(self) -> torch.Tensor:
        """This rank's block of the table the fetch serves: a learned
        measure's embeddings (the wire diet), or the features with the
        packed prefilter words beside them as float32 bit patterns when
        the prefilter is armed (one exchange for both)."""
        if self.stateful:
            return self._state_tab
        if self._n not in self._tables:
            dense = self.store.features.dense
            table = dense
            if self.cfg.hamming_prefilter_bits > 0:
                pref = _prefilter_sketch(PointFeatures(dense=dense),
                                         self.cfg.hamming_prefilter_bits,
                                         self.cfg.seed)
                table = torch.cat([dense, to_wire(pref).view(torch.float32)],
                                  dim=1)
            self._tables = {self._n: table}
        return self._tables[self._n]

    def _sort_round(self, rep_index: int):
        """Sketch and sample-sort one repetition -> this rank's slots."""
        cfg, n = self.cfg, self._n
        gid0 = self.mesh.rank * self._rows(n)
        seed = _rep_seed(cfg, rep_index)
        if self._paged:
            words = _stream_sketch_words(self.store, cfg, seed, gid0,
                                         gid0 + self._rows(n))
        else:
            words = lsh_lib.sketch(self.store.features, cfg.family,
                                   rep_seed=seed)
        keys, gids = _sketch_keys(cfg, n, words, rep_index, gid0)
        k_shift = _rep_keys(cfg, rep_index)[1]
        offset, _ = win_lib.window_layout(cfg.mode, n, cfg.window, k_shift)
        _, _, total_slots = win_lib.shard_row_layout(cfg.mode, n, cfg.window,
                                                     self.p)
        gid, bucket, _ = distributed_window_blocks(
            keys, gids, self.mesh, slot_offset=offset,
            total_slots=total_slots,
            bucket_word=0 if cfg.mode == "lsh" else None,
            payload_bits=int(n).bit_length(), window=cfg.window)
        return gid, bucket

    def _windows(self, gid, bucket) -> win_lib.Windows:
        """This rank's (rows_per_rank, W) window rows from its slots."""
        w = self.cfg.window
        gid = gid.reshape(-1, w)
        return win_lib.Windows(gid=gid, valid=gid >= 0,
                               bucket=bucket.reshape(-1, w))

    def _score(self, rep_index: int, gid, bucket, rows, new_from: int,
               refresh_below: int, refresh_fraction: float, probs):
        """Score this rank's striped window rows from the fetched rows
        (a learned measure's fetched rows are its state rows)."""
        cfg = self.cfg
        nw, _, _ = win_lib.shard_row_layout(cfg.mode, self._n, cfg.window,
                                            self.p)
        win = self._windows(gid, bucket)
        if self.stateful:
            feats, mstate, pref = None, rows, None
        else:
            d = self.store.features.dense.shape[1]
            feats, mstate = PointFeatures(dense=rows[:, :d]), None
            pref = (from_wire(rows[:, d:].view(torch.int32))
                    if cfg.hamming_prefilter_bits > 0 else None)
        _, _, k_lead, k_refresh = _rep_keys(cfg, rep_index)
        out = _score_windows(
            cfg, feats, pref, win, k_lead,
            new_from=new_from, refresh_below=refresh_below,
            refresh_fraction=refresh_fraction, k_refresh=k_refresh,
            refresh_probs=probs, measure=self.measure, state=mstate,
            row_offset=self.mesh.rank, total_rows=nw, stride=self.p,
            member_index=torch.arange(win.gid.numel(), device=self.device)
            .reshape(win.gid.shape))
        self.rank_scored_windows += out["scored_windows"]
        return out

    def _chunk_rows(self, rows: int) -> int:
        """Paged: window rows a scoring chunk, the most whose member block
        (features, or a learned measure's state rows) fits the pool."""
        width = self.measure.state_width if self.stateful else self.store.d
        return _pool_chunk_rows(self.store, self.cfg, width, rows)

    def _score_paged(self, rep_index: int, gid, bucket, new_from: int,
                     refresh_below: int, refresh_fraction: float, probs):
        """Paged: score this rank's window rows in pool-sized chunks
        served by its store (:func:`_paged_chunks`); returns the chunks'
        candidate streams and counters."""
        cfg = self.cfg
        nw, _, _ = win_lib.shard_row_layout(cfg.mode, self._n, cfg.window,
                                            self.p)
        win = self._windows(gid, bucket)
        outs = []
        for out in _paged_chunks(
                cfg, self.store, self.measure, win, rep_index,
                self._chunk_rows(win.gid.shape[0]), new_from=new_from,
                refresh_below=refresh_below,
                refresh_fraction=refresh_fraction, refresh_probs=probs,
                feature_rows=not self.stateful, row0=self.mesh.rank,
                stride=self.p, total_rows=nw):
            self.host_syncs += 1
            outs.append({k: out[k] for k in ("src", "dst", "w", "emit")
                         + _COUNTERS})
        self.rank_scored_windows += sum(o["scored_windows"] for o in outs)
        return outs

    def _counters(self, outs) -> List[Dict]:
        """Each round's counters summed over the ranks (one all-reduce)."""
        keys = ("comparisons", "emitted", "prefilter_ops")
        local = torch.tensor(
            [[int(o["scored_windows"])] for o in outs], dtype=torch.int64,
            device=self.device)
        sums = torch.stack([torch.stack([o[k].sum(dtype=torch.int64)
                                         for k in keys]) for o in outs])
        total = comm.all_reduce_sum(self.mesh, torch.cat([sums, local], 1))
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        return [dict(zip(keys + ("scored_windows",), row.unbind()),
                     dropped=zero) for row in total]

    def run_round(self, state, rep_index: int, new_from: int,
                  refresh_below: int = 0, refresh_fraction: float = 1.0,
                  refresh_probs: Optional[np.ndarray] = None):
        gid, bucket = self._sort_round(rep_index)
        if self._paged:
            outs = self._score_paged(rep_index, gid, bucket, new_from,
                                     refresh_below, refresh_fraction,
                                     refresh_probs)
            # the chunks' streams go out in one emit exchange
            streams = [[o[k] for o in outs] for k in ("src", "dst", "w",
                                                      "emit")]
            out = _chunk_counters(outs)
        else:
            rows, _, _ = fetch_rows_all_to_all(self._fetch_table(), gid,
                                               mesh=self.mesh)
            out = self._score(rep_index, gid, bucket, rows, new_from,
                              refresh_below, refresh_fraction, refresh_probs)
            streams = [out[k] for k in ("src", "dst", "w", "emit")]
        state, _ = accumulate_all_to_all(
            state, *streams, mesh=self.mesh,
            exact_weights=self.cfg.exact_weights)
        return state, self._counters([out])[0]

    def run_round_pair(self, state, rep_index: int, new_from: int,
                       refresh_below: int = 0, refresh_fraction: float = 1.0,
                       refresh_probs=(None, None)):
        """Two consecutive repetitions sharing one fetch and one emit
        exchange (5 payload all-to-alls instead of 8).  The fold of both
        streams at once equals two folds in turn (a row's top k of the
        union), so pairing changes no edge; a row's version moves once."""
        reps = (rep_index, rep_index + 1)
        sorted_ = [self._sort_round(r) for r in reps]
        rows, _, _ = fetch_rows_all_to_all(
            self._fetch_table(), tuple(g for g, _ in sorted_),
            mesh=self.mesh)
        outs = [self._score(r, g, b, x, new_from, refresh_below,
                            refresh_fraction, probs)
                for r, (g, b), x, probs in zip(reps, sorted_, rows,
                                               refresh_probs)]
        state, _ = accumulate_all_to_all(
            state, *([o[k] for o in outs] for k in ("src", "dst", "w",
                                                    "emit")),
            mesh=self.mesh, exact_weights=self.cfg.exact_weights)
        counters_a, counters_b = self._counters(outs)
        return state, counters_a, counters_b

    def extend(self, new_features: PointFeatures) -> None:
        """Pad and reshard: the old rows (features, and a resident learned
        measure's state rows) go to their owners in the layout for the
        new n (``comm.reshard_rows``), and this rank copies its share of
        the new rows.  Paged: every rank appends them to its store."""
        n_old = self._n
        if self._paged:
            self.store.append(new_features)
            self._n = self.store.n
            return
        new = _dense_source(new_features)
        self._n += int(new.shape[0])
        block = comm.reshard_rows(self.mesh, self.store.features.dense,
                                  n_old, self._n, 0)
        self._place_features(self._block(new, self._n, base=n_old,
                                         out=block))
        if self._state_tab is not None:
            self._state_tab = comm.reshard_rows(self.mesh, self._state_tab,
                                                n_old, self._n, 0)


def _check_mesh_args(features, cfg: StarsConfig, mesh,
                     device: DeviceLike) -> None:
    """Refuse what the port's mesh does not run, naming the argument."""
    want = None if device is None else torch.device(device)
    if want is not None and (want.type != mesh.device.type or want.index
                             not in (None, mesh.device.index)):
        raise ValueError(
            f"device={device!r} with mesh=: the session runs on the mesh's "
            f"device {mesh.device}")
    if isinstance(features, FeatureStore):
        raise NotImplementedError(
            "mesh= takes the raw dense features (every rank the same full "
            "table), not a FeatureStore: StarsConfig.feature_store picks "
            "each rank's store")
    if cfg.feature_store not in ("resident", "paged"):
        raise ValueError(f"unknown feature store {cfg.feature_store!r}; "
                         "supported: 'resident', 'paged'")
    if cfg.feature_store == "paged" and cfg.hamming_prefilter_bits > 0:
        raise NotImplementedError(
            "feature_store='paged' on a mesh does not support the Hamming "
            "prefilter (hamming_prefilter_bits > 0: its packed words would "
            "need their own paging); unset it or use feature_store="
            "'resident'")
    if isinstance(features, PointFeatures) and features.dense is None:
        raise ValueError(
            "mesh= needs dense features: the features= argument carries no "
            "dense block")
    if cfg.pair_cache_slots > 0:
        raise NotImplementedError(
            "the pair-score cache is device-resident single-device state; "
            "it does not combine with mesh= (set pair_cache_slots=0)")


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


def _dense_source(features) -> Optional[torch.Tensor]:
    """The dense block of ``features`` (a PointFeatures, an array or a
    tensor) as a tensor where it lies: a host array is wrapped, not
    moved; None without one."""
    dense = (features.dense if isinstance(features, PointFeatures)
             else features)
    if dense is None or isinstance(dense, torch.Tensor):
        return dense
    return as_tensor(dense, device=torch.device("cpu"))


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
      mesh:     a :class:`repro_torch.distributed.Mesh`: the build runs
                over its ranks, one process each, every rank calling with
                the same full features and keeping its row block
                (:class:`_MeshBackend`); the session runs on the mesh's
                device.  Dense features, resident or paged
                (``cfg.feature_store``: each rank a host store of the
                whole table), the four windowed sources, cosine or dot
                (with the prefilter on the resident store), or a
                state-complete learned measure (``measure=``).
    """

    # Per-round counters stay on the device and are summed to host ints
    # every few rounds, so rounds are not held up by a sync each.
    COUNTER_ROLLUP_EVERY = 8

    def __init__(self, features, cfg: StarsConfig, *,
                 device: DeviceLike = None,
                 learned_apply: Optional[Callable] = None,
                 measure: Optional[Measure] = None, mesh=None):
        if measure is not None and learned_apply is not None:
            raise ValueError(
                "pass either measure= or the legacy learned_apply=, not "
                "both (they would name two different scoring functions)")
        if mesh is not None:
            _check_mesh_args(features, cfg, mesh, device)
            device = mesh.device
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
        self._embed_rows = 0
        if mesh is not None:
            self._backend = _MeshBackend(features, cfg, mesh, self._measure)
        else:
            self._backend = self._single_device_backend(features)
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

    def _single_device_backend(self, features):
        """The resident or paged backend over the store ``cfg`` names."""
        cfg = self.cfg
        store = as_feature_store(features, cfg, self.device)
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
        if paged:
            return _PagedBackend(store, cfg, self._measure)
        return _SingleDeviceBackend(store, cfg, self._measure)

    @property
    def n(self) -> int:
        """Number of points in the session."""
        return self._backend.n

    @property
    def feature_store(self) -> FeatureStore:
        """The session's FeatureStore (resident or paged; on a mesh, this
        rank's row block, or its paged store of the whole table)."""
        return self._backend.store

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
        table = self._backend.store.checkpoint_view()
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
        done = 0
        while done < reps:
            rep = self._reps_done
            # a pair's probabilities in turn: the second sees the age
            # ledger after the first, as two single rounds would
            pair = self._backend.pairs_rounds and reps - done >= 2
            probs = [self._next_refresh_probs(rep + i, refresh_fraction)
                     if refresh else None for i in range(1 + pair)]
            kw = dict(refresh_below=refresh_below,
                      refresh_fraction=refresh_fraction)
            if pair:
                self._state, *counters = self._backend.run_round_pair(
                    self._state, rep, new_from, refresh_probs=probs, **kw)
            else:
                self._state, counters = self._backend.run_round(
                    self._state, rep, new_from, refresh_probs=probs[0], **kw)
                counters = [counters]
            for c in counters:
                self._note_round(c, refresh, progress)
            done += len(counters)

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
        """The live device-resident (n, k) slabs (no host transfer; on a
        mesh, the real rows gathered to every rank)."""
        return self._backend.trim(self._ensure_state())

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
        state = self._ensure_state()
        components, affinity = self._backend.cluster_programs()
        if method == "components":
            labels, info = components(state.nbr, n=self.n,
                                      max_rounds=max_rounds)
        elif method == "affinity":
            labels, info = affinity(state.nbr, state.w, n=self.n,
                                    target_clusters=target_clusters,
                                    max_rounds=max_rounds,
                                    min_similarity=min_similarity)
        else:
            raise ValueError(f"unknown clustering method {method!r}; "
                             f"known: 'components', 'affinity'")
        return (labels, info) if return_info else labels

    def row_versions(self) -> np.ndarray:
        """The (n,) int64 logical row versions (fetches only the int32
        version vector; not metered as a delta fetch)."""
        ver = self.slab_state().ver.cpu().numpy()
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
        nbr, w, ver_dev = acc_lib.to_host(self.slab_state())
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
                measure: Optional[Measure] = None,
                mesh=None) -> "GraphBuilder":
        """Resume a session from a checkpoint (same features and config),
        on ``device`` (CUDA unless ``"cpu"``) or on ``mesh`` (any rank
        count: the checkpoint holds the (n, k) image).

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
                      learned_apply=learned_apply, measure=measure,
                      mesh=mesh)
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
        builder._state = builder._backend.state_from_host(
            nbr, w, (ver - vbase).astype(np.int32))
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
        return acc_lib.to_graph(self.slab_state(),
                                stats=self._roll_up_counters())
