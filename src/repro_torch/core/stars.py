"""The Stars per-repetition program (``repro.core.stars``).

Each repetition r of R:
  1. sketch the points with a fresh draw of the hash family (core/lsh.py),
  2. sort + window them (core/windows.py) with a random tiebreak: LSH
     buckets capped at W (Stars 1, ``mode='lsh'``) or SortingLSH blocks
     with a random window shift (Stars 2, ``mode='sorting'``),
  3. compare every member with its bucket's first member (LSH-Stars), or
     with ``s`` random leaders per window (SortingLSH Stars), or take all
     pairs (non-Stars),
  4. score the pairs and build the emit mask, and hand the masked
     candidate stream to the accumulator.

Scoring goes through a :class:`repro_torch.similarity.measure.Measure`.
cosine / dot run on hand-written kernels (their plain versions on the
CPU): ``window_score`` scores and masks whole windows in one call;
``leader_score`` scores the gathered tiles of LSH-Stars and of the Hamming
prefilter path, whose packed sketch comes from ``simhash_packed``.  The
other measures (Jaccard, mixture, angular, learned) score in PyTorch, as
the JAX package scores them outside its kernels.

Every draw comes from the same threefry keys as the JAX package
(:mod:`repro_torch.prng`), so the windows, leaders, masks and comparison
counts are identical to a JAX build of the same config.

Batching: the JAX package scores the LSH-Stars and chunked paths in
``lax.map`` chunks of ``score_chunk * 8`` and ``score_chunk`` windows.
The port builds the masks over a whole repetition and scores cosine / dot
in one kernel call; the other measures score in chunks sized by the
device's cap on a scoring block (``measures.max_block_elems``; the
config's ``score_chunk`` is kept so that configs convert field for field),
each of one shape (the tail padded), which bounds their memory and keeps
a pair's score independent of its chunk.  Every window's stream entries
and masks are those of the chunked program, and its per-window counters
sum to the same totals.

Extension rounds (``new_from`` > 0) score only pairs with a point at or
past ``new_from``; refresh rounds (``refresh_below`` > 0) only pairs of
points below it, in a sampled set of windows (``GraphBuilder.extend`` /
``refresh_reps``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import prng
from repro_torch.core import lsh as lsh_lib
from repro_torch.core import windows as win_lib
from repro_torch.device import as_tensor
from repro_torch.graph import accumulator as acc_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.similarity.measure import Measure, make_measure
from repro_torch.similarity.measures import PointFeatures, max_block_elems
from repro_torch.similarity.store import masked_take

# Random sort-tiebreak resolution, in bits (the JAX package's value: both
# sort keys must be identical for edge-for-edge parity).
TIEBREAK_BITS = 20


@dataclasses.dataclass(frozen=True)
class StarsConfig:
    """Configuration for one graph build.

    The same fields and defaults as ``repro.core.stars.StarsConfig``, so
    one can be built from the other's fields; see that class for what
    each field means.  ``score_chunk`` is carried but not read: the port
    sizes its scoring chunks by the device (:func:`score_chunk_rows`).
    """

    mode: str = "sorting"
    scoring: str = "stars"
    family: lsh_lib.HashFamilyConfig = lsh_lib.HashFamilyConfig()
    measure: str = "cosine"
    r: int = 25
    window: int = 250
    leaders: int = 25
    r1: Optional[float] = None
    degree_cap: Optional[int] = 250
    hamming_prefilter_bits: int = 0
    hamming_prefilter_max: int = 0
    mixture_alpha: float = 0.5
    score_chunk: int = 8
    seed: int = 0
    source: Optional[str] = None
    allpairs_block: int = 2048
    refresh_fraction: float = 0.25
    refresh_rate: float = 0.0
    exact_weights: bool = True
    feature_store: str = "resident"
    feature_page_rows: int = 512
    feature_pool_bytes: int = 64 << 20
    pair_cache_slots: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= self.mixture_alpha <= 1.0:
            raise ValueError(
                f"StarsConfig.mixture_alpha={self.mixture_alpha!r}: the "
                "mixture weight must lie in [0, 1]")
        if self.pair_cache_slots < 0:
            raise ValueError(
                f"StarsConfig.pair_cache_slots={self.pair_cache_slots!r}: "
                "must be >= 0 (0 disables the pair-score cache)")

    @property
    def source_name(self) -> str:
        """Candidate-source name: '<mode>-<scoring>' unless ``source``."""
        return self.source if self.source is not None \
            else f"{self.mode}-{self.scoring}"

    def slab_capacity(self, n: int, *, reps: Optional[int] = None) -> int:
        """Per-node accumulator capacity for an n-point build."""
        if self.source_name == "allpairs":
            return acc_lib.capacity_for(self.degree_cap, n)
        return acc_lib.capacity_for(self.degree_cap, n,
                                    reps=self.r if reps is None else reps,
                                    per_rep_bound=self.window + self.leaders)


def _scored_rows(nw: int, row_offset: int, total_rows: Optional[int],
                 stride: int = 1) -> int:
    """How many real global window rows this scoring call owns (the whole
    grid on one device)."""
    if total_rows is None:
        return nw
    return max(0, min(nw, (total_rows - row_offset + stride - 1) // stride))


def _refresh_window_sample(k_refresh: prng.Key, nw: int, fraction: float,
                           probs=None, *, device: torch.device,
                           row_offset: int = 0,
                           total_rows: Optional[int] = None,
                           stride: int = 1) -> torch.Tensor:
    """(nw,) bool: the windows one refresh round rescores.

    A uniform draw from the repetition's ``k_refresh`` key, one per window
    row, kept where it falls below ``fraction`` or, when given, below the
    row's keep probability in ``probs`` (the host's float32 age-weighted
    vector a global window row, ``GraphBuilder._next_refresh_probs``).  A
    probability of 1.0 or more keeps every window.  The draw is issued at
    the global row count and row-gathered (``windows.global_row_draw``),
    so a call that scores rows ``row_offset + stride * [0, nw)`` of a
    ``total_rows`` grid samples the windows the whole-grid call would;
    rows past the grid read draw 2.0 and probability -1.0, never kept.
    """
    draw = win_lib.global_row_draw(
        lambda rows: prng.uniform(k_refresh, (rows,), device=device), nw,
        row_offset, total_rows, fill=2.0, stride=stride)
    if probs is None:
        return draw < torch.tensor(fraction, dtype=torch.float32,
                                   device=device)
    probs = as_tensor(probs, device=device, dtype=torch.float32)
    return draw < win_lib.global_row_draw(
        lambda rows: probs[:rows], nw, row_offset, total_rows, fill=-1.0,
        stride=stride)


def _rep_seed(cfg: StarsConfig, rep_index: int) -> int:
    """The sketch's per-repetition seed, as the JAX package folds it."""
    return (rep_index & 0xFFFFFFFF) ^ (cfg.seed & 0xFFFFFFFF)


def _rep_keys(cfg: StarsConfig, rep_index: int):
    """The per-repetition PRNG keys (k_tie, k_shift, k_lead, k_refresh)."""
    k = prng.fold_in(prng.key(cfg.seed), rep_index)
    k_tie, k_shift, k_lead = prng.split(k, 3)
    return k_tie, k_shift, k_lead, prng.fold_in(k, 0x5EF5)


def _prefilter_sketch(features: PointFeatures, bits: int,
                      seed: int) -> torch.Tensor:
    """Packed SimHash words shared by all repetitions (prefilter only).

    The JAX package's draw: ``normal(fold_in(key(seed), 0xBEEF), (d,
    bits))``.  Returns (n, ceil(bits/32)) uint32 words carried in int64,
    as :func:`lsh.hamming_pairwise` takes them.
    """
    dense = features.dense
    proj = prng.normal(prng.fold_in(prng.key(seed), 0xBEEF),
                       (dense.shape[-1], bits), device=dense.device)
    words = kernel_ops.simhash_packed(dense.contiguous(), proj)
    return words.to(torch.int64) & 0xFFFFFFFF


def _resolve_measure(cfg: StarsConfig, measure: Optional[Measure]) -> Measure:
    return (measure if measure is not None
            else make_measure(cfg.measure, alpha=cfg.mixture_alpha))


def _kernel_scored(measure: Measure,
                   features: Optional[PointFeatures]) -> bool:
    """cosine / dot on dense features score through the hand-written
    kernels, as the JAX package routes them to its Pallas kernels."""
    return (measure.name in ("cosine", "dot") and features is not None
            and features.dense is not None)


def _gather(features: Optional[PointFeatures],
            state: Optional[torch.Tensor], gid: torch.Tensor):
    """The rows (``masked_take``) and measure-state rows of an id grid,
    under the same -1 clamp."""
    rows = None if features is None else masked_take(features, gid)
    return rows, None if state is None else state[gid.clamp_min(0)]


def _measure_scores(measure: Measure, fa, fb, sa, sb) -> torch.Tensor:
    sims = measure(fa, fb) if sa is None else measure(fa, fb, sa, sb)
    return sims.to(torch.float32)


def _score_tile(measure: Measure, features: Optional[PointFeatures],
                a_gid: torch.Tensor, b_gid: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Similarity tiles between gathered id tiles a_gid (nw, A) and b_gid
    (nw, B) -> (nw, A, B) float32.

    cosine / dot go to ``leader_score``.  Any other measure gets the
    gathered rows and, when the measure keeps per-point state (the
    learned measure's embeddings), the state rows.
    """
    (fa, sa), (fb, sb) = (_gather(features, state, a_gid),
                          _gather(features, state, b_gid))
    if _kernel_scored(measure, features):
        a, b = fa.dense.contiguous(), fb.dense.contiguous()
        ok_a = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
        ok_b = torch.ones(b.shape[:-1], dtype=torch.bool, device=b.device)
        return kernel_ops.leader_score(a, b, ok_a, ok_b,
                                       normalized=measure.name == "cosine")
    return _measure_scores(measure, fa, fb, sa, sb)


def score_chunk_rows(measure: Measure, features: Optional[PointFeatures],
                     tile_pairs: int, device: torch.device) -> int:
    """Rows of (A, B) tiles, ``tile_pairs`` = A * B, that one scoring
    chunk outside the kernels takes on ``device``: as many as keep its
    widest intermediate (the sets' match grid, nnz x nnz a pair, or the
    measure's own ``pair_width``) under ``max_block_elems``.  It depends
    on the tile's shape alone, never on the number of rows."""
    width = measure.pair_width
    if features is not None and features.set_idx is not None:
        width = max(width, features.set_idx.shape[-1] ** 2)
    return max(1, max_block_elems(device) // (tile_pairs * width))


def _score_chunked(measure: Measure, features: Optional[PointFeatures],
                   a_gid: torch.Tensor, b_gid: torch.Tensor,
                   state: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`_score_tile` over (nw, A) x (nw, B) id tiles, in chunks of
    :func:`score_chunk_rows` rows for a measure outside the kernels (the
    JAX package's ``lax.map`` over chunks): every chunk has one shape, the
    tail padded with -1 rows, so a pair's score does not depend on where
    it falls.  The rows are gathered once for the whole grid.  The kernel
    measures score the whole grid in one call."""
    if _kernel_scored(measure, features):
        return _score_tile(measure, features, a_gid, b_gid, state)
    nw = a_gid.shape[0]
    chunk = score_chunk_rows(measure, features,
                             a_gid.shape[1] * b_gid.shape[1], a_gid.device)
    pad = -nw % chunk
    if pad:
        a_gid, b_gid = (torch.cat([g, g.new_full((pad,) + g.shape[1:], -1)])
                        for g in (a_gid, b_gid))
    (fa, sa), (fb, sb) = (_gather(features, state, a_gid),
                          _gather(features, state, b_gid))
    out = None
    for lo in range(0, nw + pad, chunk):
        part = lambda t: None if t is None else t[lo:lo + chunk]
        rows = lambda f: None if f is None else f.map(part)
        sims = _measure_scores(measure, rows(fa), rows(fb), part(sa),
                               part(sb))
        if out is None:
            out = sims.new_empty((nw + pad,) + sims.shape[1:])
        out[lo:lo + chunk] = sims
    return out[:nw]


def _emit(mask: torch.Tensor, sims: torch.Tensor,
          r1: Optional[float]) -> torch.Tensor:
    if r1 is None:
        return mask
    return mask & (sims > torch.tensor(r1, dtype=torch.float32,
                                       device=sims.device))


def _rep_lsh_stars(cfg: StarsConfig, features: PointFeatures,
                   prefilter: Optional[torch.Tensor],
                   win: win_lib.Windows, *, new_from: int = 0,
                   refresh_below: int = 0,
                   keep_win: Optional[torch.Tensor] = None,
                   measure: Optional[Measure] = None,
                   state: Optional[torch.Tensor] = None,
                   row_offset: int = 0, total_rows: Optional[int] = None,
                   stride: int = 1,
                   member_index: Optional[torch.Tensor] = None):
    """Stars 1 scoring: every member compares to its bucket's leader only.

    The sort tiebreak is a fresh random priority, so the first slot of
    every bucket run in a window is a uniformly random leader; a window's
    first slot starts a new run (the random sub-bucket split at the cap).
    O(n) comparisons per repetition, scored as (nw * W, 1, 1) tiles (in
    chunks outside the kernels, as the JAX package maps them).

    ``new_from`` > 0 rescores every sub-bucket that holds a point at or
    past ``new_from`` (a new member reaches its old bucket-mates only
    through the leader, so the whole touched star is scored);
    ``refresh_below`` > 0 keeps pairs of old points in the windows of
    ``keep_win``.  ``row_offset`` / ``total_rows`` / ``stride`` /
    ``member_index`` are :func:`_score_windows`' row-subset mode.
    """
    measure = _resolve_measure(cfg, measure)
    nw, w_sz = win.gid.shape
    dev = win.gid.device
    fidx = win.gid if member_index is None else member_index
    is_head = torch.ones_like(win.valid)
    is_head[:, 1:] = win.bucket[:, 1:] != win.bucket[:, :-1]
    slot = torch.arange(w_sz, dtype=torch.int64, device=dev).expand(nw, w_sz)
    head_slot = torch.cummax(
        torch.where(is_head, slot, torch.zeros_like(slot)), dim=1).values
    head_gid = win.gid.gather(1, head_slot)
    head_fidx = fidx.gather(1, head_slot)
    # an invalid head disables its whole run, as in the JAX package
    mask = win.valid & win.valid.gather(1, head_slot) & (head_slot != slot)
    if new_from > 0:
        # scatter-max of "holds a new point" over each sub-bucket run
        is_new = (win.valid & (win.gid >= new_from)).to(torch.int32)
        seg = torch.cumsum(is_head.to(torch.int64), dim=1)
        seg_new = torch.zeros((nw, w_sz + 1), dtype=torch.int32, device=dev)
        seg_new.scatter_reduce_(1, seg, is_new, reduce="amax")
        mask &= seg_new.gather(1, seg) > 0
    if refresh_below > 0:
        mask &= (keep_win[:, None] & (head_gid < refresh_below)
                 & (win.gid < refresh_below))
    pref_ops = torch.zeros((nw,), dtype=torch.int32, device=dev)
    if prefilter is not None:
        pref_ops = mask.sum(1, dtype=torch.int32)
        ham = lsh_lib.hamming_pairwise(
            prefilter[head_fidx.clamp_min(0)][..., None, :],
            prefilter[fidx.clamp_min(0)][..., None, :])[..., 0, 0]
        mask &= ham <= cfg.hamming_prefilter_max
    sims = _score_chunked(measure, features, head_fidx.reshape(-1, 1),
                          fidx.reshape(-1, 1), state)
    sims = sims.reshape(nw, w_sz)
    emit = _emit(mask, sims, cfg.r1)
    return dict(src=head_gid.reshape(-1), dst=win.gid.reshape(-1),
                w=sims.reshape(-1), emit=emit.reshape(-1),
                cmp=mask.reshape(-1),
                emitted=emit.sum(1, dtype=torch.int32),
                comparisons=mask.sum(1, dtype=torch.int32),
                prefilter_ops=pref_ops,
                scored_windows=_scored_rows(nw, row_offset, total_rows,
                                            stride))


def _rep_window_grid(cfg: StarsConfig, words: torch.Tensor,
                     k_tie: prng.Key, k_shift: prng.Key) -> win_lib.Windows:
    """One repetition's window grid from its (n, M) sketch words."""
    n = words.shape[0]
    # only the top TIEBREAK_BITS of the draw, as in the JAX package
    tiebreak = prng.bits(k_tie, (n,), device=words.device) \
        & (((1 << TIEBREAK_BITS) - 1) << (32 - TIEBREAK_BITS))
    if cfg.mode == "lsh":
        return win_lib.lsh_windows(
            lsh_lib.bucket_key(words, cfg.family), window=cfg.window,
            tiebreak=tiebreak, tiebreak_bits=TIEBREAK_BITS)
    if cfg.mode == "sorting":
        return win_lib.sorting_lsh_windows(
            words, window=cfg.window, shift_key=k_shift, tiebreak=tiebreak,
            tiebreak_bits=TIEBREAK_BITS,
            word_bits=lsh_lib.word_bits(cfg.family))
    raise ValueError(f"unknown mode {cfg.mode!r}")


def _rep_candidates(cfg: StarsConfig, features: PointFeatures,
                    prefilter: Optional[torch.Tensor], rep_index: int, *,
                    new_from: int = 0, refresh_below: int = 0,
                    refresh_fraction: float = 1.0,
                    refresh_probs: Optional[torch.Tensor] = None,
                    measure: Optional[Measure] = None,
                    state: Optional[torch.Tensor] = None):
    """One repetition: sketch, window, score; returns the candidate stream.

    A dict of the flat 'src', 'dst', 'w' stream and its 'emit' mask, and
    per-window int32 'comparisons' / 'emitted' / 'prefilter_ops' counts
    (summed on the host as int64).  Outside the fused branch it also
    holds 'cmp', the lanes that 'comparisons' counts (the pair-score
    cache's mask).  ``prefilter`` is the packed sketch of
    :func:`_prefilter_sketch` when the config has the prefilter on;
    ``measure`` the session's :class:`Measure` (by default the one
    ``cfg.measure`` names) and ``state`` its per-point state table.

    ``new_from`` > 0 masks out pairs of points both below it (an extension
    round: old-old edges are already in the slabs); ``refresh_below`` > 0
    keeps only pairs of points both below it, in the windows the refresh
    sample keeps (``refresh_probs``, else ``refresh_fraction``).  The masks
    act before the counters, so 'comparisons' counts what was scored.
    """
    k_tie, k_shift, k_lead, k_refresh = _rep_keys(cfg, rep_index)
    words = lsh_lib.sketch(features, cfg.family,
                           rep_seed=_rep_seed(cfg, rep_index))
    win = _rep_window_grid(cfg, words, k_tie, k_shift)
    del words
    return _score_windows(cfg, features, prefilter, win, k_lead,
                          new_from=new_from, refresh_below=refresh_below,
                          refresh_fraction=refresh_fraction,
                          k_refresh=k_refresh, refresh_probs=refresh_probs,
                          measure=measure, state=state)


def _pair_mask(cfg: StarsConfig, win: win_lib.Windows,
               leader_slot: torch.Tensor, leader_ok: torch.Tensor,
               lead_gid: torch.Tensor, lead_bucket: torch.Tensor,
               keep_win: torch.Tensor, new_from: int,
               refresh_below: int) -> torch.Tensor:
    """(nw, s, W) bool: the leader-member pairs a repetition scores (the
    JAX package's chunked branch's mask chain, over the whole grid)."""
    w_sz = win.gid.shape[1]
    members = torch.arange(w_sz, dtype=torch.int32, device=win.gid.device)
    lslot = leader_slot[:, :, None]
    mask = leader_ok[:, :, None] & win.valid[:, None, :]
    mask = mask & (lslot != members)          # self slot
    if cfg.scoring == "allpairs":
        mask &= lslot < members               # each unordered pair once
    if cfg.mode == "lsh":
        mask &= lead_bucket[:, :, None] == win.bucket[:, None, :]
    if new_from > 0:
        mask &= ((lead_gid[:, :, None] >= new_from)
                 | (win.gid[:, None, :] >= new_from))
    if refresh_below > 0:
        mask &= keep_win[:, None, None]
        mask &= ((lead_gid[:, :, None] < refresh_below)
                 & (win.gid[:, None, :] < refresh_below))
    return mask


def _score_windows(cfg: StarsConfig, features: PointFeatures,
                   prefilter: Optional[torch.Tensor],
                   win: win_lib.Windows, k_lead: prng.Key, *,
                   new_from: int = 0, refresh_below: int = 0,
                   refresh_fraction: float = 1.0,
                   k_refresh: Optional[prng.Key] = None,
                   refresh_probs: Optional[torch.Tensor] = None,
                   measure: Optional[Measure] = None,
                   state: Optional[torch.Tensor] = None,
                   row_offset: int = 0, total_rows: Optional[int] = None,
                   stride: int = 1,
                   member_index: Optional[torch.Tensor] = None):
    """Score one repetition's windows into a masked candidate stream.

    LSH-Stars goes to :func:`_rep_lsh_stars`.  cosine / dot without the
    prefilter take the fused branch of the JAX package: gather the leader
    and member rows once, then one ``window_score`` call gives the
    similarities, the emit mask (the extension and refresh masks
    included) and the per-window counters.  Everything else takes the
    chunked branch: the mask chain over the whole repetition, the
    Hamming cut with the prefilter, then the tiles through the measure
    (``leader_score`` for cosine / dot, :func:`_score_chunked` otherwise).

    Row-subset mode (the paged backend's chunks): ``win`` holds the
    global window rows ``row_offset + stride * [0, nw)`` of a grid of
    ``total_rows`` rows.  The leader and refresh draws are issued at the
    global shape and row-gathered, so a chunk draws what the whole-grid
    call draws for its rows.  ``member_index``, when given, is a (nw, W)
    index grid into ``features`` (and ``state``) used for every gather
    instead of ``win.gid``: the paged backend passes slot ids into the
    chunk's gathered block.  Emitted src / dst are always global gids,
    and ``scored_windows`` counts the real global rows the call owns.
    """
    measure = _resolve_measure(cfg, measure)
    nw, w_sz = win.gid.shape
    dev = win.gid.device
    refresh = refresh_below > 0
    subset = dict(row_offset=row_offset, total_rows=total_rows,
                  stride=stride)
    keep_win = (_refresh_window_sample(k_refresh, nw, refresh_fraction,
                                       refresh_probs, device=dev, **subset)
                if refresh else
                torch.ones((nw,), dtype=torch.bool, device=dev))
    if cfg.mode == "lsh" and cfg.scoring == "stars":
        return _rep_lsh_stars(cfg, features, prefilter, win,
                              new_from=new_from, refresh_below=refresh_below,
                              keep_win=keep_win, measure=measure, state=state,
                              member_index=member_index, **subset)
    if cfg.scoring == "stars":
        leader_slot, leader_ok = win_lib.sample_leaders(
            win, s=cfg.leaders, key=k_lead, **subset)
    elif cfg.scoring == "allpairs":
        leader_slot = torch.arange(w_sz, dtype=torch.int32, device=dev)
        leader_slot = leader_slot.expand(nw, w_sz)
        leader_ok = win.valid
    else:
        raise ValueError(f"unknown scoring {cfg.scoring!r}")
    slot64 = leader_slot.long()
    fidx = win.gid if member_index is None else member_index
    lead_gid = win.gid.gather(1, slot64)
    lead_fidx = fidx.gather(1, slot64)
    lead_bucket = win.bucket.gather(1, slot64)
    out = {}
    if prefilter is None and _kernel_scored(measure, features):
        lead = masked_take(features, lead_fidx).dense
        memb = masked_take(features, fidx).dense
        sims, emit, comparisons, emitted = kernel_ops.window_score(
            lead.contiguous(), memb.contiguous(), leader_slot.contiguous(),
            lead_gid, win.gid, leader_ok.contiguous(), win.valid,
            lead_bucket, win.bucket, keep_win,
            normalized=measure.name == "cosine",
            allpairs=cfg.scoring == "allpairs",
            match_bucket=cfg.mode == "lsh", new_from=new_from,
            refresh_below=refresh_below, r1=cfg.r1)
        pref_ops = torch.zeros((nw,), dtype=torch.int32, device=dev)
    else:
        mask = _pair_mask(cfg, win, leader_slot, leader_ok, lead_gid,
                          lead_bucket, keep_win, new_from, refresh_below)
        pref_ops = torch.zeros((nw,), dtype=torch.int32, device=dev)
        if prefilter is not None:
            pref_ops = mask.sum((1, 2), dtype=torch.int32)
            ham = lsh_lib.hamming_pairwise(prefilter[lead_fidx.clamp_min(0)],
                                           prefilter[fidx.clamp_min(0)])
            mask &= ham <= cfg.hamming_prefilter_max
            del ham
        sims = _score_chunked(measure, features, lead_fidx, fidx, state)
        emit = _emit(mask, sims, cfg.r1)
        comparisons = mask.sum((1, 2), dtype=torch.int32)
        emitted = emit.sum((1, 2), dtype=torch.int32)
        out["cmp"] = mask.reshape(-1)
    src = lead_gid[:, :, None].expand(sims.shape)
    dst = win.gid[:, None, :].expand(sims.shape)
    return dict(src=src.reshape(-1), dst=dst.reshape(-1),
                w=sims.reshape(-1), emit=emit.reshape(-1),
                emitted=emitted, comparisons=comparisons,
                prefilter_ops=pref_ops,
                scored_windows=_scored_rows(nw, row_offset, total_rows,
                                            stride), **out)


def build_graph(features, cfg: StarsConfig, *,
                learned_apply: Optional[Callable] = None,
                measure: Optional[Measure] = None, device=None,
                progress=None):
    """Run ``cfg.r`` repetitions and return the graph: the one-shot
    wrapper over :class:`repro_torch.core.builder.GraphBuilder`."""
    from repro_torch.core.builder import GraphBuilder
    builder = GraphBuilder(features, cfg, learned_apply=learned_apply,
                           measure=measure, device=device)
    builder.add_reps(cfg.r, progress=progress)
    return builder.finalize()


def allpairs_graph(features, measure: str = "cosine", *,
                   r1: Optional[float] = None,
                   degree_cap: Optional[int] = None, block: int = 2048,
                   mixture_alpha: float = 0.5,
                   learned_apply: Optional[Callable] = None,
                   learned: Optional[Measure] = None, device=None):
    """The exact *AllPair* baseline: n (n - 1) / 2 comparisons in blocks,
    one sweep of the 'allpairs' source of
    :class:`repro_torch.core.builder.GraphBuilder`; ``learned`` is a
    :class:`Measure` for ``measure='learned'``."""
    from repro_torch.core.builder import GraphBuilder
    cfg = StarsConfig(source="allpairs", measure=measure, r=1, r1=r1,
                      degree_cap=degree_cap, mixture_alpha=mixture_alpha,
                      allpairs_block=block)
    builder = GraphBuilder(features, cfg, learned_apply=learned_apply,
                           measure=learned, device=device)
    builder.add_reps(1)
    return builder.finalize()
