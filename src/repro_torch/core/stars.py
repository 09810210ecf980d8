"""The Stars per-repetition program (``repro.core.stars``), SortingLSH path.

Each repetition r of R:
  1. sketch the points with a fresh SimHash draw (core/lsh.py),
  2. sort + window them (core/windows.py) with a random tiebreak and a
     random window shift,
  3. sample ``s`` random leaders per window (Stars) or take all pairs
     (non-Stars),
  4. score leader x member tiles and build the emit mask in one fused op,
     ``window_score`` (the CUDA kernel on the card, the plain version on
     the CPU), and hand the masked candidate stream to the accumulator.

Every draw comes from the same threefry keys as the JAX package
(:mod:`repro_torch.prng`), so the windows, leaders, masks and comparison
counts are identical to a JAX build of the same config.

Ported so far: SortingLSH mode with Stars or all-pairs scoring, dense
cosine / dot measures, no Hamming prefilter.  LSH-Stars (``mode='lsh'``),
the prefilter and the non-dense measures raise ``NotImplementedError``;
they come with the other single-device sources.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import lsh as lsh_lib
from repro_torch.core import windows as win_lib
from repro_torch.graph import accumulator as acc_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.similarity.measures import PointFeatures
from repro_torch.similarity.store import masked_take

# Random sort-tiebreak resolution, in bits (the JAX package's value: both
# sort keys must be identical for edge-for-edge parity).
TIEBREAK_BITS = 20

_LATER = ("is not ported yet; it comes with the other single-device "
          "sources (LSH-Stars, the Hamming prefilter, non-dense measures)")


@dataclasses.dataclass(frozen=True)
class StarsConfig:
    """Configuration for one graph build.

    The same fields and defaults as ``repro.core.stars.StarsConfig``, so
    one can be built from the other's fields; see that class for what
    each field means.  Fields of paths this port does not run yet
    (refresh, feature stores, pair cache, mesh wire precision) are kept
    for that parity and rejected by :class:`GraphBuilder` when set to
    anything but their default.
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


def _rep_keys(cfg: StarsConfig, rep_index: int):
    """The per-repetition PRNG keys (k_tie, k_shift, k_lead, k_refresh)."""
    k = prng.fold_in(prng.key(cfg.seed), rep_index)
    k_tie, k_shift, k_lead = prng.split(k, 3)
    return k_tie, k_shift, k_lead, prng.fold_in(k, 0x5EF5)


def _rep_window_grid(cfg: StarsConfig, bits: torch.Tensor,
                     k_tie: prng.Key, k_shift: prng.Key) -> win_lib.Windows:
    """One repetition's window grid from its (n, M) sketch bits."""
    if cfg.mode == "lsh":
        raise NotImplementedError(f"mode='lsh' (LSH-Stars) {_LATER}")
    if cfg.mode != "sorting":
        raise ValueError(f"unknown mode {cfg.mode!r}")
    n = bits.shape[0]
    # only the top TIEBREAK_BITS of the draw, as in the JAX package
    tiebreak = prng.bits(k_tie, (n,), device=bits.device) \
        & (((1 << TIEBREAK_BITS) - 1) << (32 - TIEBREAK_BITS))
    return win_lib.sorting_lsh_windows(
        bits, window=cfg.window, shift_key=k_shift, tiebreak=tiebreak,
        tiebreak_bits=TIEBREAK_BITS)


def _rep_candidates(cfg: StarsConfig, features: PointFeatures,
                    rep_index: int):
    """One repetition: sketch, window, score; returns the candidate stream.

    A dict of the flat 'src', 'dst', 'w' stream and its 'emit' mask, and
    per-window int32 'comparisons' / 'emitted' counts (summed on the host
    as int64).
    """
    rep_seed = (rep_index & 0xFFFFFFFF) ^ (cfg.seed & 0xFFFFFFFF)
    k_tie, k_shift, k_lead, _ = _rep_keys(cfg, rep_index)
    bits = lsh_lib.sketch(features, cfg.family, rep_seed=rep_seed)
    win = _rep_window_grid(cfg, bits, k_tie, k_shift)
    return _score_windows(cfg, features, win, k_lead)


def _score_windows(cfg: StarsConfig, features: PointFeatures,
                   win: win_lib.Windows, k_lead: prng.Key):
    """Score one repetition's windows into a masked candidate stream.

    The fused branch of the JAX package's ``_score_windows``: gather the
    leader and member rows once, then one ``window_score`` call gives the
    similarities, the emit mask and the per-window counters.
    """
    nw, w_sz = win.gid.shape
    dev = win.gid.device
    if cfg.mode == "lsh":
        raise NotImplementedError(f"mode='lsh' (LSH-Stars) {_LATER}")
    if cfg.hamming_prefilter_bits > 0:
        raise NotImplementedError(f"the Hamming prefilter {_LATER}")
    if cfg.measure not in ("cosine", "dot"):
        raise NotImplementedError(f"measure={cfg.measure!r} {_LATER}")
    if cfg.scoring == "stars":
        leader_slot, leader_ok = win_lib.sample_leaders(
            win, s=cfg.leaders, key=k_lead)
    elif cfg.scoring == "allpairs":
        leader_slot = torch.arange(w_sz, dtype=torch.int32, device=dev)
        leader_slot = leader_slot.expand(nw, w_sz)
        leader_ok = win.valid
    else:
        raise ValueError(f"unknown scoring {cfg.scoring!r}")
    slot64 = leader_slot.long()
    lead_gid = win.gid.gather(1, slot64)
    lead_bucket = win.bucket.gather(1, slot64)
    lead = masked_take(features, lead_gid).dense
    memb = masked_take(features, win.gid).dense
    keep_win = torch.ones((nw,), dtype=torch.bool, device=dev)
    sims, emit, comparisons, emitted = kernel_ops.window_score(
        lead.contiguous(), memb.contiguous(), leader_slot.contiguous(),
        lead_gid, win.gid, leader_ok.contiguous(), win.valid, lead_bucket,
        win.bucket, keep_win, normalized=cfg.measure == "cosine",
        allpairs=cfg.scoring == "allpairs", match_bucket=False, r1=cfg.r1)
    src = lead_gid[:, :, None].expand(sims.shape)
    dst = win.gid[:, None, :].expand(sims.shape)
    return dict(src=src.reshape(-1), dst=dst.reshape(-1),
                w=sims.reshape(-1), emit=emit.reshape(-1),
                emitted=emitted, comparisons=comparisons,
                prefilter_ops=torch.zeros((nw,), dtype=torch.int32,
                                          device=dev),
                scored_windows=_scored_rows(nw, 0, None))
