"""Sort-and-window machinery (``repro.core.windows``).

SortingLSH mode (Stars 2): points sort lexicographically by their M
sketch words with a random tiebreak, then a random shift r ~ [W/2, W]
offsets the window boundaries.  LSH mode (Stars 1): points sort by their
folded bucket id with a random tiebreak, so buckets become contiguous
runs cut into windows of at most W.  Windows are fixed (n_windows, W)
slot grids with a validity mask, exactly as in the JAX package.

Two traps of the JAX program have no direct torch counterpart:

  * ``lax.sort`` over several operands: the sort keys (the M sketch words,
    most significant first, or the 32-bit bucket id) and the 20-bit
    tiebreak pack into int64 keys of at most 63 bits (one key for SimHash
    bits, several for 32-bit MinHash words), sorted by a chain of stable
    sorts, least significant key first; ascending gids resolve the
    remaining ties, as in the JAX sort.
  * ``lax.top_k`` keeps the lower index on a tie and ``torch.topk`` does
    not; a stable descending sort does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch import prng

INVALID = -1

# Bucket id of padding slots: uint32 0xFFFFFFFF held as its int32 bit
# pattern (buckets are only ever compared for equality).
PAD_BUCKET = -1


@dataclasses.dataclass(frozen=True)
class Windows:
    """Fixed-shape windowed view of one repetition's sorted order.

    Attributes:
      gid:    (n_windows, W) int32 point ids; -1 on padding slots.
      valid:  (n_windows, W) bool.
      bucket: (n_windows, W) int32 bucket id bit patterns: 0 in sorting
              mode (the window is the bucket), ``PAD_BUCKET`` on padding.
    """

    gid: torch.Tensor
    valid: torch.Tensor
    bucket: torch.Tensor


def _scatter_to_slots(perm_gid: torch.Tensor, perm_bucket: torch.Tensor,
                      offset: int, n_slots: int, w: int) -> Windows:
    """Place the sorted sequence into padded slots starting at ``offset``."""
    n = perm_gid.shape[0]
    dev = perm_gid.device
    slots_gid = torch.full((n_slots,), INVALID, dtype=torch.int32, device=dev)
    slots_bucket = torch.full((n_slots,), PAD_BUCKET, dtype=torch.int32,
                              device=dev)
    slots_gid[offset:offset + n] = perm_gid
    slots_bucket[offset:offset + n] = perm_bucket
    gid = slots_gid.reshape(-1, w)
    return Windows(gid=gid, valid=gid >= 0, bucket=slots_bucket.reshape(-1, w))


def window_slot_count(mode: str, n: int, window: int) -> int:
    """Static padded slot count of one repetition's window grid."""
    if mode == "lsh":
        return ((n + window - 1) // window) * window
    if mode != "sorting":
        raise ValueError(f"unknown mode {mode!r}")
    return ((n + window - 1) // window + 1) * window


def window_layout(mode: str, n: int, window: int,
                  shift_key: Optional[prng.Key] = None) -> Tuple[int, int]:
    """(slot offset, padded slot count) of one repetition's window grid.

    SortingLSH mode draws the first-block size r ~ [W/2, W] from
    ``shift_key`` (offset W - r) and pads one extra window of slots.
    """
    if mode == "lsh":
        return 0, window_slot_count(mode, n, window)
    if mode != "sorting":
        raise ValueError(f"unknown mode {mode!r}")
    # one host scalar: drawn on the CPU on purpose, whatever the device
    r = int(prng.randint(shift_key, (), window // 2, window + 1,
                         device="cpu"))
    return window - r, window_slot_count(mode, n, window)


def shard_row_layout(mode: str, n: int, window: int,
                     p: int) -> Tuple[int, int, int]:
    """Static window-row partition of one repetition's grid over ``p`` ranks.

    Rank ``i`` owns the striped global window rows ``i, i + p, ...``
    (:func:`shard_row_permutation`): window occupancy is full rows, then
    one partial row, then empty padding rows, so striping spreads the
    light tail over the ranks (their real-row counts differ by at most 1).
    Returns ``(n_windows, rows_per_rank, padded_slots)``: the real global
    row count, ``ceil(n_windows / p)`` and ``p * rows_per_rank * W``
    (rows past ``n_windows`` hold no point and score nothing).  Ownership
    is decided in slot space, after the sorting-mode shift, so a window
    whose members come from two ranks' sort output still has one owner.
    """
    if p < 1:
        raise ValueError(f"shard count must be >= 1: {p}")
    n_windows = window_slot_count(mode, n, window) // window
    rows_per_rank = -(-n_windows // p)
    return n_windows, rows_per_rank, p * rows_per_rank * window


def shard_row_permutation(row, rows_per_rank: int, p: int):
    """Physical row of global window row ``row`` under the striping: rank
    ``row % p``, local row ``row // p``, so ``(row % p) * rows_per_rank +
    row // p``; a bijection on ``[0, p * rows_per_rank)``, the identity at
    ``p == 1``.  Elementwise on ints or integer tensors."""
    return (row % p) * rows_per_rank + row // p


def sort_keys(words: torch.Tensor, word_bits: int, tiebreak: torch.Tensor,
              tiebreak_bits: int) -> List[torch.Tensor]:
    """The lexicographic sort key of (word 0, ..., word M-1, tiebreak) as
    int64 keys of at most 63 bits, most significant first.

    Each word contributes its low ``word_bits`` bits (1 for SimHash bits,
    32 for MinHash words), the tiebreak its top ``tiebreak_bits`` of 32.
    Fields pack greedily from the least significant end, so a key that
    fits in 63 bits (SimHash at M <= 43) is the single int64 of the
    packed bits above the tiebreak.
    """
    n, m = words.shape
    fields = [(words[:, j], word_bits) for j in range(m)]
    fields.append((tiebreak >> (32 - tiebreak_bits), tiebreak_bits))
    keys: List[torch.Tensor] = []
    key, width = None, 0
    for val, bits in reversed(fields):
        if key is not None and width + bits > 63:
            keys.append(key)
            key, width = None, 0
        part = val.to(torch.int64) << width
        key = part if key is None else key | part
        width += bits
    keys.append(key)
    return keys[::-1]


def lexsort_gids(keys: List[torch.Tensor]) -> torch.Tensor:
    """Point ids in the lexicographic order of ``keys`` (most significant
    first), equal keys by ascending id: a chain of stable sorts, least
    significant key first."""
    perm = torch.sort(keys[-1], stable=True).indices
    for key in reversed(keys[:-1]):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def sorting_lsh_windows(words: torch.Tensor, *, window: int,
                        shift_key: prng.Key, tiebreak: torch.Tensor,
                        tiebreak_bits: int, word_bits: int = 1) -> Windows:
    """Stars 2 windowing: exact lexicographic sort + random-shift blocks.

    Args:
      words:     (n, M) sketch words per point (uint32 values in int64).
      window:    W.
      shift_key: PRNG key of the random shift r ~ [W/2, W].
      tiebreak:  (n,) int64 uint32 tiebreak values; only the top
                 ``tiebreak_bits`` may be set (``stars._rep_window_grid``).
      word_bits: significant bits of a word (``lsh.word_bits``).
    """
    n = words.shape[0]
    # stable over gids 0..n-1: equal keys keep gid order, the JAX sort's
    # final resolver
    perm_gid = lexsort_gids(
        sort_keys(words, word_bits, tiebreak, tiebreak_bits)).to(torch.int32)
    offset, n_slots = window_layout("sorting", n, window, shift_key)
    return _scatter_to_slots(perm_gid, torch.zeros_like(perm_gid), offset,
                             n_slots, window)


def lsh_windows(bucket_id: torch.Tensor, *, window: int,
                tiebreak: torch.Tensor, tiebreak_bits: int) -> Windows:
    """Stars 1 bucketing: sort by (bucket id, random tiebreak), window.

    Args:
      bucket_id: (n,) int64 uint32 folded sketches (``lsh.bucket_key``).
      window:    the bucket-size cap W.
      tiebreak:  (n,) int64 uint32 random priorities; only the top
                 ``tiebreak_bits`` may be set (``stars._rep_window_grid``).
    """
    n = bucket_id.shape[0]
    key = (bucket_id << tiebreak_bits) | (tiebreak >> (32 - tiebreak_bits))
    perm = torch.sort(key, stable=True).indices
    b = bucket_id[perm]
    perm_bucket = torch.where(b >= 2**31, b - 2**32, b).to(torch.int32)
    offset, n_slots = window_layout("lsh", n, window)
    return _scatter_to_slots(perm.to(torch.int32), perm_bucket, offset,
                             n_slots, window)


def global_row_draw(draw, nw: int, row_offset: int,
                    total_rows: Optional[int], fill: float,
                    stride: int = 1) -> torch.Tensor:
    """Rows ``row_offset + stride * [0, nw)`` of a globally shaped draw.

    ``draw(rows)`` is a pure function of its row count.  On one device
    (``total_rows`` None) the slice is the whole grid; the sharded form
    reads ``fill`` past ``total_rows``, as in the JAX package.
    """
    if total_rows is None:
        return draw(nw)
    full = draw(total_rows)
    idx = row_offset + stride * torch.arange(nw, device=full.device)
    take = full[idx.clamp_max(total_rows - 1)]
    oob = (idx >= total_rows).reshape((nw,) + (1,) * (full.dim() - 1))
    return torch.where(oob, torch.full_like(take, fill), take)


def sample_leaders(windows: Windows, *, s: int, key: prng.Key,
                   row_offset: int = 0, total_rows: Optional[int] = None,
                   stride: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample up to ``s`` uniformly random leaders per window.

    Returns:
      leader_slot: (n_windows, s) int32 slot index within the window.
      leader_ok:   (n_windows, s) bool, False where a window had fewer
                   than s valid points.
    """
    nw, w = windows.gid.shape
    dev = windows.gid.device
    pri = global_row_draw(
        lambda rows: prng.uniform(key, (rows, w), device=dev), nw,
        row_offset, total_rows, fill=-1.0, stride=stride)
    pri = torch.where(windows.valid, pri, torch.full_like(pri, -1.0))
    # lax.top_k order: value descending, lower index first on a tie
    vals, slots = torch.sort(pri, dim=1, descending=True, stable=True)
    vals, slots = vals[:, :s], slots[:, :s]
    # a draw of exactly 0.0 is a valid leader: the boundary is inclusive
    return slots.to(torch.int32), vals >= 0.0
