"""Device-resident pair-score cache for expensive (learned) measures
(``repro.similarity.pair_cache``).

Stars re-visits pairs (overlapping repetitions, refresh rounds).  For a
learned measure every visit would re-pay the pair head; this cache keeps
each pair's score in a fixed-size hash-slot table keyed by the unordered
(gid_lo, gid_hi), so a re-visit is metered as a hit instead of an
expensive comparison, and the cached score is the one accumulated.

The contract that makes cache-on builds equal cache-off builds: a pair's
score is bitwise the same in whatever tile it is scored (every scoring
chunk has one shape, and the measures keep a row's arithmetic independent
of the tile: ``similarity/measures.py``), so a hit returns exactly what
the tile computed.  A slot collision evicts; it never mixes two pairs.

Layout: one (slots + 1, 3) int32 table of rows (gid_lo, gid_hi, score
bits), 12 bytes a slot as in the JAX package; the extra last row is a
scratch row that lanes which do not insert write to (the counterpart of
the JAX scatter's ``mode="drop"``) and that no lookup reads.  Where
several lanes of one batch insert into one slot, the last lane wins, as
XLA's scatter applies updates in order; exactly one row write reaches
each slot, so a key never travels with another lane's score.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hashing
from repro_torch.device import DeviceLike, resolve_device

# Empty-slot sentinel: 0xFFFFFFFF as int32; real gids are >= 0.
_EMPTY = -1


@dataclasses.dataclass(frozen=True)
class PairCache:
    """Hash-slot table: (slots + 1, 3) int32 rows (gid_lo, gid_hi, score
    bits); the last row is scratch."""

    table: torch.Tensor

    @property
    def slots(self) -> int:
        return int(self.table.shape[0]) - 1

    @property
    def nbytes(self) -> int:
        return self.table.numel() * self.table.element_size()


def create(slots: int, *, device: DeviceLike = None) -> PairCache:
    """A cache with at least ``slots`` slots (rounded up to a power of
    two), on ``device`` (CUDA unless ``"cpu"``)."""
    if slots <= 0:
        raise ValueError(f"pair cache needs slots > 0, got {slots}")
    size = 1 << max(1, int(slots - 1).bit_length())
    return PairCache(table=torch.full((size + 1, 3), _EMPTY,
                                      dtype=torch.int32,
                                      device=resolve_device(device)))


def _hash_slot(lo: torch.Tensor, hi: torch.Tensor, size: int) -> torch.Tensor:
    """The JAX package's murmur3-fmix-style mix of the two key words (uint32
    values carried in int64) -> slot index (int64)."""
    h = lo ^ hashing._mul32(hi, 0x9E3779B9)
    h = hashing._mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = hashing._mul32(h ^ (h >> 13), 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h & (size - 1)


def lookup_insert(cache: PairCache, src: torch.Tensor, dst: torch.Tensor,
                  w: torch.Tensor, cmp: torch.Tensor):
    """One batched lookup and insert over a flat candidate stream.

    Args:
      src / dst: (N,) int32 gids (keyed as the unordered pair).
      w:         (N,) float32 freshly computed scores.
      cmp:       (N,) bool: lanes that are real comparisons; the others
                 neither hit nor insert.

    Returns ``(w_out, cache', hits, misses, evictions)``: ``w_out`` takes
    the cached score on hits and ``w`` elsewhere; the counters are int64
    device scalars (``misses`` are the round's expensive comparisons,
    ``evictions`` live entries overwritten).  A pair twice in one batch
    counts as two misses (both lanes see the table before the insert).
    The table is updated in place; the returned cache holds it.
    """
    table = cache.table
    size = cache.slots
    lo32 = torch.minimum(src, dst).to(torch.int32)
    hi32 = torch.maximum(src, dst).to(torch.int32)
    slot = _hash_slot(lo32.to(torch.int64) & 0xFFFFFFFF,
                      hi32.to(torch.int64) & 0xFFFFFFFF, size)
    row = table[slot]
    match = (row[:, 0] == lo32) & (row[:, 1] == hi32)
    hit = cmp & match
    w_out = torch.where(hit, row[:, 2].view(torch.float32), w)
    miss = cmp & ~match
    evict = miss & (row[:, 0] != _EMPTY)
    # one winner a slot: the last inserting lane, as XLA's scatter leaves it
    lane = torch.arange(slot.shape[0], dtype=torch.int64, device=slot.device)
    winner = torch.full((size + 1,), -1, dtype=torch.int64,
                        device=slot.device)
    winner.scatter_reduce_(0, slot, torch.where(miss, lane, -1),
                           reduce="amax")
    won = miss & (winner[slot] == lane)
    vals = torch.stack([lo32, hi32, w.contiguous().view(torch.int32)], dim=-1)
    table.index_put_((torch.where(won, slot, size),), vals)
    count = lambda m: m.sum(dtype=torch.int64)
    return (w_out, PairCache(table=table), count(hit), count(miss),
            count(evict))
