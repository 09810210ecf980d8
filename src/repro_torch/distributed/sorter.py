"""Distributed sample sort over ``torch.distributed`` (``repro.distributed.sorter``).

The paper sorts nR sketches with TeraSort over a fleet (its Appendix
C.1).  Over p ranks the same job is an MPC sample sort:

  1. each rank sorts its keys,
  2. splitters: each rank samples p local quantiles, an all-gather and a
     sort of the p * p samples give p - 1 global splitters,
  3. partition: a key goes to the rank of the number of splitters below
     it (lexicographic on the key words),
  4. one exact-size all-to-all (a counts exchange, then the keys: no
     fixed capacity, nothing dropped),
  5. each rank sorts what it received.

Keys are multi-word: an (n, nk) tensor of uint32 words (carried in
int64, as the port carries every uint32) sorts lexicographically, word 0
first.  The payload (the point id) is the last key, so ties in every key
word resolve by ascending id: the order of the single-device sort.
With ``payload_bits`` the id already sits in the low bits of the last
word (:func:`pack_bit_fields`), and the keys alone ship.  Rows with
payload -1 (a mesh's pad rows) are left out before the sort: they never
enter the splitter sample or the exchange.

The output is globally sorted across the ranks in rank order.  Two
consumers build on it: :func:`distributed_window_blocks` (the mesh
build's scoring input: each sorted id goes to the owner of its window
slot) and :func:`distributed_argsort` (the whole permutation on every
rank).  Words cross the wire as int32 bit patterns, 4 bytes a word.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import windows as win_lib
from repro_torch.distributed import comm
from repro_torch.distributed.comm import Mesh

SENTINEL = 0xFFFFFFFF


def pack_bit_fields(fields: Sequence[torch.Tensor],
                    widths: Sequence[int]) -> torch.Tensor:
    """Pack per-row bit fields into a big-endian uint32 word stream.

    ``fields[i]`` is an (n,) integer tensor whose low ``widths[i]`` bits
    are the field (higher bits are masked off); the fields concatenate
    most significant first over ``ceil(sum(widths) / 32)`` words, word 0
    most significant, so the packed words compare lexicographically as
    the field tuples do.  Each width is at most 32; a zero width is a
    no-op.  Returns (n, nwords) int64 holding uint32 values; inverse
    :func:`unpack_bit_fields`.
    """
    total = sum(widths)
    nwords = -(-total // 32)
    n = fields[0].shape[0]
    dev = fields[0].device
    words = [torch.zeros((n,), dtype=torch.int64, device=dev)
             for _ in range(nwords)]
    off = 0
    for f, w in zip(fields, widths):
        if w < 0 or w > 32:
            raise ValueError(f"field width {w} not in [0, 32]")
        if w == 0:
            continue
        f = f.to(torch.int64) & ((1 << w) - 1)
        end = off + w
        for j in range(off // 32, (end - 1) // 32 + 1):
            wend = 32 * (j + 1)
            if end > wend:          # the field continues into the next word
                part = f >> (end - wend)
            else:
                part = (f << (wend - end)) & SENTINEL
            words[j] = words[j] | part
        off = end
    return torch.stack(words, dim=-1)


def unpack_bit_fields(words: torch.Tensor,
                      widths: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Inverse of :func:`pack_bit_fields`: (n, nwords) -> the fields, each
    (n,) int64 with its low ``widths[i]`` bits."""
    total = sum(widths)
    if words.shape[-1] != -(-total // 32):
        raise ValueError(f"{words.shape[-1]} words cannot hold {total} bits")
    outs = []
    off = 0
    for w in widths:
        end = off + w
        acc = torch.zeros(words.shape[:-1], dtype=torch.int64,
                          device=words.device)
        if w:
            for j in range(off // 32, (end - 1) // 32 + 1):
                wstart, wend = 32 * j, 32 * (j + 1)
                lo_b = max(0, wend - end)
                nb = (wend - max(off, wstart)) - lo_b
                chunk = (words[..., j] >> lo_b) & ((1 << nb) - 1)
                acc = acc | (chunk << (end - min(end, wend)))
        outs.append(acc)
        off = end
    return tuple(outs)


def to_wire(words: torch.Tensor) -> torch.Tensor:
    """uint32 values carried in int64 -> their int32 bit patterns."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def from_wire(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> uint32 values carried in int64."""
    return words.to(torch.int64) & SENTINEL


def lexsort(words: torch.Tensor) -> torch.Tensor:
    """Row order of an (m, nk) word matrix sorted lexicographically, word
    0 first: a chain of stable sorts, the last word first (equal rows
    keep their order)."""
    perm = torch.sort(words[:, -1], stable=True).indices
    for j in range(words.shape[1] - 2, -1, -1):
        perm = perm[torch.sort(words[perm, j], stable=True).indices]
    return perm


def _splitters_below(keys: torch.Tensor, splitters: torch.Tensor
                     ) -> torch.Tensor:
    """(m,) number of splitter rows lexicographically below each key row."""
    below = torch.zeros((keys.shape[0], splitters.shape[0]), dtype=torch.bool,
                        device=keys.device)
    eq = torch.ones_like(below)
    for j in range(keys.shape[1]):
        s, k = splitters[None, :, j], keys[:, None, j]
        below |= eq & (s < k)
        eq &= s == k
    return below.sum(1)


def sample_sort(words: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sort (m, nk) unique key rows across the mesh; returns this rank's
    run of the global order (the runs concatenate in rank order)."""
    p = mesh.size
    m, nk = words.shape
    words = words[lexsort(words)] if m else words
    # p local quantiles (sentinel rows from a rank with no key sort last)
    if m:
        sample = words[(torch.arange(p, device=words.device) * m) // p]
    else:
        sample = words.new_full((p, nk), SENTINEL)
    samples = torch.cat(comm.all_gather(mesh, sample))
    samples = samples[lexsort(samples)]
    splitters = samples[torch.arange(1, p, device=words.device) * p]
    dest = _splitters_below(words, splitters)
    order, send_counts = comm.owner_order(dest, p)
    recv_counts = comm.counts_exchange(mesh, send_counts)
    got = from_wire(comm.all_to_all(mesh, to_wire(words[order]), send_counts,
                                    recv_counts))
    return got[lexsort(got)] if got.shape[0] else got


def _payload(last_word: torch.Tensor, gid_bits: int) -> torch.Tensor:
    """The gid in the low ``gid_bits`` bits of a packed key's last word."""
    return (last_word & ((1 << gid_bits) - 1)).to(torch.int32)


def _key_matrix(keys: torch.Tensor) -> torch.Tensor:
    return keys[:, None] if keys.dim() == 1 else keys


def _sorted_ids(keys, gids, mesh, payload_bits):
    """Sort the live rows (gid >= 0); returns this rank's sorted key words
    and ids."""
    words = _key_matrix(keys)
    live = gids >= 0
    words, gids = words[live], gids[live]
    if payload_bits is None:
        # the id is the last key; ids are >= 0, so it fits a uint32 word
        out = sample_sort(torch.cat([words, gids.to(torch.int64)[:, None]],
                                    dim=1), mesh)
        return out[:, :-1], out[:, -1].to(torch.int32)
    out = sample_sort(words, mesh)
    return out, _payload(out[:, -1], payload_bits)


def distributed_sort(keys: torch.Tensor, payload: torch.Tensor, mesh: Mesh):
    """Globally sort this rank's (keys, payload) rows over the mesh.

    ``keys``: (m,) or (m, nk) uint32 words in int64 (word 0 most
    significant); ``payload``: (m,) int32 ids, -1 for rows to leave out.
    Returns ``(keys, payload, valid, dropped)`` of this rank's run of the
    global order (the runs concatenate in rank order), with the key rank
    of the input; ``valid`` is all True and ``dropped`` 0, since the
    exchange is exact.
    """
    words, ids = _sorted_ids(keys, payload, mesh, None)
    out_k = words[:, 0] if keys.dim() == 1 else words
    dropped = torch.zeros((1,), dtype=torch.int32, device=ids.device)
    return out_k, ids, torch.ones_like(ids, dtype=torch.bool), dropped


def _rank_offset(mesh: Mesh, count: int, device) -> Tuple[int, List[int]]:
    """(this rank's first global position, every rank's count)."""
    counts = torch.cat(comm.all_gather(
        mesh, torch.tensor([count], dtype=torch.int64, device=device)))
    counts = counts.tolist()
    return sum(counts[:mesh.rank]), counts


def _slot_owner(slot: torch.Tensor, block: int, p: int, window: int):
    """(owner rank, position in its block) of global slots, the window
    rows of ``window`` slots striped over the ranks."""
    rps = block // window
    row, col = slot // window, slot % window
    phys = win_lib.shard_row_permutation(row, rps, p) * window + col
    return phys // block, phys % block


def _my_slots(rank: int, block: int, p: int, window: int,
              device) -> torch.Tensor:
    """The global slots of ``rank``'s block, in block order."""
    i = torch.arange(block, dtype=torch.int64, device=device)
    return (rank + p * (i // window)) * window + i % window


def distributed_window_blocks(keys: torch.Tensor, gids: torch.Tensor,
                              mesh: Mesh, *, slot_offset: int,
                              total_slots: int, window: int,
                              payload_bits: int,
                              bucket_word: Optional[int] = None):
    """Sample-sort (keys, gids) and hand each rank its own window slots.

    Each sorted id has a window slot, its global rank plus
    ``slot_offset`` (the sorting-mode shift, as ``windows._scatter_to_
    slots`` places it on one device), and goes to the rank owning that
    slot: rank i owns the striped window rows i, i + p, ... of ``window``
    (W) slots each (``windows.shard_row_layout``).  Ownership is in slot space after the
    shift, so a window whose members straddle two ranks' sort output
    arrives whole at its one owner.  The receiver knows which slots it
    owns and that ids arrive in global order, so only the ids (and, with
    ``bucket_word``, the LSH bucket in that key word) cross, in one
    exchange metered as ``slot_scatter``.

    ``payload_bits``: the keys end in a gid field of that width
    (:func:`pack_bit_fields`), so the sort ships the keys alone.

    Returns ``(block_gid, block_bucket, dropped)``: (total_slots / p,)
    int32 ids (-1 on empty slots) and int32 bucket bit patterns (0 in
    sorting mode, ``windows.PAD_BUCKET`` on empty slots), and 0 dropped.
    """
    p = mesh.size
    if total_slots % (p * window):
        raise ValueError(
            f"total_slots {total_slots} not divisible by p*W {p * window}")
    dev = gids.device
    block = total_slots // p
    words, ids = _sorted_ids(keys, gids, mesh, payload_bits)
    rank0, counts = _rank_offset(mesh, ids.shape[0], dev)
    n_total = sum(counts)
    # send: each sorted id to its slot's owner, in global order per owner
    slot = slot_offset + rank0 + torch.arange(ids.shape[0], device=dev)
    owner, _ = _slot_owner(slot, block, p, window)
    cols = [ids]
    if bucket_word is not None:
        cols.append(to_wire(_key_matrix(words)[:, bucket_word]))
    order, send_counts = comm.owner_order(owner, p)
    payload = torch.stack(cols, dim=1)[order]
    # receive: the ids of my slots arrive in global order, grouped by the
    # rank that sorted them
    g = _my_slots(mesh.rank, block, p, window, dev) - slot_offset
    mine = (g >= 0) & (g < n_total)
    src = torch.searchsorted(
        torch.tensor(counts, device=dev).cumsum(0), g[mine], right=True)
    recv_counts = torch.bincount(src, minlength=p)[:p].tolist()
    got = comm.all_to_all(mesh, payload, send_counts, recv_counts,
                          kind="slot_scatter")
    block_gid = torch.full((block,), -1, dtype=torch.int32, device=dev)
    block_gid[mine] = got[:, 0]
    block_bucket = torch.full((block,), win_lib.PAD_BUCKET,
                              dtype=torch.int32, device=dev)
    block_bucket[mine] = got[:, 1] if bucket_word is not None else 0
    dropped = torch.zeros((1,), dtype=torch.int32, device=dev)
    return block_gid, block_bucket, dropped


def distributed_argsort(keys: torch.Tensor, gids: torch.Tensor, mesh: Mesh,
                        n_out: int):
    """The global sort permutation of (keys, gids), on every rank.

    Each rank places its sorted ids at their global ranks in an (n_out,)
    buffer and an all-reduce sums the buffers (ids + 1, so empty ranks
    read -1): slot i is the id of global rank i.  Rows with gid -1 are
    left out.  Returns ``(perm, dropped)``.
    """
    _, ids = _sorted_ids(keys, gids, mesh, None)
    rank0, _ = _rank_offset(mesh, ids.shape[0], ids.device)
    perm = torch.zeros((n_out,), dtype=torch.int32, device=ids.device)
    perm[rank0:rank0 + ids.shape[0]] = ids + 1
    perm = comm.all_reduce_sum(mesh, perm) - 1
    return perm, torch.zeros((1,), dtype=torch.int32, device=ids.device)
