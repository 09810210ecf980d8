"""The mesh build's fetch and emit exchanges (``repro.distributed.stars_dist``).

Per repetition the mesh build (``core.builder._MeshBackend``) runs:

  1. sketch: each rank sketches its own row block into bit-packed sort
     keys (no communication),
  2. sort: :func:`sorter.distributed_window_blocks` hands each rank the
     ~n_windows / p striped window rows it scores, in the single-device
     order,
  3. fetch: :func:`fetch_rows_all_to_all` brings each rank the feature
     (and prefilter) rows of its window slots from their owners, row
     ``gid`` living on rank ``gid // (n_pad / p)``,
  4. score: each rank runs ``stars._score_windows`` on its rows only,
     with leader and refresh draws keyed by global window row, so draws
     and floats equal one device's,
  5. emit: :func:`accumulate_all_to_all` routes every (node, nbr, w)
     insertion triple to the rank owning the node's slab row and folds
     it there with the accumulator's ``_fold_triples``.

Every global window row is scored once, by one rank, from the same
rows, and every triple reaches its row before the same top-k fold, so
the mesh build equals the single-device build edge for edge.  The
exchanges are exact-size (:mod:`comm`): nothing is dropped.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.comm import Mesh
from repro_torch.distributed.sorter import (from_wire, pack_bit_fields,
                                            to_wire, unpack_bit_fields)
from repro_torch.graph import accumulator as acc_lib

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]


def emit_widths(n_pad: int, p: int, exact_weights: bool):
    """Bit widths of a packed emit triple ``(loc, nbr, weight)``: the
    destination-local slab row (the all-ones value reserved, as in the JAX
    package), the global neighbour id, and the float32 weight or, with
    ``exact_weights`` False, its bfloat16 rounding."""
    rows = n_pad // p
    return (int(rows).bit_length(), int(n_pad).bit_length(),
            32 if exact_weights else 16)


def _no_drop(device) -> torch.Tensor:
    return torch.zeros((1,), dtype=torch.int32, device=device)


def fetch_rows_all_to_all(table: torch.Tensor, gids: Parts, *, mesh: Mesh):
    """The rows of ``table`` at this rank's gids, from their owner ranks.

    ``table``: this rank's (n_pad / p, d) row block (features, with the
    prefilter words beside them as float32 bit patterns when armed).
    ``gids``: an int32 tensor of global ids (-1 for an empty slot), or a
    tuple of them, whose fetches then share one request / response pair
    (a repetition pair).  Each rank groups its live ids by owner, a counts
    exchange sizes the exchange, the local row ids go out in one
    all-to-all and the rows come back in a second.  Empty slots read zero
    rows with ``ok`` False.

    Returns ``(rows, ok, dropped)``: (S, d) rows and (S,) bools in slot
    order (per part for a tuple), and 0 dropped.
    """
    is_tuple = isinstance(gids, (tuple, list))
    parts = tuple(gids) if is_tuple else (gids,)
    rows_per_rank, d = table.shape
    gid = torch.cat([g.reshape(-1) for g in parts])
    live = gid >= 0
    idx = torch.nonzero(live).reshape(-1)
    owner = gid[idx].to(torch.int64) // rows_per_rank
    order, send_counts, recv_counts, (asked,) = comm.exchange(
        mesh, owner, (gid[idx].to(torch.int64) - owner * rows_per_rank)
        .to(torch.int32))
    answer = comm.all_to_all(mesh, table[asked.long()], recv_counts,
                             send_counts)
    out = table.new_zeros((gid.shape[0], d))
    out[idx[order]] = answer
    outs, oks, off = [], [], 0
    for g in parts:
        size = g.numel()
        outs.append(out[off:off + size])
        oks.append(live[off:off + size])
        off += size
    dropped = _no_drop(table.device)
    if is_tuple:
        return tuple(outs), tuple(oks), dropped
    return outs[0], oks[0], dropped


def _weight_field(w: torch.Tensor, exact_weights: bool) -> torch.Tensor:
    if exact_weights:
        return from_wire(w.view(torch.int32))
    return w.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def _field_weight(field: torch.Tensor, exact_weights: bool) -> torch.Tensor:
    bits = field if exact_weights else field << 16
    return to_wire(bits).view(torch.float32)


def accumulate_all_to_all(state: acc_lib.EdgeAccumulator, src: Parts,
                          dst: Parts, w: Parts, valid: Parts, *, mesh: Mesh,
                          exact_weights: bool = True
                          ) -> Tuple[acc_lib.EdgeAccumulator, torch.Tensor]:
    """Fold a candidate stream into this rank's slab rows through one
    exact-size all-to-all.

    ``state`` is this rank's (n_pad / p, k) row block; ``src`` / ``dst``
    / ``w`` / ``valid`` one stream or tuples of streams (a repetition
    pair, which then shares the exchange).  Each rank doubles its stream
    into (node, nbr, w) insertion triples (invalid, negative-id and
    self-loop entries left out), groups them by the rank owning ``node``'s
    row, packs each to ``emit_widths`` bits (``exact_weights`` False
    ships bfloat16 weights) and ships them; the owner folds what it
    receives with ``_fold_triples``.  A row's result depends only on the
    multiset of its triples (ties by lower neighbour id), so the fold
    equals a single-device ``accumulate`` of the same stream.

    Returns (the new row block, 0 dropped).
    """
    if not isinstance(src, (tuple, list)):
        src, dst, w, valid = (src,), (dst,), (w,), (valid,)
    cat = lambda ts: torch.cat([t.reshape(-1) for t in ts])
    s, t, ww, ok = (cat(src).to(torch.int64), cat(dst).to(torch.int64),
                    cat(w).to(torch.float32), cat(valid))
    ok = ok & (s >= 0) & (t >= 0) & (s != t)
    s, t, ww = s[ok], t[ok], ww[ok]
    node, nbr, ww = torch.cat([s, t]), torch.cat([t, s]), torch.cat([ww, ww])
    rows = state.n
    p = mesh.size
    widths = emit_widths(rows * p, p, exact_weights)
    owner = node // rows
    words = pack_bit_fields(
        (node - owner * rows, nbr, _weight_field(ww, exact_weights)), widths)
    _, _, _, (got,) = comm.exchange(mesh, owner, to_wire(words))
    loc, nbr_r, field = unpack_bit_fields(from_wire(got), widths)
    w_r = _field_weight(field, exact_weights)
    if loc.shape[0] == 0:
        # one dead triple keeps the fold's shapes non-empty
        loc, nbr_r = loc.new_full((1,), -1), nbr_r.new_full((1,), -1)
        w_r = w_r.new_zeros((1,))
    state = acc_lib._fold_triples(state, loc, nbr_r, w_r, loc >= 0)
    return state, _no_drop(state.nbr.device)

