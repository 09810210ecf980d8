"""The mesh's collectives: one rank a process under ``torch.distributed``.

The JAX package runs p devices in one process under ``shard_map`` and
reaches its collectives through ``repro.compat`` (``all_to_all``,
``psum_scatter``, ``axis_size``).  The port runs one rank a process, and
this module is its counterpart: the :class:`Mesh` handle, a metered
exact-size all-to-all, all-gather and all-reduce.

XLA needs static shapes, so the JAX package ships fixed-capacity buffers
and counts what overflows them.  Here every exchange is exact: a small
counts exchange (``counts_exchange``: one int64 a rank pair) tells each
rank how many rows it receives, then one ``all_to_all_single`` moves
exactly those rows, so nothing is ever dropped.

Every collective is metered in ``accumulator.transfer_stats``, this
rank's share, cross-rank bytes only (a rank's slice to itself never
leaves it, so every byte count is exactly 0 at p = 1):

  * ``all_to_all_calls`` / ``all_to_all_bytes``: the payload exchanges,
    counted as the JAX package counts its exchanges (bytes at the wire
    width: bit-packed sort keys and emit triples);
  * ``all_to_all_count_calls`` / ``_bytes``: the counts exchanges before
    them;
  * ``slot_scatter_calls`` / ``_bytes``: the sort's routing of sorted
    ids to their window slots' owners (the JAX package's unmetered
    reduce-scatter);
  * ``reshard_calls`` / ``_bytes``: the row moves of ``extend`` when
    the padded row layout changes (:func:`reshard_rows`);
  * ``all_gather_calls`` / ``_bytes`` and ``all_reduce_calls`` /
    ``_bytes``: splitter samples, rank counts, round counters and the
    slab gathers of ``finalize`` / ``checkpoint``;
  * ``state_gather_calls`` / ``_bytes``: on a paged mesh, the all-gather
    of a learned measure's embeddings into every rank's host store.

The process group's backend decides the transport: NCCL carries CUDA
tensors, gloo CPU tensors (the tests) and, through its own staging,
CUDA tensors.  A group that cannot carry tensors on the mesh's device
raises; nothing here copies to the host to get round it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph import accumulator as acc_lib

# the device types whose tensors each backend's collectives take
_CARRIES = {"nccl": ("cuda",), "gloo": ("cpu", "cuda")}


def _backend_for(group, device: torch.device) -> str:
    """The backend that carries ``device``'s tensors in ``group``: a plain
    name, or the entry for the device type of a "cpu:gloo,cuda:nccl"
    style mapping; raises if it cannot carry them."""
    name = dist.get_backend(group)
    if ":" in name:
        mapping = dict(part.split(":") for part in name.split(","))
        name = mapping.get(device.type, "")
    if device.type not in _CARRIES.get(name, ()):
        raise ValueError(
            f"the process group's backend {dist.get_backend(group)!r} "
            f"cannot carry {device.type} tensors (nccl carries cuda, gloo "
            "carries cpu and cuda); make a group for the mesh's device")
    return name


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group as the mesh build sees it: this process's rank in
    it, its size and the device this rank's tensors live on.

    ``Mesh.create()`` wraps the default group (after
    ``torch.distributed.init_process_group``) on CUDA, the current device;
    ``device="cpu"`` asks for the CPU, ``group=`` for another group.
    """

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: str

    @classmethod
    def create(cls, group=None, *, device: DeviceLike = None) -> "Mesh":
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "no process group: call torch.distributed."
                "init_process_group(...) on every rank before Mesh.create")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        rank = dist.get_rank(group)
        if rank < 0:
            raise ValueError("this process is not a member of the group")
        return cls(group=group, rank=rank, size=dist.get_world_size(group),
                   device=dev, backend=_backend_for(group, dev))


def _record(kind: str, nbytes: int) -> None:
    acc_lib.transfer_stats[f"{kind}_calls"] += 1
    acc_lib.transfer_stats[f"{kind}_bytes"] += int(nbytes)


def _row_bytes(t: torch.Tensor) -> int:
    return t.element_size() * math.prod(t.shape[1:])


def counts_exchange(mesh: Mesh, send_counts: Sequence[int]) -> List[int]:
    """How many rows each rank will send this one, from how many this one
    sends each rank (one int64 a rank pair, metered as a count call)."""
    p = mesh.size
    send = torch.tensor(list(send_counts), dtype=torch.int64,
                        device=mesh.device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    _record("all_to_all_count", 8 * (p - 1))
    return recv.tolist()


def all_to_all(mesh: Mesh, send: torch.Tensor, send_counts: Sequence[int],
               recv_counts: Sequence[int], *,
               kind: str = "all_to_all") -> torch.Tensor:
    """Exact-size all-to-all of rows: ``send``'s rows, grouped by
    destination rank in rank order (``send_counts``), are delivered, and
    the rows from every rank come back grouped by source in rank order
    (``recv_counts``).  Metered under ``kind``: this rank's rows to other
    ranks times their byte width."""
    send = send.contiguous()
    send_counts, recv_counts = list(send_counts), list(recv_counts)
    out = send.new_empty((sum(recv_counts),) + tuple(send.shape[1:]))
    dist.all_to_all_single(out, send, recv_counts, send_counts,
                           group=mesh.group)
    cross = sum(send_counts) - send_counts[mesh.rank]
    _record(kind, cross * _row_bytes(send))
    return out


def owner_order(owner: torch.Tensor, p: int):
    """(order, counts): a stable order that groups rows by owner rank
    (rows keep their order within a group) and the rows a rank."""
    order = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=p)[:p].tolist()
    return order, counts


def exchange(mesh: Mesh, owner: torch.Tensor, *payloads: torch.Tensor):
    """Send each row of the ``payloads`` to rank ``owner``: one counts
    exchange, then one metered all-to-all a payload.  Returns the stable
    owner order of the sent rows, the per-rank send and receive counts
    and the received payloads (grouped by source rank)."""
    order, send_counts = owner_order(owner, mesh.size)
    recv_counts = counts_exchange(mesh, send_counts)
    received = [all_to_all(mesh, t[order], send_counts, recv_counts)
                for t in payloads]
    return order, send_counts, recv_counts, received


def layout_rows(n: int, p: int) -> int:
    """Rows a rank of the padded layout for ``n`` points: rank r holds
    rows ``[r, r + 1) * ceil(n / p)``."""
    return -(-n // p)


def reshard_rows(mesh: Mesh, block: torch.Tensor, n_old: int, n_new: int,
                 fill) -> torch.Tensor:
    """This rank's block of the layout for ``n_new`` points, from its
    block ``block`` of the layout for ``n_old`` (``n_new >= n_old``).

    The first ``n_old`` rows move to their new owners in one all-to-all
    whose sizes every rank knows from the two layouts (no counts
    exchange); the rows past ``n_old`` and the pad rows read ``fill``.
    Only this rank's rows ever reach it.
    """
    p, r = mesh.size, mesh.rank
    old, new = layout_rows(n_old, p), layout_rows(n_new, p)

    def overlap(a_lo, a_hi, b_lo, b_hi):
        return max(0, min(a_hi, b_hi) - max(a_lo, b_lo))

    mine_lo = r * old
    send_counts = [overlap(mine_lo, min(mine_lo + old, n_old), q * new,
                           (q + 1) * new) for q in range(p)]
    recv_counts = [overlap(q * old, min((q + 1) * old, n_old), r * new,
                           (r + 1) * new) for q in range(p)]
    got = all_to_all(mesh, block[:sum(send_counts)], send_counts,
                     recv_counts, kind="reshard")
    out = block.new_full((new,) + tuple(block.shape[1:]), fill)
    out[:got.shape[0]] = got
    return out


def all_gather(mesh: Mesh, t: torch.Tensor, *,
               kind: str = "all_gather") -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on every rank), in rank order;
    metered under ``kind``."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    _record(kind, (mesh.size - 1) * t.numel() * t.element_size())
    return out


def all_gather_rows(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """The row blocks of every rank (equal row counts), concatenated."""
    return torch.cat(all_gather(mesh, block))


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks (a new tensor)."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=mesh.group)
    _record("all_reduce", (mesh.size - 1) * out.numel() * out.element_size())
    return out


def any_rank(mesh: Mesh, flag: torch.Tensor) -> bool:
    """Whether ``flag`` (a bool scalar tensor) is true on any rank."""
    return bool(all_reduce_sum(mesh, flag.reshape(1).to(torch.int32)) > 0)
