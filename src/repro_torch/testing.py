"""Test helpers: edge-for-edge comparison of two builds, and gloo ranks.

:class:`RankPool` starts p gloo ranks on the CPU once and runs jobs on
them (the mesh tests).  The rest compares two builds, for the tests and
``chip_smoke.py``.

Two builds of one config agree on every discrete choice (windows, leaders,
masks, comparison counts), but their similarity floats may differ by an
ulp or two (another summation order on another device or library).  Such
a difference can swap two candidates whose weights tie to within an ulp
at a node's slab boundary, and only there.  :func:`compare_builds`
counts edges present in one build only, and explains each by such a
near-tie or reports it as unexplained.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.spanner import Graph


def slab_boundary(nbr: np.ndarray, w: np.ndarray) -> np.ndarray:
    """(n,) weight of the last slot of each full slab row; -inf otherwise."""
    nbr = np.asarray(nbr)
    w = np.asarray(w, np.float32)
    return np.where(nbr[:, -1] >= 0, w[:, -1], -np.inf)


def compare_builds(g_a: Graph, g_b: Graph, bound_a: np.ndarray,
                   bound_b: np.ndarray, *, tol: float = 1e-6) -> dict:
    """Compare two graphs of one config; ``bound_*`` from :func:`slab_boundary`.

    An edge of one build missing from the other is a boundary near-tie if
    its weight lies within ``tol`` of the other build's slab boundary at
    one of its endpoints.  Returns counts and the largest weight
    difference over the common edges.
    """
    n = g_a.n
    key_a = g_a.src.astype(np.int64) * n + g_a.dst
    key_b = g_b.src.astype(np.int64) * n + g_b.dst
    _, ia, ib = np.intersect1d(key_a, key_b, assume_unique=True,
                               return_indices=True)

    def one_sided(g, key, common_idx, other_bound):
        alone = np.ones(key.shape[0], bool)
        alone[common_idx] = False
        w = g.w[alone].astype(np.float64)
        near = np.minimum(np.abs(w - other_bound[g.src[alone]]),
                          np.abs(w - other_bound[g.dst[alone]])) <= tol
        return int(alone.sum()), int(near.sum())

    only_a, ties_a = one_sided(g_a, key_a, ia, bound_b)
    only_b, ties_b = one_sided(g_b, key_b, ib, bound_a)
    dw = np.abs(g_a.w[ia].astype(np.float64) - g_b.w[ib])
    return {"edges_a": int(key_a.shape[0]), "edges_b": int(key_b.shape[0]),
            "only_a": only_a, "only_b": only_b,
            "boundary_ties": ties_a + ties_b,
            "unexplained": only_a + only_b - ties_a - ties_b,
            "max_weight_diff": float(dw.max()) if dw.size else 0.0}


_STOP = object()       # ends a rank's writer thread


class RankError(RuntimeError):
    """A job raised on a rank; the message holds the rank's traceback."""


def _rank_main(rank: int, world: int, path: str, conn, threads: int,
               sizes) -> None:
    """A pool rank: join the gloo group through ``path``, make the groups
    of the first ``s`` ranks for each mesh size, then run jobs."""
    import datetime
    import queue
    import threading
    import traceback

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import Mesh

    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    # every rank takes part in creating every group, member or not
    groups = {s: (None if s == world else dist.new_group(list(range(s))))
              for s in sizes}
    # a reader and a writer thread keep the pipe drained both ways, so
    # queued jobs and unread results never block the other side
    inbox, outbox = queue.Queue(), queue.Queue()

    def read():
        while True:
            msg = conn.recv()
            inbox.put(msg)
            if msg is None:
                return

    def write():
        while (item := outbox.get()) is not _STOP:
            conn.send(item)

    threads_ = [threading.Thread(target=f, daemon=True) for f in (read, write)]
    for t in threads_:
        t.start()
    try:
        while (msg := inbox.get()) is not None:
            fn, args, size = msg
            if rank >= size:
                outbox.put(None)
                continue
            try:
                mesh = Mesh.create(groups[size], device="cpu")
                outbox.put(fn(mesh, *args))
            except Exception:   # reported to the caller, who raises
                outbox.put(RankError(f"rank {rank} of {size}:\n"
                                     + traceback.format_exc()))
    finally:
        outbox.put(_STOP)
        threads_[1].join()
        dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks on the CPU, started once, that run jobs.

    The ranks meet through ``file://<rendezvous>`` (a path that does not
    exist yet), so pools of parallel test processes never share a port;
    each makes a group of its first ``s`` ranks for every size in
    ``sizes``.  ``run(fn, *args, size=p)`` calls ``fn(mesh, *args)`` on
    ranks ``0 .. p - 1`` (``mesh`` a CPU :class:`Mesh` of p ranks; ``fn``
    a module-level function, pickled by name) and returns their results
    in rank order; if any rank raises, it raises :class:`RankError` with
    that rank's traceback.  Use as a context manager, or ``close()``.
    """

    def __init__(self, world: int, rendezvous, *, sizes=(), threads: int = 1,
                 timeout: float = 300.0):
        import multiprocessing as mp
        # the ranks fork from a server that imported torch and the port
        # once, not once a rank
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(["repro_torch.core.builder",
                                    "repro_torch.testing"])
        self.world = world
        self.timeout = timeout
        sizes = tuple(sorted(set(sizes) | {world}))
        self._conns, self._procs = [], []
        self._queued: list = []
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_rank_main,
                               args=(rank, world, str(rendezvous), child,
                                     threads, sizes), daemon=True)
            proc.start()
            self._conns.append(parent)
            self._procs.append(proc)

    def submit(self, fn, *args, size: Optional[int] = None) -> None:
        """Queue ``fn(mesh, *args)`` on the ranks without waiting; its
        results come from :meth:`collect`, in submission order."""
        if not self._conns:
            raise RankError("the pool was closed (after an error?)")
        size = self.world if size is None else size
        for conn in self._conns:
            conn.send((fn, args, size))
        self._queued.append(size)

    def collect(self) -> list:
        """The results of the oldest submitted job, in rank order."""
        from multiprocessing.connection import wait
        size = self._queued.pop(0)
        out = {}
        pending = dict(enumerate(self._conns))
        while pending:
            ready = wait(list(pending.values()), self.timeout)
            if not ready:
                self.close(kill=True)
                raise RankError(f"ranks {sorted(pending)} gave no result in "
                                f"{self.timeout} s")
            for rank in [r for r, c in pending.items() if c in ready]:
                out[rank] = pending.pop(rank).recv()
                if isinstance(out[rank], RankError):
                    # the other ranks may wait in a collective for it
                    self.close(kill=True)
                    raise out[rank]
        return [out[r] for r in range(size)]

    def run(self, fn, *args, size: Optional[int] = None) -> list:
        """:meth:`submit` then :meth:`collect`."""
        self.submit(fn, *args, size=size)
        return self.collect()

    def close(self, kill: bool = False) -> None:
        for conn, proc in zip(self._conns, self._procs):
            if proc.is_alive() and not kill:
                try:
                    conn.send(None)
                except OSError:
                    pass
        for proc in self._procs:
            proc.join(timeout=0 if kill else 30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        self._conns, self._procs = [], []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
