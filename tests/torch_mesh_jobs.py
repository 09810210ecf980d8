"""Jobs the mesh tests run on gloo ranks (``repro_torch.testing.RankPool``).

Each job takes the rank's ``Mesh`` first, imports only the port, and
returns plain numpy / Python results, which the test process holds
against the JAX package.  Inputs are whole arrays; a job cuts its rank's
share itself.
"""

import numpy as np

from repro_torch import GraphBuilder
from repro_torch.graph import accumulator as acc_lib


def _share(a, mesh):
    """This rank's contiguous part of an array (parts differ by <= 1 row)."""
    return np.array_split(np.asarray(a), mesh.size)[mesh.rank]


def sort_job(mesh, keys, payload):
    import torch
    from repro_torch.distributed.sorter import distributed_sort
    k, pay, valid, dropped = distributed_sort(
        torch.from_numpy(_share(keys, mesh)),
        torch.from_numpy(_share(payload, mesh)), mesh)
    return k.numpy(), pay.numpy(), valid.numpy(), int(dropped.sum())


def argsort_job(mesh, keys, gids, n_out):
    import torch
    from repro_torch.distributed.sorter import distributed_argsort
    perm, dropped = distributed_argsort(
        torch.from_numpy(_share(keys, mesh)),
        torch.from_numpy(_share(gids, mesh)), mesh, n_out)
    return perm.numpy(), int(dropped.sum())


def window_blocks_job(mesh, x, cfg, rep):
    """This rank's window slot block of one repetition (the mesh
    backend's sketch, keys and sample sort), and the length of its run
    of the sort's output."""
    from repro_torch.core import lsh
    from repro_torch.core.builder import _sketch_keys
    from repro_torch.core.stars import _rep_seed
    from repro_torch.distributed.sorter import distributed_sort
    b = GraphBuilder(x, cfg, mesh=mesh)
    gid, bucket = b._backend._sort_round(rep)
    words = lsh.sketch(b.feature_store.features, cfg.family,
                       rep_seed=_rep_seed(cfg, rep))
    keys, gids = _sketch_keys(cfg, b.n, words, rep,
                              mesh.rank * b.feature_store.n)
    run = distributed_sort(keys, gids, mesh)[1]
    return gid.numpy(), bucket.numpy(), int(run.shape[0])


def build_job(mesh, x, cfg, reps):
    """add_reps + finalize on the mesh, with the stats, this rank's scored
    window rows, its transfer counters and the slab boundaries."""
    from repro_torch.testing import slab_boundary
    acc_lib.reset_transfer_stats()
    b = GraphBuilder(x, cfg, mesh=mesh).add_reps(reps)
    g = b.finalize()
    state = b.slab_state()
    return {"graph": g, "rank_scored": b._backend.rank_scored_windows,
            "transfer": dict(acc_lib.transfer_stats),
            "bound": slab_boundary(state.nbr.numpy(), state.w.numpy())}


def _owned(b):
    """(rows, storage bytes, tensor bytes) of the session's device
    tensors: the feature block and the slabs (on a mesh, this rank's)."""
    return [(t.shape[0], t.untyped_storage().nbytes(),
             t.numel() * t.element_size())
            for t in (b.feature_store.features.dense, b._state.nbr,
                      b._state.w, b._state.ver)]


def session_job(mesh, x, n0, cfg, reps):
    """add_reps on the first n0 points, extend by the rest (with the
    automatic refresh), two manual refresh rounds: the graph, the slab
    image and what the session's tensors own."""
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    b = GraphBuilder(x[:n0], cfg, **kw).add_reps(reps)
    b.extend(x[n0:], reps=reps)
    b.refresh_reps(2, fraction=0.7)
    state = b.slab_state()
    return b.finalize(), state.nbr.numpy(), state.w.numpy(), _owned(b)


def checkpoint_job(mesh, x, n0, cfg, reps):
    """A session on the first n0 points, extended, refreshed, then
    checkpointed; returns the checkpoint."""
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    b = GraphBuilder(x[:n0], cfg, **kw).add_reps(reps)
    b.extend(x[n0:], reps=2)
    b.refresh_reps(1)
    return b.checkpoint()


def resume_job(mesh, x, cfg, ckpt, refresh=True):
    """Restore ``ckpt``, checkpoint again at once (the round trip), then
    finish the session (with ``refresh``, two refresh rounds first) with
    two repetitions: the round trip, the graph, the slab boundaries and
    what the restored session's tensors owned."""
    from repro_torch.testing import slab_boundary
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    b = GraphBuilder.restore(x, cfg, ckpt, **kw)
    owned = _owned(b)
    again = b.checkpoint()
    if refresh:
        b.refresh_reps(2, fraction=0.8)
    b.add_reps(2)
    state = b.slab_state()
    return again, b.finalize(), slab_boundary(state.nbr.numpy(),
                                              state.w.numpy()), owned


def cluster_job(mesh, x, cfg, ckpt, affinity_args):
    """Restore a slab image onto the mesh and cluster it: components,
    then affinity under each argument set; with the transfer counters."""
    acc_lib.reset_transfer_stats()
    b = GraphBuilder.restore(x, cfg, ckpt, mesh=mesh)
    cc, cc_info = b.cluster("components", return_info=True)
    affinity = [b.cluster("affinity", return_info=True, **args)
                for args in affinity_args]
    return cc, cc_info, affinity, dict(acc_lib.transfer_stats)



def _state_owned(b):
    """(rows, storage bytes, tensor bytes) of a resident learned mesh
    session's state block."""
    t = b._backend._state_tab
    return (t.shape[0], t.untyped_storage().nbytes(),
            t.numel() * t.element_size())


def paged_session_job(mesh, x, more, cfg, reps, ckpt_reps=0,
                      cluster=False):
    """add_reps, extend by ``more`` (2 repetitions), one refresh round,
    then (with ``cluster``) both clusterings, and a checkpoint
    (optionally after ``ckpt_reps`` more repetitions): the graph, the
    slab image, the labels, this rank's transfer counters, host syncs
    and scored rows."""
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    acc_lib.reset_transfer_stats()
    b = GraphBuilder(x, cfg, **kw).add_reps(reps)
    b.extend(more, reps=2)
    b.refresh_reps(1)
    ts = dict(acc_lib.transfer_stats)
    g = b.finalize()
    state = b.slab_state()
    labels = ((b.cluster("components"),
               b.cluster("affinity", return_info=True, target_clusters=6))
              if cluster else None)
    backend = b._backend
    out = {"graph": g, "nbr": state.nbr.numpy(), "w": state.w.numpy(),
           "labels": labels, "transfer": ts,
           "host_syncs": getattr(backend, "host_syncs", 0),
           "rank_scored": getattr(backend, "rank_scored_windows", None),
           "pairs_rounds": backend.pairs_rounds}
    if ckpt_reps:
        b.add_reps(ckpt_reps)
    out["ckpt"] = b.checkpoint()
    return out


def paged_resume_job(mesh, x, more, cfg, ckpt, reps):
    """Restore a paged session's checkpoint (taken after the extend) and
    run ``reps`` repetitions: the graph."""
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    allx = np.concatenate([x, more])
    b = GraphBuilder.restore(allx, cfg, ckpt, **kw).add_reps(reps)
    return b.finalize()


def learned_build_job(mesh, x, cfg, measure, reps):
    """add_reps + finalize with a measure (learned or closed-form):
    the graph, the slab image and this rank's transfer counters."""
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    acc_lib.reset_transfer_stats()
    b = GraphBuilder(x, cfg, measure=measure, **kw).add_reps(reps)
    ts = dict(acc_lib.transfer_stats)
    state = b.slab_state()
    return {"graph": b.finalize(), "nbr": state.nbr.numpy(),
            "w": state.w.numpy(), "transfer": ts}


def learned_session_job(mesh, x, n0, cfg, measure, reps):
    """A resident learned session: ``reps`` repetitions on the first n0
    points, an extend by the rest (one repetition), checkpoint, restore
    (on the same ranks) and one more repetition: the graphs after the
    extend and at the end, and the state block each rank owned after the
    extend and after the restore."""
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    b = GraphBuilder(x[:n0], cfg, measure=measure, **kw).add_reps(reps)
    b.extend(x[n0:], reps=1)
    owned = [] if mesh is None else [_state_owned(b)]
    g_ext = b.finalize()
    ckpt = b.checkpoint()
    b = GraphBuilder.restore(x, cfg, ckpt, measure=measure, **kw)
    b.add_reps(1)
    if mesh is not None:
        owned.append(_state_owned(b))
    return g_ext, b.finalize(), owned


def _records(d):
    return (d.rows.tolist(), d.node.tolist(), d.nbr.tolist(),
            d.w.view(np.int32).tolist(), d.sign.tolist())


def delta_job(mesh, base, extra, cfg):
    """finalize(delta=True) after add_reps and after an extend by
    ``extra`` (2 repetitions): the two deltas' Z-set records."""
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    b = GraphBuilder(base, cfg, **kw).add_reps(cfg.r)
    d0 = b.finalize(delta=True)
    b.extend(extra, reps=2)
    d1 = b.finalize(delta=True)
    return _records(d0), _records(d1), int(d1.rows.shape[0])


def delta_chain_job(mesh, base, extra, cfg):
    """A full checkpoint after add_reps, an extend, then a delta
    checkpoint and a full one: the three, and the delta stream's
    position."""
    b = GraphBuilder(base, cfg, mesh=mesh).add_reps(cfg.r)
    full = b.checkpoint()
    b.extend(extra, reps=2)
    dckpt = b.checkpoint(delta=True)
    return full, dckpt, b.checkpoint(), b.delta_seq
