"""The mesh session's lifecycle: extend, refresh, checkpoints across a reshard.

On p = 2 and 4 gloo ranks (``repro_torch.testing.RankPool``): add
repetitions on 487 of ``mnist_like_points(n=600, ...)`` (not divisible
by any p), extend by the rest (the padded row layout moves: features and
slabs reshard), with the automatic refresh policy and two manual refresh
rounds, for the four windowed sources of ``tests/test_mesh_parity.py``
and the prefilter build.  The JAX package's own mesh extend / refresh
fails on this tree (``ROADMAP.md`` §3), and the port's single-device
session is held to JAX's in ``tests/test_torch_session.py``; so the mesh
session is held to the port's single-device one: equal edges (weight
bits included), stats and slab images; after the extend, and after a
restore, each rank's feature block and slabs hold its ceil(n / p) rows
in storage of their own.  A checkpoint cut on 4 ranks
restores onto 2 and onto one device bit for bit, and the three finished
sessions are equal; a JAX single-device checkpoint restores onto the
port's mesh through ``checkpoint_from_reference`` and finishes as the
JAX session does.  The delta stream (``tests/test_service.py:371`` and
``:401``): ``finalize(delta=True)`` on 2 and 4 ranks, before and after
an extend, gives the single-device session's records, and a delta chain
cut on 4 ranks replays into a one-device session bit for bit.
"""

import numpy as np
import pytest

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.core.builder import GraphBuilder as JBuilder
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro_torch.core.convert import (checkpoint_from_reference,
                                      config_from_reference)
from repro_torch.testing import RankPool, compare_builds, slab_boundary

import torch_mesh_jobs as jobs

pytestmark = pytest.mark.torch_port

N, N0 = 600, 487
SOURCES = {
    "lsh-stars": ("lsh", "stars", 8, 128, {}),
    "sorting-stars": ("sorting", "stars", 16, 64, {}),
    "lsh-allpairs": ("lsh", "allpairs", 8, 64, {}),
    "sorting-allpairs": ("sorting", "allpairs", 16, 32, {}),
    "prefilter": ("sorting", "stars", 16, 64,
                  dict(hamming_prefilter_bits=64, hamming_prefilter_max=24)),
}


def _jcfg(source, **kw):
    mode, scoring, m, window, extra = SOURCES[source]
    base = dict(mode=mode, scoring=scoring, family=JHash("simhash", m=m),
                measure="cosine", r=3, window=window, leaders=8,
                degree_cap=20, seed=3, refresh_rate=0.5,
                refresh_fraction=0.5, **extra)
    base.update(kw)
    return JConfig(**base)


def _edges(g):
    return dict(zip(zip(g.src.tolist(), g.dst.tolist()),
                    np.asarray(g.w, np.float32).tolist()))


def _without_dropped(stats):
    return {k: v for k, v in stats.items() if k != "dropped"}


class _Results:
    """The mesh sessions, queued on the ranks, and their single-device
    counterparts built meanwhile."""

    def __init__(self, pool):
        feats, _ = mnist_like_points(n=N, d=24, classes=6, spread=0.25,
                                     seed=0)
        x = self.x = np.asarray(feats.dense)
        order = [(s, p) for s in SOURCES for p in (2, 4)]
        for source, p in order:
            tc = config_from_reference(_jcfg(source))
            pool.submit(jobs.session_job, x, N0, tc, 3, size=p)
        # the reshard: a checkpoint after an extend and a refresh on 4 ranks
        self.ck_cfg = config_from_reference(
            _jcfg("sorting-stars", refresh_rate=0.3))
        pool.submit(jobs.checkpoint_job, x, 500, self.ck_cfg, 3, size=4)
        self.single = {s: jobs.session_job(
            None, x, N0, config_from_reference(_jcfg(s)), 3)
            for s in SOURCES}
        self.mesh = {key: pool.collect() for key in order}
        self.ckpt = pool.collect()[0]
        pool.submit(jobs.resume_job, x, self.ck_cfg, self.ckpt, size=4)
        pool.submit(jobs.resume_job, x, self.ck_cfg, self.ckpt, size=2)
        # a JAX single-device session's checkpoint, finished on the mesh
        jc = _jcfg("sorting-stars", refresh_rate=0.0)
        jb = JBuilder(x, jc).add_reps(3)
        self.j_ckpt = checkpoint_from_reference(jb.checkpoint())
        j_cfg = config_from_reference(jc)
        for p in (2, 4):
            pool.submit(jobs.resume_job, x, j_cfg, self.j_ckpt, False,
                        size=p)
        self.resumed_single = jobs.resume_job(None, x, self.ck_cfg,
                                              self.ckpt)
        jb.add_reps(2)
        self.j_end = (jb.finalize(), slab_boundary(
            *j_acc.to_host(jb.slab_state())[:2]))
        self.resumed = {4: pool.collect(), 2: pool.collect()}
        self.j_resumed = {2: pool.collect(), 4: pool.collect()}
        # the delta stream (tests/test_service.py:371-446's session)
        feats, _ = mnist_like_points(n=402, d=24, classes=6, spread=0.25,
                                     seed=0)
        d = self.delta_x = np.asarray(feats.dense)
        self.delta_cfg = config_from_reference(JConfig(
            mode="sorting", scoring="stars", family=JHash("simhash", m=16),
            measure="cosine", r=4, window=32, leaders=8, degree_cap=16,
            seed=3))
        for p in (2, 4):
            pool.submit(jobs.delta_job, d[:396], d[396:], self.delta_cfg,
                        size=p)
        pool.submit(jobs.delta_chain_job, d[:396], d[396:], self.delta_cfg,
                    size=4)
        self.delta_single = jobs.delta_job(None, d[:396], d[396:],
                                           self.delta_cfg)
        self.delta = {2: pool.collect(), 4: pool.collect()}
        self.chain = pool.collect()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("mesh") / "rendezvous",
                  sizes=(2, 4)) as pool:
        yield _Results(pool)


def _assert_owns_its_block(owned, n, p):
    """Each tensor holds its rank's ceil(n / p) rows in storage of its
    own: no view keeps the whole table alive."""
    for rows, storage, nbytes in owned:
        assert rows == -(-n // p) and storage == nbytes, owned


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("source", list(SOURCES))
def test_mesh_extend_and_refresh_equal_single_device(results, source, p):
    g1, nbr1, w1, _ = results.single[source]
    for g, nbr, w, owned in results.mesh[(source, p)]:
        _assert_owns_its_block(owned, N, p)
        assert _edges(g) == _edges(g1)
        assert _without_dropped(g.stats) == g1.stats
        assert g.stats["dropped"] == 0
        np.testing.assert_array_equal(nbr, nbr1)
        np.testing.assert_array_equal(w, w1)
    stats = g1.stats
    assert stats["refresh_reps"] == 3
    assert 0 < stats["refresh_comparisons"] < stats["comparisons"]


def test_checkpoint_restores_bit_exact_across_a_reshard(results):
    ck = results.ckpt
    assert ck.nbr.shape[0] == N and ck.refresh_watermark == 500
    assert abs(ck.refresh_credit - 0.6) < 1e-9 and ck.refresh_reps == 1
    finished = []
    for p in (4, 2):
        for *_, owned in results.resumed[p]:
            _assert_owns_its_block(owned, N, p)
    for again, g, _, _ in (results.resumed[4] + results.resumed[2]
                           + [results.resumed_single]):
        for name in ("nbr", "w", "ver", "refresh_age"):
            np.testing.assert_array_equal(getattr(again, name),
                                          getattr(ck, name))
        assert (again.refresh_watermark, again.refresh_reps,
                again.refresh_credit, again.reps_done) == \
            (ck.refresh_watermark, ck.refresh_reps, ck.refresh_credit,
             ck.reps_done)
        finished.append(g)
    for g in finished[1:]:
        assert _edges(g) == _edges(finished[0])
        assert _without_dropped(g.stats) == _without_dropped(
            finished[0].stats)


@pytest.mark.parametrize("p", [2, 4])
def test_jax_checkpoint_resumes_on_the_mesh(results, p):
    g_j, bound_j = results.j_end
    for again, g, bound, owned in results.j_resumed[p]:
        _assert_owns_its_block(owned, N, p)
        np.testing.assert_array_equal(again.nbr, results.j_ckpt.nbr)
        np.testing.assert_array_equal(again.w, results.j_ckpt.w)
        diff = compare_builds(g, g_j, bound, bound_j, tol=1e-6)
        assert diff["unexplained"] == 0 and diff["boundary_ties"] <= 4, diff
        assert diff["max_weight_diff"] <= 1e-6, diff
        assert _without_dropped(g.stats) == g_j.stats


@pytest.mark.parametrize("p", [2, 4])
def test_mesh_delta_stream_equals_single_device(results, p):
    """finalize(delta=True) on p ranks, before and after an extend, gives
    the single-device session's Z-set records: changed rows, record keys,
    weight bits (tests/test_service.py:371)."""
    d0, d1, rows1 = results.delta_single
    assert rows1 > 0
    for got in results.delta[p]:
        assert got == (d0, d1, rows1)


def test_mesh_delta_chain_replays_on_one_device(results):
    """A full checkpoint cut on 4 ranks, an extend, a delta checkpoint:
    replayed into a one-device session it is the mesh's live image bit
    for bit, at the same stream position, and nothing re-ships
    (tests/test_service.py:401)."""
    from repro_torch import GraphBuilder
    for full, dckpt, live, seq in results.chain:
        assert len(dckpt.delta_chain) >= 1
        rb = GraphBuilder.restore(results.delta_x, results.delta_cfg, dckpt,
                                  base=full, device="cpu")
        assert rb.delta_seq == seq
        again = rb.checkpoint()
        for name in ("nbr", "w", "ver"):
            np.testing.assert_array_equal(getattr(again, name),
                                          getattr(live, name))
        assert rb.finalize(delta=True).num_records == 0
