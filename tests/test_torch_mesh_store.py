"""The paged store and the learned measure on a mesh (``GraphBuilder(mesh=)``).

On 1, 2 and 4 gloo ranks (``repro_torch.testing.RankPool``, one pool of
4 for the module; the jobs in ``tests/torch_mesh_jobs.py``):

  * the paged store at ``tests/test_store.py:233-285``'s shapes: 602
    points, an extend by 140, one refresh round, d = 24, the four
    windowed sources, pages of 32 rows and a pool of 4 x 32 x 24 x 4
    bytes, at p = 4 (SortingLSH Stars and the dot measure at p = 2 as
    well).  Against the port's single-device resident session: equal
    edges (weight bits included), slab images, comparisons and
    ``scored_windows``.  ``tests/test_torch_store.py`` holds that
    session to the JAX package's single-device session at these shapes
    and configs, all four sources (the JAX paged mesh at two devices
    fails on this tree).  Page faults on every rank, the peak pool
    within the pool, no fetch bytes, rounds not paired; for SortingLSH
    Stars both clusterings equal the single device's, and a checkpoint
    cut on 4 ranks finishes on 2 and on one device as on the single
    device.  ``exact_weights=False`` equals the resident mesh that ships
    the same bfloat16 weights.
  * the learned measure at ``tests/test_measure.py:395-460``'s shapes
    (n = 300, d = 64, E = 8, ``pair_features='embed'``; 2 repetitions,
    not 4: every repetition pays a whole fixed-shape scoring chunk on
    the CPU), resident at p = 1 and 2, paged at p = 4: edges and
    comparisons equal to the single-device build's (the port's bit for
    bit; JAX's up to near-ties, the two-tower scores within rtol = atol
    = 1e-5 as in ``tests/test_torch_measure.py``); the wire diet: 0
    payload bytes at p = 1, and at p = 2 fewer than the cosine build's
    on the same points; on 4 ranks a resident session's state block
    holds only its rank's rows after an extend and after a restore.
"""

import dataclasses

import numpy as np
import pytest

import repro.core  # noqa: F401  (imports repro's modules in a working order)
import jax
from repro.core import GraphBuilder as JBuilder
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro.similarity import learned as j_learned
from repro.similarity.measure import LearnedMeasure as JLearnedMeasure
from repro_torch import LearnedMeasure
from repro_torch.core.convert import (config_from_reference,
                                      learned_params_from_reference)
from repro_torch.similarity import LearnedSimilarity, TwoTowerConfig
from repro_torch.testing import RankPool, compare_builds, slab_boundary

import torch_mesh_jobs as jobs

pytestmark = pytest.mark.torch_port

SIZES = (2, 4)
# tests/test_store.py:245-248: mode, scoring, M, window, reps
PAGED = {"lsh-stars": ("lsh", "stars", 8, 8, 4),
         "sorting-stars": ("sorting", "stars", 16, 16, 4),
         "lsh-allpairs": ("lsh", "allpairs", 8, 8, 3),
         "sorting-allpairs": ("sorting", "allpairs", 16, 8, 3)}
POOL = 4 * 32 * 24 * 4
# the sources at p = 4 (uneven blocks); SortingLSH Stars, whose sessions
# also cluster and checkpoint (the clustering programs do not depend on
# the source), and the dot measure at p = 2 as well
PAGED_SIZES = {"sorting-stars": SIZES, "dot": (2,)}
CLUSTERED = "sorting-stars"
# (store, p) of the learned builds: p = 1 crosses nothing; the wire diet
# is held at p = 2, the paged learned mesh at p = 4
LEARNED_CASES = (("resident", 1), ("resident", 2), ("paged", 4))
N_LEARNED, D_LEARNED, E_LEARNED, N0_LEARNED = 300, 64, 8, 250
LEARNED_R = 2


def _jcfg(source, **kw):
    mode, scoring, m, window, reps = PAGED[source]
    return JConfig(mode=mode, scoring=scoring, family=JHash("simhash", m=m),
                   measure="cosine", r=reps, window=window, leaders=4,
                   degree_cap=12, seed=7, refresh_fraction=0.5, **kw)


def _paged(cfg):
    return dataclasses.replace(cfg, feature_store="paged",
                               feature_page_rows=32, feature_pool_bytes=POOL)


def _edges(g):
    return dict(zip(zip(g.src.tolist(), g.dst.tolist()),
                    np.asarray(g.w, np.float32).view(np.int32).tolist()))


def _without_dropped(stats):
    return {k: v for k, v in stats.items() if k != "dropped"}


def _learned_models():
    kw = dict(in_dim=D_LEARNED, embed_dim=E_LEARNED, tower_hidden=16,
              head_hidden=16, use_set_features=False, pair_features="embed")
    j_model = j_learned.LearnedSimilarity(j_learned.TwoTowerConfig(**kw))
    j_params = j_model.init(jax.random.key(0))
    t_params = learned_params_from_reference(
        {k: np.asarray(v) for k, v in j_params.items()})
    return (JLearnedMeasure(j_model, j_params),
            LearnedMeasure(LearnedSimilarity(TwoTowerConfig(**kw)),
                           t_params))


def _learned_jcfg(**kw):
    # tests/test_measure.py:404's config at LEARNED_R repetitions
    return JConfig(measure=kw.pop("measure", "learned"), r=LEARNED_R,
                   window=16, leaders=4, degree_cap=8, seed=3, **kw)


class _Results:
    """The mesh jobs, queued on the ranks first; the single-device
    references (the port's and JAX's) built while they run."""

    def __init__(self, pool):
        feats, _ = mnist_like_points(n=602, d=24, classes=6, spread=0.25,
                                     seed=0)
        more, _ = mnist_like_points(n=140, d=24, classes=6, spread=0.25,
                                    seed=1)
        x, more = np.asarray(feats.dense), np.asarray(more.dense)
        rng = np.random.default_rng(0)
        xl = np.asarray(rng.normal(size=(N_LEARNED, D_LEARNED)), np.float32)
        j_meas, t_meas = _learned_models()
        t_learned = config_from_reference(_learned_jcfg())
        t_cosine = config_from_reference(_learned_jcfg(measure="cosine"))
        paged_cases = {s: _paged(config_from_reference(_jcfg(s)))
                       for s in PAGED}
        paged_cases["dot"] = dataclasses.replace(
            paged_cases["sorting-stars"], measure="dot")
        bf16 = dataclasses.replace(paged_cases["sorting-stars"],
                                   exact_weights=False)
        queue = []

        def submit(key, fn, *args, size):
            pool.submit(fn, *args, size=size)
            queue.append(key)

        for name, cfg in paged_cases.items():
            for p in PAGED_SIZES.get(name, (4,)):
                submit(("paged", name, p), jobs.paged_session_job, x, more,
                       cfg, cfg.r, 2 if name == CLUSTERED else 0,
                       name == CLUSTERED, size=p)
        submit(("bf16", "paged"), jobs.paged_session_job, x, more, bf16,
               bf16.r, size=4)
        submit(("bf16", "resident"), jobs.paged_session_job, x, more,
               dataclasses.replace(bf16, feature_store="resident"), bf16.r,
               size=4)
        for store, p in LEARNED_CASES:
            cfg = dataclasses.replace(
                t_learned, feature_store=store, feature_page_rows=32,
                feature_pool_bytes=4 * 32 * D_LEARNED * 4)
            submit(("learned", store, p), jobs.learned_build_job, xl, cfg,
                   t_meas, cfg.r, size=p)
        for p in (1, 2):
            submit(("cosine", p), jobs.learned_build_job, xl, t_cosine,
                   None, t_cosine.r, size=p)
        submit(("learned-session", 4), jobs.learned_session_job, xl,
               N0_LEARNED, t_learned, t_meas, 2, size=4)

        # the references, while the ranks work
        self.single = {}
        for name, cfg in paged_cases.items():
            resident = dataclasses.replace(cfg, feature_store="resident")
            self.single[name] = jobs.paged_session_job(
                None, x, more, resident, cfg.r, 0, name == CLUSTERED)
        self.learned_single = jobs.learned_build_job(None, xl, t_learned,
                                                     t_meas, t_learned.r)
        jb = JBuilder(xl, _learned_jcfg(), measure=j_meas).add_reps()
        nbr, w, _ = j_acc.to_host(jb.slab_state())
        self.learned_jax = (jb.finalize(), slab_boundary(nbr, w))
        self.learned_session = jobs.learned_session_job(
            None, xl, N0_LEARNED, t_learned, t_meas, 2)

        self.mesh = {key: pool.collect() for key in queue}
        # a checkpoint cut on 4 ranks (after the extend, the refresh and
        # two more repetitions) finishes on 2 ranks and on one device
        self.ckpt = self.mesh[("paged", CLUSTERED, 4)][0]["ckpt"]
        self.ckpt_cfg = paged_cases[CLUSTERED]
        pool.submit(jobs.paged_resume_job, x, more, self.ckpt_cfg,
                    self.ckpt, 2, size=2)
        self.resumed_single = jobs.paged_resume_job(
            None, x, more, self.ckpt_cfg, self.ckpt, 2)
        self.resumed = pool.collect()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("mesh") / "rendezvous",
                  sizes=(1,) + SIZES) as pool:
        yield _Results(pool)


@pytest.mark.parametrize("source,p", [(s, p) for s in list(PAGED) + ["dot"]
                                      for p in PAGED_SIZES.get(s, (4,))])
def test_paged_mesh_session_equals_single_device(results, source, p):
    one = results.single[source]
    g1 = one["graph"]
    assert g1.num_edges > 0
    for out in results.mesh[("paged", source, p)]:
        g = out["graph"]
        assert _edges(g) == _edges(g1)
        assert _without_dropped(g.stats) == g1.stats
        assert g.stats["dropped"] == 0
        np.testing.assert_array_equal(out["nbr"], one["nbr"])
        np.testing.assert_array_equal(out["w"].view(np.int32),
                                      one["w"].view(np.int32))
        if source == CLUSTERED:
            # both clusterings on the row-sharded slabs
            np.testing.assert_array_equal(out["labels"][0],
                                          one["labels"][0])
            (af, info), (af1, info1) = out["labels"][1], one["labels"][1]
            np.testing.assert_array_equal(af, af1)
            assert info == info1
        ts = out["transfer"]
        assert ts["feature_page_faults"] > 0
        assert 0 < ts["feature_page_peak_bytes"] <= POOL
        assert out["host_syncs"] > 0 and not out["pairs_rounds"]
        # the store serves the fetch: no feature row crosses the ranks;
        # the payload is the sort's keys and the emit's triples
        assert ts["all_to_all_calls"] == 2 * g.stats["reps"]
    scored = [out["rank_scored"] for out in results.mesh[("paged", source,
                                                          p)]]
    assert sum(scored) == g1.stats["scored_windows"]


def test_paged_checkpoint_restores_across_rank_counts(results):
    g1 = results.resumed_single
    assert g1.num_edges > 0
    for g in results.resumed:
        assert _edges(g) == _edges(g1)
        assert _without_dropped(g.stats) == _without_dropped(g1.stats)


def test_paged_bf16_wire_equals_resident_mesh(results):
    """exact_weights=False ships bfloat16 weights: the paged mesh folds
    the same triples as the resident mesh (whose rounds are paired)."""
    paged, resident = results.mesh[("bf16", "paged")], \
        results.mesh[("bf16", "resident")]
    for a, b in zip(paged, resident):
        assert _edges(a["graph"]) == _edges(b["graph"])
        np.testing.assert_array_equal(a["nbr"], b["nbr"])
        np.testing.assert_array_equal(a["w"].view(np.int32),
                                      b["w"].view(np.int32))
    assert _edges(paged[0]["graph"]) != _edges(
        results.single["sorting-stars"]["graph"])


@pytest.mark.parametrize("store,p", LEARNED_CASES)
def test_learned_mesh_equals_single_device(results, store, p):
    one = results.learned_single
    g1 = one["graph"]
    assert g1.num_edges > 0
    for out in results.mesh[("learned", store, p)]:
        assert _edges(out["graph"]) == _edges(g1)
        assert _without_dropped(out["graph"].stats) == g1.stats
        np.testing.assert_array_equal(out["w"].view(np.int32),
                                      one["w"].view(np.int32))
        ts = out["transfer"]
        if store == "paged":
            assert ts["embed_page_faults"] > 0
            # the embeddings were all-gathered into every host store
            assert ts["state_gather_calls"] == 1
            assert (ts["state_gather_bytes"] > 0) == (p > 1)
    g_j, bound_j = results.learned_jax
    out = results.mesh[("learned", store, p)][0]
    assert out["graph"].stats["comparisons"] == g_j.stats["comparisons"]
    diff = compare_builds(out["graph"], g_j,
                          slab_boundary(out["nbr"], out["w"]), bound_j,
                          tol=1e-5)
    assert diff["unexplained"] == 0, diff
    # the two-tower scores' tolerance against JAX (rtol = atol = 1e-5,
    # tests/test_torch_measure.py); these scores reach |w| ~ 23
    g = out["graph"]
    n = g.n
    _, ia, ib = np.intersect1d(g.src.astype(np.int64) * n + g.dst,
                               g_j.src.astype(np.int64) * n + g_j.dst,
                               assume_unique=True, return_indices=True)
    np.testing.assert_allclose(g.w[ia], g_j.w[ib], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", [1, 2])
def test_learned_mesh_ships_embeddings(results, p):
    """The wire diet (tests/test_measure.py:442-460): nothing crosses at
    p = 1; at p > 1 the fetch ships E = 8 floats a row, not d = 64, so
    fewer payload bytes than the cosine build on the same points."""
    a2a = lambda key: sum(o["transfer"]["all_to_all_bytes"]
                          for o in results.mesh[key])
    learned, cosine = a2a(("learned", "resident", p)), a2a(("cosine", p))
    if p == 1:
        assert learned == cosine == 0
    else:
        assert 0 < learned < cosine
    # the paged learned mesh's fetch is its store: sort and emit only
    paged = results.mesh[("learned", "paged", 4)]
    reps = paged[0]["graph"].stats["reps"]
    assert all(o["transfer"]["all_to_all_calls"] == 2 * reps for o in paged)


@pytest.mark.parametrize("p", [4])
def test_learned_session_extend_and_restore(results, p):
    """Extend then checkpoint, restore and one more repetition, as on one
    device; each rank's state block holds its ceil(n / p) rows in
    storage of its own, after the extend and after the restore."""
    ext1, end1, _ = results.learned_session
    for ext, end, owned in results.mesh[("learned-session", p)]:
        assert _edges(ext) == _edges(ext1)
        assert _edges(end) == _edges(end1)
        assert _without_dropped(end.stats) == end1.stats
        for rows, storage, nbytes in owned:
            assert rows == -(-N_LEARNED // p) and storage == nbytes
