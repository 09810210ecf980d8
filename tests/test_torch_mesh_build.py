"""The port's mesh build against the JAX package's single-device build.

``GraphBuilder(x, cfg, mesh=...)`` runs on p = 1, 2 and 4 gloo ranks on
the CPU (``repro_torch.testing.RankPool``, spawned once for the module)
over ``mnist_like_points(n=602, d=24, classes=6, spread=0.25, seed=0)``
(602: uneven row blocks at p > 1) and ``tests/test_mesh_parity.py``'s
grid of the four windowed sources, plus the Hamming-prefilter build.
Against the port's single-device build: equal edges, weight bits
included.  Against the JAX single-device ``GraphBuilder`` of the same
config: equal comparison counts and edges, weights within 1e-6, up to the
slab-boundary near-ties ``repro_torch.testing`` explains (the frameworks
may sum a dot product in another order); every global window row
scored once a repetition, the per-rank counts ~n_windows / p and, at
p = 2, equal to the JAX mesh's per-shard counts (one
``repro.testing.run_forced_devices`` run of its own mesh build);
repetitions paired into 5 payload exchanges a pair (4 for a lone one),
cross-rank bytes 0 at p = 1 and above 0 beyond; one edge fetch a rank;
nothing dropped; the same graph on every rank.  ``exact_weights=False``
ships bfloat16 weights: fewer bytes, two-hop recall within 1 % of the
exact build (``test_mesh_parity.py:130``).  The constructor refuses what
the port's mesh does not run, naming the argument: the set measures, the
exact sweep, the pair cache, the paged store with the prefilter, and a
learned measure that is not state-complete or comes with the prefilter.
"""

import dataclasses
import threading

import numpy as np
import pytest

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.core.builder import GraphBuilder as JBuilder
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro.testing import run_forced_devices
from repro_torch import GraphBuilder, PointFeatures
from repro_torch.core import windows as t_win
from repro_torch.core.convert import config_from_reference
from repro_torch.distributed import comm
from repro_torch.graph.metrics import neighbor_recall
from repro_torch.testing import RankPool, compare_builds, slab_boundary

import torch_mesh_jobs as jobs

pytestmark = pytest.mark.torch_port

SIZES = (1, 2, 4)
N = 602
# tests/test_mesh_parity.py:75-84, and the prefilter on the SortingLSH row
GRID = {
    "lsh-stars": ("lsh", "stars", 8, 128, 6, {}),
    "sorting-stars": ("sorting", "stars", 16, 64, 6, {}),
    "lsh-allpairs": ("lsh", "allpairs", 8, 64, 3, {}),
    "sorting-allpairs": ("sorting", "allpairs", 16, 32, 3, {}),
    "prefilter": ("sorting", "stars", 16, 64, 3,
                  dict(hamming_prefilter_bits=64, hamming_prefilter_max=24)),
}


def _jcfg(source):
    mode, scoring, m, window, reps, extra = GRID[source]
    return JConfig(mode=mode, scoring=scoring, family=JHash("simhash", m=m),
                   measure="cosine", r=reps, window=window, leaders=8,
                   degree_cap=20, seed=7, **extra)


def _edges(g):
    return dict(zip(zip(g.src.tolist(), g.dst.tolist()),
                    np.asarray(g.w, np.float32).tolist()))


# the JAX mesh's per-shard scored window rows at p = 2 (its own build
# passes on this tree); run in a thread beside the rank jobs
_JAX_MESH = """
        import json
        import jax, numpy as np
        from repro.core import GraphBuilder, HashFamilyConfig, StarsConfig
        from repro.data import mnist_like_points
        feats, _ = mnist_like_points(n=602, d=24, classes=6, spread=0.25,
                                     seed=0)
        mesh = jax.make_mesh((2,), ("data",))
        cfg = StarsConfig(mode="sorting", scoring="stars",
                          family=HashFamilyConfig("simhash", m=16),
                          measure="cosine", r=6, window=64, leaders=8,
                          degree_cap=20, seed=7)
        from repro.graph import accumulator as acc_lib
        acc_lib.reset_transfer_stats()
        b = GraphBuilder(feats.dense, cfg, mesh=mesh).add_reps(6)
        per_round = [np.asarray(c["scored_windows"]).tolist()
                     for c in b._counters]
        print(json.dumps({"per_round": per_round,
                          "transfer": dict(acc_lib.transfer_stats)}))
"""


class _Results:
    """Every rank build of the module, queued on the ranks first, then the
    JAX references built while they run."""

    def __init__(self, pool):
        feats, _ = mnist_like_points(n=N, d=24, classes=6, spread=0.25,
                                     seed=0)
        self.x = np.asarray(feats.dense)
        self.jax_mesh = {}
        thread = threading.Thread(target=self._jax_mesh_run)
        thread.start()
        order = []
        for source in GRID:
            tc = config_from_reference(_jcfg(source))
            for p in SIZES:
                pool.submit(jobs.build_job, self.x, tc, tc.r, size=p)
                order.append((source, p))
        x16, cfg16 = self.bf16_input()
        for exact in (True, False):
            cfg = dataclasses.replace(cfg16, exact_weights=exact)
            pool.submit(jobs.build_job, x16, cfg, cfg.r, size=4)
        self.jax, self.single = {}, {}
        for source in GRID:
            jb = JBuilder(self.x, _jcfg(source)).add_reps(_jcfg(source).r)
            self.jax[source] = (jb.finalize(), slab_boundary(
                *j_acc.to_host(jb.slab_state())[:2]))
            tc = config_from_reference(_jcfg(source))
            self.single[source] = GraphBuilder(
                self.x, tc, device="cpu").add_reps(tc.r).finalize()
        jb = JBuilder(x16, self.bf16_jcfg()).add_reps(8)
        self.jax_bf16_ref = (jb.finalize(), slab_boundary(
            *j_acc.to_host(jb.slab_state())[:2]))
        self.mesh = {key: pool.collect() for key in order}
        self.bf16 = {exact: pool.collect()[0] for exact in (True, False)}
        thread.join()

    def _jax_mesh_run(self):
        self.jax_mesh = run_forced_devices(_JAX_MESH, 2, timeout=600)

    @staticmethod
    def bf16_jcfg():
        # tests/test_mesh_parity.py:142-158: n_pad = 256 at p = 4, so the
        # bfloat16 triple packs into one word where the exact one takes two
        return JConfig(mode="sorting", scoring="stars",
                       family=JHash("simhash", m=24), measure="cosine", r=8,
                       window=80, leaders=10, degree_cap=40, seed=2)

    def bf16_input(self):
        feats, _ = mnist_like_points(n=256, d=32, classes=8, spread=0.15,
                                     seed=3)
        return np.asarray(feats.dense), config_from_reference(
            self.bf16_jcfg())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("mesh") / "rendezvous",
                  sizes=SIZES) as pool:
        yield _Results(pool)


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("source", list(GRID))
def test_mesh_build_equals_jax_single_device(results, source, p):
    ranks = results.mesh[(source, p)]
    g_j, bound_j = results.jax[source]
    mode, _, _, window, reps, _ = GRID[source]
    g = ranks[0]["graph"]
    for r in ranks:                       # the same graph on every rank
        assert _edges(r["graph"]) == _edges(g)
        assert r["graph"].stats == g.stats
    # the port's single-device build, weight bits included
    assert _edges(g) == _edges(results.single[source])
    # JAX's: the frameworks may sum a dot product in another order, which
    # can swap two slab-boundary near-ties and nothing else
    diff = compare_builds(g, g_j, ranks[0]["bound"], bound_j, tol=1e-6)
    assert diff["unexplained"] == 0, diff
    assert diff["boundary_ties"] <= 4, diff
    assert diff["max_weight_diff"] <= 1e-6, diff
    assert g.num_edges > 0
    stats = g.stats
    for key in ("comparisons", "emitted", "prefilter_ops", "scored_windows",
                "reps"):
        assert stats[key] == g_j.stats[key], key
    assert stats["dropped"] == 0
    nw, rps, _ = t_win.shard_row_layout(mode, N, window, p)
    assert stats["scored_windows"] == reps * nw
    per_rank = [r["rank_scored"] for r in ranks]
    assert sum(per_rank) == reps * nw and max(per_rank) <= reps * rps
    for r in ranks:
        ts = r["transfer"]
        assert ts["edge_fetches"] == 1
        assert ts["all_to_all_calls"] == 5 * (reps // 2) + 4 * (reps % 2)
        assert ts["all_to_all_count_calls"] == 4 * (reps // 2) + 3 * (reps % 2)
    total = sum(r["transfer"]["all_to_all_bytes"] for r in ranks)
    assert total > 0 if p > 1 else total == 0
    if p == 1:
        assert all(v == 0 for k, v in ranks[0]["transfer"].items()
                   if k.endswith("_bytes") and k != "bytes"
                   and not k.startswith(("checkpoint", "delta", "cluster",
                                         "feature", "embed")))


def test_per_rank_scored_windows_and_exchanges_beside_the_jax_mesh(results):
    per_round = results.jax_mesh["per_round"]
    assert len(per_round) == 6
    ranks = results.mesh[("sorting-stars", 2)]
    for rank, r in enumerate(ranks):
        assert r["rank_scored"] == sum(c[rank] for c in per_round)
    assert all(c == per_round[0] for c in per_round)
    # as many payload exchanges; exact sizes ship no more than JAX's
    # fixed-capacity buffers, which dropped nothing here
    j_ts = results.jax_mesh["transfer"]
    assert ranks[0]["transfer"]["all_to_all_calls"] == \
        j_ts["all_to_all_calls"]
    ours = sum(r["transfer"]["all_to_all_bytes"] for r in ranks)
    assert 0 < ours <= j_ts["all_to_all_bytes"], (ours, j_ts)


def test_bf16_wire_weights_recall_within_one_percent(results):
    exact, bf16 = results.bf16[True], results.bf16[False]
    diff = compare_builds(exact["graph"], results.jax_bf16_ref[0],
                          exact["bound"], results.jax_bf16_ref[1], tol=1e-6)
    assert diff["unexplained"] == 0 and diff["boundary_ties"] <= 4, diff
    assert exact["graph"].stats["comparisons"] == \
        bf16["graph"].stats["comparisons"]
    assert bf16["transfer"]["all_to_all_bytes"] < \
        exact["transfer"]["all_to_all_bytes"]
    x, _ = results.bf16_input()
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    sims = xn @ xn.T
    np.fill_diagonal(sims, -np.inf)
    queries = np.arange(0, x.shape[0], 2)
    truth = [np.argsort(-sims[q])[:10] for q in queries]

    def recall(r):
        return neighbor_recall(r["graph"], queries, truth, hops=2, k_cap=10)

    assert recall(bf16) > recall(exact) - 0.01


def test_backend_carries_only_its_devices(monkeypatch):
    cpu, cuda = "cpu", "cuda"
    import torch
    for name, device, ok in [("gloo", cpu, "gloo"), ("nccl", cpu, None),
                             ("nccl", cuda, "nccl"), ("mpi", cpu, None),
                             ("cpu:gloo,cuda:nccl", cpu, "gloo"),
                             ("cpu:gloo,cuda:nccl", cuda, "nccl")]:
        monkeypatch.setattr(comm.dist, "get_backend", lambda g, n=name: n)
        if ok is None:
            with pytest.raises(ValueError, match="cannot carry"):
                comm._backend_for(None, torch.device(device))
        else:
            assert comm._backend_for(None, torch.device(device)) == ok


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        comm.Mesh.create(device="cpu")


@dataclasses.dataclass(frozen=True)
class _FakeMesh:
    device: object = None
    rank: int = 0
    size: int = 2


@pytest.mark.parametrize("change,names", [
    (dict(feature_store="paged", hamming_prefilter_bits=64,
          hamming_prefilter_max=24), "feature_store"),
    (dict(measure="jaccard"), "measure"),
    (dict(source="allpairs"), "source"),
    (dict(pair_cache_slots=64), "pair_cache_slots")])
def test_mesh_refuses_what_is_not_ported(change, names):
    import torch
    cfg = dataclasses.replace(config_from_reference(_jcfg("sorting-stars")),
                              **change)
    with pytest.raises(NotImplementedError, match=names):
        GraphBuilder(np.zeros((8, 4), np.float32), cfg,
                     mesh=_FakeMesh(device=torch.device("cpu")))


@pytest.mark.parametrize("pair_features,change,names", [
    ("raw", {}, "pair_features"),
    ("embed", dict(hamming_prefilter_bits=64, hamming_prefilter_max=24),
     "hamming_prefilter_bits"),
    ("embed", dict(feature_store="paged", hamming_prefilter_bits=64,
                   hamming_prefilter_max=24), "hamming_prefilter_bits")])
def test_mesh_refuses_learned_without_the_wire_diet(pair_features, change,
                                                    names):
    """A learned measure on a mesh ships its embeddings, never raw rows:
    one that needs raw features at its tiles, or the prefilter's words,
    is refused (src/repro/core/builder.py:866-877), with the paged store
    too."""
    import torch
    from repro_torch import LearnedMeasure
    from repro_torch.similarity import LearnedSimilarity, TwoTowerConfig
    model = LearnedSimilarity(TwoTowerConfig(
        in_dim=4, embed_dim=2, tower_hidden=4, head_hidden=4,
        pair_features=pair_features, use_set_features=False))
    meas = LearnedMeasure(model, model.init(torch.Generator().manual_seed(0)))
    cfg = dataclasses.replace(config_from_reference(_jcfg("sorting-stars")),
                              measure="learned", **change)
    mesh = _FakeMesh(device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match=names):
        GraphBuilder(np.zeros((8, 4), np.float32), cfg, mesh=mesh,
                     measure=meas)
    # a legacy closure is not state-complete either
    if not change:
        with pytest.raises(NotImplementedError, match="learned_apply"):
            GraphBuilder(np.zeros((8, 4), np.float32), cfg, mesh=mesh,
                         learned_apply=lambda fa, fb: fa.dense @ fb.dense.T)


def test_mesh_refuses_set_features_and_another_device():
    import torch
    cfg = config_from_reference(_jcfg("sorting-stars"))
    mesh = _FakeMesh(device=torch.device("cpu"))
    sets = PointFeatures(set_idx=np.zeros((4, 3), np.int32))
    with pytest.raises(ValueError, match="dense"):
        GraphBuilder(sets, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="device"):
        GraphBuilder(np.zeros((4, 2), np.float32), cfg, mesh=mesh,
                     device="meta")
    # the mesh's own device, named, is no conflict
    b = GraphBuilder(np.zeros((5, 2), np.float32), cfg, mesh=mesh,
                     device="cpu")
    assert b.device == mesh.device and b.n == 5
    assert b.feature_store.n == 3           # rank 0's block of n_pad = 6
