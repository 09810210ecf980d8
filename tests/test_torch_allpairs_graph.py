"""The port's exact AllPair baseline (the session and its one-shot
wrapper) and host graph functions against the JAX package, on the CPU.

* ``allpairs_graph`` (the 'allpairs' source's blocked sweep) equals JAX's
  edge for edge, weights within 1e-6, up to slab-boundary near-ties (the
  two frameworks' matmuls may sum in another order), with exactly
  n (n - 1) / 2 comparisons; it also equals a dense numpy oracle and runs
  one sweep per point set.
* ``Graph.merged_with`` / ``threshold`` / ``two_hop_sets``,
  ``two_hop_threshold_recall``, the host connected components and
  ``single_linkage_from_spanners`` return what JAX's return on random
  graphs (host numpy in both packages: exact).

``tests/test_torch_system.py`` runs ``tests/test_system.py``'s pipeline.
"""

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import StarsConfig as JConfig
from repro.core.builder import GraphBuilder as JBuilder
from repro.core.spanner import Graph as JGraph
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro.graph import connected_components_np as j_components
from repro.graph import single_linkage_from_spanners as j_single_linkage
from repro.graph import two_hop_threshold_recall as j_threshold_recall
from repro.graph.components import num_components as j_num_components
from repro_torch import GraphBuilder, StarsConfig
from repro_torch.core.convert import config_from_reference
from repro_torch.core.spanner import Graph
from repro_torch.core.stars import allpairs_graph
from repro_torch.graph import accumulator as t_acc
from repro_torch.graph.components import (connected_components_np,
                                          num_components)
from repro_torch.graph.metrics import two_hop_threshold_recall
from repro_torch.graph.single_linkage import single_linkage_from_spanners
from repro_torch.testing import compare_builds, slab_boundary

pytestmark = pytest.mark.torch_port

CPU = "cpu"


def _edges(g):
    return {(int(s), int(d)): float(w)
            for s, d, w in zip(g.src, g.dst, g.w)}


@pytest.fixture(scope="module")
def small():
    feats, _ = mnist_like_points(n=300, d=24, classes=6, spread=0.25, seed=0)
    return np.array(feats.dense)


def _bounds(builder, acc):
    return slab_boundary(*acc.to_host(builder.slab_state())[:2])


@pytest.mark.parametrize("measure,r1,cap", [("cosine", None, 10),
                                            ("dot", None, 10),
                                            ("cosine", 0.5, None)])
def test_allpairs_graph_equals_jax(small, measure, r1, cap):
    """tests/test_builder.py's allpairs session (at n = 300, block 128:
    six blocks) on both packages, through the session and through the
    wrapper."""
    n = small.shape[0]
    jc = JConfig(source="allpairs", measure=measure, r1=r1, degree_cap=cap,
                 allpairs_block=128, r=1)
    jb = JBuilder(small, jc).add_reps()
    tb = GraphBuilder(small, config_from_reference(jc),
                      device=CPU).add_reps()
    g_j, g_t = jb.finalize(), tb.finalize()
    assert g_t.stats == g_j.stats
    assert g_t.stats["comparisons"] == n * (n - 1) // 2
    diff = compare_builds(g_t, g_j, _bounds(tb, t_acc), _bounds(jb, j_acc),
                          tol=1e-6)
    assert diff["unexplained"] == 0, diff
    assert diff["boundary_ties"] <= 4, diff
    assert diff["max_weight_diff"] <= 1e-6, diff
    if r1 is not None:
        assert (g_t.w > r1).all()
    g_w = allpairs_graph(small, measure, r1=r1, degree_cap=cap, block=128,
                         device=CPU)
    assert _edges(g_w) == _edges(g_t) and g_w.stats == g_t.stats


def test_allpairs_matches_numpy_oracle(small):
    """The sweep against a dense numpy cosine matrix compacted and
    degree-capped by the port's host Graph, independent of the slabs."""
    n, cap = small.shape[0], 10
    g = allpairs_graph(small, "cosine", degree_cap=cap, block=128,
                       device=CPU)
    xn = small / np.sqrt((small * small).sum(-1, keepdims=True) + 1e-12)
    sims = xn @ xn.T
    iu, ju = np.triu_indices(n, k=1)
    oracle = Graph.from_candidates(n, iu, ju, sims[iu, ju],
                                   np.ones(iu.size, bool)).degree_cap(cap)
    e_g, e_o = _edges(g), _edges(oracle)
    assert set(e_g) == set(e_o)
    keys = sorted(e_g)
    np.testing.assert_allclose([e_g[k] for k in keys],
                               [e_o[k] for k in keys], rtol=1e-6)


def test_allpairs_source_is_one_sweep_only(small):
    """tests/test_builder.py's guard, and extend's new-vs-all sweep."""
    cfg = StarsConfig(source="allpairs", degree_cap=5, allpairs_block=128)
    b = GraphBuilder(small[:250], cfg, device=CPU)
    with pytest.raises(ValueError):
        b.add_reps(3)
    b.add_reps()
    with pytest.raises(ValueError):
        b.add_reps()
    with pytest.raises(ValueError):
        b.extend(small[250:], reps=2)
    b.extend(small[250:])
    assert b.stats["comparisons"] == 300 * 299 // 2
    assert b.stats["reps"] == 2


def test_allpairs_block_product_ignores_tf32(small, monkeypatch):
    """A process that allows TF32 still gets the sweep's IEEE fp32
    products: every block's matmul runs at the 'highest' precision, the
    process's setting comes back after it, and the edges are those of a
    process that never allowed TF32."""
    want = allpairs_graph(small, "cosine", degree_cap=10, block=128,
                          device=CPU)
    seen = []
    matmul = torch.matmul

    def spy(*args, **kwargs):
        seen.append(torch.get_float32_matmul_precision())
        return matmul(*args, **kwargs)

    prior = torch.get_float32_matmul_precision()
    monkeypatch.setattr(torch, "matmul", spy)
    torch.set_float32_matmul_precision("high")
    try:
        got = allpairs_graph(small, "cosine", degree_cap=10, block=128,
                             device=CPU)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prior)
    assert seen == ["highest"] * 6                 # 3 x 4 / 2 blocks
    assert _edges(got) == _edges(want) and got.stats == want.stats


# --------------------------------------------------------------------------- #
# Host graph functions
# --------------------------------------------------------------------------- #


def _random_pair(seed, n=60, m=240):
    rng = np.random.RandomState(seed)
    src, dst = rng.randint(0, n, m), rng.randint(0, n, m)
    w = rng.rand(m).astype(np.float32)
    valid = rng.rand(m) > 0.1
    stats = {"comparisons": int(rng.randint(100)), "reps": 2}
    return (Graph.from_candidates(n, src, dst, w, valid, stats),
            JGraph.from_candidates(n, src, dst, w, valid, stats))


def _same_graph(a, b):
    assert a.n == b.n and a.stats == b.stats
    for f in ("src", "dst", "w"):
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_merged_with_and_threshold_equal_jax(seed):
    (a_t, a_j), (b_t, b_j) = _random_pair(seed), _random_pair(seed + 10)
    _same_graph(a_t.merged_with(b_t), a_j.merged_with(b_j))
    for r in (0.0, 0.35, 0.9, 2.0):
        _same_graph(a_t.threshold(r), a_j.threshold(r))


@pytest.mark.parametrize("seed", [0, 1])
def test_two_hop_sets_and_threshold_recall_equal_jax(seed):
    g_t, g_j = _random_pair(seed)
    queries = np.arange(0, g_t.n, 3)
    rng = np.random.RandomState(seed + 5)
    truth = [rng.choice(g_t.n, size=rng.randint(0, 6), replace=False)
             for _ in queries]
    for min_w in (-np.inf, 0.3, 0.8):
        got = g_t.two_hop_sets(queries, min_edge_w=min_w)
        want = g_j.two_hop_sets(queries, min_edge_w=min_w)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        if np.isfinite(min_w):
            assert two_hop_threshold_recall(
                g_t, queries, truth, min_edge_w=min_w) \
                == j_threshold_recall(g_j, queries, truth, min_edge_w=min_w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_components_and_single_linkage_equal_jax(seed):
    g_t, g_j = _random_pair(seed, n=80, m=70)
    labels = connected_components_np(g_t.n, g_t.src, g_t.dst)
    want = j_components(g_j.n, g_j.src, g_j.dst)
    np.testing.assert_array_equal(labels, want)
    assert num_components(labels) == j_num_components(want)
    assert 1 < num_components(labels) < g_t.n
    for k, r_min in ((3, 0.05), (10, -0.2), (40, 0.3)):
        got = single_linkage_from_spanners(g_t, k, r_min=r_min, r_max=1.0)
        ref = j_single_linkage(g_j, k, r_min=r_min, r_max=1.0)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]
