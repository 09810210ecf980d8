"""tests/test_system.py's pipeline on the port against the JAX package,
on the CPU.

``mnist_like_points(n=4000, d=32, classes=10, spread=0.15, seed=3)`` goes
through Stars and sorting-allpairs at test_system's config (r = 20,
W = 150, s = 10, cap 50) in both packages, then affinity clustering of
the degree-capped graphs.  Comparisons must equal JAX's, the edges equal
up to the slab-boundary near-ties ``repro_torch.testing`` explains
(weights within 1e-6), and each v-measure lie within 0.005 of JAX's own
(0.848 and 0.936 on this data).  The reference's quality assert (Stars
above all-pairs minus 0.05) fails on this data in the JAX package too and
is not made here.
"""

import dataclasses

import numpy as np
import pytest

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.core.builder import GraphBuilder as JBuilder
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro.graph import affinity_clustering as j_affinity
from repro.graph import v_measure as j_v_measure
from repro_torch import GraphBuilder
from repro_torch.core.convert import config_from_reference
from repro_torch.core.stars import build_graph
from repro_torch.graph import accumulator as t_acc
from repro_torch.graph.affinity import affinity_clustering
from repro_torch.graph.metrics import v_measure
from repro_torch.testing import compare_builds, slab_boundary

pytestmark = pytest.mark.torch_port

CPU = "cpu"


def _edges(g):
    return {(int(s), int(d)): float(w)
            for s, d, w in zip(g.src, g.dst, g.w)}


def _bounds(builder, acc):
    return slab_boundary(*acc.to_host(builder.slab_state())[:2])


@pytest.fixture(scope="module")
def system_points():
    feats, labels = mnist_like_points(n=4000, d=32, classes=10, spread=0.15,
                                      seed=3)
    return feats, np.array(feats.dense), labels


def _system_cfg(scoring):
    # tests/test_system.py's _cfg
    return JConfig(mode="sorting", scoring=scoring,
                   family=JHash("simhash", m=20), measure="cosine", r=20,
                   window=150, leaders=10, degree_cap=50, seed=7)


_SYSTEM = {}


def _system(system_points, scoring):
    if scoring not in _SYSTEM:
        feats, x, _ = system_points
        jc = _system_cfg(scoring)
        jb = JBuilder(feats, jc).add_reps(jc.r)
        g_j = jb.finalize()
        tc = config_from_reference(jc)
        tb = GraphBuilder(x, tc, device=CPU).add_reps(tc.r)
        g_t = tb.finalize()
        _SYSTEM[scoring] = (g_t, _bounds(tb, t_acc), g_j, _bounds(jb, j_acc))
    return _SYSTEM[scoring]


@pytest.mark.parametrize("scoring", ["stars", "allpairs"])
def test_system_pipeline_equals_jax(system_points, scoring):
    _, x, labels = system_points
    g_t, bound_t, g_j, bound_j = _system(system_points, scoring)
    assert g_t.stats == g_j.stats
    diff = compare_builds(g_t, g_j, bound_t, bound_j, tol=1e-6)
    assert diff["unexplained"] == 0, diff
    assert diff["boundary_ties"] <= 8, diff
    assert diff["max_weight_diff"] <= 1e-6, diff
    if scoring == "stars":                # the one-shot wrapper, once
        g_w = build_graph(x, config_from_reference(_system_cfg(scoring)),
                          device=CPU)
        assert _edges(g_w) == _edges(g_t) and g_w.stats == g_t.stats
    v_t = v_measure(labels, affinity_clustering(g_t.degree_cap(10),
                                                target_clusters=10))["v"]
    v_j = j_v_measure(labels, j_affinity(g_j.degree_cap(10),
                                         target_clusters=10))["v"]
    assert abs(v_t - v_j) <= 0.005, (v_t, v_j)
    assert v_t > 0.8


def test_system_pipeline_comparison_ratio(system_points):
    """Fig. 1's ratio on the port: sorting-allpairs makes more than 3x the
    comparisons of Stars, as in the JAX package."""
    stars = _system(system_points, "stars")
    every = _system(system_points, "allpairs")
    ratio = every[0].stats["comparisons"] / stars[0].stats["comparisons"]
    assert ratio == every[2].stats["comparisons"] \
        / stars[2].stats["comparisons"]
    assert ratio > 3.0
    assert dataclasses.replace(_system_cfg("stars"), scoring="allpairs") \
        == _system_cfg("allpairs")
