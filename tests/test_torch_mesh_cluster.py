"""Clustering on the mesh's row-sharded slabs against the JAX package.

A JAX single-device session's checkpoint (``checkpoint_from_reference``)
is restored onto p = 1, 2 and 4 gloo ranks (``repro_torch.testing.
RankPool``), so both packages cluster the same slabs.
``connected_components_mesh`` must give JAX's ``connected_components_np``
labels on the finalized graph (component minima); ``affinity_mesh`` the
JAX builder's ``cluster("affinity")`` labels and info, label for label
(JAX runs its mesh program on its trivial one-device mesh), with each
cluster pair's weights summed in the single-device order at any p.  A
``cluster()`` call fetches no edge: ``edge_fetches`` and ``bytes`` stay
0, and one label vector crosses a call.
"""

import numpy as np
import pytest

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.core.builder import GraphBuilder as JBuilder
from repro.data import mnist_like_points
from repro.graph import connected_components_np
from repro_torch.core.convert import (checkpoint_from_reference,
                                      config_from_reference)
from repro_torch.testing import RankPool

import torch_mesh_jobs as jobs

pytestmark = pytest.mark.torch_port

SIZES = (1, 2, 4)
# tests/test_torch_cluster.py's inputs (the first is tests/test_cluster.py
# :297's single-device one)
CASES = {
    "test_cluster": (dict(n=240, d=16, classes=4, spread=0.12, seed=5),
                     dict(mode="sorting", scoring="stars",
                          family=JHash("simhash", m=16), measure="cosine",
                          r=5, window=48, leaders=8, degree_cap=12, seed=2),
                     [dict(target_clusters=4)]),
    "larger": (dict(n=2000, d=32, classes=10, spread=0.15, seed=3),
               dict(mode="sorting", scoring="stars",
                    family=JHash("simhash", m=20), measure="cosine", r=4,
                    window=150, leaders=10, degree_cap=30, seed=7),
               [dict(target_clusters=10),
                dict(target_clusters=1, min_similarity=0.6),
                dict(target_clusters=1, max_rounds=2)]),
}


class _Results:
    def __init__(self, pool):
        self.mesh, self.jax = {}, {}
        order = []
        for case, (data, cfg, args) in CASES.items():
            feats, _ = mnist_like_points(**data)
            x = np.asarray(feats.dense)
            jc = JConfig(**cfg)
            jb = JBuilder(x, jc).add_reps(cfg["r"])
            ckpt = checkpoint_from_reference(jb.checkpoint())
            for p in SIZES:
                pool.submit(jobs.cluster_job, x, config_from_reference(jc),
                            ckpt, args, size=p)
                order.append((case, p))
            g = jb.finalize()
            self.jax[case] = (
                connected_components_np(g.n, g.src, g.dst),
                [jb.cluster("affinity", return_info=True, **a)
                 for a in args])
        self.mesh = {key: pool.collect() for key in order}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("mesh") / "rendezvous",
                  sizes=SIZES) as pool:
        yield _Results(pool)


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_components_mesh_equal_the_host_union_find(results, case, p):
    want, _ = results.jax[case]
    for cc, info, _, _ in results.mesh[(case, p)]:
        np.testing.assert_array_equal(cc, want)
        assert cc.dtype == np.int64 and info["converged"]
        assert info["rounds"] > 0


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_affinity_mesh_equals_jax_label_for_label(results, case, p):
    _, want = results.jax[case]
    for _, _, affinity, _ in results.mesh[(case, p)]:
        for (labels, info), (j_labels, j_info) in zip(affinity, want):
            np.testing.assert_array_equal(labels, np.asarray(j_labels))
            assert info == j_info
            assert info["rounds"] > 0


@pytest.mark.parametrize("p", SIZES)
def test_cluster_fetches_no_edge(results, p):
    n = CASES["larger"][0]["n"]
    calls = 1 + len(CASES["larger"][2])
    ranks = results.mesh[("larger", p)]
    for _, _, _, ts in ranks:
        assert ts["edge_fetches"] == 0 and ts["bytes"] == 0
        assert ts["cluster_label_fetches"] == calls
        assert ts["cluster_label_bytes"] == calls * n * 4
        assert ts["all_to_all_calls"] > 0
    total = sum(ts["all_to_all_bytes"] for *_, ts in ranks)
    assert total > 0 if p > 1 else total == 0
