"""LSH-Stars, LSH all-pairs and the Hamming-prefilter build: the port
against the JAX package.

One repetition of ``_rep_lsh_stars`` is compared stream entry by stream
entry; then whole builds of ``mnist_like_points(n=2000, d=32)`` at r=6, as
in ``tests/test_torch_builder.py``: equal stats (comparisons and
``prefilter_ops`` included), equal edge sets, weights within 1e-6 (the
frameworks sum a dot product in different orders, an ulp apart) and equal
affinity v-measure.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.core import lsh as j_lsh
from repro.core import stars as j_stars
from repro.core.builder import GraphBuilder as JBuilder
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro.graph import affinity_clustering as j_affinity
from repro.graph import v_measure as j_v_measure
from repro.similarity.measures import PointFeatures as JFeatures
from repro_torch import GraphBuilder, HashFamilyConfig, StarsConfig
from repro_torch.core import lsh as t_lsh
from repro_torch.core import stars as t_stars
from repro_torch.graph import accumulator as t_acc
from repro_torch.graph.affinity import affinity_clustering
from repro_torch.graph.metrics import v_measure
from repro_torch.similarity.measures import PointFeatures as TFeatures
from repro_torch.testing import compare_builds, slab_boundary

pytestmark = pytest.mark.torch_port

CONFIGS = {
    # M = 8 and W = 256: buckets of a class outgrow W and split across
    # windows
    "lsh-stars": dict(mode="lsh", scoring="stars",
                      family=JHash("simhash", m=8), window=256),
    "lsh-allpairs": dict(mode="lsh", scoring="allpairs",
                         family=JHash("simhash", m=8), window=128),
    # the tests/test_system.py prefilter setting on the sorting build
    "sorting-prefilter": dict(mode="sorting", scoring="stars",
                              family=JHash("simhash", m=20), window=150,
                              leaders=10, hamming_prefilter_bits=64,
                              hamming_prefilter_max=24),
}


def _port_cfg(jc):
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    fields["family"] = HashFamilyConfig(**dataclasses.asdict(jc.family))
    return StarsConfig(**fields)


@pytest.fixture(scope="module")
def dataset():
    feats, labels = mnist_like_points(n=2000, d=32, classes=10, spread=0.15,
                                      seed=3)
    return np.asarray(feats.dense), labels


@pytest.mark.parametrize("prefilter_bits,r1,score_chunk", [
    (0, None, 8), (0, 0.3, 1), (64, None, 1)])
def test_rep_lsh_stars_stream_equals_jax(dataset, prefilter_bits, r1,
                                         score_chunk):
    """One repetition: the stream's src, dst and emit lanes and the
    counters exactly, its weights within 1e-6.  ``score_chunk=1`` makes
    JAX pad its window axis; the padded tail is cut off before comparing."""
    x, _ = dataset
    jc = JConfig(mode="lsh", family=JHash("simhash", m=8), window=100,
                 r1=r1, seed=4, score_chunk=score_chunk,
                 hamming_prefilter_bits=prefilter_bits,
                 hamming_prefilter_max=20)
    tc = _port_cfg(jc)
    jf, tf = JFeatures(dense=jnp.asarray(x)), TFeatures(
        dense=torch.from_numpy(x.copy()))
    rep = 3
    jk = j_stars._rep_keys(jc, jnp.int32(rep))
    tk = t_stars._rep_keys(tc, rep)
    j_win = j_stars._rep_window_grid(
        jc, j_lsh.sketch(jf, jc.family, rep_seed=rep ^ jc.seed), jk[0], jk[1])
    t_win = t_stars._rep_window_grid(
        tc, t_lsh.sketch(tf, tc.family, rep_seed=rep ^ tc.seed), tk[0], tk[1])
    j_pref = t_pref = None
    if prefilter_bits:
        j_pref = j_stars._prefilter_sketch(jf, prefilter_bits, jc.seed)
        t_pref = t_stars._prefilter_sketch(tf, prefilter_bits, tc.seed)
        np.testing.assert_array_equal(t_pref.numpy(),
                                      np.asarray(j_pref).astype(np.int64))
    want = j_stars._rep_lsh_stars(jc, jf, None, j_pref, j_win)
    got = t_stars._rep_lsh_stars(tc, tf, t_pref, t_win)
    size = got["src"].shape[0]
    assert size == t_win.gid.numel()
    for key in ("src", "dst", "emit"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key])[:size], key)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"])[:size],
                               atol=1e-6, rtol=0)
    for key in ("comparisons", "emitted", "prefilter_ops"):
        assert int(got[key].sum()) == int(np.asarray(want[key]).sum()), key
    assert int(got["comparisons"].sum()) > 0
    if prefilter_bits:
        assert 0 < int(got["comparisons"].sum()) \
            < int(got["prefilter_ops"].sum())
    if r1 is not None:
        assert 0 < int(got["emitted"].sum()) < int(got["comparisons"].sum())


_BUILDS = {}


def _builds(dataset, name):
    if name not in _BUILDS:
        x, _ = dataset
        jc = JConfig(measure="cosine", r=6, degree_cap=50, seed=7,
                     **CONFIGS[name])
        jb = JBuilder(x, jc).add_reps()
        tb = GraphBuilder(x, _port_cfg(jc), device="cpu").add_reps()
        _BUILDS[name] = (
            jb.finalize(), slab_boundary(*j_acc.to_host(jb.slab_state())[:2]),
            tb.finalize(), slab_boundary(*t_acc.to_host(tb.slab_state())[:2]))
    return _BUILDS[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_build_equals_jax_edge_for_edge(dataset, name):
    g_j, bound_j, g_t, bound_t = _builds(dataset, name)
    assert g_t.stats == g_j.stats
    assert g_t.stats["comparisons"] > 0
    if "prefilter" in name:
        assert 0 < g_t.stats["comparisons"] < g_t.stats["prefilter_ops"]
    diff = compare_builds(g_t, g_j, bound_t, bound_j, tol=1e-6)
    assert diff["unexplained"] == 0, diff
    assert diff["max_weight_diff"] <= 1e-6, diff
    assert diff["edges_a"] > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_affinity_v_measure_equals_jax(dataset, name):
    _, labels = dataset
    g_j, _, g_t, _ = _builds(dataset, name)
    v_j = j_v_measure(labels, j_affinity(g_j.degree_cap(10),
                                         target_clusters=10))["v"]
    v_t = v_measure(labels, affinity_clustering(g_t.degree_cap(10),
                                                target_clusters=10))["v"]
    assert v_t == v_j
