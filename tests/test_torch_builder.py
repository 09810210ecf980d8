"""The port's whole slice against the JAX package: a build, edge for edge.

``mnist_like_points(n=2000, d=32, classes=10, spread=0.15, seed=3)`` goes
through the JAX ``GraphBuilder`` and the port's ``GraphBuilder(device=
"cpu")`` with ``tests/test_system.py``-style configs at r=6, for both
scorings.  Comparison counts and all other stats must be equal, the edge
sets equal, weights within 1e-6, and the affinity v-measure equal.  The
two frameworks sum a window's dot products in different orders, so a
similarity may differ by an ulp; that can swap two candidates whose
weights tie to within an ulp at a slab boundary and nowhere else.  Such
edges are counted (``repro_torch.testing.compare_builds``) and allowed
only in that form; every other difference fails.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.core.builder import GraphBuilder as JBuilder
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro.graph import affinity_clustering as j_affinity
from repro.graph import v_measure as j_v_measure
from repro_torch import (GraphBuilder, HashFamilyConfig, PointFeatures,
                         StarsConfig)
from repro_torch.graph import accumulator as t_acc
from repro_torch.graph.affinity import affinity_clustering
from repro_torch.graph.metrics import v_measure
from repro_torch.testing import compare_builds, slab_boundary

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]


def _cfgs(scoring, r=6):
    jc = JConfig(mode="sorting", scoring=scoring,
                 family=JHash("simhash", m=20), measure="cosine", r=r,
                 window=150, leaders=10, degree_cap=50, seed=7)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    fields["family"] = HashFamilyConfig(**dataclasses.asdict(jc.family))
    return jc, StarsConfig(**fields)


@pytest.fixture(scope="module")
def dataset():
    feats, labels = mnist_like_points(n=2000, d=32, classes=10, spread=0.15,
                                      seed=3)
    return np.asarray(feats.dense), labels


_BUILDS = {}


def _builds(dataset, scoring):
    if scoring not in _BUILDS:
        x, _ = dataset
        jc, tc = _cfgs(scoring)
        jb = JBuilder(x, jc).add_reps()
        tb = GraphBuilder(x, tc, device="cpu").add_reps()
        _BUILDS[scoring] = (
            jb.finalize(), slab_boundary(*j_acc.to_host(jb.slab_state())[:2]),
            tb.finalize(), slab_boundary(*t_acc.to_host(tb.slab_state())[:2]))
    return _BUILDS[scoring]


@pytest.mark.parametrize("scoring", ["stars", "allpairs"])
def test_build_equals_jax_edge_for_edge(dataset, scoring):
    g_j, bound_j, g_t, bound_t = _builds(dataset, scoring)
    assert g_t.stats == g_j.stats
    assert g_t.stats["comparisons"] > 0
    diff = compare_builds(g_t, g_j, bound_t, bound_j, tol=1e-6)
    assert diff["unexplained"] == 0, diff
    assert diff["boundary_ties"] <= 4, diff
    assert diff["max_weight_diff"] <= 1e-6, diff
    assert diff["edges_a"] > 0


@pytest.mark.parametrize("scoring", ["stars", "allpairs"])
def test_affinity_v_measure_equals_jax(dataset, scoring):
    _, labels = dataset
    g_j, _, g_t, _ = _builds(dataset, scoring)
    v_j = j_v_measure(labels, j_affinity(g_j.degree_cap(10),
                                         target_clusters=10))["v"]
    v_t = v_measure(labels, affinity_clustering(g_t.degree_cap(10),
                                                target_clusters=10))["v"]
    assert v_t == v_j


def test_stars_config_mirrors_jax_fields_and_defaults():
    j_fields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(StarsConfig)}
    assert j_fields.keys() == t_fields.keys()
    for name, default in j_fields.items():
        if name != "family":
            assert t_fields[name] == default, name
    assert dataclasses.asdict(t_fields["family"]) \
        == dataclasses.asdict(j_fields["family"])


@pytest.mark.parametrize("change", [
    dict(family=HashFamilyConfig("wminhash")), dict(pair_cache_slots=8),
    dict(measure="jaccard"), dict(measure="learned"),
    dict(feature_store="paged"), dict(measure="mixture"),
    dict(family=HashFamilyConfig("minhash"))])
def test_unported_configs_raise(change):
    """Every config the port once refused now behaves as in the JAX
    package: the pair cache refuses a closed-form measure and 'learned'
    needs a model (``ValueError``); the set families and measures build on
    points with dense and set blocks, and the paged feature store builds
    from their dense block (it is dense-only)."""
    rs = np.random.RandomState(0)
    x = PointFeatures(
        dense=torch.from_numpy(rs.randn(40, 4).astype(np.float32)),
        set_idx=torch.from_numpy(rs.randint(0, 30, (40, 4)).astype(np.int32)),
        set_w=torch.ones((40, 4)), set_mask=torch.ones((40, 4), dtype=bool))
    cfg = dataclasses.replace(StarsConfig(r=2, window=8, leaders=2,
                                          degree_cap=4), **change)
    if cfg.pair_cache_slots or cfg.measure == "learned":
        with pytest.raises(ValueError):
            GraphBuilder(x, cfg, device="cpu")
    else:
        g = GraphBuilder(x, cfg, device="cpu").add_reps().finalize()
        assert g.stats["comparisons"] > 0 and g.num_edges > 0


def test_unported_session_calls_raise():
    """``cluster`` is ported: it returns one label a point and refuses an
    unknown method.  Delta finalize returns a delta."""
    from repro_torch.service.delta import SlabDelta
    x = np.random.RandomState(0).randn(40, 8).astype(np.float32)
    b = GraphBuilder(x, StarsConfig(r=1, window=8, leaders=2),
                     device="cpu").add_reps()
    labels = b.cluster()
    assert labels.shape == (40,) and labels.dtype == np.int64
    assert b.cluster("components").shape == (40,)
    with pytest.raises(ValueError, match="unknown clustering method"):
        b.cluster("kmeans")
    assert isinstance(b.finalize(delta=True), SlabDelta)
    assert b.finalize().num_edges > 0


def test_port_imports_neither_jax_nor_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro\b)")
    files = [ROOT / "chip_smoke.py", *(ROOT / "src/repro_torch").rglob("*.py")]
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pattern.match(line)]
    assert not bad, bad


def test_import_without_jax_and_cuda_device_is_required():
    """With ``jax`` unimportable the port imports; without a card,
    ``GraphBuilder`` refuses to run unless it is asked for the CPU."""
    code = """
import sys
sys.modules["jax"] = None
import numpy as np, torch
import repro_torch
from repro_torch import GraphBuilder, StarsConfig
import repro_torch.kernels.ops, repro_torch.graph.metrics, \\
    repro_torch.graph.affinity, repro_torch.testing, \\
    repro_torch.core.convert, repro_torch.service.delta, \\
    repro_torch.graph.components, repro_torch.graph.single_linkage, \\
    repro_torch.data, repro_torch.similarity.pair_cache, \\
    repro_torch.similarity.store, repro_torch.graph.cluster, \\
    repro_torch.service.session
assert "jax" not in sys.modules or sys.modules["jax"] is None
assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
x = np.random.RandomState(0).randn(40, 8).astype(np.float32)
cfg = StarsConfig(r=1, window=8, leaders=2)
if not torch.cuda.is_available():
    try:
        GraphBuilder(x, cfg)
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise SystemExit("GraphBuilder ran without a CUDA device")
print(GraphBuilder(x, cfg, device="cpu").add_reps().finalize().num_edges)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) > 0
