"""The port's device clustering against the JAX package, on the CPU.

  * ``connected_components_device`` against ``connected_components_jax``
    on ``tests/test_cluster.py``'s adversarial edge lists (long chains,
    stars, forests, no edges): equal labels; the unconverged contract
    (RuntimeError, or the flag with ``return_converged``); and the label
    width (int32 while ids fit, int64 past it, where the JAX package
    without x64 raises).
  * ``GraphBuilder.cluster("components")`` and ``("affinity")`` against
    the JAX session's ``cluster`` (its ``cluster_dist`` programs on a
    one-device mesh) on the same slabs: the port's session is restored
    from the JAX session's checkpoint, so both cluster one slab image.
    Labels are equal label for label, with the same rounds, for
    ``test_cluster.py``'s inputs and a larger build; only the label
    vector crosses to the host.
"""

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import GraphBuilder as JBuilder
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro.graph.components import (connected_components_jax,
                                    connected_components_np)
from repro_torch import GraphBuilder
from repro_torch.core.convert import (checkpoint_from_reference,
                                      config_from_reference)
from repro_torch.graph import accumulator as t_acc
from repro_torch.graph.cluster import affinity_slabs
from repro_torch.graph.components import (connected_components_device,
                                          label_dtype)

pytestmark = pytest.mark.torch_port

CPU = "cpu"


@pytest.mark.parametrize("n,edges", [
    (3000, [(i, i + 1) for i in range(2999)]),
    (500, [(0, i) for i in range(1, 500)]),
    (120, [(i, i + 1) for i in range(49)]
     + [(60 + i, 61 + i) for i in range(49)]),
    (17, []),
])
def test_components_device_equals_jax(n, edges):
    src = np.array([e[0] for e in edges], np.int64)
    dst = np.array([e[1] for e in edges], np.int64)
    want = np.asarray(connected_components_jax(n, src, dst))
    got = connected_components_device(n, src, dst, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, connected_components_np(n, src,
                                                                dst))
    # reversed edges, shuffled: the same minima
    perm = np.random.RandomState(0).permutation(src.size)
    got = connected_components_device(n, torch.from_numpy(dst[perm]),
                                      torch.from_numpy(src[perm]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_components_device_unconverged_contract():
    n = 4096
    src, dst = np.arange(n - 1), np.arange(1, n)
    with pytest.raises(RuntimeError, match="max_iters"):
        connected_components_device(n, src, dst, max_iters=1, device=CPU)
    lab, conv = connected_components_device(n, src, dst, max_iters=1,
                                            return_converged=True,
                                            device=CPU)
    j_lab, j_conv = connected_components_jax(n, src, dst, max_iters=1,
                                             return_converged=True)
    assert not conv and not bool(j_conv)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(j_lab))
    assert np.unique(lab.numpy()).size > 1
    lab, conv = connected_components_device(n, src, dst,
                                            return_converged=True,
                                            device=CPU)
    assert conv and np.unique(lab.numpy()).size == 1


def test_components_label_width():
    """Ids past int32 take int64 labels, where the JAX package (x64 off)
    refuses rather than wrap."""
    import jax
    assert label_dtype(2**31) == torch.int32
    assert label_dtype(2**31 + 5) == torch.int64
    if not jax.config.jax_enable_x64:
        with pytest.raises(OverflowError, match="int32"):
            connected_components_jax(2**31 + 5, np.array([0]),
                                     np.array([1]))


def _sessions(feats, jc, reps):
    """A JAX session and the port's session restored from its checkpoint
    (the same slabs)."""
    jb = JBuilder(feats, jc).add_reps(reps)
    tb = GraphBuilder.restore(np.asarray(feats), config_from_reference(jc),
                              checkpoint_from_reference(jb.checkpoint()),
                              device=CPU)
    return jb, tb


CASES = {
    # tests/test_cluster.py:297's single-device input
    "test_cluster": (dict(n=240, d=16, classes=4, spread=0.12, seed=5),
                     dict(mode="sorting", scoring="stars",
                          family=JHash("simhash", m=16), measure="cosine",
                          r=5, window=48, leaders=8, degree_cap=12, seed=2),
                     [dict(target_clusters=4)]),
    "larger": (dict(n=2000, d=32, classes=10, spread=0.15, seed=3),
               dict(mode="sorting", scoring="stars",
                    family=JHash("simhash", m=20), measure="cosine", r=4,
                    window=150, leaders=10, degree_cap=30, seed=7),
               [dict(target_clusters=10), dict(target_clusters=1),
                dict(target_clusters=1, min_similarity=0.6),
                dict(target_clusters=1, max_rounds=2)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_builder_cluster_equals_jax(case):
    data, cfg, affinity_args = CASES[case]
    feats, _ = mnist_like_points(**data)
    jb, tb = _sessions(np.asarray(feats.dense), JConfig(**cfg), cfg["r"])
    j_acc.reset_transfer_stats()
    t_acc.reset_transfer_stats()
    j_cc, j_info = jb.cluster("components", return_info=True)
    t_cc, t_info = tb.cluster("components", return_info=True)
    np.testing.assert_array_equal(t_cc, j_cc)
    assert t_info == {k: int(v) if k != "converged" else v
                      for k, v in j_info.items()}
    for args in affinity_args:
        j_af, j_info = jb.cluster("affinity", return_info=True, **args)
        t_af, t_info = tb.cluster("affinity", return_info=True, **args)
        np.testing.assert_array_equal(t_af, j_af)
        assert t_info == j_info, args
        assert t_info["rounds"] > 0
        assert t_af.dtype == np.int64 and t_af.shape == (tb.n,)
    calls = 1 + len(affinity_args)
    ts = t_acc.transfer_stats
    assert ts["edge_fetches"] == 0 and ts["bytes"] == 0
    assert ts["cluster_label_fetches"] == calls
    assert ts["cluster_label_bytes"] == calls * tb.n * 4
    assert ts["cluster_label_bytes"] == \
        j_acc.transfer_stats["cluster_label_bytes"]
    g = tb.finalize()
    np.testing.assert_array_equal(t_cc, connected_components_np(
        g.n, g.src, g.dst))
    with pytest.raises(ValueError, match="unknown clustering method"):
        tb.cluster("kmeans")


def test_affinity_sums_each_pair_in_node_pair_order():
    """A cluster pair's mean is a sequential float32 sum over its node
    pairs in order (the JAX package's segment sum on the CPU): whatever
    order the slab rows hold the entries in, the same labels."""
    rng = np.random.RandomState(7)
    n, k = 64, 12
    nbr = np.full((n, k), -1, np.int32)
    w = np.full((n, k), -np.inf, np.float32)
    for u in range(n):
        cand = rng.choice(np.delete(np.arange(n), u), size=k, replace=False)
        keep = rng.rand(k) < 0.8
        nbr[u, :keep.sum()] = cand[keep]
        w[u, :keep.sum()] = (rng.rand(keep.sum()) * 1e-3 + 0.5).astype(
            np.float32)
    # one weight per unordered pair, as a symmetric measure gives
    sym = {}
    for u in range(n):
        for j in range(k):
            if nbr[u, j] >= 0:
                key = (min(u, nbr[u, j]), max(u, nbr[u, j]))
                w[u, j] = sym.setdefault(key, w[u, j])
    perm = rng.permutation(k)
    a = affinity_slabs(torch.from_numpy(nbr), torch.from_numpy(w), n=n,
                       target_clusters=3)
    b = affinity_slabs(torch.from_numpy(nbr[:, perm]),
                       torch.from_numpy(w[:, perm]), n=n, target_clusters=3)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] and a[1]["rounds"] > 0
