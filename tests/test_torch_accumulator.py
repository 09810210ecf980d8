"""The port's edge accumulator against the JAX package's, fold for fold.

Both packages start from the same slabs (the JAX snapshot carried across
with ``from_host``) and fold the same candidate streams, made with numpy
from a seed; slabs and row versions must be exactly equal after every
fold.  Weights are distinct across a test's folds, because the JAX CPU merge
(``topk_merge_sorted_ref``) and ``topk_merge_ref`` order cross-input
exact weight ties differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.graph import accumulator as j_acc
from repro_torch.graph import accumulator as t_acc

pytestmark = pytest.mark.torch_port

_j_accumulate = jax.jit(j_acc.accumulate)


def _stream(rs, n, m, fold, valid_frac=0.7):
    src = rs.randint(-1, n, m).astype(np.int32)
    dst = rs.randint(-1, n, m).astype(np.int32)
    # weights distinct across all folds of a test (exact in float32), with
    # a few pairs repeated at another weight
    w = ((fold * m + rs.permutation(m)) * 2.0**-16).astype(np.float32)
    rep = rs.rand(m) < 0.1
    src[rep], dst[rep] = np.roll(src, 1)[rep], np.roll(dst, 1)[rep]
    valid = rs.rand(m) < valid_frac
    return src, dst, w, valid


def _assert_state_equal(t_state, j_state):
    j_nbr, j_w, j_ver = j_acc.to_host(j_state)
    t_nbr, t_w, t_ver = t_acc.to_host(t_state)
    np.testing.assert_array_equal(t_nbr, j_nbr)
    np.testing.assert_array_equal(t_w.view(np.int32), j_w.view(np.int32))
    np.testing.assert_array_equal(t_ver, j_ver)


@pytest.mark.parametrize("n,cap,m,folds", [(40, 5, 300, 4), (200, 16, 2000, 3),
                                            (7, 6, 50, 5), (64, 50, 900, 3)])
def test_accumulate_sequence_matches_jax(n, cap, m, folds):
    rs = np.random.RandomState(n + cap)
    j_state = j_acc.EdgeAccumulator.create(n, cap)
    # a warm start: one JAX fold, then both packages continue from it
    j_state = _j_accumulate(j_state, *(jnp.asarray(a)
                                       for a in _stream(rs, n, m, 0)))
    t_state = t_acc.from_host(*j_acc.to_host(j_state), device="cpu")
    _assert_state_equal(t_state, j_state)
    for fold in range(1, folds + 1):
        s = _stream(rs, n, m, fold)
        j_state = _j_accumulate(j_state, *(jnp.asarray(a) for a in s))
        t_state = t_acc.accumulate(t_state, *(torch.from_numpy(a)
                                              for a in s))
        _assert_state_equal(t_state, j_state)


def test_to_graph_matches_jax():
    rs = np.random.RandomState(1)
    n, cap = 50, 8
    j_state = j_acc.EdgeAccumulator.create(n, cap)
    for fold in range(3):
        j_state = _j_accumulate(j_state, *(jnp.asarray(a)
                                           for a in _stream(rs, n, 400,
                                                            fold)))
    t_state = t_acc.from_host(*j_acc.to_host(j_state), device="cpu")
    g_j = j_acc.to_graph(j_state)
    g_t = t_acc.to_graph(t_state)
    np.testing.assert_array_equal(g_t.src, g_j.src)
    np.testing.assert_array_equal(g_t.dst, g_j.dst)
    np.testing.assert_array_equal(g_t.w, g_j.w)
    assert g_t.degree_cap(3).num_edges == g_j.degree_cap(3).num_edges


@pytest.mark.parametrize("grow_to", [(30, 6), (45, 6), (45, 9)])
def test_grow_matches_jax(grow_to):
    rs = np.random.RandomState(2)
    j_state = _j_accumulate(
        j_acc.EdgeAccumulator.create(30, 6),
        *(jnp.asarray(a) for a in _stream(rs, 30, 200, 0)))
    t_state = t_acc.from_host(*j_acc.to_host(j_state), device="cpu")
    _assert_state_equal(t_acc.grow(t_state, *grow_to),
                        j_acc.grow(j_state, *grow_to))
    with pytest.raises(ValueError):
        t_acc.grow(t_state, 29)


@pytest.mark.parametrize("degree_cap,n,reps,bound", [
    (250, 1000, 1, 0), (250, 100, 1, 0), (None, 1000, 3, 275),
    (None, 50, 3, 275), (None, 10, 1, 0)])
def test_capacity_for_matches_jax(degree_cap, n, reps, bound):
    assert t_acc.capacity_for(degree_cap, n, reps=reps, per_rep_bound=bound) \
        == j_acc.capacity_for(degree_cap, n, reps=reps, per_rep_bound=bound)


def test_create_and_transfer_stats():
    t_acc.reset_transfer_stats()
    state = t_acc.EdgeAccumulator.create(5, 3, device="cpu")
    assert state.nbr.dtype == torch.int32 and (state.nbr == -1).all()
    assert torch.isneginf(state.w).all() and (state.ver == 0).all()
    g = t_acc.to_graph(state)
    assert g.num_edges == 0
    assert t_acc.transfer_stats["edge_fetches"] == 1
    assert t_acc.transfer_stats["bytes"] == 5 * 3 * 8


@pytest.mark.parametrize("seed", [0, 1])
def test_to_graph_equals_the_jax_host_pass(seed):
    """The slabs compacted where they lie (torch sorts) give JAX's
    ``to_graph`` (``Graph.from_degree_slabs`` in numpy) edge for edge:
    empty slots, self loops and non-finite weights dropped, an edge in
    both endpoints' slabs kept once at its larger weight, equal weights
    on a key kept once."""
    rs = np.random.RandomState(seed)
    n, k = 40, 7
    nbr = rs.randint(-1, n, (n, k)).astype(np.int32)
    w = rs.choice(np.float32([0.25, 0.5, 0.75, -0.5]), (n, k))
    w[rs.rand(n, k) < 0.1] = -np.inf
    w[rs.rand(n, k) < 0.05] = np.nan
    # mirror some entries so that an edge sits in both endpoints' slabs
    for i, j in zip(*np.nonzero(rs.rand(n, k) < 0.3)):
        v = nbr[i, j]
        if v >= 0:
            nbr[v, j], w[v, j] = i, w[i, j] + np.float32(0.125) * rs.randint(2)
    state = t_acc.from_host(nbr, w, np.zeros(n, np.int32), device="cpu")
    t_acc.reset_transfer_stats()
    got = t_acc.to_graph(state, stats={"comparisons": 3})
    j_acc.reset_transfer_stats()
    want = j_acc.to_graph(j_acc.EdgeAccumulator(
        nbr=jnp.asarray(nbr), w=jnp.asarray(w),
        ver=jnp.zeros(n, jnp.int32)), stats={"comparisons": 3})
    assert got.n == want.n and got.stats == want.stats
    assert got.num_edges > 0
    for name in ("src", "dst", "w"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert t_acc.transfer_stats["edge_fetches"] == 1
    assert t_acc.transfer_stats["bytes"] == n * k * 8
