"""The port's measure layer against the JAX package, on the CPU.

The single-device cases of ``tests/test_measure.py`` (validation, the
Jaccard chunking, the pair-cache unit semantics) and the JAX package's
pairwise functions, two-tower model and pair cache fed the same inputs:

  * exact: unweighted Jaccard, every integer and boolean output, the pair
    cache's table, hits, misses and evictions batch after batch (with
    colliding slots; the slot's last inserting lane wins, as XLA's
    scatter leaves it);
  * atol 1e-6: weighted Jaccard, cosine, angular and mixture scores;
  * rtol 1e-5 and atol 1e-5: the two-tower embeddings and pair scores
    from the JAX parameters converted by
    ``core.convert.learned_params_from_reference``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
import jax
import jax.numpy as jnp
from repro.similarity import learned as j_learned
from repro.similarity import measures as j_measures
from repro.similarity import pair_cache as j_pc
from repro_torch import GraphBuilder, StarsConfig
from repro_torch.core.convert import learned_params_from_reference
from repro_torch.similarity import (LearnedMeasure, LearnedSimilarity,
                                    PointFeatures, TwoTowerConfig,
                                    make_measure, pairwise_similarity)
from repro_torch.similarity import measures as t_measures
from repro_torch.similarity import pair_cache as t_pc
from repro_torch.similarity.measure import params_fingerprint

pytestmark = pytest.mark.torch_port

CPU = "cpu"


def _dense(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _sets(n_rows, nnz, universe, seed, weighted=True):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, universe, size=(n_rows, nnz)).astype(np.int32)
    w = (rng.uniform(0.1, 2.0, size=(n_rows, nnz)) if weighted
         else np.ones((n_rows, nnz))).astype(np.float32)
    mask = rng.random((n_rows, nnz)) < 0.8
    return idx, w, mask


def _tile_sets(weighted=False):
    """Batched A / B set tiles, (2, 12, 6) and (2, 15, 5): one shape for
    every JAX call here, so JAX compiles its Jaccard once."""
    a = _sets(24, 6, 40, seed=3, weighted=weighted)
    b = _sets(30, 5, 40, seed=4, weighted=weighted)
    return (tuple(x.reshape(2, 12, -1) for x in a),
            tuple(x.reshape(2, 15, -1) for x in b))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _learned(d=16, embed_dim=8, seed=0, **kw):
    """A JAX two-tower model with its parameters and the port's measure
    over the same parameters."""
    base = dict(in_dim=d, embed_dim=embed_dim, tower_hidden=16,
                head_hidden=16, use_set_features=False)
    base.update(kw)
    j_model = j_learned.LearnedSimilarity(j_learned.TwoTowerConfig(**base))
    j_params = j_model.init(jax.random.key(seed))
    t_model = LearnedSimilarity(TwoTowerConfig(**base))
    t_params = learned_params_from_reference(
        {k: np.asarray(v) for k, v in j_params.items()})
    return j_model, j_params, LearnedMeasure(t_model, t_params)


# --------------------------------------------------------------------- #
# Validation (tests/test_measure.py::TestValidation)
# --------------------------------------------------------------------- #
def test_mixture_alpha_and_cache_slot_bounds():
    for bad in (-0.1, 1.5, 2.0):
        with pytest.raises(ValueError, match="mixture_alpha"):
            StarsConfig(mixture_alpha=bad)
    StarsConfig(mixture_alpha=0.0)
    StarsConfig(mixture_alpha=1.0)
    with pytest.raises(ValueError, match="pair_cache_slots"):
        StarsConfig(pair_cache_slots=-1)


def test_learned_apply_with_cheap_measure_and_unknown_measure_raise():
    fn = lambda fa, fb: torch.zeros((fa.dense.shape[0], fb.dense.shape[0]))
    with pytest.raises(ValueError, match="learned"):
        pairwise_similarity("cosine", learned_apply=fn)
    with pytest.raises(ValueError, match="learned"):
        make_measure("cosine", learned=fn)
    with pytest.raises(ValueError, match="unknown"):
        make_measure("euclidean")
    with pytest.raises(ValueError, match="requires"):
        make_measure("learned")


@pytest.mark.parametrize("case", ["cheap", "allpairs", "paged", "both"])
def test_builder_rejects_what_the_jax_builder_rejects(case):
    x = _dense(64, 8)
    model = LearnedSimilarity(TwoTowerConfig(in_dim=8, embed_dim=4,
                                             tower_hidden=8, head_hidden=8))
    meas = LearnedMeasure(model, model.init(torch.Generator().manual_seed(0)))
    learned = dict(measure="learned", degree_cap=8, pair_cache_slots=256)
    if case == "cheap":
        with pytest.raises(ValueError, match="pair_cache_slots"):
            GraphBuilder(x, StarsConfig(r=2, window=16, leaders=4,
                                        pair_cache_slots=256), device=CPU)
    elif case == "allpairs":
        with pytest.raises(ValueError, match="allpairs"):
            GraphBuilder(x, StarsConfig(source="allpairs", **learned),
                         measure=meas, device=CPU)
    elif case == "paged":
        with pytest.raises(NotImplementedError):
            GraphBuilder(x, StarsConfig(feature_store="paged", r=2,
                                        window=16, leaders=4, **learned),
                         measure=meas, device=CPU)
    else:
        with pytest.raises(ValueError, match="either"):
            GraphBuilder(x, StarsConfig(measure="learned"), measure=meas,
                         learned_apply=lambda fa, fb: None, device=CPU)


def test_point_features_take_and_concat():
    idx, w, mask = _t(*_sets(6, 4, 30, seed=1))
    dense = torch.from_numpy(_dense(6, 3))
    f = PointFeatures(dense=dense, set_idx=idx, set_w=w, set_mask=mask)
    g = f.take(torch.tensor([[2, 0], [5, 5]]))
    assert g.set_idx.shape == (2, 2, 4) and g.dense.shape == (2, 2, 3)
    assert torch.equal(g.set_w[1, 0], w[5])
    both = f.concat(f)
    assert both.n == 12 and torch.equal(both.set_mask[6:], mask)
    with pytest.raises(ValueError, match="one side"):
        f.concat(PointFeatures(dense=dense))
    with pytest.raises(ValueError, match="dtypes"):
        f.concat(dataclasses.replace(f, set_w=w.double()))
    with pytest.raises(ValueError, match="trailing"):
        f.concat(dataclasses.replace(f, dense=dense[:, :2]))


# --------------------------------------------------------------------- #
# Pairwise measures against JAX; the Jaccard chunking
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("weighted", [False, True])
def test_jaccard_equals_jax(weighted):
    """Unweighted Jaccard exactly, weighted within 1e-6, batched."""
    a, b = _tile_sets(weighted)
    want = np.asarray(j_measures.jaccard_pairwise(*_j(*a), *_j(*b)))
    got = t_measures.jaccard_pairwise(*_t(*a), *_t(*b)).numpy()
    assert got.shape == want.shape == (2, 12, 15)
    if weighted:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)
    assert (got > 0).any()


@pytest.mark.parametrize("shape", ["even", "ragged", "batched"])
def test_jaccard_chunked_bitwise_equals_one_shot(monkeypatch, shape):
    """tests/test_measure.py::TestJaccardChunking on the port."""
    if shape == "even":
        a, b, cap = _sets(40, 6, 50, 7), _sets(24, 6, 50, 8), 64
    elif shape == "ragged":                 # prime A: a ragged last chunk
        a, b, cap = _sets(37, 4, 30, 9), _sets(11, 4, 30, 10), 16
    else:
        a = tuple(x.reshape(3, 4, 5) for x in _sets(12, 5, 40, 11))
        b = tuple(x.reshape(3, 3, 5) for x in _sets(9, 5, 40, 12))
        cap = 8
    one_shot = t_measures.jaccard_pairwise(*_t(*a), *_t(*b))
    monkeypatch.setattr(t_measures, "_MAX_BLOCK_ELEMS", cap)
    chunked = t_measures.jaccard_pairwise(*_t(*a), *_t(*b))
    assert torch.equal(chunked.view(torch.int32), one_shot.view(torch.int32))


def test_dense_and_mixture_measures_equal_jax():
    da, db = _dense(2 * 12, 12, 1).reshape(2, 12, 12), \
        _dense(2 * 15, 12, 2).reshape(2, 15, 12)
    sa, sb = _tile_sets()
    jfa = j_measures.PointFeatures(jnp.asarray(da), *_j(*sa))
    jfb = j_measures.PointFeatures(jnp.asarray(db), *_j(*sb))
    tfa = PointFeatures(torch.from_numpy(da), *_t(*sa))
    tfb = PointFeatures(torch.from_numpy(db), *_t(*sb))
    for name in ("dot", "cosine", "angular", "jaccard", "mixture"):
        want = np.asarray(j_measures.pairwise_similarity(
            name, alpha=0.3)(jfa, jfb))
        got = make_measure(name, alpha=0.3)(tfa, tfb).numpy()
        tol = 1e-5 if name == "dot" else 1e-6
        np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                   err_msg=name)


# --------------------------------------------------------------------- #
# The two-tower model from converted JAX parameters
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["raw", "embed", "none"])
def test_two_tower_embed_and_pairwise_equal_jax(mode):
    j_model, j_params, meas = _learned(d=12, embed_dim=6, seed=4,
                                       pair_features=mode,
                                       use_set_features=True)
    da, db = _dense(2 * 12, 12, 3).reshape(2, 12, 12), \
        _dense(2 * 15, 12, 4).reshape(2, 15, 12)
    sa, sb = _tile_sets()
    jfa = j_measures.PointFeatures(jnp.asarray(da), *_j(*sa))
    jfb = j_measures.PointFeatures(jnp.asarray(db), *_j(*sb))
    tfa = PointFeatures(torch.from_numpy(da), *_t(*sa))
    tfb = PointFeatures(torch.from_numpy(db), *_t(*sb))
    emb = meas.model.embed(meas.params, tfa.dense).numpy()
    np.testing.assert_allclose(
        emb, np.asarray(j_model.embed(j_params, jfa.dense)),
        rtol=1e-5, atol=1e-5)
    want = np.asarray(j_model.pairwise(j_params, jfa, jfb))
    got = meas(tfa, tfb).numpy()
    assert got.shape == (2, 12, 15)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the two-phase form: precompute once, score from the state
    sta = meas.precompute(PointFeatures(dense=tfa.dense.reshape(24, 12)))
    stb = meas.precompute(PointFeatures(dense=tfb.dense.reshape(30, 12)))
    np.testing.assert_allclose(sta.numpy().reshape(2, 12, 6), emb,
                               rtol=1e-6, atol=1e-6)
    two_phase = meas(tfa, tfb, sta.reshape(2, 12, 6),
                     stb.reshape(2, 15, 6)).numpy()
    np.testing.assert_allclose(two_phase, got, rtol=1e-6, atol=1e-6)
    assert meas.state_complete == (mode != "raw")
    assert meas.state_width == 6


def test_fingerprint_keys_parameters():
    _, _, meas = _learned(d=8, seed=0)
    _, _, same = _learned(d=8, seed=0)
    _, _, other = _learned(d=8, seed=1)
    assert meas.fingerprint() == same.fingerprint()
    assert meas.fingerprint() != other.fingerprint()
    assert make_measure("cosine").fingerprint() is None
    params = dict(meas.params)
    params["head_b2"] = params["head_b2"] + 1.0
    assert params_fingerprint(meas.model.cfg, params) != meas.fingerprint()


def test_precompute_blocks_match_one_shot():
    """Rows embedded in a session's blocks equal one tower call on them
    (the blocks bound the matmul shapes, not the values)."""
    _, _, meas = _learned(d=8, seed=2)
    x = torch.from_numpy(_dense(300, 8, 5))
    state = meas.precompute(PointFeatures(dense=x))
    tail = meas.precompute(PointFeatures(dense=x[200:]))
    np.testing.assert_allclose(state.numpy(),
                               meas.model.embed(meas.params, x).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(state[200:], tail)


# --------------------------------------------------------------------- #
# Pair cache (tests/test_measure.py::TestPairCache) and its JAX parity
# --------------------------------------------------------------------- #
def _cache_call(cache, src, dst, w, cmp):
    return t_pc.lookup_insert(
        cache, torch.tensor(src, dtype=torch.int32),
        torch.tensor(dst, dtype=torch.int32),
        torch.tensor(w, dtype=torch.float32), torch.tensor(cmp))


def test_pair_cache_unit_semantics():
    assert t_pc.create(100, device=CPU).slots == 128
    assert t_pc.create(128, device=CPU).slots == 128
    with pytest.raises(ValueError):
        t_pc.create(0, device=CPU)
    # a miss inserts; a swapped re-visit with fresh scores hits the
    # original bits
    cache = t_pc.create(256, device=CPU)
    w = [0.125, -2.5, 1e-7]
    w0, cache, h, m, _ = _cache_call(cache, [1, 2, 3], [5, 6, 7], w,
                                     [True] * 3)
    assert (int(h), int(m)) == (0, 3)
    assert np.array_equal(w0.numpy(), np.float32(w))
    w1, cache, h, m, _ = _cache_call(cache, [5, 6, 7], [1, 2, 3],
                                     [9.0] * 3, [True] * 3)
    assert (int(h), int(m)) == (3, 0)
    assert np.array_equal(w1.numpy(), np.float32(w))
    # masked lanes neither hit nor insert
    cache = t_pc.create(256, device=CPU)
    _, cache, h, m, _ = _cache_call(cache, [1, 2], [5, 6], [1.0, 2.0],
                                    [True, False])
    assert (int(h), int(m)) == (0, 1)
    _, _, h, m, _ = _cache_call(cache, [1, 2], [5, 6], [1.0, 2.0],
                                [True, True])
    assert (int(h), int(m)) == (1, 1)
    # a pair twice in one batch counts two misses
    _, _, h, m, _ = _cache_call(t_pc.create(256, device=CPU), [3, 3], [9, 9],
                                [0.5, 0.5], [True, True])
    assert (int(h), int(m)) == (0, 2)


def test_pair_cache_collisions_evict_never_corrupt():
    cache = t_pc.create(2, device=CPU)
    n = 16
    for base, evicts in ((0, False), (1000, True)):
        src = np.arange(n) + base
        _, cache, _, m, ev = _cache_call(cache, src, src + 100,
                                         src * 0.25, [True] * n)
        assert int(m) == n and (int(ev) > 0) == evicts
    tab = cache.table[:cache.slots].numpy()
    live = tab[tab[:, 0] != -1]
    assert live.shape[0] > 0
    for lo, hi, bits in live:
        assert hi == lo + 100
        assert np.float32(lo * 0.25).view(np.int32) == bits


def test_pair_cache_equals_jax_batch_after_batch():
    """Several batches into a small table (colliding slots within and
    across batches, repeated pairs, masked lanes): every batch's scores,
    counters and the whole table equal the JAX package's."""
    rng = np.random.default_rng(0)
    j_cache = j_pc.create(64)
    t_cache = t_pc.create(64, device=CPU)
    for step in range(5):
        lanes = 300
        src = rng.integers(0, 40, lanes).astype(np.int32)
        dst = rng.integers(0, 40, lanes).astype(np.int32)
        w = rng.normal(size=lanes).astype(np.float32)
        cmp = rng.random(lanes) < 0.8
        jw, j_cache, jh, jm, je = j_pc.lookup_insert(
            j_cache, *_j(src, dst, w, cmp))
        tw, t_cache, th, tm, te = t_pc.lookup_insert(
            t_cache, *_t(src, dst, w, cmp))
        assert (int(th), int(tm), int(te)) == (int(jh), int(jm), int(je))
        assert np.array_equal(tw.numpy().view(np.int32),
                              np.asarray(jw).view(np.int32))
        np.testing.assert_array_equal(
            t_cache.table[:t_cache.slots].numpy(),
            np.asarray(j_cache.table).view(np.int32), err_msg=str(step))
    assert int(te) > 0 and int(th) > 0


def test_pair_cache_hash_slot_equals_jax():
    rng = np.random.default_rng(3)
    lo = rng.integers(0, 2**31 - 1, 1000).astype(np.int64)
    hi = rng.integers(0, 2**31 - 1, 1000).astype(np.int64)
    want = np.asarray(j_pc._hash_slot(jnp.asarray(lo, jnp.uint32),
                                      jnp.asarray(hi, jnp.uint32), 1 << 20))
    got = t_pc._hash_slot(torch.from_numpy(lo), torch.from_numpy(hi),
                          1 << 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ieee_fp32_matmul_keeps_the_precision_readable():
    """The IEEE block under a caller that allows TF32 through
    ``torch.set_float32_matmul_precision``: 'highest' inside (also when
    nested), the caller's setting back after, and readable throughout."""
    prior = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with t_measures.ieee_fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            with t_measures.ieee_fp32_matmul():
                t_measures.dot_pairwise(torch.ones(2, 3), torch.ones(4, 3))
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prior)
