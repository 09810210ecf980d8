"""The port's feature stores and paged builds against the JAX package, on
the CPU.

  * The store contract: sentinels (a resident store reads row 0, a paged
    store a zero row), the LRU order, byte-accurate eviction over feature
    and measure-state pages of different sizes, all-sentinel gathers,
    dtype refusal, and the page counters equal to the JAX
    ``PagedFeatureStore``'s on the same calls.
  * Builds (``tests/test_store.py``'s configs): a paged build equals the
    port's resident build bit for bit and counter for counter, and the
    JAX build edge for edge (up to the slab-boundary near-ties of
    ``repro_torch.testing``), for the four windowed sources with an
    extend and a refresh round, the exact sweep, and the learned measure
    with its state pages; its page counters equal the JAX paged build's.
  * The pool bound, checkpoint / restore under 'paged', and the contract
    errors naming the argument.
  * ``_score_windows`` in its row-subset mode (the paged backend's chunks
    at row offsets 0, C, 2C with a padded tail) equals the whole-grid
    call, for the fused, chunked and LSH-Stars branches with the
    extension and refresh masks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
import jax
from repro.core import GraphBuilder as JBuilder
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro.similarity import learned as j_learned
from repro.similarity.measure import LearnedMeasure as JLearnedMeasure
from repro.similarity.store import PagedFeatureStore as JPagedStore
from repro_torch import GraphBuilder, LearnedMeasure, StarsConfig
from repro_torch.core import windows as win_lib
from repro_torch.core.convert import (config_from_reference,
                                      learned_params_from_reference)
from repro_torch.core.stars import (_rep_keys, _rep_seed,
                                    _rep_window_grid, _score_windows)
from repro_torch.core import lsh as lsh_lib
from repro_torch.graph import accumulator as t_acc
from repro_torch.similarity import LearnedSimilarity, TwoTowerConfig
from repro_torch.similarity.measures import PointFeatures
from repro_torch.similarity.store import (PagedFeatureStore,
                                          ResidentFeatureStore,
                                          make_feature_store)
from repro_torch.testing import compare_builds, slab_boundary

pytestmark = pytest.mark.torch_port

CPU = "cpu"
D = 24
PAGE_KEYS = ("feature_page_bytes", "feature_page_faults",
             "feature_page_hits", "feature_page_peak_bytes",
             "embed_page_bytes", "embed_page_faults", "embed_page_hits")


def _pages(stats):
    return {k: stats[k] for k in PAGE_KEYS}


def _reset():
    j_acc.reset_transfer_stats()
    t_acc.reset_transfer_stats()


def _paged(cfg, page_rows=32, pool_pages=4):
    return dataclasses.replace(
        cfg, feature_store="paged", feature_page_rows=page_rows,
        feature_pool_bytes=pool_pages * page_rows * D * 4)


def _bits(g):
    return g.src, g.dst, g.w.view(np.int32)


def _same_graph(g1, g2):
    return (all(np.array_equal(a, b) for a, b in zip(_bits(g1), _bits(g2)))
            and g1.stats == g2.stats)


def _graph_and_bound(builder, acc):
    nbr, w, _ = acc.to_host(builder.slab_state())
    return builder.finalize(), slab_boundary(nbr, w)


def _equal_to_jax(j, t, tol=1e-6):
    (jg, jb), (tg, tb) = j, t
    assert tg.stats == jg.stats
    diff = compare_builds(jg, tg, jb, tb, tol=tol)
    assert diff["unexplained"] == 0, diff
    assert diff["max_weight_diff"] <= tol, diff
    assert jg.num_edges > 0


@pytest.fixture(scope="module")
def points():
    feats, _ = mnist_like_points(n=602, d=D, classes=6, spread=0.25, seed=0)
    more, _ = mnist_like_points(n=140, d=D, classes=6, spread=0.25, seed=1)
    return np.array(feats.dense), np.array(more.dense)


# --------------------------------------------------------------------- #
# The store contract
# --------------------------------------------------------------------- #
def test_sentinels_and_all_sentinel_gather():
    x = np.arange(200 * 6, dtype=np.float32).reshape(200, 6) + 1.0
    _reset()
    ps = PagedFeatureStore(x, page_rows=32, pool_bytes=2 * 32 * 6 * 4,
                           device=CPU)
    out = ps.gather(np.full((4, 5), -1))
    assert out.dense.shape == (4, 5, 6) and not out.dense.any()
    assert _pages(t_acc.transfer_stats) == dict.fromkeys(PAGE_KEYS, 0)
    mixed = ps.gather(np.array([[3, -1], [-1, 199]]))
    assert torch.equal(mixed.dense[0, 0], torch.from_numpy(x[3]))
    assert torch.equal(mixed.dense[1, 1], torch.from_numpy(x[199]))
    assert not mixed.dense[0, 1].any() and not mixed.dense[1, 0].any()
    rs = ResidentFeatureStore(PointFeatures(dense=torch.from_numpy(x)))
    assert torch.equal(rs.gather(np.full((3,), -1)).dense,
                       torch.from_numpy(np.stack([x[0]] * 3)))
    with pytest.raises(IndexError, match="out of range"):
        ps.gather(np.array([200]))


def test_lru_order():
    """A pool of two pages: a re-touched page is a hit and moves to the
    recent end, so the next fault evicts the other one."""
    x = np.random.RandomState(0).randn(4 * 8, 4).astype(np.float32)
    ps = PagedFeatureStore(x, page_rows=8, pool_bytes=2 * 8 * 4 * 4,
                           device=CPU)
    stats = t_acc.transfer_stats
    _reset()
    for page, fault in [(0, 1), (1, 1), (0, 0), (2, 1), (0, 0), (1, 1)]:
        before = stats["feature_page_faults"]
        got = ps.gather(np.array([8 * page + 3]))
        assert torch.equal(got.dense[0], torch.from_numpy(x[8 * page + 3]))
        assert stats["feature_page_faults"] - before == fault, page
    assert stats["feature_page_hits"] == 2
    assert ps.resident_bytes == stats["feature_page_peak_bytes"] \
        == 2 * 8 * 4 * 4


def _store_script(store, x, state, rng):
    """The same call sequence on a JAX or a port store: gathers of random
    grids (sentinels included) larger than the pool, state attached,
    state and feature gathers interleaved (mixed page sizes), appends."""
    outs = []
    n = x.shape[0]
    for _ in range(3):
        idx = rng.randint(-1, n, size=(7, 9))
        outs.append(np.asarray(store.gather(idx).dense))
    store.attach_state(state)
    for _ in range(4):
        idx = rng.randint(-1, n, size=(40,))
        outs.append(np.asarray(store.gather_state(idx)))
        outs.append(np.asarray(store.gather(idx[::-1]).dense))
        for _ in range(2):              # the second time from the pool
            outs.append(np.asarray(store.gather(np.arange(16)).dense))
    extra = rng.randn(21, x.shape[1]).astype(np.float32)
    store.append(type(store.checkpoint_view())(dense=extra))
    store.append_state(rng.randn(21, state.shape[1]).astype(np.float32))
    idx = rng.randint(-1, n + 21, size=(5, 30))
    outs.append(np.asarray(store.gather(idx).dense))
    outs.append(np.asarray(store.gather_state(idx)))
    return outs


def test_page_counters_and_mixed_eviction_equal_jax():
    """Feature pages of 8 x 6 floats and state pages of 8 x 13 share a
    pool of 700 bytes: byte-accurate eviction over both kinds; every
    gathered row and every counter equals the JAX store's."""
    rng = np.random.RandomState(1)
    x = rng.randn(203, 6).astype(np.float32)
    state = rng.randn(203, 13).astype(np.float32)
    runs = []
    for store_cls, extra, acc in ((JPagedStore, {}, j_acc),
                                  (PagedFeatureStore, {"device": CPU},
                                   t_acc)):
        _reset()
        store = store_cls(x, page_rows=8, pool_bytes=700, **extra)
        outs = _store_script(store, x, state, np.random.RandomState(2))
        runs.append((outs, _pages(acc.transfer_stats), store.n))
    (j_outs, j_stats, j_n), (t_outs, t_stats, t_n) = runs
    assert t_n == j_n == 224
    assert t_stats == j_stats
    assert t_stats["embed_page_faults"] > 0 and t_stats[
        "feature_page_hits"] > 0
    assert t_stats["feature_page_peak_bytes"] <= 700
    for a, b in zip(j_outs, t_outs):
        np.testing.assert_array_equal(a, b)


def test_append_refuses_dtype_and_repins_shape():
    x = np.zeros((40, 4), np.float32)
    ps = PagedFeatureStore(x, page_rows=16, pool_bytes=2 * 16 * 16,
                           device=CPU)
    with pytest.raises(ValueError, match="never silently casts"):
        ps.append(PointFeatures(dense=torch.zeros((3, 4),
                                                  dtype=torch.float64)))
    with pytest.raises(ValueError, match="shape"):
        ps.append(PointFeatures(dense=torch.zeros((3, 5))))
    ps.append(PointFeatures(dense=torch.ones((3, 4))))
    assert ps.n == 43 and ps.dtype == torch.float32
    assert torch.equal(ps.gather(np.array([42])).dense,
                       torch.ones((1, 4)))


def test_zero_row_extend_and_dtype_refusal(points):
    x, _ = points
    for extra in ({}, {"feature_store": "paged", "feature_page_rows": 32,
                       "feature_pool_bytes": 4 * 32 * D * 4}):
        cfg = StarsConfig(mode="lsh", r=2, window=8, leaders=4,
                          degree_cap=8, **extra)
        b = GraphBuilder(x[:201], cfg, device=CPU).add_reps()
        before = (b.n, b.reps_done, b.refresh_watermark)
        b.extend(np.zeros((0, D), np.float32))
        assert (b.n, b.reps_done, b.refresh_watermark) == before
        with pytest.raises(ValueError, match="new_features.*float64"):
            b.extend(np.zeros((5, D), np.float64))
        assert b.n == 201


# --------------------------------------------------------------------- #
# Builds
# --------------------------------------------------------------------- #
GRID = [("lsh", "stars", 8, 8, 4),
        ("sorting", "stars", 16, 16, 4),
        ("lsh", "allpairs", 8, 8, 3),
        ("sorting", "allpairs", 16, 8, 3)]


def _session(builder_cls, x, more, cfg, **kw):
    b = builder_cls(x, cfg, **kw).add_reps()
    b.extend(more, reps=2)
    b.refresh_reps(1)
    return b


@pytest.mark.parametrize("mode,scoring,m,window,reps", GRID)
def test_paged_build_equals_resident_and_jax(points, mode, scoring, m,
                                             window, reps):
    """tests/test_store.py's session (build, extend, refresh) on a pool of
    4 pages x 32 rows against a 742-row table."""
    x, more = points
    jc = JConfig(mode=mode, scoring=scoring, family=JHash("simhash", m=m),
                 measure="cosine", r=reps, window=window, leaders=4,
                 degree_cap=12, seed=7, refresh_fraction=0.5)
    tc = config_from_reference(jc)
    j_res = _graph_and_bound(_session(JBuilder, x, more, jc), j_acc)
    t_res = _session(GraphBuilder, x, more, tc, device=CPU)
    t_res_g = _graph_and_bound(t_res, t_acc)
    _reset()
    jb = _session(JBuilder, x, more, _paged(jc))
    j_pages = _pages(j_acc.transfer_stats)
    tb = _session(GraphBuilder, x, more, _paged(tc), device=CPU)
    t_pages = _pages(t_acc.transfer_stats)
    assert isinstance(tb.feature_store, PagedFeatureStore)
    assert _same_graph(tb.finalize(), t_res_g[0])
    assert tb.stats == t_res.stats
    _equal_to_jax(j_res, t_res_g)
    assert _same_graph(jb.finalize(), j_res[0])
    assert t_pages == j_pages
    assert t_pages["feature_page_faults"] > 0
    assert t_pages["feature_page_bytes"] == \
        t_pages["feature_page_faults"] * 32 * D * 4
    assert t_pages["feature_page_peak_bytes"] <= 4 * 32 * D * 4


def test_pool_bound_build():
    """A table of 3,001 x 24 floats, more than four times the pool: the
    build completes with the resident pool bytes within the budget."""
    feats, _ = mnist_like_points(n=3001, d=D, classes=6, spread=0.25, seed=2)
    x = np.array(feats.dense)
    pool = 10 * 64 * D * 4
    jc = JConfig(mode="sorting", scoring="stars",
                 family=JHash("simhash", m=16), measure="cosine", r=2,
                 window=16, leaders=4, degree_cap=12, seed=3,
                 feature_store="paged", feature_page_rows=64,
                 feature_pool_bytes=pool)
    _reset()
    JBuilder(x, jc).add_reps()
    j_pages = _pages(j_acc.transfer_stats)
    tb = GraphBuilder(x, config_from_reference(jc), device=CPU).add_reps()
    g = tb.finalize()
    ts = _pages(t_acc.transfer_stats)
    assert g.num_edges > 0
    assert ts == j_pages
    assert ts["feature_page_bytes"] == ts["feature_page_faults"] * 64 * D * 4
    assert 0 < ts["feature_page_peak_bytes"] <= pool
    # one host sync a scoring chunk: the grid's window rows over the rows
    # whose gathered block fits the pool, a repetition
    nw = win_lib.window_slot_count("sorting", 3001, 16) // 16
    chunks = -(-nw // min(nw, pool // (16 * D * 4)))
    assert chunks > 1
    assert tb._backend.host_syncs == 2 * chunks


def test_paged_allpairs_sweep(points):
    x, more = points
    jc = JConfig(source="allpairs", degree_cap=10, allpairs_block=64)
    tc = config_from_reference(jc)

    def sweep(cls, cfg, **kw):
        b = cls(x[:301], cfg, **kw).add_reps()
        b.extend(more[:60])
        return b

    j_res = _graph_and_bound(sweep(JBuilder, jc), j_acc)
    t_res = _graph_and_bound(sweep(GraphBuilder, tc, device=CPU), t_acc)
    _reset()
    sweep(JBuilder, _paged(jc))
    j_pages = _pages(j_acc.transfer_stats)
    tb = sweep(GraphBuilder, _paged(tc), device=CPU)
    assert _same_graph(tb.finalize(), t_res[0])
    _equal_to_jax(j_res, t_res)
    assert _pages(t_acc.transfer_stats) == j_pages
    assert j_pages["feature_page_peak_bytes"] <= 4 * 32 * D * 4


def _learned_models():
    kw = dict(in_dim=D, embed_dim=8, tower_hidden=16, head_hidden=16,
              pair_features="raw", use_set_features=False)
    j_model = j_learned.LearnedSimilarity(j_learned.TwoTowerConfig(**kw))
    j_params = j_model.init(jax.random.key(0))
    t_params = learned_params_from_reference(
        {k: np.asarray(v) for k, v in j_params.items()})
    return (JLearnedMeasure(j_model, j_params),
            LearnedMeasure(LearnedSimilarity(TwoTowerConfig(**kw)),
                           t_params))


def test_paged_learned_measure_with_state_pages(points):
    """The learned measure's embeddings page through the same pool
    (embed_page_*): paged == resident bit for bit, an extend's tail
    embedded alone, counters equal to the JAX paged session's."""
    x, more = points
    j_meas, t_meas = _learned_models()
    jc = JConfig(measure="learned", family=JHash("simhash", m=12), r=2,
                 window=32, leaders=4, degree_cap=12, seed=2)
    tc = config_from_reference(jc)
    pool = 6 * 32 * (D + 8) * 4

    def run(cls, cfg, meas, **kw):
        b = cls(x, cfg, measure=meas, **kw).add_reps()
        b.extend(more, reps=1)
        return b

    t_res = run(GraphBuilder, tc, t_meas, device=CPU)
    t_res_g = _graph_and_bound(t_res, t_acc)
    j_res = _graph_and_bound(run(JBuilder, jc, j_meas), j_acc)
    paged = dict(feature_store="paged", feature_page_rows=32,
                 feature_pool_bytes=pool)
    _reset()
    run(JBuilder, dataclasses.replace(jc, **paged), j_meas)
    j_pages = _pages(j_acc.transfer_stats)
    tb = run(GraphBuilder, dataclasses.replace(tc, **paged), t_meas,
             device=CPU)
    assert _same_graph(tb.finalize(), t_res_g[0])
    assert tb.stats["embed_rows"] == x.shape[0] + more.shape[0]
    _equal_to_jax(j_res, t_res_g, tol=1e-5)
    assert _pages(t_acc.transfer_stats) == j_pages
    assert j_pages["embed_page_faults"] > 0
    assert j_pages["feature_page_peak_bytes"] <= pool


def test_paged_checkpoint_restore(points):
    x, more = points
    cfg = _paged(StarsConfig(r=3, window=16, leaders=4, degree_cap=12,
                             seed=5, refresh_fraction=0.5))
    b = GraphBuilder(x, cfg, device=CPU).add_reps()
    ckpt = b.checkpoint()
    view = b.feature_store.checkpoint_view().dense
    assert view.device.type == CPU and torch.equal(view, torch.from_numpy(x))
    b.extend(more, reps=2)
    b.refresh_reps(1)
    r = GraphBuilder.restore(x, cfg, ckpt, device=CPU)
    assert isinstance(r.feature_store, PagedFeatureStore)
    r.extend(more, reps=2)
    r.refresh_reps(1)
    assert _same_graph(r.finalize(), b.finalize())
    # the device clustering runs on a paged session's slabs as well
    resident = GraphBuilder.restore(
        np.concatenate([x, more]), dataclasses.replace(
            cfg, feature_store="resident"),
        dataclasses.replace(b.checkpoint(), cfg=dataclasses.replace(
            cfg, feature_store="resident")), device=CPU)
    for method in ("components", "affinity"):
        np.testing.assert_array_equal(b.cluster(method),
                                      resident.cluster(method))


def test_contract_errors_name_the_argument():
    sets = PointFeatures(set_idx=torch.zeros((8, 3), dtype=torch.int32),
                         set_w=torch.ones((8, 3)),
                         set_mask=torch.ones((8, 3), dtype=torch.bool))
    with pytest.raises(ValueError, match="features=.*no dense block"):
        make_feature_store(sets, "paged", device=CPU)
    with pytest.raises(ValueError, match="unknown feature store"):
        make_feature_store(sets, "mmap")
    with pytest.raises(ValueError, match="feature_pool_bytes"):
        PagedFeatureStore(np.zeros((64, 8), np.float32), page_rows=64,
                          pool_bytes=16, device=CPU)
    x = np.random.RandomState(0).randn(64, 8).astype(np.float32)
    with pytest.raises(NotImplementedError, match="Hamming prefilter"):
        GraphBuilder(x, _paged(StarsConfig(hamming_prefilter_bits=64)),
                     device=CPU)
    _, t_meas = _learned_models()
    with pytest.raises(NotImplementedError, match="pair_cache_slots=0"):
        GraphBuilder(x, _paged(StarsConfig(measure="learned",
                                           pair_cache_slots=64)),
                     measure=t_meas, device=CPU)
    with pytest.raises(ValueError, match="new_features.*set_idx"):
        b = GraphBuilder(x, _paged(StarsConfig(r=1, window=8, leaders=2)),
                         device=CPU).add_reps()
        b.extend(PointFeatures(dense=torch.zeros((2, 8)),
                               set_idx=torch.zeros((2, 3),
                                                   dtype=torch.int32),
                               set_w=torch.ones((2, 3)),
                               set_mask=torch.ones((2, 3), dtype=bool)))


# --------------------------------------------------------------------- #
# _score_windows' row-subset mode
# --------------------------------------------------------------------- #
BRANCHES = {
    "fused": dict(mode="sorting", scoring="stars", measure="cosine"),
    "fused-allpairs": dict(mode="sorting", scoring="allpairs",
                           measure="dot"),
    "chunked": dict(mode="sorting", scoring="stars", measure="angular"),
    "lsh-stars": dict(mode="lsh", scoring="stars", measure="cosine"),
}
MASKS = {"none": {}, "new": dict(new_from=250),
         "refresh": dict(refresh_below=250, refresh_fraction=0.6)}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_chunked_score_windows_equals_whole_grid(points, branch, mask):
    """Chunks of C = 7 window rows (offsets 0, C, 2C, ..., the last one
    padded) gathered through a paged store give the whole-grid call's
    stream on every emitted lane, its emit lanes, and per-window counters
    that sum to its totals."""
    x, _ = points
    cfg = StarsConfig(family=lsh_lib.HashFamilyConfig("simhash", m=8),
                      window=16, leaders=4, r1=0.1, seed=3,
                      **BRANCHES[branch])
    kw = dict(MASKS[mask])
    feats = PointFeatures(dense=torch.from_numpy(x))
    k_tie, k_shift, k_lead, k_refresh = _rep_keys(cfg, 2)
    words = lsh_lib.sketch(feats, cfg.family, rep_seed=_rep_seed(cfg, 2))
    win = _rep_window_grid(cfg, words, k_tie, k_shift)
    nw, w_sz = win.gid.shape
    probs = None
    if mask == "refresh":
        probs = np.random.RandomState(4).uniform(0.2, 1.2, nw).astype(
            np.float32)
    whole = _score_windows(cfg, feats, None, win, k_lead,
                           k_refresh=k_refresh, refresh_probs=probs, **kw)
    c_rows = 7
    assert nw % c_rows
    pad = -nw % c_rows
    padded = lambda t, fill: torch.cat([t, t.new_full((pad, w_sz), fill)])
    gid = padded(win.gid, -1)
    valid = padded(win.valid, False)
    bucket = padded(win.bucket, win_lib.PAD_BUCKET)
    store = PagedFeatureStore(x, page_rows=32, pool_bytes=3 * 32 * D * 4,
                              device=CPU)
    member_index = torch.arange(c_rows * w_sz).reshape(c_rows, w_sz)
    per = whole["src"].shape[0] // nw
    totals = dict.fromkeys(("comparisons", "emitted", "scored_windows"), 0)
    for c0 in range(0, nw + pad, c_rows):
        gid_c = gid[c0:c0 + c_rows]
        block = store.gather(gid_c.numpy()).dense.reshape(
            c_rows * w_sz, D)
        out = _score_windows(
            cfg, PointFeatures(dense=block), None,
            win_lib.Windows(gid=gid_c, valid=valid[c0:c0 + c_rows],
                            bucket=bucket[c0:c0 + c_rows]),
            k_lead, k_refresh=k_refresh, refresh_probs=probs,
            row_offset=c0, total_rows=nw, member_index=member_index, **kw)
        real = min(c_rows, nw - c0)
        lo, hi = c0 * per, (c0 + real) * per
        emit = whole["emit"][lo:hi]
        assert torch.equal(out["emit"][:real * per], emit)
        assert not out["emit"][real * per:].any()
        for key in ("src", "dst"):
            assert torch.equal(out[key][:real * per], whole[key][lo:hi])
        assert torch.equal(out["w"][:real * per][emit], whole["w"][lo:hi][
            emit])
        for key in ("comparisons", "emitted"):
            assert torch.equal(out[key][:real].reshape(-1),
                               whole[key][c0:c0 + real].reshape(-1)), key
            assert not out[key][real:].any()
        totals["comparisons"] += int(out["comparisons"].sum())
        totals["emitted"] += int(out["emitted"].sum())
        totals["scored_windows"] += out["scored_windows"]
    assert totals == {"comparisons": int(whole["comparisons"].sum()),
                      "emitted": int(whole["emitted"].sum()),
                      "scored_windows": nw}
    assert totals["comparisons"] > 0


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_strided_score_windows_equals_whole_grid(points, branch):
    """Two calls that own the window rows ``r + 2 * [0, nw)`` (r = 0, 1;
    ``stride=2``, the layout of a grid dealt round robin over two
    scorers) give the whole-grid call's stream, emit lanes and per-window
    counters on those rows, with the refresh and extension masks on."""
    x, _ = points
    cfg = StarsConfig(family=lsh_lib.HashFamilyConfig("simhash", m=8),
                      window=16, leaders=4, r1=0.1, seed=3,
                      **BRANCHES[branch])
    feats = PointFeatures(dense=torch.from_numpy(x))
    k_tie, k_shift, k_lead, k_refresh = _rep_keys(cfg, 2)
    words = lsh_lib.sketch(feats, cfg.family, rep_seed=_rep_seed(cfg, 2))
    win = _rep_window_grid(cfg, words, k_tie, k_shift)
    nw = win.gid.shape[0]
    probs = np.random.RandomState(4).uniform(0.2, 1.2, nw).astype(
        np.float32)
    kw = dict(new_from=100, refresh_below=250, refresh_fraction=0.6,
              k_refresh=k_refresh, refresh_probs=probs)
    whole = _score_windows(cfg, feats, None, win, k_lead, **kw)
    by_row = lambda t: t.reshape(nw, -1)
    emitted = 0
    for r in range(2):
        sub = win_lib.Windows(gid=win.gid[r::2], valid=win.valid[r::2],
                              bucket=win.bucket[r::2])
        rows = sub.gid.shape[0]
        out = _score_windows(
            cfg, feats, None, sub, k_lead, row_offset=r, total_rows=nw,
            stride=2, **kw)
        emit = by_row(whole["emit"])[r::2].reshape(-1)
        assert torch.equal(out["emit"], emit)
        for key in ("src", "dst"):
            assert torch.equal(out[key], by_row(whole[key])[r::2].reshape(-1))
        assert torch.equal(out["w"][emit],
                           by_row(whole["w"])[r::2].reshape(-1)[emit])
        for key in ("comparisons", "emitted"):
            assert torch.equal(out[key].reshape(-1),
                               whole[key][r::2].reshape(-1)), key
        assert out["scored_windows"] == rows
        emitted += int(out["emitted"].sum())
    assert emitted == int(whole["emitted"].sum()) > 0
