"""The port's build-session lifecycle against the JAX package, on the CPU.

Seeded numpy points go through the JAX ``GraphBuilder`` and the port's
``GraphBuilder(device="cpu")``: add repetitions on 80 % of the points,
checkpoint, extend by the rest, refresh, finalize (whole and as a delta).
For each of the five candidate sources (sorting-stars, lsh-stars,
sorting-allpairs, the Hamming-prefilter build and the exact 'allpairs'
sweep) every counter must be equal and the edges equal, weights within
1e-6, up to the slab-boundary near-ties ``repro_torch.testing`` explains
(the two frameworks may sum a dot product in another order).  Integers,
masks, refresh probabilities and delta records are exact.  The configs
are those of ``tests/test_builder.py``'s extend tests at r = 2 and
n = 1,000; the
refresh, checkpoint and delta checks mirror ``tests/test_refresh.py`` and
``tests/test_service.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
import repro.service as j_service
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.core.builder import GraphBuilder as JBuilder
from repro.core.stars import _rep_candidates as j_rep_candidates
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro.similarity.measures import PointFeatures as JPointFeatures
from repro.similarity.measures import pairwise_similarity
from repro_torch import GraphBuilder
from repro_torch.core.convert import (checkpoint_from_reference,
                                      config_from_reference)
from repro_torch.core.stars import _rep_candidates
from repro_torch.graph import accumulator as t_acc
from repro_torch.service.delta import (SlabDelta, apply_delta, diff_rows,
                                       replay_chain)
from repro_torch.similarity.measures import PointFeatures
from repro_torch.testing import compare_builds, slab_boundary

pytestmark = pytest.mark.torch_port

CPU = "cpu"
R = 2
N, N0 = 1000, 800

# tests/test_builder.py:160's SortingLSH config, tests/test_refresh.py's
# LSH one (W = 128: several windows at this n, so that two refresh rounds
# sample some), the allpairs source's block of tests/test_builder.py; the
# refresh sample at 0.5
SOURCES = {
    "sorting-stars": dict(mode="sorting", family=JHash("simhash", m=24),
                          window=128),
    "lsh-stars": dict(mode="lsh", family=JHash("simhash", m=8), window=128),
    "sorting-allpairs": dict(mode="sorting", scoring="allpairs",
                             family=JHash("simhash", m=24), window=128),
    "prefilter": dict(mode="sorting", family=JHash("simhash", m=24),
                      window=128, hamming_prefilter_bits=64,
                      hamming_prefilter_max=24),
    "allpairs": dict(source="allpairs", allpairs_block=256),
}


def _jcfg(source, **kw):
    base = dict(scoring="stars", measure="cosine", r=R, leaders=10,
                degree_cap=50, seed=2, refresh_fraction=0.5)
    base.update(SOURCES[source])
    base.update(kw)
    return JConfig(**base)


@pytest.fixture(scope="module")
def points():
    feats, _ = mnist_like_points(n=N, d=32, classes=8, spread=0.15, seed=3)
    return np.array(feats.dense)


def _host(builder, acc):
    nbr, w, _ = acc.to_host(builder.slab_state())
    return nbr, w


class _Run:
    """One session of each package: add on N0 points, checkpoint, extend
    by the rest, refresh twice (not 'allpairs'), with the graphs and slab
    images after the extend and at the end; the JAX session then cuts a
    delta checkpoint and a full one."""

    def __init__(self, x, source):
        self.exact = source == "allpairs"
        self.jc = _jcfg(source)
        self.tc = config_from_reference(self.jc)
        reps = 1 if self.exact else R
        jb = JBuilder(x[:N0], self.jc).add_reps(reps)
        self.j_base = jb.stats
        self.j_ckpt = jb.checkpoint()
        jb.extend(x[N0:], reps=reps)
        self.j_ext = (jb.finalize(), slab_boundary(*_host(jb, j_acc)))
        if not self.exact:
            jb.refresh_reps(2)
        self.j_end = (jb.finalize(), slab_boundary(*_host(jb, j_acc)))
        self.j_delta = jb.finalize(delta=True)
        self.j_dckpt = jb.checkpoint(delta=True)
        self.j_live = jb.checkpoint()

        tb = GraphBuilder(x[:N0], self.tc, device=CPU).add_reps(reps)
        self.t_base = tb.stats
        self.t_ckpt = tb.checkpoint()
        tb.extend(x[N0:], reps=reps)
        self.t_ext = (tb.finalize(), slab_boundary(*_host(tb, t_acc)))
        if not self.exact:
            tb.refresh_reps(2)
        self.t_end = (tb.finalize(), slab_boundary(*_host(tb, t_acc)))
        self.t_delta = tb.finalize(delta=True)
        self.t_builder = tb


_RUNS = {}


def _run(points, source) -> _Run:
    if source not in _RUNS:
        _RUNS[source] = _Run(points, source)
    return _RUNS[source]


def _same_build(g_t, bound_t, g_j, bound_j):
    assert g_t.stats == g_j.stats
    diff = compare_builds(g_t, g_j, bound_t, bound_j, tol=1e-6)
    assert diff["unexplained"] == 0, diff
    assert diff["boundary_ties"] <= 4, diff
    assert diff["max_weight_diff"] <= 1e-6, diff
    assert diff["edges_a"] > 0


def _finish(builder, x, exact):
    builder.extend(x[N0:], reps=1 if exact else R)
    if not exact:
        builder.refresh_reps(2)
    return builder


@pytest.mark.parametrize("source", list(SOURCES))
def test_extend_equals_jax(points, source):
    run = _run(points, source)
    assert run.t_base == run.j_base
    _same_build(*run.t_ext, *run.j_ext)
    g = run.t_ext[0]
    ext = g.stats["comparisons"] - run.t_base["comparisons"]
    if source == "allpairs":
        assert ext == N * (N - 1) // 2 - N0 * (N0 - 1) // 2
    else:
        assert 0 < ext < g.stats["comparisons"]


@pytest.mark.parametrize("source", [s for s in SOURCES if s != "allpairs"])
def test_refresh_equals_jax(points, source):
    run = _run(points, source)
    _same_build(*run.t_end, *run.j_end)
    stats = run.t_end[0].stats
    assert stats["refresh_reps"] == 2
    assert 0 < stats["refresh_comparisons"] < stats["comparisons"]


@pytest.mark.parametrize("source", list(SOURCES))
def test_restore_within_the_port_is_bit_exact(points, source):
    """A restored port checkpoint runs the same extend and refresh into
    the same slabs, versions and stats, bit for bit."""
    run = _run(points, source)
    resumed = GraphBuilder.restore(points[:N0], run.tc, run.t_ckpt,
                                   device=CPU)
    assert resumed.reps_done == run.t_ckpt.reps_done
    _finish(resumed, points, run.exact)
    live, back = run.t_builder.slab_state(), resumed.slab_state()
    assert torch.equal(live.nbr, back.nbr) and torch.equal(live.w, back.w)
    # rows an extend adds start at the restored session's version base,
    # as in the JAX package, so only the old rows' versions carry over
    np.testing.assert_array_equal(resumed.row_versions()[:N0],
                                  run.t_builder.row_versions()[:N0])
    assert resumed.stats == run.t_builder.stats
    rt = GraphBuilder.restore(points[:N0], run.tc, run.t_ckpt,
                              device=CPU).checkpoint()
    np.testing.assert_array_equal(rt.nbr, run.t_ckpt.nbr)
    np.testing.assert_array_equal(rt.w, run.t_ckpt.w)
    np.testing.assert_array_equal(rt.ver, run.t_ckpt.ver)


@pytest.mark.parametrize("source", list(SOURCES))
def test_restore_from_a_jax_checkpoint(points, source):
    """A JAX checkpoint crosses through ``checkpoint_from_reference``; the
    port resumes it and its edges equal the JAX session's."""
    run = _run(points, source)
    ckpt = checkpoint_from_reference(run.j_ckpt)
    assert ckpt.cfg == run.tc
    np.testing.assert_array_equal(ckpt.nbr, run.j_ckpt.nbr)
    resumed = _finish(GraphBuilder.restore(points[:N0], run.tc, ckpt,
                                           device=CPU), points, run.exact)
    g = resumed.finalize()
    _same_build(g, slab_boundary(*_host(resumed, t_acc)), *run.j_end)


@pytest.mark.parametrize("source", ["sorting-stars", "lsh-stars",
                                    "allpairs"])
def test_delta_finalize_replays_and_matches_jax(points, source):
    """The delta since the checkpoint, applied to the checkpoint image,
    is the live slab image; its rows and versions are the JAX delta's."""
    run = _run(points, source)
    d = run.t_delta
    nbr, w = apply_delta(run.t_ckpt.nbr, run.t_ckpt.w, d)
    live_nbr, live_w = _host(run.t_builder, t_acc)
    np.testing.assert_array_equal(nbr, live_nbr)
    np.testing.assert_array_equal(w, live_w)
    assert d.seq == run.j_delta.seq == 1
    assert (d.n_old, d.n_new, d.k_old, d.k_new) == (
        run.j_delta.n_old, run.j_delta.n_new, run.j_delta.k_old,
        run.j_delta.k_new)
    np.testing.assert_array_equal(d.rows, run.j_delta.rows)
    np.testing.assert_array_equal(d.row_ver, run.j_delta.row_ver)
    assert 0 < d.rows.shape[0] <= N


# --------------------------------------------------------------------------- #
# Refresh masks, guards, the credit and the age ledger
# --------------------------------------------------------------------------- #


def _small():
    feats, _ = mnist_like_points(n=600, d=24, classes=6, spread=0.25, seed=0)
    return np.array(feats.dense)


def _small_cfg(**kw):
    base = dict(mode="sorting", scoring="stars",
                family=JHash("simhash", m=16), measure="cosine", r=4,
                window=64, leaders=8, degree_cap=20, seed=3)
    base.update(kw)
    return JConfig(**base)


def _streams(cfg_kw, **round_kw):
    """(JAX, port) emit masks and sources of one rep's candidate stream."""
    x = _small()
    jc = _small_cfg(**cfg_kw)
    j = j_rep_candidates(jc, JPointFeatures(dense=x),
                         pairwise_similarity(jc.measure), None, 2,
                         **round_kw)
    t = _rep_candidates(config_from_reference(jc),
                        PointFeatures(dense=torch.from_numpy(x)), None, 2,
                        **round_kw)
    return ({k: np.asarray(j[k]) for k in ("src", "dst", "emit")},
            {k: t[k].numpy() for k in ("src", "dst", "emit")})


@pytest.mark.parametrize("scoring", ["stars", "allpairs"])
def test_refresh_mask_partitions_full_stream_sorting(scoring):
    """tests/test_refresh.py:136 on the port: at fraction 1.0 the
    extension and refresh masks partition the full stream, refresh emits
    old-old pairs only, a sampled fraction is a subset; every mask equals
    the JAX package's."""
    wm = 400
    kw = dict(scoring=scoring)
    full_j, full = _streams(kw)
    ext_j, ext = _streams(kw, new_from=wm)
    ref_j, ref = _streams(kw, refresh_below=wm, refresh_fraction=1.0)
    samp_j, samp = _streams(kw, refresh_below=wm, refresh_fraction=0.5)
    for t, j in ((full, full_j), (ext, ext_j), (ref, ref_j), (samp, samp_j)):
        np.testing.assert_array_equal(t["emit"], j["emit"])
        np.testing.assert_array_equal(t["src"], j["src"])
    e_full, e_ext, e_ref = full["emit"], ext["emit"], ref["emit"]
    assert not (e_ext & e_ref).any()
    np.testing.assert_array_equal(e_ext | e_ref, e_full)
    assert (ref["src"][e_ref] < wm).all() and (ref["dst"][e_ref] < wm).all()
    e_samp = samp["emit"]
    assert 0 < e_samp.sum() < e_ref.sum()
    assert not (e_samp & ~e_ref).any()


def test_refresh_mask_lsh_stars_old_old_only():
    """tests/test_refresh.py:171 on the port: LSH-Stars' extension rescores
    whole touched stars, so the two streams overlap, union to the full
    stream, and refresh stays old-old; masks equal to JAX's."""
    wm = 400
    kw = dict(mode="lsh", family=JHash("simhash", m=8), window=128)
    full_j, full = _streams(kw)
    ext_j, ext = _streams(kw, new_from=wm)
    ref_j, ref = _streams(kw, refresh_below=wm, refresh_fraction=1.0)
    for t, j in ((full, full_j), (ext, ext_j), (ref, ref_j)):
        np.testing.assert_array_equal(t["emit"], j["emit"])
    e_full, e_ext, e_ref = full["emit"], ext["emit"], ref["emit"]
    np.testing.assert_array_equal(e_ext | e_ref, e_full)
    assert (ref["src"][e_ref] < wm).all() and (ref["dst"][e_ref] < wm).all()
    assert e_ext.sum() + e_ref.sum() >= e_full.sum()
    assert (e_ext & e_ref).any()          # touched stars rescore old pairs


def test_refresh_guards():
    """tests/test_refresh.py:196's guards, with the extend guards of
    tests/test_builder.py:243 and the dtype rule."""
    x = _small()
    tc = config_from_reference(_small_cfg())
    b = GraphBuilder(x[:400], tc, device=CPU)
    with pytest.raises(ValueError):
        b.extend(x[400:])                     # before any repetition
    b.add_reps(2)
    with pytest.raises(ValueError):
        b.refresh_reps(1)                     # nothing extended yet
    with pytest.raises(ValueError):           # never cast to the table
        b.extend(x[400:].astype(np.float64))
    stats = b.stats
    b.extend(x[:0])                           # empty: a no-op
    assert b.refresh_watermark == 0 and b.n == 400 and b.stats == stats
    b.extend(torch.from_numpy(x[400:]), reps=2)
    assert b.refresh_watermark == 400
    with pytest.raises(ValueError):
        b.refresh_reps(1, fraction=0.0)
    b.refresh_reps(1)

    ap = config_from_reference(JConfig(source="allpairs", measure="cosine",
                                       degree_cap=10, allpairs_block=256))
    apb = GraphBuilder(x[:400], ap, device=CPU).add_reps()
    apb.extend(x[400:])
    with pytest.raises(ValueError):
        apb.refresh_reps(1)                   # exact source
    with pytest.raises(ValueError):
        GraphBuilder(x, dataclasses.replace(tc, refresh_rate=0.5,
                                            refresh_fraction=0.0),
                     device=CPU)
    with pytest.raises(ValueError):
        GraphBuilder(x, dataclasses.replace(tc, refresh_rate=-0.1),
                     device=CPU)


def test_auto_refresh_banks_fractional_credit_as_jax():
    """tests/test_refresh.py:222 on both packages: every extend banks reps
    * rate and runs the whole part; the states and edges agree."""
    x = _small()
    jc = _small_cfg(refresh_rate=0.3, refresh_fraction=0.5)
    sessions = (JBuilder(x[:300], jc),
                GraphBuilder(x[:300], config_from_reference(jc), device=CPU))
    for b in sessions:
        b.add_reps(2)
        b.extend(x[300:400], reps=2)          # credit 0.6
        assert b.refresh_watermark == 300
        assert b._refresh_reps == 0
        assert b._refresh_credit == pytest.approx(0.6)
        b.extend(x[400:500], reps=2)          # credit 1.2 -> 1 round
        assert b.refresh_watermark == 400
        assert b._refresh_reps == 1
        assert b._refresh_credit == pytest.approx(0.2)
    jb, tb = sessions
    assert tb._refresh_credit == jb._refresh_credit
    np.testing.assert_array_equal(tb._refresh_age, jb._refresh_age)
    g_j, g_t = jb.finalize(), tb.finalize()
    assert g_t.stats == g_j.stats
    assert g_t.stats["refresh_reps"] == 1 and g_t.stats["reps"] == 7
    assert g_t.stats["refresh_comparisons"] > 0
    _same_build(g_t, slab_boundary(*_host(tb, t_acc)),
                g_j, slab_boundary(*_host(jb, j_acc)))


@pytest.mark.parametrize("mode", ["sorting", "lsh"])
def test_next_refresh_probs_bit_equal_to_jax(mode):
    """The host age ledger: the same probabilities and ages as JAX's, bit
    for bit, over rounds of several fractions and a grid that grows."""
    kw = dict(mode=mode, family=JHash("simhash", m=8 if mode == "lsh"
                                      else 16))
    jc = _small_cfg(**kw)
    x = _small()
    jb = JBuilder(x[:300], jc)
    tb = GraphBuilder(x[:300], config_from_reference(jc), device=CPU)
    rep = 0
    for n, fractions in ((300, (0.25, 0.25, 0.7)), (600, (0.5, 1.0, 0.1))):
        if jb.n < n:                          # the grid grows: new rows
            jb._backend.extend(JPointFeatures(dense=x[jb.n:n]))
            tb._backend.extend(torch.from_numpy(x[tb.n:n]))
        for frac in fractions:
            p_j = jb._next_refresh_probs(rep, frac)
            p_t = tb._next_refresh_probs(rep, frac)
            assert p_t.dtype == np.float32
            np.testing.assert_array_equal(p_t, p_j)
            np.testing.assert_array_equal(tb._refresh_age, jb._refresh_age)
            rep += 1
    assert tb._refresh_age.max() > 0


# --------------------------------------------------------------------------- #
# Z-set deltas and the delta checkpoint chain
# --------------------------------------------------------------------------- #


def _random_image(rng, n, k, kind):
    """(n, k) slab rows sorted by weight desc: distinct weights, weights
    on a coarse grid (exact ties), with +-0.0, or with a neighbour twice
    in some rows (not what a session makes; the functions still agree)."""
    nbr = np.full((n, k), -1, np.int32)
    w = np.full((n, k), -np.inf, np.float32)
    for i in range(n):
        deg = rng.randint(0, k + 1)
        ids = rng.choice(30, size=deg, replace=kind == "dupes")
        ws = (rng.rand(deg) * 2 - 1).astype(np.float32)
        if kind in ("ties", "zeros"):
            ws = (np.round(ws * 3) / 3).astype(np.float32)
        if kind == "zeros":
            ws[rng.rand(deg) < 0.3] = np.float32(-0.0)
        order = np.argsort(-ws, kind="stable")
        nbr[i, :deg], w[i, :deg] = ids[order], ws[order]
    return nbr, w


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("kind", ["distinct", "ties", "zeros", "dupes",
                                  "unsorted-rows"])
def test_delta_functions_equal_jax_on_random_rows(kind):
    """diff_rows, apply_delta and replay_chain give the JAX package's
    records, images and errors on random slab rows: rows that empty out,
    fill up or grow a column, replicas one entry off the pre-state, and a
    chain with a gap."""
    rng = np.random.RandomState(len(kind))
    image_kind = "distinct" if kind == "unsorted-rows" else kind
    for trial in range(40):
        n, k = rng.randint(1, 12), rng.randint(1, 9)
        old = _random_image(rng, n, k, image_kind)
        kk = k + rng.randint(0, 2)
        new = _random_image(rng, n, kk, image_kind)
        old = (np.pad(old[0], ((0, 0), (0, kk - k)), constant_values=-1),
               np.pad(old[1], ((0, 0), (0, kk - k)),
                      constant_values=-np.inf))
        rows = (rng.permutation(n) if kind == "unsorted-rows"
                else np.arange(n) * 2).astype(np.int32)
        rec = diff_rows(rows, *old, *new)
        rec_j = j_service.diff_rows(rows, *old, *new)
        for a, b in zip(rec, rec_j):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        big = 2 * n + 1
        replica = (np.full((big, kk), -1, np.int32),
                   np.full((big, kk), -np.inf, np.float32))
        replica[0][rows], replica[1][rows] = old
        meta = dict(seq=trial + 1, n_old=big, n_new=big + rng.randint(0, 2),
                    k_old=kk, k_new=kk + rng.randint(0, 2), rows=rows,
                    row_ver=np.ones(n, np.int64))
        d = SlabDelta(**meta, node=rec[0], nbr=rec[1], w=rec[2],
                      sign=rec[3])
        d_j = j_service.SlabDelta(**meta, node=rec[0], nbr=rec[1],
                                  w=rec[2], sign=rec[3])
        off = (replica[0].copy(), replica[1].copy())
        if rec[0].size:
            off[1][rec[0][rng.randint(rec[0].size)], 0] = np.float32(0.123)
        for rep in (replica, off):
            got = _outcome(apply_delta, *rep, d)
            want = _outcome(j_service.apply_delta, *rep, d_j)
            assert got[0] == want[0], (trial, got, want)
            if got[0] == "ok":
                for a, b in zip(got[1], want[1]):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                if kind == "distinct" and rep is replica:
                    np.testing.assert_array_equal(got[1][0][rows][:, :kk],
                                                  new[0])
            else:
                assert got[1] == want[1]
        if trial == 0:
            chain = [d, dataclasses.replace(d, seq=d.seq + 2)]
            with pytest.raises(ValueError, match="chain gap"):
                replay_chain(*replica, chain)
            got = replay_chain(*replica, chain[:1])
            want = j_service.replay_chain(*replica, [d_j])
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_diff_rows_zset_records():
    """tests/test_service.py's hand-built diff on the port."""
    old_nbr = np.array([[5, 7, -1]], np.int32)
    old_w = np.array([[0.9, 0.5, -np.inf]], np.float32)
    new_nbr = np.array([[5, 8, 7]], np.int32)
    new_w = np.array([[0.9, 0.7, 0.4]], np.float32)
    node, nbr, w, sign = diff_rows(np.array([3], np.int32),
                                   old_nbr, old_w, new_nbr, new_w)
    assert node.tolist() == [3, 3, 3]
    assert sign.tolist() == [-1, 1, 1]
    assert nbr.tolist() == [7, 8, 7]
    np.testing.assert_allclose(w, [0.5, 0.7, 0.4])
    bad = SlabDelta(seq=1, n_old=1, n_new=1, k_old=3, k_new=3,
                    rows=np.array([3], np.int32),
                    row_ver=np.array([1], np.int64),
                    node=np.array([0], np.int32), nbr=np.array([9], np.int32),
                    w=np.array([0.3], np.float32),
                    sign=np.array([-1], np.int8))
    with pytest.raises(ValueError, match="does not hold"):
        apply_delta(old_nbr[:, :3], old_w, dataclasses.replace(
            bad, rows=np.array([0], np.int32)))


def _svc_cfg(**kw):
    base = dict(mode="sorting", scoring="stars",
                family=JHash("simhash", m=16), measure="cosine", r=6,
                window=32, leaders=8, degree_cap=20, seed=3)
    base.update(kw)
    return config_from_reference(JConfig(**base))


def test_row_versions_and_small_deltas():
    """tests/test_service.py's version contract and delta economics: rows
    whose version did not move are bit-identical; a one-point extend ships
    a small delta that a replica folds into the live image; an empty delta
    ships only the version vector."""
    feats, _ = mnist_like_points(n=800, d=24, classes=6, spread=0.25, seed=0)
    x = np.asarray(feats.dense)
    cfg = _svc_cfg()
    b = GraphBuilder(x[:799], cfg, device=CPU).add_reps(cfg.r)
    d0 = b.finalize(delta=True)
    rep_nbr, rep_w = apply_delta(np.zeros((0, 0), np.int32),
                                 np.zeros((0, 0), np.float32), d0)
    ck1 = b.checkpoint()
    before = dict(t_acc.transfer_stats)
    b.extend(x[799:], reps=1)
    d1 = b.finalize(delta=True)
    moved = {k: t_acc.transfer_stats[k] - before[k] for k in before}
    assert moved["delta_fetches"] == 1 and moved["edge_fetches"] == 0
    assert moved["delta_rows"] == d1.rows.shape[0]
    assert 0 < d1.rows.shape[0] <= b.n // 100 + 2
    assert moved["delta_bytes"] <= 0.05 * b.n * b.capacity * 8
    ck2 = b.checkpoint()
    n0 = ck1.n
    assert np.all(ck2.ver[:n0] >= ck1.ver)
    changed = np.any((ck1.nbr != ck2.nbr[:n0]) | (ck1.w != ck2.w[:n0]), 1)
    assert changed.any()
    assert np.all(ck2.ver[:n0][changed] > ck1.ver[changed])
    same = ck1.ver == ck2.ver[:n0]
    np.testing.assert_array_equal(ck1.nbr[same], ck2.nbr[:n0][same])
    rep_nbr, rep_w = apply_delta(rep_nbr, rep_w, d1)
    np.testing.assert_array_equal(rep_nbr, ck2.nbr)
    np.testing.assert_array_equal(rep_w, ck2.w)
    np.testing.assert_array_equal(b.row_versions(), ck2.ver)
    before = t_acc.transfer_stats["delta_bytes"]
    d2 = b.finalize(delta=True)
    assert d2.num_records == 0 and d2.rows.shape[0] == 0
    assert t_acc.transfer_stats["delta_bytes"] - before == b.n * 4


def test_delta_checkpoint_chain_restores_bit_exact(points):
    """Full checkpoint, extend, delta checkpoint, restore(base=full): the
    live slabs, versions and stream position; the chain is smaller than
    the image.  A chain cut by the JAX package (the sorting-stars
    session's: a delta finalize, then a delta checkpoint) restores into
    the port to the JAX session's image."""
    feats, _ = mnist_like_points(n=500, d=24, classes=6, spread=0.25, seed=0)
    x = np.asarray(feats.dense)
    cfg = _svc_cfg(seed=9)
    b = GraphBuilder(x[:490], cfg, device=CPU).add_reps(4)
    full = b.checkpoint()
    b.extend(x[490:], reps=2)
    dckpt = b.checkpoint(delta=True)
    assert dckpt.nbr is None and dckpt.delta_chain
    live = b.checkpoint()
    restored = GraphBuilder.restore(x, cfg, dckpt, base=full, device=CPU)
    rck = restored.checkpoint()
    np.testing.assert_array_equal(rck.nbr, live.nbr)
    np.testing.assert_array_equal(rck.w, live.w)
    np.testing.assert_array_equal(rck.ver, live.ver)
    assert restored.delta_seq == b.delta_seq
    assert sum(d.nbytes for d in dckpt.delta_chain) \
        < full.nbr.nbytes + full.w.nbytes

    run = _run(points, "sorting-stars")
    assert [d.seq for d in run.j_dckpt.delta_chain] == [1, 2]
    got = GraphBuilder.restore(
        points, run.tc, checkpoint_from_reference(run.j_dckpt),
        base=checkpoint_from_reference(run.j_ckpt), device=CPU).checkpoint()
    np.testing.assert_array_equal(got.nbr, run.j_live.nbr)
    np.testing.assert_array_equal(got.w, run.j_live.w)
    np.testing.assert_array_equal(got.ver, run.j_live.ver)


def test_delta_checkpoint_error_cases():
    """tests/test_service.py's delta checkpoint errors on the port."""
    feats, _ = mnist_like_points(n=200, d=16, classes=4, spread=0.25, seed=2)
    x = np.asarray(feats.dense)
    cfg = _svc_cfg(seed=13)
    b = GraphBuilder(x, cfg, device=CPU).add_reps(2)
    with pytest.raises(ValueError, match="prior full"):
        b.checkpoint(delta=True)
    full1 = b.checkpoint()
    b.add_reps(1)
    dckpt = b.checkpoint(delta=True)
    with pytest.raises(ValueError, match="base="):
        GraphBuilder.restore(x, cfg, dckpt, device=CPU)
    with pytest.raises(ValueError, match="FULL"):
        GraphBuilder.restore(x, cfg, dckpt, base=dckpt, device=CPU)
    full2 = b.checkpoint()
    b.add_reps(1)
    dckpt2 = b.checkpoint(delta=True)
    with pytest.raises(ValueError, match="base checkpoint was cut"):
        GraphBuilder.restore(x, cfg, dckpt2, base=full1, device=CPU)
    with pytest.raises(ValueError, match="StarsConfig"):
        GraphBuilder.restore(x, dataclasses.replace(cfg, seed=99), dckpt2,
                             base=full2, device=CPU)
    with pytest.raises(ValueError):
        GraphBuilder.restore(x[:100], cfg, full2, device=CPU)
    assert GraphBuilder.restore(x, cfg, dckpt2, base=full2,
                                device=CPU).n == 200


def test_extend_grows_slab_capacity_and_keeps_the_device():
    """tests/test_builder.py:205 on the port: degree_cap clamps to n - 1,
    so an extend widens the slabs; extend, restore and delta finalize stay
    on the session's device."""
    feats, _ = mnist_like_points(n=128, d=16, classes=4, spread=0.2, seed=2)
    x = np.asarray(feats.dense)
    cfg = config_from_reference(JConfig(
        mode="sorting", scoring="stars", family=JHash("simhash", m=16),
        measure="cosine", r=4, window=32, leaders=4, degree_cap=20, seed=4))
    b = GraphBuilder(x[:12], cfg, device=CPU).add_reps(2)
    assert b.capacity == 11
    ck = b.checkpoint()
    b.extend(x[12:], reps=2)
    assert b.capacity == 20
    b.finalize(delta=True)
    assert b.slab_state().nbr.device.type == CPU
    assert b._backend.features.dense.device.type == CPU
    g = b.finalize()
    assert g.num_edges > 0 and int(g.dst.max()) < 128
    r = GraphBuilder.restore(x[:12], cfg, ck, device=CPU)
    assert r.device.type == CPU and r.slab_state().w.device.type == CPU
