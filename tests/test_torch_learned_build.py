"""Builds through the port's measure layer against the JAX package's, on
the CPU.

The same points (drawn with the port's ``wikipedia_like_sets`` /
``products_like_points``, which equal the JAX package's generators:
``tests/test_torch_minhash.py``) go through the JAX ``GraphBuilder`` and
the port's ``GraphBuilder(device="cpu")``:

  * Jaccard with weighted MinHash, sorting-stars, and the exact Jaccard
    AllPair sweep, on Wikipedia-like sets;
  * the mixture measure with the mixture family, sorting-stars and
    lsh-stars, on Amazon2m-like points;
  * the learned two-tower measure (the JAX parameters converted) with
    ``pair_features='raw'`` with the pair cache off and on, with
    ``'embed'``, and with the Hamming prefilter: each learned session
    adds repetitions on 80 % of the points, checkpoints, and extends by
    the rest; the JAX checkpoint restored through
    ``checkpoint_from_reference`` and extended again equals it.

Counters are exact (comparisons, emitted, prefilter_ops, embed_rows,
expensive comparisons, cache hits / misses / evictions); edges equal up to
slab-boundary near-ties within the score tolerance (1e-6 for Jaccard and
mixture, 1e-5 for learned scores: ``repro_torch.testing``).  Cache-on
builds equal cache-off builds bit for bit, and their hit accounting equals
the JAX package's.  Every build stays at n <= 1,200 and r <= 3; each JAX
session runs once per module.
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
from repro.graph import accumulator as j_acc
from repro.similarity import learned as j_learned
from repro.similarity.measure import LearnedMeasure as JLearnedMeasure
from repro.similarity.measures import PointFeatures as JFeatures
from repro_torch import GraphBuilder, LearnedMeasure, StarsConfig
from repro_torch.core.convert import (checkpoint_from_reference,
                                      config_from_reference,
                                      learned_params_from_reference)
from repro_torch.data import products_like_points, wikipedia_like_sets
from repro_torch.graph import accumulator as t_acc
from repro_torch.similarity import LearnedSimilarity, TwoTowerConfig
from repro_torch.testing import compare_builds, slab_boundary

pytestmark = pytest.mark.torch_port

CPU = "cpu"
FIELDS = ("dense", "set_idx", "set_w", "set_mask")
N_WIKI, N_PROD, N0 = 1200, 1000, 800


def _both(tf):
    """(JAX features, port features) over the same arrays."""
    arrays = {f: None if getattr(tf, f) is None else getattr(tf, f).numpy()
              for f in FIELDS}
    return JFeatures(**arrays), tf


@pytest.fixture(scope="module")
def wiki():
    return _both(wikipedia_like_sets(N_WIKI, classes=8, nnz=16,
                                     dup_frac=0.3, seed=5, device=CPU)[0])


@pytest.fixture(scope="module")
def prod():
    return _both(products_like_points(N_PROD, d=16, classes=8, nnz=8,
                                      dup_frac=0.3, seed=5, device=CPU)[0])


def _split(f, lo, hi):
    return type(f)(**{k: None if getattr(f, k) is None
                      else getattr(f, k)[lo:hi] for k in FIELDS})


def _graph_and_bound(builder, acc):
    nbr, w, _ = acc.to_host(builder.slab_state())
    return builder.finalize(), slab_boundary(nbr, w)


def _assert_same_build(j, t, tol, stats=True):
    (jg, jb), (tg, tb) = j, t
    if stats:
        assert tg.stats == jg.stats
    diff = compare_builds(jg, tg, jb, tb, tol=tol)
    assert diff["unexplained"] == 0, diff
    assert diff["max_weight_diff"] <= tol, diff
    assert jg.num_edges > 0 and jg.stats["comparisons"] > 0
    return diff


def _edges_bits(g):
    return g.src, g.dst, g.w.view(np.int32)


def _same_edges(g1, g2):
    return all(np.array_equal(a, b) for a, b in
               zip(_edges_bits(g1), _edges_bits(g2)))


# --------------------------------------------------------------------- #
# Closed-form set measures
# --------------------------------------------------------------------- #
CHEAP = {
    "jaccard-wminhash": ("wiki", dict(measure="jaccard",
                                      family=JHash("wminhash", m=3),
                                      window=64, leaders=8)),
    "mixture-sorting": ("prod", dict(measure="mixture", mixture_alpha=0.4,
                                     family=JHash("mixture", m=12),
                                     window=64, leaders=8)),
    "mixture-lsh": ("prod", dict(measure="mixture", mode="lsh",
                                 family=JHash("mixture", m=8), window=128)),
    "jaccard-allpairs": ("wiki", dict(measure="jaccard", source="allpairs",
                                      allpairs_block=256)),
}
# the exact sweep scores all n (n - 1) / 2 pairs: it takes the first 500
N_SWEEP = 500


@pytest.mark.parametrize("name", list(CHEAP))
def test_set_measure_build_equals_jax(name, wiki, prod):
    which, kw = CHEAP[name]
    jf, tf = {"wiki": wiki, "prod": prod}[which]
    jc = JConfig(r=3, degree_cap=16, seed=1, **kw)
    if jc.source == "allpairs":
        jf, tf = _split(jf, 0, N_SWEEP), _split(tf, 0, N_SWEEP)
    reps = 1 if jc.source == "allpairs" else jc.r
    jb = JBuilder(jf, jc).add_reps(reps)
    tb = GraphBuilder(tf, config_from_reference(jc),
                      device=CPU).add_reps(reps)
    _assert_same_build(_graph_and_bound(jb, j_acc),
                       _graph_and_bound(tb, t_acc), 1e-6)
    if jc.source == "allpairs":
        n = tf.n
        assert tb.stats["comparisons"] == n * (n - 1) // 2


# --------------------------------------------------------------------- #
# The learned measure: sessions with an extend and a restore
# --------------------------------------------------------------------- #
def _models(mode, use_sets, seed=0):
    kw = dict(in_dim=16, embed_dim=8, tower_hidden=16, head_hidden=16,
              pair_features=mode, use_set_features=use_sets)
    j_model = j_learned.LearnedSimilarity(j_learned.TwoTowerConfig(**kw))
    j_params = j_model.init(jax.random.key(seed))
    t_params = learned_params_from_reference(
        {k: np.asarray(v) for k, v in j_params.items()})
    return (JLearnedMeasure(j_model, j_params),
            LearnedMeasure(LearnedSimilarity(TwoTowerConfig(**kw)),
                           t_params))


LEARNED = {
    "raw": ("raw", True, dict(family=JHash("mixture", m=12))),
    "raw-cache": ("raw", True, dict(family=JHash("mixture", m=12),
                                    pair_cache_slots=1 << 12)),
    "embed": ("embed", False, dict(family=JHash("simhash", m=12))),
    "prefilter": ("raw", False, dict(family=JHash("simhash", m=12),
                                     hamming_prefilter_bits=64,
                                     hamming_prefilter_max=26)),
}


class _Session:
    """A JAX learned session: add_reps on the first N0 points, checkpoint,
    extend by the rest; graphs after the add and at the end."""

    def __init__(self, name, prod):
        mode, use_sets, kw = LEARNED[name]
        jf, tf = prod
        self.jc = JConfig(measure="learned", r=3, window=64, leaders=8,
                          degree_cap=16, seed=2, **kw)
        self.j_meas, self.t_meas = _models(mode, use_sets)
        self.head = (_split(jf, 0, N0), _split(tf, 0, N0))
        self.tail = (_split(jf, N0, None), _split(tf, N0, None))
        jb = JBuilder(self.head[0], self.jc, measure=self.j_meas).add_reps()
        self.j_add = _graph_and_bound(jb, j_acc)
        self.j_ckpt = jb.checkpoint()
        jb.extend(self.tail[0], reps=2)
        self.j_end = _graph_and_bound(jb, j_acc)

    def port(self, cfg=None, **kw):
        tc = config_from_reference(self.jc) if cfg is None else cfg
        tb = GraphBuilder(self.head[1], tc, measure=self.t_meas, device=CPU,
                          **kw).add_reps()
        add = _graph_and_bound(tb, t_acc)
        tb.extend(self.tail[1], reps=2)
        return add, _graph_and_bound(tb, t_acc)


@pytest.fixture(scope="module")
def sessions(prod):
    return {}


def _session(sessions, prod, name):
    if name not in sessions:
        sessions[name] = _Session(name, prod)
    return sessions[name]


@pytest.mark.parametrize("name", ["raw", "embed", "prefilter"])
def test_learned_session_equals_jax(name, sessions, prod):
    s = _session(sessions, prod, "raw-cache" if name == "raw" else name)
    if name == "raw":
        # the JAX session ran with the cache: its edges are its cache-off
        # edges (tests/test_measure.py), its stats those of the cache
        cfg = dataclasses.replace(config_from_reference(s.jc),
                                  pair_cache_slots=0)
        add, end = s.port(cfg)
        drop = ("cache_hits", "cache_misses", "cache_evictions")
        for (jg, _), (tg, _) in ((s.j_add, add), (s.j_end, end)):
            js = {k: v for k, v in jg.stats.items() if k not in drop}
            js["expensive_comparisons"] = js["comparisons"]
            assert tg.stats == js
    else:
        add, end = s.port()
    _assert_same_build(s.j_add, add, 1e-5, stats=name != "raw")
    _assert_same_build(s.j_end, end, 1e-5, stats=name != "raw")
    stats = end[0].stats
    assert stats["embed_rows"] == N_PROD
    if name == "prefilter":
        assert 0 < stats["comparisons"] < stats["prefilter_ops"]


def test_pair_cache_on_equals_off_with_jax_hit_accounting(sessions, prod):
    """Cache-on port builds equal cache-off port builds bit for bit; hits,
    misses and evictions equal the JAX cache's, round after round."""
    s = _session(sessions, prod, "raw-cache")
    on_add, on_end = s.port()
    off_cfg = dataclasses.replace(config_from_reference(s.jc),
                                  pair_cache_slots=0)
    off_add, off_end = s.port(off_cfg)
    for (on, _), (off, _), (jg, _) in ((on_add, off_add, s.j_add),
                                       (on_end, off_end, s.j_end)):
        assert _same_edges(on, off)
        st = on.stats
        for k in ("cache_hits", "cache_misses", "cache_evictions",
                  "expensive_comparisons", "comparisons"):
            assert st[k] == jg.stats[k], k
        assert st["cache_hits"] + st["cache_misses"] == st["comparisons"]
        assert st["expensive_comparisons"] == st["cache_misses"]
        assert off.stats["expensive_comparisons"] == st["comparisons"]
    assert on_end[0].stats["cache_hits"] > 0


@pytest.mark.parametrize("name", ["raw-cache", "embed"])
def test_learned_checkpoints_restore(name, sessions, prod):
    """The JAX checkpoint after the add rounds, restored on the port with
    the port measure's fingerprint stamped in, then extended, equals the
    JAX session's end; the port's own checkpoint restored and extended
    equals its uninterrupted session bit for bit (the pair cache starts
    empty after a restore, its edges do not change).  A restore under
    other tower parameters, or of the JAX fingerprint, is refused."""
    s = _session(sessions, prod, name)
    tc = config_from_reference(s.jc)
    ckpt = checkpoint_from_reference(s.j_ckpt, measure=s.t_meas)
    assert ckpt.measure_fingerprint == s.t_meas.fingerprint()
    tb = GraphBuilder.restore(s.head[1], tc, ckpt, measure=s.t_meas,
                              device=CPU)
    tb.extend(s.tail[1], reps=2)
    end = _graph_and_bound(tb, t_acc)
    assert end[0].stats["embed_rows"] == N_PROD      # re-embeds every row
    cache = ("cache_hits", "cache_misses", "cache_evictions",
             "expensive_comparisons") if tc.pair_cache_slots else ()
    assert {k: v for k, v in end[0].stats.items() if k not in cache} \
        == {k: v for k, v in s.j_end[0].stats.items() if k not in cache}
    _assert_same_build(s.j_end, end, 1e-5, stats=False)

    live = GraphBuilder(s.head[1], tc, measure=s.t_meas,
                        device=CPU).add_reps()
    own = live.checkpoint()
    live.extend(s.tail[1], reps=2)
    resumed = GraphBuilder.restore(s.head[1], tc, own, measure=s.t_meas,
                                   device=CPU)
    resumed.extend(s.tail[1], reps=2)
    assert _same_edges(resumed.finalize(), live.finalize())

    mode, use_sets, _ = LEARNED[name]
    other = _models(mode, use_sets, seed=1)[1]
    with pytest.raises(ValueError, match="different similarity measure"):
        GraphBuilder.restore(s.head[1], tc, ckpt, measure=other, device=CPU)
    with pytest.raises(ValueError, match="different similarity measure"):
        GraphBuilder.restore(s.head[1], tc, checkpoint_from_reference(
            s.j_ckpt), measure=s.t_meas, device=CPU)


def test_two_phase_equals_legacy_opaque_and_cheap_fingerprint(prod):
    """tests/test_measure.py: the two-phase measure and the same model as
    a legacy learned_apply closure build the same edges; the opaque one
    embeds nothing and meters every comparison as expensive.  A
    closed-form session checkpoints no fingerprint and restores."""
    _, tf = prod
    meas = _models("embed", False)[1]
    cfg = StarsConfig(measure="learned", r=2, window=32, leaders=4,
                      degree_cap=8, seed=3)
    g_meas = GraphBuilder(tf, cfg, measure=meas, device=CPU).add_reps() \
        .finalize()
    g_opaque = GraphBuilder(
        tf, cfg, learned_apply=lambda fa, fb: meas.model.pairwise(
            meas.params, fa, fb), device=CPU).add_reps().finalize()
    key = lambda g: {(int(a), int(b)): float(w)
                     for a, b, w in zip(g.src, g.dst, g.w)}
    assert key(g_meas) == key(g_opaque)
    assert "embed_rows" not in g_opaque.stats
    assert g_opaque.stats["expensive_comparisons"] \
        == g_opaque.stats["comparisons"]
    cheap = StarsConfig(r=2, window=32, leaders=4, degree_cap=8, seed=3)
    b = GraphBuilder(tf, cheap, device=CPU).add_reps()
    ck = b.checkpoint()
    assert ck.measure_fingerprint is None
    GraphBuilder.restore(tf, cheap, ck, device=CPU)
