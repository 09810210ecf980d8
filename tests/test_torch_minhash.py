"""The port's MinHash families, multi-word SortingLSH windows and synthetic
set data against the JAX package, on the CPU.

MinHash, weighted MinHash (the exponential race) and mixture sketches
are compared word for word with ``repro.core.lsh.sketch`` on the JAX
package's own ``wikipedia_like_sets`` / ``products_like_points`` data, as
are their bucket keys, the SortingLSH grids that sort 32-bit words (M
words plus the tiebreak, a chain of stable sorts past 63 bits) and the
leaders drawn on them: all exact.  The port's generators equal JAX's in
every integer field, their floats within 1e-6.  The single-family
properties of ``tests/test_lsh.py`` hold on the port.
"""

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
import jax.numpy as jnp
from repro.core import lsh as j_lsh
from repro.core import stars as j_stars
from repro.core import windows as j_win
from repro.data.synthetic import products_like_points as j_products
from repro.data.synthetic import wikipedia_like_sets as j_wikipedia
from repro.similarity.measures import PointFeatures as JFeatures
from repro_torch.core import lsh as t_lsh
from repro_torch.core import stars as t_stars
from repro_torch.core import windows as t_win
from repro_torch.core.convert import config_from_reference
from repro_torch.data import products_like_points, wikipedia_like_sets
from repro_torch.similarity.measures import PointFeatures

pytestmark = pytest.mark.torch_port

FIELDS = ("dense", "set_idx", "set_w", "set_mask")


def _port(jf) -> PointFeatures:
    return PointFeatures(**{f: None if getattr(jf, f) is None else
                            torch.from_numpy(np.array(getattr(jf, f)))
                            for f in FIELDS})


WIKI = dict(classes=8, nnz=16, dup_frac=0.3, seed=2)
PROD = dict(d=24, classes=8, nnz=8, dup_frac=0.3, seed=2)


@pytest.fixture(scope="module")
def generated():
    """Each generator's (JAX features, JAX labels, port features, port
    labels) at n = 1,500."""
    return {"wiki": (*j_wikipedia(1500, **WIKI),
                     *wikipedia_like_sets(1500, device="cpu", **WIKI)),
            "prod": (*j_products(1500, **PROD),
                     *products_like_points(1500, device="cpu", **PROD))}


@pytest.fixture(scope="module")
def data(generated):
    wiki, prod = generated["wiki"][0], generated["prod"][0]
    # an empty set among them: it hashes to 0xFFFFFFFF in every family
    mask = np.array(wiki.set_mask)
    mask[7] = False
    wiki = JFeatures(set_idx=wiki.set_idx, set_w=wiki.set_w,
                     set_mask=jnp.asarray(mask))
    return {"wiki": wiki, "prod": prod}


@pytest.mark.parametrize("kind,m", [("minhash", 3), ("wminhash", 3),
                                    ("mixture", 16), ("simhash", 16)])
def test_sketch_words_and_bucket_keys_equal_jax(data, kind, m):
    jf = data["prod" if kind in ("mixture", "simhash") else "wiki"]
    jc = j_lsh.HashFamilyConfig(kind, m=m, mixture_sim_prob=0.4)
    tc = t_lsh.HashFamilyConfig(kind, m=m, mixture_sim_prob=0.4)
    tf = _port(jf)
    for rep_seed in (0, 5 ^ 3):
        want = np.asarray(j_lsh.sketch(jf, jc, rep_seed=rep_seed))
        got = t_lsh.sketch(tf, tc, rep_seed=rep_seed)
        assert got.dtype == torch.int64 and got.shape == (1500, m)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(
            t_lsh.bucket_key(got, tc).numpy(),
            np.asarray(j_lsh.bucket_key(jnp.asarray(want), jc))
            .astype(np.int64))
    if kind in ("minhash", "wminhash"):
        assert (got[7] == 0xFFFFFFFF).all()
        assert len(np.unique(got[:, 0].numpy())) > 100


def test_weighted_minhash_properties():
    """tests/test_lsh.py's weighted MinHash cases: identical sets always
    collide; collisions grow with the overlap."""
    rs = np.random.RandomState(0)
    idx = torch.from_numpy(rs.randint(0, 1000, (1, 20)).astype(np.int32))
    w = torch.from_numpy(rs.rand(1, 20).astype(np.float32) + 0.1)
    mask = torch.ones((1, 20), dtype=torch.bool)
    seeds = t_lsh._slot_seeds(256, 7, "cpu")
    a = t_lsh.weighted_minhash_words(idx, w, mask, seeds)
    assert torch.equal(a, t_lsh.weighted_minhash_words(idx, w, mask, seeds))
    rates = []
    for overlap in (0, 10, 20):
        ib = idx.clone()
        ib[0, overlap:] += 5000
        b = t_lsh.weighted_minhash_words(ib, w, mask, seeds)
        rates.append(float((a == b).float().mean()))
    assert rates[0] == 0.0 and rates[0] < rates[1] < rates[2] == 1.0


@pytest.mark.parametrize("kind,m,window", [("wminhash", 3, 64),
                                           ("minhash", 2, 100),
                                           ("mixture", 16, 64)])
def test_multiword_sorting_windows_equal_jax(data, kind, m, window):
    """SortingLSH over 32-bit MinHash words (three int64 sort keys at
    M = 3) and over mixture bits (one key): the grid and the leaders
    equal the JAX package's."""
    jf = data["prod" if kind == "mixture" else "wiki"]
    jc = j_stars.StarsConfig(family=j_lsh.HashFamilyConfig(kind, m=m),
                             window=window, leaders=8, seed=4)
    tc = config_from_reference(jc)
    rep = 3
    rep_seed = rep ^ jc.seed
    j_words = j_lsh.sketch(jf, jc.family, rep_seed=rep_seed)
    t_words = t_lsh.sketch(_port(jf), tc.family, rep_seed=rep_seed)
    jk = j_stars._rep_keys(jc, jnp.int32(rep))
    tk = t_stars._rep_keys(tc, rep)
    jg = j_stars._rep_window_grid(jc, j_words, jk[0], jk[1])
    tg = t_stars._rep_window_grid(tc, t_words, tk[0], tk[1])
    np.testing.assert_array_equal(tg.gid.numpy(), np.asarray(jg.gid))
    np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
    j_slot, j_ok = j_win.sample_leaders(jg, s=8, key=jk[2])
    t_slot, t_ok = t_win.sample_leaders(tg, s=8, key=tk[2])
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    tb = torch.zeros(4, dtype=torch.int64)
    n_keys = len(t_win.sort_keys(t_words[:4], t_lsh.word_bits(tc.family),
                                 tb, t_stars.TIEBREAK_BITS))
    assert n_keys == (m if kind != "mixture" else 1)


@pytest.mark.parametrize("kind", ["minhash", "mixture"])
def test_lsh_mode_grid_of_set_families_equals_jax(data, kind):
    jf = data["prod" if kind == "mixture" else "wiki"]
    jc = j_stars.StarsConfig(mode="lsh",
                             family=j_lsh.HashFamilyConfig(kind, m=2),
                             window=64, seed=1)
    tc = config_from_reference(jc)
    jk = j_stars._rep_keys(jc, jnp.int32(1))
    tk = t_stars._rep_keys(tc, 1)
    jg = j_stars._rep_window_grid(
        jc, j_lsh.sketch(jf, jc.family, rep_seed=1 ^ 1), jk[0], jk[1])
    tg = t_stars._rep_window_grid(
        tc, t_lsh.sketch(_port(jf), tc.family, rep_seed=1 ^ 1), tk[0], tk[1])
    np.testing.assert_array_equal(tg.gid.numpy(), np.asarray(jg.gid))
    np.testing.assert_array_equal(tg.bucket.numpy(),
                                  np.asarray(jg.bucket).view(np.int32))


@pytest.mark.parametrize("which", ["prod", "wiki"])
def test_generators_equal_jax(generated, which):
    """products_like_points and wikipedia_like_sets, near-duplicates
    included: integer and boolean fields exact, floats within 1e-6."""
    jf, jl, tf, tl = generated[which]
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for f in FIELDS:
        want, got = getattr(jf, f), getattr(tf, f)
        assert (want is None) == (got is None), f
        if want is None:
            continue
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, f
        if want.dtype == np.float32:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
