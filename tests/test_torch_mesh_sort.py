"""The mesh's sort layer against the JAX package, on gloo ranks on the CPU.

``pack_bit_fields`` / ``unpack_bit_fields`` (on ``tests/test_sort_keys.py``'s
widths) and the striped window-row layout
(``shard_row_layout`` / ``shard_row_permutation``) are compared with the
JAX functions word for word.  The sample sort runs on p = 2 and 4 gloo
ranks (``repro_torch.testing.RankPool``, spawned once for the module):
its output, concatenated in rank order, must be the lexsort of the
input; the window slot blocks at p = 1, 2 and 4 must assemble to the
JAX single-device window grid of the same repetition, including windows
whose members straddle two ranks' sort output (n = 302, W = 64, as in
``tests/test_mesh_parity.py``); the replicated permutation must equal
JAX's ``distributed_argsort``.  All integers exactly.
"""

import numpy as np
import pytest

import repro.core  # noqa: F401  (imports repro's modules in a working order)
import jax
import jax.numpy as jnp
from repro.core import lsh as j_lsh
from repro.core import windows as j_win
from repro.core.stars import _rep_keys as j_rep_keys
from repro.core.stars import _rep_window_grid as j_rep_window_grid
from repro.data import mnist_like_points
from repro.distributed import sorter as j_sorter
from repro.similarity.measures import PointFeatures as JPointFeatures
from repro_torch import HashFamilyConfig, StarsConfig
from repro_torch.core import windows as t_win
from repro_torch.core.stars import _rep_keys as t_rep_keys
from repro_torch.distributed import sorter as t_sorter
from repro_torch.testing import RankPool

import torch
import torch_mesh_jobs as jobs

pytestmark = pytest.mark.torch_port

SIZES = (1, 2, 4)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("mesh") / "rendezvous",
                  sizes=SIZES) as p:
        yield p


# tests/test_sort_keys.py's layouts: SimHash bits, an LSH bucket, a field
# across a word boundary, zero-width pads, the gid field last
WIDTHS = [[1] * 16 + [20, 7, 21], [32, 20, 0, 12], [20, 32, 12],
          [0, 0, 32], [7, 13, 32, 1, 11], [5], [32, 32, 32]]


@pytest.mark.parametrize("widths", WIDTHS,
                         ids=lambda w: "-".join(map(str, w)))
def test_pack_bit_fields_equals_jax(widths):
    rng = np.random.default_rng(len(widths) * 100 + sum(widths))
    n = 97
    # unmasked random words: the packers must mask to each width
    fields = [rng.integers(0, 2**32, size=n, dtype=np.uint64)
              .astype(np.uint32) for _ in widths]
    want = np.asarray(j_sorter.pack_bit_fields(
        [jnp.asarray(f) for f in fields], widths))
    got = t_sorter.pack_bit_fields(
        [torch.from_numpy(f.astype(np.int64)) for f in fields], widths)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    j_out = j_sorter.unpack_bit_fields(jnp.asarray(want), widths)
    t_out = t_sorter.unpack_bit_fields(got, widths)
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.int64))
    with pytest.raises(ValueError):
        t_sorter.pack_bit_fields([torch.zeros(1, dtype=torch.int64)], [33])


ROWS = 4096


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("mode", ["sorting", "lsh"])
def test_shard_row_layout_and_permutation_equal_jax(mode, p):
    for n in (1, 63, 64, 65, 302, 602, 1000):
        for w in (1, 16, 64, 250):
            layout = t_win.shard_row_layout(mode, n, w, p)
            assert layout == j_win.shard_row_layout(mode, n, w, p)
            _, rps, _ = layout
            # one shape for every call: JAX compiles its ops once
            rows = np.arange(ROWS)
            want = np.asarray(j_win.shard_row_permutation(
                jnp.asarray(rows), rps, p))
            got = t_win.shard_row_permutation(torch.from_numpy(rows), rps, p)
            np.testing.assert_array_equal(got.numpy(), want)
            live = want[:p * rps]
            assert sorted(live.tolist()) == list(range(p * rps))
    with pytest.raises(ValueError):
        t_win.shard_row_layout(mode, 10, 4, 0)


def _sort_input(seed, n=1001, nk=3):
    """Multi-word keys with many ties (small word values), ids as the last
    key, a few rows left out (id -1)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 3, size=(n, nk)).astype(np.int64)
    keys[:, 0] = rng.choice([0, 2**31, 2**32 - 1], size=n)  # the top bit
    ids = rng.permutation(n).astype(np.int32)
    ids[rng.choice(n, 17, replace=False)] = -1
    return keys, ids


@pytest.mark.parametrize("p", [2, 4])
def test_distributed_sort_is_a_global_lexsort(pool, p):
    keys, ids = _sort_input(p)
    out = pool.run(jobs.sort_job, keys, ids, size=p)
    got_k = np.concatenate([o[0] for o in out])
    got_p = np.concatenate([o[1] for o in out])
    assert all(o[2].all() for o in out) and sum(o[3] for o in out) == 0
    live = ids >= 0
    order = np.lexsort((ids[live],) + tuple(keys[live].T[::-1]))
    np.testing.assert_array_equal(got_p, ids[live][order])
    np.testing.assert_array_equal(got_k, keys[live][order])
    # the runs partition the output: every rank got a non-empty run
    assert all(len(o[1]) > 0 for o in out)


@pytest.mark.parametrize("p", [2, 4])
def test_distributed_argsort_equals_jax(pool, p):
    keys, ids = _sort_input(10 + p, n=300, nk=2)
    keys[ids < 0] = 0xFFFFFFFF             # JAX's rule for left-out rows
    mesh = jax.make_mesh((1,), ("data",))
    want, _ = j_sorter.distributed_argsort(
        jnp.asarray(keys.astype(np.uint32)), jnp.asarray(ids), mesh, 300)
    out = pool.run(jobs.argsort_job, keys, ids, 300, size=p)
    for perm, dropped in out:
        np.testing.assert_array_equal(perm, np.asarray(want))
        assert dropped == 0


def _jax_grid(x, mode, rep, w):
    """The JAX single-device window grid of repetition ``rep``."""
    from repro.core import HashFamilyConfig as JHash
    from repro.core import StarsConfig as JConfig
    cfg = JConfig(mode=mode, scoring="stars", family=JHash("simhash", m=8),
                  measure="cosine", r=1, window=w, leaders=4, degree_cap=10,
                  seed=7)
    rep_seed = jnp.uint32(rep) ^ jnp.uint32(cfg.seed)
    words = j_lsh.sketch(JPointFeatures(dense=jnp.asarray(x)), cfg.family,
                         rep_seed=rep_seed)
    k_tie, k_shift, _, _ = j_rep_keys(cfg, jnp.int32(rep))
    win = j_rep_window_grid(cfg, words, k_tie, k_shift)
    return (np.asarray(win.gid),
            np.asarray(win.bucket).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("mode", ["sorting", "lsh"])
def test_window_blocks_assemble_the_jax_grid(pool, mode, p):
    n, w = 302, 64          # runs of ~302 / p ids: windows straddle them
    feats, _ = mnist_like_points(n=n, d=16, classes=5, spread=0.25, seed=0)
    x = np.asarray(feats.dense)
    cfg = StarsConfig(mode=mode, scoring="stars",
                      family=HashFamilyConfig("simhash", m=8),
                      measure="cosine", r=1, window=w, leaders=4,
                      degree_cap=10, seed=7)
    nw, rps, total = t_win.shard_row_layout(mode, n, w, p)
    for rep in (0, 1):
        ref_gid, ref_bucket = _jax_grid(x, mode, rep, w)
        blocks = pool.run(jobs.window_blocks_job, x, cfg, rep, size=p)
        assert all(g.shape == (total // p,) for g, _, _ in blocks)
        grid_gid = np.concatenate([g for g, _, _ in blocks]).reshape(-1, w)
        grid_bucket = np.concatenate([b for _, b, _ in blocks]) \
            .reshape(-1, w)
        # physical row of global row r: rank r % p, local row r // p
        phys = t_win.shard_row_permutation(np.arange(nw), rps, p)
        np.testing.assert_array_equal(grid_gid[phys], ref_gid)
        np.testing.assert_array_equal(grid_bucket[phys], ref_bucket)
        rest = np.setdiff1d(np.arange(total // w), phys)
        assert (grid_gid[rest] == -1).all()          # rows past the grid
        assert (grid_bucket[grid_gid < 0] == t_win.PAD_BUCKET).all()
        # the sort's runs end inside a window: its members came from two
        # ranks' runs and still arrived whole at their one owner
        ends = np.cumsum([r for _, _, r in blocks])
        assert ends[-1] == n
        offset, _ = t_win.window_layout(
            mode, n, w, t_rep_keys(cfg, rep)[1])
        if p > 1:
            assert ((offset + ends[:-1]) % w != 0).any()
