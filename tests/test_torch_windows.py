"""The port's sketch, window grid and leader sample against the JAX package.

Every discrete choice of a repetition must be bit-equal: the SimHash
words, the sorted window grid (gid, valid, bucket) and the leader slots.
Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import lsh as j_lsh
from repro.core import stars as j_stars
from repro.core import windows as j_win
from repro.similarity.measures import PointFeatures as JFeatures
from repro_torch.core import lsh as t_lsh
from repro_torch.core import stars as t_stars
from repro_torch.core import windows as t_win
from repro_torch.similarity.measures import PointFeatures as TFeatures

pytestmark = pytest.mark.torch_port


def _points(n, d, seed):
    rs = np.random.RandomState(seed)
    centers = rs.randn(8, d)
    x = centers[rs.randint(0, 8, n)] + 0.3 * rs.randn(n, d)
    return x.astype(np.float32)


def _cfgs(m, window, leaders, seed, mode="sorting"):
    jc = j_stars.StarsConfig(mode=mode,
                             family=j_lsh.HashFamilyConfig("simhash", m=m),
                             window=window, leaders=leaders, seed=seed)
    tc = t_stars.StarsConfig(mode=mode,
                             family=t_lsh.HashFamilyConfig("simhash", m=m),
                             window=window, leaders=leaders, seed=seed)
    return jc, tc


def _rep(n, d, m, window, leaders, seed, rep, mode="sorting"):
    """One repetition's sketch, grid and leaders in both packages."""
    x = _points(n, d, seed)
    jc, tc = _cfgs(m, window, leaders, seed, mode)
    rep_seed = rep ^ seed
    j_words = j_lsh.sketch(JFeatures(dense=jnp.asarray(x)), jc.family,
                           rep_seed=rep_seed)
    t_bits = t_lsh.sketch(TFeatures(dense=torch.from_numpy(x)), tc.family,
                          rep_seed=rep_seed)
    jk = j_stars._rep_keys(jc, jnp.int32(rep))
    tk = t_stars._rep_keys(tc, rep)
    j_grid = j_stars._rep_window_grid(jc, j_words, jk[0], jk[1])
    t_grid = t_stars._rep_window_grid(tc, t_bits, tk[0], tk[1])
    j_lead = j_win.sample_leaders(j_grid, s=leaders, key=jk[2])
    t_lead = t_win.sample_leaders(t_grid, s=leaders, key=tk[2])
    return (j_words, j_grid, j_lead), (t_bits, t_grid, t_lead)


@pytest.mark.parametrize("n,d,m", [(500, 16, 16), (1000, 32, 20),
                                   (777, 8, 12)])
@pytest.mark.parametrize("rep", [0, 3])
def test_sketch_words_bit_equal(n, d, m, rep):
    (j_words, _, _), (t_bits, _, _) = _rep(n, d, m, 64, 8, 5, rep)
    np.testing.assert_array_equal(t_bits.numpy().astype(np.uint32),
                                  np.asarray(j_words))


@pytest.mark.parametrize("n,window,leaders", [
    (1000, 50, 8),       # n a multiple of W
    (1003, 64, 10),      # n not a multiple of W
    (257, 250, 25),      # the default W and s, fewer points than 2 windows
    (90, 32, 32),        # s == W: every valid slot leads
])
@pytest.mark.parametrize("rep", [0, 5])
def test_window_grid_and_leaders_bit_equal(n, window, leaders, rep):
    (_, jg, (j_slot, j_ok)), (_, tg, (t_slot, t_ok)) = _rep(
        n, 16, 16, window, leaders, 7, rep)
    np.testing.assert_array_equal(tg.gid.numpy(), np.asarray(jg.gid))
    np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
    np.testing.assert_array_equal(tg.bucket.numpy(),
                                  np.asarray(jg.bucket).view(np.int32))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    ok = np.asarray(j_ok)
    np.testing.assert_array_equal(t_slot.numpy()[ok], np.asarray(j_slot)[ok])
    # ties among pad slots (all -1.0) follow lax.top_k's lower-index rule
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))


@pytest.mark.parametrize("n,window", [(1000, 250), (10, 4), (251, 250)])
def test_window_layout_matches(n, window):
    jc, tc = _cfgs(16, window, 4, 3)
    for rep in range(4):
        jk = j_stars._rep_keys(jc, jnp.int32(rep))
        tk = t_stars._rep_keys(tc, rep)
        j_off, j_slots = j_win.window_layout("sorting", n, window, jk[1])
        assert t_win.window_layout("sorting", n, window, tk[1]) \
            == (int(j_off), j_slots)


def test_pack_bits_matches():
    rs = np.random.RandomState(0)
    bits = rs.rand(33, 40) > 0.5
    np.testing.assert_array_equal(
        t_lsh.pack_bits(torch.from_numpy(bits)).numpy(),
        np.asarray(j_lsh.pack_bits(jnp.asarray(bits))).astype(np.int64))


def test_sort_key_needs_63_bits():
    """Keys stay within 63 bits: M = 43 SimHash bits and the 20-bit
    tiebreak pack into one int64; M = 44 needs a second key, and the
    chained stable sort orders the points as a lexicographic sort of
    (words, tiebreak, gid) does."""
    rs = np.random.RandomState(1)
    tb = torch.from_numpy(rs.randint(0, 4, 64).astype(np.int64) << 30)
    assert len(t_win.sort_keys(torch.zeros((64, 43), dtype=torch.int64), 1,
                               tb, 20)) == 1
    words = rs.randint(0, 2, (64, 44)).astype(np.int64)
    words[:, :40] = 0                     # many ties on the leading words
    keys = t_win.sort_keys(torch.from_numpy(words), 1, tb, 20)
    assert len(keys) == 2
    assert all(int(k.max()) < 2**63 and int(k.min()) >= 0 for k in keys)
    cols = [np.arange(64), tb.numpy() >> 12] + [words[:, j] for j in
                                                 range(43, -1, -1)]
    np.testing.assert_array_equal(t_win.lexsort_gids(keys).numpy(),
                                  np.lexsort(cols))


@pytest.mark.parametrize("n,m,window", [(1000, 8, 64), (777, 12, 100)])
def test_lsh_mode_grid_bit_equal(n, m, window):
    """LSH mode end to end from the points: sketch, bucket ids, sort and
    windows.  Eight clusters at M = 8 give buckets larger than W, so
    buckets split across windows; the last window holds pad slots."""
    (_, jg, _), (_, tg, _) = _rep(n, 16, m, window, 4, 3, 2, mode="lsh")
    np.testing.assert_array_equal(tg.gid.numpy(), np.asarray(jg.gid))
    np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
    np.testing.assert_array_equal(tg.bucket.numpy(),
                                  np.asarray(jg.bucket).view(np.int32))
    assert not tg.valid.all()
    b, v = tg.bucket, tg.valid
    assert ((b[:-1, -1] == b[1:, 0]) & v[:-1, -1] & v[1:, 0]).any()


@pytest.mark.parametrize("row_offset,stride,total_rows", [
    (0, 1, 9), (1, 2, 9), (2, 3, 7)])
def test_leader_sample_of_a_row_subset_matches(row_offset, stride,
                                                 total_rows):
    """The sharded form: rows ``row_offset + stride * [0, nw)`` of a
    ``total_rows`` grid draw exactly the JAX package's leaders."""
    (_, jg, _), (_, tg, _) = _rep(600, 16, 16, 64, 6, 2, 1)
    nw = 4
    rows = row_offset + stride * np.arange(nw)
    rows = np.minimum(rows, jg.gid.shape[0] - 1)
    j_sub = j_win.Windows(gid=jg.gid[rows], valid=jg.valid[rows],
                          bucket=jg.bucket[rows])
    t_sub = t_win.Windows(gid=tg.gid[rows], valid=tg.valid[rows],
                          bucket=tg.bucket[rows])
    jk = j_stars._rep_keys(j_stars.StarsConfig(seed=2), jnp.int32(1))
    tk = t_stars._rep_keys(t_stars.StarsConfig(seed=2), 1)
    kw = dict(s=6, row_offset=row_offset, total_rows=total_rows,
              stride=stride)
    j_slot, j_ok = j_win.sample_leaders(j_sub, key=jk[2], **kw)
    t_slot, t_ok = t_win.sample_leaders(t_sub, key=tk[2], **kw)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    for offset in (0, 3, 9):
        assert t_stars._scored_rows(nw, offset, total_rows, stride) \
            == int(j_stars._scored_rows(nw, offset, total_rows, stride))
    assert t_stars._scored_rows(nw, 0, None) == nw
    assert t_win.window_layout("lsh", 1003, 64) \
        == tuple(int(v) for v in j_win.window_layout("lsh", 1003, 64))
