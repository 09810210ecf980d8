"""The Hopper ``topk_merge`` merge design, modelled on the CPU and held
against the JAX oracle and the Pallas kernel; its preconditions, held
against the port's accumulator traffic; and its CPU route.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the plain version bit for bit.  Here:

- a plain model of the merge design's algorithm, as ``csrc/topk_merge.cu``
  states it (each input's live entries keyed as (f32 key of -w) << 32 |
  nbr; the precondition checks; cross-input dedup, the lighter instance
  dropped and the slab's kept on an exact tie; the survivors' output
  slots from merge-path ranks; weights copied by position), equals JAX's
  ``topk_merge_ref`` and the interpret-mode Pallas kernel exactly on
  hypothesis-made accumulator-shaped rows, ties and +-0.0 included; rows
  that break a precondition are counted and merged by the sort-based
  algorithm, with the same result;
- every (slab, incoming) pair that the port's accumulator hands to the
  merge, over folds with exact ties and over a small CPU build, meets the
  preconditions;
- ``ops.topk_merge`` on the CPU is ``topk_merge_ref`` and launches nothing,
  and the wrapper refuses CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.kernels import ref as j_ref
from repro.kernels.topk_merge import topk_merge as pallas_topk_merge
from repro_torch import GraphBuilder, StarsConfig
from repro_torch.graph import accumulator as t_acc
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import topk_merge as t_tm

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_stub import given, settings, st

pytestmark = pytest.mark.torch_port

DEAD = 2**64 - 1                # key of an entry that is not live
INF_KEY = 0xFF800000            # f32 key of +inf


# --------------------------------------------------------------------------- #
# the merge design, modelled
# --------------------------------------------------------------------------- #


def f32_key(x):
    """uint32 keys ordered like the float32 values (-0.0 == 0.0, NaN
    last), as the kernel's f32_key."""
    x = np.where(x == 0, np.float32(0), x).astype(np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    b = np.where(np.isnan(x), np.uint64(0x7FC00000), b)
    return np.where(b >= 2**31, b ^ 0xFFFFFFFF, b | 2**31).astype(np.uint64)


def row_keys(nbr, w):
    """The kernel's 64-bit key of each entry (DEAD where not live) and
    whether a live id carries a NaN weight."""
    wk = f32_key(-w)
    live = (nbr >= 0) & (wk < INF_KEY)
    key = np.where(live, (wk << np.uint64(32)) | nbr.astype(np.uint64),
                   np.uint64(DEAD))
    return key.astype(np.uint64), bool(((nbr >= 0) & np.isnan(w)).any())


def preconditions_hold(nbr, w) -> bool:
    """One input's row: live entries a strictly increasing prefix of the
    row in the 64-bit key, no id twice, no NaN weight on a live id."""
    key, nan = row_keys(nbr, w)
    live = key != DEAD
    na = int(live.sum())
    ids = nbr[:na]
    return (not nan and bool(live[:na].all())
            and bool((key[1:na] > key[:na][:-1]).all())
            and len(np.unique(ids)) == na)


def merge_row_model(snbr, sw, inbr, iw, k):
    """The merge design on one row: (out_nbr, out_w), or None where the
    row breaks a precondition (the kernel counts it and merges it by the
    bitonic algorithm)."""
    if not (preconditions_hold(snbr, sw) and preconditions_hold(inbr, iw)):
        return None
    ka, _ = row_keys(snbr, sw)
    kb, _ = row_keys(inbr, iw)
    na, nb = int((ka != DEAD).sum()), int((kb != DEAD).sum())
    ka, kb = ka[:na], kb[:nb]
    # cross-input duplicates: the lighter instance goes, the slab's stays
    # on an exact tie
    drop_a, drop_b = np.zeros(na, bool), np.zeros(nb, bool)
    where_b = {int(i): j for j, i in enumerate(inbr[:nb])}
    for i, ident in enumerate(snbr[:na]):
        j = where_b.get(int(ident))
        if j is not None:
            if (ka[i] >> np.uint64(32)) <= (kb[j] >> np.uint64(32)):
                drop_b[j] = True
            else:
                drop_a[i] = True
    a_key, a_w = ka[~drop_a], sw[:na][~drop_a]
    b_key, b_w = kb[~drop_b], iw[:nb][~drop_b]
    # merge-path ranks: an entry's slot is its rank in its own list plus
    # the survivors of the other list that sort before it
    slot_a = np.arange(len(a_key)) + np.searchsorted(b_key, a_key)
    slot_b = np.arange(len(b_key)) + np.searchsorted(a_key, b_key)
    out_nbr = np.full(k, -1, np.int32)
    out_w = np.full(k, -np.inf, np.float32)
    for keys, ws, slots in ((a_key, a_w, slot_a), (b_key, b_w, slot_b)):
        ok = slots < k
        out_nbr[slots[ok]] = (keys[ok] & np.uint64(0xFFFFFFFF)).astype(
            np.int32)
        out_w[slots[ok]] = ws[ok]
    return out_nbr, out_w


def merge_model(snbr, sw, inbr, iw):
    """The merge design on all rows: (out_nbr, out_w, violations)."""
    n, k = snbr.shape
    out_nbr = np.empty((n, k), np.int32)
    out_w = np.empty((n, k), np.float32)
    violations = 0
    for r in range(n):
        got = merge_row_model(snbr[r], sw[r], inbr[r], iw[r], k)
        if got is None:
            violations += 1
            got = tuple(t.numpy()[0] for t in t_ref.topk_merge_ref(
                *(torch.from_numpy(a[r:r + 1].copy())
                  for a in (snbr, sw, inbr, iw))))
        out_nbr[r], out_w[r] = got
    return out_nbr, out_w, violations


def accumulator_rows(rs, n, cols, universe, grid, fill=None):
    """Rows as the accumulator's traffic has them: distinct ids from
    ``universe``, weights on a grid of 1/``grid`` (negative ones and
    -0.0 too), live entries sorted by (-w key, nbr) then an empty tail."""
    nbr = np.full((n, cols), -1, np.int32)
    w = np.full((n, cols), -np.inf, np.float32)
    for r in range(n):
        live = rs.randint(0, cols + 1) if fill is None else fill
        ids = rs.choice(universe, size=live, replace=False).astype(np.int32)
        ws = (rs.randint(-grid // 4, grid, live) / grid).astype(np.float32)
        ws[(ws == 0) & (rs.rand(live) < 0.5)] = -0.0
        order = np.lexsort((ids, f32_key(-ws)))
        nbr[r, :live], w[r, :live] = ids[order], ws[order]
    return nbr, w


def _assert_equal(got_nbr, got_w, want):
    np.testing.assert_array_equal(got_nbr, np.asarray(want[0]))
    np.testing.assert_array_equal(got_w.view(np.int32),
                                  np.asarray(want[1]).view(np.int32))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 4),
       k=st.integers(1, 12), kin=st.integers(1, 12),
       grid=st.sampled_from([2, 8, 2**20]))
def test_merge_model_matches_jax_on_accumulator_rows(seed, n, k, kin, grid):
    """Exact against ``topk_merge_ref`` on rows with cross-input
    duplicates (ids from a universe of 1.5 (k + kin)), exact ties (coarse
    grids) and +-0.0; none of them breaks a precondition."""
    rs = np.random.RandomState(seed)
    universe = max(2, 3 * (k + kin) // 2)
    args = (*accumulator_rows(rs, n, k, universe, grid),
            *accumulator_rows(rs, n, kin, universe, grid))
    got_nbr, got_w, violations = merge_model(*args)
    assert violations == 0
    _assert_equal(got_nbr, got_w,
                  j_ref.topk_merge_ref(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("n,k,kin,grid", [(6, 8, 8, 4), (5, 16, 8, 2),
                                          (4, 3, 9, 64), (3, 12, 12, 2**20),
                                          (5, 9, 1, 4), (4, 17, 3, 2)])
def test_merge_model_matches_pallas_on_accumulator_rows(n, k, kin, grid):
    """The last two: odd k well above kin, as a fold of few candidates
    into a slab of odd capacity gives."""
    rs = np.random.RandomState(n * k + kin)
    universe = 3 * (k + kin) // 2
    args = (*accumulator_rows(rs, n, k, universe, grid),
            *accumulator_rows(rs, n, kin, universe, grid))
    got_nbr, got_w, violations = merge_model(*args)
    assert violations == 0
    _assert_equal(got_nbr, got_w, pallas_topk_merge(
        *(jnp.asarray(a) for a in args), interpret=True))


def _broken_rows():
    """Full accumulator rows of which rows 0-5 break a precondition one
    way each (as chip_smoke.broken_rows does on the card)."""
    rs = np.random.RandomState(5)
    sn, sw = accumulator_rows(rs, 9, 10, 40, 8, fill=10)
    inn, iw = accumulator_rows(rs, 9, 10, 40, 8, fill=10)
    sn[0, [0, 1]], sw[0, [0, 1]] = sn[0, [1, 0]], sw[0, [1, 0]]  # order
    sn[1, 1] = sn[1, 0]                                # slab id twice
    inn[2, 3], iw[2, 3] = -1, -np.inf                  # live after empty
    sw[3, 2] = np.nan                                  # NaN weight
    sw[4, 0] = sw[4, 1]                                # slab-first tie
    sn[4, 0], sn[4, 1] = max(sn[4, :2]), min(sn[4, :2])
    inn[5, 2] = inn[5, 0]                              # incoming id twice
    return (sn, sw, inn, iw), 6


def test_merge_model_counts_and_repairs_broken_rows():
    args, broken = _broken_rows()
    for r in range(args[0].shape[0]):
        holds = preconditions_hold(args[0][r], args[1][r]) \
            and preconditions_hold(args[2][r], args[3][r])
        assert holds == (r >= broken), r
    got_nbr, got_w, violations = merge_model(*args)
    assert violations == broken
    _assert_equal(got_nbr, got_w,
                  j_ref.topk_merge_ref(*(jnp.asarray(a) for a in args)))


# --------------------------------------------------------------------------- #
# the accumulator's traffic meets the preconditions
# --------------------------------------------------------------------------- #


@pytest.fixture
def merges(monkeypatch):
    """Every (slab, incoming) pair that the accumulator merges, recorded
    as numpy arrays."""
    seen = []
    merge = t_ops.topk_merge

    def record(*args):
        seen.append(tuple(a.numpy().copy() for a in args))
        return merge(*args)
    monkeypatch.setattr(t_ops, "topk_merge", record)
    return seen


def _assert_meets_preconditions(seen):
    assert seen
    for args in seen:
        for nbr, w in (args[:2], args[2:]):
            for r in range(nbr.shape[0]):
                assert preconditions_hold(nbr[r], w[r]), r
        # and the model's output is the merge's
        got = merge_model(*args)
        assert got[2] == 0
        _assert_equal(got[0], got[1], t_ref.topk_merge_ref(
            *(torch.from_numpy(a) for a in args)))


@pytest.mark.parametrize("n,cap,m,grid", [(40, 5, 300, 4), (60, 12, 900, 16),
                                          (7, 6, 50, 2)])
def test_accumulator_folds_meet_the_merge_preconditions(merges, n, cap, m,
                                                        grid):
    """Folds of candidate streams with repeated pairs, exact weight ties
    (weights on a coarse grid, +-0.0 among them), invalid and self-loop
    entries."""
    rs = np.random.RandomState(n + cap)
    state = t_acc.EdgeAccumulator.create(n, cap, device="cpu")
    for _ in range(4):
        src = torch.from_numpy(rs.randint(-1, n, m).astype(np.int32))
        dst = torch.from_numpy(rs.randint(-1, n, m).astype(np.int32))
        w = rs.randint(-grid, grid, m) / grid
        w = np.where((w == 0) & (rs.rand(m) < 0.5), -0.0, w)
        valid = torch.from_numpy(rs.rand(m) < 0.8)
        state = t_acc.accumulate(state, src, dst,
                                 torch.from_numpy(w.astype(np.float32)),
                                 valid)
    _assert_meets_preconditions(merges)


def test_small_build_merges_meet_the_merge_preconditions(merges):
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.randn(300, 16).astype(np.float32))
    GraphBuilder(x, StarsConfig(window=20, leaders=3, r=3, degree_cap=8),
                 device="cpu").add_reps().finalize()
    _assert_meets_preconditions(merges)


# --------------------------------------------------------------------------- #
# the CPU route
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("rows", ["accumulator", "broken"])
def test_ops_topk_merge_on_cpu_is_the_plain_version(rows):
    rs = np.random.RandomState(2)
    args = _broken_rows()[0] if rows == "broken" else (
        *accumulator_rows(rs, 7, 9, 20, 4), *accumulator_rows(rs, 7, 6, 20, 4))
    args = tuple(torch.from_numpy(a) for a in args)
    before = t_tm.launches
    got = t_ops.topk_merge(*args)
    want = t_ref.topk_merge_ref(*args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert t_tm.launches == before


def test_topk_merge_wrapper_refuses_cpu_tensors():
    rs = np.random.RandomState(4)
    args = tuple(torch.from_numpy(a) for a in (
        *accumulator_rows(rs, 2, 3, 9, 4), *accumulator_rows(rs, 2, 3, 9, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        t_tm.topk_merge(*args)
