"""The port's plain kernel versions against the JAX oracles and the Pallas
kernels (interpret mode), and the device dispatch.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.  Here the plain versions must
match ``repro.kernels.ref`` and the Pallas kernels: discrete outputs
exactly, window similarities within 2e-6 (the Pallas kernel's own
tolerance against its oracle; the two frameworks sum the dot product in
different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.kernels import ref as j_ref
from repro.kernels.topk_merge import topk_merge as pallas_topk_merge
from repro.kernels.window_score import window_score as pallas_window_score
from repro_torch.kernels import leader_score as t_ls
from repro_torch.kernels import ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import simhash as t_sh
from repro_torch.kernels import topk_merge as t_tm
from repro_torch.kernels import window_score as t_ws

pytestmark = pytest.mark.torch_port

VARIANTS = [
    # (normalized, allpairs, match_bucket, new_from, refresh_below, r1)
    (True, False, False, 0, 0, None),
    (False, False, False, 0, 0, None),
    (True, True, False, 0, 0, None),
    (True, False, True, 0, 0, None),
    (True, False, False, 7, 0, None),
    (True, False, False, 0, 9, None),
    (False, True, True, 5, 11, 0.2),
]
SHAPES = [(1, 4, 8, 16), (5, 8, 24, 16), (3, 25, 250, 64), (2, 1, 16, 8)]


def _window_inputs(nw, s, w, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(nw, s, d).astype(np.float32),
            rs.randn(nw, w, d).astype(np.float32),
            rs.randint(0, w, (nw, s)).astype(np.int32),
            rs.randint(0, 16, (nw, s)).astype(np.int32),
            rs.randint(0, 16, (nw, w)).astype(np.int32),
            rs.rand(nw, s) > 0.2, rs.rand(nw, w) > 0.2,
            rs.randint(0, 3, (nw, s)).astype(np.uint32),
            rs.randint(0, 3, (nw, w)).astype(np.uint32),
            rs.rand(nw) > 0.4)


def _torch_args(args):
    # uint32 buckets travel as their int32 bit patterns
    return tuple(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                  else a) for a in args)


def _kw(variant):
    normalized, allpairs, match_bucket, new_from, refresh_below, r1 = variant
    return dict(normalized=normalized, allpairs=allpairs,
                match_bucket=match_bucket, new_from=new_from,
                refresh_below=refresh_below, r1=r1)


def _assert_window_outputs(got, want):
    sims, sims_want = got[0].numpy(), np.asarray(want[0])
    np.testing.assert_array_equal(np.isneginf(sims), np.isneginf(sims_want),
                                  err_msg="sims -inf pattern")
    fin = np.isfinite(sims_want)
    np.testing.assert_allclose(sims[fin], sims_want[fin], atol=2e-6,
                               err_msg="sims")
    for g, w, name in zip(got[1:], want[1:],
                          ("emit", "comparisons", "emitted")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("nw,s,w,d", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_window_score_plain_matches_jax(nw, s, w, d, variant, against):
    args = _window_inputs(nw, s, w, d, seed=nw * w + s)
    kw = _kw(variant)
    got = t_ref.window_score_ref(*_torch_args(args), **kw)
    jargs = tuple(jnp.asarray(a) for a in args)
    if against == "ref":
        want = j_ref.window_score_ref(*jargs, **kw)
    else:
        want = pallas_window_score(*jargs, interpret=True, **kw)
    _assert_window_outputs(got, want)


def _slab_rows(rs, n, cols, nbr_hi):
    nbr = rs.randint(-1, nbr_hi, (n, cols)).astype(np.int32)
    w = rs.rand(n, cols).astype(np.float32)
    w[nbr < 0] = -np.inf
    return nbr, w


@pytest.mark.parametrize("n,k,kin", [(1, 4, 4), (17, 8, 8), (64, 16, 8),
                                     (5, 3, 9), (33, 50, 50)])
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_topk_merge_plain_matches_jax(n, k, kin, against):
    rs = np.random.RandomState(n * k + kin)
    snbr, sw = _slab_rows(rs, n, k, 3 * k)
    inbr, iw = _slab_rows(rs, n, kin, 3 * k)
    args = (snbr, sw, inbr, iw)
    got = t_ref.topk_merge_ref(*(torch.from_numpy(a) for a in args))
    jargs = tuple(jnp.asarray(a) for a in args)
    want = (j_ref.topk_merge_ref(*jargs) if against == "ref"
            else pallas_topk_merge(*jargs, interpret=True))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                  np.asarray(want[1]).view(np.int32))


def test_topk_merge_plain_exact_ties_and_duplicates():
    """Weights on a coarse grid: in-row and cross-input duplicates and
    exact ties, broken as ``topk_merge_ref`` breaks them."""
    rs = np.random.RandomState(3)
    n, k, kin = 40, 12, 12
    snbr = rs.randint(-1, 20, (n, k)).astype(np.int32)
    inbr = rs.randint(-1, 20, (n, kin)).astype(np.int32)
    sw = (rs.randint(0, 4, (n, k)) / 4).astype(np.float32)
    iw = (rs.randint(0, 4, (n, kin)) / 4).astype(np.float32)
    sw[snbr < 0] = -np.inf
    iw[inbr < 0] = -np.inf
    sw[0, 0], iw[0, 0], snbr[0, 0], inbr[0, 0] = 0.0, -0.0, 3, 3
    got = t_ref.topk_merge_ref(*(torch.from_numpy(a)
                                 for a in (snbr, sw, inbr, iw)))
    want = j_ref.topk_merge_ref(*(jnp.asarray(a)
                                  for a in (snbr, sw, inbr, iw)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                  np.asarray(want[1]).view(np.int32))


def test_f32_sort_key_orders_like_floats():
    x = torch.tensor([float("-inf"), -2.5, -1e-30, -0.0, 0.0, 1e-30, 3.0,
                      float("inf"), float("nan")])
    key = t_ref.f32_sort_key(x)
    assert (key[1:] >= key[:-1]).all()
    assert key[3] == key[4]                 # -0.0 equals 0.0
    assert key[-1] > key[-2]                # NaN after +inf


def _leader_simhash_args(seed):
    args = _torch_args(_window_inputs(2, 4, 8, 16, seed=seed))
    rs = np.random.RandomState(seed)
    sim = (torch.from_numpy(rs.randn(9, 16).astype(np.float32)),
           torch.from_numpy(rs.randn(16, 40).astype(np.float32)))
    return (args[0], args[1], args[5], args[6]), sim


def test_cpu_tensors_dispatch_to_plain_versions():
    args = _torch_args(_window_inputs(2, 4, 8, 16, seed=0))
    before = (t_ws.launches, t_tm.launches, t_ls.launches, t_sh.launches)
    got = ops.window_score(*args, r1=0.1)
    want = t_ref.window_score_ref(*args, r1=0.1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rs = np.random.RandomState(0)
    slabs = [torch.from_numpy(a) for a in (*_slab_rows(rs, 6, 4, 9),
                                           *_slab_rows(rs, 6, 4, 9))]
    for g, w in zip(ops.topk_merge(*slabs), t_ref.topk_merge_ref(*slabs)):
        assert torch.equal(g, w)
    lead, sim = _leader_simhash_args(0)
    for normalized in (True, False):
        assert torch.equal(
            ops.leader_score(*lead, normalized=normalized),
            t_ref.leader_score_ref(*lead, normalized=normalized))
    assert torch.equal(ops.simhash_packed(*sim),
                       t_ref.simhash_packed_ref(*sim))
    assert (t_ws.launches, t_tm.launches, t_ls.launches,
            t_sh.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    args = _torch_args(_window_inputs(1, 2, 4, 8, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        t_ws.window_score(*args)
    rs = np.random.RandomState(1)
    slabs = [torch.from_numpy(a) for a in (*_slab_rows(rs, 2, 3, 5),
                                           *_slab_rows(rs, 2, 3, 5))]
    with pytest.raises(ValueError, match="CUDA"):
        t_tm.topk_merge(*slabs)
    lead, sim = _leader_simhash_args(1)
    with pytest.raises(ValueError, match="CUDA"):
        t_ls.leader_score(*lead)
    with pytest.raises(ValueError, match="CUDA"):
        t_sh.simhash_packed(*sim)
