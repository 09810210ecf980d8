"""The Hopper ``window_score`` pipe design, modelled on the CPU and held
against the JAX oracle and the Pallas kernel; and its design picker.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds both
of its designs against the plain version.  Here a plain model of the pipe
design's arithmetic (``csrc/pipe.cuh``'s order of operations: a row's
squares in one fmaf chain, the division correctly rounded, d summed in two
halves and the halves added; the model of
``tests/test_torch_prefilter_kernels.py``), followed by
``csrc/window_score.cu``'s mask chain and per-window counters, agrees with
JAX's ``window_score_ref`` and the interpret-mode Pallas kernel over the
seven mask variants of ``tests/test_torch_kernels.py``: similarities
within its 2e-6 (rows scaled by 1/sqrt(d), so that the dot products are
O(1) as the builds' near-unit-norm rows give), the -inf pattern and
comparisons exactly, the emit mask and emitted counts exactly away from
r1 (within 2e-6 of it a decision may flip).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.kernels import ref as j_ref
from repro.kernels.window_score import window_score as pallas_window_score
from repro_torch.kernels import window_score as t_ws
from test_torch_prefilter_kernels import pipe_model

pytestmark = pytest.mark.torch_port

TOL = 2e-6
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


def window_pipe_model(leaders, members, leader_slot, lead_gid, gid,
                      leader_ok, member_ok, lead_bucket, bucket, keep, *,
                      normalized, allpairs, match_bucket, new_from,
                      refresh_below, r1):
    """The pipe design on the CPU: pipe_model's similarities, then the
    mask chain in window_score.cu's order and the per-window counts."""
    sims = pipe_model(leaders, members, leader_ok, member_ok, normalized)
    w = members.shape[1]
    m = np.arange(w)[None, None, :]
    lslot = leader_slot[:, :, None]
    mask0 = leader_ok[:, :, None] & member_ok[:, None, :]
    mask = mask0 & (lslot != m)
    if allpairs:
        mask &= lslot < m
    if match_bucket:
        mask &= lead_bucket[:, :, None] == bucket[:, None, :]
    lg, mg = lead_gid[:, :, None], gid[:, None, :]
    if new_from > 0:
        mask &= (lg >= new_from) | (mg >= new_from)
    if refresh_below > 0:
        mask &= keep[:, None, None] & (lg < refresh_below) \
            & (mg < refresh_below)
    emit = mask & (sims > np.float32(r1)) if r1 is not None else mask
    return (sims, emit, mask.sum((1, 2), dtype=np.int32),
            emit.sum((1, 2), dtype=np.int32))


def _window_inputs(nw, s, w, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(nw, s, d).astype(np.float32) / np.sqrt(d),
            rs.randn(nw, w, d).astype(np.float32) / np.sqrt(d),
            rs.randint(0, w, (nw, s)).astype(np.int32),
            rs.randint(0, 16, (nw, s)).astype(np.int32),
            rs.randint(0, 16, (nw, w)).astype(np.int32),
            rs.rand(nw, s) > 0.2, rs.rand(nw, w) > 0.2,
            rs.randint(0, 3, (nw, s)).astype(np.uint32),
            rs.randint(0, 3, (nw, w)).astype(np.uint32),
            rs.rand(nw) > 0.4)


def _kw(variant):
    normalized, allpairs, match_bucket, new_from, refresh_below, r1 = variant
    return dict(normalized=normalized, allpairs=allpairs,
                match_bucket=match_bucket, new_from=new_from,
                refresh_below=refresh_below, r1=r1)


# the path's 25 x 250 tiles at d = 128 and 64; 16 x 16 (256 similarities,
# the design's smallest); s = 33 / 40 (a ragged second leader tile) with
# W = 65 / 70 (ragged member tiles) at d = 36 (halves of 5 and 4 float4s)
# and d = 4 (one float4, the second half empty)
SHAPES = [(2, 25, 250, 128), (2, 25, 250, 64), (3, 16, 16, 32),
          (2, 33, 65, 36), (2, 40, 70, 4)]


@pytest.mark.parametrize("nw,s,w,d", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_window_pipe_model_matches_jax(nw, s, w, d, variant, against):
    assert t_ws._design(s, w, d) == "pipe"
    args = _window_inputs(nw, s, w, d, seed=nw * w + s + d)
    kw = _kw(variant)
    got = window_pipe_model(*args, **kw)
    jargs = tuple(jnp.asarray(a) for a in args)
    if against == "ref":
        want = j_ref.window_score_ref(*jargs, **kw)
    else:
        want = pallas_window_score(*jargs, interpret=True, **kw)
    want = tuple(np.asarray(t) for t in want)
    np.testing.assert_array_equal(np.isneginf(got[0]), np.isneginf(want[0]),
                                  err_msg="sims -inf pattern")
    fin = np.isfinite(want[0])
    np.testing.assert_allclose(got[0][fin], want[0][fin], atol=TOL,
                               rtol=0, err_msg="sims")
    np.testing.assert_array_equal(got[2], want[2], err_msg="comparisons")
    r1 = kw["r1"]
    if r1 is None:
        np.testing.assert_array_equal(got[1], want[1], err_msg="emit")
        np.testing.assert_array_equal(got[3], want[3], err_msg="emitted")
    else:
        flips = got[1] != want[1]
        assert not (flips & (np.abs(want[0] - r1) >= TOL)).any(), \
            "emit differs away from r1"
        assert np.abs(got[3] - want[3]).sum() <= flips.sum()


@pytest.mark.parametrize("s,w,d,want", [
    (25, 250, 128, "pipe"),          # the main path's tiles
    (16, 16, 4, "pipe"),             # s * W == 256
    (15, 17, 128, "tile"),           # s * W == 255
    (1, 256, 16, "pipe"),
    (1, 16, 8, "tile"),
    (250, 250, 128, "pipe"),         # several leader tiles
    (1000, 1000, 128, "pipe"),       # the LSH all-pairs parity build
    (25, 250, 127, "tile"),          # d % 4 == 3
    (25, 250, 126, "tile"),          # d % 4 == 2
    (33, 65, 33, "tile"),            # d % 4 == 1
    (25, 250, 512, "pipe"),          # the widest row of the pipe design
    (25, 250, 516, "tile"),          # one float4 past it
    (25, 250, 1152, "tile"),         # the LM path's embeddings
])
def test_window_score_design_is_picked_by_shape_alone(monkeypatch, s, w, d,
                                                      want):
    """pipe for s * W >= 256 with d % 4 == 0 and d <= 512, tile for the
    rest, without asking CUDA anything."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("_design queried CUDA")
    for name in ("is_available", "get_device_capability", "device_count",
                 "current_device", "get_device_properties"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    assert t_ws._design(s, w, d) == want
    assert set(t_ws.design_launches) == {"pipe", "tile"}
