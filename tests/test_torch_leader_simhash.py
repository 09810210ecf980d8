"""The plain versions of ``leader_score`` and ``simhash_packed`` against the
JAX oracles and the Pallas kernels (interpret mode).

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against these plain versions.  Tolerances: ``leader_score`` within 2e-6
of the JAX oracle (the same division by the row norm; the frameworks sum
in different orders) and within 2e-5 of the Pallas kernel, which
multiplies by an rsqrt instead (the tolerance ``tests/test_kernels.py``
holds it to); ``simhash_packed`` bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import lsh as j_lsh
from repro.kernels import ref as j_ref
from repro.kernels.leader_score import leader_score as pallas_leader_score
from repro.kernels.simhash import simhash_packed as pallas_simhash_packed
from repro_torch.kernels import ref as t_ref

pytestmark = pytest.mark.torch_port


def _leader_inputs(nw, s, w, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(nw, s, d).astype(np.float32),
            rs.randn(nw, w, d).astype(np.float32),
            rs.rand(nw, s) > 0.3, rs.rand(nw, w) > 0.3)


@pytest.mark.parametrize("nw,s,w,d", [(1, 4, 8, 16), (5, 8, 24, 16),
                                      (3, 25, 250, 64), (2, 1, 16, 8),
                                      (1000, 1, 1, 16)])
@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_leader_score_plain_matches_jax(nw, s, w, d, normalized, against):
    args = _leader_inputs(nw, s, w, d, seed=nw * w + s)
    got = t_ref.leader_score_ref(*(torch.from_numpy(a) for a in args),
                                 normalized=normalized).numpy()
    jargs = tuple(jnp.asarray(a) for a in args)
    if against == "ref":
        want, atol = j_ref.leader_score_ref(*jargs, normalized=normalized), \
            2e-6
    else:
        want, atol = pallas_leader_score(*jargs, normalized=normalized,
                                         interpret=True), 2e-5
    want = np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=0)


def _simhash_inputs(n, d, m, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, d).astype(np.float32),
            rs.randn(d, m).astype(np.float32))


@pytest.mark.parametrize("n,d,m", [(8, 16, 32), (70, 40, 64),
                                   (128, 64, 128), (33, 7, 96)])
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_simhash_packed_plain_matches_jax(n, d, m, against):
    x, proj = _simhash_inputs(n, d, m, seed=n * m)
    got = t_ref.simhash_packed_ref(torch.from_numpy(x),
                                   torch.from_numpy(proj))
    if against == "ref":
        want = j_ref.simhash_packed_ref(jnp.asarray(x), jnp.asarray(proj))
    else:
        want = pallas_simhash_packed(jnp.asarray(x), jnp.asarray(proj),
                                     block_n=32, block_m=32, interpret=True)
    assert got.dtype == torch.int32 and got.shape == (n, m // 32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("n,d", [(50, 16), (129, 33)])
def test_simhash_packed_plain_ragged_m_matches_pack_bits(n, d):
    """m = 40: two words, the last with 24 zero tail bits."""
    x, proj = _simhash_inputs(n, d, 40, seed=n + d)
    got = t_ref.simhash_packed_ref(torch.from_numpy(x),
                                   torch.from_numpy(proj))
    want = np.asarray(j_lsh.pack_bits(j_lsh.simhash_bits(
        jnp.asarray(x), jnp.asarray(proj))))
    assert got.shape == (n, 2)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert not (got[:, 1].numpy().view(np.uint32) >> 8).any()
