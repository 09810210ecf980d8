"""The port's hashing, LSH bucket ids, Hamming distances and LSH window
grid against the JAX package, bit for bit.

uint32 values travel between the packages as numpy uint32 arrays; the
port carries them in int64 and its window buckets as int32 bit patterns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
from repro.core import hashing as j_hash
from repro.core import lsh as j_lsh
from repro.core import stars as j_stars
from repro.core import windows as j_win
from repro_torch import prng
from repro_torch.core import hashing as t_hash
from repro_torch.core import lsh as t_lsh
from repro_torch.core import stars as t_stars
from repro_torch.core import windows as t_win

pytestmark = pytest.mark.torch_port


def _u32(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    special = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF][:n]
    x[:len(special)] = special
    return x


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("fn", ["mix32", "hash_u32", "hash_combine"])
def test_hash_functions_bit_equal(fn):
    a, b = _u32(4096, 0), _u32(4096, 1)
    if fn == "mix32":
        got, want = t_hash.mix32(_t(a)), j_hash.mix32(jnp.asarray(a))
    else:
        got = getattr(t_hash, fn)(_t(a), _t(b))
        want = getattr(j_hash, fn)(jnp.asarray(a), jnp.asarray(b))
    _equal(got, want)


def test_hash_u32_with_scalar_seed_and_fold_words_bit_equal():
    a = _u32(1000, 2)
    for seed in (0, 1, 0xFFFFFFFF, 123456789):
        _equal(t_hash.hash_u32(_t(a), seed), j_hash.hash_u32(jnp.asarray(a),
                                                             seed))
    words = _u32(3 * 500, 3).reshape(500, 3)
    for w in (1, 2, 3):
        _equal(t_hash.fold_words(_t(words[:, :w])),
               j_hash.fold_words(jnp.asarray(words[:, :w])))


def test_uniform01_from_u32_bit_equal():
    a = _u32(4096, 4)
    got = t_hash.uniform01_from_u32(_t(a))
    want = np.asarray(j_hash.uniform01_from_u32(jnp.asarray(a)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("m", [8, 16, 32, 40, 70])
def test_bucket_key_bit_equal(m):
    rs = np.random.RandomState(m)
    bits = rs.rand(600, m) > 0.5
    bits[1] = bits[0]                       # equal sketches, equal ids
    bits[2] = True
    bits[3] = False
    cfg_j = j_lsh.HashFamilyConfig("simhash", m=m)
    cfg_t = t_lsh.HashFamilyConfig("simhash", m=m)
    got = t_lsh.bucket_key(torch.from_numpy(bits), cfg_t)
    _equal(got, j_lsh.bucket_key(jnp.asarray(bits.astype(np.uint32)), cfg_j))
    assert got[0] == got[1]


@pytest.mark.parametrize("a,b,w", [(7, 9, 1), (5, 5, 2), (3, 11, 3)])
def test_hamming_pairwise_bit_equal(a, b, w):
    rs = np.random.RandomState(a * b + w)
    pa = _u32(4 * a * w, a).reshape(4, a, w)
    pb = _u32(4 * b * w, b + 100).reshape(4, b, w)
    pa |= (rs.rand(*pa.shape) > 0.5).astype(np.uint32) << 31   # top bits
    pa[0, 0] = 0xFFFFFFFF
    pb[0, 0] = 0
    pb[1, 0] = pa[1, 0]                     # distance 0
    got = t_lsh.hamming_pairwise(_t(pa), _t(pb))
    want = np.asarray(j_lsh.hamming_pairwise(jnp.asarray(pa),
                                             jnp.asarray(pb)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 0] == 32 * w
    assert got[1, 0, 0] == 0


@pytest.mark.parametrize("n,window,n_buckets", [
    (1000, 64, 8),       # buckets larger than W: split across windows
    (777, 100, 300),     # many small buckets, a ragged last window
    (50, 64, 3),         # fewer points than one window: pad slots
])
@pytest.mark.parametrize("rep", [0, 4])
def test_lsh_window_grid_bit_equal(n, window, n_buckets, rep):
    """Bucket ids with forced collisions (few distinct values), 0 and
    0xFFFFFFFF (the pad slots' pattern) among them, sorted with the
    repetition's tiebreak; gid, valid and bucket patterns must be equal."""
    rs = np.random.RandomState(n + rep)
    pool = _u32(n_buckets, n_buckets)
    bucket = pool[rs.randint(0, n_buckets, n)]
    jc = j_stars.StarsConfig(mode="lsh", window=window, seed=9)
    tc = t_stars.StarsConfig(mode="lsh", window=window, seed=9)
    jk = j_stars._rep_keys(jc, jnp.int32(rep))
    tk = t_stars._rep_keys(tc, rep)
    j_tie = jax.random.bits(jk[0], (n,), jnp.uint32) \
        & jnp.uint32(((1 << 20) - 1) << 12)
    t_tie = prng.bits(tk[0], (n,), device="cpu") \
        & (((1 << 20) - 1) << 12)
    jg = j_win.lsh_windows(jnp.asarray(bucket), window=window,
                           tiebreak=j_tie)
    tg = t_win.lsh_windows(_t(bucket), window=window, tiebreak=t_tie,
                           tiebreak_bits=20)
    np.testing.assert_array_equal(tg.gid.numpy(), np.asarray(jg.gid))
    np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
    np.testing.assert_array_equal(tg.bucket.numpy(),
                                  np.asarray(jg.bucket).view(np.int32))
    assert not tg.valid.all() or n % window == 0
