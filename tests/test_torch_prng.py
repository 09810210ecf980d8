"""The port's threefry draws against ``jax.random`` (partitionable mode).

Keys, bits, uniforms and randints must be bit-equal; ``normal`` goes
through a float32 inverse-erf polynomial whose ``log1p`` differs from
XLA's by an ulp, so it is held to 4 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

pytestmark = pytest.mark.torch_port

SEEDS = [0, 7, 123456, 2**31 - 1]


def _key_words(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bit_equal(seed):
    k = jax.random.key(seed)
    pk = prng.key(seed)
    assert _key_words(k) == pk
    for data in (0, 5, 0x5EF5, 2**31 - 1, -3):
        want = jax.random.fold_in(k, jnp.int32(data) if data < 0 else data)
        assert _key_words(want) == prng.fold_in(pk, data)
    for num in (2, 3, 5):
        assert [_key_words(x) for x in jax.random.split(k, num)] \
            == prng.split(pk, num)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (7, 13), (4196, 3)])
def test_bits_and_uniform_bit_equal(seed, shape):
    k = jax.random.fold_in(jax.random.key(seed), 11)
    pk = prng.fold_in(prng.key(seed), 11)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(
        prng.bits(pk, shape, device="cpu").numpy(), want)
    u = np.asarray(jax.random.uniform(k, shape))
    np.testing.assert_array_equal(
        prng.uniform(pk, shape, device="cpu").numpy().view(np.int32),
        u.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(125, 251), (0, 16), (-5, 1000003),
                                   (3, 3)])
def test_randint_bit_equal(seed, lo, hi):
    k = jax.random.key(seed)
    pk = prng.key(seed)
    assert int(jax.random.randint(k, (), lo, hi)) \
        == int(prng.randint(pk, (), lo, hi, device="cpu"))
    np.testing.assert_array_equal(
        prng.randint(pk, (257,), lo, hi, device="cpu").numpy(),
        np.asarray(jax.random.randint(k, (257,), lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_4_ulp(seed):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    pk = prng.fold_in(prng.key(seed), 3)
    want = np.asarray(jax.random.normal(k, (128, 16)))
    got = prng.normal(pk, (128, 16), device="cpu").numpy()
    assert got.dtype == np.float32
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4, ulp.max()


@pytest.mark.parametrize("draw", ["bits", "uniform", "randint", "normal"])
def test_draws_resolve_their_device(monkeypatch, draw):
    """With no device a draw goes to the card, and without one that
    raises instead of drawing on the CPU; device="cpu" draws there."""
    pk = prng.key(5)
    call = {"bits": lambda **kw: prng.bits(pk, (3,), **kw),
            "uniform": lambda **kw: prng.uniform(pk, (3,), **kw),
            "randint": lambda **kw: prng.randint(pk, (3,), 0, 9, **kw),
            "normal": lambda **kw: prng.normal(pk, (3,), **kw)}[draw]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert call(device="cpu").device.type == "cpu"


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float32)
    out = prng.erf_inv(x)
    assert out[0] == float("-inf") and out[1] == float("inf")
    assert out[2] == 0.0


def test_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        prng.key(-1)
