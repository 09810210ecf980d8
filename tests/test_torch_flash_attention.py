"""The port's plain attention (``ref.mha_ref``, and ``ops.attention`` on CPU
tensors) against the JAX oracle and the Pallas kernel in interpret mode.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against this plain version.  Inputs are made with numpy from a seed; bf16
inputs are the same fp32 draws rounded to bf16 on both sides.  Tolerances
are those of ``tests/test_kernels.py``: atol 2e-5 in fp32 (the frameworks
sum in other orders, and the Pallas kernel scales q before the product
where the oracles scale the scores) and 2e-2 in bf16 (one bf16 rounding
of outputs of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

pytestmark = pytest.mark.torch_port

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(b, hq, hkv, sq, sk, d, seed, dtype):
    rs = np.random.RandomState(seed)
    arrays = (rs.randn(b, hq, sq, d).astype(np.float32),
              rs.randn(b, hkv, sk, d).astype(np.float32),
              rs.randn(b, hkv, sk, d).astype(np.float32))
    t_dtype, j_dtype = DTYPES[dtype]
    return (tuple(torch.from_numpy(a).to(t_dtype) for a in arrays),
            tuple(jnp.asarray(a, j_dtype) for a in arrays))


def _compare(shape, dtype, against, causal=True, window=None, block=32):
    t_args, j_args = _inputs(*shape, seed=sum(shape), dtype=dtype)
    got = t_ops.attention(*t_args, causal=causal, window=window)
    assert got.dtype == t_args[0].dtype and got.shape == t_args[0].shape
    if against == "ref":
        want = j_ref.mha_ref(*j_args, causal=causal, window=window)
    else:
        want = pallas_flash(*j_args, causal=causal, window=window,
                            block_q=block, block_k=block, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (1, 2, 2, 32, 32, 16),
    (2, 4, 2, 64, 64, 32),
    (2, 8, 1, 32, 32, 64),     # MQA
    (1, 4, 4, 32, 128, 16),    # prefill with longer KV (right-aligned)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_attention_matches_jax(b, hq, hkv, sq, sk, d, dtype, against):
    _compare((b, hq, hkv, sq, sk, d), dtype, against)


@pytest.mark.parametrize("window", [8, 16, 64])
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_attention_sliding_window_matches_jax(window, against):
    _compare((2, 4, 2, 64, 64, 32), "float32", against, window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_attention_gemma3_local_layer_matches_jax(dtype, against):
    """Head dim 256, 4 query heads on 1 KV head, window 512 at s = 1024:
    gemma3-1b's local layers (with the Pallas kernel's default blocks of
    128, so whole key blocks are skipped)."""
    _compare((1, 4, 1, 1024, 1024, 256), dtype, against, window=512,
             block=128)


@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_attention_without_causal_mask_matches_jax(against):
    _compare((2, 4, 2, 64, 64, 32), "float32", against, causal=False)


def test_ops_attention_on_cpu_is_the_plain_version():
    """On CPU tensors the dispatcher runs ``mha_ref`` and never the
    kernel."""
    t_args, _ = _inputs(1, 4, 2, 16, 24, 8, seed=3, dtype="float32")
    before = t_fa.launches
    got = t_ops.attention(*t_args, causal=True, window=5, scale=0.3)
    want = t_ref.mha_ref(*t_args, causal=True, window=5, scale=0.3)
    assert torch.equal(got, want)
    assert t_fa.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    t_args, _ = _inputs(1, 2, 1, 8, 8, 8, seed=4, dtype="float32")
    with pytest.raises(ValueError, match="CUDA"):
        t_fa.flash_attention(*t_args)
