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


# --------------------------------------------------------------------------- #
# the tensor-core design's arithmetic (csrc/flash_attention_wgmma.cu), as a
# plain model, and its dispatch
# --------------------------------------------------------------------------- #

def _wgmma_model(q, k, v, *, causal, window, block=64):
    """What the tensor-core design computes, in plain PyTorch on the CPU:
    an online softmax over blocks of 64 keys, the scale applied to the fp32
    scores (not to bf16 q), and P split into bf16 hi = bf16(p) and lo =
    bf16(p - hi) before the product with V, so that hi V + lo V keeps the
    fp32 contract.  Returns fp32."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    sk = k.shape[2]
    scale = 1.0 / d ** 0.5
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full((b, hq, sq), float("-inf"))
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, sk, block):
        kpos = torch.arange(k0, min(k0 + block, sk))[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + block])
        s = s * scale
        mask = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full_like(s, float("-inf")))
        m_new = torch.maximum(m, s.amax(-1))
        # p = 0 while the max is -inf; alpha = 0 after a -inf max
        m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_use[..., None])
        alpha = torch.exp(m - m_use)
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        v_blk = vf[:, :, k0:k0 + block]
        acc = acc * alpha[..., None] + hi @ v_blk + lo @ v_blk
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _split_tol(v):
    """fp32 tolerance of the split: hi + lo is p to within 2^-18 of p (lo
    is bf16(p - hi) with |p - hi| <= 2^-9 p), so the output moves by at
    most 2^-18 max|v|; twice that leaves room for fp32 sums taken in other
    orders and the scale applied after the product."""
    return 2.0 ** -17 * float(np.abs(np.asarray(v, np.float32)).max())


# (b, hq, hkv, sq, sk, d), causal, window: head dims 64, 128 and 256 with
# a GQA group of 4, windows 8, 40 and 512, ragged rows and keys (not
# multiples of the design's 128-row blocks or 64-key tiles)
WGMMA_CASES = [
    ((1, 4, 1, 130, 200, 128), True, None),
    ((1, 4, 1, 130, 200, 128), True, 40),
    ((1, 4, 1, 100, 100, 64), True, 8),
    ((2, 4, 1, 64, 192, 64), True, None),
    ((1, 4, 1, 130, 200, 64), False, 50),
    ((1, 4, 1, 256, 256, 256), True, None),
    ((1, 4, 1, 1024, 1024, 256), True, 512),
]
WGMMA_IDS = [f"{'x'.join(map(str, s))}-{'c' if c else 'nc'}-w{w}"
             for s, c, w in WGMMA_CASES]


def _bf16_inputs(shape, seed):
    """bf16 draws, and the same values as fp32 numpy arrays for JAX."""
    (t_args, _) = _inputs(*shape, seed=seed, dtype="bfloat16")
    return t_args, tuple(a.float().numpy() for a in t_args)


@pytest.mark.parametrize("shape,causal,window", WGMMA_CASES, ids=WGMMA_IDS)
def test_wgmma_model_matches_jax_oracle(shape, causal, window):
    """The design's arithmetic against the JAX oracle in fp32 on the same
    bf16 values, within the split's tolerance."""
    t_args, np_args = _bf16_inputs(shape, seed=sum(shape))
    got = _wgmma_model(*t_args, causal=causal, window=window)
    want = j_ref.mha_ref(*(jnp.asarray(a) for a in np_args), causal=causal,
                         window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=_split_tol(np_args[2]), rtol=0)


@pytest.mark.parametrize("shape,causal,window", WGMMA_CASES, ids=WGMMA_IDS)
def test_wgmma_model_matches_pallas_kernel(shape, causal, window):
    """The design's arithmetic against the Pallas kernel in interpret
    mode: in fp32 within the split's tolerance, and with bf16 inputs and
    output within the file's bf16 tolerance."""
    t_args, np_args = _bf16_inputs(shape, seed=sum(shape) + 1)
    b, hq, hkv, sq, sk, d = shape
    block = 128 if sq % 128 == 0 and sk % 128 == 0 else max(sq, sk)
    got = _wgmma_model(*t_args, causal=causal, window=window)
    want32 = pallas_flash(*(jnp.asarray(a) for a in np_args), causal=causal,
                          window=window, block_q=block, block_k=block,
                          interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want32, np.float32),
                               atol=_split_tol(np_args[2]), rtol=0)
    want16 = pallas_flash(*(jnp.asarray(a, jnp.bfloat16) for a in np_args),
                          causal=causal, window=window, block_q=block,
                          block_k=block, interpret=True)
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(),
                               np.asarray(want16, np.float32),
                               atol=TOL["bfloat16"], rtol=0)


def test_wgmma_split_is_needed():
    """The split is what keeps the fp32 contract: rounding P to one bf16
    instead (as SDPA does) misses the oracle by far more than the split's
    tolerance on the same inputs."""
    shape = (1, 4, 1, 130, 200, 128)
    t_args, np_args = _bf16_inputs(shape, seed=7)
    want = np.asarray(j_ref.mha_ref(*(jnp.asarray(a) for a in np_args),
                                    causal=True, window=None), np.float32)
    q, k, v = (t.float() for t in t_args)
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(4, dim=1)) / 128 ** 0.5
    qpos = torch.arange(130)[:, None] + 70
    s = s.masked_fill(torch.arange(200)[None, :] > qpos, float("-inf"))
    p = torch.softmax(s, -1).to(torch.bfloat16).float()
    one_bf16 = p @ v.repeat_interleave(4, dim=1)
    assert np.abs(one_bf16.numpy() - want).max() > 8 * _split_tol(np_args[2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 100, 128, 192, 256, 512])
def test_design_is_picked_by_dtype_and_head_dim_alone(monkeypatch, dtype, d):
    """bf16 at head dims 64, 128 and 256 goes to the wgmma design, fp32 at
    those head dims to the split-TF32 mma design, everything else to the
    FMA design, without asking CUDA anything."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("_design queried CUDA")
    for name in ("is_available", "get_device_capability", "device_count",
                 "current_device", "get_device_properties"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    want = "fma"
    if d in (64, 128, 256) and dtype in (torch.bfloat16, torch.float32):
        want = "wgmma" if dtype == torch.bfloat16 else "mma"
    assert t_fa._design(dtype, d) == want
