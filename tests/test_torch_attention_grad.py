"""The attention gradient of the port (``repro_torch.kernels``) on the CPU.

  * ``ref.mha_lse_ref`` and ``ref.mha_bwd_ref`` (the backward kernel's
    plain version) against ``jax.vjp`` of the JAX package's
    ``ref.mha_ref``, over the card's sweep of masks and shapes at small
    sizes (fp32, atol 1e-5: outputs and gradients of order 1, the
    frameworks sum in other orders);
  * ``torch.autograd.gradcheck`` in float64 of the ``FlashAttention``
    Function with its two kernels replaced by their plain versions: the
    wiring the card runs;
  * the stack's gradient through ``ops.attention`` routed as on the card
    (every call through the Function; the kernels replaced by plain
    versions whose forward returns a tensor without autograd history, as
    the CUDA kernel's does): every layer's attn_wq / attn_wk / attn_wv
    gets autograd's gradient through ``ref.mha_ref`` (within 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro_torch.configs import gemma3_1b as t_gemma
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import init_params
from repro_torch.train import make_loss_fn
from repro_torch.train._tree import leaves, unflatten

pytestmark = pytest.mark.torch_port

# (b, hq, hkv, sq, sk, d), causal, window: GQA groups 1, 2, 4 and 8,
# causal, sliding window and non-causal, sq == sk and sq < sk
# (right-aligned), lengths not a multiple of the kernel's tiles
SWEEP = [((1, 1, 1, 9, 9, 8), True, None),
         ((2, 4, 1, 13, 13, 16), True, None),
         ((1, 8, 1, 7, 19, 16), True, None),
         ((1, 4, 2, 40, 40, 8), True, 16),
         ((1, 4, 1, 21, 33, 16), True, 5),
         ((2, 8, 8, 6, 6, 8), False, None),
         ((1, 4, 1, 7, 20, 16), False, None),
         ((1, 8, 1, 5, 17, 8), False, 9)]


def _inputs(shape, seed, dtype=np.float32):
    b, hq, hkv, sq, sk, d = shape
    rs = np.random.RandomState(seed)
    return (rs.randn(b, hq, sq, d).astype(dtype),
            rs.randn(b, hkv, sk, d).astype(dtype),
            rs.randn(b, hkv, sk, d).astype(dtype),
            rs.randn(b, hq, sq, d).astype(dtype))


@pytest.mark.parametrize("shape,causal,window", SWEEP)
def test_plain_backward_matches_jax_vjp(shape, causal, window):
    q, k, v, do = _inputs(shape, seed=sum(shape))
    o, vjp = jax.vjp(lambda q_, k_, v_: j_ref.mha_ref(
        q_, k_, v_, causal=causal, window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    t = [torch.as_tensor(a) for a in (q, k, v, do)]
    to, lse = ref.mha_lse_ref(*t[:3], causal=causal, window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=1e-5)
    # the plain forward's output is mha_ref's, bit for bit
    assert torch.equal(to, ref.mha_ref(*t[:3], causal=causal,
                                       window=window))
    # the row log-sum-exp of the scaled, masked scores
    s = np.einsum("bhqd,bhkd->bhqk", q,
                  np.repeat(k, shape[1] // shape[2], axis=1)) \
        / np.sqrt(shape[5])
    mask = np.asarray(ref._visible(shape[3], shape[4], causal, window,
                                   "cpu"))
    s = np.where(mask, s, -np.inf)
    np.testing.assert_allclose(
        lse.numpy(), np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1))
        + s.max(-1), atol=1e-5)
    got = ref.mha_bwd_ref(*t[:3], to, t[3], lse, causal=causal,
                          window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def _plain_kernels(monkeypatch, calls=None):
    """Replace the two CUDA kernels by their plain versions: the forward
    runs without autograd history (as the kernel's output has none)."""
    def forward(q, k, v, *, causal, window, scale, return_lse=False):
        if calls is not None:
            calls["fwd"].append(return_lse)
        with torch.no_grad():
            out, lse = ref.mha_lse_ref(q, k, v, causal=causal,
                                       window=window, scale=scale)
        return (out, lse) if return_lse else out

    def backward(q, k, v, o, do, lse, *, causal, window, scale):
        if calls is not None:
            calls["bwd"] += 1
        return ref.mha_bwd_ref(q, k, v, o, do, lse, causal=causal,
                               window=window, scale=scale)

    monkeypatch.setattr(fa, "flash_attention", forward)
    monkeypatch.setattr(fa, "flash_attention_bwd", backward)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None), (False, 4)])
def test_function_gradcheck_float64(monkeypatch, causal, window):
    _plain_kernels(monkeypatch)
    # float64 is the plain versions' and gradcheck's; the kernels take
    # fp32 and bf16
    monkeypatch.setattr(fa, "backward_supported", lambda q: True)
    rs = np.random.RandomState(3)
    q = torch.tensor(rs.randn(1, 4, 5, 4), dtype=torch.float64,
                     requires_grad=True)
    k = torch.tensor(rs.randn(1, 2, 7, 4), dtype=torch.float64,
                     requires_grad=True)
    v = torch.tensor(rs.randn(1, 2, 7, 4), dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: fa.FlashAttention.apply(
            q_, k_, v_, causal, window, 0.7, True), (q, k, v))


def _stack_grads(cfg, params, tokens):
    loss_fn = make_loss_fn(cfg)
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = loss_fn(unflatten(params, live), {"tokens": tokens})
    return loss, unflatten(params, list(torch.autograd.grad(loss, live)))


def test_stack_attention_weights_get_gradients_through_the_function(
        monkeypatch):
    """Fault 1: the CUDA attention returned the kernel's output without
    autograd history, so no loss reached attn_wq / attn_wk / attn_wv.
    Here ops.attention takes the CUDA route (through the Function) with
    the kernels' plain versions, and every layer's attention weights get
    the gradient that autograd through ref.mha_ref gives."""
    cfg = dataclasses.replace(t_gemma.REDUCED, dtype=torch.float32,
                              param_dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tokens = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab, (2, 24)))
    want_loss, want = _stack_grads(cfg, params, tokens)
    calls = {"fwd": [], "bwd": 0}
    _plain_kernels(monkeypatch, calls)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    loss, got = _stack_grads(cfg, params, tokens)
    assert calls["fwd"] == [True] * cfg.n_layers
    assert calls["bwd"] == cfg.n_layers
    assert abs(loss.item() - want_loss.item()) <= 1e-6
    for layer, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        for name in ("attn_wq", "attn_wk", "attn_wv"):
            assert g[name].abs().max() > 0, (layer, name)
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(),
                                       atol=1e-5, err_msg=f"{layer} {name}")


def test_function_without_gradient_asks_for_no_lse(monkeypatch):
    calls = {"fwd": [], "bwd": 0}
    _plain_kernels(monkeypatch, calls)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    q, k, v, _ = (torch.as_tensor(a) for a in _inputs((1, 2, 1, 6, 6, 8),
                                                       seed=5))
    out = ops.attention(q, k, v)
    with torch.no_grad():
        ops.attention(q.requires_grad_(True), k, v)
    assert calls["fwd"] == [False, False]
    assert out.grad_fn is None
    assert torch.equal(out, ref.mha_ref(q.detach(), k, v))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 300),
                                     (torch.float64, 16)])
def test_gradient_the_kernel_cannot_give_raises(monkeypatch, dtype, d):
    _plain_kernels(monkeypatch)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    q = torch.zeros((1, 2, 4, d), dtype=dtype, requires_grad=True)
    k = torch.zeros((1, 1, 4, d), dtype=dtype)
    with pytest.raises(ValueError, match="no backward kernel"):
        ops.attention(q, k, k)


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 4, 8))
    k = torch.zeros((1, 1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, k, q, q, torch.zeros((1, 2, 4)))
