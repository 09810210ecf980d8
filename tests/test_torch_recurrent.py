"""The port's recurrent block flavours (``repro_torch.models.rwkv``,
``mamba``, the ``rwkv`` / ``mamba_dense`` / ``mamba_moe`` blocks of
``stack``) against the JAX package on the CPU, at rwkv6-3b's and
jamba-1.5-large-398b's REDUCED configs.

Weights are the JAX package's own ``init_params`` draws, carried across
with ``models.convert.params_from_jax``; inputs are made with numpy from
a seed.  Each JAX result of the stacks is computed once per module
(``jax_runs``), under ``jax.jit``.  The single-layer cases replace the
constant and zero leaves of the init (the mu interpolations, u, w0, the
norm gains, the conv bias, D) with random values, so that a leaf used
the wrong way shows.

Tolerances:
  * The layer functions in fp32 within 1e-5 of the largest |output|
    (outputs of order 1; the frameworks sum the products and the
    einsums in other orders: measured 2e-7-5e-7 relative).  In bf16, on
    the same bf16 inputs and weights, against JAX run op by op
    (``jax.disable_jit``), where each op rounds to bf16 as each PyTorch
    op does, within 2**-7 of the largest |output| (measured at most
    1.8e-3 over six seeds; under ``jax.jit`` XLA keeps fused elementwise
    chains such as Mamba's conv sum in fp32, which moves its output by
    up to 9e-3 relative).
  * One decode step from a non-zero cache, fp32, within 1e-5 of the
    largest |output|; the new caches likewise.
  * The stacks in fp32: logits within 1e-4, jamba's summed MoE aux
    within 1e-6, embeddings within 1e-5; greedy tokens equal; 12 decode
    steps within 1e-4 of JAX's step by step; rwkv6's loss within 1e-5
    relative and its gradients within 1e-5 of each leaf's largest
    |gradient| (at least 1e-5 absolute), as ``test_torch_moe`` holds
    olmoe's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import serve as j_serve
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import mamba as j_mamba
from repro.models import rwkv as j_rwkv
from repro.train import make_loss_fn as j_make_loss_fn
from repro_torch.launch import serve as t_serve
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.models import mamba as t_mamba
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.stack import layer_defs, layer_plan
from repro_torch.train._tree import leaves, unflatten
from repro_torch.train.train_step import make_loss_fn
from test_torch_models import _to_torch_cfg, _tokens

pytestmark = pytest.mark.torch_port

ARCHS = ["rwkv6-3b", "jamba-1.5-large-398b"]
J_F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
BF16_RTOL = 2.0 ** -7


def _cfg(name, dtype="float32"):
    cfg = j_configs.get_reduced(name)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, **J_F32)
    return cfg


def _params(j_cfg, seed):
    values, _ = j_init_params(j_cfg, jax.random.key(seed))
    return values, jax.tree.map(np.asarray, values)


# The leaves the init makes constant or zero, and the random values the
# single-layer cases give them instead: (name, low, high)
RANDOM_LEAVES = [("tmix_mu_r", 0, 1), ("tmix_mu_k", 0, 1),
                 ("tmix_mu_v", 0, 1), ("tmix_mu_g", 0, 1),
                 ("tmix_mu_w", 0, 1), ("tmix_w0", -7, -1), ("tmix_u", -1, 1),
                 ("tmix_ln_g", -0.5, 0.5), ("cmix_mu_k", 0, 1),
                 ("cmix_mu_r", 0, 1), ("mamba_conv_b", -0.5, 0.5),
                 ("mamba_dskip", 0, 2), ("norm1", -0.5, 0.5)]


def _layer(name, dtype, flavour, seed):
    """The JAX config, the port's config, and the first layer of the
    given flavour in both packages' forms, its constant leaves made
    random (drawn in fp32, rounded to the parameter dtype)."""
    j_cfg = _cfg(name, dtype)
    t_cfg = _to_torch_cfg(j_cfg)
    _, values = _params(j_cfg, seed)
    defs = layer_defs(layer_plan(t_cfg))
    at = [bd.flavor for bd in defs].index(flavour)
    layer = params_from_jax(values, t_cfg, device="cpu")["layers"][at]
    rs = np.random.RandomState(seed)
    for leaf, lo, hi in RANDOM_LEAVES:
        if leaf in layer:
            v = rs.uniform(lo, hi, tuple(layer[leaf].shape)) \
                .astype(np.float32)
            layer[leaf] = torch.from_numpy(v).to(t_cfg.param_dtype)
    j_layer = {k: jnp.asarray(_np(t)) for k, t in layer.items()}
    return j_cfg, t_cfg, j_layer, layer


def _np(t):
    """A port tensor as the numpy array JAX takes (bf16 bit for bit)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _x(j_cfg, shape, seed):
    """Inputs as in the stack (the output of a norm): order 1, in the
    model dtype in both packages."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jx = jnp.asarray(x, j_cfg.dtype)
    return jx, torch.from_numpy(np.array(jx, np.float32)).to(
        _to_torch_cfg(j_cfg).dtype)


def _close(got, want, rtol, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert scale > 0 and err <= rtol * scale, (what, err, scale)


# --------------------------------------------------------------------------- #
# the layer functions
# --------------------------------------------------------------------------- #


LAYER_FWD = {
    "rwkv_time_fwd": ("rwkv6-3b", "rwkv", t_rwkv.rwkv_time_fwd,
                      j_rwkv.rwkv_time_fwd),
    "rwkv_channel_fwd": ("rwkv6-3b", "rwkv", t_rwkv.rwkv_channel_fwd,
                         j_rwkv.rwkv_channel_fwd),
    "mamba_fwd": ("jamba-1.5-large-398b", "mamba_dense", t_mamba.mamba_fwd,
                  j_mamba.mamba_fwd),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", list(LAYER_FWD))
def test_layer_fwd_matches_jax(fn, dtype):
    """One layer's full-sequence function on 3 x 20 tokens."""
    name, flavour, t_fn, j_fn = LAYER_FWD[fn]
    j_cfg, t_cfg, j_layer, layer = _layer(name, dtype, flavour, seed=5)
    jx, x = _x(j_cfg, (3, 20, j_cfg.d_model), seed=6)
    if dtype == "float32":
        want = jax.jit(lambda p, xx: j_fn(p, j_cfg, xx))(j_layer, jx)
    else:
        with jax.disable_jit():             # each op rounded to bf16
            want = j_fn(j_layer, j_cfg, jx)
    got = t_fn(layer, t_cfg, x)
    assert got.dtype == t_cfg.dtype and tuple(got.shape) == want.shape
    _close(got, want, 1e-5 if dtype == "float32" else BF16_RTOL, fn)


def _nonzero_cache(j_cfg, t_cfg, kind, seed):
    """A cache of 3 sequences in both packages' forms, every entry
    random (the state of a decode some steps in)."""
    rs = np.random.RandomState(seed)
    j = (j_rwkv.init_rwkv_cache(j_cfg, 3) if kind == "rwkv"
         else j_mamba.init_mamba_cache(j_cfg, 3))
    j = {k: jnp.asarray((0.5 * rs.randn(*a.shape)).astype(np.float32),
                        a.dtype) for k, a in j.items()}
    t = {k: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.float32 if a.dtype == jnp.float32 else t_cfg.dtype)
        for k, a in j.items()}
    return j, t


LAYER_DECODE = {
    "rwkv_time_decode": ("rwkv6-3b", "rwkv", t_rwkv.rwkv_time_decode,
                         j_rwkv.rwkv_time_decode, ("state", "tprev")),
    "rwkv_channel_decode": ("rwkv6-3b", "rwkv", t_rwkv.rwkv_channel_decode,
                            j_rwkv.rwkv_channel_decode, ("cprev",)),
    "mamba_decode": ("jamba-1.5-large-398b", "mamba_dense",
                     t_mamba.mamba_decode, j_mamba.mamba_decode,
                     ("conv", "ssm")),
}


@pytest.mark.parametrize("fn", list(LAYER_DECODE))
def test_layer_decode_matches_jax(fn):
    """One step from a non-zero cache: the output, the entries the step
    renews (stored into the port's dict in place) and the others kept."""
    name, flavour, t_fn, j_fn, renewed = LAYER_DECODE[fn]
    j_cfg, t_cfg, j_layer, layer = _layer(name, "float32", flavour, seed=7)
    j_cache, cache = _nonzero_cache(j_cfg, t_cfg, flavour[:5], seed=8)
    before = {k: v.clone() for k, v in cache.items()}
    jx, x = _x(j_cfg, (3, 1, j_cfg.d_model), seed=9)
    want, j_new = j_fn(j_layer, j_cfg, jx, j_cache)
    got, new = t_fn(layer, t_cfg, x, cache)
    assert new is cache and got.shape == (3, 1, j_cfg.d_model)
    _close(got, want, 1e-5, fn)
    for k in cache:
        _close(cache[k], j_new[k], 1e-5, k)
        assert torch.equal(cache[k], before[k]) == (k not in renewed), k


# --------------------------------------------------------------------------- #
# the stacks: forward, embed, generate, decode, loss
# --------------------------------------------------------------------------- #


class _JaxRuns:
    """Each architecture's JAX results, computed once per module."""

    def __init__(self):
        self._runs = {}

    def __call__(self, name):
        if name not in self._runs:
            self._runs[name] = self._run(name)
        return self._runs[name]

    @staticmethod
    def _run(name):
        j_cfg = _cfg(name)
        j_params, values = _params(j_cfg, seed=0)
        out = {"cfg": j_cfg, "values": values}
        toks = _tokens(2, 24, j_cfg.vocab, seed=0)
        logits, aux = jax.jit(lambda p, t: j_forward(
            j_cfg, p, {"tokens": t}))(j_params, jnp.asarray(toks))
        out["forward"] = (toks, np.asarray(logits), float(aux))
        docs = _tokens(5, 16, j_cfg.vocab, seed=1)
        out["embed"] = (docs, np.asarray(j_serve.embed_corpus(
            j_cfg, j_params, jnp.asarray(docs), block=2)))
        prompt = _tokens(3, 8, j_cfg.vocab, seed=2)
        gen, _ = j_serve.generate(j_cfg, j_params, jnp.asarray(prompt),
                                  max_new=8, max_len=16)
        out["generate"] = (prompt, np.asarray(gen))
        seq = _tokens(3, 12, j_cfg.vocab, seed=3)
        step = jax.jit(lambda p, tok, c, pos: j_decode_step(j_cfg, p, tok, c,
                                                            pos))
        cache = j_init_cache(j_cfg, 3, 12)
        steps = []
        for t in range(12):
            lg, cache = step(j_params, jnp.asarray(seq[:, t:t + 1]), cache,
                             jnp.int32(t))
            steps.append(np.asarray(lg))
        out["decode"] = (seq, steps)
        if name == "rwkv6-3b":
            batch = _tokens(2, 16, j_cfg.vocab, seed=4)
            (loss, parts), grads = jax.jit(jax.value_and_grad(
                j_make_loss_fn(j_cfg), has_aux=True))(
                    j_params, {"tokens": jnp.asarray(batch)})
            out["loss"] = (batch, float(loss),
                           {k: float(v) for k, v in parts.items()},
                           jax.tree.map(np.asarray, grads))
        return out


@pytest.fixture(scope="module")
def jax_runs():
    return _JaxRuns()


def _port(run):
    t_cfg = _to_torch_cfg(run["cfg"])
    return t_cfg, params_from_jax(run["values"], t_cfg, device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_aux_match_jax(jax_runs, name):
    run = jax_runs(name)
    t_cfg, params = _port(run)
    toks, want, want_aux = run["forward"]
    got, aux = forward(t_cfg, params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    n_moe = sum(bd.flavor.endswith("moe")
                for bd in layer_defs(layer_plan(t_cfg)))
    assert n_moe == (4 if t_cfg.moe is not None else 0)
    assert (float(aux) > 1.0) == (n_moe > 0)
    assert float(aux) == pytest.approx(want_aux, abs=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_embed_corpus_matches_jax(jax_runs, name):
    """Blocks of 2 over 5 sequences: the last block holds one sequence."""
    run = jax_runs(name)
    t_cfg, params = _port(run)
    docs, want = run["embed"]
    got = t_serve.embed_corpus(t_cfg, params, docs, block=2)
    assert got.dtype == torch.float32 and got.shape == (5, t_cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_jax(jax_runs, name):
    run = jax_runs(name)
    t_cfg, params = _port(run)
    prompt, want = run["generate"]
    got, _ = t_serve.generate(t_cfg, params, prompt, max_new=8, max_len=16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_jax_step_by_step(jax_runs, name):
    """12 steps of 3 tokens through ``decode_step``, each from the cache
    the last one left: a step that ran from a zeroed state (a cache
    thrown away) would differ from the second step on."""
    run = jax_runs(name)
    t_cfg, params = _port(run)
    seq, want = run["decode"]
    cache = init_cache(t_cfg, 3, 12, device="cpu")
    for t in range(12):
        lg, out = decode_step(t_cfg, params,
                              torch.from_numpy(seq[:, t:t + 1]), cache, t)
        assert out is cache
        np.testing.assert_allclose(lg.numpy(), want[t], atol=1e-4, rtol=0,
                                   err_msg=f"step {t}")


CACHE_KEYS = {"rwkv": {"state", "tprev", "cprev"},
              "mamba_dense": {"conv", "ssm"}, "mamba_moe": {"conv", "ssm"},
              "dense": {"k", "v"}}


@pytest.mark.parametrize("name", ARCHS)
def test_cache_layout_matches_jax(name):
    """Each layer's cache holds its flavour's entries, with the shapes
    and dtypes of the JAX package's (bf16, as the configs are)."""
    j_cfg = j_configs.get_reduced(name)
    t_cfg = _to_torch_cfg(j_cfg)
    cache = init_cache(t_cfg, 3, 12, device="cpu")
    want = j_init_cache(j_cfg, 3, 12)
    slots = [(f"g{gi}", f"s{si}", o, i)
             for gi, (ro, subs) in enumerate(layer_plan(t_cfg))
             for o in range(ro) for si, (ri, _) in enumerate(subs)
             for i in range(ri)]
    defs = layer_defs(layer_plan(t_cfg))
    assert len(cache) == len(defs) == len(slots)
    for c, bd, (g, s, o, i) in zip(cache, defs, slots):
        assert set(c) == CACHE_KEYS[bd.flavor], bd.flavor
        for k, t in c.items():
            a = want[g][s][k][o, i]
            assert tuple(t.shape) == a.shape, (bd.flavor, k)
            assert str(t.dtype) == f"torch.{a.dtype}", (bd.flavor, k)
            assert not t.any()


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_has_jax_layout(name):
    """The port's own init (bf16, the configs' dtype) gives the JAX
    tree's names, shapes and dtypes, and the constant leaves JAX's
    values bit for bit: mu, u, w0, D, and the bf16 roundings of Mamba's
    a_log = log(1..16) and dt_b = log(expm1(0.01))."""
    j_cfg = j_configs.get_reduced(name)
    t_cfg = _to_torch_cfg(j_cfg)
    params = init_params(t_cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    j_values, _ = j_init_params(j_cfg, jax.random.key(0))
    got = params_to_jax(params, t_cfg)
    as_layout = lambda tree: jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), tree)
    assert as_layout(got) == as_layout(j_values)
    consts = ("tmix_mu_r", "tmix_mu_k", "tmix_mu_v", "tmix_mu_g",
              "tmix_mu_w", "tmix_w0", "tmix_u", "cmix_mu_k", "cmix_mu_r",
              "mamba_dt_b", "mamba_a_log", "mamba_dskip")
    seen = 0
    for path, a in jax.tree_util.tree_flatten_with_path(j_values)[0]:
        if path[-1].key in consts:
            g, s = path[0].key, path[1].key
            b = got[g][s][path[-1].key]
            np.testing.assert_array_equal(
                np.asarray(a).view(np.int16), b.view(np.int16),
                err_msg=str(path))
            seen += 1
    # rwkv6: one stack of 9; jamba: 7 Mamba sub-blocks of 3
    assert seen == (9 if t_cfg.rwkv else 3 * 7)
    if not t_cfg.rwkv:
        # in bf16, A = -exp(a_log) is not exactly -(1..16)
        a = -np.exp(np.asarray(got["g0"]["s0"]["mamba_a_log"][0, 0],
                               np.float32))
        assert not np.array_equal(a[0], -np.arange(1, a.shape[1] + 1))


def test_loss_and_grads_match_jax(jax_runs):
    """rwkv6's loss (ce + z, no aux) and its gradient through the time
    recurrence, the decay LoRA and the token shifts."""
    run = jax_runs("rwkv6-3b")
    t_cfg, params = _port(run)
    batch, want_loss, want_parts, want_grads = run["loss"]
    live = [p.requires_grad_(True) for p in leaves(params)]
    loss, parts = make_loss_fn(t_cfg)(unflatten(params, live),
                                      {"tokens": torch.from_numpy(batch)})
    grads = unflatten(params, list(torch.autograd.grad(loss, live)))
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    for key in ("ce", "z"):
        assert float(parts[key]) == pytest.approx(want_parts[key], rel=1e-5)
    assert float(parts["aux"]) == want_parts["aux"] == 0.0
    want = params_to_jax(params_from_jax(want_grads, t_cfg, device="cpu"),
                         t_cfg)
    got = params_to_jax(grads, t_cfg)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert any("tmix_w_lora_a" in str(path) for path, _ in flat)
    for (path, a), b in zip(flat, jax.tree.leaves(got)):
        atol = max(1e-5, 1e-5 * np.abs(a).max())
        np.testing.assert_allclose(b, a, atol=atol, rtol=0,
                                   err_msg=str(path))

