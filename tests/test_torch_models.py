"""The port's LM substrate (``repro_torch.models``, ``configs``,
``launch.serve``) against the JAX package on the CPU.

Weights are the JAX package's own ``init_params`` draws, carried across
with ``models.convert.params_from_jax``; tokens are made with numpy from a
seed.  Tolerances: fp32 forward logits within 1e-4 and embeddings within
1e-5 (the frameworks sum in other orders; the outputs are of order 1);
bf16 forward logits within 3e-2, some bf16 ulps at logits below 1, since
XLA keeps fused elementwise chains in fp32 where PyTorch rounds each op
to bf16 (measured 0.009-0.011 over three seeds); the port's decode
against its own forward within 5e-5, the bound
``tests/test_decode_consistency.py`` holds the JAX package to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import gemma3_1b as j_gemma
from repro.launch import serve as j_serve
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import layer_plan as j_layer_plan
from repro_torch import configs as t_configs
from repro_torch import prng
from repro_torch.configs import gemma3_1b as t_gemma
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import (decode_step, forward, init_cache, init_params,
                                layer_plan)
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.stack import layer_defs

pytestmark = pytest.mark.torch_port

J_F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
T_F32 = dict(dtype=torch.float32, param_dtype=torch.float32)
J_REDUCED32 = dataclasses.replace(j_gemma.REDUCED, **J_F32)
T_REDUCED32 = dataclasses.replace(t_gemma.REDUCED, **T_F32)


def _jax_params(cfg, seed):
    values, _ = j_init_params(cfg, jax.random.key(seed))
    return values, jax.tree.map(np.asarray, values)


def _tokens(b, s, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)) \
        .astype(np.int32)


def _to_torch_cfg(cfg):
    """A JAX ModelConfig as the port's (dtypes and nested configs)."""
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    fields["dtype"], fields["param_dtype"] = dt[cfg.dtype], \
        dt[cfg.param_dtype]
    if cfg.moe is not None:
        moe = dataclasses.asdict(cfg.moe)
        moe["router_dtype"] = dt[cfg.moe.router_dtype]
        fields["moe"] = t_common.MoEConfig(**moe)
    if cfg.mamba is not None:
        fields["mamba"] = t_common.MambaConfig(**dataclasses.asdict(cfg.mamba))
    return t_common.ModelConfig(**fields)


# --------------------------------------------------------------------------- #
# configs and plans
# --------------------------------------------------------------------------- #


def test_gemma3_configs_equal_jax():
    for j_cfg, t_cfg in ((j_gemma.CONFIG, t_gemma.CONFIG),
                         (j_gemma.REDUCED, t_gemma.REDUCED)):
        assert t_cfg == _to_torch_cfg(j_cfg)
    assert t_configs.get_config("gemma3-1b") is t_gemma.CONFIG
    assert t_configs.get_reduced("gemma3-1b") is t_gemma.REDUCED
    assert dataclasses.asdict(t_configs.get_arch("gemma3-1b")) \
        == dataclasses.asdict(j_configs.get_arch("gemma3-1b"))
    assert t_configs.ARCH_NAMES == j_configs.ARCH_NAMES
    assert t_configs.SHAPES == j_configs.SHAPES


@pytest.mark.parametrize("name", [n for n in t_configs.PORTED
                                  if n != "gemma3-1b"])
def test_ported_configs_equal_jax(name):
    """CONFIG, REDUCED and ARCH of every other ported architecture equal
    the JAX package's (gemma3-1b's: the test above)."""
    assert t_configs.get_config(name) \
        == _to_torch_cfg(j_configs.get_config(name))
    assert t_configs.get_reduced(name) \
        == _to_torch_cfg(j_configs.get_reduced(name))
    assert dataclasses.asdict(t_configs.get_arch(name)) \
        == dataclasses.asdict(j_configs.get_arch(name))


def test_ported_architectures():
    assert set(t_configs.PORTED) == {
        "gemma3-1b", "tinyllama-1.1b", "qwen3-8b", "phi4-mini-3.8b",
        "olmoe-1b-7b", "deepseek-v3-671b", "rwkv6-3b",
        "jamba-1.5-large-398b"}


@pytest.mark.parametrize("name", [n for n in j_configs.ARCH_NAMES
                                  if n not in t_configs.PORTED])
def test_unported_architecture_raises(name):
    with pytest.raises(NotImplementedError):
        t_configs.get_config(name)


@pytest.mark.parametrize("name", j_configs.ARCH_NAMES)
def test_layer_plan_equals_jax(name):
    j_cfg = j_configs.get_config(name)
    t_plan = layer_plan(_to_torch_cfg(j_cfg))
    j_plan = j_layer_plan(j_cfg)
    as_tuples = lambda plan: [(ro, [(ri, dataclasses.astuple(bd))
                                    for ri, bd in subs])
                              for ro, subs in plan]
    assert as_tuples(t_plan) == as_tuples(j_plan)


def test_unported_flavour_raises():
    cfg = _to_torch_cfg(j_configs.get_reduced("llama-3.2-vision-90b"))
    with pytest.raises(NotImplementedError, match="cross_dense"):
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #


# (architecture, dtype, the layer to spot-check, its JAX stack and
# (outer, inner) index, a leaf): gemma3 REDUCED is [(2, [(2, local),
# (1, global)])], so layer 4 is outer repeat 1, sub-block 0, inner repeat
# 1; olmoe's second layer is g0/s0[0, 1]; deepseek's layers are one
# mla_dense prefix (g0) and two mla_moe (g1), its third g1/s0[0, 1];
# rwkv6's two layers are g0/s0[0, 0] and [0, 1]; jamba's REDUCED plan is
# [(1, [8 sub-blocks of 1])], layer i under g0/s{i}[0, 0]: 0 mamba_dense,
# 4 dense (attention), 5 mamba_moe
ROUND_TRIPS = [
    pytest.param("gemma3-1b", "float32", 4, ("g0", "s0", 1, 1), "attn_wq",
                 id="float32"),
    pytest.param("gemma3-1b", "bfloat16", 4, ("g0", "s0", 1, 1), "attn_wq",
                 id="bfloat16"),
    pytest.param("olmoe-1b-7b", "bfloat16", 1, ("g0", "s0", 0, 1), "moe_wg",
                 id="olmoe-1b-7b-bfloat16"),
    pytest.param("deepseek-v3-671b", "bfloat16", 2, ("g1", "s0", 0, 1),
                 "mla_wk_b", id="deepseek-v3-671b-bfloat16"),
    pytest.param("rwkv6-3b", "bfloat16", 1, ("g0", "s0", 0, 1),
                 "tmix_w_lora_a", id="rwkv-bfloat16"),
    pytest.param("jamba-1.5-large-398b", "float32", 0, ("g0", "s0", 0, 0),
                 "mamba_a_log", id="mamba_dense-float32"),
    pytest.param("jamba-1.5-large-398b", "bfloat16", 5, ("g0", "s5", 0, 0),
                 "mamba_dt_w", id="mamba_moe-bfloat16"),
]


@pytest.mark.parametrize("name,dtype,layer,where,leaf", ROUND_TRIPS)
def test_params_from_jax_round_trip(name, dtype, layer, where, leaf):
    j_cfg = j_configs.get_reduced(name)
    if dtype == "float32":
        j_cfg = dataclasses.replace(j_cfg, **J_F32)
    t_cfg = _to_torch_cfg(j_cfg)
    _, values = _jax_params(j_cfg, seed=3)
    params = params_from_jax(values, t_cfg, device="cpu")
    assert len(params["layers"]) == j_cfg.n_layers
    g, si, o, i = where
    want = values[g][si][leaf][o, i]
    got = params["layers"][layer][leaf]
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    back = params_to_jax(params, t_cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(values)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_init_params_has_jax_layout():
    """The port's own init gives the JAX tree's names, shapes and dtypes."""
    params = init_params(t_gemma.REDUCED, torch.Generator().manual_seed(0),
                         device="cpu")
    shapes = jax.eval_shape(lambda k: j_init_params(j_gemma.REDUCED, k)[0],
                            jax.random.key(0))
    back = params_to_jax(params, t_gemma.REDUCED)
    got = jax.tree.map(lambda a: (a.shape, str(a.dtype)), back)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), shapes)
    assert got == want


# --------------------------------------------------------------------------- #
# primitives and attention
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 64).astype(np.float32)
    gamma = (0.1 * rs.randn(64)).astype(np.float32)
    t_dt, j_dt = (torch.float32, jnp.float32) if dtype == "float32" \
        else (torch.bfloat16, jnp.bfloat16)
    got = t_common.rms_norm(torch.from_numpy(x).to(t_dt),
                            torch.from_numpy(gamma).to(t_dt))
    want = j_common.rms_norm(jnp.asarray(x, j_dt), jnp.asarray(gamma, j_dt))
    atol = 1e-6 if dtype == "float32" else 1.6e-2   # one bf16 ulp at |x|<4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("theta", [10_000.0, 1e6])
def test_rope_matches_jax(theta):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 4, 40, 16).astype(np.float32)
    pos = np.arange(40)
    cos, sin = t_common.rope_freqs(torch.from_numpy(pos), 16, theta)
    j_cos, j_sin = j_common.rope_freqs(jnp.asarray(pos), 16, theta)
    np.testing.assert_allclose(cos.numpy(), np.asarray(j_cos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(j_sin), atol=1e-6)
    got = t_common.apply_rope(torch.from_numpy(x), cos, sin)
    want = j_common.apply_rope(jnp.asarray(x), j_cos, j_sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("window,theta", [(8, None), (None, 1e6)])
def test_attn_fwd_matches_jax(window, theta):
    """One local and one global layer of gemma3 REDUCED in fp32."""
    _, values = _jax_params(J_REDUCED32, seed=5)
    params = params_from_jax(values, T_REDUCED32, device="cpu")
    layer = params["layers"][2]
    j_layer = jax.tree.map(lambda a: jnp.asarray(a[0, 0]),
                           values["g0"]["s1"])
    x = np.random.RandomState(2).randn(2, 24, 64).astype(np.float32)
    got = t_attn.attn_fwd(layer, T_REDUCED32, torch.from_numpy(x),
                          positions=torch.arange(24), window=window,
                          rope_theta=theta)
    want = j_attn.attn_fwd(j_layer, J_REDUCED32, jnp.asarray(x),
                           positions=jnp.arange(24), window=window,
                           rope_theta=theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("window", [None, 4])
def test_init_kv_cache_resolves_its_device(monkeypatch, window):
    """With no device the cache goes to the card, and without one that
    raises; device="cpu" gives the JAX cache's shapes, dtype and zeros."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_attn.init_kv_cache(T_REDUCED32, 2, 16, window=window)
    got = t_attn.init_kv_cache(T_REDUCED32, 2, 16, window=window,
                               device="cpu")
    want = j_attn.init_kv_cache(J_REDUCED32, 2, 16, window=window)
    assert set(got) == set(want) == {"k", "v"}
    for name in ("k", "v"):
        assert got[name].device.type == "cpu"
        assert got[name].dtype == torch.float32
        assert tuple(got[name].shape) == want[name].shape
        assert not got[name].any()
        assert not np.asarray(want[name]).any()


# --------------------------------------------------------------------------- #
# the stack and the serving entry points
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    j_cfg = J_REDUCED32 if dtype == "float32" else j_gemma.REDUCED
    t_cfg = T_REDUCED32 if dtype == "float32" else t_gemma.REDUCED
    j_params, values = _jax_params(j_cfg, seed=0)
    params = params_from_jax(values, t_cfg, device="cpu")
    toks = _tokens(2, 24, t_cfg.vocab, seed=0)
    got, aux = forward(t_cfg, params, {"tokens": torch.from_numpy(toks)})
    want, _ = j_forward(j_cfg, j_params, {"tokens": jnp.asarray(toks)})
    assert got.dtype == t_cfg.dtype and got.shape == (2, 24, t_cfg.vocab)
    assert float(aux) == 0.0
    atol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen3-8b",
                                  "phi4-mini-3.8b"])
def test_dense_configs_forward_and_decode_match_jax(name):
    """The three dense configs at REDUCED in fp32: forward logits, then
    decode step by step, each against the JAX package's (qwen3 with
    qk_norm, phi4 with tied embeddings, tinyllama with head dim 8)."""
    from repro.models import decode_step as j_decode_step
    from repro.models import init_cache as j_init_cache
    j_cfg = dataclasses.replace(j_configs.get_reduced(name), **J_F32)
    t_cfg = _to_torch_cfg(j_cfg)
    j_params, values = _jax_params(j_cfg, seed=6)
    params = params_from_jax(values, t_cfg, device="cpu")
    toks = _tokens(2, 10, t_cfg.vocab, seed=6)
    got, _ = forward(t_cfg, params, {"tokens": torch.from_numpy(toks)})
    want, _ = jax.jit(lambda p, t: j_forward(j_cfg, p, {"tokens": t}))(
        j_params, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    step = jax.jit(lambda p, tok, c, pos: j_decode_step(j_cfg, p, tok, c,
                                                        pos))
    j_cache = j_init_cache(j_cfg, 2, 10)
    cache = init_cache(t_cfg, 2, 10, device="cpu")
    for t in range(10):
        want, j_cache = step(j_params, jnp.asarray(toks[:, t:t + 1]),
                             j_cache, jnp.int32(t))
        lg, cache = decode_step(t_cfg, params,
                                torch.from_numpy(toks[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0, err_msg=f"step {t}")


BASE = dict(n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab=64, remat=False, **T_F32)


@pytest.mark.parametrize("extra", [
    {},                                                  # dense GQA
    {"qk_norm": True},
    {"n_layers": 6, "sliding_window": 4, "global_every": 3,
     "rope_theta_global": 1e6},                          # ring cache
], ids=["dense_gqa", "qk_norm", "sliding_window_ring_cache"])
def test_decode_matches_forward(extra):
    """Token-by-token decode reproduces the port's own forward pass (with
    S = 12 > window 4, the ring cache wraps)."""
    cfg = t_common.ModelConfig(name="t", kind="dense", **{**BASE, **extra})
    params = init_params(cfg, torch.Generator().manual_seed(1),
                         device="cpu")
    if cfg.qk_norm:        # zeros at init: make the norms do something
        gen = torch.Generator().manual_seed(2)
        for layer in params["layers"]:
            for name in ("attn_qnorm", "attn_knorm"):
                layer[name] = 0.3 * torch.randn(cfg.hd, generator=gen)
    toks = torch.from_numpy(_tokens(2, 12, cfg.vocab, seed=2))
    logits, _ = forward(cfg, params, {"tokens": toks})
    cache = init_cache(cfg, 2, 12, device="cpu")
    errs = []
    for t in range(12):
        lg, cache = decode_step(cfg, params, toks[:, t:t + 1], cache, t)
        errs.append(float((lg - logits[:, t]).abs().max()))
    assert max(errs) < 5e-5, errs


def test_ring_cache_has_window_slots():
    cfg = t_common.ModelConfig(name="t", kind="dense", sliding_window=4,
                               global_every=3, **{**BASE, "n_layers": 6})
    cache = init_cache(cfg, 2, 12, device="cpu")
    slots = [c["k"].shape[2] for c in cache]
    assert slots == [4 if bd.window else 12
                     for bd in layer_defs(layer_plan(cfg))]
    assert slots == [4, 4, 12, 4, 4, 12]


def test_embed_corpus_matches_jax():
    j_params, values = _jax_params(J_REDUCED32, seed=1)
    params = params_from_jax(values, T_REDUCED32, device="cpu")
    toks = _tokens(5, 32, 512, seed=1)
    got = t_serve.embed_corpus(T_REDUCED32, params, toks, block=2)
    want = j_serve.embed_corpus(J_REDUCED32, j_params, jnp.asarray(toks),
                                block=2)
    assert got.dtype == torch.float32 and got.shape == (5, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 11)],
                         ids=["greedy", "temperature"])
def test_generate_matches_jax(temperature, seed):
    j_params, values = _jax_params(J_REDUCED32, seed=2)
    params = params_from_jax(values, T_REDUCED32, device="cpu")
    prompt = _tokens(3, 10, 512, seed=3)
    got, stats = t_serve.generate(T_REDUCED32, params, prompt, max_new=12,
                                  max_len=32, temperature=temperature,
                                  seed=seed)
    want, j_stats = j_serve.generate(J_REDUCED32, j_params,
                                     jnp.asarray(prompt), max_new=12,
                                     max_len=32, temperature=temperature,
                                     seed=seed)
    assert set(stats) == set(j_stats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uniform_and_gumbel_noise_match_jax(dtype):
    """The sampling noise: uniform draws bit-equal to ``jax.random.uniform``
    in both dtypes; the Gumbel transform within an ulp or two in fp32 (the
    two libraries' ``log`` differ in the last bit, and where -log(u) is
    near 1 the outer log turns that into an absolute error of about 1e-7)
    and bit-equal in bf16."""
    t_dt, j_dt = (torch.float32, jnp.float32) if dtype == "float32" \
        else (torch.bfloat16, jnp.bfloat16)
    tiny = float(jnp.finfo(j_dt).tiny)
    key = prng.key(9)
    u = prng.uniform(key, (4096,), minval=tiny, maxval=1.0, dtype=t_dt,
                     device="cpu")
    j_u = jax.random.uniform(jax.random.key(9), (4096,), j_dt, minval=tiny,
                             maxval=1.0)
    np.testing.assert_array_equal(u.float().numpy(),
                                  np.asarray(j_u, np.float32))
    g = t_serve._gumbel(key, (4096,), t_dt, torch.device("cpu"))
    j_g = np.asarray(jax.random.gumbel(jax.random.key(9), (4096,), j_dt),
                     np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g.numpy(), j_g, rtol=2.4e-7, atol=2.4e-7)
    else:
        np.testing.assert_array_equal(g.float().numpy(), j_g)
