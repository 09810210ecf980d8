"""The port's MoE and MLA block flavours (``repro_torch.models.moe``,
``mla``, the ``moe`` / ``mla_dense`` / ``mla_moe`` blocks of ``stack``)
against the JAX package on the CPU, at olmoe-1b-7b's and
deepseek-v3-671b's REDUCED configs in fp32.

Weights are the JAX package's own ``init_params`` draws, carried across
with ``models.convert.params_from_jax``; inputs are made with numpy from
a seed.  Each JAX result is computed once per module (``jax_runs``),
under ``jax.jit`` where the JAX package allows it.

Tolerances:
  * ``moe_ffn`` in fp32 within 2e-6 of the largest |output| (the
    REDUCED experts' outputs are of order 50: the JAX package scales the
    (E, d, f) expert weights by 1/sqrt(E), not 1/sqrt(d); measured
    2.8e-7, one or two fp32 ulps, from the frameworks' product orders);
    the aux loss within 1e-6.  In bf16, on the same bf16 inputs, within
    two bf16 ulps of the largest |output| (2**-7 of it; measured one ulp
    on one element in 7,680), the counterpart of ``test_torch_models``'s
    3e-2 for values below 1.  Which assignments drop is exact: the same
    stable sort on the same routing.
  * MLA forward and absorbed decode within 1e-5 (outputs of order 1).
  * The stacks: logits within 1e-4, the summed aux loss within 1e-6 and
    embeddings within 1e-5, as ``test_torch_models`` holds gemma3;
    greedy tokens equal; the loss within 1e-5 relative and gradients
    within 1e-5 of each leaf's largest |gradient| (at least 1e-5
    absolute), as ``test_torch_train`` holds gemma3's (1e-5 absolute).
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
from repro.models import mla as j_mla
from repro.models import moe as j_moe
from repro.train import make_loss_fn as j_make_loss_fn
from repro_torch.launch import serve as t_serve
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.models import mla as t_mla
from repro_torch.models import moe as t_moe
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.stack import layer_defs, layer_plan
from repro_torch.train._tree import leaves, unflatten
from repro_torch.train.train_step import make_loss_fn
from test_torch_models import _to_torch_cfg, _tokens

pytestmark = pytest.mark.torch_port

ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
J_F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)


def _cfg(name, capacity_factor=None, dtype="float32"):
    cfg = j_configs.get_reduced(name)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, **J_F32)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _params(j_cfg, seed):
    values, _ = j_init_params(j_cfg, jax.random.key(seed))
    return values, jax.tree.map(np.asarray, values)


def _last_layer(values):
    """The last layer of the JAX tree (a MoE layer in both configs) as a
    dict of unstacked arrays."""
    last = max(k for k in values if k.startswith("g"))
    return jax.tree.map(lambda a: jnp.asarray(a[-1, -1]), values[last]["s0"])


# --------------------------------------------------------------------------- #
# moe_ffn and the MLA functions
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_matches_jax(name, capacity_factor, dtype):
    """olmoe's FFN (no shared expert) and deepseek's (one shared expert)
    on 3 x 40 tokens: at 0.5 many assignments drop, at 8 none does."""
    j_cfg = _cfg(name, capacity_factor, dtype)
    t_cfg = _to_torch_cfg(j_cfg)
    _, values = _params(j_cfg, seed=4)
    layer = params_from_jax(values, t_cfg, device="cpu")["layers"][-1]
    x = np.random.RandomState(5).randn(3, 40, j_cfg.d_model) \
        .astype(np.float32)
    jx = jnp.asarray(x, j_cfg.dtype)
    want, want_aux = j_moe.moe_ffn(_last_layer(values), j_cfg, jx)
    got, aux = t_moe.moe_ffn(layer, t_cfg,
                             torch.from_numpy(np.array(jx, np.float32))
                             .to(t_cfg.dtype))
    assert got.dtype == t_cfg.dtype and got.shape == (3, 40, j_cfg.d_model)
    assert aux.dtype == torch.float32
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-6)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    rtol = 2e-6 if dtype == "float32" else 2.0 ** -7
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rtol * scale, (err, scale)
    # the drops: JAX's routing puts n_e of the 120 x top_k assignments on
    # expert e, and max(n_e - cap, 0) of them drop
    mo = t_cfg.moe
    cap = t_moe.capacity(mo, 120)
    assert cap == int(capacity_factor * 120 * mo.top_k / mo.num_experts) + 1
    router = _last_layer(values)["moe_router"].astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(
        jx.reshape(120, -1).astype(jnp.float32) @ router), mo.top_k)
    per_expert = np.bincount(np.asarray(idx).ravel(),
                             minlength=mo.num_experts)
    dropped = int(np.maximum(per_expert - cap, 0).sum())
    assert (dropped > 0) == (capacity_factor < 8)


def _mla_layer(seed):
    j_cfg = _cfg("deepseek-v3-671b")
    t_cfg = _to_torch_cfg(j_cfg)
    _, values = _params(j_cfg, seed)
    layer = params_from_jax(values, t_cfg, device="cpu")["layers"][0]
    j_layer = jax.tree.map(lambda a: jnp.asarray(a[0, 0]), values["g0"]["s0"])
    # the norms' gammas are zeros at init: make them do something
    rs = np.random.RandomState(seed)
    for name in ("mla_q_norm", "mla_kv_norm"):
        g = (0.3 * rs.randn(*j_layer[name].shape)).astype(np.float32)
        j_layer[name] = jnp.asarray(g)
        layer[name] = torch.from_numpy(g)
    return j_cfg, t_cfg, j_layer, layer


def test_mla_fwd_matches_jax():
    j_cfg, t_cfg, j_layer, layer = _mla_layer(seed=6)
    x = np.random.RandomState(7).randn(2, 20, j_cfg.d_model) \
        .astype(np.float32)
    got = t_mla.mla_fwd(layer, t_cfg, torch.from_numpy(x),
                        positions=torch.arange(20))
    want = j_mla.mla_fwd(j_layer, j_cfg, jnp.asarray(x),
                         positions=jnp.arange(20))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_mla_decode_matches_jax():
    """The absorbed decode, step by step over 10 positions of a 12-slot
    latent cache: the outputs and the caches."""
    j_cfg, t_cfg, j_layer, layer = _mla_layer(seed=8)
    x = np.random.RandomState(9).randn(2, 10, j_cfg.d_model) \
        .astype(np.float32)
    j_cache = j_mla.init_mla_cache(j_cfg, 2, 12)
    cache = t_mla.init_mla_cache(t_cfg, 2, 12, device="cpu")
    step = jax.jit(lambda xx, c, pos: j_mla.mla_decode(j_layer, j_cfg, xx, c,
                                                       pos))
    for t in range(10):
        want, j_cache = step(jnp.asarray(x[:, t:t + 1]), j_cache,
                             jnp.int32(t))
        got, cache = t_mla.mla_decode(layer, t_cfg,
                                      torch.from_numpy(x[:, t:t + 1]), cache,
                                      t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0, err_msg=f"step {t}")
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(j_cache[name]), atol=1e-5)


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
        if name == "olmoe-1b-7b":
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
    # every MoE layer adds its loss: about 1 a layer at balanced routing
    n_moe = sum(bd.flavor.endswith("moe")
                for bd in layer_defs(layer_plan(t_cfg)))
    assert n_moe == 2 and float(aux) > 1.0
    assert float(aux) == pytest.approx(want_aux, abs=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_embed_corpus_matches_jax(jax_runs, name):
    """Blocks of 2 over 5 sequences: the last block holds one sequence,
    so its MoE capacity is that of 16 tokens, not 32."""
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


def _record_drops(monkeypatch):
    """Wrap the port's ``moe_ffn`` so that each call appends the number of
    assignments its routing drops past the capacity (the router
    recomputed from the call's inputs)."""
    dropped = []
    inner = t_moe.moe_ffn

    def recording(p, cfg, x, prefix="moe"):
        mo = cfg.moe
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p[f"{prefix}_router"].float(), dim=-1)
        idx = torch.topk(probs, mo.top_k, dim=-1).indices
        per_expert = torch.bincount(idx.reshape(-1),
                                    minlength=mo.num_experts)
        cap = t_moe.capacity(mo, idx.shape[0])
        dropped.append(int((per_expert - cap).clamp_min(0).sum()))
        return inner(p, cfg, x, prefix)

    monkeypatch.setattr(t_moe, "moe_ffn", recording)
    return dropped


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_jax_step_by_step(jax_runs, name, monkeypatch):
    """Decode steps of 3 tokens: the MoE runs at cap = int(1.25 * 3 * 2 /
    8) + 1 = 1, so tokens routed to the same expert drop, in both."""
    run = jax_runs(name)
    t_cfg, params = _port(run)
    seq, want = run["decode"]
    assert t_moe.capacity(t_cfg.moe, 3) == 1
    dropped = _record_drops(monkeypatch)
    cache = init_cache(t_cfg, 3, 12, device="cpu")
    assert set(cache[-1]) == ({"ckv", "krope"} if t_cfg.mla
                              else {"k", "v"})
    for t in range(12):
        lg, cache = decode_step(t_cfg, params,
                                torch.from_numpy(seq[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(lg.numpy(), want[t], atol=1e-4, rtol=0,
                                   err_msg=f"step {t}")
    assert sum(dropped) > 0         # some assignments did drop


def test_loss_and_grads_match_jax(jax_runs):
    """olmoe's loss (ce + 0.01 aux + z) and its gradient, router and
    experts included."""
    run = jax_runs("olmoe-1b-7b")
    t_cfg, params = _port(run)
    batch, want_loss, want_parts, want_grads = run["loss"]
    live = [p.requires_grad_(True) for p in leaves(params)]
    loss, parts = make_loss_fn(t_cfg)(unflatten(params, live),
                                      {"tokens": torch.from_numpy(batch)})
    grads = unflatten(params, list(torch.autograd.grad(loss, live)))
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    for key in ("ce", "aux", "z"):
        assert float(parts[key]) == pytest.approx(want_parts[key], rel=1e-5)
    want = params_to_jax(params_from_jax(want_grads, t_cfg, device="cpu"),
                         t_cfg)
    got = params_to_jax(grads, t_cfg)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert any("moe_router" in str(path) for path, _ in flat)
    for (path, a), b in zip(flat, jax.tree.leaves(got)):
        assert np.abs(a).max() > 0 or "norm" in str(path), path
        atol = max(1e-5, 1e-5 * np.abs(a).max())
        np.testing.assert_allclose(b, a, atol=atol, rtol=0,
                                   err_msg=str(path))


def test_init_params_has_jax_layout():
    """The port's own init gives the JAX trees' names, shapes and dtypes
    for both configs (bf16), the expert weights' fan-in quirk included."""
    for name in ARCHS:
        j_cfg = j_configs.get_reduced(name)
        t_cfg = _to_torch_cfg(j_cfg)
        params = init_params(t_cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        shapes = jax.eval_shape(lambda k: j_init_params(j_cfg, k)[0],
                                jax.random.key(0))
        got = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           params_to_jax(params, t_cfg))
        assert got == jax.tree.map(lambda a: (a.shape, str(a.dtype)), shapes)
        wg = params["layers"][-1]["moe_wg"].float()
        e = t_cfg.moe.num_experts
        assert wg.std().item() == pytest.approx(e ** -0.5, rel=0.05)
