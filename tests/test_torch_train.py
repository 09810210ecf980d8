"""The port's training substrate (``repro_torch.train``,
``launch.train``) on the CPU: the cases of ``tests/test_training.py``,
then parity with the JAX package on numpy-seeded inputs.

Tolerances: ``lr_schedule`` within 1e-7 relative (fp32 cos and pow of
two libraries); ``adamw_update`` within 1e-6 (one step, the same
formulas op for op; XLA may contract a multiply-add); int8 compression
words, scales, dequantised values and errors equal to the jitted JAX
function's; loss within 1e-5 and gradients within 1e-5 absolute (fp32,
other summation orders); three train steps from the same state: losses
and grad norms within 1e-5 relative, every leaf 99.9 % within 1e-5 (see
STEP_ATOL), with int8 the port compressing the JAX step's gradients (see
_inject_jax_grads); remat and resume bit for bit.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_dense_cfg
from repro.configs import gemma3_1b as j_gemma
from repro.data import token_stream_batch as j_tokens
from repro.models import init_params as j_init_params
from repro.train import (AdamWConfig as JAdamW,
                         CheckpointManager as JCheckpointManager,
                         TrainState as JTrainState,
                         compress_grads as j_compress,
                         make_loss_fn as j_make_loss_fn,
                         make_train_step as j_make_train_step)
from repro.train.optimizer import (adamw_init as j_adamw_init,
                                   adamw_update as j_adamw_update,
                                   lr_schedule as j_lr_schedule)
from repro_torch.configs import gemma3_1b as t_gemma
from repro_torch.data import token_stream_batch
from repro_torch.launch import train as t_launch
from repro_torch.models import ModelConfig, init_params
from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                        train_state_from_jax,
                                        train_state_to_jax)
from repro_torch.train import (AdamWConfig, CheckpointManager, TrainState,
                               compress_grads, make_loss_fn, make_train_step)
from repro_torch.train._tree import leaves, leaves_with_paths, unflatten
from repro_torch.train.compression import int8_words
from repro_torch.train.train_step import stacked_scale_groups
from repro_torch.train.optimizer import adamw_init, adamw_update, lr_schedule

pytestmark = pytest.mark.torch_port


def _cfg(**kw):
    """conftest.small_dense_cfg as the port's config."""
    base = dict(name="t", kind="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab=256, dtype=torch.float32,
                param_dtype=torch.float32, remat=False)
    base.update(kw)
    return ModelConfig(**base)


def _fresh(cfg=None, opt=None, compression=None):
    cfg = cfg or _cfg()
    opt = opt or AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    return cfg, opt, TrainState.create(opt, params, compression=compression)


def _batch(t, b, s, vocab):
    return {"tokens": token_stream_batch(t, batch=b, seq_len=s, vocab=vocab,
                                         device="cpu")}


# --------------------------------------------------------------------------- #
# tests/test_training.py on the port
# --------------------------------------------------------------------------- #


def test_loss_decreases_over_training():
    cfg, opt, state = _fresh()
    step = make_train_step(cfg, opt)
    losses = []
    for t in range(30):
        state, m = step(state, _batch(t, 8, 32, cfg.vocab))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_grad_accum_matches_single_batch():
    cfg, opt, state = _fresh()
    batch = _batch(0, 8, 32, cfg.vocab)
    s1, m1 = make_train_step(cfg, opt, accum_steps=1)(state, batch)
    s4, m4 = make_train_step(cfg, opt, accum_steps=4)(state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for a, b in zip(leaves(s1.params), leaves(s4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_bf16_compression_close_to_exact():
    cfg, opt, state = _fresh()
    batch = _batch(0, 8, 32, cfg.vocab)
    s_ref, _ = make_train_step(cfg, opt)(state, batch)
    s_c, _ = make_train_step(cfg, opt, compression="bf16")(state, batch)
    for a, b in zip(leaves(s_ref.params), leaves(s_c.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-2)


def test_int8_error_feedback_accumulates_to_zero():
    g = {"w": torch.as_tensor(np.random.RandomState(0).randn(64) * 1e-3,
                              dtype=torch.float32)}
    err = None
    outs = []
    for _ in range(50):
        dq, err = compress_grads(g, "int8_ef", err)
        outs.append(dq["w"].numpy())
    np.testing.assert_allclose(np.mean(outs, axis=0), g["w"].numpy(),
                               rtol=0.02, atol=1e-6)


def test_int8_training_converges():
    cfg, opt, state = _fresh(compression="int8_ef")
    step = make_train_step(cfg, opt, compression="int8_ef")
    losses = []
    for t in range(30):
        state, m = step(state, _batch(t, 8, 32, cfg.vocab))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_checkpoint_restart_is_bit_exact():
    cfg, opt, state = _fresh()
    step = make_train_step(cfg, opt)
    for t in range(3):
        state, _ = step(state, _batch(t, 4, 16, cfg.vocab))
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=2)
        cm.save(3, state)
        restored, s = cm.restore(state)
        assert s == 3
        for t in range(3, 6):
            batch = _batch(t, 4, 16, cfg.vocab)
            state, m_live = step(state, batch)
            restored, m_rest = step(restored, batch)
        assert float(m_live["loss"]) == float(m_rest["loss"])
        for a, b in zip(leaves(state), leaves(restored)):
            assert torch.equal(a, b)


def test_checkpoint_detects_corruption():
    cfg, opt, state = _fresh()
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        path = cm.save(1, state)
        npz = os.path.join(path, "arrays.npz")
        data = dict(np.load(npz))
        k = sorted(data)[0]
        data[k] = data[k] + 1.0
        np.savez(npz, **data)
        with pytest.raises(IOError):
            cm.restore(state)


def test_checkpoint_keep_n_and_tmp_gc():
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=2)
        for s in range(5):
            cm.save(s, {"x": torch.zeros(3)})
        assert cm.available_steps() == [3, 4]
        os.makedirs(os.path.join(d, "step_00000099.tmp-123"))
        cm.save(9, {"x": torch.zeros(3)})
        assert not any(".tmp-" in f for f in os.listdir(d))


def test_elastic_restore_onto_different_template_dtype():
    """Restore validates the structure and returns the stored values in
    their stored dtype, whatever the template's leaves hold."""
    cfg, opt, state = _fresh()
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        cm.save(1, state)
        restored, _ = cm.restore(state)
        for a, b in zip(leaves(state), leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        bf16 = TrainState.create(
            dataclasses.replace(opt, moment_dtype=torch.bfloat16),
            state.params)
        again, _ = cm.restore(bf16)
        for a, b in zip(leaves(state), leaves(again)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_lr_schedule_warmup_and_cosine():
    opt = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                      min_lr_frac=0.1)
    assert float(lr_schedule(opt, 0)) == 0.0
    assert float(lr_schedule(opt, 10)) == pytest.approx(1.0)
    assert float(lr_schedule(opt, 110)) == pytest.approx(0.1)
    mid = float(lr_schedule(opt, 60))
    assert 0.1 < mid < 1.0


# --------------------------------------------------------------------------- #
# parity with the JAX package
# --------------------------------------------------------------------------- #


def test_lr_schedule_matches_jax():
    for kw in (dict(lr=3e-4, warmup_steps=10, total_steps=100),
               dict(lr=1.0, warmup_steps=7, total_steps=50,
                    min_lr_frac=0.05)):
        for step in (0, 1, 6, 7, 10, 23, 49, 50, 51, 200):
            want = float(j_lr_schedule(JAdamW(**kw), jnp.int32(step)))
            got = float(lr_schedule(AdamWConfig(**kw), step))
            assert got == pytest.approx(want, rel=1e-7, abs=1e-12), \
                (kw, step)


def _random_tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {"a": (rs.randn(5, 7) * scale).astype(np.float32),
            "b": {"c": (rs.randn(11) * scale).astype(np.float32),
                  "d": (rs.randn(3, 2, 4) * scale).astype(np.float32)}}


def _t(tree):
    return jax.tree.map(torch.as_tensor, tree)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_jax(clip):
    p, g = _random_tree(0), _random_tree(1, scale=0.5)
    j_cfg = JAdamW(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=clip)
    t_cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                        clip_norm=clip)
    j_state, t_state = j_adamw_init(j_cfg, p), adamw_init(t_cfg, _t(p))
    j_p, t_p = jax.tree.map(jnp.asarray, p), _t(p)
    for i in range(3):
        g_i = jax.tree.map(lambda x: x * (i + 1), g)
        j_p, j_state, j_m = j_adamw_update(j_cfg, g_i, j_p, j_state)
        t_p, t_state, t_m = adamw_update(t_cfg, _t(g_i), t_p, t_state)
    for a, b in zip(jax.tree.leaves(j_p), leaves(t_p)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(j_state[key]), leaves(t_state[key])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-12)
    assert int(t_state["step"]) == int(j_state["step"]) == 3
    for key in ("grad_norm", "lr"):
        assert float(t_m[key]) == pytest.approx(float(j_m[key]), rel=1e-6)


# The JAX step compresses under jit, where XLA multiplies by fl(1 / 127)
# and fuses the residual into one multiply-add; eager JAX does neither,
# so the port is held to the jitted function.
j_compress_jit = jax.jit(j_compress, static_argnums=1)


def test_compress_grads_int8_words_and_bf16_equal_jax():
    g = _random_tree(2, scale=1e-3)
    j_err, t_err = None, None
    for _ in range(4):
        j_dq, j_err = j_compress_jit(g, "int8_ef", j_err)
        t_in = _t(g)
        t_words = [int8_words([x], [e])[0][0] for x, e in zip(
            leaves(t_in), leaves(t_err) if t_err is not None
            else [torch.zeros_like(x) for x in leaves(t_in)])]
        t_dq, t_err = compress_grads(t_in, "int8_ef", t_err)
        for a, b, w, e_j, e_t in zip(
                jax.tree.leaves(j_dq), leaves(t_dq), t_words,
                jax.tree.leaves(j_err), leaves(t_err)):
            a = np.asarray(a)
            assert np.array_equal(a.view(np.int32), b.numpy().view(np.int32))
            np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
            # the words behind the dequantised values: deq = word * scale
            scale = np.abs(a).max() / np.abs(w.numpy()).max()
            np.testing.assert_array_equal(np.round(a / scale).astype(np.int8),
                                          w.numpy())
    j_bf, _ = j_compress(g, "bf16")
    t_bf, _ = compress_grads(_t(g), "bf16")
    for a, b in zip(jax.tree.leaves(j_bf), leaves(t_bf)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_compress_grads_int8_equals_the_jitted_jax_step_at_gemma3_reduced():
    """Identical fp32 gradients and carried errors at the REDUCED gemma3
    shapes, the port's leaves grouped by ``stacked_scale_groups``: the
    int8 words, scales and errors are the jitted JAX function's bit for
    bit (the words and the scale through the dequantised values, which
    JAX's function returns as word x scale)."""
    j_cfg, t_cfg = CONFIGS["gemma3_reduced"]
    params, _ = j_init_params(j_cfg, jax.random.key(2))
    rs = np.random.RandomState(7)
    for e_scale in (0.0, 1e-4):
        g = jax.tree.map(lambda p: (rs.randn(*p.shape) * 1e-2)
                         .astype(np.float32), params)
        e = jax.tree.map(lambda p: (rs.randn(*p.shape) * e_scale)
                         .astype(np.float32), params)
        j_dq, j_err = j_compress_jit(g, "int8_ef", e)
        t_g = params_from_jax(g, t_cfg, device="cpu")
        t_e = params_from_jax(e, t_cfg, device="cpu")
        groups = stacked_scale_groups(t_cfg, t_g)
        t_dq, t_err = compress_grads(t_g, "int8_ef", t_e, groups)
        want_dq = leaves(params_from_jax(jax.tree.map(np.asarray, j_dq),
                                         t_cfg, device="cpu"))
        want_err = leaves(params_from_jax(jax.tree.map(np.asarray, j_err),
                                          t_cfg, device="cpu"))
        gs, es = leaves(t_g), leaves(t_e)
        assert len(groups) < len(gs)
        for group in groups:
            words, scale, _ = int8_words([gs[i] for i in group],
                                         [es[i] for i in group])
            for i, w in zip(group, words):
                assert torch.equal(w.to(torch.float32) * scale, want_dq[i])
                assert torch.equal(leaves(t_dq)[i], want_dq[i])
                assert torch.equal(leaves(t_err)[i], want_err[i])


J_F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
T_F32 = dict(dtype=torch.float32, param_dtype=torch.float32)
CONFIGS = {
    "small_dense": (small_dense_cfg(), _cfg()),
    "gemma3_reduced": (dataclasses.replace(j_gemma.REDUCED, **J_F32),
                       dataclasses.replace(t_gemma.REDUCED, **T_F32)),
}


GRAD_ATOL = 1e-5


def _jax_state(j_cfg, j_opt, seed=0):
    params, _ = j_init_params(j_cfg, jax.random.key(seed))
    return JTrainState.create(j_opt, params)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_grads_match_jax(name):
    j_cfg, t_cfg = CONFIGS[name]
    params, _ = j_init_params(j_cfg, jax.random.key(1))
    tokens = np.asarray(j_tokens(3, batch=2, seq_len=24, vocab=j_cfg.vocab))
    (j_loss, j_parts), j_g = jax.value_and_grad(
        j_make_loss_fn(j_cfg), has_aux=True)(params, {"tokens": tokens})
    t_params = params_from_jax(jax.tree.map(np.asarray, params), t_cfg,
                               device="cpu")
    live = [p.requires_grad_(True) for p in leaves(t_params)]
    t_loss, t_parts = make_loss_fn(t_cfg)(unflatten(t_params, live),
                                          {"tokens": torch.as_tensor(tokens)})
    t_g = unflatten(t_params, list(torch.autograd.grad(t_loss, live)))
    assert float(t_loss) == pytest.approx(float(j_loss), rel=1e-5)
    for key in ("ce", "z"):
        assert float(t_parts[key]) == pytest.approx(float(j_parts[key]),
                                                    rel=1e-5)
    want = params_to_jax(params_from_jax(
        jax.tree.map(np.asarray, j_g), t_cfg, device="cpu"), t_cfg)
    got = params_to_jax(t_g, t_cfg)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, atol=GRAD_ATOL, err_msg=str(path))


# AdamW's normalised step m_hat / (sqrt(v_hat) + eps) is about +-1 for a
# coordinate whose gradient is near 0, whatever its size, and an int8
# word or a bf16 rounding flips on an ulp of difference: so a few
# coordinates whose gradients the two frameworks sum to a different last
# bit move by up to ~lr apart (measured: 1 of 40,960 in one leaf without
# compression, up to 1.2e-4 of a leaf with int8).  Every leaf keeps
# 99.9 % of its elements within 1e-5, and every parameter is within
# 3 x the summed learning rates.
STEP_ATOL, STEP_SHARE = 1e-5, 1e-3


def _inject_jax_grads(monkeypatch, t_cfg):
    """The port's step compresses the JAX step's accumulated gradients
    in place of its own.  The two frameworks sum the fp32 gradients in
    other orders, and an int8 word flips on an ulp of its input, which
    moves that coordinate's AdamW step by up to ~lr: after two steps the
    parameters, and so the third step's gradients and grad norm (2e-5
    relative), drift apart by more than the step's tolerances.  With the
    same inputs the compression is bit for bit JAX's (the test above),
    so the norm and the state are held on equal terms; the port's own
    gradients are held to JAX's within GRAD_ATOL, as in
    test_loss_and_grads_match_jax."""
    import repro.train.train_step as j_train_step
    import repro_torch.train.train_step as t_train_step
    seen = {"checked": 0}

    def j_spy(grads, mode, err):
        jax.debug.callback(lambda g: seen.__setitem__(
            "jax", jax.tree.map(np.asarray, g)), grads)
        return j_compress(grads, mode, err)

    def t_inject(grads, mode, err, groups):
        jax.effects_barrier()
        want = params_from_jax(seen.pop("jax"), t_cfg, device="cpu")
        for a, b in zip(leaves(want), leaves(grads)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=GRAD_ATOL)
        seen["checked"] += 1
        return compress_grads(want, mode, err, groups)

    monkeypatch.setattr(j_train_step, "compress_grads", j_spy)
    monkeypatch.setattr(t_train_step, "compress_grads", t_inject)
    return seen


@pytest.mark.parametrize("accum,compression", [(1, None), (2, None),
                                               (2, "int8_ef"), (1, "bf16")])
def test_train_steps_from_a_jax_state_match_jax(accum, compression,
                                                monkeypatch):
    j_cfg, t_cfg = CONFIGS["gemma3_reduced"]
    j_opt = JAdamW(lr=1e-3, warmup_steps=2, total_steps=50)
    t_opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    params, _ = j_init_params(j_cfg, jax.random.key(2))
    j_state = JTrainState.create(j_opt, params, compression=compression)
    t_state = train_state_from_jax(jax.tree.map(np.asarray, j_state), t_cfg,
                                   device="cpu")
    injected = _inject_jax_grads(monkeypatch, t_cfg) \
        if compression == "int8_ef" else None
    j_step = jax.jit(j_make_train_step(j_cfg, j_opt, accum_steps=accum,
                                       compression=compression))
    t_step = make_train_step(t_cfg, t_opt, accum_steps=accum,
                             compression=compression)
    lr_sum = 0.0
    for t in range(3):
        tokens = np.asarray(j_tokens(t, batch=4, seq_len=16,
                                     vocab=j_cfg.vocab))
        j_state, j_m = j_step(j_state, {"tokens": jnp.asarray(tokens)})
        t_state, t_m = t_step(t_state, {"tokens": torch.as_tensor(tokens)})
        assert float(t_m["loss"]) == pytest.approx(float(j_m["loss"]),
                                                   rel=1e-5)
        assert float(t_m["grad_norm"]) == pytest.approx(
            float(j_m["grad_norm"]), rel=1e-5)
        lr_sum += float(j_m["lr"])
    assert injected is None or injected["checked"] == 3
    want = train_state_to_jax(train_state_from_jax(
        jax.tree.map(np.asarray, j_state), t_cfg, device="cpu"), t_cfg)
    got = train_state_to_jax(t_state, t_cfg)
    assert int(got["step"]) == int(got["opt_state"]["step"]) == 3
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        diff = np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64))
        assert np.mean(diff > STEP_ATOL) <= STEP_SHARE, str(path)
        if jax.tree_util.keystr(path).startswith("['params']"):
            assert diff.max() <= 3 * lr_sum, str(path)


def test_remat_on_equals_off_bit_for_bit():
    _, t_cfg = CONFIGS["gemma3_reduced"]
    params = init_params(t_cfg, torch.Generator().manual_seed(4),
                         device="cpu")
    tokens = token_stream_batch(0, batch=2, seq_len=20, vocab=t_cfg.vocab,
                                device="cpu")
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(t_cfg, remat=remat)
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, _ = make_loss_fn(cfg)(unflatten(params, live),
                                    {"tokens": tokens})
        out[remat] = [loss] + list(torch.autograd.grad(loss, live))
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


def test_jax_checkpoint_directory_restores_into_the_port():
    j_cfg, t_cfg = CONFIGS["small_dense"]
    j_opt = JAdamW(lr=1e-3, warmup_steps=2, total_steps=50)
    j_state = _jax_state(j_cfg, j_opt)
    j_state, _ = jax.jit(j_make_train_step(j_cfg, j_opt))(
        j_state, {"tokens": j_tokens(0, batch=2, seq_len=16,
                                     vocab=j_cfg.vocab)})
    with tempfile.TemporaryDirectory() as d:
        JCheckpointManager(d).save(1, j_state)
        restored, step = JCheckpointManager(d).restore(j_state)
    assert step == 1
    t_state = train_state_from_jax(jax.tree.map(np.asarray, restored),
                                   t_cfg, device="cpu")
    assert int(t_state.step) == 1 and int(t_state.opt_state["step"]) == 1
    back = train_state_to_jax(t_state, t_cfg)
    rebuilt = JTrainState(**jax.tree.map(jnp.asarray, back))
    for a, b in zip(jax.tree.leaves(j_state), jax.tree.leaves(rebuilt)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_checkpoint_keeps_bf16_bits_and_records_the_dtype():
    tree = {"w": torch.randn(6, 5, generator=torch.Generator().manual_seed(0))
            .to(torch.bfloat16), "s": torch.tensor(7, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        path = cm.save(2, tree)
        import json
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
        assert np.load(os.path.join(path, "arrays.npz"))["w"].dtype \
            == np.int16
        out, _ = cm.restore({"w": torch.zeros(6, 5), "s": torch.tensor(0)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), tree["w"].view(torch.int16))
    assert torch.equal(out["s"], tree["s"])
    assert [k for k, _ in leaves_with_paths(tree)] == ["s", "w"]


def test_train_loop_preempt_and_resume_equals_an_uninterrupted_run():
    cfg = _cfg()
    kw = dict(steps=6, batch=4, seq=16, save_every=4, lr=1e-3, log_every=100,
              device="cpu")
    with tempfile.TemporaryDirectory() as d:
        live, reached = t_launch.train_loop(cfg, ckpt_dir=os.path.join(d, "a"),
                                            **kw)
        assert reached == 6
        b = os.path.join(d, "b")
        hist = []
        _, at = t_launch.train_loop(cfg, ckpt_dir=b, max_seconds=0.0,
                                    history=hist, **kw)
        assert at == 1 and len(hist) == 1
        assert CheckpointManager(b).available_steps() == [1]
        resumed, reached = t_launch.train_loop(cfg, ckpt_dir=b,
                                               history=hist, **kw)
        assert reached == 6 and [h["step"] for h in hist] == list(range(6))
        assert CheckpointManager(b).available_steps() == [1, 4, 6]
    for a, c in zip(leaves(live), leaves(resumed)):
        assert torch.equal(a, c)


def test_mesh_training_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="item 9"):
        t_launch.main(["--arch", "gemma3-1b", "--reduced", "--mesh-model",
                       "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 9"):
        t_launch.train_loop(_cfg(), steps=1, batch=2, seq=8, ckpt_dir="x",
                            mesh=object(), device="cpu")


def test_main_trains_the_reduced_config(tmp_path):
    state, reached = t_launch.main([
        "--arch", "gemma3-1b", "--reduced", "--steps", "3", "--batch", "2",
        "--seq", "16", "--ckpt", str(tmp_path), "--accum", "2",
        "--compression", "int8_ef", "--device", "cpu"])
    assert reached == 3 and int(state.step) == 3
    assert state.error_state is not None
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
