"""The port's synthetic data (``repro_torch.data.synthetic``) and the
two-tower loss (``LearnedSimilarity.loss``) against the JAX package on
the CPU.

``token_stream_batch`` and every integer field are bit-equal; the point
generators' normal draws agree to a few ulp (``prng.normal`` is not
bitwise), so their features are held within 1e-5 (values of order 1).
The loss and its gradients within 1e-6 and one step of
``examples/train_embedder.py``'s SGD within 1e-6 (fp32, IEEE products
on both sides, other summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (repro.data imports the core first)
from repro.data import synthetic as j_syn
from repro.similarity.learned import LearnedSimilarity as JLearned
from repro.similarity.learned import TwoTowerConfig as JTwoTower
from repro_torch.data import synthetic as t_syn
from repro_torch.similarity.learned import LearnedSimilarity, TwoTowerConfig
from repro_torch.similarity.measures import PointFeatures

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (0, 0, 4, 32, 256), (0, 7, 2, 65, 1000), (3, 1, 8, 16, 262144),
    (11, 12345, 3, 40, 32000), (2**31, 2, 1, 9, 7)])
def test_token_stream_batch_bit_equal(seed, step, batch, seq, vocab):
    want = np.asarray(j_syn.token_stream_batch(
        step, batch=batch, seq_len=seq, vocab=vocab, seed=seed))
    got = t_syn.token_stream_batch(step, batch=batch, seq_len=seq,
                                   vocab=vocab, seed=seed, device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 5])
def test_gaussian_mixture_points(seed):
    want, want_mode = j_syn.gaussian_mixture_points(700, d=20, modes=30,
                                                    std=0.1, seed=seed)
    got, mode = t_syn.gaussian_mixture_points(700, d=20, modes=30, std=0.1,
                                              seed=seed, device="cpu")
    np.testing.assert_array_equal(mode.numpy(), want_mode)
    np.testing.assert_allclose(got.dense.numpy(), np.asarray(want.dense),
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 9])
def test_mnist_like_points(seed):
    want, want_label = j_syn.mnist_like_points(600, d=24, classes=7,
                                               spread=0.2, seed=seed)
    got, label = t_syn.mnist_like_points(600, d=24, classes=7, spread=0.2,
                                         seed=seed, device="cpu")
    np.testing.assert_array_equal(label.numpy(), want_label)
    np.testing.assert_allclose(got.dense.numpy(), np.asarray(want.dense),
                               atol=1e-5)


SMALL = dict(in_dim=32, tower_hidden=24, embed_dim=8, head_hidden=16)


def _pairs(n_points=400, n_pairs=96, seed=3):
    feats, labels = j_syn.products_like_points(n=n_points, d=32, classes=6,
                                               nnz=8, dup_frac=0.2,
                                               seed=seed)
    rs = np.random.RandomState(seed)
    i = rs.randint(0, n_points, n_pairs)
    j = rs.randint(0, n_points, n_pairs)
    y = (labels[i] == labels[j]).astype(np.float32)
    t_feats = PointFeatures(**{
        f: None if getattr(feats, f) is None
        else torch.as_tensor(np.array(getattr(feats, f)))
        for f in ("dense", "set_idx", "set_w", "set_mask")})
    return feats, t_feats, i, j, y


@pytest.mark.parametrize("kw", [{}, {"pair_features": "embed"},
                                {"use_set_features": False}])
def test_learned_loss_and_grads_match_jax(kw):
    feats, t_feats, i, j, y = _pairs()
    model = JLearned(JTwoTower(**SMALL, **kw))
    params = model.init(jax.random.key(1))
    loss, grads = jax.value_and_grad(lambda p: model.loss(
        p, feats.take(jnp.asarray(i)), feats.take(jnp.asarray(j)),
        jnp.asarray(y)))(params)
    t_model = LearnedSimilarity(TwoTowerConfig(**SMALL, **kw))
    t_params = {k: torch.tensor(np.asarray(v), requires_grad=True)
                for k, v in params.items()}
    t_loss = t_model.loss(t_params, t_feats.take(torch.as_tensor(i)),
                          t_feats.take(torch.as_tensor(j)),
                          torch.as_tensor(y))
    t_grads = torch.autograd.grad(t_loss, list(t_params.values()))
    assert abs(t_loss.item() - float(loss)) <= 1e-6
    for name, g in zip(t_params, t_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(grads[name]),
                                   atol=1e-6, err_msg=name)


def test_one_sgd_step_of_the_example_matches_jax():
    """examples/train_embedder.py's step: p - 0.05 * grad of the loss on
    a batch of aligned pairs."""
    feats, t_feats, i, j, y = _pairs(n_pairs=256, seed=4)
    model = JLearned(JTwoTower(**SMALL))
    params = model.init(jax.random.key(2))

    @jax.jit
    def step(params, i, j, y):
        def loss(p):
            return model.loss(p, feats.take(i), feats.take(j), y)
        l, g = jax.value_and_grad(loss)(params)
        return jax.tree.map(lambda p_, g_: p_ - 0.05 * g_, params, g), l

    want, want_loss = step(params, jnp.asarray(i), jnp.asarray(j),
                           jnp.asarray(y))
    t_model = LearnedSimilarity(TwoTowerConfig(**SMALL))
    live = {k: torch.tensor(np.asarray(v), requires_grad=True)
            for k, v in params.items()}
    loss = t_model.loss(live, t_feats.take(torch.as_tensor(i)),
                        t_feats.take(torch.as_tensor(j)), torch.as_tensor(y))
    grads = torch.autograd.grad(loss, list(live.values()))
    got = {k: p.detach() - 0.05 * g for (k, p), g in zip(live.items(), grads)}
    assert abs(loss.item() - float(want_loss)) <= 1e-6
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(want[name]),
                                   atol=1e-6, err_msg=name)
