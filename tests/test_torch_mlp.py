"""The port's MLP (models/mlp.py) held against the JAX package's: training
from the JAX initial parameters, a JAX-fitted MLP predicting through the
port, the JAX parameter layout of `fit.extras`, and the public API."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu_torch import convert

# (the models packages export the function `mlp` under the module's name)
mlp_jax = importlib.import_module("genomicbreedingmodels_tpu.models.mlp")
mlp_t = importlib.import_module("genomicbreedingmodels_tpu_torch.models.mlp")

torch.set_num_threads(2)
CPU = "cpu"


def _standardised(sim_small, rows=80):
    genomes, phenomes, _ = sim_small
    X = genomes.allele_frequencies[:rows]
    y = phenomes.phenotypes[:rows, 0]
    sd = X.std(0)
    sd[sd < 1e-12] = 1.0
    return ((X - X.mean(0)) / sd).astype(np.float32), ((y - y.mean()) / y.std()).astype(np.float32)


def test_training_from_jax_initial_params_matches(sim_small):
    """The JAX initial parameters carried across, dropout 0, 50 full-batch
    AdamW epochs in both packages (optax.adamw against torch.optim.AdamW,
    eps 1e-8, decoupled decay): every final parameter array within 1e-4
    relative norm, the loss traces within rtol 1e-4."""
    Xs, ys = _standardised(sim_small)
    sizes = [Xs.shape[1], 32, 16, 1]
    p0 = mlp_jax._init_params(jax.random.PRNGKey(3), sizes)
    pj, lj = mlp_jax._train(p0, jnp.asarray(Xs), jnp.asarray(ys), 3, n_epochs=50, dropout_rate=0.0,
                            learning_rate=1e-3, weight_decay=1e-4)
    net = convert.mlp_from_params([(np.asarray(W), np.asarray(b)) for W, b in p0], device=CPU)
    lt = mlp_t._train(net, torch.from_numpy(Xs), torch.from_numpy(ys), torch.Generator().manual_seed(3),
                      50, 1e-3, 1e-4)
    for (Wt, bt), (Wj, bj) in zip(mlp_t.mlp_params(net), pj):
        Wj, bj = np.asarray(Wj), np.asarray(bj)
        assert Wt.shape == Wj.shape and bt.shape == bj.shape
        assert np.linalg.norm(Wt - Wj) <= 1e-4 * np.linalg.norm(Wj)
        assert np.linalg.norm(bt - bj) <= 1e-4 * max(np.linalg.norm(bj), 1e-3)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4)


def test_jax_fitted_mlp_predicts_through_port(sim_small):
    """A JAX `mlp` Fit (default widths) carried across by
    convert.fit_from_reference: the port's forward pass within 1e-5·std(y)
    of the JAX predict. The port's default widths and parameter shapes are
    the JAX package's: min(256, max(64, 2n)) halved per layer, floor 16."""
    genomes, phenomes, _ = sim_small
    g, p = convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)
    fj = gj.mlp(genomes, phenomes, idx_entries=np.arange(80), n_epochs=40)
    test = np.arange(80, 100)
    pj = gj.predict(fj, genomes, test)
    pt = gt.predict(convert.fit_from_reference(fj), g, test, device=CPU)
    assert np.abs(pt - pj).max() <= 1e-5 * phenomes.phenotypes[:, 0].std()
    ft = gt.mlp(g, p, idx_entries=np.arange(80), n_epochs=2, device=CPU)
    assert ft.extras["hidden_dims"] == fj.extras["hidden_dims"] == [160, 80, 40]
    assert [W.shape for W, _ in ft.extras["params"]] == [np.asarray(W).shape for W, _ in fj.extras["params"]]


def test_params_layout_round_trips():
    """fit.extras["params"] is the JAX layout [(W (din, dout), b)];
    convert.mlp_from_params reads it back into the same network."""
    net = mlp_t.MLP([7, 5, 1])
    mlp_t._init_he(net, torch.Generator().manual_seed(0))
    params = mlp_t.mlp_params(net)
    assert [W.shape for W, _ in params] == [(7, 5), (5, 1)] and params[0][1].shape == (5,)
    back = convert.mlp_from_params(params, device=CPU)
    x = torch.randn(4, 7, generator=torch.Generator().manual_seed(1))
    assert torch.equal(mlp_t.mlp_apply(back, x), mlp_t.mlp_apply(net, x))
    ref = np.maximum(x.numpy() @ params[0][0] + params[0][1], 0.0) @ params[1][0] + params[1][1]
    np.testing.assert_allclose(mlp_t.mlp_apply(net, x).numpy(), ref[:, 0], rtol=1e-5, atol=1e-6)


def test_he_init_scale():
    """He initialisation: W ~ N(0, 2/din), zero biases (the JAX law)."""
    net = mlp_t.MLP([400, 300, 1])
    mlp_t._init_he(net, torch.Generator().manual_seed(0))
    W = net.layers[0].weight.detach().numpy()
    assert W.std() == pytest.approx(np.sqrt(2.0 / 400), rel=0.02) and not net.layers[0].bias.any()


def test_mlp_fit_predict_and_seed(sim_small):
    """The public API: an in-sample fit that learns, held-out predict through
    `predict`, identical fits for one seed with dropout on, others for
    another seed."""
    genomes, phenomes, _ = sim_small
    g, p = convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)
    kw = dict(idx_entries=np.arange(80), n_epochs=150, hidden_dims=[32, 16], dropout_rate=0.2, device=CPU)
    f1 = gt.mlp(g, p, seed=7, **kw)
    f2 = gt.mlp(g, p, seed=7, **kw)
    f3 = gt.mlp(g, p, seed=8, **kw)
    assert f1.model == "mlp" and f1.checkdims() and np.isfinite(f1.extras["final_loss"])
    assert f1.metrics["cor"] > 0.5
    assert np.array_equal(f1.y_pred, f2.y_pred) and not np.array_equal(f1.y_pred, f3.y_pred)
    pred = gt.predict(f1, g, np.arange(80, 100), device=CPU)
    assert pred.shape == (20,) and np.all(np.isfinite(pred))
    assert f1.extras["hidden_dims"] == [32, 16] and f1.extras["dropout_rate"] == 0.2

