"""Multilayer-perceptron genomic prediction, torch port of
genomicbreedingmodels_tpu/models/mlp.py (the reference's intended-but-disabled
DL extension, src/dl.jl:82-211).

The network is an `nn.Module`: Linear + ReLU (+ dropout) hidden layers and a
Linear output of width 1, trained full-batch on standardized allele
frequencies with MSE loss and `torch.optim.AdamW(lr, weight_decay=wd,
eps=1e-8)`, whose decoupled decay is optax.adamw's: in both,
p ← p − lr·(adam + wd·p). He initialisation and dropout draw from one
`torch.Generator` seeded from `seed`, so a fit is a function of its seed.

`fit.extras["params"]` keeps the JAX package's layout, a list of numpy
(W (din, dout), b) pairs (`nn.Linear.weight` is its transpose), so a Fit from
either package predicts through either `predict`; `convert.mlp_from_params`
builds the module from that list.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.structs import Fit, Genomes, Phenomes
from ..device import as_tensor, resolve_device
from ..ops.metrics import metrics
from ..prediction import extractxyetc

__all__ = ["MLP", "mlp", "mlp_apply", "mlp_params", "mlp_predict_from_fit"]


class MLP(nn.Module):
    """sizes = [p, h_1, ..., h_k, 1]: ReLU after every hidden layer, then
    dropout at `dropout_rate` while training, drawn from `generator`."""

    def __init__(self, sizes: Sequence[int], dropout_rate: float = 0.0) -> None:
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(din, dout) for din, dout in zip(sizes[:-1], sizes[1:]))
        self.dropout_rate = float(dropout_rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = layer(h)
            if i < last:
                h = torch.relu(h)
                if self.training and self.dropout_rate > 0.0:
                    keep = torch.rand(h.shape, device=h.device, generator=self.generator)
                    keep = keep < 1.0 - self.dropout_rate
                    h = torch.where(keep, h / (1.0 - self.dropout_rate), torch.zeros_like(h))
        return h[:, 0]


def _init_he(net: MLP, gen: torch.Generator) -> None:
    """He initialisation for ReLU stacks: W ~ N(0, 2/din), b = 0."""
    with torch.no_grad():
        for layer in net.layers:
            din = layer.in_features
            w = torch.randn((din, layer.out_features), generator=gen, device=layer.weight.device)
            layer.weight.copy_(((2.0 / din) ** 0.5 * w).T)
            layer.bias.zero_()


def mlp_params(net: MLP) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The network's weights in the JAX layout: [(W (din, dout), b), ...]."""
    return [(layer.weight.detach().T.cpu().numpy().copy(), layer.bias.detach().cpu().numpy().copy())
            for layer in net.layers]


def mlp_apply(net: MLP, X: torch.Tensor) -> torch.Tensor:
    """Inference pass (no dropout)."""
    net.eval()
    with torch.no_grad():
        return net(X)


def _train(net: MLP, Xs: torch.Tensor, ys: torch.Tensor, gen: torch.Generator, n_epochs: int,
           learning_rate: float, weight_decay: float) -> torch.Tensor:
    """Full-batch AdamW for `n_epochs` epochs; returns each epoch's training
    loss (taken before that epoch's update), on the device."""
    opt = torch.optim.AdamW(net.parameters(), lr=learning_rate, weight_decay=weight_decay, eps=1e-8)
    net.train()
    net.generator = gen
    losses = torch.empty(n_epochs, dtype=torch.float32, device=Xs.device)
    for epoch in range(n_epochs):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((net(Xs) - ys) ** 2)
        loss.backward()
        opt.step()
        losses[epoch] = loss.detach()
    net.generator = None
    net.eval()
    return losses


def mlp(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    idx_trait: int = 0,
    n_hidden_layers: int = 3,
    hidden_dims: Optional[Sequence[int]] = None,
    dropout_rate: float = 0.25,
    n_epochs: int = 1_000,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-4,
    seed: int = 42,
    verbose: bool = False,
    device="cuda",
) -> Fit:
    """Fit an MLP on standardized allele frequencies with MSE loss + AdamW.

    Defaults are the JAX package's (lr 1e-3, 1000 epochs; the reference's
    commented spec had Adam 1e-4).
    """
    dev = resolve_device(device)
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    n, p = X.shape
    x_mean = X.mean(axis=0)
    x_std = X.std(axis=0)
    x_std[x_std < 1e-12] = 1.0
    y_mean = float(y.mean())
    y_std = float(y.std())
    y_std = y_std if y_std > 1e-12 else 1.0

    if hidden_dims is None:
        width = int(min(256, max(64, 2 * n)))
        hidden_dims = [max(16, width // (2**i)) for i in range(int(n_hidden_layers))]
    sizes = [p, *[int(h) for h in hidden_dims], 1]

    Xs = as_tensor((X - x_mean) / x_std, dev, torch.float32)
    ys = as_tensor((y - y_mean) / y_std, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    net = MLP(sizes, dropout_rate).to(dev)
    _init_he(net, gen)
    losses = _train(net, Xs, ys, gen, int(n_epochs), float(learning_rate), float(weight_decay))
    final_loss = float(losses[-1])
    if verbose:
        print(f"mlp: final training MSE {final_loss:.6f}")

    y_pred = mlp_apply(net, Xs).double().cpu().numpy() * y_std + y_mean

    fit = Fit(
        model="mlp",
        b_hat=np.zeros(p + 1),
        b_hat_labels=np.concatenate([np.asarray(["intercept"], dtype=object), loci_alleles]),
        trait=str(phenomes.traits[idx_trait]),
        entries=entries,
        populations=populations,
        y_true=y,
        y_pred=y_pred,
        metrics=metrics(y, y_pred),
        extras={
            "params": mlp_params(net),
            "x_mean": x_mean,
            "x_std": x_std,
            "y_mean": y_mean,
            "y_std": y_std,
            "hidden_dims": [int(h) for h in hidden_dims],
            "dropout_rate": float(dropout_rate),
            "final_loss": final_loss,
        },
    )
    if not fit.checkdims():
        raise RuntimeError("error fitting mlp")
    return fit


def mlp_predict_from_fit(fit: Fit, G: np.ndarray, device="cuda") -> np.ndarray:
    """Re-materialize the network from fit.extras and predict rows of G
    (columns already resolved to the fit's loci by the caller)."""
    from ..convert import mlp_from_params

    ex = fit.extras
    missing = [k for k in ("params", "x_mean", "x_std", "y_mean", "y_std") if k not in ex]
    if missing:
        raise ValueError(f"the {fit.model!r} Fit carries no network: fit.extras lacks {missing}")
    Xs = (np.asarray(G, dtype=np.float64) - ex["x_mean"]) / ex["x_std"]
    net = mlp_from_params(ex["params"], device=device)
    out = mlp_apply(net, as_tensor(Xs, device, torch.float32))
    return out.double().cpu().numpy() * ex["y_std"] + ex["y_mean"]
