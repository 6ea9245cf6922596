"""Stochastic Variational Inference (Hoffman et al. 2013; paper §BNN).

Counterpart of ``repro.core.svi``.  The ELBO of a partially stochastic
network with variational block q(theta_s) and deterministic weights
theta_d,

    L = E_q[ log p(y | x, theta_s, theta_d) ] - beta * KL( q || p ),

with the KL in closed form for a Gaussian q against a Gaussian prior,
the expectation estimated from ``train_mc_samples`` reparameterized
draws, and ``beta`` annealed linearly (KL warm-up) and scaled by
1 / num_train_examples (the per-example ELBO).

Models expose ``nll_fn(params, batch, key) -> (nll, aux)`` with ``key`` a
``core.keys`` key.  The variational leaves of a parameter tree are every
``GaussianVariational`` (the BNN's probabilistic block) and every
``{"mu", "rho"}`` dict (the LM head's training form); ``elbo_loss`` adds
the KL of each.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import keys as K
from repro_torch.core.bayesian import GaussianVariational
from repro_torch.sharding import collectives as C


@dataclasses.dataclass(frozen=True)
class SVIConfig:
    prior_sigma: float = 1.0
    kl_warmup_steps: int = 500        # beta: 0 -> 1 linearly
    num_train_examples: int = 60_000  # ELBO 1/N scaling
    train_mc_samples: int = 1         # MC draws per training step


def variational_leaves(tree: Any) -> list[GaussianVariational]:
    """Every variational posterior in ``tree``, as ``GaussianVariational``
    views (no copies)."""
    if isinstance(tree, GaussianVariational):
        return [tree]
    if isinstance(tree, dict):
        if set(tree) == {"mu", "rho"}:
            return [GaussianVariational(mu=tree["mu"], rho=tree["rho"])]
        return [q for k in sorted(tree) for q in variational_leaves(tree[k])]
    return []


def kl_divergence(params: Any, prior_sigma: float = 1.0) -> torch.Tensor:
    """Sum of KL(q || p) over every variational leaf of ``params``."""
    qs = variational_leaves(params)
    if not qs:
        return torch.zeros(())
    return sum(q.kl_to_prior(prior_sigma) for q in qs)


def kl_beta(step: int, cfg: SVIConfig) -> torch.Tensor:
    """Linear KL warm-up, beta in [0, 1] (a float32 0-d tensor)."""
    s = torch.tensor(step, dtype=torch.float32)
    return torch.clamp(s / max(cfg.kl_warmup_steps, 1), 0.0, 1.0)


def elbo_loss(nll_fn: Callable, params: Any, batch: Any, key: K.Key,
              step: int, cfg: SVIConfig,
              mesh=None) -> tuple[torch.Tensor, dict]:
    """Negative per-example ELBO = NLL + beta * KL / N_train.

    ``nll_fn`` returns the mean per-example negative log likelihood; it
    is averaged over ``train_mc_samples`` draws, each on its own key
    (``keys.split``).

    Under a train ``mesh`` the parameters are the rank's shards and
    ``nll_fn`` gives this data rank's share of the global mean: the value
    returned is then the rank's share of the ELBO (its gradient, summed
    over the ranks, is the ELBO's), with the KL of the rank's own blocks
    of the head (which shards on every mesh axis).  The metrics sum the
    shares: ``nll`` over ``data``, ``kl`` over every rank, and ``loss``
    is the global ELBO."""
    outs = [nll_fn(params, batch, k)
            for k in K.split(key, cfg.train_mc_samples)]
    nll = torch.stack([o[0] for o in outs]).mean()
    kl = kl_divergence(params, cfg.prior_sigma).to(nll.device)
    beta = kl_beta(step, cfg).to(nll.device)
    loss = nll + beta * kl / cfg.num_train_examples
    aux = {name: torch.stack([o[1][name] for o in outs]).float().mean(0)
           for name in outs[0][1]}
    aux.update({"nll": nll, "kl": kl, "beta": beta})
    if mesh is not None:
        nll_g = C.all_reduce(nll.detach(), mesh.data)
        kl_g = C.all_reduce(kl.detach(), mesh.world)
        aux.update({"nll": nll_g, "kl": kl_g,
                    "loss": nll_g + beta * kl_g / cfg.num_train_examples})
    return loss, aux
