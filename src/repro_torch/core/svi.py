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
from torch.utils.checkpoint import checkpoint

from repro_torch.core import keys as K
from repro_torch.core.bayesian import GaussianVariational
from repro_torch.sharding import collectives as C


# elements of a posterior above which its KL is summed a flat slice at a
# time (``_kl``)
KL_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class SVIConfig:
    prior_sigma: float = 1.0
    kl_warmup_steps: int = 500        # beta: 0 -> 1 linearly
    num_train_examples: int = 60_000  # ELBO 1/N scaling
    train_mc_samples: int = 1         # MC draws per training step


def variational_items(tree: Any, path: str = "") -> list:
    """(path, posterior) of every variational posterior in ``tree``, as
    ``GaussianVariational`` views (no copies); the path is the node's
    (``head`` for the LM head's ``{"mu", "rho"}``)."""
    if isinstance(tree, GaussianVariational):
        return [(path, tree)]
    if isinstance(tree, dict):
        if set(tree) == {"mu", "rho"}:
            return [(path, GaussianVariational(mu=tree["mu"],
                                               rho=tree["rho"]))]
        return [q for k in sorted(tree) for q in variational_items(
            tree[k], f"{path}/{k}" if path else k)]
    return []


def variational_leaves(tree: Any) -> list[GaussianVariational]:
    """Every variational posterior in ``tree``, as ``GaussianVariational``
    views (no copies)."""
    return [q for _, q in variational_items(tree)]


def kl_divergence(params: Any, prior_sigma: float = 1.0) -> torch.Tensor:
    """Sum of KL(q || p) over every variational leaf of ``params``."""
    qs = variational_leaves(params)
    if not qs:
        return torch.zeros(())
    return sum(q.kl_to_prior(prior_sigma) for q in qs)


def _kl(q: GaussianVariational, prior_sigma: float) -> torch.Tensor:
    """KL(q || p) of one posterior: ``kl_to_prior`` whole where it holds
    at most ``KL_SLICE`` elements; above, the sum over flat slices of
    ``KL_SLICE``, each recomputed in the backward pass, so that the
    elementwise temporaries of a full-width head's (d, V) f32 leaves
    (several live at once, some kept for the backward) never exist
    whole.  Only the order of the f32 sum changes."""
    n = q.mu.numel()
    if n <= KL_SLICE or not (q.mu.is_contiguous() and q.rho.is_contiguous()):
        return q.kl_to_prior(prior_sigma)

    def part(mu, rho):
        return GaussianVariational(mu=mu, rho=rho).kl_to_prior(prior_sigma)

    mu, rho = q.mu.reshape(-1), q.rho.reshape(-1)
    return sum(checkpoint(part, mu[i:i + KL_SLICE], rho[i:i + KL_SLICE],
                          use_reentrant=False)
               for i in range(0, n, KL_SLICE))


def kl_beta(step: int, cfg: SVIConfig) -> torch.Tensor:
    """Linear KL warm-up, beta in [0, 1] (a float32 0-d tensor)."""
    s = torch.tensor(step, dtype=torch.float32)
    return torch.clamp(s / max(cfg.kl_warmup_steps, 1), 0.0, 1.0)


def elbo_loss(nll_fn: Callable, params: Any, batch: Any, key: K.Key,
              step: int, cfg: SVIConfig, mesh=None,
              kl_scope=None) -> tuple[torch.Tensor, dict]:
    """Negative per-example ELBO = NLL + beta * KL / N_train.

    ``nll_fn`` returns the mean per-example negative log likelihood; it
    is averaged over ``train_mc_samples`` draws, each on its own key
    (``keys.split``).

    Under a train ``mesh`` the parameters are the rank's shards and
    ``nll_fn`` gives this data rank's share of the global mean: the value
    returned is then the rank's share of the ELBO (its gradient, summed
    over the ranks, is the ELBO's), with the KL of the rank's own blocks
    of the head.  ``kl_scope`` = (in the loss, in the metric), each a
    predicate on a posterior's path, names the posteriors whose KL this
    rank adds (default all): one replicated on some ranks counts in the
    loss on one rank of each group whose gradients are summed, and in
    the metric on one rank of each group that holds it
    (``steps.build_train_step``).  The metrics sum the shares: ``nll``
    over ``data``, ``kl`` over every rank, and ``loss`` is the global
    ELBO."""
    outs = [nll_fn(params, batch, k)
            for k in K.split(key, cfg.train_mc_samples)]
    nll = torch.stack([o[0] for o in outs]).mean()
    in_loss, in_metric = kl_scope or (None, None)
    # a rank computes only the KL terms it adds to its loss or metric
    kls = [(p, _kl(q, cfg.prior_sigma)) for p, q in variational_items(params)
           if kl_scope is None or in_loss(p) or in_metric(p)]

    def total(keep):
        return sum((v for p, v in kls if keep is None or keep(p)),
                   torch.zeros((), device=nll.device))

    kl = total(in_loss)
    kl_metric = kl if kl_scope is None else total(in_metric)
    beta = kl_beta(step, cfg).to(nll.device)
    loss = nll + beta * kl / cfg.num_train_examples
    aux = {name: torch.stack([o[1][name] for o in outs]).float().mean(0)
           for name in outs[0][1]}
    aux.update({"nll": nll, "kl": kl, "beta": beta})
    if mesh is not None:
        nll_g = C.all_reduce(nll.detach(), mesh.data)
        kl_g = C.all_reduce(kl_metric.detach(), mesh.world)
        aux.update({"nll": nll_g, "kl": kl_g,
                    "loss": nll_g + beta * kl_g / cfg.num_train_examples})
    return loss, aux
