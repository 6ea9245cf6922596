"""Plain PyTorch oracles for the head kernel (counterpart of the
LRT-head part of ``repro.kernels.ref``).

Straightforward forms with no tiling: the (S, M, V) logits exist in full.
The tile-loop plain versions beside each kernel (``uncertainty_head.py``,
``paged_attention.py``) are checked against these, and these against the
JAX package's oracles.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import rng


def lrt_matmul(x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
               xi: torch.Tensor) -> torch.Tensor:
    """Local-reparameterization GEMM (Kingma et al. 2015):

        y = x @ mu + sqrt((x*x) @ (sigma*sigma)) * xi

    Same marginals as weight-space sampling with the entropy in the
    output space (xi: (..., M, N)).
    """
    x32 = x.float()
    m = x32 @ mu.float()
    v = (x32 * x32) @ (sigma.float() ** 2)
    return m + torch.sqrt(torch.clamp(v, min=0.0)) * xi.float()


def uncertainty_head(x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                     xi: torch.Tensor) -> dict[str, torch.Tensor]:
    """Bayesian head + uncertainty readout (paper Eqs. 1-2).

    x: (M, K) hidden states; mu/sigma: (K, V); xi: (S, M, V).  Returns per
    row H (total), SE (aleatoric), MI (epistemic), pred (argmax of the
    mean predictive) and p_max (its value).
    """
    logits = lrt_matmul(x, mu, sigma, xi)     # (S, M, V) f32
    logp = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(logp)
    p_mean = probs.mean(dim=0)
    h = -torch.sum(p_mean * torch.log(p_mean + 1e-12), dim=-1)
    se = (-torch.sum(probs * logp, dim=-1)).mean(dim=0)
    mi = torch.clamp(h - se, min=0.0)
    p_max, pred = p_mean.max(dim=-1)
    return {"H": h, "SE": se, "MI": mi, "pred": pred.to(torch.int32),
            "p_max": p_max}


def uncertainty_head_sampled(x: torch.Tensor, mu: torch.Tensor,
                             sigma: torch.Tensor, seed: int, step: int,
                             num_samples: int) -> dict[str, torch.Tensor]:
    """The seeded head: the variates of the Philox stream keyed by
    (seed, step), drawn in full, then ``uncertainty_head``."""
    cols = torch.arange(mu.shape[-1], dtype=torch.int64, device=x.device)
    xi = rng.head_normal(seed, step, num_samples, x.shape[0], cols)
    return uncertainty_head(x, mu, sigma, xi)
