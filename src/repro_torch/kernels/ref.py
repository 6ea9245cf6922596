"""Plain PyTorch oracles of the port's kernels (counterpart of
``repro.kernels.ref``).

Straightforward forms with no tiling: the (S, M, V) logits, the sampled
weights and the per-symbol variates exist in full.  The tile-loop plain
versions beside each kernel (``uncertainty_head.py``,
``paged_attention.py``, ``photonic_conv.py``, ``bayes_matmul.py``) are
checked against these, and these against the JAX package's oracles.  The
seeded oracles draw the whole Philox stream of ``rng.py`` at once.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import rng


def quantize(x: torch.Tensor, bits: int, x_max: float) -> torch.Tensor:
    """Forward-only uniform symmetric quantizer: round half to even of
    ``x / scale``, clipped to +-(2^(bits-1) - 1) levels.  It divides by the
    float32 scale as the JAX package does; multiplying by the reciprocal
    (which PyTorch's CUDA division does for a Python scalar) rounds
    differently, since 1/scale is not exact.  The scale is filled on x's
    device: ``torch.tensor`` would copy it from the host and synchronize
    the stream on every call."""
    levels = 2 ** (bits - 1) - 1
    scale = torch.full((), x_max / levels, dtype=torch.float32,
                       device=x.device)
    return torch.clamp(torch.round(x / scale), -levels, levels) * scale


def bayes_matmul(x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                 eps: torch.Tensor) -> torch.Tensor:
    """Weight-space sampled GEMM y = x @ (mu + sigma * eps), f32.

    x: (M, K), mu/sigma/eps: (K, N), or eps (S, K, N) for S draws.
    """
    w = mu.float() + sigma.float() * eps.float()
    return x.float() @ w


def photonic_conv(x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                  eps: torch.Tensor, dac_bits: int = 8, adc_bits: int = 8,
                  in_range: float = 1.0,
                  out_range: float = 4.0) -> torch.Tensor:
    """The machine's primitive: 9-tap probabilistic convolution.

    x: (B, T); mu/sigma: (C,); eps: (B, To, C) with To = T - C + 1.
    y[b, t] = sum_k xq[b, t+k] * w[b, t, C-1-k],  w = mu + sigma*eps,
    then ADC quantization.
    """
    C = mu.shape[-1]
    To = x.shape[-1] - C + 1
    xq = quantize(x.float(), dac_bits, in_range)
    idx = (torch.arange(To, device=x.device)[:, None]
           + torch.arange(C, device=x.device)[None, :])
    taps = xq[..., idx]                       # (B, To, C)
    w = mu.float() + sigma.float() * eps.float()
    y = torch.sum(taps * w.flip(-1), dim=-1)
    return quantize(y, adc_bits, out_range)


def bayes_matmul_sampled(x: torch.Tensor, mu: torch.Tensor,
                         sigma: torch.Tensor, seed: int,
                         num_samples: int) -> torch.Tensor:
    """S seeded weight-space MC samples (S, M, N) of the TAG_BAYES stream:
    one sampled W_s shared by every row."""
    K, N = mu.shape
    dev = x.device
    eps = rng.bayes_normal(seed, num_samples,
                           torch.arange(K, dtype=torch.int64, device=dev),
                           torch.arange(N, dtype=torch.int64, device=dev))
    return bayes_matmul(x, mu, sigma, eps)


def photonic_conv_sampled(x: torch.Tensor, mu: torch.Tensor,
                          sigma: torch.Tensor, seed: int,
                          dac_bits: int = 8, adc_bits: int = 8,
                          in_range: float = 1.0,
                          out_range: float = 4.0) -> torch.Tensor:
    """Seeded 9-tap probabilistic conv: fresh per-symbol draws of the
    TAG_CONV stream."""
    B, T = x.shape
    C = mu.shape[-1]
    dev = x.device
    eps = rng.conv_normal(seed, torch.arange(B, dtype=torch.int64,
                                             device=dev),
                          torch.arange(T - C + 1, dtype=torch.int64,
                                       device=dev), C)
    return photonic_conv(x, mu, sigma, eps, dac_bits=dac_bits,
                         adc_bits=adc_bits, in_range=in_range,
                         out_range=out_range)


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
