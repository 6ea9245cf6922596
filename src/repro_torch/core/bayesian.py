"""Variational (Bayesian) parameters and layers.

Counterpart of ``repro.core.bayesian``.  The paper's BNN keeps a single
probabilistic layer whose weights carry Gaussian variational posteriors
q(w) = N(mu, sigma^2), sigma = softplus(rho) (Blundell et al. 2015).  A
sampled forward pass is reparameterized, w = mu + sigma * eps, with eps
from an ``EntropySource`` (``core.entropy``), so the same code runs the
surrogate (training) and the machine (prediction).  The seed-driven
``bayes_dense_sampled`` runs all S samples in one call of the fused
sampled-weight GEMM (``kernels.ops.bayes_matmul_sampled``), whose
variates are drawn in the kernel on the GPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.entropy import (EntropySource, KernelEntropy,
                                      PRNGEntropy)
from repro_torch.core.photonic import quantize_ste
from repro_torch.kernels import ops


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as logaddexp(x, 0), like the JAX package (no linear
    threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y):
    y = torch.as_tensor(y, dtype=torch.float32)
    return torch.log(torch.expm1(torch.clamp(y, min=1e-8)))


@dataclasses.dataclass(frozen=True)
class GaussianVariational:
    """q(w) = N(mu, softplus(rho)^2) over a weight tensor."""
    mu: torch.Tensor
    rho: torch.Tensor

    @property
    def sigma(self) -> torch.Tensor:
        return softplus(self.rho)

    @staticmethod
    def init(generator: torch.Generator, shape: tuple[int, ...],
             fan_in: int, init_sigma: float = 0.05,
             dtype=torch.float32) -> "GaussianVariational":
        mu = torch.randn(shape, generator=generator, dtype=dtype,
                         device=generator.device) / math.sqrt(float(fan_in))
        rho = torch.full(shape, float(inv_softplus(init_sigma)), dtype=dtype,
                         device=generator.device)
        return GaussianVariational(mu=mu, rho=rho)

    def sample(self, generator: torch.Generator,
               source: EntropySource | None = None,
               num: int | None = None) -> torch.Tensor:
        src = source or PRNGEntropy()
        shape = tuple(self.mu.shape) if num is None \
            else (num, *self.mu.shape)
        return self.mu + self.sigma * src.sample(generator, shape,
                                                 self.mu.dtype)

    def sample_with_eps(self, eps: torch.Tensor) -> torch.Tensor:
        """Reparameterized sample from an externally supplied entropy
        tensor (the kernel path: entropy is an operand)."""
        return self.mu + self.sigma * eps

    def kl_to_prior(self, prior_sigma: float = 1.0) -> torch.Tensor:
        """KL( N(mu, sigma) || N(0, prior_sigma) ), summed over weights."""
        s2 = self.sigma ** 2
        p2 = prior_sigma ** 2
        kl = 0.5 * (s2 / p2 + self.mu ** 2 / p2 - 1.0 - torch.log(s2 / p2))
        return kl.sum()


# --------------------------------------------------------------------------
# layer applications (pure functions over a GaussianVariational + inputs)
# --------------------------------------------------------------------------

def _draw(q, generator, source, hardware_bits, w_range):
    w = q.sample(generator, source)
    if hardware_bits is not None:
        w = quantize_ste(w, hardware_bits, w_range)
    return w


def bayes_dense(x: torch.Tensor, q: GaussianVariational,
                generator: torch.Generator,
                source: EntropySource | None = None,
                hardware_bits: int | None = None,
                w_range: float = 1.0) -> torch.Tensor:
    """y = x @ w, w ~ q: one weight draw per call (per MC sample).
    ``hardware_bits`` passes the draw through the machine's STE quantizer
    (the surrogate's limited-accuracy forward)."""
    return x @ _draw(q, generator, source, hardware_bits, w_range)


def same_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """NCHW / OIHW convolution with XLA's ``SAME`` padding (the low side
    gets the smaller half of an odd total)."""
    pads = []
    for size, k in zip(reversed(x.shape[2:]), reversed(w.shape[2:])):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=stride, groups=groups)


def bayes_conv2d(x: torch.Tensor, q: GaussianVariational,
                 generator: torch.Generator,
                 source: EntropySource | None = None, stride: int = 1,
                 groups: int = 1, hardware_bits: int | None = None,
                 w_range: float = 1.0) -> torch.Tensor:
    """NCHW conv with sampled weights of shape (O, I/g, kh, kw): the layer
    the machine executes (a 3x3 kernel's 9 weights are its 9 channels)."""
    w = _draw(q, generator, source, hardware_bits, w_range)
    return same_conv2d(x, w, stride=stride, groups=groups)


def split_generators(generator: torch.Generator, n: int,
                     device=None) -> list[torch.Generator]:
    """``n`` generators on ``device`` (default: the generator's), seeded
    from ``generator`` — the counterpart of ``jax.random.split``."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=device or generator.device).manual_seed(s)
            for s in seeds]


def mc_forward(apply_fn: Callable[[torch.Generator], torch.Tensor],
               generator: torch.Generator, num_samples: int) -> torch.Tensor:
    """``apply_fn(generator_i)`` for N MC samples, each with its own
    generator split from ``generator``; stacked on axis 0 (paper N = 10)."""
    return torch.stack([apply_fn(g) for g in
                        split_generators(generator, num_samples)])


# --------------------------------------------------------------------------
# seed-driven path (in-kernel entropy on the GPU)
# --------------------------------------------------------------------------

def bayes_dense_sampled(x: torch.Tensor, q: GaussianVariational,
                        entropy: KernelEntropy,
                        num_samples: int) -> torch.Tensor:
    """All S MC samples of y = x @ w, w ~ q, in one fused call: (S, M, N).
    On the GPU the weight noise is drawn inside the kernel from
    ``entropy.fold()`` and mu/sigma are read once for all S samples."""
    return ops.bayes_matmul_sampled(x, q.mu, q.sigma, entropy.fold(),
                                    num_samples=num_samples)


def mc_forward_seeded(apply_fn: Callable[[torch.Generator], torch.Tensor],
                      entropy: KernelEntropy, num_samples: int,
                      device="cuda") -> torch.Tensor:
    """Seed-driven ``mc_forward``: sample s runs on ``entropy.key(s)`` on
    ``device`` (CUDA unless the caller passes the CPU), so the result is a
    pure function of the base seed."""
    return torch.stack([apply_fn(entropy.key(s, device=device))
                        for s in range(num_samples)])
