"""The paper's hybrid Bayesian CNN (Fig. 3).

Counterpart of ``repro.models.bnn_cnn``.  DenseNet-style concat skips and
MobileNetV1 depthwise-separable (DWS) convolutions: one standard 3x3
conv, three DWS blocks and a linear head.  Exactly ONE probabilistic
block, the depthwise 3x3 conv of block ``prob_block``: each depthwise
kernel has 9 weights, the machine's 9 spectral channels.

Forward modes:
  * 'surrogate' — training: Gaussian draw + STE quantization + sigma
    clamped to the machine-realizable band (``core.surrogate``).
  * 'machine'   — prediction on the digital twin: Gamma(M) ASE statistics
    at the bandwidth that realizes each weight's sigma, STE-quantized
    weights, DAC/ADC on the block's input and output.  A plain grouped
    convolution, as in the JAX package: no kernel.
  * 'mean'      — the deterministic (MAP) network.

Layouts are the JAX package's (NCHW activations, OIHW weights), and
``params_from_numpy`` takes the JAX parameters across, so the tests
compare like with like.  Where the two frameworks differ: GELU is the
tanh form (``jax.nn.gelu``'s default); ``SAME`` 3x3 convs at stride 1 pad
by 1; the 2x2 average pool drops an odd edge as ``VALID`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import entropy as E
from repro_torch.core import keys as K
from repro_torch.core.bayesian import (GaussianVariational, inv_softplus,
                                      split_generators)
from repro_torch.core.photonic import quantize_ste
from repro_torch.core.surrogate import SurrogateSpec

# (block, modes) -> Gamma(modes) draws of the probabilistic block's
# weights in machine mode; tests pass the JAX package's draws through it
GammaNoise = Callable[[int, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BNNConfig:
    num_classes: int = 7
    in_channels: int = 3
    width: int = 16                 # base channel count
    image_size: int = 28
    mc_samples: int = 10            # paper: N = 10
    prob_block: int = 3             # which block carries the variational dw
    init_sigma: float = 0.08


def _conv(generator, cin, cout, kh=3, kw=3, groups=1):
    fan = cin // groups * kh * kw
    return (torch.randn((cout, cin // groups, kh, kw), generator=generator,
                        device=generator.device) / math.sqrt(float(fan)))


def conv2d(x: torch.Tensor, w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Stride-1 ``SAME`` convolution of an odd square kernel."""
    return F.conv2d(x, w, padding=w.shape[-1] // 2, groups=groups)


def _pool(h: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(h, 2)     # 2x2 VALID window sum / 4


def init_params(generator: torch.Generator, cfg: BNNConfig) -> dict:
    """Six conv layers in four blocks, A (std conv), DWS, DWS (prob), DWS,
    with random weights from ``generator`` (on its device)."""
    w = cfg.width
    c = cfg.in_channels
    p = {"b0": {"w": _conv(generator, c, w)}}
    c = w + c                                      # concat skip
    for i, co in enumerate((w * 2, w * 3, w * 4), start=1):
        dw = _conv(generator, c, c, groups=c)      # (C, 1, 3, 3)
        if i == cfg.prob_block:
            dw = GaussianVariational(
                mu=dw, rho=torch.full_like(dw, float(inv_softplus(
                    cfg.init_sigma))))
        p[f"b{i}"] = {"dw": dw, "pw": _conv(generator, c, co, 1, 1)}
        c = co + c                                 # concat skip
    p["head"] = {"w": torch.randn((c, cfg.num_classes), generator=generator,
                                  device=generator.device)
                 / math.sqrt(float(c)),
                 "b": torch.zeros((cfg.num_classes,),
                                  device=generator.device)}
    return p


def params_from_numpy(tree: dict, cfg: BNNConfig, device) -> dict:
    """The port's parameters from the JAX ``init_params`` tree given as
    nested dicts of numpy arrays (the probabilistic ``dw`` as ``{"mu",
    "rho"}``), in the same layouts."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    p = {"b0": {"w": t(tree["b0"]["w"])},
         "head": {"w": t(tree["head"]["w"]), "b": t(tree["head"]["b"])}}
    for i in (1, 2, 3):
        b = tree[f"b{i}"]
        dw = b["dw"]
        if i == cfg.prob_block:
            dw = GaussianVariational(mu=t(dw["mu"]), rho=t(dw["rho"]))
        else:
            dw = t(dw)
        p[f"b{i}"] = {"dw": dw, "pw": t(b["pw"])}
    return p


def _dw_weights(q: GaussianVariational, generator, mode: str,
                spec: SurrogateSpec, block: int,
                noise: GammaNoise | None,
                eps: dict | None = None) -> torch.Tensor:
    """The probabilistic depthwise weights of one forward pass."""
    if mode == "mean":
        return q.mu
    if mode == "surrogate":
        e = eps[block] if eps is not None else torch.randn(
            q.mu.shape, generator=generator, device=q.mu.device)
        return spec.apply_weight(q, e)
    if mode == "machine":
        # ASE Gamma(M) statistics at the programmed bandwidth + DAC grid
        sigma = spec.realizable_sigma(q.mu, q.sigma)
        rel = sigma / torch.clamp(torch.abs(q.mu), min=1e-6)
        m = E.modes_from_bandwidth(E.bandwidth_for_relstd(rel))
        gam = (noise(block, m) if noise is not None else
               torch._standard_gamma(m, generator=generator)) / m
        w = q.mu + sigma * ((gam - 1.0) * torch.sqrt(m))
        return quantize_ste(w, spec.machine.dac_bits,
                            spec.machine.weight_range)
    raise ValueError(mode)


def apply(params: dict, cfg: BNNConfig, x: torch.Tensor,
          generator: torch.Generator | None, mode: str = "surrogate",
          spec: SurrogateSpec = SurrogateSpec(),
          noise: GammaNoise | None = None,
          eps: dict | None = None) -> torch.Tensor:
    """x: (B, C, H, W) in [0, 1] -> logits (B, num_classes).  ``noise``
    supplies machine mode's Gamma draws instead of ``generator``; ``eps``
    ({block: standard normals of the block's weight shape}) surrogate
    mode's Gaussian draws."""
    act = lambda v: F.gelu(v, approximate="tanh")  # noqa: E731
    h = act(conv2d(x, params["b0"]["w"]))
    h = _pool(torch.cat([h, x], dim=1))
    for i in (1, 2, 3):
        bp = params[f"b{i}"]
        cin = h.shape[1]
        if isinstance(bp["dw"], GaussianVariational):
            dw = _dw_weights(bp["dw"], generator, mode, spec, i, noise,
                             eps)
            hin = spec.apply_input(torch.clamp(h, -1.0, 1.0)) \
                if mode != "mean" else h
            hd = conv2d(hin, dw, groups=cin)
            if mode != "mean":
                hd = spec.apply_output(hd)        # ADC on the way back
        else:
            hd = conv2d(h, bp["dw"], groups=cin)
        hp = act(conv2d(hd, bp["pw"]))            # pointwise 1x1
        h = torch.cat([hp, h], dim=1)
        if i < 3:
            h = _pool(h)
    h = h.mean(dim=(2, 3))                        # global average pool
    return h @ params["head"]["w"] + params["head"]["b"]


def mc_predict(params: dict, cfg: BNNConfig, x: torch.Tensor,
               generator: torch.Generator | None = None,
               mode: str = "machine", spec: SurrogateSpec = SurrogateSpec(),
               noise: Callable[[int, int, torch.Tensor], torch.Tensor]
               | None = None) -> torch.Tensor:
    """N = ``cfg.mc_samples`` stochastic forward passes -> probabilities
    (N, B, classes).  Sample s draws from its own generator, split from
    ``generator`` (the counterpart of the JAX package's ``vmap`` over
    split keys).  ``noise(s, block, modes)`` supplies machine mode's Gamma
    draws instead."""
    n = cfg.mc_samples
    gens = split_generators(generator, n, x.device) \
        if generator is not None else [None] * n
    logits = [apply(params, cfg, x, g, mode=mode, spec=spec,
                    noise=None if noise is None else
                    (lambda i, m, s=s: noise(s, i, m)))
              for s, g in enumerate(gens)]
    return torch.softmax(torch.stack(logits), dim=-1)


def nll_fn(cfg: BNNConfig, spec: SurrogateSpec = SurrogateSpec(),
           noise=None):
    """The ELBO's NLL closure for ``core.svi.elbo_loss``
    (``repro.models.bnn_cnn.nll_fn``): ``nll(params, batch, key) ->
    (nll, {"accuracy"})`` over ``batch`` = {"images", "labels"}, the
    forward in surrogate mode.  The probabilistic block ``i`` draws its
    eps from ``noise(fold_in(key, i), shape, device)`` (default
    ``keys.normal``), as the reference keys it; its quantizers and the
    sigma clamp pass gradients straight through."""
    draw = noise or K.normal

    def nll(params, batch, key):
        x = batch["images"]
        eps = {i: draw(K.fold_in(key, i), tuple(params[f"b{i}"]["dw"].mu
                                                .shape), x.device)
               for i in (1, 2, 3)
               if isinstance(params[f"b{i}"]["dw"], GaussianVariational)}
        logits = apply(params, cfg, x, None, mode="surrogate", spec=spec,
                       eps=eps)
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return nll, {"accuracy": acc}

    return nll
