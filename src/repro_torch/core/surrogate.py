"""Differentiable surrogate of the photonic Bayesian machine (paper §BNN).

Counterpart of ``repro.core.surrogate``.  The paper trains against a
Gaussian surrogate whose forward pass mimics the machine's limited
accuracy through straight-through estimators, then predicts on the
machine.  The surrogate imposes the machine's constraints on the
variational family:

  * sigma is representable only inside the relative-std band set by the
    25-150 GHz channel bandwidth (``entropy.relstd_range``); it is clamped
    into that band with an STE, so gradients keep shaping rho;
  * weights pass the 8-bit DAC grid (STE quantization);
  * activations pass the 8-bit DAC (inputs) and ADC (outputs) grids.

At prediction, ``models.bnn_cnn`` in ``machine`` mode draws the
probabilistic block's weights from the Gamma statistics of the twin and
runs a plain grouped convolution; no kernel is involved (the JAX
package's docstring says otherwise, its code does the same).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import entropy as E
from repro_torch.core.bayesian import GaussianVariational
from repro_torch.core.photonic import MachineConfig, quantize_ste


def ste_clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """clip with identity gradient (keeps SVI gradients alive at the
    rails)."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


@dataclasses.dataclass(frozen=True)
class SurrogateSpec:
    machine: MachineConfig = MachineConfig()
    quantize_weights: bool = True
    clamp_sigma: bool = True
    quantize_activations: bool = True

    def realizable_sigma(self, mu: torch.Tensor,
                         sigma: torch.Tensor) -> torch.Tensor:
        """Project sigma into the machine's per-channel band [r_lo |mu|,
        r_hi |mu|]; a |mu| floor keeps near-zero weights programmable."""
        r_lo, r_hi = E.relstd_range()
        a = torch.clamp(torch.abs(mu), min=2.0 / (2 ** self.machine.dac_bits))
        return ste_clip(sigma, r_lo * a, r_hi * a)

    def apply_weight(self, q: GaussianVariational,
                     eps: torch.Tensor) -> torch.Tensor:
        """Surrogate forward draw: reparam + hardware constraints w/ STE."""
        sigma = q.sigma
        if self.clamp_sigma:
            sigma = self.realizable_sigma(q.mu, sigma)
        w = q.mu + sigma * eps
        if self.quantize_weights:
            w = quantize_ste(w, self.machine.dac_bits,
                             self.machine.weight_range)
        return w

    def apply_input(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quantize_activations:
            return x
        return quantize_ste(x, self.machine.dac_bits,
                            self.machine.input_range)

    def apply_output(self, y: torch.Tensor) -> torch.Tensor:
        if not self.quantize_activations:
            return y
        return quantize_ste(y, self.machine.adc_bits,
                            self.machine.output_range)
