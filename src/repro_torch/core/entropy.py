"""Entropy sources for the photonic Bayesian machine.

Counterpart of ``repro.core.entropy``.  The paper's physical entropy
source is amplified spontaneous emission (ASE) sliced into frequency
channels; the detected power of a channel of optical bandwidth B_opt seen
with electrical bandwidth B_elec is Gamma distributed with M = B_opt /
B_elec modes: mean P (set by the optical power) and std P / sqrt(M) (set
by the bandwidth) — the machine's programming rule.

Four sources behind one API, all returning STANDARD variates (mean 0,
std 1) shaped as asked, so a layer applies ``w = mu + sigma * eps``
whatever the source:

  * ``PRNGEntropy``    -- the digital Gaussian baseline.
  * ``ASEEntropy``     -- standardised Gamma(M): mean 0, std 1, skew
                          2/sqrt(M), the physics the Gaussian surrogate
                          approximates away.
  * ``EntropyStream``  -- a buffer drawn beforehand and replayed into the
                          kernels as an operand (a ring with a functional
                          cursor), the machine's external randomness.
  * ``KernelEntropy``  -- the base seed of the kernels' in-kernel Philox
                          streams (``kernels/rng.py``): no entropy tensor
                          exists in device memory.

Random draws take a ``torch.Generator`` where the JAX package takes a
key; the two give different numbers, so the parity tests feed both the
same variates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device

# --- hardware constants from the paper --------------------------------------
CENTER_FREQ_THZ = 194.0          # channel grid center
CHANNEL_SPACING_GHZ = 403.0      # spacing between the 9 channels
NUM_CHANNELS = 9                 # one probabilistic weight per channel
BW_MIN_GHZ = 25.0                # minimum programmable channel bandwidth
BW_MAX_GHZ = 150.0               # maximum programmable channel bandwidth
ELEC_BW_GHZ = 40.0               # detection bandwidth (80 GSPS Nyquist)
GROUP_DELAY_PS_PER_THZ = -93.1   # chirped-grating dispersion
DAC_BITS = 8
ADC_BITS = 8
SAMPLES_PER_SYMBOL = 3           # 80 GSPS DAC, 3 samples per vector entry
CONV_LATENCY_PS = 37.5           # one 9-tap probabilistic convolution

# Detection integrates SAMPLES_PER_SYMBOL ADC samples per symbol plus the
# analog front-end's time-bandwidth product; both multiply the Gamma mode
# count (variance averaging).  The balanced receiver detects one
# polarization per arm, so there is no polarization-diversity factor.
INTEGRATION_FACTOR = 2.0 * SAMPLES_PER_SYMBOL

_GOLDEN = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


def modes_from_bandwidth(bw_ghz: torch.Tensor) -> torch.Tensor:
    """Gamma degrees of freedom M for a channel of optical bandwidth bw."""
    bw = torch.clamp(torch.as_tensor(bw_ghz, dtype=torch.float32),
                     BW_MIN_GHZ, BW_MAX_GHZ)
    return bw / ELEC_BW_GHZ * INTEGRATION_FACTOR


def relstd_range() -> tuple[float, float]:
    """Realizable sigma/|mu| band of one channel: [1/sqrt(M_max),
    1/sqrt(M_min)] — a sqrt(6) ratio over the 25-150 GHz range."""
    m_lo = BW_MIN_GHZ / ELEC_BW_GHZ * INTEGRATION_FACTOR
    m_hi = BW_MAX_GHZ / ELEC_BW_GHZ * INTEGRATION_FACTOR
    return 1.0 / m_hi ** 0.5, 1.0 / m_lo ** 0.5


def bandwidth_for_relstd(rel_std: torch.Tensor) -> torch.Tensor:
    """Invert std/mean = 1/sqrt(M): the bandwidth that realizes a relative
    std, clipped to the hardware band."""
    rel = torch.as_tensor(rel_std, dtype=torch.float32)
    m = 1.0 / torch.clamp(rel, min=1e-6) ** 2
    return torch.clamp(m * ELEC_BW_GHZ / INTEGRATION_FACTOR, BW_MIN_GHZ,
                       BW_MAX_GHZ)


class EntropySource:
    """Standard-variate sampler interface: eps has mean 0, std 1."""

    def sample(self, generator: torch.Generator, shape: tuple[int, ...],
               dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PRNGEntropy(EntropySource):
    """Digital Gaussian baseline."""

    def sample(self, generator, shape, dtype=torch.float32):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device)


@dataclasses.dataclass(frozen=True)
class ASEEntropy(EntropySource):
    """Gamma(M) photocurrent statistics of a spectrally sliced ASE source,
    standardised: eps = (I/P - 1) * sqrt(M), I ~ Gamma(M, P/M), so mean 0,
    std 1 and skew 2/sqrt(M).  ``modes`` is a scalar or a tensor that
    broadcasts to the sample shape (per-channel bandwidths)."""

    modes: float = 2.0 * 100.0 / ELEC_BW_GHZ  # default: 100 GHz channel

    def sample(self, generator, shape, dtype=torch.float32):
        m = torch.as_tensor(self.modes, dtype=torch.float32,
                            device=generator.device)
        gam = torch._standard_gamma(m.expand(shape).contiguous(),
                                    generator=generator) / m
        return ((gam - 1.0) * torch.sqrt(m)).to(dtype)


@dataclasses.dataclass(frozen=True)
class KernelEntropy(EntropySource):
    """Base seed of the in-kernel entropy streams.  The kernels key their
    Philox4x32-10 streams by a seed derived from it (``fold``), so every
    call site owns a distinct, replayable stream and no entropy tensor
    exists in device memory.  Contract: standard normal, and the same
    seed gives the same stream."""

    seed: int = 0

    def fold(self, *ids: int) -> int:
        """Derive a per-site 32-bit seed from the base seed: successive
        fold-ins ``s = s * 0x9E3779B9 + id + 1`` (mod 2^32), the mixing
        the JAX package uses on host and device."""
        s = self.seed & _MASK32
        for i in ids:
            s = (s * _GOLDEN + (i & _MASK32) + 1) & _MASK32
        return s

    def key(self, *ids: int, device="cuda") -> torch.Generator:
        """A generator on ``device`` for the (optionally folded) stream —
        the draws of layers that need materialized variates.  CUDA unless
        the caller passes the CPU; without a GPU it raises."""
        return torch.Generator(device=resolve_device(device)).manual_seed(
            self.fold(*ids))

    def sample(self, generator, shape, dtype=torch.float32):
        """Draws on ``generator``'s device; generator=None draws the
        seed's own stream on the GPU (``key()``)."""
        g = self.key() if generator is None else generator
        return torch.randn(shape, generator=g, dtype=dtype, device=g.device)


@dataclasses.dataclass(frozen=True)
class EntropyStream:
    """Variates drawn beforehand and replayed into the kernels as an
    operand: a ring buffer whose cursor advances functionally (``draw``
    returns the next stream state), so a caller can carry or checkpoint
    it."""

    buffer: torch.Tensor       # (capacity,) standard variates
    cursor: int = 0

    @staticmethod
    def create(generator: torch.Generator, capacity: int,
               source: EntropySource | None = None) -> "EntropyStream":
        src = source or ASEEntropy()
        return EntropyStream(buffer=src.sample(generator, (capacity,)))

    def draw(self, shape: tuple[int, ...]) -> tuple[torch.Tensor,
                                                    "EntropyStream"]:
        n = int(np.prod(shape))
        cap = self.buffer.shape[0]
        if n > cap:
            raise ValueError(f"draw of {n} exceeds stream capacity {cap}")
        idx = (self.cursor + torch.arange(n, device=self.buffer.device)) \
            % cap
        nxt = EntropyStream(self.buffer, (self.cursor + n) % cap)
        return self.buffer[idx].reshape(shape), nxt


# -- NIST-style sanity statistics (the paper cites SP 800-22) ----------------

def entropy_health(bits: np.ndarray) -> dict[str, float]:
    """Light-weight health tests on a bitstream (monobit, runs, chi2 bytes).

    Not the full SP 800-22 battery -- the subset that catches a dead or
    correlated source, which is what a production machine monitors online.
    """
    bits = np.asarray(bits).astype(np.uint8) & 1
    n = bits.size
    ones = float(bits.sum())
    monobit_z = abs(ones - n / 2) / np.sqrt(n / 4)
    # runs test
    pi = ones / n
    runs = 1 + int(np.sum(bits[1:] != bits[:-1]))
    runs_expected = 2 * n * pi * (1 - pi) + 1
    runs_var = 2 * n * pi * (1 - pi) * (2 * pi * (1 - pi)) if n else 1.0
    runs_z = abs(runs - runs_expected) / max(np.sqrt(max(runs_var, 1e-12)),
                                             1e-12)
    # byte chi^2
    nbytes = n // 8
    byts = np.packbits(bits[: nbytes * 8])
    hist = np.bincount(byts, minlength=256)
    expected = nbytes / 256.0
    chi2 = float(np.sum((hist - expected) ** 2 / max(expected, 1e-12)))
    return {"monobit_z": float(monobit_z), "runs_z": float(runs_z),
            "byte_chi2": chi2, "n_bits": float(n)}


def gaussian_to_bits(eps: np.ndarray) -> np.ndarray:
    """Median-threshold bit extraction used for the health tests."""
    med = np.median(eps)
    return (np.asarray(eps) > med).astype(np.uint8)
