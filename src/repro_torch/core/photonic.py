"""Digital twin of the photonic Bayesian machine (paper Fig. 2).

Counterpart of ``repro.core.photonic``.  The signal chain:

  1. an 8-bit DAC (80 GSPS, 3 samples per symbol) drives a broadband EOM,
     so every frequency channel carries the same input waveform;
  2. the ASE spectrum is shaped into 9 channels, channel k carrying the
     k-th probabilistic weight: mean from optical power, std from
     bandwidth (Gamma(M) statistics, ``core.entropy``);
  3. the chirped grating delays adjacent channels by one symbol, so
     channel k sees x[t - k];
  4. the photodetector sums the channels, y[t] = sum_k w_k(t) x[t - k]: a
     9-tap convolution whose taps are fresh draws per output symbol;
  5. an 8-bit ADC digitizes y.

``calibrate`` is the paper's feedback programming loop, and the analog
impairments (quantization, crosstalk, EOM curvature, drift, bandwidth
quantization and jitter, detector noise) reproduce its computation
errors.  Random draws take a ``torch.Generator``; ``convolve`` and
``sample_weights`` also take the weights' standard variates explicitly,
so a test can feed the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import entropy as E
from repro_torch.kernels import ref


# --------------------------------------------------------------------------
# quantization (8-bit DAC / ADC) with straight-through estimators
# --------------------------------------------------------------------------

def quantize_ste(x: torch.Tensor, bits: int, x_max: float) -> torch.Tensor:
    """Uniform symmetric quantizer whose gradient is the identity: the
    forward pass sees the 8-bit grid, gradients flow straight through."""
    return x + (ref.quantize(x, bits, x_max) - x).detach()


# --------------------------------------------------------------------------
# machine state
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MachineConfig:
    num_channels: int = E.NUM_CHANNELS
    dac_bits: int = E.DAC_BITS
    adc_bits: int = E.ADC_BITS
    input_range: float = 1.0          # EOM drive normalized to [-1, 1]
    output_range: float = 4.0         # photodetector + TIA full scale
    weight_range: float = 1.0         # |w| realizable per channel
    detector_noise: float = 5e-3      # thermal+shot noise floor (rel. FS)
    programming_gain: float = 0.6     # feedback step size of calibration
    gaussian_surrogate: bool = False  # True -> Gaussian eps (surrogate mode)
    # analog impairments (Fig. 2c/d error budget)
    crosstalk: float = 0.04           # adjacent-channel leakage
    eom_mod_depth: float = 0.75       # residual sin() nonlinearity
    drift_std: float = 0.03           # slow power drift after calibration
    # bandwidth-axis impairments: they hit sigma (prop. 1/sqrt(BW)) and
    # leave the power (mean) axis alone
    bw_quant_ghz: float = 12.5        # waveshaper setpoint granularity
    bw_jitter_std: float = 0.05       # fractional filter-edge jitter per shot


@dataclasses.dataclass(frozen=True)
class ChannelProgram:
    """Per-channel analog settings, the machine's 'weights register'."""
    power: torch.Tensor      # (C,)  differential optical power -> mean
    bandwidth: torch.Tensor  # (C,)  GHz -> std via Gamma modes

    def moments(self, bandwidth: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Weight moments at a bandwidth (default: the programmed setpoint,
        the controller's ideal model; the plant passes the bandwidth it
        realizes, ``effective_bandwidth``)."""
        m = E.modes_from_bandwidth(self.bandwidth if bandwidth is None
                                   else bandwidth)
        return self.power, torch.abs(self.power) / torch.sqrt(m)


def program_for_target(mu: torch.Tensor, sigma: torch.Tensor,
                       cfg: MachineConfig = MachineConfig()
                       ) -> ChannelProgram:
    """Open-loop programming: invert the moment maps (no feedback yet)."""
    mu = torch.clamp(mu, -cfg.weight_range, cfg.weight_range)
    rel = sigma / torch.clamp(torch.abs(mu), min=1e-3)
    return ChannelProgram(power=mu, bandwidth=E.bandwidth_for_relstd(rel))


# --------------------------------------------------------------------------
# the analog forward pass
# --------------------------------------------------------------------------

def effective_bandwidth(generator: torch.Generator, bw_ghz: torch.Tensor,
                        cfg: MachineConfig = MachineConfig(),
                        shots: tuple[int, ...] = ()) -> torch.Tensor:
    """Bandwidth the filter realizes for a programmed setpoint, per shot
    (``shots`` leading axes): snapped to the waveshaper's setpoint grid,
    then jittered by its wandering filter edges.  The controller's model
    stays ideal, so these survive calibration as residual sigma error."""
    bw = bw_ghz
    if cfg.bw_quant_ghz > 0:
        bw = torch.round(bw / cfg.bw_quant_ghz) * cfg.bw_quant_ghz
    if cfg.bw_jitter_std > 0:
        jit = 1.0 + cfg.bw_jitter_std * torch.randn(
            (*shots, *bw.shape), generator=generator, device=bw.device)
        bw = bw * torch.clamp(jit, min=0.1)
    return torch.clamp(bw, E.BW_MIN_GHZ, E.BW_MAX_GHZ)


def sample_weights(generator: torch.Generator, prog: ChannelProgram,
                   shape: tuple[int, ...],
                   cfg: MachineConfig = MachineConfig(),
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """Physical weights w ~ machine(prog), fresh per output symbol:
    (*shape, C).  ``eps`` gives the standard variates instead of drawing
    them (the Gaussian surrogate's or the standardised Gamma's)."""
    return _sample_weights(generator, prog, (), shape, cfg, eps)


def _per_shot(t: torch.Tensor, shots: tuple[int, ...], ndim: int):
    """(*shots, C) -> (*shots, 1, ..., 1, C) broadcasting over ``ndim``
    middle axes."""
    return t.reshape(*shots, *([1] * ndim), t.shape[-1])


def _sample_weights(generator, prog, shots, shape, cfg, eps):
    bw = effective_bandwidth(generator, prog.bandwidth, cfg, shots)
    mu, sigma = prog.moments(bandwidth=bw)
    full = (*shots, *shape, prog.power.shape[-1])
    if mu.dim() > 1:
        mu = _per_shot(mu, shots, len(shape))
    sigma = _per_shot(sigma, shots, len(shape)) if sigma.dim() > 1 \
        else sigma
    if eps is None:
        if cfg.gaussian_surrogate:
            eps = torch.randn(full, generator=generator,
                              device=prog.power.device)
        else:
            m = E.modes_from_bandwidth(bw)
            m = _per_shot(m, shots, len(shape)) if m.dim() > 1 else m
            m = m.expand(full).contiguous()
            gam = torch._standard_gamma(m, generator=generator) / m
            eps = (gam - 1.0) * torch.sqrt(m)
    return mu + sigma * eps


def convolve(generator: torch.Generator, x: torch.Tensor,
             prog: ChannelProgram, cfg: MachineConfig = MachineConfig(),
             eps: torch.Tensor | None = None) -> torch.Tensor:
    """One analog pass y[t] = sum_k w_k[t] x[t - k] over the valid region:
    x (..., T) in [-input_range, input_range] -> (..., T - C + 1), every
    output symbol with its own draw of the C weights.  ``eps`` (..., To,
    C) gives the weights' standard variates."""
    if eps is not None:
        eps = eps[None]
    return convolve_shots(generator, x, prog, 1, cfg, eps)[0]


def convolve_shots(generator: torch.Generator, x: torch.Tensor,
                   prog: ChannelProgram, n_shots: int,
                   cfg: MachineConfig = MachineConfig(),
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """``n_shots`` independent analog passes of ``convolve`` at once:
    (n_shots, ..., To).  Each shot has its own bandwidth jitter, power
    drift, weight draws and detector noise, as separate calls would."""
    C = cfg.num_channels
    shots = (n_shots,)
    xq = quantize_ste(x, cfg.dac_bits, cfg.input_range)   # DAC
    if cfg.eom_mod_depth > 0:
        # EOM sin() transfer, digitally linearized up to residual curvature
        a = cfg.eom_mod_depth * math.pi / 2
        xq = torch.sin(a * xq) / math.sin(a)
    T = x.shape[-1]
    To = T - C + 1
    # frequency-dependent group delay == stack of shifted copies (im2col)
    idx = (torch.arange(To, device=x.device)[:, None]
           + torch.arange(C, device=x.device)[None, :])
    taps = xq[..., idx]                                    # (..., To, C)
    if cfg.crosstalk > 0:
        # grating sidelobes leak a tap onto its neighbours' delays
        c = cfg.crosstalk
        left = torch.roll(taps, 1, dims=-1)
        left[..., 0] = 0.0
        right = torch.roll(taps, -1, dims=-1)
        right[..., -1] = 0.0
        taps = (1 - c) * taps + 0.5 * c * (left + right)
    if cfg.drift_std > 0:
        drift = 1.0 + cfg.drift_std * torch.randn(
            (n_shots, C), generator=generator, device=x.device)
        prog = ChannelProgram(power=prog.power * drift,
                              bandwidth=prog.bandwidth)
    w = _sample_weights(generator, prog, shots, (*x.shape[:-1], To), cfg,
                        eps)                               # (S, ..., To, C)
    y = torch.sum(taps * w.flip(-1), dim=-1)               # photodetector
    if cfg.detector_noise > 0:
        y = y + cfg.detector_noise * cfg.output_range * torch.randn(
            y.shape, generator=generator, device=x.device)
    return quantize_ste(y, cfg.adc_bits, cfg.output_range)  # ADC


def conv_throughput_estimate(cfg: MachineConfig = MachineConfig()) -> dict:
    """The paper's rated analog figures (not a measurement): 80 GSPS / 3
    samples per symbol ~ 26.7e9 probabilistic convolutions/s, 37.5 ps
    each, a 1.28 Tbit/s interface."""
    sps = 80e9 / E.SAMPLES_PER_SYMBOL
    return {"conv_per_s": sps, "latency_ps": E.CONV_LATENCY_PS,
            "interface_tbit_s": 2 * 80e9 * 8 / 1e12}


# --------------------------------------------------------------------------
# feedback-based calibration (paper: iterative programming, Supp. S8)
# --------------------------------------------------------------------------

def measure_moments(generator: torch.Generator, prog: ChannelProgram,
                    n_shots: int, cfg: MachineConfig = MachineConfig()
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel weight moments estimated from test convolutions: a
    unit impulse on each tap position reads one channel's weight."""
    C = cfg.num_channels
    probes = torch.nn.functional.pad(
        torch.eye(C, device=prog.power.device), (C - 1, C - 1))  # (C, T)
    ys = convolve_shots(generator, probes, prog, n_shots, cfg)  # (S, C, To)
    # probe row k has its impulse at padded position C-1+k, so output column
    # C-1 of that row reads tap w_{C-1-k}; flip to recover channel order.
    vals = ys[..., C - 1].flip(-1)                              # (S, C)
    return vals.mean(0), vals.std(0, unbiased=False)


def calibrate(generator: torch.Generator, target_mu: torch.Tensor,
              target_sigma: torch.Tensor, iters: int = 12,
              n_shots: int = 256, cfg: MachineConfig = MachineConfig()
              ) -> tuple[ChannelProgram, dict]:
    """Iterative feedback programming against target (mu, sigma):

        power     <- power     - g * (mu_meas - mu_target)
        bandwidth <- bandwidth * (sigma_meas / sigma_target)^(2g)

    (sigma goes as 1/sqrt(BW): halving sigma needs 4x the bandwidth)."""
    prog = program_for_target(target_mu, target_sigma, cfg)
    g = cfg.programming_gain
    history = {"mu_err": [], "sigma_err": []}
    for _ in range(iters):
        mu_m, sg_m = measure_moments(generator, prog, n_shots, cfg)
        mu_err = mu_m - target_mu
        ratio = torch.clamp(sg_m / torch.clamp(target_sigma, min=1e-4),
                            0.25, 4.0)
        prog = ChannelProgram(
            power=torch.clamp(prog.power - g * mu_err, -cfg.weight_range,
                              cfg.weight_range),
            bandwidth=torch.clamp(prog.bandwidth * ratio ** (2 * g),
                                  E.BW_MIN_GHZ, E.BW_MAX_GHZ))
        history["mu_err"].append(float(torch.abs(mu_err).mean()))
        history["sigma_err"].append(
            float(torch.abs(sg_m - target_sigma).mean()))
    return prog, history


def computation_error(generator: torch.Generator, n_kernels: int = 25,
                      n_shots: int = 512, seq_len: int = 64,
                      cfg: MachineConfig = MachineConfig()) -> dict:
    """Fig. 2(c, d): normalized error of the output mean and std.  For
    ``n_kernels`` random probabilistic kernels, calibrate, run random
    input waveforms, and compare the measured output distribution with
    the analytic target, normalized by the target output std (the
    paper's Eq. S8 convention)."""
    C = cfg.num_channels
    dev = generator.device
    errs_mu, errs_sg = [], []
    for _ in range(n_kernels):
        mu_t = (torch.rand((C,), generator=generator, device=dev) * 1.6
                - 0.8)
        sg_t = torch.abs(mu_t) * (0.12 + 0.16 * torch.rand(
            (C,), generator=generator, device=dev))
        prog, _ = calibrate(generator, mu_t, sg_t, iters=8, n_shots=128,
                            cfg=cfg)
        x = torch.rand((seq_len,), generator=generator, device=dev) * 2 - 1
        ys = convolve_shots(generator, x, prog, n_shots, cfg)  # (S, To)
        idx = (torch.arange(seq_len - C + 1, device=dev)[:, None]
               + torch.arange(C, device=dev))
        taps = x[idx]
        y_mu_t = taps @ mu_t.flip(0)
        y_sg_t = torch.sqrt(taps ** 2 @ (sg_t.flip(0) ** 2))
        scale = torch.clamp(y_sg_t.mean(), min=1e-6)
        errs_mu.append(float(torch.sqrt(torch.mean(
            (ys.mean(0) - y_mu_t) ** 2)) / (4 * scale)))
        errs_sg.append(float(torch.sqrt(torch.mean(
            (ys.std(0, unbiased=False) - y_sg_t) ** 2)) / scale))
    return {"mean_error": sum(errs_mu) / n_kernels,
            "std_error": sum(errs_sg) / n_kernels,
            "paper_mean_error": 0.158, "paper_std_error": 0.266}
