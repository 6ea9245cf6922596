"""The machine primitive, a 9-tap probabilistic convolution: the CUDA
kernels and their plain PyTorch version.

Counterpart of ``repro.kernels.photonic_conv`` (``photonic_conv_kernel``
with an explicit entropy operand, ``photonic_conv_fused_kernel`` with the
per-symbol variates drawn in the kernel).  For x (B, T) and the channel
moments mu/sigma (C,), with To = T - C + 1:

    xq = DAC(x)                      (8 bit over +-in_range)
    y[b, t] = sum_{k=0..C-1} xq[b, t+k] * w[b, t, C-1-k],
    w[b, t, c] = mu[c] + sigma[c] * eps[b, t, c]
    out = ADC(y)                     (8 bit over +-out_range)

The sum runs in the order k = 0..C-1 with every product and sum rounded
on its own (no fused multiply-add), as the TPU kernel's loop does, so the
kernel and the plain version agree bit for bit and a sum near an ADC
level rounds the same way.  eps is either an explicit (B, To, C) operand
(``photonic_conv_cuda``) or the TAG_CONV Philox stream of ``rng.py``
keyed by (seed, 0) (``photonic_conv_sampled_cuda``), which never exists
in device memory: that stream is the (B, To, C) operand drawn four normals
a Philox call in row-major order, so
``photonic_conv_sampled(x, mu, sigma, seed)`` equals
``photonic_conv(x, mu, sigma, rng.conv_normal(seed, ...))``.  Both kernels
run one body (``csrc/photonic_conv.cu``): only how the block's eps tile
is filled differs.  ``ops.py`` picks the kernel or the plain version by
the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches, ref, rng

MAX_CHANNELS = 16    # the kernels' bound on C
MAX_ROWS = 65535     # B is the kernels' grid y dimension


def _levels_scale(bits: int, x_max: float) -> tuple[int, float]:
    levels = 2 ** (bits - 1) - 1
    return levels, x_max / levels


# ---------------------------------------------------------------------------
# plain version (the kernel's tap loop, in PyTorch)
# ---------------------------------------------------------------------------

def photonic_conv_plain(x: torch.Tensor, mu: torch.Tensor,
                        sigma: torch.Tensor, eps: torch.Tensor | None = None,
                        *, seed: int = 0, dac_bits: int = 8,
                        adc_bits: int = 8, in_range: float = 1.0,
                        out_range: float = 4.0) -> torch.Tensor:
    """(B, To) f32; eps=None draws the TAG_CONV stream keyed by seed."""
    B, T = x.shape
    C = mu.shape[-1]
    To = T - C + 1
    if eps is None:
        dev = x.device
        eps = rng.conv_normal(seed, torch.arange(B, dtype=torch.int64,
                                                 device=dev),
                              torch.arange(To, dtype=torch.int64,
                                           device=dev), C)
    xq = ref.quantize(x.float(), dac_bits, in_range)
    mu, sigma, eps = mu.float(), sigma.float(), eps.float()
    acc = torch.zeros((B, To), dtype=torch.float32, device=x.device)
    for k in range(C):
        c = C - 1 - k
        w = mu[c] + sigma[c] * eps[..., c]
        acc = acc + xq[:, k:k + To] * w
    return ref.quantize(acc, adc_bits, out_range)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _fn(name: str):
    fn = getattr(build.load("photonic_conv"), name)
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, i, p, p, i, p, ctypes.c_uint32, p, f, f, f, f,
                       p]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(kernel: str, x, mu, sigma, eps, seed, dac_bits, adc_bits,
            in_range, out_range) -> torch.Tensor:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {dev}")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, T), got {tuple(x.shape)}")
    B, T = x.shape
    C = mu.shape[-1]
    To = T - C + 1
    if not 1 <= C <= MAX_CHANNELS or To < 1 or not 1 <= B <= MAX_ROWS \
            or To * C >= 2 ** 32:
        raise ValueError(f"need 1 <= C <= {MAX_CHANNELS}, T >= C, "
                         f"(T - C + 1) * C < 2^32 and 1 <= B <= {MAX_ROWS}; "
                         f"got B={B}, T={T}, C={C}")
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be 32-bit unsigned, got {seed}")
    _check(x, "x", (B, T), dev)
    _check(mu, "mu", (C,), dev)
    _check(sigma, "sigma", (C,), dev)
    if eps is not None:
        _check(eps, "eps", (B, To, C), dev)
    in_levels, in_scale = _levels_scale(dac_bits, in_range)
    out_levels, out_scale = _levels_scale(adc_bits, out_range)
    y = torch.empty((B, To), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn(f"repro_{kernel}")(
            x.data_ptr(), B, T, mu.data_ptr(), sigma.data_ptr(), C,
            eps.data_ptr() if eps is not None else None, seed, y.data_ptr(),
            in_scale, float(in_levels), out_scale, float(out_levels), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    launches.COUNTS[kernel] += 1
    return y


def photonic_conv_cuda(x, mu, sigma, eps, *, dac_bits: int = 8,
                       adc_bits: int = 8, in_range: float = 1.0,
                       out_range: float = 4.0) -> torch.Tensor:
    """The kernel with an explicit (B, To, C) eps operand."""
    return _launch("photonic_conv", x, mu, sigma, eps, 0, dac_bits,
                   adc_bits, in_range, out_range)


def photonic_conv_sampled_cuda(x, mu, sigma, seed: int, *, dac_bits: int = 8,
                               adc_bits: int = 8, in_range: float = 1.0,
                               out_range: float = 4.0) -> torch.Tensor:
    """The kernel that draws eps into shared memory (TAG_CONV stream)."""
    return _launch("photonic_conv_sampled", x, mu, sigma, None, seed,
                   dac_bits, adc_bits, in_range, out_range)
