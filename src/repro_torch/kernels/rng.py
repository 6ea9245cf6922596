"""Philox4x32-10 in plain PyTorch — the port's counter-based generator.

The JAX package draws the Bayesian head's variates with the TPU's own
per-core PRNG (``repro.kernels.rng``), re-seeded per tile so pass 2 can
replay pass 1's bits.  On the GPU the head kernel carries Philox4x32-10
(``csrc/philox.cuh``) instead, and this module is its bit-exact twin:

  * key = (seed, step), one counter per element: (v, m, s, tag) for vocab
    column v, row m, sample s.  The stream therefore depends on the
    element alone, never on a tile shape, and replay is free;
  * a normal is Box-Muller over the first two output words, each mapped
    to U[0, 1) by its top 24 bits, exactly as ``repro.kernels.rng`` does:
    ``sqrt(-2 log(1 - u1)) * cos(2 pi u2)``.

The integer rounds run in int64 with 16-bit limbs for the 32x32->64
products, so no intermediate overflows and CPU and CUDA give the same
bits as the kernel.  The float transform can differ from CUDA's libm by
an ulp.
"""

from __future__ import annotations

import math

import torch

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK = 0xFFFFFFFF
_INV_2_24 = 1.0 / float(1 << 24)
_TWO_PI = 2.0 * math.pi

# counter tags (the fourth counter word) separating the two head streams
TAG_KERNEL = 0     # in-kernel head draws, key (seed, step)
TAG_OPERAND = 1    # operand-mode decode noise, key (seed, depth)


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product m * x, x in [0, 2^32)."""
    lo16 = x & 0xFFFF
    hi16 = x >> 16
    a = m * lo16                              # < 2^48
    b = m * hi16                              # < 2^48
    mid = a + ((b & 0xFFFF) << 16)            # < 2^49
    lo = mid & _MASK
    hi = ((b >> 16) + (mid >> 32)) & _MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of broadcastable int64 counter and key words (ints or
    tensors, each in [0, 2^32)).  Returns the four output words as int64."""
    dev = next((w.device for w in (c0, c1, c2, c3, k0, k1)
                if isinstance(w, torch.Tensor)), None)
    c = [torch.as_tensor(w, dtype=torch.int64, device=dev)
         for w in (c0, c1, c2, c3)]
    c0, c1, c2, c3 = torch.broadcast_tensors(*c)
    k0 = k0 & _MASK
    k1 = k1 & _MASK
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64 holding [0, 2^32)) -> U[0, 1) float32 from the
    top 24 bits (full mantissa, no modulo bias)."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def normal_from_bits(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Box-Muller: r*cos(theta), r = sqrt(-2 log(1-u1)), theta = 2 pi u2.
    u1 in [0, 1) keeps 1-u1 in (0, 1], so the log never sees 0."""
    u1 = uniform_from_bits(w0)
    u2 = uniform_from_bits(w1)
    r = torch.sqrt(-2.0 * torch.log(1.0 - u1))
    return r * torch.cos(_TWO_PI * u2)


def element_normal(seed: int, step: int, v: torch.Tensor, m: torch.Tensor,
                   s: torch.Tensor, tag: int = TAG_KERNEL) -> torch.Tensor:
    """Standard normals at broadcast (v, m, s) element coordinates of the
    stream keyed by (seed, step) — what the head kernel draws in place."""
    w0, w1, _, _ = philox4x32(v, m, s, tag, seed, step)
    return normal_from_bits(w0, w1)


def head_normal(seed: int, step: int, num_samples: int, rows: int,
                cols: torch.Tensor, tag: int = TAG_KERNEL) -> torch.Tensor:
    """(S, rows, len(cols)) variates of the head stream for vocab columns
    ``cols`` (an int64 tensor; its device is the output's)."""
    dev = cols.device
    s = torch.arange(num_samples, dtype=torch.int64, device=dev)
    m = torch.arange(rows, dtype=torch.int64, device=dev)
    return element_normal(seed, step, cols[None, None, :], m[None, :, None],
                          s[:, None, None], tag)
