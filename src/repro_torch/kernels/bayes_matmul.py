"""The sampled-weight GEMM: the CUDA kernels and their plain PyTorch
versions (the weight-space half of ``repro.kernels.bayes_matmul``; the
LRT half is not ported yet).

  * ``bayes_matmul``: one draw, y = x @ (mu + sigma * eps) with an
    explicit (K, N) eps — counterpart of ``bayes_matmul_kernel``.
  * ``bayes_matmul_sampled``: S draws in one pass, y_s = x @ (mu + sigma *
    eps_s), (S, M, N) — counterpart of ``bayes_matmul_fused_kernel``.
    Each mu/sigma tile is read once for all S samples.  eps is either an
    explicit (S, K, N) operand or the TAG_BAYES Philox stream of
    ``rng.py`` keyed by (seed, 0) with one counter per (n, k, s // 4), so
    every row block of the kernel redraws the SAME W_s: one sampled
    weight matrix per sample, whatever the row.

Both kernels are f32 GEMMs on the CUDA cores (no tensor cores, no TF32);
bf16 operands are converted to f32 here, before the launch.  The
single draw's plain version is ``ref.bayes_matmul``.  The sampled GEMM's
plain version below follows the kernel's loop — W_s formed per (bk, bn)
tile, the variates drawn per tile from the element's own counter, row
blocks replayed — so masking and stream keying are checked on the CPU.
Its tile sizes are arguments: the stream must not depend on them.
``ops.py`` picks the kernel or the plain version by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches, rng

MAX_SAMPLES = 16     # the fused kernel keeps S accumulators per output
PLAIN_BK = 128       # the plain version's default tiles (any tile gives
PLAIN_BN = 256       # the same variates; the kernel uses its own)


# ---------------------------------------------------------------------------
# plain version of the sampled GEMM (the kernel's tile loop, in PyTorch)
# ---------------------------------------------------------------------------

def bayes_matmul_sampled_plain(x: torch.Tensor, mu: torch.Tensor,
                               sigma: torch.Tensor, *, num_samples: int,
                               eps: torch.Tensor | None = None,
                               seed: int = 0, bm: int | None = None,
                               bk: int = PLAIN_BK,
                               bn: int = PLAIN_BN) -> torch.Tensor:
    """(S, M, N) f32.  eps=None draws each tile's variates from the
    TAG_BAYES stream keyed by seed, once per row block of ``bm`` rows
    (all rows by default), as the kernel does."""
    x, mu, sigma = x.float(), mu.float(), sigma.float()
    M, K = x.shape
    N = mu.shape[1]
    S = num_samples
    dev = x.device
    y = torch.zeros((S, M, N), dtype=torch.float32, device=dev)
    bm = bm or M
    for m0 in range(0, M, bm):
        m1 = min(m0 + bm, M)
        for n0 in range(0, N, bn):
            n1 = min(n0 + bn, N)
            for k0 in range(0, K, bk):
                k1 = min(k0 + bk, K)
                if eps is None:
                    e = rng.bayes_normal(
                        seed, S,
                        torch.arange(k0, k1, dtype=torch.int64, device=dev),
                        torch.arange(n0, n1, dtype=torch.int64, device=dev))
                else:
                    e = eps[:, k0:k1, n0:n1].float()
                w = mu[None, k0:k1, n0:n1] + sigma[None, k0:k1, n0:n1] * e
                y[:, m0:m1, n0:n1] += x[None, m0:m1, k0:k1] @ w
    return y


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _fn(name: str):
    fn = getattr(build.load("bayes_matmul"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, ctypes.c_uint32, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _operands(x, mu, sigma, eps, eps_shape):
    """f32, contiguous operands on x's CUDA device, shapes checked."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"bayes_matmul kernels need CUDA tensors, got {dev}")
    if x.dim() != 2 or mu.dim() != 2:
        raise ValueError(f"x must be (M, K) and mu (K, N), got "
                         f"{tuple(x.shape)}, {tuple(mu.shape)}")
    M, K = x.shape
    N = mu.shape[1]
    _check(mu, "mu", (K, N), dev)
    _check(sigma, "sigma", (K, N), dev)
    if eps is not None:
        _check(eps, "eps", eps_shape(K, N), dev)
    for t, name in ((x, "x"), (mu, "mu"), (sigma, "sigma"), (eps, "eps")):
        if t is not None and t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32 "
                            "or bfloat16")
    return M, K, N, [None if t is None else t.float().contiguous()
                     for t in (x, mu, sigma, eps)]


def _launch(kernel, xs, S, seed, y, M, K, N):
    x, mu, sigma, eps = xs
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn(f"repro_{kernel}")(
            x.data_ptr(), mu.data_ptr(), sigma.data_ptr(),
            eps.data_ptr() if eps is not None else None, S, seed,
            y.data_ptr(), M, K, N, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    launches.COUNTS[kernel] += 1
    return y


def bayes_matmul_cuda(x, mu, sigma, eps) -> torch.Tensor:
    """One draw with an explicit (K, N) eps -> (M, N) f32."""
    M, K, N, xs = _operands(x, mu, sigma, eps, lambda k, n: (k, n))
    if xs[3] is None:
        raise ValueError("bayes_matmul needs an explicit eps")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    return _launch("bayes_matmul", xs, 1, 0, y, M, K, N)


def bayes_matmul_sampled_cuda(x, mu, sigma, *, num_samples: int,
                              eps=None, seed: int = 0) -> torch.Tensor:
    """S draws in one pass -> (S, M, N) f32; eps (S, K, N) or
    None for the in-kernel TAG_BAYES stream keyed by seed."""
    S = num_samples
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"num_samples must be in [1, {MAX_SAMPLES}], got "
                         f"{S}")
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be 32-bit unsigned, got {seed}")
    M, K, N, xs = _operands(x, mu, sigma, eps, lambda k, n: (S, k, n))
    y = torch.empty((S, M, N), dtype=torch.float32, device=x.device)
    return _launch("bayes_matmul_sampled", xs, S, seed, y, M, K, N)
