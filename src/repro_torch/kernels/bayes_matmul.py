"""The sampled-weight GEMM and the local-reparameterization (LRT) GEMM:
the CUDA kernels and their plain PyTorch versions (counterpart of
``repro.kernels.bayes_matmul``).

  * ``bayes_matmul``: one draw, y = x @ (mu + sigma * eps) with an
    explicit (K, N) eps — counterpart of ``bayes_matmul_kernel``.
  * ``bayes_matmul_sampled``: S draws in one pass, y_s = x @ (mu + sigma *
    eps_s), (S, M, N) — counterpart of ``bayes_matmul_fused_kernel``.
    Each mu/sigma tile is read once for all S samples.  eps is either an
    explicit (S, K, N) operand or the TAG_BAYES Philox stream of
    ``rng.py`` keyed by (seed, 0) with one counter per (n, k, s // 4), so
    every row block of the kernel redraws the SAME W_s: one sampled
    weight matrix per sample, whatever the row.

  * ``lrt_matmul``: one output-space draw, y = x@mu + sqrt(max((x*x) @
    sigma^2, 0)) * xi with an explicit (M, N) xi — counterpart of
    ``lrt_matmul_kernel``.
  * ``lrt_matmul_sampled``: S draws from ONE mean GEMM and ONE variance
    GEMM, (S, M, N) — counterpart of ``lrt_matmul_fused_kernel``.  xi is
    an explicit (S, M, N) operand or the TAG_LRT Philox stream keyed by
    (seed, 0) with one counter per (n, m, s // 4): the draw depends on the
    output element alone.

The weight-space GEMMs have two kernels, chosen by ``bayes_route`` from
shape, S and alignment (never by failure): ``bayes_gemm_mma``, 3xTF32
tensor-core tiles that form each W_s tile once per 128-row block and
split each x fragment once for all S samples, for at least
``BAYES_MMA_MIN_ROWS`` rows with N % 4 == 0 and 16-byte aligned mu,
sigma and eps (any K: x rows that are not 16-byte aligned, the im2col's
K 171, are copied 4 bytes at a time); the SIMT kernels, f32 FMAs on the
CUDA cores, for everything else.  The single draw is the S = 1 instance
of the sampled GEMM.  bf16 operands are converted to f32 here, before the
launch, and the route is taken on the f32 operands the kernel reads.
The LRT GEMMs have two kernels, chosen by ``lrt_route`` from shape, type
and alignment (never by failure): ``lrt_gemm_mma``, 3xTF32 tensor-core
tiles (each operand split as hi + lo in tf32, three products per GEMM),
for at least ``LRT_MMA_MIN_ROWS`` rows; ``lrt_gemm_stream``, a thread
per output column streaming mu and sigma, for everything else (the
head's M 4).  Both read x as f32 or bf16 and mu/sigma as f32.  The
single draw's plain version is ``ref.bayes_matmul``.  The sampled GEMM's
plain version below follows the kernel's loop — W_s formed per (bk, bn)
tile, the variates drawn per tile from the element's own counter, row
blocks replayed — so masking and stream keying are checked on the CPU.
Its tile sizes are arguments: the stream must not depend on them.  The
LRT GEMMs' plain versions form the mean and variance GEMMs once and then
draw the epilogue's variates per column tile, as the kernels do per
column.  Every plain version takes ``split="tf32x3"`` (or ``"tf32"``,
one pass) to form its products as the tensor-core kernels do.
``ops.py`` picks the kernel or the plain version by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches, rng

MAX_SAMPLES = 16     # the fused kernels keep S accumulators per output
# the least M that takes the tensor-core weight-space kernel.  Its time is
# flat below 128 rows (one row block; the draws set it), and it was the
# faster kernel at every point of chip_smoke.py's route sweep (both
# kernels at M 8-128 with S 10, and at S 1-16 with M 128)
BAYES_MMA_MIN_ROWS = 1
BAYES_ROUTES = ("simt", "mma")   # the C entry points' route argument
# rows of a block's output tile in each weight-space kernel: rows in
# different blocks draw their W_s separately, and must see the same one
BAYES_TILE_ROWS = {"simt": 64, "mma": 128}
MAX_LRT_SAMPLES = 1024   # the LRT kernels loop over S in their epilogue
# the least M that takes the tensor-core LRT kernel.  Its time is flat
# below 32 rows (one 32-row tile); the streaming kernel's doubles where
# its row block grows from 8 to 16 rows (M 9), and below that it is the
# faster of the two at qwen2-1.5B's head width (chip_smoke.py's route
# sweep times both at M 8, 9, 16, 32 and 64)
LRT_MMA_MIN_ROWS = 9
LRT_ROUTES = ("stream", "mma")   # the C entry point's route argument
PLAIN_BK = 128       # the plain version's default tiles (any tile gives
PLAIN_BN = 256       # the same variates; the kernel uses its own)


# ---------------------------------------------------------------------------
# plain version of the sampled GEMM (the kernel's tile loop, in PyTorch)
# ---------------------------------------------------------------------------

def bayes_matmul_sampled_plain(x: torch.Tensor, mu: torch.Tensor,
                               sigma: torch.Tensor, *, num_samples: int,
                               eps: torch.Tensor | None = None,
                               seed: int = 0, bm: int | None = None,
                               bk: int = PLAIN_BK, bn: int = PLAIN_BN,
                               split: str | None = None) -> torch.Tensor:
    """(S, M, N) f32.  eps=None draws each tile's variates from the
    TAG_BAYES stream keyed by seed, once per row block of ``bm`` rows
    (all rows by default), as the kernels do.  ``split`` forms each tile's
    x @ W_s from tf32 parts as the tensor-core kernel does (see
    ``_split_matmul``); None is the f32 version."""
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
                y[:, m0:m1, n0:n1] += _split_matmul(x[None, m0:m1, k0:k1],
                                                    w, split)
    return y


# ---------------------------------------------------------------------------
# plain versions of the LRT GEMMs
# ---------------------------------------------------------------------------

def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to tf32 as ``cvt.rna.tf32.f32`` rounds: to 10
    mantissa bits, to nearest with ties away from zero (half an ulp added
    to the magnitude, the low 13 bits cleared); NaN and infinities kept."""
    bits = v.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
    r = mag.view(torch.float32)
    r = torch.where(bits < 0, -r, r)
    return torch.where(torch.isfinite(v), r, v)


def tf32_truncate(v: torch.Tensor) -> torch.Tensor:
    """f32 values truncated to tf32 (the low 13 bits cleared), as a
    tensor-core product reads an f32 operand; NaN and infinities kept."""
    r = (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(v), r, v)


def _split_matmul(a: torch.Tensor, b: torch.Tensor, split: str | None):
    """a @ b in f32 (split None), or as the tensor-core kernel forms it:
    one pass of tf32 operands (``"tf32"``), or three (``"tf32x3"``: each
    operand as hi = tf32_round(v) plus lo = tf32_truncate(v - hi), summed
    as lo@hi' + hi@lo' + hi@hi')."""
    if split is None:
        return a @ b
    ah, bh = tf32_round(a), tf32_round(b)
    if split == "tf32":
        return ah @ bh
    if split != "tf32x3":
        raise ValueError(f"split must be None, 'tf32' or 'tf32x3', got "
                         f"{split!r}")
    al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def lrt_matmul_sampled_plain(x: torch.Tensor, mu: torch.Tensor,
                             sigma: torch.Tensor, *, num_samples: int,
                             xi: torch.Tensor | None = None, seed: int = 0,
                             bn: int = PLAIN_BN,
                             split: str | None = None) -> torch.Tensor:
    """(S, M, N) f32: the mean and variance GEMMs once, then S outputs
    per column tile of ``bn``; xi=None draws each tile's variates from the
    TAG_LRT stream keyed by seed.  ``split`` forms the two GEMMs from
    tf32-rounded operands as the tensor-core kernel does (x*x and
    sigma*sigma squared in f32 first); None is the f32 version."""
    x32 = x.float()
    sg = sigma.float()
    mean = _split_matmul(x32, mu.float(), split)
    std = torch.sqrt(torch.clamp(_split_matmul(x32 * x32, sg * sg, split),
                                 min=0.0))
    M, N = mean.shape
    dev = x.device
    rows = torch.arange(M, dtype=torch.int64, device=dev)
    y = torch.empty((num_samples, M, N), dtype=torch.float32, device=dev)
    for n0 in range(0, N, bn):
        n1 = min(n0 + bn, N)
        if xi is None:
            e = rng.lrt_normal(seed, num_samples, rows,
                               torch.arange(n0, n1, dtype=torch.int64,
                                            device=dev))
        else:
            e = xi[:, :, n0:n1].float()
        y[:, :, n0:n1] = mean[None, :, n0:n1] + std[None, :, n0:n1] * e
    return y


def lrt_matmul_plain(x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                     xi: torch.Tensor, *,
                     split: str | None = None) -> torch.Tensor:
    """One draw with an explicit (M, N) xi -> (M, N) f32."""
    return lrt_matmul_sampled_plain(x, mu, sigma, num_samples=1,
                                    xi=xi[None], split=split)[0]


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _fn(name: str):
    fn = getattr(build.load("bayes_matmul"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, ctypes.c_uint32, p, i, i, i, i, p]
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


def bayes_route(M: int, K: int, N: int, S: int, x: torch.Tensor,
                mu: torch.Tensor, sigma: torch.Tensor,
                eps: torch.Tensor | None = None) -> str:
    """Which weight-space kernel a CUDA call launches, from the f32
    contiguous operands the kernel reads: ``"mma"`` (3xTF32 tensor-core
    tiles) where M is at least ``BAYES_MMA_MIN_ROWS``, 1 <= S <=
    ``MAX_SAMPLES``, N a multiple of 4 and mu, sigma and eps start on
    16-byte boundaries (the kernel's 16-byte ``cp.async`` copies of their
    rows), else ``"simt"``.  K and x's alignment do not route: x rows off
    a 16-byte boundary are copied 4 bytes at a time."""
    if M < BAYES_MMA_MIN_ROWS or not 1 <= S <= MAX_SAMPLES or N % 4:
        return "simt"
    if any(t.data_ptr() % 16 for t in (mu, sigma, eps) if t is not None):
        return "simt"
    return "mma"


def _launch(kernel, xs, S, seed, y, M, K, N, route):
    """Launches the kernel of ``route`` (by default ``bayes_route``'s)
    behind entry point ``kernel`` and counts it."""
    x, mu, sigma, eps = xs
    if route is None:
        route = bayes_route(M, K, N, S, x, mu, sigma, eps)
    elif route not in BAYES_ROUTES:
        raise ValueError(f"route must be one of {BAYES_ROUTES}, got "
                         f"{route!r}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn(f"repro_{kernel}")(
            x.data_ptr(), mu.data_ptr(), sigma.data_ptr(),
            eps.data_ptr() if eps is not None else None, S, seed,
            y.data_ptr(), M, K, N, BAYES_ROUTES.index(route), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    launches.COUNTS[kernel] += 1
    return y


def bayes_matmul_cuda(x, mu, sigma, eps, *,
                      route: str | None = None) -> torch.Tensor:
    """One draw with an explicit (K, N) eps -> (M, N) f32.  ``route``
    ("simt" or "mma") overrides ``bayes_route``, for tests and
    ``chip_smoke.py`` only; "mma" on operands the kernel does not take
    raises."""
    M, K, N, xs = _operands(x, mu, sigma, eps, lambda k, n: (k, n))
    if xs[3] is None:
        raise ValueError("bayes_matmul needs an explicit eps")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    return _launch("bayes_matmul", xs, 1, 0, y, M, K, N, route)


def bayes_matmul_sampled_cuda(x, mu, sigma, *, num_samples: int,
                              eps=None, seed: int = 0,
                              route: str | None = None) -> torch.Tensor:
    """S draws in one pass -> (S, M, N) f32; eps (S, K, N) or None for
    the in-kernel TAG_BAYES stream keyed by seed.  ``route`` as for
    ``bayes_matmul_cuda``."""
    S = num_samples
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"num_samples must be in [1, {MAX_SAMPLES}], got "
                         f"{S}")
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be 32-bit unsigned, got {seed}")
    M, K, N, xs = _operands(x, mu, sigma, eps, lambda k, n: (S, k, n))
    y = torch.empty((S, M, N), dtype=torch.float32, device=x.device)
    return _launch("bayes_matmul_sampled", xs, S, seed, y, M, K, N, route)


def lrt_route(M: int, K: int, N: int, x: torch.Tensor, mu: torch.Tensor,
              sigma: torch.Tensor, xi: torch.Tensor | None = None) -> str:
    """Which LRT kernel a CUDA call launches, from the operands as the
    caller passes them: ``"mma"`` (3xTF32 tensor-core tiles) where M is at
    least ``LRT_MMA_MIN_ROWS``, K a multiple of 4 for f32 x (of 8 for bf16
    x), N a multiple of 4 and every operand starts on a 16-byte boundary
    (what the kernel's 16-byte ``cp.async`` copies of whole rows need),
    else ``"stream"``."""
    if M < LRT_MMA_MIN_ROWS or K % (16 // x.element_size()) or N % 4:
        return "stream"
    if any(t.data_ptr() % 16 for t in (x, mu, sigma, xi) if t is not None):
        return "stream"
    return "mma"


def _lrt_fn():
    fn = build.load("bayes_matmul").repro_lrt_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, ctypes.c_uint32, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _lrt_launch(count: str, x, mu, sigma, xi, S: int, seed: int,
                route: str | None):
    """Checks the operands and launches the LRT kernel of ``route`` (by
    default ``lrt_route``'s) -> (S, M, N) f32."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{count} needs CUDA tensors, got {dev}")
    if x.dim() != 2 or mu.dim() != 2:
        raise ValueError(f"x must be (M, K) and mu (K, N), got "
                         f"{tuple(x.shape)}, {tuple(mu.shape)}")
    M, K = x.shape
    N = mu.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or "
                        "bfloat16")
    for t, name, shape in ((mu, "mu", (K, N)), (sigma, "sigma", (K, N)),
                           (xi, "xi", (S, M, N))):
        if t is None:
            continue
        _check(t, name, shape, dev)
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if not 1 <= S <= MAX_LRT_SAMPLES:
        raise ValueError(f"num_samples must be in [1, {MAX_LRT_SAMPLES}], "
                         f"got {S}")
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be 32-bit unsigned, got {seed}")
    if route is None:
        route = lrt_route(M, K, N, x, mu, sigma, xi)
    elif route not in LRT_ROUTES:
        raise ValueError(f"route must be one of {LRT_ROUTES}, got {route!r}")
    x, mu, sigma = (t.contiguous() for t in (x, mu, sigma))
    xi = xi.contiguous() if xi is not None else None
    y = torch.empty((S, M, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lrt_fn()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                       mu.data_ptr(), sigma.data_ptr(),
                       xi.data_ptr() if xi is not None else None, S, seed,
                       y.data_ptr(), M, K, N, LRT_ROUTES.index(route), stream)
    if rc != 0:
        raise RuntimeError(f"{count} kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    launches.COUNTS[count] += 1
    return y


def lrt_matmul_cuda(x, mu, sigma, xi, *, route: str | None = None
                    ) -> torch.Tensor:
    """One draw with an explicit (M, N) xi -> (M, N) f32.  ``route``
    ("stream" or "mma") overrides ``lrt_route``, for tests and
    ``chip_smoke.py`` only; "mma" on operands the kernel does not take
    raises."""
    if xi is None or xi.dim() != 2:
        raise ValueError("lrt_matmul needs an explicit (M, N) xi")
    return _lrt_launch("lrt_matmul", x, mu, sigma, xi[None], 1, 0, route)[0]


def lrt_matmul_sampled_cuda(x, mu, sigma, *, num_samples: int, xi=None,
                            seed: int = 0,
                            route: str | None = None) -> torch.Tensor:
    """S draws from one mean and one variance GEMM -> (S, M, N) f32; xi
    (S, M, N) or None for the in-kernel TAG_LRT stream keyed by seed.
    ``route`` as for ``lrt_matmul_cuda``."""
    return _lrt_launch("lrt_matmul_sampled", x, mu, sigma, xi, num_samples,
                       seed, route)
