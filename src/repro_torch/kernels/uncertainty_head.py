"""Fused Bayesian LM head + uncertainty readout: the CUDA kernel and its
plain PyTorch version.

Counterpart of ``repro.kernels.uncertainty_head.uncertainty_head_fused_
kernel``.  For x (M, K) and the variational head mu/sigma (K, V) it takes
S LRT draws ``x@mu + sqrt((x*x)@sigma^2) * xi_s`` and returns per row
H, SE, MI, pred (argmax of the mean predictive, lowest index on ties) and
p_max.  The variates xi are either an explicit (S, M, V) operand (the
validation path) or drawn in place from the Philox stream keyed by
(seed, step) (``rng.py``), which never exists in memory.

The kernel (``csrc/uncertainty_head.cu``) reads mu/sigma once, keeps the
(M, V) mean and std in a scratch, merges per-vocab-tile online softmax
stats, and regenerates the variates in its second pass.  The plain
version below follows the same loop — 128-column tiles with the ragged
tail masked to -1e30, per-tile (max, Z, A), a merge, a second sweep for
p-bar, H and the argmax, then the final merge — so masking, merges and
Philox replay are checked on the CPU.  ``ops.py`` picks between them by
the tensor's device.

sigma is ``softplus(rho)``; the serving parameters are frozen, so the
port computes it once when they are loaded (``models/registry.py``)
instead of inside every decode step.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches, rng

TILE = 128           # vocab columns per tile (the kernel's block width)
MAX_SAMPLES = 64     # the kernel's bound on S
_NEG = -1e30


# ---------------------------------------------------------------------------
# plain version (the kernel's loop, in PyTorch)
# ---------------------------------------------------------------------------

def _tile_logits(mean, std, xi, seed, step, num_samples, c0, tile):
    """(S, M, tile) logits of columns [c0, c0 + tile), padding masked."""
    M, V = mean.shape
    c1 = min(c0 + tile, V)
    cols = torch.arange(c0, c1, dtype=torch.int64, device=mean.device)
    if xi is None:
        e = rng.head_normal(seed, step, num_samples, M, cols)
    else:
        e = xi[:, :, c0:c1].float()
    logits = torch.full((num_samples, M, tile), _NEG, dtype=torch.float32,
                        device=mean.device)
    logits[:, :, :c1 - c0] = mean[None, :, c0:c1] + std[None, :, c0:c1] * e
    return logits, c1 - c0


def uncertainty_head_plain(x: torch.Tensor, mu: torch.Tensor,
                           sigma: torch.Tensor, *, num_samples: int,
                           xi: torch.Tensor | None = None, seed: int = 0,
                           step: int = 0,
                           tile: int = TILE) -> dict[str, torch.Tensor]:
    M, _ = x.shape
    V = mu.shape[1]
    S = num_samples
    x32 = x.float()
    # pass 1: one sweep over mu/sigma -> the (M, V) mean/std scratch
    mean = x32 @ mu.float()
    std = torch.sqrt(torch.clamp((x32 * x32) @ (sigma.float() ** 2),
                                 min=0.0))
    starts = range(0, V, tile)
    tmax, tz, ta = [], [], []
    for c0 in starts:
        logits, _ = _tile_logits(mean, std, xi, seed, step, S, c0, tile)
        mx = logits.max(dim=-1).values                       # (S, M)
        e = torch.exp(logits - mx[..., None])
        tmax.append(mx)
        tz.append(e.sum(dim=-1))
        ta.append((e * logits).sum(dim=-1))
    # merge the per-tile partials (global max first, then rescaled sums)
    tmax, tz, ta = (torch.stack(t, dim=-1) for t in (tmax, tz, ta))
    gmx = tmax.max(dim=-1).values                            # (S, M)
    c = torch.exp(tmax - gmx[..., None])
    z = (tz * c).sum(dim=-1)
    a = (ta * c).sum(dim=-1)
    # pass 2: p-bar from the scratch + the replayed variates
    th, tbest, tidx = [], [], []
    for c0 in starts:
        logits, n = _tile_logits(mean, std, xi, seed, step, S, c0, tile)
        pbar = (torch.exp(logits - gmx[..., None]) / z[..., None]).sum(
            dim=0) / S                                       # (M, tile)
        valid = torch.arange(tile, device=x.device) < n
        th.append(torch.where(valid, pbar * torch.log(pbar + 1e-12),
                              0.0).sum(dim=-1))
        best, idx = torch.where(valid, pbar, -1.0).max(dim=-1)
        tbest.append(best)
        tidx.append(idx + c0)
    th, tbest, tidx = (torch.stack(t, dim=-1) for t in (th, tbest, tidx))
    h = -th.sum(dim=-1)
    p_max, j = tbest.max(dim=-1)          # first tile wins a tie
    pred = tidx.gather(-1, j[:, None])[:, 0]
    se = (gmx + torch.log(z) - a / z).mean(dim=0)
    return {"H": h, "SE": se, "MI": torch.clamp(h - se, min=0.0),
            "pred": pred.to(torch.int32), "p_max": p_max}


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _fn():
    fn = build.load("uncertainty_head").repro_uncertainty_head
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        u = ctypes.c_uint32
        fn.argtypes = [p, i, i, i, p, p, i, p, i, u, u, i,
                       p, p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def uncertainty_head_cuda(x: torch.Tensor, mu: torch.Tensor,
                          sigma: torch.Tensor, *, num_samples: int,
                          xi: torch.Tensor | None = None, seed: int = 0,
                          step: int = 0) -> dict[str, torch.Tensor]:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"uncertainty_head_cuda needs CUDA tensors, got {dev}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    V = mu.shape[-1]
    S = num_samples
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"num_samples must be in [1, {MAX_SAMPLES}], got {S}")
    if not (0 <= seed < 2 ** 32 and 0 <= step < 2 ** 32):
        raise ValueError(f"seed/step must be 32-bit unsigned, got "
                         f"{seed}/{step}")
    _check(x, "x", (torch.float32, torch.bfloat16), (M, K), dev)
    _check(mu, "mu", (torch.float32,), (K, V), dev)
    _check(sigma, "sigma", (torch.float32,), (K, V), dev)
    if xi is not None:
        _check(xi, "xi", (torch.float32,), (S, M, V), dev)
    nt = -(-V // TILE)
    # scratch dropped on return while the kernels may still run is safe:
    # the caching allocator hands it out again only to work queued after
    # them on this stream
    f32 = dict(dtype=torch.float32, device=dev)
    mean = torch.empty((M, V), **f32)
    std = torch.empty((M, V), **f32)
    part1 = torch.empty((3, S, M, nt), **f32)
    stats = torch.empty((3, S, M), **f32)
    part2 = torch.empty((3, M, nt), **f32)
    out = {n: torch.empty((M,), **f32) for n in ("H", "SE", "MI", "p_max")}
    out["pred"] = torch.empty((M,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16), M, K,
                   mu.data_ptr(), sigma.data_ptr(), V,
                   xi.data_ptr() if xi is not None else None, S, seed, step,
                   TILE, mean.data_ptr(), std.data_ptr(), part1.data_ptr(),
                   stats.data_ptr(), part2.data_ptr(), out["H"].data_ptr(),
                   out["SE"].data_ptr(), out["MI"].data_ptr(),
                   out["p_max"].data_ptr(), out["pred"].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"uncertainty_head kernel launch failed: CUDA "
                           f"error {rc}")
    launches.COUNTS["uncertainty_head"] += 1
    return out
