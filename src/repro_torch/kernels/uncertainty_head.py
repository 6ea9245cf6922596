"""Bayesian LM head + uncertainty readout, fused and two-pass: the CUDA
kernels and their plain PyTorch versions.

Counterpart of ``repro.kernels.uncertainty_head``: the fused head
(``uncertainty_head_fused_kernel``, the serving path's) and the two-pass
head (``uncertainty_head_kernel``, behind ``ops.uncertainty_head``).  For
x (M, K) and the variational head mu/sigma (K, V) both take
S LRT draws ``x@mu + sqrt((x*x)@sigma^2) * xi_s`` and returns per row
H, SE, MI, pred (argmax of the mean predictive, lowest index on ties) and
p_max.  The variates xi are either an explicit (S, M, V) operand (the
validation path) or drawn in place from the Philox stream keyed by
(seed, step) (``rng.py``), which never exists in memory.  ``step`` is a
Python int or a one-element int32 tensor on the operands' device, plus
``step_offset``: the kernel reads the tensor in device memory, so a CUDA
graph that captured the call replays it at whatever step was written
there (``launch/engine/runner.py``).  The plain version takes the step
as an int.

The kernel (``csrc/uncertainty_head.cu``) reads mu/sigma once, keeps the
(M, V) mean and std in a scratch, merges per-vocab-tile online softmax
stats, and regenerates the variates in its second pass.  The plain
version below follows the same loop — 128-column tiles with the ragged
tail masked to -1e30, per-tile (max, Z, A), a merge, a second sweep for
p-bar, H and the argmax, then the final merge — so masking, merges and
Philox replay are checked on the CPU.

The two-pass head takes an explicit xi only.  Its pass 1 writes the
(S, M, V) logits scratch (V unpadded) with the per-tile stats, and its
pass 2 re-reads the scratch instead of rebuilding the logits; the
merges and the argmax rule are the fused head's.  Its plain version runs
the same tile loop around a scratch, so it gives the fused plain
version's numbers bit for bit.  ``ops.py`` picks between kernel and
plain version by the tensor's device.

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
# plain versions (the kernels' loops, in PyTorch)
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


def _head_readout(pass1_tile, pass2_tile, V: int, S: int, tile: int,
                  dev) -> dict[str, torch.Tensor]:
    """The head's tile loop over ``(S, M, tile)`` logits tiles (padding
    masked), given by ``pass1_tile(c0)`` and ``pass2_tile(c0)``: per-tile
    (max, Z, A), their merge, then p-bar, H and the argmax per tile and
    the final merge."""
    starts = range(0, V, tile)
    tmax, tz, ta = [], [], []
    for c0 in starts:
        logits = pass1_tile(c0)
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
    # pass 2: p-bar per tile
    th, tbest, tidx = [], [], []
    for c0 in starts:
        logits = pass2_tile(c0)
        n = min(tile, V - c0)
        pbar = (torch.exp(logits - gmx[..., None]) / z[..., None]).sum(
            dim=0) / S                                       # (M, tile)
        valid = torch.arange(tile, device=dev) < n
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


def _mean_std(x, mu, sigma):
    """The (M, V) mean and std of the LRT logits: one sweep over mu/sigma."""
    x32 = x.float()
    mean = x32 @ mu.float()
    std = torch.sqrt(torch.clamp((x32 * x32) @ (sigma.float() ** 2),
                                 min=0.0))
    return mean, std


def uncertainty_head_plain(x: torch.Tensor, mu: torch.Tensor,
                           sigma: torch.Tensor, *, num_samples: int,
                           xi: torch.Tensor | None = None, seed: int = 0,
                           step: int | torch.Tensor = 0, step_offset: int = 0,
                           tile: int = TILE) -> dict[str, torch.Tensor]:
    """The fused head: pass 1 keeps the (M, V) mean/std, both passes
    rebuild each logits tile from it and the (replayed) variates."""
    mean, std = _mean_std(x, mu, sigma)
    S = num_samples
    step = int(step) + step_offset

    def tile_logits(c0):
        return _tile_logits(mean, std, xi, seed, step, S, c0, tile)[0]

    return _head_readout(tile_logits, tile_logits, mu.shape[1], S, tile,
                         x.device)


def uncertainty_head_two_pass_plain(x: torch.Tensor, mu: torch.Tensor,
                                    sigma: torch.Tensor, xi: torch.Tensor,
                                    *, tile: int = TILE
                                    ) -> dict[str, torch.Tensor]:
    """The two-pass head with an explicit (S, M, V) xi: pass 1 writes each
    logits tile into the (S, M, V) scratch, pass 2 re-reads it."""
    mean, std = _mean_std(x, mu, sigma)
    S, M, V = xi.shape
    scratch = torch.empty((S, M, V), dtype=torch.float32, device=x.device)

    def write(c0):
        logits, n = _tile_logits(mean, std, xi, 0, 0, S, c0, tile)
        scratch[:, :, c0:c0 + n] = logits[:, :, :n]
        return logits

    def read(c0):
        n = min(tile, V - c0)
        logits = torch.full((S, M, tile), _NEG, dtype=torch.float32,
                            device=x.device)
        logits[:, :, :n] = scratch[:, :, c0:c0 + n]
        return logits

    return _head_readout(write, read, V, S, tile, x.device)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _fn():
    fn = build.load("uncertainty_head").repro_uncertainty_head
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        u = ctypes.c_uint32
        fn.argtypes = [p, i, i, i, p, p, i, p, i, u, p, u, i,
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


def _two_pass_fn():
    fn = build.load("uncertainty_head").repro_uncertainty_head_two_pass
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p, i, p, i, i,
                       p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


# a zero int32 per device: an int step is passed as the offset over it, so
# the kernel has one way to its step (device memory plus an offset)
_zero_step: dict[torch.device, torch.Tensor] = {}


def _step_operand(step, step_offset: int, dev) -> tuple[int, int]:
    """(device address, offset) of the head stream's step."""
    if isinstance(step, torch.Tensor):
        _check(step.reshape(-1), "step", (torch.int32,), (1,), dev)
        if not 0 <= step_offset < 2 ** 32:
            raise ValueError(f"step_offset must be 32-bit unsigned, got "
                             f"{step_offset}")
        return step.data_ptr(), step_offset
    step = step + step_offset
    if not 0 <= step < 2 ** 32:
        raise ValueError(f"step must be 32-bit unsigned, got {step}")
    zero = _zero_step.get(dev)
    if zero is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("an int step needs one call outside CUDA "
                               "graph capture first (it allocates its zero)")
        zero = _zero_step[dev] = torch.zeros((1,), dtype=torch.int32,
                                             device=dev)
    return zero.data_ptr(), step


def _launch_head(kernel: str, x, mu, sigma, xi, S: int, seed: int = 0,
                 step: int | torch.Tensor = 0,
                 step_offset: int = 0) -> dict[str, torch.Tensor]:
    """Checks the operands, allocates the scratch and the outputs, and
    launches the fused head (``kernel`` "uncertainty_head") or the two-pass
    head ("uncertainty_head_two_pass")."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {dev}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    V = mu.shape[-1]
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"num_samples must be in [1, {MAX_SAMPLES}], got {S}")
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be 32-bit unsigned, got {seed}")
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
    part1 = torch.empty((3, S, M, nt), **f32)
    stats = torch.empty((3, S, M), **f32)
    part2 = torch.empty((3, M, nt), **f32)
    out = {n: torch.empty((M,), **f32) for n in ("H", "SE", "MI", "p_max")}
    out["pred"] = torch.empty((M,), dtype=torch.int32, device=dev)
    tail = [t.data_ptr() for t in (part1, stats, part2, out["H"], out["SE"],
                                   out["MI"], out["p_max"], out["pred"])]
    head = (x.data_ptr(), int(x.dtype == torch.bfloat16), M, K,
            mu.data_ptr(), sigma.data_ptr(), V,
            xi.data_ptr() if xi is not None else None, S)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "uncertainty_head_two_pass":
            logits = torch.empty((S, M, V), **f32)
            rc = _two_pass_fn()(*head, TILE, logits.data_ptr(), *tail,
                                stream)
        else:
            mean = torch.empty((M, V), **f32)
            std = torch.empty((M, V), **f32)
            rc = _fn()(*head, seed, *_step_operand(step, step_offset, dev),
                       TILE, mean.data_ptr(), std.data_ptr(), *tail, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    launches.COUNTS[kernel] += 1
    return out


def uncertainty_head_cuda(x: torch.Tensor, mu: torch.Tensor,
                          sigma: torch.Tensor, *, num_samples: int,
                          xi: torch.Tensor | None = None, seed: int = 0,
                          step: int | torch.Tensor = 0,
                          step_offset: int = 0) -> dict[str, torch.Tensor]:
    """The fused head; xi (S, M, V) or None for the in-kernel stream keyed
    by (seed, step + step_offset), ``step`` an int or a one-element int32
    device tensor that the kernel reads (never read back to the host)."""
    return _launch_head("uncertainty_head", x, mu, sigma, xi, num_samples,
                        seed, step, step_offset)


def uncertainty_head_two_pass_cuda(x: torch.Tensor, mu: torch.Tensor,
                                   sigma: torch.Tensor, xi: torch.Tensor
                                   ) -> dict[str, torch.Tensor]:
    """The two-pass head with an explicit (S, M, V) xi; the (S, M, V)
    logits scratch lives for the call."""
    if xi is None or xi.dim() != 3:
        raise ValueError("the two-pass head needs an explicit (S, M, V) xi")
    return _launch_head("uncertainty_head_two_pass", x, mu, sigma, xi,
                        xi.shape[0])
