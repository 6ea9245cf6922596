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

The kernel (``csrc/uncertainty_head.cu``) streams mu/sigma once, as a
split-K stream planned from the shape alone (``head_plan``): (vocab
tile, K slice) work items whose (mean, var) partials are summed in slice
order, then per-128-column-tile online softmax stats, a merge, and a
second pass that regenerates the variates.  The plain version below
follows the same loop — the (M, V) mean and variance as a sum over the
plan's K slices in slice order, 128-column tiles with the ragged tail
masked to -1e30 (all tiles as one (S, M, NT, tile) tensor), per-tile
(max, Z, A), a merge, a second sweep for p-bar, H and the argmax, then
the final merge — so slices, masking, merges and Philox replay are
checked on the CPU.

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
import dataclasses
import functools

import torch

from repro_torch.kernels import build, launches, rng

TILE = 128           # vocab columns per softmax tile (the stats' blocks)
MAX_SAMPLES = 64     # the kernel's bound on S
_NEG = -1e30

# The stream (csrc/uncertainty_head.cu, head_stream): a block covers
# STREAM_TILE vocab columns, STREAM_COLS a consumer thread, with 128
# consumer threads and one producer warp; a ring of STREAM_STAGES stages
# of STREAM_STAGE_ROWS rows of mu and of sigma; x staged once per K slice
# in at most STREAM_X_BYTES of shared memory.
STREAM_TILE = 256
STREAM_COLS = 2
STREAM_STAGE_ROWS = 8
STREAM_STAGES = 4
STREAM_X_BYTES = 40 * 1024
STREAM_ROWS = (4, 8, 16)          # the row templates
ROUTES = ("bulk", "async8", "async4")   # the C entry point's route argument
SMS = 132                         # streaming multiprocessors of an H100
STREAM_BLOCKS_PER_SM = 2          # resident stream blocks an SM
PLAN_BALANCE = 1.1                # busiest SM's bytes over the mean, at most
PLAN_WAVES = 0.9                  # blocks over their waves' slots, at least
PLAN_SHORT_SLICE = 512            # K rows a slice whose partial wave is cheap
PLAN_SCRATCH = 0.05               # split-K scratch over the weight bytes


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """How the stream covers an (M, K) x (K, V) head: ``rows`` rows of x a
    block (a row template, ``groups`` of them), ``tile`` vocab columns a
    block and ``cols`` a thread, K cut into ``splits`` slices of
    ``k_slice`` rows (the last one ragged), and the copy ``route``."""

    M: int
    K: int
    V: int
    rows: int
    k_slice: int
    route: str
    tile = STREAM_TILE
    cols = STREAM_COLS

    @property
    def groups(self) -> int:
        return -(-self.M // self.rows)

    @property
    def splits(self) -> int:
        return -(-self.K // self.k_slice)

    @property
    def tiles(self) -> int:
        return -(-self.V // self.tile)

    @property
    def blocks(self) -> int:
        """Work items, one block each: (row group, K slice, tile), the
        tile fastest."""
        return self.groups * self.splits * self.tiles

    def items(self):
        """Each block's (rows, K rows, columns) as half-open ranges, in
        block order."""
        for g in range(self.groups):
            rows = (g * self.rows, min((g + 1) * self.rows, self.M))
            for s in range(self.splits):
                ks = (s * self.k_slice, min((s + 1) * self.k_slice, self.K))
                for t in range(self.tiles):
                    yield rows, ks, (t * self.tile,
                                     min((t + 1) * self.tile, self.V))

    def sm_bytes(self) -> list[int]:
        """Bytes of mu/sigma each SM streams, block i dealt to SM i % 132
        (the order in which the card hands out the first blocks)."""
        load = [0] * SMS
        for i, (_, (k0, k1), (c0, c1)) in enumerate(self.items()):
            load[i % SMS] += (k1 - k0) * (c1 - c0) * 8
        return load

    @property
    def balance(self) -> float:
        """The busiest SM's bytes over the mean an SM."""
        load = self.sm_bytes()
        return max(load) * SMS / sum(load)

    @property
    def waves(self) -> float:
        """The blocks over the resident-block slots (two an SM) of the
        waves they take: 1.0 for whole waves."""
        slots = STREAM_BLOCKS_PER_SM * SMS
        return self.blocks / (slots * -(-self.blocks // slots))

    @property
    def scratch_bytes(self) -> int:
        """The (splits, 2, M, V) f32 partials."""
        return self.splits * 2 * self.M * self.V * 4

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a stream block: the barriers, the ring
        and the staged x."""
        ring = STREAM_STAGES * STREAM_STAGE_ROWS * self.tile * 2 * 4
        return 128 + ring + self.rows * self.k_slice * 4


def head_route(V: int, align: int = 16) -> str:
    """The stream's copy route, by alignment: ``"bulk"`` (TMA bulk copies
    of whole rows, 16 bytes aligned) where V % 4 == 0 and mu/sigma start on
    16 bytes; else ``cp.async`` of 8 bytes (``"async8"``, every row on
    8 bytes: V even) or of 4 (``"async4"``)."""
    if V % 4 == 0 and align % 16 == 0:
        return "bulk"
    return "async8" if V % 2 == 0 and align % 8 == 0 else "async4"


@functools.lru_cache(maxsize=256)
def head_plan(M: int, K: int, V: int, align: int = 16) -> HeadPlan:
    """The stream's plan from the shape alone (and the operands' alignment,
    ``align`` bytes): the smallest row template that holds M (M above 16
    takes several groups), and the fewest K slices whose blocks give the
    busiest SM at most ``PLAN_BALANCE`` times the mean bytes and either
    fill the card's two blocks an SM in whole waves or near them
    (``waves`` at least ``PLAN_WAVES``) or are short (at most
    ``PLAN_SHORT_SLICE`` rows: on an H100 a partial last wave of such
    blocks cost less than more slices), keeping the scratch under
    ``PLAN_SCRATCH`` of the weight bytes (the first candidate, the fewest
    slices the staged x allows, is taken whatever its scratch); failing
    that, the best balanced candidate."""
    if min(M, K, V) < 1:
        raise ValueError(f"empty head: M {M}, K {K}, V {V}")
    rows = next((r for r in STREAM_ROWS if M <= r), STREAM_ROWS[-1])
    R = STREAM_STAGE_ROWS
    kl_max = STREAM_X_BYTES // (4 * rows) // R * R
    best = None
    seen = set()
    for want in range(-(-K // kl_max), K + 1):
        k_slice = -(-(-(-K // want)) // R) * R
        if k_slice in seen:
            continue
        seen.add(k_slice)
        plan = HeadPlan(M, K, V, rows, k_slice, head_route(V, align))
        if best is not None and plan.splits * M >= PLAN_SCRATCH * K:
            break
        if best is None or plan.balance < best.balance:
            best = plan
        if plan.balance <= PLAN_BALANCE and (
                plan.waves >= PLAN_WAVES or k_slice <= PLAN_SHORT_SLICE):
            return plan
    return best


# ---------------------------------------------------------------------------
# plain versions (the kernels' loops, in PyTorch)
# ---------------------------------------------------------------------------

def _tiles(logits: torch.Tensor, tile: int) -> torch.Tensor:
    """(S, M, V) logits as (S, M, NT, tile) tiles, the ragged last tile's
    padding masked to -1e30."""
    S, M, V = logits.shape
    nt = -(-V // tile)
    out = torch.full((S, M, nt * tile), _NEG, dtype=torch.float32,
                     device=logits.device)
    out[:, :, :V] = logits
    return out.view(S, M, nt, tile)


def _logits(mean, std, xi, seed, step, num_samples):
    """The (S, M, V) logits mean + std * variates (xi, or the head stream
    keyed by (seed, step))."""
    M, V = mean.shape
    if xi is None:
        e = rng.head_normal(seed, step, num_samples, M,
                            torch.arange(V, dtype=torch.int64,
                                         device=mean.device))
    else:
        e = xi.float()
    return mean[None] + std[None] * e


def _head_readout(pass1, pass2, V: int, S: int) -> dict[str, torch.Tensor]:
    """The head's tile loop over (S, M, NT, tile) logits tiles (padding
    masked), ``pass1`` and ``pass2`` the tiles each pass reads, all tiles
    at once: per-tile (max, Z, A), their merge, then p-bar, H and the
    argmax per tile and the final merge."""
    tile = pass1.shape[-1]
    tmax = pass1.max(dim=-1).values                          # (S, M, NT)
    e = torch.exp(pass1 - tmax[..., None])
    tz = e.sum(dim=-1)
    ta = (e * pass1).sum(dim=-1)
    # merge the per-tile partials (global max first, then rescaled sums)
    gmx = tmax.max(dim=-1).values                            # (S, M)
    c = torch.exp(tmax - gmx[..., None])
    z = (tz * c).sum(dim=-1)
    a = (ta * c).sum(dim=-1)
    # pass 2: p-bar per tile
    pbar = (torch.exp(pass2 - gmx[..., None, None])
            / z[..., None, None]).sum(dim=0) / S             # (M, NT, tile)
    cols = torch.arange(pass2.shape[-2] * tile,
                        device=pass2.device).view(-1, tile)  # (NT, tile)
    valid = cols < V
    th = torch.where(valid, pbar * torch.log(pbar + 1e-12), 0.0).sum(dim=-1)
    tbest, idx = torch.where(valid, pbar, -1.0).max(dim=-1)  # (M, NT)
    tidx = idx + cols[:, 0]
    h = -th.sum(dim=-1)
    p_max, j = tbest.max(dim=-1)          # first tile wins a tie
    pred = tidx.gather(-1, j[:, None])[:, 0]
    se = (gmx + torch.log(z) - a / z).mean(dim=0)
    return {"H": h, "SE": se, "MI": torch.clamp(h - se, min=0.0),
            "pred": pred.to(torch.int32), "p_max": p_max}


def _mean_std(x, mu, sigma, k_slice: int):
    """The (M, V) mean and std of the LRT logits: one sweep over mu/sigma
    in K slices of ``k_slice`` rows, the slices' partials summed in slice
    order; std = sqrt(max(var, 0)), a NaN variance staying NaN."""
    x32 = x.float()
    x2 = x32 * x32
    mean = var = None
    for k0 in range(0, x.shape[1], k_slice):
        k1 = k0 + k_slice
        pm = x32[:, k0:k1] @ mu[k0:k1].float()
        pv = x2[:, k0:k1] @ (sigma[k0:k1].float() ** 2)
        mean = pm if mean is None else mean + pm
        var = pv if var is None else var + pv
    return mean, torch.sqrt(torch.clamp(var, min=0.0))


def _k_slice(x, mu, plan: HeadPlan | None) -> int:
    return (plan or head_plan(x.shape[0], x.shape[1], mu.shape[1])).k_slice


def uncertainty_head_plain(x: torch.Tensor, mu: torch.Tensor,
                           sigma: torch.Tensor, *, num_samples: int,
                           xi: torch.Tensor | None = None, seed: int = 0,
                           step: int | torch.Tensor = 0, step_offset: int = 0,
                           tile: int = TILE, plan: HeadPlan | None = None
                           ) -> dict[str, torch.Tensor]:
    """The fused head: the stream keeps the (M, V) mean/std (K slices of
    ``plan``, by default ``head_plan``'s), both passes rebuild each logits
    tile from it and the (replayed) variates."""
    mean, std = _mean_std(x, mu, sigma, _k_slice(x, mu, plan))
    tiles = _tiles(_logits(mean, std, xi, seed, int(step) + step_offset,
                           num_samples), tile)
    return _head_readout(tiles, tiles, mu.shape[1], num_samples)


def uncertainty_head_two_pass_plain(x: torch.Tensor, mu: torch.Tensor,
                                    sigma: torch.Tensor, xi: torch.Tensor,
                                    *, tile: int = TILE,
                                    plan: HeadPlan | None = None
                                    ) -> dict[str, torch.Tensor]:
    """The two-pass head with an explicit (S, M, V) xi: pass 1 writes the
    logits tiles into the (S, M, V) scratch, pass 2 re-reads it."""
    mean, std = _mean_std(x, mu, sigma, _k_slice(x, mu, plan))
    S, M, V = xi.shape
    scratch = _logits(mean, std, xi, 0, 0, S)
    return _head_readout(_tiles(scratch, tile), _tiles(scratch, tile), V, S)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _fn():
    fn = build.load("uncertainty_head").repro_uncertainty_head
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        u = ctypes.c_uint32
        fn.argtypes = [p, i, i, i, p, p, i, p, i, u, p, u, i, i, i, i,
                       p, p, p, p, p, p, p, p, p, p, p, p]
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
        fn.argtypes = [p, i, i, i, p, p, i, p, i, i, i, i, i,
                       p, p, p, p, p, p, p, p, p, p, p]
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


def _alignment(*ts: torch.Tensor) -> int:
    """The largest of 16, 8, 4 bytes on which every tensor starts."""
    return next(a for a in (16, 8, 4, 1)
                if all(t.data_ptr() % a == 0 for t in ts))


def _launch_head(kernel: str, x, mu, sigma, xi, S: int, seed: int = 0,
                 step: int | torch.Tensor = 0, step_offset: int = 0,
                 plan: HeadPlan | None = None) -> dict[str, torch.Tensor]:
    """Checks the operands, allocates the scratch and the outputs, and
    launches the fused head (``kernel`` "uncertainty_head") or the two-pass
    head ("uncertainty_head_two_pass") with ``plan`` (by default
    ``head_plan`` of the shape and of mu/sigma's alignment; a plan whose
    route the alignment does not allow is refused by the kernel)."""
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
    if plan is None:
        plan = head_plan(M, K, V, _alignment(mu, sigma))
    elif (plan.M, plan.K, plan.V) != (M, K, V):
        raise ValueError(f"the plan is for {(plan.M, plan.K, plan.V)}, the "
                         f"operands are {(M, K, V)}")
    nt = -(-V // TILE)
    # scratch dropped on return while the kernels may still run is safe:
    # the caching allocator hands it out again only to work queued after
    # them on this stream
    f32 = dict(dtype=torch.float32, device=dev)
    part0 = torch.empty((plan.splits, 2, M, V), **f32)
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
    shape = (TILE, plan.rows, plan.k_slice, ROUTES.index(plan.route),
             part0.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "uncertainty_head_two_pass":
            logits = torch.empty((S, M, V), **f32)
            rc = _two_pass_fn()(*head, *shape, logits.data_ptr(), *tail,
                                stream)
        else:
            mean = torch.empty((M, V), **f32)
            std = torch.empty((M, V), **f32)
            rc = _fn()(*head, seed, *_step_operand(step, step_offset, dev),
                       *shape, mean.data_ptr(), std.data_ptr(), *tail,
                       stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    launches.COUNTS[kernel] += 1
    return out


def uncertainty_head_cuda(x: torch.Tensor, mu: torch.Tensor,
                          sigma: torch.Tensor, *, num_samples: int,
                          xi: torch.Tensor | None = None, seed: int = 0,
                          step: int | torch.Tensor = 0,
                          step_offset: int = 0, plan: HeadPlan | None = None
                          ) -> dict[str, torch.Tensor]:
    """The fused head; xi (S, M, V) or None for the in-kernel stream keyed
    by (seed, step + step_offset), ``step`` an int or a one-element int32
    device tensor that the kernel reads (never read back to the host);
    ``plan`` forces a stream plan (tests), by default ``head_plan``'s."""
    return _launch_head("uncertainty_head", x, mu, sigma, xi, num_samples,
                        seed, step, step_offset, plan)


def uncertainty_head_two_pass_cuda(x: torch.Tensor, mu: torch.Tensor,
                                   sigma: torch.Tensor, xi: torch.Tensor,
                                   *, plan: HeadPlan | None = None
                                   ) -> dict[str, torch.Tensor]:
    """The two-pass head with an explicit (S, M, V) xi; the (S, M, V)
    logits scratch lives for the call."""
    if xi is None or xi.dim() != 3:
        raise ValueError("the two-pass head needs an explicit (S, M, V) xi")
    return _launch_head("uncertainty_head_two_pass", x, mu, sigma, xi,
                        xi.shape[0], plan=plan)
