"""AdamW over the port's parameter trees.

Counterpart of ``repro.optim.adamw``: dtype-policied moments
(``ArchConfig.moment_dtype``), global-norm clipping, cosine / linear /
constant schedules with linear warm-up, and optional top-k gradient
compression with error feedback.  Parameters are nested dicts of tensors
(``core.tree``; a ``GaussianVariational`` contributes its ``mu`` and
``rho``), and the optimizer state is ``{"mu", "nu", "step"[, "error"]}``
with the parameters' structure.

``apply_updates`` computes each update in float32 and writes it back in
the parameter's dtype IN PLACE, under ``torch.no_grad``: a parameter
tensor keeps its address across steps (the moments too), as the JAX
package's donated buffers do.  Decoupled weight decay applies to every
leaf of two or more dimensions as stored: the layer-stacked (L, d) norms
and QKV biases decay, and so does the head's ``rho``, exactly as in the
reference.  A leaf of more than ``SLICE`` elements is updated, and
enters the global norm, a slice at a time: the update is elementwise, so
only the norm's f32 sum changes its order, and the f32 temporaries of a
full-width stacked leaf (zamba2-7b's ``in_proj`` at 48 layers holds 2.5B
elements, 10 GB a pass) stay 256 MB.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import tree as T
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as P

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SLICE = 1 << 26         # elements a pass of the update takes at a time

# the count each state's step tensor holds, kept on the host beside it:
# tensor -> (the tensor's version counter when written, the count).  A
# step reads it without a device-to-host copy, and a dry run's fake step
# tensor (``launch.dryrun``), which holds no value, still has its count;
# a tensor written by anything else (a restored checkpoint) has another
# version and is read again
_HOST_STEP = WeakIdKeyDictionary()


def step_count(state: dict) -> int:
    """The optimizer state's step as a Python int."""
    t = state["step"]
    version, n = _HOST_STEP.get(t, (None, 0))
    if version != t._version:
        n = int(t)
        _HOST_STEP[t] = (t._version, n)
    return n


def _set_step(t: torch.Tensor, n: int) -> None:
    t.fill_(n)
    _HOST_STEP[t] = (t._version, n)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 200
    total_steps: int = 10_000
    schedule: str = "cosine"         # cosine | linear | constant
    min_lr_ratio: float = 0.1
    # gradient compression (0 disables): keep top-k fraction of entries
    compress_topk: float = 0.0


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the reference computes in float32)."""
    return float(torch.tensor(x, dtype=torch.float32))


def schedule_lr(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step`` (1-based after the first update), in
    float32 arithmetic as the reference's jnp schedule."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    s = f(step)
    warm = torch.minimum(s / max(cfg.warmup_steps, 1), f(1.0))
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
            (1 + torch.cos(f(math.pi) * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * t
    else:
        decay = torch.ones_like(t)
    return float(cfg.lr * warm * decay)


def init_state(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments in ``moment_dtype`` beside every parameter leaf (and
    the error-feedback accumulator when compressing), step 0 (an int32
    scalar tensor on the parameters' device)."""
    mdt = _DTYPES[cfg.moment_dtype]
    first = T.leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    _HOST_STEP[step] = (step._version, 0)
    state = {"mu": T.zeros_like(params, mdt), "nu": T.zeros_like(params, mdt),
             "step": step}
    if cfg.compress_topk > 0:
        # float32, the dtype the reference's accumulator holds after its
        # first step
        state["error"] = T.zeros_like(params, torch.float32)
    return state


def _slices(*ts: torch.Tensor):
    """Matching flat slices of ``SLICE`` elements of same-shape tensors
    (views, so in-place writes land in the tensors), or the tensors whole
    where they are small or one is not contiguous."""
    n = ts[0].numel()
    if n <= SLICE or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, SLICE):
        yield tuple(f[i:i + SLICE] for f in flat)


def global_norm(tree: Any, mesh=None, owned: Any = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a 0-d tensor
    on the leaves' device).  Under a train ``mesh`` the leaves are the
    rank's blocks: each rank sums the leaves it ``owned``
    (``sharding.partition.owned``: one rank of every group that holds the
    same block, so a replicated leaf counts once) and the squares are
    all-reduced over the mesh."""
    leaves = T.leaves(tree)
    mine = T.leaves(owned) if mesh is not None else [True] * len(leaves)
    sq = sum((torch.sum(torch.square(s.float()))
              for x, m in zip(leaves, mine) if m for (s,) in _slices(x)),
             torch.zeros((), dtype=torch.float32, device=leaves[0].device))
    if mesh is not None:
        sq = C.all_reduce(sq, mesh.world)
    return torch.sqrt(sq)


def _clip_scale(grads: Any, max_norm: float, mesh=None, owned: Any = None):
    """(the factor that clips ``grads`` to ``max_norm``, their norm)."""
    norm = global_norm(grads, mesh, owned)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled to at most ``max_norm`` in global norm, the norm)."""
    scale, norm = _clip_scale(grads, max_norm)
    return T.map_tree(lambda g: g * scale.to(g.dtype), grads), norm


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` of a 1-D float32 tensor (linear
    interpolation, computed in float32 as there), from a full sort:
    ``torch.quantile`` refuses inputs above 2^24 elements and the
    qwen2-1.5B head holds 233M."""
    n = x.numel()
    v = torch.sort(x).values
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    lo_i, hi_i = int(lo.clamp(0, n - 1)), int(hi.clamp(0, n - 1))
    return v[lo_i] * w_lo.to(v.device) + v[hi_i] * w_hi.to(v.device)


def compress_topk(grads: Any, error: Any, frac: float, mesh=None,
                  dims: Any = None):
    """Error-feedback top-k sparsification with a per-leaf threshold:
    entries of |g + e| below the leaf's (1 - frac) quantile are zeroed
    and fed back into the error accumulator.  Returns (sent, new error).
    Under a train ``mesh`` the trees are the rank's blocks (``dims``,
    their parameters' specs; the error is sharded as the moments are):
    the threshold is the quantile of the WHOLE leaf's |g + e|, gathered
    over the mesh (``sharding.partition.gather_leaf``), as the unsharded
    step computes it, and applies to the rank's block."""
    specs = dims if mesh is not None else T.map_tree(lambda _: (), grads)

    def one(g, e, spec):
        g = g.float() + e.float()
        mag = torch.abs(g)
        if mesh is not None:
            mag = P.gather_leaf(mag, spec, mesh)
        k = quantile(mag.reshape(-1), 1.0 - frac)
        sent = torch.where(torch.abs(g) >= k, g, torch.zeros_like(g))
        return sent, g - sent

    pairs = T.map_tree(one, grads, error, specs)
    sent = T.map_tree(lambda _, p: p[0], grads, pairs)
    new_err = T.map_tree(lambda _, p: p[1], grads, pairs)
    return sent, new_err


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                  mesh=None, owned: Any = None,
                  dims: Any = None) -> tuple[Any, dict, dict]:
    """One AdamW step, IN PLACE: every parameter, moment and the step
    tensor keep their addresses.  Returns ``(params, state, metrics)``
    (the same trees), metrics ``grad_norm`` (a 0-d device tensor), ``lr``
    (a float) and, when compressing, ``compressed``.  Under a train
    ``mesh`` the trees are the rank's blocks, whole gradients of them:
    the update is elementwise, so only the global norm crosses the ranks
    (``global_norm``, with ``owned``), and compression's threshold, a
    quantile of the whole leaf (``compress_topk`` with ``dims``, the
    parameters' specs)."""
    metrics = {}
    if cfg.compress_topk > 0:
        grads, new_error = compress_topk(grads, state["error"],
                                         cfg.compress_topk, mesh, dims)
        for e, n in zip(T.leaves(state["error"]), T.leaves(new_error)):
            e.copy_(n)
        metrics["compressed"] = 1.0
    # clip_by_global_norm, applied leaf by leaf inside the loop below (no
    # scaled copy of the whole gradient tree)
    scale, metrics["grad_norm"] = _clip_scale(grads, cfg.clip_norm, mesh,
                                              owned)
    step = step_count(state) + 1
    b1, b2 = cfg.beta1, cfg.beta2
    # host scalars, computed with any tensor mode set aside (a dry run's
    # fake tensors), so they are a real step's numbers
    with _disable_current_modes():
        lr = schedule_lr(cfg, step)
        bc1 = 1 - _f32(b1) ** torch.tensor(float(step))
        bc2 = 1 - _f32(b2) ** torch.tensor(float(step))
        bc1, bc2 = float(bc1), float(bc2)
    metrics["lr"] = lr
    # the reference's expressions term by term, in place where a buffer
    # is free (float32 moments update in their own storage)
    for leaf in zip(T.leaves(params), T.leaves(grads),
                    T.leaves(state["mu"]), T.leaves(state["nu"])):
        decay = leaf[0].ndim >= 2
        for p, g, m, v in _slices(*leaf):
            g32 = (g * scale.to(g.dtype)).float()
            m2 = m.float().mul_(b1).add_(g32 * (1 - b1))
            v2 = v.float().mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
            delta = (m2 / bc1).div_((v2 / bc2).sqrt_().add_(cfg.eps))
            if decay:
                delta.add_(p.float() * cfg.weight_decay)
            p.copy_(p.float() - delta.mul_(lr))
            if m2 is not m:
                m.copy_(m2)
            if v2 is not v:
                v.copy_(v2)
    _set_step(state["step"], step)
    return params, state, metrics
