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
reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import tree as T

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    state = {"mu": T.zeros_like(params, mdt), "nu": T.zeros_like(params, mdt),
             "step": torch.zeros((), dtype=torch.int32, device=first.device)}
    if cfg.compress_topk > 0:
        # float32, the dtype the reference's accumulator holds after its
        # first step
        state["error"] = T.zeros_like(params, torch.float32)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a 0-d tensor
    on the leaves' device)."""
    sq = sum(torch.sum(torch.square(x.float())) for x in T.leaves(tree))
    return torch.sqrt(sq)


def _clip_scale(grads: Any, max_norm: float):
    """(the factor that clips ``grads`` to ``max_norm``, their norm)."""
    norm = global_norm(grads)
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


def compress_topk(grads: Any, error: Any, frac: float):
    """Error-feedback top-k sparsification with a per-leaf threshold:
    entries of |g + e| below the leaf's (1 - frac) quantile are zeroed
    and fed back into the error accumulator.  Returns (sent, new error)."""
    def one(g, e):
        g = g.float() + e.float()
        k = quantile(torch.abs(g.reshape(-1)), 1.0 - frac)
        sent = torch.where(torch.abs(g) >= k, g, torch.zeros_like(g))
        return sent, g - sent

    pairs = T.map_tree(one, grads, error)
    sent = T.map_tree(lambda _, p: p[0], grads, pairs)
    new_err = T.map_tree(lambda _, p: p[1], grads, pairs)
    return sent, new_err


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict,
                  cfg: AdamWConfig) -> tuple[Any, dict, dict]:
    """One AdamW step, IN PLACE: every parameter, moment and the step
    tensor keep their addresses.  Returns ``(params, state, metrics)``
    (the same trees), metrics ``grad_norm`` (a 0-d device tensor), ``lr``
    (a float) and, when compressing, ``compressed``."""
    metrics = {}
    if cfg.compress_topk > 0:
        grads, new_error = compress_topk(grads, state["error"],
                                         cfg.compress_topk)
        for e, n in zip(T.leaves(state["error"]), T.leaves(new_error)):
            e.copy_(n)
        metrics["compressed"] = 1.0
    # clip_by_global_norm, applied leaf by leaf inside the loop below (no
    # scaled copy of the whole gradient tree)
    scale, metrics["grad_norm"] = _clip_scale(grads, cfg.clip_norm)
    step = int(state["step"]) + 1
    lr = schedule_lr(cfg, step)
    metrics["lr"] = lr
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - _f32(b1) ** torch.tensor(float(step))
    bc2 = 1 - _f32(b2) ** torch.tensor(float(step))
    bc1, bc2 = float(bc1), float(bc2)
    # the reference's expressions term by term, in place where a buffer
    # is free (float32 moments update in their own storage)
    for p, g, m, v in zip(T.leaves(params), T.leaves(grads),
                          T.leaves(state["mu"]), T.leaves(state["nu"])):
        g32 = (g * scale.to(g.dtype)).float()
        m2 = m.float().mul_(b1).add_(g32 * (1 - b1))
        v2 = v.float().mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
        delta = (m2 / bc1).div_((v2 / bc2).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:
            delta.add_(p.float() * cfg.weight_decay)
        p.copy_(p.float() - delta.mul_(lr))
        if m2 is not m:
            m.copy_(m2)
        if v2 is not v:
            v.copy_(v2)
    state["step"].fill_(step)
    return params, state, metrics
