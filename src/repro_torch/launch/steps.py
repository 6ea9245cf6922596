"""Serving step builders: one decode step, and chunked decode.

PyTorch counterpart of the serving half of ``repro.launch.steps``.  The
JAX package's ``jax.lax.scan`` over ``chunk`` decode steps becomes a
Python loop that keeps every output on the device and stacks them, so
the engine pays ONE host transfer per chunk, never one per token.

Noise keys: the head stream is keyed by (seed, step).  In kernel-entropy
mode step is the engine's GLOBAL decode step (``step0 + t`` inside a
chunk), as in the JAX package; in operand mode the step is unused and
``layers.decode_head_noise`` keys by (seed, slot, depth) instead, so a
slot's draws depend only on its own token position.  The seed is
``entropy.seed``, or 17 without an entropy source (the JAX package's
legacy ``PRNGKey(17)`` stream).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry as M

LEGACY_SEED = 17

# per-step outputs of a chunk, in the order of the packed host transfer
OUTPUTS = ("token", "H", "SE", "MI", "p_max", "epistemic", "aleatoric")


def decode_seed(entropy) -> int:
    return entropy.seed if entropy is not None else LEGACY_SEED


def build_decode_step(cfg: ArchConfig, entropy=None, head_noise=None):
    """Single uncertain decode step: (params, token, cache, step) ->
    (outputs, cache)."""
    seed = decode_seed(entropy)

    def decode_step(params, token, cache, step: int):
        return M.decode_step(params, cfg, token, cache, (seed, step),
                             head_noise=head_noise)

    return decode_step


def build_scan_decode(cfg: ArchConfig, entropy=None, chunk: int = 8,
                      mi_threshold: float = 0.05, se_threshold: float = 1.0,
                      head_noise=None):
    """Chunked decode: ``chunk`` tokens per host round-trip.

    Returns ``scan_decode(params, token, cache, step0, active, flags) ->
    (token, cache, flags, ys)``: ``flags`` are per-slot epistemic /
    aleatoric counters that only ``active`` slots accumulate (device
    telemetry: a request finishing mid-chunk keeps counting to the chunk
    boundary), and ``ys`` is a (len(OUTPUTS), chunk, B) float32 device
    tensor — token ids and flags are exact in float32 — that the caller
    copies to the host once.
    """
    step_fn = build_decode_step(cfg, entropy=entropy, head_noise=head_noise)

    def scan_decode(params, token, cache, step0: int, active, flags):
        rows = []
        epi, alea = flags["epistemic"], flags["aleatoric"]
        for t in range(chunk):
            out, cache = step_fn(params, token, cache, step0 + t)
            is_epi = out["MI"] > mi_threshold
            is_alea = (out["SE"] > se_threshold) & ~is_epi
            rows.append(torch.stack([
                out["next_token"].float(), out["H"], out["SE"], out["MI"],
                out["p_max"], is_epi.float(), is_alea.float()]))
            token = out["next_token"]
            epi = epi + (is_epi & active).to(epi.dtype)
            alea = alea + (is_alea & active).to(alea.dtype)
        ys = torch.stack(rows, dim=1)                  # (outputs, chunk, B)
        return token, cache, {"epistemic": epi, "aleatoric": alea}, ys

    return scan_decode
