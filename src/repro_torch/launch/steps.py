"""Serving step builders: one decode step, and chunked decode.

PyTorch counterpart of the serving half of ``repro.launch.steps``.  The
JAX package's ``jax.lax.scan`` over ``chunk`` decode steps becomes a
Python loop that writes every output in place into buffers the caller
owns (the token carry, the flag counters, the (chunk, outputs, B) ``ys``
and the cache), so the engine pays ONE host transfer per chunk, never
one per token, and the chunk can be captured as a CUDA graph over fixed
addresses (``launch/engine/runner.py``): the PyTorch form of the JAX
runner's ``jax.jit(scan_decode, donate_argnums=(2,))``.

Noise keys: the head stream is keyed by (seed, step).  In kernel-entropy
mode step is the engine's GLOBAL decode step (``step0 + t`` inside a
chunk), as in the JAX package; ``step0`` is a one-element int32 tensor
that the head kernel reads in device memory, with ``t`` as its offset.
In operand mode the step is unused and ``layers.decode_head_noise`` keys
by (seed, slot, depth) instead, so a slot's draws depend only on its own
token position.  The seed is ``entropy.seed``, or 17 without an entropy
source (the JAX package's legacy ``PRNGKey(17)`` stream).
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
    """Single uncertain decode step: (params, token, cache, step,
    offset=0) -> (outputs, cache); the head stream's step is ``step +
    offset``, ``step`` an int or a one-element int32 device tensor."""
    seed = decode_seed(entropy)

    def decode_step(params, token, cache, step, offset: int = 0):
        return M.decode_step(params, cfg, token, cache, (seed, step, offset),
                             head_noise=head_noise)

    return decode_step


def build_scan_decode(cfg: ArchConfig, entropy=None, chunk: int = 8,
                      mi_threshold: float = 0.05, se_threshold: float = 1.0,
                      head_noise=None):
    """Chunked decode: ``chunk`` tokens per host round-trip.

    Returns ``scan_decode(params, token, cache, step0, active, flags, ys)
    -> (token, cache, flags, ys)``, which writes every result IN PLACE and
    returns the tensors it was given: ``token`` (B,) int32 ends as the
    last step's tokens; ``flags`` are per-slot epistemic / aleatoric int32
    counters that only ``active`` slots accumulate (device telemetry: a
    request finishing mid-chunk keeps counting to the chunk boundary);
    ``ys`` is a (chunk, len(OUTPUTS), B) float32 buffer — token ids and
    flags are exact in float32 — that the caller copies to the host once.
    ``step0`` is the chunk's first global step, a one-element int32
    tensor on the cache's device.
    """
    step_fn = build_decode_step(cfg, entropy=entropy, head_noise=head_noise)

    def scan_decode(params, token, cache, step0, active, flags, ys):
        epi, alea = flags["epistemic"], flags["aleatoric"]
        for t in range(chunk):
            out, cache = step_fn(params, token, cache, step0, t)
            is_epi = out["MI"] > mi_threshold
            is_alea = (out["SE"] > se_threshold) & ~is_epi
            torch.stack([out["next_token"].float(), out["H"], out["SE"],
                         out["MI"], out["p_max"], is_epi.float(),
                         is_alea.float()], out=ys[t])
            token.copy_(out["next_token"])
            epi.add_((is_epi & active).to(epi.dtype))
            alea.add_((is_alea & active).to(alea.dtype))
        return token, cache, flags, ys

    return scan_decode
