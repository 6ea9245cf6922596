"""Serving step builders: one decode step, chunked decode, and the
draft / verify / commit of uncertainty-gated speculative decoding.

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

Speculative decoding runs in operand mode only (the engine refuses the
kernel stream, whose key folds the global step): the noise then depends
on (slot, depth) alone, so a verify at a draft position draws plain
decode's variates.  The draft and the verify write into buffers the
caller owns, as the chunk does, so the runner captures both as one CUDA
graph per draft depth.
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


# ---------------------------------------------------------------------------
# speculative decoding (draft / verify / commit)
# ---------------------------------------------------------------------------

def build_spec_draft(cfg: ArchConfig, entropy=None, k: int = 4,
                     draft_samples: int = 1, head_noise=None):
    """``k``-step draft of a speculative round.

    Returns ``spec_draft(params, token, cache, hiddens, ys, states) ->
    (token, cache)``.  Each step runs the full model body
    (``M.decode_hidden``: the same code at the same shapes as a chunk's
    step, so its KV and state writes at the slot's depth are plain
    decode's for the same fed token) and proposes with a
    ``draft_samples``-draw head (0: the mean head).  Written in place:
    ``hiddens[j]`` (B, d) the body's hidden at step j, ``ys[j, 0]`` the
    proposal (a float, exact below 2^24), ``states[leaf][j]`` the
    post-step recurrent leaves (hybrid, ssm) for rollback, and ``token``
    the last proposal.  No separate draft cache exists: a rejected tail
    leaves junk KV above the kept depth, which decode masks and later
    steps overwrite.
    """
    seed = decode_seed(entropy)

    def spec_draft(params, token, cache, hiddens, ys, states):
        for j in range(k):
            depth = cache["len"].clone()     # the body advances len in place
            hidden, cache = M.decode_hidden(params, cfg, token, cache)
            if hidden.dtype != hiddens.dtype:
                raise TypeError(f"draft hidden is {hidden.dtype}, the "
                                f"buffer {hiddens.dtype}")
            out = M.head_outputs(params, cfg, hidden, depth, (seed, 0),
                                 num_samples=draft_samples,
                                 head_noise=head_noise)
            hiddens[j].copy_(hidden)
            ys[j, 0].copy_(out["next_token"])
            token.copy_(out["next_token"])
            for leaf, st in states.items():
                st[j].copy_(cache[leaf])
        return token, cache

    return spec_draft


def build_spec_verify(cfg: ArchConfig, entropy=None, k: int = 4,
                      mi_threshold: float = 0.05, se_threshold: float = 1.0,
                      head_noise=None):
    """The full-S verify of a speculative round over the k draft hiddens.

    Returns ``spec_verify(params, hiddens, lens0, ys) -> ys``: position j
    runs the family's uncertain head (``M.head_outputs``) on
    ``hiddens[j]`` (B, d) at depth ``lens0 + j``, once per position at
    exactly plain decode's shapes (B rows), so that its outputs are the
    ones plain decode emits there: a (k * B)-row product need not equal k
    B-row products, and the operand noise keys column b by row b, the
    slot.  Writes ``ys[j, 1:]`` = OUTPUTS (with the epistemic / aleatoric
    flags) in place.
    """
    seed = decode_seed(entropy)

    def spec_verify(params, hiddens, lens0, ys):
        for j in range(k):
            out = M.head_outputs(params, cfg, hiddens[j], lens0 + j,
                                 (seed, 0), head_noise=head_noise)
            is_epi = out["MI"] > mi_threshold
            is_alea = (out["SE"] > se_threshold) & ~is_epi
            torch.stack([out["next_token"].float(), out["H"], out["SE"],
                         out["MI"], out["p_max"], is_epi.float(),
                         is_alea.float()], out=ys[j, 1:])
        return ys

    return spec_verify


def build_spec_commit(cfg: ArchConfig):
    """The commit / rollback after a speculative round, in place.

    ``spec_commit(cache, token, mask, new_tok, new_len, states, idx)``:
    the slots in ``mask`` (B,) keep the round's results: their carry
    token and depth are pinned to ``new_tok`` / ``new_len`` (the pre-round
    depth + the tokens emitted), and their recurrent leaves rewind to
    ``states[leaf][idx[b], :, b]``, the state after the last kept step
    (``idx`` = emitted - 1).  KV above the kept depth needs no cleanup.
    Other slots keep their junk-advanced carry, as inactive slots do
    under a chunk.  Every write lands in the tensors given
    (``torch.where`` then ``copy_``), so graphs captured over them stay
    valid.
    """
    del cfg

    def spec_commit(cache, token, mask, new_tok, new_len, states, idx):
        token.copy_(torch.where(mask, new_tok, token))
        cache["len"].copy_(torch.where(mask, new_len, cache["len"]))
        rows = torch.arange(mask.shape[0], device=mask.device)
        for leaf, st in states.items():
            picked = st[idx.long(), :, rows].movedim(0, 1)   # (L, B, ...)
            keep = mask.reshape((1, -1) + (1,) * (picked.ndim - 2))
            cache[leaf].copy_(torch.where(keep, picked, cache[leaf]))
        return token, cache

    return spec_commit
