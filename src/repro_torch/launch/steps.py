"""Step builders: the SVI train step, and for serving one decode step,
chunked decode, and the draft / verify / commit of uncertainty-gated
speculative decoding.

PyTorch counterpart of ``repro.launch.steps`` (its dry-run shape specs
are not ported).  The train step is plain PyTorch with autograd, as the
reference's is plain jnp under ``jax.value_and_grad``: no kernel lies on
it.  The
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

import contextlib
import os

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import keys as K
from repro_torch.core import tree as T
from repro_torch.core.svi import SVIConfig, elbo_loss
from repro_torch.models import registry as M
from repro_torch.optim import adamw

LEGACY_SEED = 17

# per-step outputs of a chunk, in the order of the packed host transfer
OUTPUTS = ("token", "H", "SE", "MI", "p_max", "epistemic", "aleatoric")


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms for the span of a train step on CUDA (the
    embedding and gather backwards otherwise accumulate with atomics, and
    a resumed run must be bit-exact); cuBLAS needs its workspace pinned
    for that (``CUBLAS_WORKSPACE_CONFIG``, set here where unset).  The
    mode's NaN fill of every new tensor is turned off: the step reads no
    memory it has not written, and the fill is one more pass over every
    output.  The caller's settings are restored afterwards.  A no-op on
    the CPU."""
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def build_train_step(cfg, opt_cfg: adamw.AdamWConfig,
                     svi_cfg: SVIConfig | None = None,
                     micro_batches: int = 1, seed: int = 0, noise=None,
                     nll_fn=None):
    """``(state, batch) -> (state, metrics)`` with ``state = {"params",
    "opt"}``: the negative ELBO (``core.svi.elbo_loss`` of ``nll_fn``,
    default the family's ``registry.nll_loss``), its gradients by
    autograd, and one AdamW update (``optim.adamw.apply_updates``), all in
    place: the state's tensors keep their addresses.

    The step's noise key is ``fold_in(root(seed), step)`` (``core.keys``),
    so a run and its resumption draw the same variates.  ``micro_batches``
    > 1 splits the batch on its leading axis: micro-batch i runs on
    ``fold_in(key, i)``, its gradients accumulate in float32 and are
    averaged, as the reference's scan does.  ``noise`` replaces the head's
    draw (tests inject the JAX package's).  Metrics: ``loss``, ``nll``,
    ``kl``, ``beta``, ``accuracy``, ``grad_norm`` (0-d device tensors) and
    ``lr`` (a float)."""
    svi = svi_cfg or SVIConfig()
    nll = nll_fn or (lambda p, b, k: M.nll_loss(p, cfg, b, k, noise=noise))

    def grads_of(params, batch, key, step):
        leaves = T.leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss, aux = elbo_loss(nll, params, batch, key, step, svi)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        step = int(opt["step"])
        key = K.fold_in(K.root(seed), step)
        device = T.leaves(params)[0].device
        with deterministic(device):
            if micro_batches == 1:
                loss, aux, grads = grads_of(params, batch, key, step)
            else:
                acc, losses, auxs = None, [], []
                for i in range(micro_batches):
                    mb = {k: v.reshape(micro_batches, -1, *v.shape[1:])[i]
                          for k, v in batch.items()}
                    l_i, a_i, g_i = grads_of(params, mb, K.fold_in(key, i),
                                             step)
                    acc = [g.float() for g in g_i] if acc is None else \
                        [a + g.float() for a, g in zip(acc, g_i)]
                    losses.append(l_i)
                    auxs.append(a_i)
                inv = 1.0 / micro_batches
                grads = [g * inv for g in acc]
                loss = sum(losses[1:], losses[0]) * inv
                aux = {k: torch.stack([a[k] for a in auxs]).mean(0)
                       for k in auxs[0]}
            params, opt, om = adamw.apply_updates(
                params, T.unflatten(params, list(grads)), opt, opt_cfg)
        metrics = {"loss": loss, **aux, **om}
        return {"params": params, "opt": opt}, metrics

    return train_step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

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
