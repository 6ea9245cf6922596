"""The uncertain decode head (the body/head split of a decode step).

PyTorch counterpart of ``repro.models.uncertain_head``.  A decode step is
a KV-writing BODY (``decode_hidden``) followed by this HEAD:
``cfg.mc_samples`` LRT draws from the Bayesian output projection over the
body's hidden state, reduced to the paper's (H, SE, MI) triplet plus the
greedy next token.

Two entropy modes, as in the JAX package:

* ``head_entropy='kernel'``: the fused head (``ops.uncertainty_head_
  sampled``) draws its variates from the Philox stream keyed by
  (seed, global step) inside the kernel — no xi tensor exists;
* ``'operand'``: an explicit (S, B, V) xi that is a pure function of
  (seed, slot, depth) (``layers.decode_head_noise``, or the caller's
  ``head_noise`` provider with the same signature), then the plain
  logits path.

The split is what speculative decoding builds on (``launch/steps.py``):
the draft runs the body and proposes with a ``num_samples`` override of
this head (one draw, or 0 for the mean head), and the verify runs this
head alone at each draft position, at plain decode's shapes.  In operand
mode the noise depends on (slot, depth) only, so the verify's outputs
are plain decode's.  The fused kernel head is taken only without an
override, as in the reference.

By design, the kernel mode takes the fused head for EVERY family.  The
JAX package takes its fused kernel for the dense and vlm families only
and gives the moe, ssm, hybrid and encdec families its plain operand
tail, whose xi is keyed by (step-folded key, slot, depth).  Both draw
the same LRT distribution, so the two agree in distribution, not draw
for draw (``tests/test_torch_head.py::test_kernel_mode_head_moments_
match_the_reference_tail``).

Under a tensor-parallel mesh (``tp``) the operand mode's head is sharded
on its vocabulary columns and the plain path gathers the mean and the
variance along V before the combine, as the JAX package does.  The
kernel mode keeps ``mu`` / ``sigma`` WHOLE on every rank and every rank
launches the fused kernel on the full vocabulary: its Philox stream is
keyed by (seed, step) alone, so the ranks draw the same variates and
agree.  The JAX serve rules shard the head in both modes, but there
GSPMD cannot partition the Pallas body it feeds; a vocabulary-split
fused head merged across ranks is not ported (ROADMAP.md §2b, "Not
queued").
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.uncertainty import uncertainty_from_logits
from repro_torch.models import layers as L

# (seed, cache_len (B,), num_samples, vocab) -> (S, B, V) f32 xi
HeadNoise = Callable[[int, torch.Tensor, int, int], torch.Tensor]


def head_outputs(params, cfg: ArchConfig, hidden: torch.Tensor,
                 cache_len: torch.Tensor, key: tuple[int, int],
                 head_noise: Optional[HeadNoise] = None,
                 num_samples: Optional[int] = None, tp=None) -> dict:
    """Uncertain head over a decode hidden state.

    hidden: (B, d); ``cache_len``: (B,) PRE-step depths (the operand noise
    site); ``key``: (seed, step) or (seed, step, offset) of the head
    stream, ``step`` an int or a one-element int32 device tensor that the
    kernel reads (``ops.uncertainty_head_sampled``).  ``num_samples``
    overrides ``cfg.mc_samples`` for the draft head (0: the mean head,
    the greedy argmax of the softmax mean with no draws).  ``tp``: the
    rank's mesh handle (see the module docstring).  Returns {next_token,
    H, SE, MI, p_max} per slot.
    """
    head = params["head"]
    S = cfg.mc_samples if num_samples is None else num_samples
    seed, step = key[:2]
    if cfg.head_entropy == "kernel" and num_samples is None \
            and not cfg.logits_softcap:
        from repro_torch.kernels import ops
        if head["mu"].shape[-1] != cfg.vocab_size:
            raise ValueError("the fused head takes the whole vocabulary: "
                             "kernel entropy keeps the head unsharded")
        unc = ops.uncertainty_head_sampled(
            hidden, head["mu"], head["sigma"], seed, step, num_samples=S,
            step_offset=key[2] if len(key) > 2 else 0)
        return {"next_token": unc["pred"], "H": unc["H"], "SE": unc["SE"],
                "MI": unc["MI"], "p_max": unc["p_max"]}
    if S > 0:
        xi = (head_noise or L.decode_head_noise)(seed, cache_len, S,
                                                 cfg.vocab_size)
        logits = L.head_logits_sampled(head, hidden[None], cfg, xi, tp)
    else:
        logits = L.head_logits_mean(head, hidden, cfg, tp)[None]
    unc = uncertainty_from_logits(logits)
    p_max, tok = unc["p_mean"].max(dim=-1)
    return {"next_token": tok.to(torch.int32), "H": unc["H"],
            "SE": unc["SE"], "MI": unc["MI"], "p_max": p_max}
