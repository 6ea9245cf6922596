"""Synthetic LM token stream (a numpy copy of the JAX package's
``data/synthetic.py`` token section, so the port's CLI builds the same
prompts as the JAX CLI for the same seed).

A Zipf-weighted order-2 Markov chain over the arch's vocabulary —
deterministic given (seed, host, step), so the stream is shardable across
hosts and exactly resumable from a checkpointed cursor.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStreamState:
    """Exactly-resumable cursor for the synthetic LM stream."""
    seed: int
    host: int
    num_hosts: int
    step: int = 0


def token_batch(state: TokenStreamState, batch: int, seq: int,
                vocab: int) -> tuple[np.ndarray, TokenStreamState]:
    """Zipf-weighted order-2 Markov token stream, sharded per host.

    Deterministic in (seed, host, step) -- restarting from a checkpointed
    ``state`` regenerates the identical remaining stream.
    """
    rng = np.random.default_rng(
        (state.seed * 1_000_003 + state.host) * 1_000_003 + state.step)
    # stationary Zipf over a hashed permutation of the vocab
    ranks = 1.0 / np.arange(1, min(vocab, 4096) + 1) ** 1.1
    probs = ranks / ranks.sum()
    base = rng.choice(len(probs), size=(batch, seq), p=probs)
    # order-2 structure: every 3rd token is a deterministic mix of the
    # previous two (gives the model something learnable)
    toks = base.astype(np.int64)
    toks[:, 2::3] = (toks[:, 1::3][:, :toks[:, 2::3].shape[1]] * 31 +
                     toks[:, 0::3][:, :toks[:, 2::3].shape[1]] * 17) % \
        max(vocab // 7, 11)
    toks = toks % vocab
    new_state = dataclasses.replace(state, step=state.step + 1)
    return toks.astype(np.int32), new_state
