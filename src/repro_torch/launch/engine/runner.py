"""Device-facing model runner (the serving engine's execution layer).

Counterpart of ``repro.launch.engine.runner``, rewritten for PyTorch
device placement: the engine above it is host-side policy, and this is
the only module that moves data between the host and the device.  The
JAX runner jit-compiles each callable and donates the cache to it; the
port runs eagerly and updates the KV cache IN PLACE (the same memory
the donation reuses), so every method here mutates the cache dict it is
given and returns it.  The mesh (tensor-parallel) mode of the JAX runner
is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.entropy import KernelEntropy
from repro_torch.launch import steps as S
from repro_torch.models import registry as M


class ModelRunner:
    """Parameters, cache placement and the callables for one engine
    config.  Receives the engine's policy-resolved knobs (kv_layout after
    the family fallback, cfg with ``decode_attn`` substituted)."""

    def __init__(self, params, cfg, *, max_len: int, chunk: int,
                 entropy: Optional[KernelEntropy], mi_threshold: float,
                 se_threshold: float, kv_layout: str, kv_block: int,
                 kv_blocks: int, device: torch.device, head_noise=None):
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.kv_layout = kv_layout
        self.kv_block = kv_block
        self.kv_blocks = kv_blocks
        self.device = device
        self._scan = S.build_scan_decode(cfg, entropy=entropy, chunk=chunk,
                                         mi_threshold=mi_threshold,
                                         se_threshold=se_threshold,
                                         head_noise=head_noise)

    def make_cache(self, num_slots: int) -> dict:
        return M.make_cache(self.cfg, num_slots, self.max_len,
                            device=self.device, layout=self.kv_layout,
                            kv_block=self.kv_block,
                            num_blocks=self.kv_blocks)

    def tokens(self, toks: np.ndarray) -> torch.Tensor:
        """A host (S,) prompt slice as a (1, S) device batch."""
        return torch.as_tensor(np.asarray(toks, np.int64),
                               device=self.device)[None]

    def place_table(self, table: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(table, np.int32),
                               device=self.device)

    def prefill(self, cache: dict, slot: int, toks: np.ndarray,
                row: Optional[np.ndarray]) -> dict:
        """Batch prefill of one prompt (bucketed width W) into ``slot``:
        paged prefill builds a W-token strip that the slot write pages
        out; dense builds the engine-wide max_len strip."""
        paged = self.kv_layout == "paged"
        width = len(toks) if paged else self.max_len
        _, sub = M.prefill(self.params, self.cfg, self.tokens(toks), width)
        return M.write_slot(self.cfg, cache, slot, sub,
                            self.place_table(row) if paged else None)

    def prefill_chunk(self, cache: dict, slot: int, toks: np.ndarray,
                      offset: int, new_len: int, span: int) -> dict:
        return M.prefill_chunk(self.params, self.cfg, self.tokens(toks),
                               cache, slot, offset, new_len, span)

    def set_len(self, cache: dict, slot: int, n: int) -> dict:
        cache["len"][slot] = n
        return cache

    def scan(self, tok, cache, step0: int, active, flags):
        return self._scan(self.params, tok, cache, step0, active, flags)

    @staticmethod
    def fetch(ys: torch.Tensor) -> dict[str, np.ndarray]:
        """The chunk's outputs on the host: ONE device-to-host copy."""
        host = ys.cpu().numpy()
        out = {name: host[i] for i, name in enumerate(S.OUTPUTS)}
        out["token"] = out["token"].astype(np.int32)
        out["epistemic"] = out["epistemic"] > 0.5
        out["aleatoric"] = out["aleatoric"] > 0.5
        return out

    def sync(self) -> None:
        """Wait for the device (timing boundaries only)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
