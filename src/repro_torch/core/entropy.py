"""The seed-driven entropy source of the serving head.

Counterpart of ``KernelEntropy`` in ``repro.core.entropy`` (the physical
entropy models stay in the JAX package until the paper slice is ported).
It carries the base seed that the fused head kernel mixes with the decode
step: the kernel keys its Philox4x32-10 stream by (seed, step), so no
entropy tensor ever exists in device memory (``kernels/rng.py``).
"""

from __future__ import annotations

import dataclasses

_GOLDEN = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class KernelEntropy:
    """Base seed of the in-kernel head-draw stream."""

    seed: int = 0

    def fold(self, *ids: int) -> int:
        """Derive a per-site 32-bit seed from the base seed: successive
        fold-ins ``s = s * 0x9E3779B9 + id + 1`` (mod 2^32), the mixing
        the JAX package uses on host and device."""
        s = self.seed & _MASK32
        for i in ids:
            s = (s * _GOLDEN + (i & _MASK32) + 1) & _MASK32
        return s
