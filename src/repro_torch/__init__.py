"""PyTorch / CUDA port of the uncertain serving path.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths (``repro_torch.models.layers`` is the counterpart of
``repro.models.layers``) and imports nothing of it.  Plain tensor code is
PyTorch; every Pallas kernel on the ported path is a hand-written CUDA
kernel for Hopper (``kernels/csrc``), built with nvcc at first use.

Precision is pinned here, for every caller: float32 matmuls run in full
float32 (no TF32), and bf16 matmuls accumulate in float32 without
reduced-precision reductions — the JAX package's ``_mm`` contract
(``preferred_element_type`` with f32 accumulation).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Never falls back quietly — a missing GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch paths on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
