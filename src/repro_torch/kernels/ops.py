"""Public kernel entry points: CPU tensors take the plain PyTorch version,
CUDA tensors launch the CUDA kernel (or raise — there is no fallback).

Counterpart of the serving half of ``repro.kernels.ops``.  The device of
the operands is the whole policy: the plain versions exist for the CPU
tests and as the references ``chip_smoke.py`` holds the kernels against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import uncertainty_head as UH


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def uncertainty_head(x, mu, sigma, xi) -> dict[str, torch.Tensor]:
    """Fused Bayesian head + (H, SE, MI, pred, p_max) per row with an
    explicit (S, M, V) xi operand (the validation path)."""
    fn = UH.uncertainty_head_cuda if _on_cuda(x) else UH.uncertainty_head_plain
    return fn(x, mu, sigma, num_samples=xi.shape[0], xi=xi)


def uncertainty_head_sampled(x, mu, sigma, seed: int, step: int,
                             num_samples: int = 10) -> dict[str, torch.Tensor]:
    """Seeded fused head: the variates come from the Philox stream keyed
    by (seed, step), drawn in the kernel and never stored."""
    fn = UH.uncertainty_head_cuda if _on_cuda(x) else UH.uncertainty_head_plain
    return fn(x, mu, sigma, num_samples=num_samples, seed=seed, step=step)


def paged_decode_attention(q, k_pool, v_pool, block_table, cache_len):
    """Block-sparse decode attention over the paged KV pool: q (B, 1, H,
    D); pools (NB, BS, Hkv, D); block_table (B, MB); cache_len () or (B,)."""
    fn = PA.paged_decode_attention_cuda if _on_cuda(q) \
        else PA.paged_decode_attention_plain
    return fn(q, k_pool, v_pool, block_table, cache_len)


def paged_prefill_attention(q, k_pool, v_pool, block_row, offset,
                            span: int, kv_chunk: int = 1024):
    """Multi-query block-sparse attention for one slot's prompt chunk: q
    (1, S, H, D) at positions ``offset + [0, S)``; ``block_row`` (1, NBLK)
    the slot's leading table entries covering ``span`` tokens."""
    fn = PA.paged_prefill_attention_cuda if _on_cuda(q) \
        else PA.paged_prefill_attention_plain
    return fn(q, k_pool, v_pool, block_row, offset, span, kv_chunk)


def entropy_bytes(kind: str, *, num_samples: int, m: int = 0, k: int = 0,
                  n: int = 0, b: int = 0, t_out: int = 0, c: int = 9,
                  in_kernel: bool = False) -> int:
    """Bytes of randomness crossing device memory per prediction.

    kind: 'weight_space' (S*K*N operand), 'lrt' (S*M*N), 'head' (S*M*V ==
    lrt at the vocab), 'conv' (S*B*To*C).  The in-kernel path is 0 by
    construction: the variates are born and die in registers.
    """
    if in_kernel:
        return 0
    counts = {
        "weight_space": num_samples * k * n,
        "lrt": num_samples * m * n,
        "head": num_samples * m * n,
        "conv": num_samples * b * t_out * c,
    }
    return counts[kind] * 4
