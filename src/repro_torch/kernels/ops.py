"""Public kernel entry points: CPU tensors take the plain PyTorch version,
CUDA tensors launch the CUDA kernel (or raise — there is no fallback).

Counterpart of ``repro.kernels.ops`` (the serving half, and the paper's
photonic conv and weight-space GEMM), with the JAX names and argument
order but no ``impl`` argument.  The device of the operands is the whole
policy: the plain versions exist for the CPU tests and as the references
``chip_smoke.py`` holds the kernels against.  Ragged shapes are masked in
the kernels, so nothing is padded here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import bayes_matmul as BM
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import photonic_conv as PC
from repro_torch.kernels import ref
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


def bayes_matmul(x, mu, sigma, eps) -> torch.Tensor:
    """Sampled-weight GEMM y = x @ (mu + sigma*eps); any (M, K, N)."""
    if _on_cuda(x):
        return BM.bayes_matmul_cuda(x, mu, sigma, eps)
    return ref.bayes_matmul(x, mu, sigma, eps)


def bayes_matmul_sampled(x, mu, sigma, seed: int,
                         num_samples: int = 10) -> torch.Tensor:
    """S seeded weight-space MC samples of y = x @ (mu + sigma*eps):
    (S, M, N), one sampled W_s shared by every row.  On the GPU the eps
    tensor never exists and each mu/sigma tile is read once for all S."""
    if _on_cuda(x):
        return BM.bayes_matmul_sampled_cuda(x, mu, sigma,
                                            num_samples=num_samples,
                                            seed=seed)
    return BM.bayes_matmul_sampled_plain(x, mu, sigma,
                                         num_samples=num_samples, seed=seed)


def photonic_conv(x, mu, sigma, eps, dac_bits: int = 8,
                  adc_bits: int = 8) -> torch.Tensor:
    """Machine primitive: (B, T) x C-channel probabilistic kernel with an
    explicit (B, To, C) eps -> (B, To)."""
    if _on_cuda(x):
        return PC.photonic_conv_cuda(x, mu, sigma, eps, dac_bits=dac_bits,
                                     adc_bits=adc_bits)
    return PC.photonic_conv_plain(x, mu, sigma, eps, dac_bits=dac_bits,
                                  adc_bits=adc_bits)


def photonic_conv_sampled(x, mu, sigma, seed: int, dac_bits: int = 8,
                          adc_bits: int = 8) -> torch.Tensor:
    """Seeded machine primitive: the per-symbol draws are born in the
    kernel (TAG_CONV stream keyed by seed)."""
    if _on_cuda(x):
        return PC.photonic_conv_sampled_cuda(x, mu, sigma, seed,
                                             dac_bits=dac_bits,
                                             adc_bits=adc_bits)
    return PC.photonic_conv_plain(x, mu, sigma, seed=seed, dac_bits=dac_bits,
                                  adc_bits=adc_bits)


def im2col(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B*H*W, C*9) 3x3 patches at stride 1 with SAME
    padding; the feature order is (channel, kh, kw), as the JAX package's
    ``conv_general_dilated_patches`` gives it, so an OIHW weight reshaped
    to (O, C*9) lines up."""
    b, c, h, w = x.shape
    return F.unfold(x, 3, padding=1).transpose(1, 2).reshape(b * h * w,
                                                             c * 9)


def bayes_conv2d_im2col(x, mu, sigma, eps) -> torch.Tensor:
    """3x3 probabilistic conv as a sampled GEMM (im2col).

    x: (B, C_in, H, W); mu/sigma/eps: (C_out, C_in, 3, 3) -> (B, C_out, H, W).
    """
    b, cin, h, w = x.shape
    cout = mu.shape[0]
    flat = [t.reshape(cout, cin * 9).T for t in (mu, sigma, eps)]
    y = bayes_matmul(im2col(x), *flat)
    return y.reshape(b, h, w, cout).permute(0, 3, 1, 2)


def bayes_conv2d_im2col_sampled(x, mu, sigma, seed: int,
                                num_samples: int = 10) -> torch.Tensor:
    """S seeded MC samples of the 3x3 probabilistic conv (im2col GEMM):
    x (B, C_in, H, W); mu/sigma (C_out, C_in, 3, 3) -> (S, B, C_out, H, W).
    One weight read per prediction on the GPU."""
    b, cin, h, w = x.shape
    cout = mu.shape[0]
    mu2, sg2 = (t.reshape(cout, cin * 9).T for t in (mu, sigma))
    y = bayes_matmul_sampled(im2col(x), mu2, sg2, seed,
                             num_samples=num_samples)
    return y.reshape(num_samples, b, h, w, cout).permute(0, 1, 4, 2, 3)


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
