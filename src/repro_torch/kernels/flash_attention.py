"""GQA flash attention (forward): the CUDA kernel and its plain PyTorch
version.

Counterpart of ``repro.kernels.flash_attention.flash_attention_kernel``
behind ``ops.flash_attention``.  q (B, Sq, H, D), k/v (B, Sk, Hkv, D) in
the port's layout (the JAX wrapper transposes to (B, H, S, D); the port
reads by stride instead), query head h attends to kv head h // (H / Hkv),
query row i sits at absolute position ``q_offset + i``, keys at or past
Sk are masked, and under ``causal`` so is every key past the query's
position.  The online state follows the TPU kernel: m starts at -1e30,
masked scores are -1e30 and their p is set to 0 (so a row whose first kv
tile is fully masked takes nothing from it), and the output is
``acc / max(l, 1e-20)`` in q's dtype.  Math and state are float32.

The kernel (``csrc/flash_attention.cu``) tiles 64 query rows x 64 keys;
the plain version below follows the JAX kernel's tiles (bq 128, bk 256)
and, like the kernel, skips kv tiles wholly above the causal diagonal.
``models.layers.flash_attention`` (the models' online-softmax attention)
is separate and unchanged.  ``ops.py`` picks kernel or plain version by
the tensor's device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, launches

MAX_HEAD_DIM = 256
_NEG = -1e30


# ---------------------------------------------------------------------------
# plain version (the JAX kernel's tile loop, in PyTorch)
# ---------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          bq: int = 128, bk: int = 256) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H, D) in q.dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    qf = q.float().transpose(1, 2)                          # (B, H, Sq, D)
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(rep, dim=1)
              for t in (k, v))                              # (B, H, Sk, D)
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        qpos = q_offset + torch.arange(q0, q1, device=dev)
        m = torch.full((B, H, q1 - q0), _NEG, device=dev)
        l = torch.zeros((B, H, q1 - q0), device=dev)
        acc = torch.zeros((B, H, q1 - q0, D), device=dev)
        # the last key a row of this tile may see: later tiles lie wholly
        # above the diagonal (p 0, correction 1) and are skipped
        kend = max(0, min(Sk, q_offset + q1)) if causal else Sk
        for k0 in range(0, kend, bk):
            k1 = min(k0 + bk, Sk)
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, q0:q1],
                             kf[:, :, k0:k1]) * scale
            kpos = torch.arange(k0, k1, device=dev)
            mask = (kpos[None, :] <= qpos[:, None] if causal else
                    torch.ones_like(s, dtype=torch.bool))
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vf[:, :, k0:k1]
            m = m_new
        out[:, :, q0:q1] = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _fn():
    fn = build.load("flash_attention").repro_flash_attention
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D), float32 or bfloat16 alike,
    last dimension contiguous -> (B, Sq, H, D) in q.dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if tuple(k.shape) != (B, Sk, Hkv, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not (1 <= D <= MAX_HEAD_DIM and Hkv >= 1 and H % Hkv == 0
            and Sq >= 1 and Sk >= 1 and B * H <= 65535):
        raise ValueError(f"unsupported shape: B {B}, Sq {Sq}, Sk {Sk}, H {H},"
                         f" Hkv {Hkv}, D {D} (D <= {MAX_HEAD_DIM}, H % Hkv "
                         f"== 0)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or "
                        "bfloat16")
    for t, name in ((k, "k"), (v, "v")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last "
                             "dimension")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1),
                                              t.stride(2))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   int(q.dtype == torch.bfloat16), B, H, Hkv, Sq, Sk, D,
                   *strides, int(causal), int(q_offset), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches.COUNTS["flash_attention"] += 1
    return o
