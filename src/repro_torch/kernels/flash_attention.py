"""GQA flash attention (forward): the CUDA kernels and their plain PyTorch
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
``acc / max(l, 1e-20)`` in q's dtype (0 for a row with no visible key).
Math and state are float32.

Two kernels in ``csrc/flash_attention.cu``, chosen by ``flash_route``
from dtype, head dim and alignment (never by failure):

* ``flash_fwd_mma`` (bf16 tensor cores): rows packed per (batch, kv head)
  as ``replica * Sq + query`` in blocks of 64, 64-key tiles, tiles above a
  block's highest query position skipped, P split into three bf16 parts
  before P.V (P to about 2^-24, as f32); when the row blocks alone do not fill the card the kv tiles
  are cut into ``flash_split`` chunks whose f32 partials a second launch
  merges.
* ``flash_fwd_simt`` (f32 on the CUDA cores): f32 operands, and bf16 at
  head dims or strides the tensor-core kernel does not take.

The plain version below follows the JAX kernel's tiles (bq 128 query rows
of one head, bk 256 keys) by default and walks the tensor-core kernel's
(``packed=True``, ``bq=FLASH_BLOCK_ROWS``, ``bk=FLASH_KEY_TILE``,
``kv_splits``) on request; both skip kv tiles wholly above the causal
diagonal and give the same function.  ``models.layers.flash_attention``
(the models' online-softmax attention) is separate and unchanged.
``ops.py`` picks kernel or plain version by the tensor's device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, launches
from repro_torch.kernels.paged_attention import SPLIT_TARGET

MAX_HEAD_DIM = 256
_NEG = -1e30
# the tensor-core kernel: query rows per block (4 warps of 16 rows), keys
# per tile, and its largest head dim (csrc/flash_attention.cu MROWS, MKT)
FLASH_BLOCK_ROWS = 64
FLASH_KEY_TILE = 64
MMA_MAX_HEAD_DIM = 128


def flash_route(dtype: torch.dtype, head_dim: int,
                *operands: torch.Tensor) -> str:
    """Which kernel a CUDA call launches: ``"mma"`` (tensor cores) for bf16
    with ``head_dim % 16 == 0`` and ``head_dim <= 128`` whose operands all
    start on a 16-byte boundary with every stride but the last a multiple
    of 8 elements (what 16-byte ``cp.async`` copies need), else
    ``"simt"``."""
    if dtype != torch.bfloat16 or head_dim % 16 \
            or head_dim > MMA_MAX_HEAD_DIM:
        return "simt"
    for t in operands:
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
            return "simt"
    return "mma"


def flash_split(batch: int, kv_heads: int, rows: int, kv_len: int) -> int:
    """Number of kv chunks of the tensor-core kernel for ``rows`` packed
    query rows per (batch, kv head) over ``kv_len`` keys: 1 where the row
    blocks alone give a block to every SM, else enough chunks that the
    (row block, chunk) grid holds about ``SPLIT_TARGET`` blocks (two per
    SM, as the paged decode kernel's split aims for), never an empty
    chunk."""
    blocks = batch * kv_heads * -(-rows // FLASH_BLOCK_ROWS)
    if 2 * blocks >= SPLIT_TARGET:
        return 1
    tiles = -(-kv_len // FLASH_KEY_TILE)
    per = -(-tiles // min(tiles, -(-SPLIT_TARGET // blocks)))
    return -(-tiles // per)


# ---------------------------------------------------------------------------
# plain version (the JAX kernel's tile loop, or the tensor-core kernel's)
# ---------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          bq: int = 128, bk: int = 256, packed: bool = False,
                          kv_splits: int = 1) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H, D) in q.dtype.

    Walks blocks of ``bq`` query rows: by default the rows of one query
    head (the JAX kernel's tiles); with ``packed`` the rows of one
    (batch, kv head), row r = replica * Sq + query, as the tensor-core
    kernel packs them.  A block walks the ``bk``-key tiles up to its
    highest query position under ``causal``.  ``kv_splits`` cuts the
    tiles into chunks of ``ceil(ceil(Sk / bk) / kv_splits)``, each with its
    own online softmax from (m -1e30, l 0, acc 0), and merges the f32
    partials weighted by exp(m_c - max m); one chunk is the plain walk.
    Every walk gives the same function: a skipped tile and an empty chunk
    are fully masked and change nothing under the guards."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    if packed:   # (B, Hkv, rep * Sq, D) against (B, Hkv, Sk, D)
        qr = q.float().reshape(B, Sq, Hkv, rep, D).permute(0, 2, 3, 1, 4)
        qr = qr.reshape(B, Hkv, rep * Sq, D)
        kr, vr = (t.float().transpose(1, 2) for t in (k, v))
    else:        # (B, H, Sq, D) against K/V expanded to the query heads
        qr = q.float().transpose(1, 2)
        kr, vr = (t.float().transpose(1, 2).repeat_interleave(rep, dim=1)
                  for t in (k, v))
    R = qr.shape[2]
    qpos = q_offset + torch.arange(R, device=dev) % Sq
    tiles = -(-Sk // bk)
    per = -(-tiles // kv_splits)
    out = torch.empty(qr.shape, dtype=torch.float32, device=dev)
    for r0 in range(0, R, bq):
        r1 = min(r0 + bq, R)
        rows = (B, qr.shape[1], r1 - r0)
        # the block's highest position; later tiles lie wholly above the
        # diagonal (p 0, correction 1) and are skipped
        top = q_offset + (Sq - 1 if (r1 - 1) // Sq != r0 // Sq
                          else (r1 - 1) % Sq)
        walked = -(-max(0, min(Sk, top + 1)) // bk) if causal else tiles
        parts = []
        for c0 in range(0, tiles, per):
            m = torch.full(rows, _NEG, device=dev)
            l = torch.zeros(rows, device=dev)
            acc = torch.zeros((*rows, D), device=dev)
            for t in range(c0, min(c0 + per, walked)):
                k0, k1 = t * bk, min(t * bk + bk, Sk)
                s = torch.einsum("bgrd,bgkd->bgrk", qr[:, :, r0:r1],
                                 kr[:, :, k0:k1]) * scale
                kpos = torch.arange(k0, k1, device=dev)
                mask = (kpos[None, :] <= qpos[r0:r1, None] if causal else
                        torch.ones_like(s, dtype=torch.bool))
                s = torch.where(mask, s, _NEG)
                m_new = torch.maximum(m, s.max(dim=-1).values)
                p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + p @ vr[:, :, k0:k1]
                m = m_new
            parts.append((m, l, acc))
        # the merge; with one chunk its weight is exp(0) = 1
        ms = torch.stack([p[0] for p in parts])
        w = torch.exp(ms - ms.max(dim=0).values)
        l = (torch.stack([p[1] for p in parts]) * w).sum(dim=0)
        acc = (torch.stack([p[2] for p in parts]) * w[..., None]).sum(dim=0)
        out[:, :, r0:r1] = acc / torch.clamp(l, min=1e-20)[..., None]
    if packed:
        out = out.reshape(B, Hkv, rep, Sq, D).permute(0, 3, 1, 2, 4)
        return out.reshape(B, Sq, H, D).to(q.dtype)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _fn():
    fn = build.load("flash_attention").repro_flash_attention
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D), float32 or bfloat16 alike,
    last dimension contiguous -> (B, Sq, H, D) in q.dtype.

    Dispatch by ``flash_route``, not a fallback on failure: the
    tensor-core kernel (over ``flash_split`` kv chunks and their merge,
    into f32 scratch allocated here) or the SIMT kernel.  Either launches
    or raises; a call counts one launch."""
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
    mma = flash_route(q.dtype, D, q, k, v) == "mma"
    chunks = flash_split(B, Hkv, (H // Hkv) * Sq, Sk) if mma else 1
    part = torch.empty((B * Sq * H * chunks * (D + 2),), dtype=torch.float32,
                       device=dev) if chunks > 1 else None
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1),
                                              t.stride(2))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   int(q.dtype == torch.bfloat16), B, H, Hkv, Sq, Sk, D,
                   *strides, int(causal), int(q_offset), int(mma), chunks,
                   None if part is None else part.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches.COUNTS["flash_attention"] += 1
    return o
