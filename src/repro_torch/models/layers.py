"""Shared model layers, dense subset: norms, RoPE, attention, MLP, heads.

PyTorch counterpart of ``repro.models.layers``.  Parameters are plain
dicts of tensors with the JAX package's layouts (weights (in, out),
attention (B, S, H, D)); storage is ``cfg.param_dtype`` and every matmul
accumulates in float32 (``repro_torch`` pins the backend flags).

Caches are updated IN PLACE where the JAX package returns a new array
(it donates the old one to XLA instead): ``paged_scatter`` writes into
the pool it is given.

Tensor parallelism (``--mesh 1xM``): the layers that meet a column-sharded
weight take the rank's ``launch.mesh.TP`` as ``tp=`` and all-gather the
sharded columns before anything contracts over them
(``sharding.partition.gather_rep``, the JAX package's seams of the same
name).  Where the ranks divide the kv heads (``heads_local``) attention
runs on the rank's own heads against its own slice of the KV cache, and
its output is gathered before ``wo``; otherwise q, k and v are gathered
and every rank attends over all heads.  ``tp`` None is the unsharded
model.

Training under a D x M train mesh (``launch.mesh.TrainMesh``) runs the
same functions on a rank's shards, with the mesh's ``model`` axis
(``launch.mesh.Axis``) as ``tp``: Megatron-LM's layout on the JAX
package's train rules (``sharding.partition.train_dims``), the JAX
``constrain`` / ``constrain_seq`` become the autograd collectives of
``sharding.collectives``.  ``wq wk wv w1 w3`` (and the biases) are
column-parallel and ``wo w2`` row-parallel, so the products leave partial
sums (``leave``); a weight FSDP-sharded over ``data`` is gathered a layer
at a time first (``gathered``), and one whose columns every model rank
reads (the Mamba2 ``in_proj``) over ``model`` (``gathered_model``); the
stream enters the column-parallel products through ``enter``.  Where the heads do not divide the model axis,
q / k / v are gathered under autograd and each rank's columns of the
output go into its rows of ``wo`` (the JAX package shards the query chunks
there instead).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import rng
from repro_torch.launch.mesh import Axis
from repro_torch.sharding import collectives as C
from repro_torch.sharding.partition import gather_rep, shardable

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
             axis=None):
    """RMSNorm over x's last axis; with a train mesh's ``axis`` x is the
    rank's slice of a wider vector, whose ranks' sums of squares are
    all-reduced forward and backward."""
    x32 = x.float()
    if axis is None:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    else:
        var = C.copy(C.reduce(torch.sum(x32 * x32, dim=-1, keepdim=True),
                              axis), axis) / (x.shape[-1] * axis.size)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """RoPE (cos, sin) at integer ``positions`` (..., S), each (..., S, 1,
    head_dim // 2) float32.  Every layer of a step rotates at the same
    positions, so the model computes these once per step (eager PyTorch
    would otherwise launch the same ~12 small ops per layer, twice)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python-scalar base: a 0-d device tensor here would cost a host copy
    # and a device sync per call
    freqs = torch.pow(float(theta), exps)
    ang = positions[..., None].float() * freqs               # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope(x: torch.Tensor, rot: tuple[torch.Tensor, torch.Tensor]):
    """x: (..., S, H, D) rotated by ``rot = rope_tables(positions, D,
    theta)``."""
    cos, sin = rot
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mm(x, w):
    # output dtype == activation dtype, f32 accumulation inside the GEMM
    return torch.matmul(x, w)


def heads_local(cfg: ArchConfig, tp) -> bool:
    """Whether attention runs on the rank's own heads: a mesh of M > 1
    ranks that divides the kv heads, so that the column slices of wq / wk
    / wv are whole heads (query heads r·H/M.. use kv heads r·Hkv/M.., a
    GQA group never straddles ranks) and the KV cache shards on its
    kv-head axis (``registry.make_cache(kv_shards=)``).  A serving handle
    may ask for every head instead (``TP.local_heads``; a train mesh's
    ``Axis`` never does)."""
    return tp is not None and tp.size > 1 \
        and getattr(tp, "local_heads", True) \
        and shardable(cfg.num_kv_heads, tp.size)


def _whole(y: torch.Tensor, width: int, tp) -> torch.Tensor:
    """``y`` with its full last axis ``width``: gathered across the ranks
    where a column-sharded weight gave this rank a slice of it.  On a
    train mesh's axis the gather is differentiable: every rank then
    repeats the work on the whole, so its backward keeps the rank's
    slice of the gradient."""
    if y.shape[-1] == width:
        return y
    if isinstance(tp, Axis):
        return C.gather(y, tp, -1, grad="split")
    return gather_rep(y, tp)


def _attn_out(p, out: torch.Tensor, cfg: ArchConfig, tp) -> torch.Tensor:
    """The (B, S, h·hd) attention output through ``wo``: gathered first
    when it holds only this rank's heads and ``wo`` is whole (serving);
    the rank's columns when it holds all heads and ``wo`` is the rank's
    rows (training's row-parallel ``wo``, the heads gathered)."""
    B, S = out.shape[:2]
    out, rows = out.reshape(B, S, -1), p["wo"].shape[-2]
    if out.shape[-1] > rows:
        out = C.split(out, tp, -1)
    return _mm(_whole(out, rows, tp), p["wo"])


def he_init(gen: torch.Generator, shape, fan_in: int, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w / math.sqrt(float(max(fan_in, 1)))).to(dtype)


# --------------------------------------------------------------------------
# flash-style chunked attention (the plain online softmax)
# --------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Memory-bounded attention: online softmax over kv chunks for each q
    chunk, with -inf guards for rows that have no valid key yet.

    q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D) with H % Hkv == 0 (GQA);
    ``q_offset`` is the absolute position of q[0].
    """
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    rep = H // Hkv
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Sk)
    nq, nk = -(-Sq // qc), -(-Sk // kc)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * qc - Sq)).float()
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * kc - Sk)).float()
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * kc - Sk)).float()
    outs = []
    for qi in range(nq):
        blk = qp[:, qi * qc:(qi + 1) * qc]                   # (B, qc, H, D)
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, H, qc), -math.inf, device=dev)
        l = torch.zeros((B, H, qc), device=dev)
        acc = torch.zeros((B, H, qc, D), device=dev)
        for kj in range(nk):
            kk = kp[:, kj * kc:(kj + 1) * kc].repeat_interleave(rep, dim=2)
            vv = vp[:, kj * kc:(kj + 1) * kc].repeat_interleave(rep, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", blk, kk) * scale
            kp_abs = kj * kc + torch.arange(kc, device=dev)
            mask = (kp_abs < Sk)[None, :]
            if causal:
                mask = mask & (kp_abs[None, :] <= qpos[:, None])
            else:
                mask = mask.expand(qc, kc)
            s = torch.where(mask, s, -math.inf)
            m2 = torch.maximum(m, s.max(dim=-1).values)
            m2s = torch.where(torch.isinf(m2), 0.0, m2)
            p = torch.where(mask, torch.exp(s - m2s[..., None]), 0.0)
            corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m2s))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                       p, vv)
            m = m2
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a (B, S, Hkv, D) cache.

    q: (B, 1, H, D); cache_len: () or (B,) valid positions per slot.  GQA
    by a grouped einsum (the cache is never repeated per query head).  A
    slot with no valid position gets NaN (softmax of an all -inf row).
    """
    B, S, Hkv, D = k_cache.shape
    H = q.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, 1, Hkv, rep, D).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache.float()) \
        / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < torch.as_tensor(cache_len).reshape(-1, 1)
    s = torch.where(mask[:, None, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# --------------------------------------------------------------------------
# paged KV cache: (slot, logical_pos) -> (block, offset) indirection
# --------------------------------------------------------------------------

def paged_table_width(max_len: int, kv_block: int) -> int:
    """Block-table width MB: blocks needed to span max_len tokens."""
    return -(-max_len // kv_block)


def init_block_table(batch: int, max_len: int, kv_block: int,
                     device) -> torch.Tensor:
    """Fresh all-unmapped (-1) per-slot block table."""
    return torch.full((batch, paged_table_width(max_len, kv_block)), -1,
                      dtype=torch.int32, device=device)


def paged_index(num_blocks: int, block_size: int, block_table: torch.Tensor,
                lens: torch.Tensor, S: int):
    """(block, offset) of logical positions ``lens[b] + [0, S)`` of every
    slot, each (B, S).  Positions whose logical block is unmapped (-1) or
    past the table go to the SINK block ``num_blocks - 1``: the pool keeps
    one trailing block that no table maps, so a dropped write lands there
    without a host sync (the JAX package's ``mode='drop'``)."""
    MB = block_table.shape[1]
    idx = lens.long()[:, None] + torch.arange(S, device=lens.device)[None, :]
    tbl = idx // block_size
    phys = torch.gather(block_table.long(), 1, torch.clamp(tbl, max=MB - 1))
    phys = torch.where((tbl < MB) & (phys >= 0), phys, num_blocks - 1)
    return phys, idx % block_size


def paged_scatter(pool: torch.Tensor, block_table: torch.Tensor,
                  lens: torch.Tensor, new: torch.Tensor,
                  index: Optional[tuple] = None) -> torch.Tensor:
    """Write per-slot KV entries into the global block pool, in place.

    pool: (NB + 1, BS, ...) physical blocks plus the sink; block_table:
    (B, MB) int32 (-1 = unmapped); lens: (B,) current logical depth per
    slot; new: (B, S, ...) entries for logical positions ``lens[b] +
    [0, S)``.  Writes to unmapped or out-of-table positions are dropped
    into the sink — what makes an evicted slot's junk steps harmless.
    ``index`` is ``paged_index``'s answer when the caller already has it
    (every layer of a step writes the same positions).
    """
    phys, off = index or paged_index(pool.shape[0], pool.shape[1],
                                     block_table, lens, new.shape[1])
    pool[phys, off] = new.to(pool.dtype)
    return pool


def copy_block(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Copy-on-write: duplicate physical block ``src`` into ``dst`` of a
    layer-stacked pool (L, NB + 1, BS, ...), IN PLACE over the layer
    axis.  The pool is never rebound (a captured decode graph holds its
    address); the engine swaps the slot's table entry to ``dst`` before
    the slot's first write at the divergence point."""
    pool[:, dst].copy_(pool[:, src])
    return pool


def paged_gather(pool: torch.Tensor, block_table: torch.Tensor):
    """Each slot's logical KV strip (B, MB*BS, ...) gathered block by
    block.  Unmapped entries gather block 0, so callers mask by
    ``mapped_span``, not by the raw depth."""
    g = pool[torch.clamp(block_table.long(), min=0)]         # (B, MB, BS, ...)
    return g.reshape(g.shape[0], -1, *pool.shape[2:])


def mapped_span(block_table: torch.Tensor, block_size: int,
                cache_len) -> torch.Tensor:
    """Readable depth per slot: ``cache_len`` clamped to the tokens the
    row's leading mapped blocks span (mapped entries form a prefix)."""
    mapped = (block_table >= 0).long()
    leading = torch.cumprod(mapped, dim=1).sum(dim=1)
    lens = torch.broadcast_to(torch.as_tensor(cache_len).reshape(-1),
                              (block_table.shape[0],))
    return torch.minimum(lens.long(), leading * block_size)


# --------------------------------------------------------------------------
# attention block (GQA, optional QKV bias, RoPE)
# --------------------------------------------------------------------------

def init_attention(gen, cfg: ArchConfig, device, lead=()):
    """Attention weights; ``lead`` prepends a stacking shape (layers)."""
    d, hd, H, Hkv = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    dt = dtype_of(cfg)
    p = {
        "wq": he_init(gen, (*lead, d, H * hd), d, dt, device),
        "wk": he_init(gen, (*lead, d, Hkv * hd), d, dt, device),
        "wv": he_init(gen, (*lead, d, Hkv * hd), d, dt, device),
        "wo": he_init(gen, (*lead, H * hd, d), H * hd, dt, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", Hkv * hd),
                            ("bv", Hkv * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dt, device=device)
    return p


def _qkv(p, cfg: ArchConfig, x: torch.Tensor, rot: tuple, tp=None):
    """(q, k, v), each (B, S, heads, hd): the rank's own heads where
    ``heads_local``, else all of them (sharded columns gathered)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _mm(x, p["wq"])
    k = _mm(x, p["wk"])
    v = _mm(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if heads_local(cfg, tp):
        H, Hkv = H // tp.size, Hkv // tp.size
    else:
        q = _whole(q, H * hd, tp)
        k = _whole(k, Hkv * hd, tp)
        v = _whole(v, Hkv * hd, tp)
    q = rope(q.reshape(B, S, H, hd), rot)
    k = rope(k.reshape(B, S, Hkv, hd), rot)
    return q, k, v.reshape(B, S, Hkv, hd)


def apply_attention(p, cfg: ArchConfig, x: torch.Tensor, *,
                    rot: Optional[tuple] = None, causal: bool = True,
                    kv_cache: Optional[tuple] = None,
                    cache_len: Optional[torch.Tensor] = None,
                    block_table: Optional[torch.Tensor] = None,
                    kv_index: Optional[tuple] = None,
                    cross_kv: Optional[tuple] = None, tp=None):
    """Returns (out, new_kv): the computed (k, v) for prefill (no cache),
    or the cache pair after this step's writes for decode.  ``rot`` is
    ``rope_tables`` at the tokens' positions; ``kv_index`` the paged
    write index of this step (``paged_index``), computed here if absent;
    ``causal`` masks the no-cache prefill (False: the encoder).

    ``cross_kv`` = (k, v), (B, S_enc, Hkv, D) encoder memory from
    ``make_cross_kv``: cross-attention, whose query takes no RoPE, attends
    all of it (non-causal) and returns ``new_kv`` None.

    ``block_table`` selects the paged layout (``kv_cache`` is then a pair
    of (NB + 1, BS, Hkv, D) pools, written in place); ``cfg.decode_attn``
    picks the paged read: ``'gather'`` materializes the logical strip and
    masks by ``mapped_span`` (the reference), ``'kernel'`` runs the
    block-sparse CUDA kernel (plain version on CPU tensors) that reads
    only mapped blocks below the depth.  The dense layout writes the
    (B, max_len, Hkv, D) strips in place; a position past max_len is
    dropped.

    ``tp``: the rank's mesh handle (see the module docstring); the caches
    then hold the rank's kv heads where ``heads_local``, and the decode
    kernel takes its split from the unsharded head count, so that each
    head's reduction runs as in the unsharded call."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    if cross_kv is not None:
        q = _mm(x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        if not heads_local(cfg, tp):
            q = _whole(q, H * hd, tp)
        out = flash_attention(q.reshape(B, S, -1, hd), *cross_kv,
                              causal=False, q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk)
        return _attn_out(p, out, cfg, tp), None
    q, k, v = _qkv(p, cfg, x, rot, tp)
    if kv_cache is None:
        out = flash_attention(q, k, v, causal=causal,
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk)
        new_kv = (k, v)
    else:
        kc, vc = kv_cache
        lens = torch.broadcast_to(torch.as_tensor(cache_len).reshape(-1),
                                  (B,))
        if block_table is not None:
            kv_index = kv_index or paged_index(kc.shape[0], kc.shape[1],
                                               block_table, lens, S)
            paged_scatter(kc, block_table, lens, k, kv_index)
            paged_scatter(vc, block_table, lens, v, kv_index)
            if cfg.decode_attn == "kernel" and S == 1:
                from repro_torch.kernels.ops import paged_decode_attention
                out = paged_decode_attention(q, kc, vc, block_table,
                                             lens + S,
                                             kv_heads=cfg.num_kv_heads)
            else:
                eff = mapped_span(block_table, kc.shape[1], lens + S)
                out = decode_attention(q, paged_gather(kc, block_table),
                                       paged_gather(vc, block_table), eff)
        else:
            if S != 1:
                raise ValueError("dense-cache attention takes one token per "
                                 "slot")
            max_len = kc.shape[1]
            rows = torch.arange(B, device=x.device)
            idx = lens.long()
            keep = (idx < max_len)[:, None, None]
            at = torch.clamp(idx, max=max_len - 1)
            kc[rows, at] = torch.where(keep, k[:, 0].to(kc.dtype), kc[rows, at])
            vc[rows, at] = torch.where(keep, v[:, 0].to(vc.dtype), vc[rows, at])
            out = decode_attention(q, kc, vc, lens + S)
        new_kv = (kc, vc)
    return _attn_out(p, out, cfg, tp), new_kv


def apply_attention_suffix(p, cfg: ArchConfig, x: torch.Tensor, *,
                           prefix_kv: tuple, prefix_len: int, rot: tuple,
                           tp=None):
    """Prefill continuation: attention for the UNCACHED suffix of a prompt
    whose first ``prefix_len`` positions already live in the KV cache (a
    prefix-cache hit).

    x: (B, S, d) suffix hidden states at absolute positions ``prefix_len
    + [0, S)``; ``prefix_kv``: (k, v) logical strips (B, prefix_len, Hkv,
    D), exactly the cached span; ``rot``: ``rope_tables`` at the suffix
    positions.  Returns (out, (k_suffix, v_suffix)), the suffix K/V that
    the caller scatters into the pool at logical offset ``prefix_len``.

    Bit for bit against the cold batch prefill: the same
    ``flash_attention`` over exactly ``prefix_len + S`` keys, the cached
    prefix concatenated with the suffix K/V, so the suffix rows see the
    cold path's operands at the same indices and the same reduction
    extent (the engine pads the suffix to the cold bucket).  Query rows
    are independent, so the query chunking may differ."""
    q, k, v = _qkv(p, cfg, x, rot, tp)
    kc, vc = prefix_kv
    ks = torch.cat([kc.to(k.dtype), k], dim=1)
    vs = torch.cat([vc.to(v.dtype), v], dim=1)
    out = flash_attention(q, ks, vs, causal=True, q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk, q_offset=prefix_len)
    return _attn_out(p, out, cfg, tp), (k, v)


def apply_attention_chunk(p, cfg: ArchConfig, x: torch.Tensor, *,
                          kv_pools: tuple, block_row: torch.Tensor,
                          offset: int, span: int, rot: tuple,
                          kv_index: tuple, tp=None):
    """Chunked-prefill attention for ONE slot against its paged KV pool.

    x: (1, S, d) hidden states of the prompt chunk at absolute positions
    ``offset + [0, S)``; ``block_row``: (1, MB) the slot's table row;
    ``span``: token extent of the whole prompt's attention reduction;
    ``rot`` / ``kv_index``: the chunk's RoPE tables and pool write index,
    shared by every layer.
    The chunk's K/V are scattered into the pools first (in place), then
    the leading ``span`` tokens are attended causally — by the
    block-sparse prefill kernel when ``cfg.decode_attn == 'kernel'``,
    else by gather + ``flash_attention`` (the reference).  The prefill
    kernel's grid is (kv head, row block): a head's walk does not depend
    on how many heads the pool holds, so a rank's own heads need no
    unsharded count."""
    q, k, v = _qkv(p, cfg, x, rot, tp)
    kc, vc = kv_pools
    paged_scatter(kc, block_row, None, k, kv_index)
    paged_scatter(vc, block_row, None, v, kv_index)
    nb = -(-span // kc.shape[1])
    row = block_row[:, :nb]
    if cfg.decode_attn == "kernel":
        from repro_torch.kernels.ops import paged_prefill_attention
        out = paged_prefill_attention(q, kc, vc, row, offset, span=span,
                                      kv_chunk=cfg.attn_kv_chunk)
    else:
        ks = paged_gather(kc, row)[:, :span]
        vs = paged_gather(vc, row)[:, :span]
        out = flash_attention(q, ks, vs, causal=True,
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk, q_offset=offset)
    return _attn_out(p, out, cfg, tp), (kc, vc)


def make_cross_kv(p, cfg: ArchConfig, enc_out: torch.Tensor, tp=None):
    """Cross-attention K/V, each (B, S_enc, Hkv, D), from the encoder
    output: the projections alone, no bias and no RoPE (as the reference
    computes them); the rank's own kv heads where ``heads_local``."""
    B, S, _ = enc_out.shape
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    k, v = _mm(enc_out, p["wk"]), _mm(enc_out, p["wv"])
    if not heads_local(cfg, tp):
        k, v = _whole(k, Hkv * hd, tp), _whole(v, Hkv * hd, tp)
    return k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd)


# --------------------------------------------------------------------------
# MLP (gated silu/gelu or nemotron squared-ReLU)
# --------------------------------------------------------------------------

def init_mlp(gen, cfg: ArchConfig, device, lead=()):
    d, ff = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    if cfg.mlp_activation == "relu2":
        return {"w1": he_init(gen, (*lead, d, ff), d, dt, device),
                "w2": he_init(gen, (*lead, ff, d), ff, dt, device)}
    return {"w1": he_init(gen, (*lead, d, ff), d, dt, device),   # gate
            "w3": he_init(gen, (*lead, d, ff), d, dt, device),   # up
            "w2": he_init(gen, (*lead, ff, d), ff, dt, device)}  # down


def apply_mlp(p, cfg: ArchConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The MLP; under a mesh w1 / w3 give the rank its ff columns and the
    activation is elementwise; the (…, ff) product is gathered once
    before a whole ``w2`` (serving), or meets the rank's rows of ``w2``
    and leaves partial sums (training)."""
    if cfg.mlp_activation == "relu2":
        h = torch.square(F.relu(_mm(x, p["w1"])))
    else:
        g = _mm(x, p["w1"])
        u = _mm(x, p["w3"])
        act = F.silu(g) if cfg.mlp_activation == "silu" \
            else F.gelu(g, approximate="tanh")
        h = act * u
    return _mm(_whole(h, p["w2"].shape[-2], tp), p["w2"])


# --------------------------------------------------------------------------
# embeddings + (Bayesian) output head
# --------------------------------------------------------------------------

def init_embed(gen, cfg: ArchConfig, device):
    return {"table": he_init(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model,
                             dtype_of(cfg), device)}


def apply_embed(p, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The table's rows of ``tokens``.  With a train mesh's model axis
    (``tp``) the table holds the rank's block of vocabulary rows: each
    rank reads the tokens of its rows (zeros for the others) and the
    ranks' rows are all-reduced, a sum of one row and zeros, exact."""
    t, tokens = p["table"], tokens.long()
    if tp is None or tp.size == 1:
        return t[tokens]
    n = t.shape[0]
    idx = tokens - tp.index * n
    mine = (idx >= 0) & (idx < n)
    x = t[idx.clamp(0, n - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return C.reduce(x, tp)


def init_head(gen, cfg: ArchConfig, device, train: bool = False):
    """The Gaussian-variational output projection: mu ~ N(0, 1)/sqrt(d)
    and rho = inv_softplus(head_init_sigma), both f32.  As SERVING
    parameters (the default) the head is ``{"mu", "sigma"}`` with sigma =
    softplus(rho) computed here once (the head is frozen while serving),
    not inside every decode step; its TRAINING form (``train``) is
    ``{"mu", "rho"}``, the leaves SVI trains (``serving_head`` turns it
    into the serving form)."""
    shape = (cfg.d_model, cfg.vocab_size)
    mu = torch.randn(shape, generator=gen, dtype=torch.float32,
                     device=device) / math.sqrt(float(cfg.d_model))
    init = max(cfg.head_init_sigma, 1e-8)
    rho = torch.full(shape, math.log(math.expm1(init)), dtype=torch.float32,
                     device=device)
    if train:
        return {"mu": mu, "rho": rho}
    return {"mu": mu, "sigma": F.softplus(rho)}


@torch.no_grad()
def serving_head(head: dict) -> dict:
    """The serving form ``{"mu", "sigma"}`` of a head in training form
    ``{"mu", "rho"}``: sigma = softplus(rho) computed once, mu the same
    tensor (no copy).  A serving-form head is returned as it is."""
    if "rho" not in head:
        return head
    return {"mu": head["mu"], "sigma": F.softplus(head["rho"])}


def head_logits_mean(p, x: torch.Tensor, cfg: ArchConfig,
                     tp=None) -> torch.Tensor:
    """The mean head's f32 logits; a head sharded on its vocabulary
    columns is gathered along V before the softcap."""
    logits = _whole(x.float() @ p["mu"], cfg.vocab_size, tp)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def decode_head_noise(seed: int, cache_len: torch.Tensor, num_samples: int,
                      vocab: int) -> torch.Tensor:
    """Per-(slot, depth) operand noise for the Bayesian decode head.

    Returns an (S, B, V) f32 xi tensor whose column b is a pure function
    of (seed, slot b, depth cache_len[b]) — never of the engine's global
    step — so two schedules that reach the same (slot, depth) through
    different interleavings draw identical variates.  Drawn from the
    Philox stream keyed by (seed, depth) at counters (v, b, s, operand
    tag), disjoint from the in-kernel head stream.
    """
    depths = torch.as_tensor(cache_len).reshape(-1).long()
    dev = depths.device
    B = depths.shape[0]
    v = torch.arange(vocab, dtype=torch.int64, device=dev)[None, None, :]
    b = torch.arange(B, dtype=torch.int64, device=dev)[None, :, None]
    s = torch.arange(num_samples, dtype=torch.int64, device=dev)[:, None,
                                                                 None]
    w0, w1, _, _ = rng.philox4x32(v, b, s, rng.TAG_OPERAND, seed,
                                  depths[None, :, None])
    return rng.normal_from_bits(w0, w1)


def head_logits_sampled(p, x: torch.Tensor, cfg: ArchConfig,
                        xi: torch.Tensor, tp=None) -> torch.Tensor:
    """One LRT draw of the Bayesian head per leading xi index: x (..., d),
    xi (..., V) -> f32 logits.  A head sharded on its vocabulary columns
    gives the rank its columns of the mean and the variance, gathered
    along V before the combine (JAX ``layers.py``'s two ``gather_rep``)."""
    x32 = x.float()
    V = cfg.vocab_size
    mean = _whole(x32 @ p["mu"], V, tp)
    var = _whole((x32 * x32) @ (p["sigma"] ** 2), V, tp)
    logits = mean + torch.sqrt(torch.clamp(var, min=0.0)) * xi
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# --------------------------------------------------------------------------
# training under a D x M mesh (``launch.mesh.TrainMesh``)
# --------------------------------------------------------------------------
#
# ``spec`` trees are a layer's leaves' specs (``sharding.partition``), the
# layer axis dropped.  The residual stream ``x`` is whole on every model
# rank, or S-sharded over ``model`` where ``sp`` (the sequence-parallel
# stream, the JAX ``constrain_seq``): a product's input is then gathered
# along S and a row-parallel output reduce-scattered back, where the plain
# layout copies in and all-reduces out.  With no mesh each is the
# identity.

def gathered(tree: dict, spec: dict, mesh) -> dict:
    """``tree``'s leaves as their products use them: a leaf whose spec
    puts ``data`` on an axis (FSDP; alone, or first in ``("data",
    "model")``) gathered over ``data`` along it (its backward
    reduce-scatters the gradient); the rest as they are.  An axis on
    ``("data", "model")`` (block d·M + m) gathered over ``data`` leaves
    model rank m blocks m, M + m, ... of it, the same blocks in every
    leaf of that layout."""
    def one(w, sp):
        for axis, entry in enumerate(sp):
            if entry == "data" or (isinstance(entry, tuple)
                                   and "data" in entry):
                return C.gather(w, mesh.data, axis)
        return w

    return {k: gathered(v, spec[k], mesh) if isinstance(v, dict)
            else one(v, spec[k]) for k, v in tree.items()}


def gathered_model(w: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """``w`` whole over ``model`` where its spec splits an axis on
    ``model`` alone (a weight every model rank reads columns of, its own
    and others'): all-gathered along that axis, the backward
    reduce-scattering the ranks' partial gradients back to the rank's
    block; ``w`` itself otherwise."""
    for axis, entry in enumerate(spec):
        if entry == "model":
            return C.gather(w, mesh.model, axis, grad="sum")
    return w


def enter(x: torch.Tensor, mesh, sp: bool) -> torch.Tensor:
    """A column-parallel product's whole-S input from the stream."""
    if mesh is None:
        return x
    return C.gather(x, mesh.model, 1) if sp else C.copy(x, mesh.model)


def leave(y: torch.Tensor, mesh, sp: bool) -> torch.Tensor:
    """A row-parallel product's partial sums back into the stream."""
    if mesh is None:
        return y
    return C.reduce_scatter(y, mesh.model, 1) if sp \
        else C.reduce(y, mesh.model)
