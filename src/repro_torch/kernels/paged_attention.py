"""Block-sparse paged attention (decode + prefill): the CUDA kernels and
their plain PyTorch versions.

Counterparts of ``repro.kernels.paged_attention``'s two Pallas kernels.
The pool is a global (NB, BS, Hkv, D) array of BS-token blocks; a slot's
table row maps its logical block j to a physical block (-1 = unmapped).

* decode: one query token per slot against the blocks below
  ``ceil(cache_len / BS)``; reading stops at the first -1 entry, which
  is the gather reference's ``mapped_span`` clamp (mapped entries form a
  prefix of a row).  A slot with no readable position returns NaN, like
  the reference softmax over an all -inf row.  Two kernels, chosen by
  dtype and head dim (``decode_route``): bf16 with ``D % 16 == 0`` runs
  the tensor-core kernel, one launch: the readable keys in 16-key tiles,
  ``decode_tiles`` consecutive tiles a split, the warps of a split
  taking its tiles in turn with an online softmax each, merged in the
  block, and the splits' partials merged by the last split to finish.
  f32, and bf16 at other head dims, run the SIMT kernel: runs of
  ``decode_split`` table blocks, each with its own online softmax, then
  a merge launch (flash-decoding).
* prefill: the S queries of one slot's prompt chunk at absolute
  positions ``offset + [0, S)``, causal, over the leading ``span`` tokens
  of its row; -1 entries read block 0 unmasked (the gather reference
  does the same); the output is ``acc / max(l, 1e-20)`` (a fully masked
  row gives 0).  Two kernels, chosen by dtype and head dim
  (``prefill_route``): bf16 with ``D % 16 == 0`` runs the tensor-core
  kernel (one sweep over 64-key tiles with an online softmax per tile,
  tiles above each block's highest query position skipped); f32, and
  bf16 at other head dims, run the SIMT kernel (the reference's
  recurrence per ``kv_chunk`` group).  ``kv_chunk`` is a schedule and
  does not change the function.

Bitwise equality with the gather path is not a goal: the kernels and
the plain versions below are held to it with f32 tolerances.  The plain
versions follow the kernels' loops (the decode walk of either kernel,
chosen like the kernel; 64-key prefill tiles with the same skip; for
bf16 on the tensor cores, p rounded to bf16 before p @ V) and are what
``ops.py`` runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, launches

MAX_REP = 16
MAX_HEAD_DIM = 128
# SIMT decode kernel blocks to aim for: two per SM of a 132-SM H100
SPLIT_TARGET = 264
# the tensor-core decode kernel: keys per tile and warps per block
# (csrc/paged_attention.cu DK_T, DK_WARPS); blocks to aim for, and the
# fewest tiles a split takes (set from chip_smoke.py's split sweep)
DECODE_KEY_TILE = 16
DECODE_WARPS = 4
DECODE_MMA_TARGET = 132
DECODE_MIN_TILES = 4
DECODE_ROUTES = ("simt", "mma")  # the C entry point's route argument
# the tensor-core prefill kernel: keys per tile, and query rows per block
# (4 warps of 16 rows; csrc/paged_attention.cu PF_KT, PF_ROWS)
PREFILL_KEY_TILE = 64
PREFILL_BLOCK_ROWS = 64


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def decode_split(batch: int, kv_heads: int, table_width: int) -> int:
    """Logical blocks per split of the SIMT decode kernel: enough splits
    that the (slot, kv head, split) grid covers the card about twice
    (``SPLIT_TARGET`` blocks), never more splits than table entries."""
    splits = max(1, -(-SPLIT_TARGET // max(batch * kv_heads, 1)))
    return max(1, -(-table_width // min(splits, table_width)))


def decode_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which decode kernel a CUDA call launches: ``"mma"`` (tensor cores)
    for bf16 with a head dim that is a multiple of 16, else ``"simt"``."""
    return "mma" if dtype == torch.bfloat16 and head_dim % 16 == 0 \
        else "simt"


def decode_tiles(batch: int, kv_heads: int, table_width: int,
                 block_size: int) -> int:
    """16-key tiles per split of the tensor-core decode kernel: enough
    splits that the (slot, kv head, split) grid covers about
    ``DECODE_MMA_TARGET`` blocks, at least ``DECODE_MIN_TILES`` tiles a
    split, never more tiles than the table spans."""
    table_tiles = -(-table_width * block_size // DECODE_KEY_TILE)
    splits = max(1, -(-DECODE_MMA_TARGET // max(batch * kv_heads, 1)))
    tiles = max(DECODE_MIN_TILES, -(-table_tiles // splits))
    return max(1, min(tiles, table_tiles))


def _merge(m, l, acc, dim: int):
    """Online-softmax partials merged along ``dim``: the parts that read
    nothing hold (-inf, 0, 0) and weigh 0."""
    mx = m.max(dim=dim, keepdim=True).values
    c = torch.where(torch.isinf(m), 0.0,
                    torch.exp(m - torch.where(torch.isinf(mx), 0.0, mx)))
    return (mx.squeeze(dim), (l * c).sum(dim=dim),
            (acc * c[..., None]).sum(dim=dim))


def _decode_plain_mma(q, k_pool, v_pool, block_table, cache_len,
                      tiles: int | None):
    """The tensor-core kernel's walk (``paged_decode_attention_plain``)."""
    B, _, H, D = q.shape
    _, BS, Hkv, _ = k_pool.shape
    MB = block_table.shape[1]
    rep = H // Hkv
    kt, W = DECODE_KEY_TILE, DECODE_WARPS
    dev = q.device
    tiles = tiles or decode_tiles(B, Hkv, MB, BS)
    NS = -(-(-(-MB * BS // kt)) // tiles)
    rounds = -(-tiles // W)              # tiles a warp takes in a split
    npos = NS * rounds * W * kt          # positions walked, padded
    # not at the top: models.layers imports this package
    from repro_torch.models.layers import mapped_span
    nkeys = mapped_span(block_table, BS, cache_len).to(dev)
    # key position of (split, round, warp, key in tile): tile s*tiles +
    # round*W + warp; tiles past the split's end are masked like the keys
    # past the prefix (a fully masked step leaves m, l, acc unchanged)
    s_i, r_i, w_i, k_i = torch.meshgrid(
        *(torch.arange(n, device=dev) for n in (NS, rounds, W, kt)),
        indexing="ij")
    tile = s_i * tiles + r_i * W + w_i
    pos = (tile * kt + k_i).reshape(-1)
    in_split = (r_i * W + w_i < tiles).reshape(-1)
    live = in_split[None, :] & (pos[None, :] < nkeys[:, None])    # (B, npos)
    blk = torch.clamp(pos // BS, max=MB - 1)
    phys = torch.where(live, block_table.long()[:, blk], 0)
    kb = torch.where(live[..., None, None], k_pool[phys, pos % BS].float(),
                     0.0)                                         # (B, npos,
    vb = torch.where(live[..., None, None], v_pool[phys, pos % BS].float(),
                     0.0)                                         # Hkv, D)
    qg = q[:, 0].float().reshape(B, Hkv, rep, D)
    s = torch.einsum("bgrd,bngd->bgrn", qg, kb) * (1.0 / math.sqrt(D))
    s = torch.where(live[:, None, None, :], s, -math.inf)
    shape = (B, Hkv, rep, NS, rounds, W, kt)
    s = s.reshape(shape)
    vb = vb.reshape(B, NS, rounds, W, kt, Hkv, D)
    p_bf16 = q.dtype == torch.bfloat16
    m = torch.full((B, Hkv, rep, NS, W), -math.inf, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, rep, NS, W, D), device=dev)
    for r in range(rounds):           # each warp's tiles in turn
        st = s[:, :, :, :, r]                               # (.., NS, W, kt)
        m2 = torch.maximum(m, st.max(dim=-1).values)
        m2s = torch.where(torch.isinf(m2), 0.0, m2)
        p = torch.where(torch.isinf(st), 0.0, torch.exp(st - m2s[..., None]))
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m2s))
        pv = p.to(torch.bfloat16).float() if p_bf16 else p
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrswk,bswkgd->bgrswd", pv, vb[:, :, r])
        m = m2
    m, l, acc = _merge(m, l, acc, dim=4)          # the warps of a split
    m, l, acc = _merge(m, l, acc, dim=3)          # the splits
    # nothing readable: 0 / 0 = NaN, the reference's fully masked row
    out = torch.where(l[..., None] > 0, acc / l[..., None], math.nan)
    return out.reshape(B, 1, H, D).to(q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, block_table, cache_len,
                                 nb_split: int | None = None, *,
                                 walk: str | None = None,
                                 tiles: int | None = None):
    """q (B, 1, H, D); pools (NB, BS, Hkv, D); table (B, MB) int32;
    cache_len () or (B,) -> (B, 1, H, D) in q.dtype.

    Walks the readable keys as the kernel of ``walk`` does (by default
    the one ``decode_route`` picks for q's dtype and head dim):
    ``"mma"``: 16-key tiles, ``tiles`` of them a split (default
    ``decode_tiles``), each warp of a split an online softmax over its
    tiles, for bf16 inputs p rounded to bf16 before p @ V (the sums keep
    the f32 p), the warps merged, then the splits.  ``"simt"``: runs of
    ``nb_split`` table blocks (default ``decode_split``), an online
    softmax per run, the runs merged."""
    D = q.shape[3]
    walk = walk or decode_route(q.dtype, D)
    if walk not in DECODE_ROUTES:
        raise ValueError(f"walk must be one of {DECODE_ROUTES}, got {walk!r}")
    if walk == "mma":
        return _decode_plain_mma(q, k_pool, v_pool, block_table, cache_len,
                                 tiles)
    B, _, H, D = q.shape
    _, BS, Hkv, _ = k_pool.shape
    MB = block_table.shape[1]
    rep = H // Hkv
    nb_split = nb_split or decode_split(B, Hkv, MB)
    lens = torch.broadcast_to(torch.as_tensor(cache_len).reshape(-1),
                              (B,)).tolist()
    table = block_table.tolist()
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    out = torch.empty((B, 1, H, D), dtype=torch.float32, device=dev)
    for b in range(B):
        qb = q[b, 0].float().reshape(Hkv, rep, D) * scale
        # the readable prefix: below the depth and before the first -1
        readable = min(-(-lens[b] // BS), MB)
        readable = next((j for j in range(readable) if table[b][j] < 0),
                        readable)
        parts = []
        for j0 in range(0, MB, nb_split):
            m = torch.full((Hkv, rep), -math.inf, device=dev)
            l = torch.zeros((Hkv, rep), device=dev)
            acc = torch.zeros((Hkv, rep, D), device=dev)
            for j in range(j0, min(j0 + nb_split, readable)):
                phys = table[b][j]
                kb = k_pool[phys].float()      # (BS, Hkv, D)
                vb = v_pool[phys].float()
                s = torch.einsum("grd,tgd->grt", qb, kb)
                pos = j * BS + torch.arange(BS, device=dev)
                s = torch.where(pos < lens[b], s, -math.inf)
                m2 = torch.maximum(m, s.max(dim=-1).values)
                corr = torch.exp(m - m2)
                p = torch.exp(s - m2[..., None])
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum("grt,tgd->grd",
                                                           p, vb)
                m = m2
            parts.append((m, l, acc))
        # merge the runs; a run that read nothing holds (-inf, 0, 0)
        _, l, acc = _merge(*(torch.stack([p[i] for p in parts])
                             for i in range(3)), dim=0)
        # nothing readable: 0 / 0 = NaN, the reference's fully masked row
        out[b, 0] = torch.where(l[..., None] > 0, acc / l[..., None],
                                math.nan).reshape(H, D)
    return out.to(q.dtype)


def prefill_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which prefill kernel a CUDA call launches: ``"mma"`` (tensor cores)
    for bf16 with a head dim that is a multiple of 16, else ``"simt"``."""
    return "mma" if dtype == torch.bfloat16 and head_dim % 16 == 0 \
        else "simt"


def prefill_tiles(rows: int, S: int, offset: int, span: int,
                  device=None) -> torch.Tensor:
    """(rows,) number of 64-key tiles the tensor-core kernel walks for each
    query row: its block of ``PREFILL_BLOCK_ROWS`` rows stops before the
    first tile whose first key lies above the block's highest query
    position ``offset + max(r % S)``."""
    br, kt = PREFILL_BLOCK_ROWS, PREFILL_KEY_TILE
    first = torch.arange(rows, device=device) // br * br
    last = torch.clamp(first + br, max=rows) - 1
    qmax = offset + torch.where(last // S != first // S, S - 1, last % S)
    walked = torch.clamp(qmax // kt + 1, max=-(-span // kt))
    return torch.where(qmax < 0, 0, walked)


def paged_prefill_attention_plain(q, k_pool, v_pool, block_row, offset,
                                  span: int, kv_chunk: int = 1024, *,
                                  skip: bool = True):
    """q (1, S, H, D) at positions offset + [0, S); pools (NB, BS, Hkv,
    D); block_row (1, NBLK) covering ``span`` tokens -> (1, S, H, D).

    Walks the tensor-core kernel's loop: 64-key tiles, an online softmax
    step per tile with the reference's -inf guards, and for bf16 inputs p
    rounded to bf16 before p @ V (the row sums keep the f32 p).  A row
    takes no step for the tiles its block skips (``prefill_tiles``);
    ``skip=False`` walks every tile, which gives the same output: a
    skipped tile is fully masked for every row of its block.
    ``kv_chunk`` is the TPU kernel's schedule and does not change the
    function; it is accepted for the kernels' signature."""
    del kv_chunk
    _, S, H, D = q.shape
    _, BS, Hkv, _ = k_pool.shape
    rep = H // Hkv
    R = rep * S
    dev = q.device
    row = torch.clamp(block_row.reshape(-1).long(), min=0)
    off = int(offset)
    kt = PREFILL_KEY_TILE
    scale = 1.0 / math.sqrt(D)
    p_bf16 = q.dtype == torch.bfloat16
    # rows flatten (replica, query) -> replica * S + query, per kv head
    qg = q[0].float().reshape(S, Hkv, rep, D).permute(1, 2, 0, 3)
    qg = qg.reshape(Hkv, R, D)
    qpos = off + torch.arange(R, device=dev) % S
    walked = prefill_tiles(R, S, off, span, dev)
    m = torch.full((Hkv, R), -math.inf, device=dev)
    l = torch.zeros((Hkv, R), device=dev)
    acc = torch.zeros((Hkv, R, D), device=dev)
    for t in range(-(-span // kt)):
        kpos = torch.arange(t * kt, min(t * kt + kt, span), device=dev)
        phys = row[kpos // BS]
        kb = k_pool[phys, kpos % BS].float()            # (n, Hkv, D)
        vb = v_pool[phys, kpos % BS].float()
        s = torch.einsum("grd,ngd->grn", qg, kb) * scale
        s = torch.where(kpos[None, None, :] <= qpos[None, :, None], s,
                        -math.inf)
        m2 = torch.maximum(m, s.max(dim=-1).values)
        m2s = torch.where(torch.isinf(m2), 0.0, m2)
        p = torch.where(torch.isinf(s), 0.0, torch.exp(s - m2s[..., None]))
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m2s))
        pv = p.to(torch.bfloat16).float() if p_bf16 else p
        l2 = l * corr + p.sum(dim=-1)
        acc2 = acc * corr[..., None] + torch.einsum("grn,ngd->grd", pv, vb)
        if skip:
            live = (t < walked)[None, :]
            m, l = torch.where(live, m2, m), torch.where(live, l2, l)
            acc = torch.where(live[..., None], acc2, acc)
        else:
            m, l, acc = m2, l2, acc2
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    out = out.reshape(Hkv, rep, S, D).permute(2, 0, 1, 3).reshape(1, S, H, D)
    return out.to(q.dtype)


def kv_blocks_read(cache_len, mapped_blocks, block_size: int,
                   table_width: int) -> int:
    """Physical KV blocks one decode step reads for one slot: blocks
    spanned by the slot's depth, clamped to what the table maps (the
    kernel's walk in host arithmetic).  The gather path reads the full
    ``table_width`` span regardless."""
    spanned = min(-(-int(cache_len) // block_size), table_width)
    return max(min(spanned, int(mapped_blocks)), 0)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _fns():
    lib = build.load("paged_attention")
    dec, pre = lib.repro_paged_decode, lib.repro_paged_prefill
    if dec.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        dec.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                        p]
        dec.restype = ctypes.c_int
        pre.argtypes = [p, p, p, p, i, i, i, p, i, i, i, i, i, i, i, i,
                        p]
        pre.restype = ctypes.c_int
    return dec, pre


def _check_attn(q, k_pool, v_pool, index, name):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for t, n in ((q, "q"), (k_pool, "k_pool"), (v_pool, "v_pool"),
                 (index, "table")):
        if t.device != dev:
            raise ValueError(f"{n} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q has dtype {q.dtype}, expected float32/bfloat16")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q and the pools must share a dtype")
    if index.dtype != torch.int32:
        raise TypeError(f"block table has dtype {index.dtype}, expected int32")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("pools must be (NB, BS, Hkv, D) and equal")
    H, D = q.shape[2], q.shape[3]
    Hkv = k_pool.shape[2]
    if k_pool.shape[3] != D or H % Hkv or H // Hkv > MAX_REP \
            or D > MAX_HEAD_DIM:
        raise ValueError(f"unsupported heads: H={H} Hkv={Hkv} D={D}")


# the tensor-core decode kernel's partials and last-block counters, per
# device: allocated once (counters zeroed once; every call leaves them at
# 0) and grown when a call needs more, so a call allocates nothing and
# zeroes nothing, and a captured CUDA graph replays it as it is.  Calls on
# one device must run on one stream: two calls in flight at once would
# share the buffers.  A grown buffer's predecessor is kept, for graphs
# captured with it.
_decode_work: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
_decode_work_old: list[tuple[torch.Tensor, torch.Tensor]] = []


def _decode_workspace(device, floats: int, counters: int):
    part, count = _decode_work.get(device, (None, None))
    if part is None or part.numel() < floats or count.numel() < counters:
        if part is not None:
            _decode_work_old.append((part, count))
            floats = max(floats, 2 * part.numel())
            counters = max(counters, 2 * count.numel())
        part = torch.empty((floats,), dtype=torch.float32, device=device)
        count = torch.zeros((counters,), dtype=torch.int32, device=device)
        _decode_work[device] = (part, count)
    return part, count


def paged_decode_attention_cuda(q, k_pool, v_pool, block_table, cache_len,
                                *, route: str | None = None,
                                tiles: int | None = None,
                                nb_split: int | None = None):
    """The decode kernel on CUDA tensors.  Dispatch by dtype and head dim
    (``decode_route``), not a fallback on failure: bf16 with a head dim
    that is a multiple of 16 launches the tensor-core kernel
    (``paged_decode_mma``, one launch, ``tiles`` 16-key tiles a split,
    default ``decode_tiles``); f32, and bf16 at other head dims, launch
    the SIMT kernel and its merge (``paged_decode_simt``, ``nb_split``
    table blocks a split, default ``decode_split``).  ``route``
    ("simt" or "mma") forces one, for tests and ``chip_smoke.py``; a
    forced "mma" that the kernel cannot take raises.  Either launches or
    raises.  Head dims above 128 and more than 16 query heads per kv head
    raise."""
    D = q.shape[-1]
    if route is None:
        route = decode_route(q.dtype, D)
    elif route not in DECODE_ROUTES:
        raise ValueError(f"route must be one of {DECODE_ROUTES}, got "
                         f"{route!r}")
    elif route == "mma" and decode_route(q.dtype, D) != "mma":
        raise ValueError(f"the mma decode route takes bf16 with D % 16 == 0, "
                         f"got {q.dtype} at D {D}")
    _check_attn(q, k_pool, v_pool, block_table, "paged_decode_attention")
    B, one, H, D = q.shape
    _, BS, Hkv, _ = k_pool.shape
    MB = block_table.shape[1]
    if one != 1 or block_table.shape[0] != B:
        raise ValueError(f"q {tuple(q.shape)} / table "
                         f"{tuple(block_table.shape)} mismatch")
    lens = torch.broadcast_to(torch.as_tensor(cache_len, device=q.device)
                              .reshape(-1), (B,)).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if route == "mma":
        if q.data_ptr() % 4 or k_pool.data_ptr() % 16 \
                or v_pool.data_ptr() % 16:
            raise ValueError("the mma decode route needs q 4-byte and the "
                             "pools 16-byte aligned")
        split = tiles or decode_tiles(B, Hkv, MB, BS)
        splits = -(-(-(-MB * BS // DECODE_KEY_TILE)) // split)
        part, count = _decode_workspace(q.device, B * H * splits * (D + 4),
                                        B * Hkv)
        count_ptr = count.data_ptr()
    else:
        split = nb_split or decode_split(B, Hkv, MB)
        splits = -(-MB // split)
        part = torch.empty((B * H * splits * (D + 2),), dtype=torch.float32,
                           device=q.device)
        count_ptr = None
    dec, _ = _fns()
    with torch.cuda.device(q.device):
        rc = dec(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 part.data_ptr(), count_ptr, B, H, Hkv, D, BS, MB, split,
                 int(q.dtype == torch.bfloat16),
                 DECODE_ROUTES.index(route),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"({route} route): CUDA error {rc}")
    launches.COUNTS["paged_decode_attention"] += 1
    return out


def paged_prefill_attention_cuda(q, k_pool, v_pool, block_row, offset,
                                 span: int, kv_chunk: int = 1024):
    """The prefill kernel on CUDA tensors.  Dispatch by dtype and shape,
    not a fallback on failure: bf16 with a head dim that is a multiple of
    16 launches the tensor-core kernel (``paged_prefill_mma``); f32, and
    bf16 at other head dims, launch the SIMT kernel
    (``paged_prefill_simt``).  Either launches or raises.  Head dims
    above 128 and more than 16 query heads per kv head raise."""
    _check_attn(q, k_pool, v_pool, block_row, "paged_prefill_attention")
    one, S, H, D = q.shape
    _, BS, Hkv, _ = k_pool.shape
    nblk = block_row.shape[-1]
    if one != 1 or block_row.numel() != nblk:
        raise ValueError(f"q {tuple(q.shape)} / row {tuple(block_row.shape)} "
                         "must hold one slot")
    if nblk * BS < span:
        raise ValueError(f"row of {nblk} blocks cannot cover span {span}")
    out = torch.empty_like(q)
    _, pre = _fns()
    with torch.cuda.device(q.device):
        rc = pre(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_row.data_ptr(), int(offset), int(span), int(kv_chunk),
                 out.data_ptr(), S, H, Hkv, D, BS, nblk,
                 int(q.dtype == torch.bfloat16),
                 int(prefill_route(q.dtype, D) == "mma"),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill_attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches.COUNTS["paged_prefill_attention"] += 1
    return out
