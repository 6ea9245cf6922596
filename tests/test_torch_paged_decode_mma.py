"""The tensor-core decode kernel's walk and its route, on the CPU.

``paged_decode_attention_plain(..., walk="mma")`` walks the readable
keys as ``paged_decode_mma`` does: 16-key tiles gathered through the
table row, ``tiles`` of them a split, each warp of a split an online
softmax over its own tiles, the warps merged, then the splits.  The walk
is held against the JAX package's gather reference (and once against
its Pallas kernel in interpret mode) on the same numpy inputs, in f32 at
atol 2e-6 (f32 sums in another order, O(1) outputs).  The kernel itself
runs in ``tests/test_torch_kernels_cuda.py`` on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, meshless_reference  # noqa: F401
from repro.kernels import ops as JO
from repro_torch.kernels import paged_attention as PA

# H, Hkv, D, BS, MB, lens, (slot, table entry) set to -1 or None
CASES = {
    # a block holds one tile; slot 1's depth ends mid-tile
    "rep1_D64_BS16": (4, 4, 64, 16, 6, (70, 33, 16, 0), None),
    # the served shape: lens 288 / 150 / 17 / 0 over 19 blocks
    "rep6_D128_BS16_served": (12, 2, 128, 16, 19, (288, 150, 17, 0), None),
    # a tile crosses four blocks
    "rep16_D16_BS4": (16, 1, 16, 4, 24, (93, 41, 5, 0), None),
    # a block holds two tiles
    "rep6_D64_BS32": (12, 2, 64, 32, 5, (150, 64, 31, 0), None),
    # a hole below the depth: slot 0 reads its first 5 blocks only
    "hole_below_depth": (12, 2, 16, 4, 24, (90, 37, 12, 0), (0, 5)),
    # a hole at the first entry: slot 1 reads nothing, like an empty slot
    "hole_at_first_block": (8, 2, 32, 8, 8, (60, 20, 9, 0), (1, 0)),
    # qwen2-7b's group: 7 query heads a kv head, rows 7-15 of the m16
    # fragment padding, at the served depths
    "rep7_D128_BS16": (28, 4, 128, 16, 19, (288, 150, 17, 0), None),
    # codeqwen1.5-7b's MHA over 32 kv heads
    "rep1_D128_Hkv32": (32, 32, 128, 16, 19, (288, 150, 17, 0), None),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    H, Hkv, D, BS, MB, lens, hole = CASES[name]
    r = np.random.default_rng(sum(map(ord, name)))
    B = len(lens)
    NB = B * MB
    k = r.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    v = r.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    q = r.standard_normal((B, 1, H, D)).astype(np.float32)
    perm = r.permutation(NB)
    table = np.full((B, MB), -1, np.int32)
    for b, n in enumerate(lens):
        nb = -(-n // BS)
        table[b, :nb] = perm[b * MB:b * MB + nb]       # shuffled, -1 tail
    if hole is not None:
        table[hole] = -1
    arrs = (q, k, v, table, np.asarray(lens, np.int32))
    want = np.asarray(JO.paged_decode_attention(*map(jnp.asarray, arrs),
                                                impl="ref"))
    return arrs, want


def _empty_slots(name):
    """Slots with no readable key: NaN rows."""
    _, _, _, _, _, lens, hole = CASES[name]
    return {b for b, n in enumerate(lens)
            if n == 0 or (hole is not None and hole == (b, 0))}


@pytest.mark.parametrize("tiles", [1, 2, 3, 4, 5, 8, None])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mma_walk_matches_gather_reference(name, tiles):
    """Every split size from one tile to eight (None: ``decode_tiles``)
    gives the reference's answer; empty slots give NaN rows."""
    arrs, want = _case(name)
    got = PA.paged_decode_attention_plain(*map(torch.from_numpy, arrs),
                                          walk="mma", tiles=tiles)
    assert got.dtype == torch.float32
    assert_close(got, want, atol=2e-6, equal_nan=True)
    empty = _empty_slots(name)
    for b in range(got.shape[0]):
        assert bool(torch.isnan(got[b]).all()) == (b in empty), b
        assert bool(torch.isnan(got[b]).any()) == (b in empty), b


def test_mma_walk_matches_the_pallas_kernel_in_interpret_mode():
    """The JAX package's decode kernel itself (``impl="auto"`` runs it in
    interpret mode off the TPU), on tiles that cross blocks.  Not on a
    hole: the Pallas kernel masks an unmapped entry alone and reads the
    mapped entries after it, where the gather reference (and the port)
    stop at the first -1."""
    arrs, _ = _case("rep16_D16_BS4")
    want = JO.paged_decode_attention(*map(jnp.asarray, arrs), impl="auto")
    got = PA.paged_decode_attention_plain(*map(torch.from_numpy, arrs),
                                          walk="mma", tiles=2)
    assert_close(got, want, atol=2e-6, equal_nan=True)


@pytest.mark.parametrize("name", ["rep6_D128_BS16_served", "rep16_D16_BS4",
                                  "rep7_D128_BS16"])
def test_mma_walk_bf16_rounds_p_like_the_kernel(name):
    """bf16 operands: the JAX oracle runs in f32 on the same bf16 values;
    the walk rounds p to bf16 before p @ V and its output to bf16 (atol
    2e-2: one bf16 ulp of O(1) outputs).  Rounding p moves the output:
    the f32 walk on the same values is not the bf16 walk."""
    arrs, _ = _case(name)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs[:3])
    table, lens = (torch.from_numpy(a) for a in arrs[3:])
    want = JO.paged_decode_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        jnp.asarray(arrs[3]), jnp.asarray(arrs[4]), impl="ref")
    got = PA.paged_decode_attention_plain(q, k, v, table, lens)
    assert got.dtype == torch.bfloat16
    assert_close(got.float(), want, atol=2e-2, equal_nan=True)
    f32 = PA.paged_decode_attention_plain(q.float(), k.float(), v.float(),
                                          table, lens, walk="mma")
    assert not torch.equal(got.float().nan_to_num(), f32.nan_to_num())


def test_both_walks_agree():
    """The SIMT kernel's walk stays selectable and gives the same
    function."""
    arrs, want = _case("rep6_D64_BS32")
    ts = [torch.from_numpy(a) for a in arrs]
    simt = PA.paged_decode_attention_plain(*ts, walk="simt")
    mma = PA.paged_decode_attention_plain(*ts, walk="mma")
    assert_close(simt, want, atol=2e-6, equal_nan=True)
    assert_close(mma, simt.numpy(), atol=2e-6, equal_nan=True)
    with pytest.raises(ValueError):
        PA.paged_decode_attention_plain(*ts, walk="wgmma")


def test_decode_route_by_dtype_and_head_dim():
    for d in (16, 32, 64, 96, 112, 128):
        assert PA.decode_route(torch.bfloat16, d) == "mma"
    for d in (8, 72, 100):
        assert PA.decode_route(torch.bfloat16, d) == "simt"
    for d in (8, 64, 128):
        assert PA.decode_route(torch.float32, d) == "simt"


def test_decode_tiles_covers_the_card_and_the_table():
    assert PA.decode_tiles(4, 2, 19, 16) == PA.DECODE_MIN_TILES
    for b, g, mb, bs in ((4, 2, 19, 16), (64, 2, 19, 16), (4, 2, 256, 16),
                         (1, 1, 1, 4), (3, 1, 7, 32), (16, 4, 100, 8)):
        tiles = PA.decode_tiles(b, g, mb, bs)
        table_tiles = -(-mb * bs // PA.DECODE_KEY_TILE)
        assert 1 <= tiles <= table_tiles
        splits = -(-table_tiles // tiles)
        if tiles > PA.DECODE_MIN_TILES:     # as many splits as the target
            assert b * g * (splits + 1) > PA.DECODE_MMA_TARGET


def test_forced_mma_route_raises_on_f32():
    """No fallback: a forced "mma" on f32 operands raises before any
    launch, and so does an unknown route."""
    arrs, _ = _case("rep1_D64_BS16")
    ts = [torch.from_numpy(a) for a in arrs]
    with pytest.raises(ValueError, match="mma decode route"):
        PA.paged_decode_attention_cuda(*ts, route="mma")
    q, k, v = (t.to(torch.bfloat16) for t in ts[:3])
    with pytest.raises(ValueError, match="route must be"):
        PA.paged_decode_attention_cuda(q, k, v, *ts[3:], route="wgmma")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        PA.paged_decode_attention_cuda(q, k, v, *ts[3:], route="mma")
