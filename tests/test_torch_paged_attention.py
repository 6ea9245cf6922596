"""Block-sparse paged attention: the port's plain versions against the
JAX package's gather references.  The CUDA kernels are held against
the plain versions in test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, meshless_reference  # noqa: F401
from repro.kernels import ops as JO
from repro.kernels.paged_attention import kv_blocks_read as j_kv_blocks_read
from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as TL


def _decode_case(seed, H, Hkv, D, BS=4, MB=6, lens=(21, 9, 4, 0),
                 hole=False):
    r = np.random.default_rng(seed)
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
    if hole:
        table[0, 2] = -1        # a hole below the depth: masked from there
    return q, k, v, table, np.asarray(lens, np.int32)


@pytest.mark.parametrize("H,Hkv,D", [(4, 1, 32), (12, 2, 16), (4, 4, 8)])
@pytest.mark.parametrize("hole", [False, True])
def test_plain_decode_matches_gather_reference(H, Hkv, D, hole):
    q, k, v, table, lens = _decode_case(H * D, H, Hkv, D, hole=hole)
    want = JO.paged_decode_attention(*map(jnp.asarray,
                                          (q, k, v, table, lens)),
                                     impl="ref")
    got = PA.paged_decode_attention_plain(
        *map(torch.from_numpy, (q, k, v, table, lens)))
    assert_close(got, want, atol=2e-6, equal_nan=True)
    assert torch.isnan(got[3]).all()        # zero-length slot
    assert not torch.isnan(got[:3]).any()


@pytest.mark.parametrize("nb_split", [1, 2, 4, 6])
@pytest.mark.parametrize("hole", [False, True])
def test_plain_decode_runs_merge_to_the_gather_reference(nb_split, hole):
    """Runs of nb_split blocks, each with its own online softmax, then the
    merge: the same answer however the table is cut."""
    q, k, v, table, lens = _decode_case(7, 12, 2, 16, hole=hole)
    want = JO.paged_decode_attention(*map(jnp.asarray,
                                          (q, k, v, table, lens)),
                                     impl="ref")
    got = PA.paged_decode_attention_plain(
        *map(torch.from_numpy, (q, k, v, table, lens)), nb_split=nb_split)
    assert_close(got, want, atol=2e-6, equal_nan=True)


def test_decode_split_covers_the_card_and_the_table():
    assert PA.decode_split(4, 2, 19) == 1          # 19 runs x 8 = 152 blocks
    assert PA.decode_split(64, 2, 19) == 7         # 3 runs of <= 7 blocks
    assert PA.decode_split(1024, 8, 5) == 5        # one run per slot
    for b, g, mb in ((4, 2, 19), (3, 1, 7), (16, 4, 100)):
        n = PA.decode_split(b, g, mb)
        assert 1 <= n <= mb


@pytest.mark.parametrize("offset,span,kc", [(0, 16, 1024), (8, 24, 8),
                                            (16, 24, 16), (4, 20, 12),
                                            (12, 16, 4)])
def test_plain_prefill_matches_gather_reference(offset, span, kc):
    r = np.random.default_rng(offset + span + kc)
    S, H, Hkv, D, BS = 8, 4, 2, 16, 4
    NB = 12
    k = r.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    v = r.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    q = r.standard_normal((1, S, H, D)).astype(np.float32)
    nblk = -(-span // BS)
    row = r.permutation(NB)[:nblk].astype(np.int32)[None]
    row[0, -1] = -1             # an unmapped entry reads block 0, unmasked
    want = JO.paged_prefill_attention(
        *map(jnp.asarray, (q, k, v, row)), jnp.int32(offset), span=span,
        kv_chunk=kc, impl="ref")
    got = PA.paged_prefill_attention_plain(
        *map(torch.from_numpy, (q, k, v, row)), offset, span, kc)
    assert_close(got, want, atol=2e-6)


def _prefill_case(seed, S, H, Hkv, D, BS, span, hole=None):
    r = np.random.default_rng(seed)
    nblk = -(-span // BS)
    NB = nblk + 4
    k = r.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    v = r.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    q = r.standard_normal((1, S, H, D)).astype(np.float32)
    row = r.permutation(NB)[:nblk].astype(np.int32)[None]
    if hole is not None:
        row[0, hole] = -1       # an unmapped entry inside the span
    return q, k, v, row


# S, H, Hkv, D, BS, offset, span, index of a -1 table entry
PREFILL_TILE_CASES = {
    "S37_rows_cross_replicas": (37, 12, 2, 64, 16, 27, 100, None),
    "span_not_a_multiple_of_64": (20, 4, 2, 64, 8, 130, 150, None),
    "offset0_span256_skips_3_of_4": (64, 12, 2, 128, 16, 0, 256, None),
    "unmapped_entry_in_span": (32, 4, 1, 64, 16, 96, 128, 2),
    "rep1": (24, 4, 4, 64, 16, 40, 64, None),
    "rep16": (9, 16, 1, 64, 16, 100, 130, None),
    "served_offset192_D128": (64, 12, 2, 128, 16, 192, 256, None),
    # qwen2-7b's group of 7: 448 packed rows (replica * S + query)
    "rep7_offset192_D128": (64, 28, 4, 128, 16, 192, 256, None),
}


@pytest.mark.parametrize("kc", [1024, 16])
@pytest.mark.parametrize("case", sorted(PREFILL_TILE_CASES))
def test_plain_prefill_tile_walk_matches_gather_reference(case, kc):
    """The plain version walks the tensor-core kernel's 64-key tiles with
    its skip; at f32 it gives the JAX oracle's answer at every kv_chunk
    (atol 2e-6: f32 sums in another order, O(1) outputs)."""
    S, H, Hkv, D, BS, offset, span, hole = PREFILL_TILE_CASES[case]
    q, k, v, row = _prefill_case(S + span + D, S, H, Hkv, D, BS, span, hole)
    want = JO.paged_prefill_attention(
        *map(jnp.asarray, (q, k, v, row)), jnp.int32(offset), span=span,
        kv_chunk=kc, impl="ref")
    got = PA.paged_prefill_attention_plain(
        *map(torch.from_numpy, (q, k, v, row)), offset, span, kc)
    assert_close(got, want, atol=2e-6)


def test_plain_prefill_bf16_matches_gather_reference():
    """bf16 operands: the JAX oracle runs in f32 on the same bf16 values;
    the plain version rounds p to bf16 before p @ V and its output to
    bf16 (atol 2e-2: one bf16 ulp of O(1) outputs)."""
    S, H, Hkv, D, BS, offset, span, hole = \
        PREFILL_TILE_CASES["served_offset192_D128"]
    arrs = _prefill_case(5, S, H, Hkv, D, BS, span, hole=3)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs[:3])
    row = torch.from_numpy(arrs[3])
    want = JO.paged_prefill_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        jnp.asarray(arrs[3]), jnp.int32(offset), span=span, impl="ref")
    got = PA.paged_prefill_attention_plain(q, k, v, row, offset, span)
    assert got.dtype == torch.bfloat16
    assert_close(got.float(), want, atol=2e-2)


@pytest.mark.parametrize("case", ["S37_rows_cross_replicas",
                                  "offset0_span256_skips_3_of_4",
                                  "span_not_a_multiple_of_64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_prefill_skip_is_exact(case, dtype):
    """Skipping the tiles above a block's highest query position gives
    the very output of a walk that visits every tile."""
    S, H, Hkv, D, BS, offset, span, hole = PREFILL_TILE_CASES[case]
    q, k, v, row = (torch.from_numpy(a) for a in
                    _prefill_case(1, S, H, Hkv, D, BS, span, hole))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    walked = PA.prefill_tiles((H // Hkv) * S, S, offset, span)
    if case == "offset0_span256_skips_3_of_4":
        assert walked.tolist() == [1] * (H // Hkv) * S
    skipped = PA.paged_prefill_attention_plain(q, k, v, row, offset, span)
    full = PA.paged_prefill_attention_plain(q, k, v, row, offset, span,
                                            skip=False)
    assert torch.equal(skipped, full)


@pytest.mark.parametrize("rows,S,offset,span", [
    (384, 64, 0, 256), (384, 64, 192, 256), (444, 37, 27, 100),
    (140, 70, 0, 256), (24, 24, 40, 64), (16, 9, 100, 130), (5, 5, 0, 3)])
def test_prefill_tiles_stop_above_each_block(rows, S, offset, span):
    """Each row walks the tiles up to its block's highest query position,
    with blocks of PREFILL_BLOCK_ROWS rows, and none past the span."""
    br, kt = PA.PREFILL_BLOCK_ROWS, PA.PREFILL_KEY_TILE
    want = []
    for r in range(rows):
        b0 = r // br * br
        top = max(offset + i % S for i in range(b0, min(b0 + br, rows)))
        want.append(sum(1 for t in range(-(-span // kt)) if t * kt <= top))
    assert PA.prefill_tiles(rows, S, offset, span).tolist() == want


def test_prefill_route_by_dtype_and_head_dim():
    assert PA.prefill_route(torch.bfloat16, 128) == "mma"
    assert PA.prefill_route(torch.bfloat16, 96) == "mma"
    assert PA.prefill_route(torch.bfloat16, 72) == "simt"
    assert PA.prefill_route(torch.float32, 128) == "simt"


def test_kv_blocks_read_matches():
    for clen in range(0, 40, 3):
        for mapped in range(0, 8):
            for width in (4, 6, 9):
                assert PA.kv_blocks_read(clen, mapped, 4, width) \
                    == j_kv_blocks_read(clen, mapped, 4, width)


def test_ops_dispatch_cpu_tensors_to_plain():
    q, k, v, table, lens = (torch.from_numpy(a) for a in
                            _decode_case(1, 4, 1, 8))
    a = ops.paged_decode_attention(q, k, v, table, lens)
    b = PA.paged_decode_attention_plain(q, k, v, table, lens)
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    qp = torch.randn((1, 4, 4, 8))
    row = table[:1, :4].clone()
    assert torch.equal(ops.paged_prefill_attention(qp, k, v, row, 0, 12, 8),
                       PA.paged_prefill_attention_plain(qp, k, v, row, 0,
                                                        12, 8))


def test_layers_paging_helpers_match():
    """mapped_span, paged_gather and the sink-dropping paged_scatter."""
    r = np.random.default_rng(3)
    BS, MB, NB = 4, 5, 12
    table = np.full((3, MB), -1, np.int32)
    table[0, :3] = [7, 2, 9]
    table[1, :1] = [4]
    lens = np.array([10, 6, 3], np.int32)
    assert_close(TL.mapped_span(torch.from_numpy(table), BS,
                                torch.from_numpy(lens)),
                 JL.mapped_span(jnp.asarray(table), BS, jnp.asarray(lens)),
                 atol=0)
    pool = r.standard_normal((NB, BS, 2, 3)).astype(np.float32)
    assert_close(TL.paged_gather(torch.from_numpy(pool),
                                 torch.from_numpy(table)),
                 JL.paged_gather(jnp.asarray(pool), jnp.asarray(table)),
                 atol=0)
    new = r.standard_normal((3, 3, 2, 3)).astype(np.float32)
    want = JL.paged_scatter(jnp.asarray(pool), jnp.asarray(table),
                            jnp.asarray(lens), jnp.asarray(new))
    sunk = np.concatenate([pool, np.zeros((1, BS, 2, 3), np.float32)])
    got = TL.paged_scatter(torch.from_numpy(sunk), torch.from_numpy(table),
                           torch.from_numpy(lens), torch.from_numpy(new))
    assert_close(got[:NB], want, atol=0)     # dropped writes hit the sink

