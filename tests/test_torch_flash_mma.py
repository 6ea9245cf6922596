"""The tensor-core flash attention kernel's tile walk, its route and its
kv split, on the CPU.

``flash_attention_plain`` walks the kernel's tiles on request: query
rows packed per (batch, kv head) in blocks of 64, 64-key tiles with the
diagonal skip, kv chunks with f32 partials and their merge.  The walk is
held against the JAX package's Pallas kernel in interpret mode, on the
same numpy inputs.  The kernel itself runs in
``tests/test_torch_kernels_cuda.py`` on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from _torch_parity import assert_close, meshless_reference  # noqa: F401
from repro.kernels import ops as JO
from repro_torch.kernels import ops

FA = importlib.import_module("repro_torch.kernels.flash_attention")


def _case(seed, b, sq, sk, h, hkv, d):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, s, n, d)).astype(np.float32)
            for s, n in ((sq, h), (sk, hkv), (sk, hkv))]


def _walk(q, k, v, kv_splits, **kw):
    """The tensor-core kernel's walk over numpy inputs."""
    return FA.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), bq=FA.FLASH_BLOCK_ROWS,
        bk=FA.FLASH_KEY_TILE, packed=True, kv_splits=kv_splits, **kw)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,q_offset,kv_splits", [
    (2, 37, 37, 6, 2, 16, True, 0, 1),       # rows cross replicas
    (2, 37, 150, 6, 2, 16, True, 113, 3),    # continuation, 3 chunks
    (1, 20, 200, 4, 2, 16, True, 0, 4),      # chunks 1-3 above the diagonal
    (2, 1, 300, 8, 2, 32, True, 299, 5),     # the decode window
    (1, 24, 100, 4, 1, 16, True, -10, 2),    # rows 0-9 see no key
    (2, 33, 90, 4, 4, 16, False, 0, 2),      # non-causal, MHA
    (1, 16, 64, 16, 1, 16, True, 48, 1),     # rep 16
    (1, 70, 130, 2, 1, 32, True, 60, 2),     # two row blocks, one replica
])
def test_mma_walk_matches_jax(b, sq, sk, h, hkv, d, causal, q_offset,
                              kv_splits):
    q, k, v = _case(sq * sk + d, b, sq, sk, h, hkv, d)
    got = _walk(q, k, v, kv_splits, causal=causal, q_offset=q_offset)
    want = JO.flash_attention(q, k, v, impl="pallas", causal=causal,
                              q_offset=q_offset, bq=16, bk=32)
    assert got.shape == (b, sq, h, d)
    assert_close(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kv_splits", [1, 2, 3, 7])
def test_mma_walk_is_the_default_walk_at_every_split(kv_splits):
    """Packing, the skip and the split are schedules: the same function
    as the JAX kernel's tiles (``ops.flash_attention`` on the CPU)."""
    q, k, v = _case(41, 2, 45, 400, 6, 2, 16)
    got = _walk(q, k, v, kv_splits, causal=True, q_offset=355)
    want = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, q_offset=355)
    assert_close(got, want.numpy(), atol=1e-6, rtol=1e-5)


def test_mma_walk_row_without_a_visible_key_gives_zero():
    q, k, v = _case(42, 1, 24, 100, 4, 2, 16)
    for kv_splits in (1, 2):
        got = _walk(q, k, v, kv_splits, causal=True, q_offset=-10)
        assert torch.equal(got[:, :10], torch.zeros_like(got[:, :10]))
        assert torch.isfinite(got).all() and (got[:, 10:] != 0).any()


def test_mma_walk_keeps_bf16_out():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _case(43, 1, 20, 20, 4, 2, 32))
    got = FA.flash_attention_plain(q, k, v, bq=64, bk=64, packed=True,
                                   kv_splits=2)
    want = FA.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    assert_close(got.float(), want.float().numpy(), atol=2e-2)


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 112, "mma"),
    (torch.float32, 128, "simt"), (torch.float32, 64, "simt"),
    (torch.bfloat16, 72, "simt"), (torch.bfloat16, 144, "simt"),
    (torch.bfloat16, 200, "simt"), (torch.bfloat16, 256, "simt"),
])
def test_flash_route_by_dtype_and_head_dim(dtype, d, route):
    q = torch.zeros((1, 8, 4, d), dtype=dtype)
    assert FA.flash_route(dtype, d) == route
    assert FA.flash_route(dtype, d, q, q[:, :, :2], q[:, :, 2:]) == route


def test_flash_route_by_alignment():
    B, S, H, D = 2, 10, 4, 64
    q = _bf16((B, S, H, D))
    assert FA.flash_route(torch.bfloat16, D, q) == "mma"
    # a (B, H, S, D) tensor seen through a transpose: strides of 8s
    t = _bf16((B, H, S, D)).transpose(1, 2)
    assert FA.flash_route(torch.bfloat16, D, q, t) == "mma"
    # an odd S stride: rows of H * D + 1 elements
    odd = _bf16((B, S, H * D + 1))[..., :H * D].unflatten(-1, (H, D))
    assert odd.stride(1) % 2 == 1
    assert FA.flash_route(torch.bfloat16, D, q, odd) == "simt"
    # a start that is 2 bytes off a 16-byte boundary
    off = _bf16((B * S * H * D + 8,))[1:1 + B * S * H * D].view(B, S, H, D)
    assert off.data_ptr() % 16 == 2
    assert FA.flash_route(torch.bfloat16, D, off) == "simt"


@pytest.mark.parametrize("B,Sq,Sk,splits", [
    (4, 2048, 2048, 1),    # causal 2048: 1,536 row blocks
    (4, 256, 256, 1),      # prompt 256: 192 row blocks
    (4, 256, 1024, 1),     # the non-causal case
    (4, 1, 2048, 32),      # the decode window: 8 row blocks
    (1, 64, 2048, 16),     # the continuation: 12 row blocks
])
def test_flash_split_at_the_smoke_cases(B, Sq, Sk, splits):
    """qwen2-1.5B's widths (H 12, Hkv 2): no split where the row blocks
    fill the card; one or two blocks per SM of 132 where they do not."""
    rows = 6 * Sq
    assert FA.flash_split(B, 2, rows, Sk) == splits
    blocks = B * 2 * -(-rows // FA.FLASH_BLOCK_ROWS) * splits
    if splits > 1:
        assert 132 <= blocks <= 264


@pytest.mark.parametrize("B,Hkv,rows,Sk", [
    (1, 1, 1, 64), (1, 1, 1, 65), (1, 1, 3, 5000), (2, 1, 70, 700),
    (1, 8, 16, 320), (3, 2, 100, 129), (1, 1, 64, 64 * 33 + 1),
])
def test_flash_split_leaves_no_chunk_empty(B, Hkv, rows, Sk):
    chunks = FA.flash_split(B, Hkv, rows, Sk)
    tiles = -(-Sk // FA.FLASH_KEY_TILE)
    per = -(-tiles // chunks)
    assert 1 <= chunks <= tiles and (chunks - 1) * per < tiles
