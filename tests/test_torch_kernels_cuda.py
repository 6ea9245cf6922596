"""The port's CUDA kernels against their plain PyTorch versions.

Every test here needs a GPU and skips without one.  The module imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed (``tests/conftest.py`` imports JAX, so run it as a script,
which leaves the conftest out):

    PYTHONPATH=src python tests/test_torch_kernels_cuda.py
"""

import sys

import numpy as np
import pytest
import torch

from _torch_parity import assert_close, cuda_device  # noqa: F401
from repro_torch.kernels import launches
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import uncertainty_head as UH

pytestmark = pytest.mark.needs_cuda

KEYS = ("H", "SE", "MI", "p_max")


def _head(seed, M, K, V, S, sigma=0.3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, K)).astype(np.float32)
    mu = (r.standard_normal((K, V)) / np.sqrt(K)).astype(np.float32)
    sg = (sigma * (0.5 + r.random((K, V)))).astype(np.float32)
    xi = r.standard_normal((S, M, V)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, mu, sg, xi)]


def _decode_case(seed, H, Hkv, D, BS, MB, lens):
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
    return [torch.from_numpy(a) for a in
            (q, k, v, table, np.asarray(lens, np.int32))]


@pytest.mark.parametrize("M,V", [(4, 1000), (16, 513), (20, 300)])
def test_cuda_head_matches_plain(cuda_device, M, V):
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(M, M, 64, V, 10))
    for kw in ({"xi": xi}, {"seed": 4, "step": 9}):
        got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, **kw)
        want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10, **kw)
        for k in KEYS:
            assert_close(got[k], want[k].cpu(), atol=2e-5, msg=k)
        assert torch.equal(got["pred"].cpu(), want["pred"].cpu())


def test_cuda_head_bf16_input_and_nan_row(cuda_device):
    """x arrives as bf16 at full width; an idle slot's NaN row stays in
    its row."""
    x, mu, sg, _ = (t.to(cuda_device) for t in _head(3, 4, 64, 700, 10))
    x = x.to(torch.bfloat16)
    x[2] = float("nan")
    got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, seed=1, step=2)
    want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10, seed=1,
                                     step=2)
    for k in KEYS:
        assert torch.isnan(got[k][2]), k
        assert_close(got[k][[0, 1, 3]], want[k][[0, 1, 3]].cpu(), atol=2e-5,
                     msg=k)
    assert torch.equal(got["pred"][[0, 1, 3]].cpu(),
                       want["pred"][[0, 1, 3]].cpu())


def test_cuda_head_is_deterministic_per_seed_and_counts_launches(
        cuda_device):
    x, mu, sg, _ = (t.to(cuda_device) for t in _head(5, 4, 64, 900, 10))
    launches.reset()
    a = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, seed=7, step=3)
    b = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, seed=7, step=3)
    c = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, seed=8, step=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["H"], c["H"])
    assert launches.snapshot()["uncertainty_head"] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D", [(12, 2, 64), (12, 2, 128), (4, 4, 32)])
def test_cuda_decode_matches_plain(cuda_device, dtype, H, Hkv, D):
    q, k, v, table, lens = (t.to(cuda_device) for t in _decode_case(
        5, H, Hkv, D, BS=16, MB=4, lens=(60, 17, 1, 0)))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = PA.paged_decode_attention_cuda(q, k, v, table, lens)
    want = PA.paged_decode_attention_plain(q, k, v, table, lens)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert_close(got.float(), want.float().cpu(), atol=tol, equal_nan=True)
    assert torch.isnan(got[3]).all() and not torch.isnan(got[:3]).any()


def test_cuda_decode_multi_block_runs_match_plain(cuda_device):
    """64 slots: each split takes a run of several blocks (decode_split >
    1), with holes, staggered depths and an empty slot among them."""
    lens = [int(n) for n in np.random.default_rng(9).integers(0, 300, 64)]
    lens[5] = 0
    q, k, v, table, ln = (t.to(cuda_device) for t in _decode_case(
        9, 12, 2, 128, BS=16, MB=19, lens=lens))
    table[7, 3] = -1                              # a hole below the depth
    assert PA.decode_split(64, 2, 19) > 1
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = PA.paged_decode_attention_cuda(q, k, v, table, ln)
    want = PA.paged_decode_attention_plain(q, k, v, table, ln)
    assert_close(got.float(), want.float().cpu(), atol=2e-2, equal_nan=True)
    assert torch.isnan(got[5]).all()


@pytest.mark.parametrize("kc", [1024, 16])
def test_cuda_prefill_matches_plain(cuda_device, kc):
    r = np.random.default_rng(kc)
    S, H, Hkv, D, BS, span, offset = 32, 12, 2, 128, 16, 64, 32
    k = torch.from_numpy(r.standard_normal((8, BS, Hkv, D)).astype(
        np.float32)).to(cuda_device)
    v = torch.randn_like(k)
    q = torch.randn((1, S, H, D), device=cuda_device)
    row = torch.tensor([[5, 1, 7, -1]], dtype=torch.int32,
                       device=cuda_device)
    got = PA.paged_prefill_attention_cuda(q, k, v, row, offset, span, kc)
    want = PA.paged_prefill_attention_plain(q, k, v, row, offset, span, kc)
    assert_close(got, want.cpu(), atol=2e-5)


def test_cuda_wrappers_refuse_bad_operands(cuda_device):
    q, k, v, table, lens = (t.to(cuda_device) for t in _decode_case(
        1, 4, 1, 32, BS=16, MB=2, lens=(20, 3)))
    with pytest.raises(TypeError):
        PA.paged_decode_attention_cuda(q, k, v, table.long(), lens)
    with pytest.raises(ValueError):
        PA.paged_decode_attention_cuda(q.cpu(), k, v, table, lens)
    x, mu, sg, _ = (t.to(cuda_device) for t in _head(1, 2, 16, 50, 2))
    with pytest.raises(ValueError):
        UH.uncertainty_head_cuda(x, mu, sg[:, :10], num_samples=2)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q", "--noconftest", "-p",
                          "no:cacheprovider"]))
