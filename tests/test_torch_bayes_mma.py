"""The tensor-core weight-space kernel's arithmetic and its route, on the
CPU.

``bayes_matmul_sampled_plain(..., split="tf32x3")`` forms each tile's
x @ W_s as ``bayes_gemm_mma`` does on the card: x and W_s each split into
two tf32 parts, three products.  It is held against the JAX package's
Pallas kernels in interpret mode on the same numpy inputs, within 1e-5 of
max |y| (ten times inside the 1e-4 rule ``chip_smoke.py`` applies to the
kernel on the card, whose sums run through the tensor core's own f32
adds).  ``bayes_route`` picks the kernel from rows, samples, width and
alignment.  The kernels themselves run in
``tests/test_torch_kernels_cuda.py`` on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from _torch_parity import meshless_reference  # noqa: F401
from repro.kernels.bayes_matmul import (bayes_matmul_fused_kernel,
                                        bayes_matmul_kernel)
from repro_torch.kernels import rng

BM = importlib.import_module("repro_torch.kernels.bayes_matmul")

REL = 1e-5
SHAPES = [(130, 1000, 300), (33, 72, 17), (200, 171, 32)]
BLOCKS = (128, 128, 512)   # the JAX kernels' default bm, bn, bk


def _case(seed, m, k, n, s):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32)
    mu = (0.3 * r.standard_normal((k, n))).astype(np.float32)
    sg = np.abs(0.1 * r.standard_normal((k, n))).astype(np.float32)
    eps = r.standard_normal((s, k, n)).astype(np.float32)
    return x, mu, sg, eps


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    g = got.double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / np.abs(w).max())


def _pad(a, axis, mult):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, -a.shape[axis] % mult)
    return np.pad(a, pad)


def _padded(x, mu, sg, eps):
    """The operands zero-padded to the JAX kernels' blocks, as
    ``repro.kernels.ops`` pads them."""
    bm, bn, bk = BLOCKS
    return (_pad(_pad(x, 0, bm), 1, bk),
            *(_pad(_pad(a, 0, bk), 1, bn) for a in (mu, sg)),
            _pad(_pad(eps, 1, bk), 2, bn))


@pytest.mark.parametrize("s", [1, 4, 10])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tf32x3_sampled_matches_jax_fused_kernel(m, k, n, s):
    """Explicit eps through ``bayes_matmul_fused_kernel`` in interpret
    mode; the plain version walks the tensor-core kernel's tiles."""
    x, mu, sg, eps = _case(m + k + n + s, m, k, n, s)
    bm, bn, bk = BLOCKS
    xp, mup, sgp, epsp = _padded(x, mu, sg, eps)
    want = bayes_matmul_fused_kernel(xp, mup, sgp, 0, num_samples=s,
                                     eps=epsp, bm=bm, bn=bn, bk=bk,
                                     interpret=True)[:, :m, :n]
    got = BM.bayes_matmul_sampled_plain(*_t(x, mu, sg), num_samples=s,
                                        eps=torch.from_numpy(eps),
                                        bm=128, bk=32, bn=16, split="tf32x3")
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tf32x3_single_draw_matches_jax_kernel(m, k, n):
    """The single draw is the S = 1 instance: a (K, N) eps as (1, K, N)."""
    x, mu, sg, eps = _case(m * n + k, m, k, n, 1)
    bm, bn, bk = BLOCKS
    xp, mup, sgp, epsp = _padded(x, mu, sg, eps)
    want = bayes_matmul_kernel(xp, mup, sgp, epsp[0], bm=bm, bn=bn, bk=bk,
                               interpret=True)[:m, :n]
    got = BM.bayes_matmul_sampled_plain(*_t(x, mu, sg), num_samples=1,
                                        eps=torch.from_numpy(eps),
                                        split="tf32x3")[0]
    assert _rel_err(got, want) <= REL


def test_three_tf32_passes_hold_what_one_pass_loses():
    """At bench_kernels' M 128 and K 1024 (N 128, S 2), one tf32 pass
    misses 1e-5 of max |y|; three passes meet it, at least 100x closer to
    the f32 version."""
    x, mu, sg, eps = _t(*_case(5, 128, 1024, 128, 2))
    want = BM.bayes_matmul_sampled_plain(x, mu, sg, num_samples=2, eps=eps)
    err = {split: _rel_err(BM.bayes_matmul_sampled_plain(
        x, mu, sg, num_samples=2, eps=eps, split=split), want)
        for split in ("tf32", "tf32x3")}
    assert err["tf32"] > REL
    assert err["tf32x3"] <= REL
    assert 100 * err["tf32x3"] <= err["tf32"]


def test_seeded_stream_does_not_depend_on_split_or_tiles():
    """The seeded draws do not move with the split or the tiles: with
    x = I the GEMM returns W_s, which the split holds to 2^-21 of itself
    at the kernel's tiles and at the plain version's, and which the f32
    version gives exactly, as the whole-stream draw does."""
    k, n, s = 40, 36, 10
    _, mu, sg, _ = _t(*_case(3, k, k, n, 1))
    eye = torch.eye(k)
    w = mu + sg * rng.bayes_normal(7, s, torch.arange(k), torch.arange(n))
    assert torch.equal(BM.bayes_matmul_sampled_plain(
        eye, mu, sg, num_samples=s, seed=7), w)
    for tiles in ({"bm": 128, "bk": 32, "bn": 16}, {"bk": 13, "bn": 20}):
        got = BM.bayes_matmul_sampled_plain(eye, mu, sg, num_samples=s,
                                            seed=7, split="tf32x3", **tiles)
        assert torch.all((got - w).abs() <= 2.0 ** -21 * w.abs())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (20, k)).astype(np.float32))
    want = BM.bayes_matmul_sampled_plain(x, mu, sg, num_samples=s, seed=7)
    got = BM.bayes_matmul_sampled_plain(x, mu, sg, num_samples=s, seed=7,
                                        bm=8, bk=32, bn=16, split="tf32x3")
    assert _rel_err(got, want) <= REL


def test_split_rejects_an_unknown_name():
    x, mu, sg, eps = _t(*_case(1, 4, 8, 8, 1))
    with pytest.raises(ValueError):
        BM.bayes_matmul_sampled_plain(x, mu, sg, num_samples=1, eps=eps,
                                      split="bf16x3")


def _route(m, k, n, s=10, **views):
    ops = {"x": torch.zeros((m, k)), "mu": torch.zeros((k, n)),
           "sigma": torch.zeros((k, n)), "eps": None, **views}
    return BM.bayes_route(m, k, n, s, ops["x"], ops["mu"], ops["sigma"],
                          ops["eps"])


def test_bayes_route_by_rows_and_samples():
    lo = BM.BAYES_MMA_MIN_ROWS
    assert _route(lo, 64, 64) == "mma"
    if lo > 1:
        assert _route(lo - 1, 64, 64) == "simt"
    assert _route(128, 1024, 4096) == "mma"               # bench_kernels
    for s in (1, 4, 10, BM.MAX_SAMPLES):
        assert _route(128, 1024, 4096, s) == "mma"
    assert _route(128, 1024, 4096, BM.MAX_SAMPLES + 1) == "simt"
    assert _route(128, 1024, 4096, 0) == "simt"


def test_bayes_route_by_width_and_k():
    """N % 4 routes (16-byte copies of mu, sigma and eps rows); K does
    not: the im2col conv's K 171 takes the tensor cores."""
    assert _route(156_800, 171, 32) == "mma"              # the im2col conv
    assert _route(130, 70, 36) == "mma"
    assert _route(130, 72, 34) == "simt"
    assert _route(130, 72, 17) == "simt"


def test_bayes_route_by_alignment():
    m, k, n = 130, 64, 36
    wide = torch.zeros((m, k + 8))
    assert _route(m, k, n, x=wide[:, 1:k + 1]) == "mma"   # x: 4-byte copies
    flat = torch.zeros(k * n + 4)
    assert _route(m, k, n, mu=flat[1:k * n + 1].view(k, n)) == "simt"
    assert _route(m, k, n, sigma=flat[4:].view(k, n)) == "mma"
    assert _route(m, k, n, sigma=flat[2:k * n + 2].view(k, n)) == "simt"
    eps = torch.zeros(3 * k * n + 2)
    assert _route(m, k, n, 3, eps=eps[2:].view(3, k, n)) == "simt"
    assert _route(m, k, n, 3, eps=eps[:-2].view(3, k, n)) == "mma"


def test_bayes_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: a CPU tensor given to a kernel wrapper raises, a
    forced route too."""
    x, mu, sg, eps = _t(*_case(2, 130, 64, 36, 2))
    for route in (None, "mma", "simt"):
        with pytest.raises(ValueError, match="CUDA"):
            BM.bayes_matmul_cuda(x, mu, sg, eps[0], route=route)
        with pytest.raises(ValueError, match="CUDA"):
            BM.bayes_matmul_sampled_cuda(x, mu, sg, num_samples=2, eps=eps,
                                         route=route)
