"""The tensor-core LRT kernel's arithmetic and its route, on the CPU.

``lrt_matmul_sampled_plain(..., split="tf32x3")`` forms the mean and
variance GEMMs as ``lrt_gemm_mma`` does on the card: every operand split
into two tf32 parts, three products per GEMM.  It is held against the JAX
package's Pallas LRT kernels in interpret mode on the same numpy inputs,
within 1e-5 of max |y|, the rule ``chip_smoke.py`` applies to the kernel
on the card.  ``lrt_route`` picks the kernel from shapes, type and
alignment.  The kernels themselves run in
``tests/test_torch_kernels_cuda.py`` on the card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import meshless_reference  # noqa: F401
from repro.kernels import ops as JO
from repro.kernels.bayes_matmul import lrt_matmul_fused_kernel

BM = importlib.import_module("repro_torch.kernels.bayes_matmul")

REL = 1e-5           # chip_smoke.py's rule for the LRT kernels
SHAPES = [(130, 1000, 300), (33, 72, 17), (200, 1024, 260)]
BLOCKS = (128, 128, 512)   # the JAX kernels' default bm, bn, bk


def _case(seed, m, k, n, s):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32)
    mu = (0.3 * r.standard_normal((k, n))).astype(np.float32)
    sg = np.abs(0.1 * r.standard_normal((k, n))).astype(np.float32)
    xi = r.standard_normal((s, m, n)).astype(np.float32)
    return x, mu, sg, xi


def _inputs(x, dtype):
    """x for JAX and for the port, the same values in f32 or bf16."""
    if dtype == "float32":
        return x, torch.from_numpy(x)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    g = got.double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / np.abs(w).max())


def _pad(a, axis, mult):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, -a.shape[axis] % mult)
    return jnp.pad(jnp.asarray(a), pad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tf32x3_lrt_matmul_matches_jax_kernel(m, k, n, dtype):
    x, mu, sg, xi = _case(m + k + n, m, k, n, 1)
    xj, xt = _inputs(x, dtype)
    want = JO.lrt_matmul(xj, mu, sg, xi[0], impl="pallas")
    got = BM.lrt_matmul_plain(xt, *(torch.from_numpy(a) for a in
                                    (mu, sg, xi[0])), split="tf32x3")
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tf32x3_lrt_matmul_sampled_matches_jax_fused_kernel(m, k, n, dtype):
    """Explicit xi (S 3) through ``lrt_matmul_fused_kernel``, operands
    zero-padded to its blocks as ``repro.kernels.ops`` pads them."""
    S = 3
    x, mu, sg, xi = _case(m * k + n, m, k, n, S)
    xj, xt = _inputs(x, dtype)
    bm, bn, bk = BLOCKS
    xp = _pad(_pad(xj, 0, bm), 1, bk)
    mup, sgp = (_pad(_pad(a, 0, bk), 1, bn) for a in (mu, sg))
    xip = _pad(_pad(xi, 1, bm), 2, bn)
    want = lrt_matmul_fused_kernel(xp, mup, sgp, 0, num_samples=S, xi=xip,
                                   bm=bm, bn=bn, bk=bk,
                                   interpret=True)[:, :m, :n]
    got = BM.lrt_matmul_sampled_plain(
        xt, *(torch.from_numpy(a) for a in (mu, sg)), num_samples=S,
        xi=torch.from_numpy(xi), split="tf32x3")
    assert _rel_err(got, want) <= REL


def test_three_tf32_passes_hold_what_one_pass_loses():
    """At bench_kernels' M 128 and K 1024 (N 256), one tf32 pass is off by
    about 3e-4 of max |y|; three passes come at least 100x closer to the
    f32 version, inside the 1e-5 rule."""
    x, mu, sg, xi = (torch.from_numpy(a) for a in
                     _case(5, 128, 1024, 256, 1))
    want = BM.lrt_matmul_plain(x, mu, sg, xi[0])
    err = {split: _rel_err(BM.lrt_matmul_plain(x, mu, sg, xi[0],
                                               split=split), want)
           for split in ("tf32", "tf32x3")}
    assert err["tf32x3"] <= REL
    assert 100 * err["tf32x3"] <= err["tf32"]


def test_tf32x3_seeded_stream_matches_f32_version():
    """The seeded draws do not depend on the split: the TAG_LRT stream of
    one seed gives the same samples within the rule."""
    x, mu, sg, _ = (torch.from_numpy(a) for a in _case(8, 40, 64, 36, 1))
    want = BM.lrt_matmul_sampled_plain(x, mu, sg, num_samples=6, seed=5)
    got = BM.lrt_matmul_sampled_plain(x, mu, sg, num_samples=6, seed=5,
                                      split="tf32x3")
    assert _rel_err(got, want) <= REL


def test_tf32_round_and_truncate():
    ulp = 2.0 ** -10
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, float("nan"), float("inf"),
                      -float("inf"), 0.0])
    got = BM.tf32_round(v)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0,
                         float("nan"), float("inf"), -float("inf"), 0.0])
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    assert torch.equal(got[fin], want[fin])
    # truncation clears the low 13 bits, toward zero
    assert torch.equal(BM.tf32_truncate(v[:5]), torch.tensor(
        [1.0, -1.0, 1.0, 1 + ulp, 3.0]))
    # hi + lo, the split the tensor-core kernel reads, holds a value to
    # about 2^-21 of itself
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(
        1000).astype(np.float32))
    hi = BM.tf32_round(r)
    lo = BM.tf32_truncate(r - hi)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((hi + lo - r).abs() <= 2.0 ** -21 * r.abs())


def test_split_rejects_an_unknown_name():
    x, mu, sg, xi = (torch.from_numpy(a) for a in _case(1, 4, 8, 8, 1))
    with pytest.raises(ValueError):
        BM.lrt_matmul_plain(x, mu, sg, xi[0], split="bf16x3")


def _route(m, k, n, dtype=torch.float32, **views):
    x = torch.zeros((m, k), dtype=dtype)
    mu = torch.zeros((k, n))
    sg = torch.zeros((k, n))
    ops = {"x": x, "mu": mu, "sigma": sg, "xi": None, **views}
    return BM.lrt_route(m, k, n, ops["x"], ops["mu"], ops["sigma"],
                        ops["xi"])


def test_lrt_route_by_rows():
    lo = BM.LRT_MMA_MIN_ROWS
    assert _route(lo, 64, 64) == "mma"
    assert _route(lo - 1, 64, 64) == "stream"
    assert _route(128, 1024, 4096) == "mma"            # bench_kernels
    assert _route(4, 1536, 4096, torch.bfloat16) == "stream"   # the head


def test_lrt_route_by_width_and_type():
    m = BM.LRT_MMA_MIN_ROWS
    assert _route(m, 1000, 36) == "mma"
    assert _route(m, 1000, 36, torch.bfloat16) == "mma"
    assert _route(m, 1004, 36) == "mma"
    assert _route(m, 1004, 36, torch.bfloat16) == "stream"   # K % 8
    assert _route(m, 70, 36) == "stream"                      # K % 4
    assert _route(m, 72, 34) == "stream"                      # N % 4


def test_lrt_route_by_alignment():
    m, k, n = BM.LRT_MMA_MIN_ROWS, 64, 36
    wide = torch.zeros((m, k + 8))
    assert _route(m, k, n, x=wide[:, 1:k + 1]) == "stream"   # odd column
    assert _route(m, k, n, x=wide[:, 4:k + 4]) == "mma"      # 16 bytes in
    flat = torch.zeros(k * n + 4)
    assert _route(m, k, n, mu=flat[1:k * n + 1].view(k, n)) == "stream"
    assert _route(m, k, n, sigma=flat[4:].view(k, n)) == "mma"
    xi = torch.zeros(3 * m * n + 2)
    assert _route(m, k, n, xi=xi[2:].view(3, m, n)) == "stream"
    assert _route(m, k, n, xi=xi[:-2].view(3, m, n)) == "mma"


def test_lrt_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: a CPU tensor given to a kernel wrapper raises."""
    x, mu, sg, xi = (torch.from_numpy(a) for a in _case(2, 64, 64, 36, 2))
    with pytest.raises(ValueError):
        BM.lrt_matmul_cuda(x, mu, sg, xi[0])
    with pytest.raises(ValueError):
        BM.lrt_matmul_sampled_cuda(x, mu, sg, num_samples=2, route="stream")
