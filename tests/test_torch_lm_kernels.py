"""The port's LM-side kernels (plain versions, as ``ops`` runs them on CPU
tensors) against the JAX package's oracles and ops on the same numpy
inputs: the LRT GEMMs, the two-pass uncertainty head and GQA flash
attention, plus the TAG_LRT stream's contracts and the library surface
``repro_torch.kernels``.  The CUDA kernels are held against these plain
versions in test_torch_kernels_cuda.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as JK
import repro_torch.kernels as K
from _torch_parity import assert_close, meshless_reference  # noqa: F401
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.bayes_matmul import lrt_matmul_fused_kernel
from repro.models import layers as JL
from repro_torch.kernels import ops, ref, rng
from repro_torch.models import layers as L

# the package exports the ops functions of the same names, which shadow
# these submodules as attributes of repro_torch.kernels
BM = importlib.import_module("repro_torch.kernels.bayes_matmul")
FA = importlib.import_module("repro_torch.kernels.flash_attention")
UH = importlib.import_module("repro_torch.kernels.uncertainty_head")

KEYS = ("H", "SE", "MI", "p_max")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _lrt_case(seed, m, k, n, s=None):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32)
    mu = (0.3 * r.standard_normal((k, n))).astype(np.float32)
    sg = np.abs(0.1 * r.standard_normal((k, n))).astype(np.float32)
    xi = r.standard_normal((m, n) if s is None else (s, m, n)).astype(
        np.float32)
    return x, mu, sg, xi


# ---------------------------------------------------------------------------
# LRT GEMMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (128, 256, 128), (40, 50, 60),
                                   (1, 128, 11), (33, 70, 17)])
def test_lrt_matmul_matches_jax(m, k, n):
    x, mu, sg, xi = _lrt_case(m * 100 + n, m, k, n)
    got = ops.lrt_matmul(*_t(x, mu, sg, xi))
    assert torch.equal(got, BM.lrt_matmul_plain(*_t(x, mu, sg, xi)))
    for want in (JR.lrt_matmul(x, mu, sg, xi),
                 JO.lrt_matmul(x, mu, sg, xi, impl="pallas")):
        assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_lrt_matmul_bf16_input_matches_jax():
    x, mu, sg, xi = _lrt_case(2, 24, 64, 40)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    got = ops.lrt_matmul(tx, *_t(mu, sg, xi))
    assert_close(got, JR.lrt_matmul(xb, mu, sg, xi), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m,k,n,s", [(16, 32, 24, 5), (8, 64, 128, 12)])
def test_lrt_matmul_sampled_explicit_xi_matches_jax_fused_kernel(m, k, n, s):
    x, mu, sg, xi = _lrt_case(s, m, k, n, s)
    got = BM.lrt_matmul_sampled_plain(*_t(x, mu, sg), num_samples=s,
                                      xi=_t(xi)[0], bn=7)
    want = lrt_matmul_fused_kernel(x, mu, sg, 0, num_samples=s, xi=xi,
                                   interpret=True)
    assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert_close(got, jax.vmap(lambda z: JR.lrt_matmul(x, mu, sg, z))(xi),
                 atol=1e-5, rtol=1e-5)


def test_seeded_lrt_is_deterministic_and_keyed_by_seed():
    x, mu, sg, _ = _t(*_lrt_case(3, 12, 32, 40))
    a = ops.lrt_matmul_sampled(x, mu, sg, 7, num_samples=6)
    b = ops.lrt_matmul_sampled(x, mu, sg, 7, num_samples=6)
    c = ops.lrt_matmul_sampled(x, mu, sg, 8, num_samples=6)
    assert a.shape == (6, 12, 40)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert_close(a, ref.lrt_matmul_sampled(x, mu, sg, 7, 6), atol=1e-6)


def test_seeded_lrt_moments_match_jax_seeded_oracle():
    """The two generators differ, so the seeded LRT samples agree in
    distribution.  Per output element both sample means lie within the
    Monte-Carlo error of the mean GEMM: their difference over its standard
    error, std * sqrt(2 / S), is ~N(0, 1) (mean |z| 0.80); the sample
    variances over the analytic one average to 1 within 5 standard errors
    of that mean, sqrt(2 / (S - 1)) / sqrt(M N)."""
    M, Kd, N, S = 16, 48, 40, 64
    x, mu, sg, _ = _lrt_case(4, M, Kd, N)
    got = ops.lrt_matmul_sampled(*_t(x, mu, sg), 5, num_samples=S).double()
    want = torch.from_numpy(np.asarray(
        JR.lrt_matmul_sampled(x, mu, sg, 5, S), np.float64))
    std = torch.from_numpy(np.sqrt((x.astype(np.float64) ** 2)
                                   @ (sg.astype(np.float64) ** 2)))
    z = (got.mean(0) - want.mean(0)) / (std * np.sqrt(2.0 / S))
    assert 0.65 < float(z.abs().mean()) < 0.95, float(z.abs().mean())
    assert float(z.abs().max()) < 5.5, float(z.abs().max())
    tol = 5 * np.sqrt(2.0 / (S - 1)) / np.sqrt(M * N)
    for y in (got, want):
        ratio = float((y.var(0) / std ** 2).mean())
        assert abs(ratio - 1.0) < tol, (ratio, tol)


def test_lrt_stream_is_the_same_whatever_sub_block_is_drawn():
    """Counter (n, m, s // 4, TAG_LRT): a draw depends on its output
    element alone, not on the tile, the block's origin or S."""
    m = torch.arange(20, dtype=torch.int64)
    n = torch.arange(33, dtype=torch.int64)
    full = rng.lrt_normal(11, 9, m, n)
    part = rng.lrt_normal(11, 6, m[5:12], n[3:30])
    assert torch.equal(part, full[:6, 5:12, 3:30])
    assert not torch.equal(full, rng.bayes_normal(11, 9, m, n))
    x, mu, sg, _ = _t(*_lrt_case(6, 20, 16, 33))
    tiles = [BM.lrt_matmul_sampled_plain(x, mu, sg, num_samples=9, seed=11,
                                         bn=bn) for bn in (1, 7, 256)]
    assert torch.equal(tiles[0], tiles[1]) and torch.equal(tiles[0],
                                                           tiles[2])
    assert torch.equal(tiles[0], ref.lrt_matmul_sampled(x, mu, sg, 11, 9))


# ---------------------------------------------------------------------------
# two-pass head
# ---------------------------------------------------------------------------

def _head_case(seed, m, k, v, s):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32)
    mu = (0.2 * r.standard_normal((k, v))).astype(np.float32)
    sg = np.abs(0.05 * r.standard_normal((k, v))).astype(np.float32)
    xi = r.standard_normal((s, m, v)).astype(np.float32)
    return x, mu, sg, xi


@pytest.mark.parametrize("m,k,v,s", [(8, 16, 12, 4), (7, 33, 517, 3),
                                     (4, 64, 1000, 10), (20, 24, 300, 6)])
def test_two_pass_head_matches_jax(m, k, v, s):
    x, mu, sg, xi = _head_case(m + v, m, k, v, s)
    got = ops.uncertainty_head(*_t(x, mu, sg, xi))
    for want in (JR.uncertainty_head(x, mu, sg, xi),
                 JO.uncertainty_head(x, mu, sg, xi, impl="pallas")):
        for name in KEYS:
            assert_close(got[name], want[name], atol=1e-5, rtol=1e-4,
                         msg=name)
        np.testing.assert_array_equal(got["pred"].numpy(),
                                      np.asarray(want["pred"]))


def test_two_pass_plain_equals_the_fused_plain_head():
    """Re-reading the scratch gives the logits the fused head rebuilds,
    bit for bit, whatever the tile."""
    x, mu, sg, xi = _t(*_head_case(1, 6, 20, 301, 5))
    for tile in (128, 64, 7):
        a = UH.uncertainty_head_two_pass_plain(x, mu, sg, xi, tile=tile)
        b = UH.uncertainty_head_plain(x, mu, sg, num_samples=5, xi=xi,
                                      tile=tile)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_two_pass_head_identities():
    """0 <= MI <= H <= log(V); SE = H - MI."""
    m, k, v, s = 64, 32, 10, 10
    x, mu, sg, xi = _head_case(10, m, k, v, s)
    out = ops.uncertainty_head(*_t(x, 2.5 * mu, 6 * sg, xi))
    h, se, mi = (out[n].double() for n in ("H", "SE", "MI"))
    assert (mi >= -1e-6).all()
    assert (h <= np.log(v) + 1e-5).all()
    assert (mi <= h + 1e-6).all()
    assert_close(se, h - mi, atol=1e-5)


def test_two_pass_head_tie_keeps_the_first_index():
    """A flat predictive (mu = sigma = 0) ties every column across tiles:
    the first wins, as JAX's strict > keeps its first tile."""
    m, k, v, s = 3, 8, 300, 4
    x, _, _, xi = _head_case(2, m, k, v, s)
    z = np.zeros((k, v), np.float32)
    got = ops.uncertainty_head(*_t(x, z, z, xi))
    want = JO.uncertainty_head(x, z, z, xi, impl="pallas")
    assert got["pred"].tolist() == [0] * m
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))
    assert_close(got["H"], np.full(m, np.log(v)), atol=1e-5)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _attn_case(seed, b, sq, sk, h, hkv, d):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, s, n, d)).astype(np.float32)
            for s, n in ((sq, h), (sk, hkv), (sk, hkv))]


@pytest.mark.parametrize("b,s,h,hkv,d,causal", [
    (1, 32, 4, 4, 16, True),
    (2, 70, 6, 2, 16, True),      # GQA, non-multiple seq
    (2, 64, 8, 1, 32, False),     # MQA, non-causal
    (1, 128, 2, 2, 64, True),
])
def test_flash_attention_matches_jax(b, s, h, hkv, d, causal):
    q, k, v = _attn_case(s + d, b, s, s, h, hkv, d)
    got = ops.flash_attention(*_t(q, k, v), causal=causal)
    small = FA.flash_attention_plain(*_t(q, k, v), causal=causal, bq=16,
                                     bk=32)
    want = JO.flash_attention(q, k, v, impl="pallas", causal=causal, bq=16,
                              bk=32)
    for g in (got, small):
        assert_close(g, want, atol=1e-5, rtol=1e-4)
    assert_close(got, JL.flash_attention(q, k, v, causal=causal, q_chunk=16,
                                         kv_chunk=16), atol=1e-5, rtol=1e-4)


def test_flash_attention_matches_the_models_online_softmax():
    q, k, v = _t(*_attn_case(21, 2, 48, 48, 4, 2, 16))
    got = ops.flash_attention(q, k, v, causal=True)
    assert_close(got, L.flash_attention(q, k, v, causal=True, q_chunk=16,
                                        kv_chunk=16), atol=1e-5, rtol=1e-4)


def test_flash_attention_q_offset_decode_window():
    """Continuation: the last token of a prefix equals full attention."""
    b, s, h, d = 1, 40, 2, 16
    q, k, v = _attn_case(22, b, s, s, h, h, d)
    tq, tk, tv = _t(q, k, v)
    full = ops.flash_attention(tq, tk, tv, causal=True)
    last = ops.flash_attention(tq[:, -1:], tk, tv, causal=True,
                               q_offset=s - 1)
    assert_close(last[:, 0], full[:, -1], atol=1e-5, rtol=1e-4)
    want = JO.flash_attention(q[:, -1:], k, v, impl="pallas", causal=True,
                              q_offset=s - 1, bq=8, bk=16)
    assert_close(last, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("sq,sk,q_offset,causal", [
    (8, 40, 32, True),      # a prefill continuation
    (24, 300, 276, True),   # several kv tiles, the first ones unmasked
    (16, 50, 0, False),     # non-causal, Sq != Sk
    (12, 30, 0, True),      # rows past the last key: later keys masked
])
def test_flash_attention_offsets_and_ragged_kv_match_jax(sq, sk, q_offset,
                                                         causal):
    q, k, v = _attn_case(sq + sk, 2, sq, sk, 6, 3, 16)
    got = ops.flash_attention(*_t(q, k, v), causal=causal, q_offset=q_offset)
    small = FA.flash_attention_plain(*_t(q, k, v), causal=causal,
                                     q_offset=q_offset, bq=8, bk=16)
    want = JO.flash_attention(q, k, v, impl="pallas", causal=causal,
                              q_offset=q_offset, bq=8, bk=16)
    for g in (got, small):
        assert_close(g, want, atol=1e-5, rtol=1e-4)


def test_flash_attention_bf16_output_takes_q_dtype():
    q, k, v = _attn_case(23, 1, 20, 20, 4, 2, 32)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    want = JO.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                for a in (q, k, v)), impl="pallas",
                              causal=True, bq=16, bk=16)
    assert want.dtype == jnp.bfloat16
    # both round an f32 result to bf16: one bf16 ulp of O(1) outputs
    assert_close(got.float(), np.asarray(want.astype(jnp.float32)),
                 atol=2e-2)


# ---------------------------------------------------------------------------
# the library surface
# ---------------------------------------------------------------------------

def test_library_surface_exports_the_jax_names():
    names = sorted(n for n in dir(JK) if not n.startswith("_")
                   and callable(getattr(JK, n)))
    assert "flash_attention" in names and "lrt_matmul_sampled" in names
    for n in names:
        assert callable(getattr(K, n)), n
        assert getattr(K, n) is getattr(ops, n), n
    assert all(hasattr(K, m) for m in ("ops", "ref", "rng"))
