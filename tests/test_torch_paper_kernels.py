"""The port's photonic conv and sampled-weight GEMM (plain versions, as
``ops`` runs them on CPU tensors) against the JAX package's oracles and
ops, on the same numpy inputs, plus the seeded streams' contracts."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, meshless_reference  # noqa: F401
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.photonic_conv import photonic_conv_fused_kernel
from repro_torch.kernels import ops, ref, rng

# the package exports the ops functions of the same names, which shadow
# these submodules as attributes of repro_torch.kernels
BM = importlib.import_module("repro_torch.kernels.bayes_matmul")
PC = importlib.import_module("repro_torch.kernels.photonic_conv")

ADC_STEP = 4.0 / 127


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv_case(seed, b, t, c=9):
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, (b, t)).astype(np.float32)
    mu = r.uniform(-0.8, 0.8, (c,)).astype(np.float32)
    sg = (np.abs(mu) * 0.2).astype(np.float32)
    eps = r.standard_normal((b, t - c + 1, c)).astype(np.float32)
    return x, mu, sg, eps


def _mm_case(seed, m, k, n, s=None):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32)
    mu = (0.3 * r.standard_normal((k, n))).astype(np.float32)
    sg = np.abs(0.1 * r.standard_normal((k, n))).astype(np.float32)
    shape = (k, n) if s is None else (s, k, n)
    eps = r.standard_normal(shape).astype(np.float32)
    return x, mu, sg, eps


def assert_conv_close(got, want):
    """Equal within 1e-5, except at most 0.1% of outputs one ADC step
    (4/127) apart: the two frameworks may sum the 9 taps in another order,
    which moves a sum lying on a level boundary to the next level."""
    d = np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))
    flips = d > 1e-5
    assert flips.sum() <= 0.001 * d.size, (flips.sum(), d.size)
    np.testing.assert_allclose(d[flips], ADC_STEP, rtol=1e-4)


# ---------------------------------------------------------------------------
# photonic conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t", [(1, 16), (8, 64), (5, 40), (16, 256)])
def test_photonic_conv_matches_jax(b, t):
    x, mu, sg, eps = _conv_case(b * 1000 + t, b, t)
    want = JR.photonic_conv(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(sg),
                            jnp.asarray(eps))
    got = ops.photonic_conv(_t(x), _t(mu), _t(sg), _t(eps))
    assert got.shape == (b, t - 8)
    assert_conv_close(got, want)
    assert_conv_close(ref.photonic_conv(_t(x), _t(mu), _t(sg), _t(eps)),
                      want)


def test_photonic_conv_quantizes_at_both_ends():
    """Inputs off the DAC grid and beyond its range, and sums beyond the
    ADC range, land on the grids (JAX's rounding: half to even)."""
    x, mu, sg, eps = _conv_case(3, 4, 40)
    x = x * 3.0
    mu = mu * 4.0
    want = JR.photonic_conv(*(jnp.asarray(a) for a in (x, mu, sg, eps)))
    got = ops.photonic_conv(_t(x), _t(mu), _t(sg), _t(eps))
    assert_conv_close(got, want)
    levels = got.numpy() / ADC_STEP
    np.testing.assert_allclose(levels, np.round(levels), atol=1e-3)
    assert np.abs(got.numpy()).max() <= 4.0 + 1e-6


def test_quantize_matches_jax_on_ties_and_rails():
    v = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.4, 200.0, -300.0],
                 np.float32) / 127.0
    v = np.concatenate([v, np.random.default_rng(0).uniform(
        -1.2, 1.2, 5000).astype(np.float32)])
    for bits, x_max in ((8, 1.0), (8, 4.0), (4, 1.0)):
        want = JR.quantize(jnp.asarray(v * x_max), bits, x_max)
        got = ref.quantize(_t(v * x_max), bits, x_max)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_conv_determinism_and_mean():
    x, mu, sg, _ = _conv_case(37, 8, 64)
    x, mu, sg = _t(x), _t(mu), _t(sg)
    a = ops.photonic_conv_sampled(x, mu, sg, 9)
    assert torch.equal(a, ops.photonic_conv_sampled(x, mu, sg, 9))
    assert not torch.equal(a, ops.photonic_conv_sampled(x, mu, sg, 10))
    # the plain version's stream is the oracle's
    assert_conv_close(a, ref.photonic_conv_sampled(x, mu, sg, 9).numpy())
    # different seeds -> different shot noise, same mean conv
    ys = torch.stack([ops.photonic_conv_sampled(x, mu, sg, s)
                      for s in range(40)])
    want = ops.photonic_conv(x, mu, sg, torch.zeros((8, 56, 9)))
    # per-output std of y <= sqrt(sum_k (x sigma)^2) <= 0.2 |mu| ||x||
    # ~ 0.45 here; 40 draws put the mean within 0.15 (~5 sigma)
    assert_close(ys.mean(0), want, atol=0.15)


def test_conv_stream_is_keyed_by_element():
    """A symbol's variates depend on (seed, b, t, c) and C alone: a
    sub-block of rows and symbols draws exactly the slice of the full draw
    of the flat stream, starting mid-call or not (17 * 9 % 4 = 1)."""
    full = rng.conv_normal(5, torch.arange(6), torch.arange(50), 9)
    part = rng.conv_normal(5, torch.arange(2, 5), torch.arange(17, 40), 9)
    assert torch.equal(part, full[2:5, 17:40])
    odd = rng.conv_normal(5, torch.tensor([4, 0]), torch.tensor([49, 3, 20]),
                          9)
    assert torch.equal(odd, full[[4, 0]][:, [49, 3, 20]])
    assert full.shape == (6, 50, 9)
    assert abs(float(full.mean())) < 0.1 and abs(float(full.std()) - 1) < 0.1


@pytest.mark.parametrize("c", [1, 4, 9, 16])
def test_conv_stream_draws_exactly_c_normals(c):
    """Row b's (To, C) variates are the normals4 of calls 0 .. ceil(To C /
    4) - 1 with counter (q, b, 0, TAG_CONV), flattened and cut to To C:
    four normals a call, none skipped or reused."""
    to, rows = 23, torch.tensor([0, 3, 70000])
    got = rng.conv_normal(11, rows, torch.arange(to), c)
    calls = -(-to * c // 4)
    q = torch.arange(calls)
    for i, b in enumerate(rows.tolist()):
        w = rng.philox4x32(q, b, 0, rng.TAG_CONV, 11, 0)
        want = rng.normals4(*w).reshape(-1)[:to * c].reshape(to, c)
        assert torch.equal(got[i], want)
    assert len(torch.unique(got)) == got.numel()


@pytest.mark.parametrize("c", [4, 9])
def test_conv_stream_moments(c):
    """Mean 0, std 1, and no correlation between neighbouring taps that
    share a call (r cos with r sin of one Box-Muller pair), each within
    5 / sqrt(n) (the std's own spread is sqrt(2) / sqrt(n))."""
    z = rng.conv_normal(2, torch.arange(64), torch.arange(500), c).double()
    flat = z.reshape(64, -1)
    n = flat.numel()
    tol = 5 / np.sqrt(n)
    assert abs(float(flat.mean())) < tol
    assert abs(float(flat.std()) - 1) < 5 * np.sqrt(0.5 / n)
    pairs = flat[:, :flat.shape[1] // 4 * 4].reshape(64, -1, 2, 2)
    cos, sin = pairs[..., 0].reshape(-1), pairs[..., 1].reshape(-1)
    corr = float((cos * sin).mean() / (cos.std() * sin.std()))
    assert abs(corr) < 5 / np.sqrt(cos.numel())


@pytest.mark.parametrize("b,t,c", [(8, 64, 9), (5, 40, 9), (8, 30, 4),
                                   (1, 33, 16), (8, 18, 1)])
def test_sampled_conv_matches_jax_on_the_conv_stream(b, t, c):
    """The seeded plain version equals the JAX package's oracle and its
    Pallas kernel (interpret mode) fed with the port's conv stream: equal
    bit for bit, except at most 0.1% of outputs one ADC step apart (the
    frameworks may sum the taps in another order)."""
    x, mu, sg, _ = _conv_case(7 * b + t + c, b, t, c)
    to = t - c + 1
    eps = rng.conv_normal(21, torch.arange(b), torch.arange(to), c).numpy()
    got = PC.photonic_conv_plain(_t(x), _t(mu), _t(sg), seed=21)
    assert torch.equal(got, ref.photonic_conv_sampled(_t(x), _t(mu), _t(sg),
                                                      21))
    jx = [jnp.asarray(a) for a in (x, mu, sg, eps)]
    for want in (JR.photonic_conv(*jx),
                 photonic_conv_fused_kernel(*jx[:3], 21, eps=jx[3],
                                            interpret=True)):
        d = np.abs(got.numpy().astype(np.float64)
                   - np.asarray(want, np.float64))
        flips = d > 0
        assert flips.sum() <= 0.001 * d.size, (flips.sum(), d.size)
        np.testing.assert_allclose(d[flips], ADC_STEP, rtol=1e-4)


# ---------------------------------------------------------------------------
# sampled-weight GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [
    (8, 16, 8), (128, 128, 128), (64, 96, 80), (33, 70, 17),
    (256, 512, 128), (1, 9, 7),
])
def test_bayes_matmul_matches_jax(m, k, n):
    x, mu, sg, eps = _mm_case(m + k + n, m, k, n)
    want = JR.bayes_matmul(*(jnp.asarray(a) for a in (x, mu, sg, eps)))
    got = ops.bayes_matmul(_t(x), _t(mu), _t(sg), _t(eps))
    assert_close(got, want, rtol=1e-5, atol=1e-4)
    # the sampled GEMM's tile loop, one draw, with tiles that split M, K
    # and N raggedly, gives the same product
    got = BM.bayes_matmul_sampled_plain(_t(x), _t(mu), _t(sg), num_samples=1,
                                        eps=_t(eps)[None], bm=4, bk=5, bn=3)
    assert_close(got[0], want, rtol=1e-5, atol=1e-4)


def test_bayes_matmul_bf16_operands():
    x, mu, sg, eps = _mm_case(1, 32, 64, 48)
    ts = [_t(a).to(torch.bfloat16) for a in (x, mu, sg, eps)]
    want = JR.bayes_matmul(*(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) for t in ts))
    # bf16 operands computed in f32 (JAX forms W in bf16): as loose as the
    # JAX package's own dtype test
    assert_close(ops.bayes_matmul(*ts), want, rtol=2e-2, atol=2e-2)


def test_bayes_matmul_zero_sigma_is_the_mean_gemm():
    x, mu, _, eps = _mm_case(2, 16, 32, 24)
    z = torch.zeros((32, 24))
    for scale in (0.0, 1.0, 100.0):
        got = ops.bayes_matmul(_t(x), _t(mu), z, _t(eps) * scale)
        assert_close(got, x @ mu, rtol=1e-5, atol=1e-4)


def test_fused_plain_with_explicit_eps_matches_jax():
    x, mu, sg, eps = _mm_case(32, 16, 32, 24, s=5)
    want = jax.vmap(lambda e: JR.bayes_matmul(
        jnp.asarray(x), jnp.asarray(mu), jnp.asarray(sg), e))(
            jnp.asarray(eps))
    for tiles in ({}, {"bm": 5, "bk": 7, "bn": 10}):
        got = BM.bayes_matmul_sampled_plain(_t(x), _t(mu), _t(sg),
                                            num_samples=5, eps=_t(eps),
                                            **tiles)
        assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_sampled_gemm_stream_does_not_depend_on_tiles():
    """With x = I the product returns W_s itself, exactly: the variates
    drawn tile by tile must be bit-identical for any tile shape, and
    equal to the oracle's whole draw."""
    k, n, s = 40, 70, 10
    _, mu, sg, _ = _mm_case(3, k, k, n)
    eye = torch.eye(k)
    a = BM.bayes_matmul_sampled_plain(eye, _t(mu), _t(sg), num_samples=s,
                                      seed=11, bm=7, bk=16, bn=32)
    b = BM.bayes_matmul_sampled_plain(eye, _t(mu), _t(sg), num_samples=s,
                                      seed=11, bm=40, bk=13, bn=64)
    assert torch.equal(a, b)
    w = _t(mu) + _t(sg) * rng.bayes_normal(11, s, torch.arange(k),
                                           torch.arange(n))
    assert torch.equal(a, w)


def test_sampled_gemm_shares_one_weight_draw_across_rows():
    """Two identical rows of x, in different row blocks, give identical
    y[s] for every s.  A stream keyed by the row passes every moment test
    and fails this one."""
    x, mu, sg, _ = _mm_case(4, 20, 33, 17)
    x[13] = x[2]
    y = BM.bayes_matmul_sampled_plain(_t(x), _t(mu), _t(sg), num_samples=6,
                                      seed=3, bm=8, bk=16, bn=8)
    assert torch.equal(y[:, 2], y[:, 13])
    assert not torch.equal(y[0, 2], y[1, 2])
    y2 = ops.bayes_matmul_sampled(_t(x), _t(mu), _t(sg), 3, num_samples=6)
    assert_close(y2, y, rtol=1e-5, atol=1e-5)


def _assert_sample_moments(y, x, mu, sg):
    """The sample mean lies within the MC error sigma/sqrt(S) of the
    analytic mean: the standardized residual is ~N(0, 1) per element, so
    its mean |.| is ~0.8; a biased stream shifts it by O(sqrt(S))."""
    mean = x @ mu
    std = np.sqrt((x * x) @ (sg * sg))
    s = y.shape[0]
    resid = (y.mean(0).numpy() - mean) / np.maximum(std / np.sqrt(s), 1e-6)
    assert np.abs(resid).mean() < 1.5, np.abs(resid).mean()
    ratio = y.std(0).numpy() / np.maximum(std, 1e-6)
    assert abs(ratio.mean() - 1.0) < 0.2, ratio.mean()


def test_sampled_gemm_moments_determinism_and_oracle():
    m, k, n, s = 16, 64, 24, 64
    x, mu, sg, _ = _mm_case(30, m, k, n)
    y = ops.bayes_matmul_sampled(_t(x), _t(mu), _t(sg), 123, num_samples=s)
    assert y.shape == (s, m, n)
    _assert_sample_moments(y, x, mu, sg)
    assert torch.equal(y, ops.bayes_matmul_sampled(_t(x), _t(mu), _t(sg),
                                                   123, num_samples=s))
    assert not torch.allclose(y, ops.bayes_matmul_sampled(
        _t(x), _t(mu), _t(sg), 124, num_samples=s))
    # the tile loop and the whole-stream oracle draw the same variates
    assert_close(y, ref.bayes_matmul_sampled(_t(x), _t(mu), _t(sg), 123, s),
                 rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# im2col probabilistic conv
# ---------------------------------------------------------------------------

def test_im2col_patch_order_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 3, 5, 6)).astype(
        np.float32)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = jax.lax.conv_general_dilated_patches(
        xp, (3, 3), (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NHWC")).reshape(2 * 5 * 6, 27)
    np.testing.assert_array_equal(ops.im2col(_t(x)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("b,cin,cout,h,w", [(2, 3, 4, 6, 6), (1, 5, 2, 7, 4)])
def test_bayes_conv2d_im2col_matches_jax(b, cin, cout, h, w):
    r = np.random.default_rng(b * cin + h)
    x = r.standard_normal((b, cin, h, w)).astype(np.float32)
    mu = (0.2 * r.standard_normal((cout, cin, 3, 3))).astype(np.float32)
    sg = np.abs(0.05 * r.standard_normal((cout, cin, 3, 3))).astype(
        np.float32)
    eps = r.standard_normal((cout, cin, 3, 3)).astype(np.float32)
    want = JO.bayes_conv2d_im2col(*(jnp.asarray(a) for a in (x, mu, sg, eps)),
                                  impl="ref")
    got = ops.bayes_conv2d_im2col(_t(x), _t(mu), _t(sg), _t(eps))
    assert got.shape == (b, cout, h, w)
    assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_im2col_sampled_shape_determinism_and_mean():
    r = np.random.default_rng(40)
    b, cin, cout, h, w, s = 2, 3, 4, 6, 6, 64
    x = _t(r.standard_normal((b, cin, h, w)).astype(np.float32))
    mu = _t((0.2 * r.standard_normal((cout, cin, 3, 3))).astype(np.float32))
    sg = _t(np.abs(0.05 * r.standard_normal((cout, cin, 3, 3))).astype(
        np.float32))
    y = ops.bayes_conv2d_im2col_sampled(x, mu, sg, 3, num_samples=s)
    assert y.shape == (s, b, cout, h, w)
    assert torch.equal(y, ops.bayes_conv2d_im2col_sampled(x, mu, sg, 3,
                                                          num_samples=s))
    mean_conv = ops.bayes_conv2d_im2col(x, mu, sg, torch.zeros_like(mu))
    std = torch.sqrt(ops.bayes_conv2d_im2col(x * x, sg * sg,
                                             torch.zeros_like(mu),
                                             torch.zeros_like(mu)))
    z = (y.mean(0) - mean_conv) / (std / s ** 0.5)
    assert float(z.abs().mean()) < 1.5


# ---------------------------------------------------------------------------
# bookkeeping and guards
# ---------------------------------------------------------------------------

def test_entropy_bytes_matches_jax():
    s, m, k, v = 10, 128, 1024, 4096
    for kind in ("weight_space", "lrt", "head", "conv"):
        for in_kernel in (False, True):
            kw = dict(num_samples=s, m=m, k=k, n=v, b=8, t_out=248,
                      in_kernel=in_kernel)
            assert ops.entropy_bytes(kind, **kw) == JO.entropy_bytes(kind,
                                                                     **kw)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the CUDA wrappers raise before touching a build:
    only ``ops`` routes the CPU to the plain versions."""
    x, mu, sg, eps = (_t(a) for a in _conv_case(1, 2, 20))
    with pytest.raises(ValueError, match="CUDA"):
        PC.photonic_conv_cuda(x, mu, sg, eps)
    with pytest.raises(ValueError, match="CUDA"):
        PC.photonic_conv_sampled_cuda(x, mu, sg, 1)
    x, mu, sg, eps = (_t(a) for a in _mm_case(1, 4, 8, 6))
    with pytest.raises(ValueError, match="CUDA"):
        BM.bayes_matmul_cuda(x, mu, sg, eps)
    with pytest.raises(ValueError, match="num_samples"):
        BM.bayes_matmul_sampled_cuda(x, mu, sg, num_samples=BM.MAX_SAMPLES
                                     + 1)
