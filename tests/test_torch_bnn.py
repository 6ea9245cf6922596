"""The blood-cell BNN, the Bayesian layers and the image generators of the
port against the JAX package, with the JAX weights taken across and, in
machine mode, the JAX package's Gamma draws injected."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_close, meshless_reference  # noqa: F401
from _torch_parity import to_numpy_tree
from repro.configs.registry import get_bnn_config as j_get_bnn_config
from repro.core import bayesian as JBa
from repro.core import uncertainty as JU
from repro.core.entropy import KernelEntropy as JKernelEntropy
from repro.data import synthetic as JD
from repro.models import bnn_cnn as JB
from repro_torch.configs.registry import get_bnn_config
from repro_torch.core import bayesian as TBa
from repro_torch.core import uncertainty as TU
from repro_torch.core.entropy import KernelEntropy
from repro_torch.data import synthetic as TD
from repro_torch.models import bnn_cnn as TB

GENERATORS = ("blood_cells", "blood_cells_ood", "glyphs", "ambiguous_glyphs",
              "fashion_ood")


@functools.lru_cache(maxsize=None)
def _bnn(seed=0):
    """(JAX cfg, JAX params, port cfg, port params) from one JAX init."""
    jcfg = j_get_bnn_config("bloodcell")
    tcfg = get_bnn_config("bloodcell")
    jparams = JB.init_params(jax.random.key(seed), jcfg)
    tparams = TB.params_from_numpy(to_numpy_tree(jparams), tcfg, CPU)
    return jcfg, jparams, tcfg, tparams


@functools.lru_cache(maxsize=None)
def _images(n=48):
    x, _ = TD.blood_cells(np.random.default_rng(0), n)
    return x


# ---------------------------------------------------------------------------
# data and config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GENERATORS)
def test_image_generators_match_jax(name):
    a, la = getattr(TD, name)(np.random.default_rng(3), 12)
    b, lb = getattr(JD, name)(np.random.default_rng(3), 12)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)


def test_bnn_configs_match_jax():
    for preset in ("bloodcell", "mnist"):
        j, t = j_get_bnn_config(preset), get_bnn_config(preset)
        assert vars(j) == vars(t), preset


def test_init_params_has_the_jax_layout():
    _, jparams, tcfg, tparams = _bnn()
    mine = TB.init_params(torch.Generator().manual_seed(0), tcfg)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a).shape,
                                  to_numpy_tree(jparams))

    def shapes(p):
        if isinstance(p, TBa.GaussianVariational):
            return {"mu": tuple(p.mu.shape), "rho": tuple(p.rho.shape)}
        if isinstance(p, dict):
            return {k: shapes(v) for k, v in p.items()}
        return tuple(p.shape)

    assert shapes(mine) == shapes(tparams) == want
    assert_close(mine["b3"]["dw"].sigma, np.full((99, 1, 3, 3), 0.08),
                 atol=1e-6)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def test_mean_mode_logits_match_jax():
    jcfg, jparams, tcfg, tparams = _bnn()
    x = _images()
    want = jax.jit(JB.apply, static_argnums=(1, 4))(
        jparams, jcfg, jnp.asarray(x), jax.random.key(0), "mean")
    got = TB.apply(tparams, tcfg, torch.from_numpy(x), None, mode="mean")
    assert got.shape == (48, 7)
    assert_close(got, want, atol=1e-4)


def _jax_gamma(key):
    """The port's machine-mode noise provider returning the JAX package's
    draws: sample s of ``mc_predict`` uses split(key, N)[s], folded with
    the block index, exactly as ``bnn_cnn._dw_weights`` does."""
    keys = jax.random.split(key, 10)

    def draw(s, block, m):
        kd = jax.random.fold_in(keys[s], block)
        return torch.from_numpy(np.array(jax.random.gamma(
            kd, jnp.asarray(m.numpy()))))

    return draw


def test_machine_mode_mc_predict_matches_jax_with_its_draws():
    """Machine mode with the JAX variates injected.  The ADC after the
    probabilistic depthwise conv can put a sum on the other side of a
    level where the two frameworks add in another order, so the
    probabilities agree within 1e-3 and the predicted class on >= 99% of
    images; the test prints how many probabilities moved past 1e-5."""
    jcfg, jparams, tcfg, tparams = _bnn()
    x = _images()
    key = jax.random.key(7)
    want = jax.jit(JB.mc_predict, static_argnums=(1, 4))(
        jparams, jcfg, jnp.asarray(x), key, "machine")
    got = TB.mc_predict(tparams, tcfg, torch.from_numpy(x), mode="machine",
                        noise=_jax_gamma(key))
    assert got.shape == (10, 48, 7)
    d = np.abs(got.numpy() - np.asarray(want))
    print(f"machine mode: {(d > 1e-5).sum()} of {d.size} probabilities "
          f"differ by more than 1e-5 (max {d.max():.3g})")
    assert d.max() < 1e-3
    same = (got.mean(0).argmax(-1).numpy()
            == np.asarray(want).mean(0).argmax(-1)).mean()
    assert same >= 0.99
    mt = TU.predictive_moments(got)
    mj = JU.predictive_moments(want)
    for k in ("p_mean", "H", "SE", "MI"):
        assert_close(mt[k], mj[k], atol=1e-3, msg=k)
    assert (mt["MI"] >= 0).all()


def test_mc_predict_is_a_function_of_the_seed():
    _, _, tcfg, tparams = _bnn()
    x = torch.from_numpy(_images()[:8])
    a = TB.mc_predict(tparams, tcfg, x, torch.Generator().manual_seed(4),
                      mode="machine")
    b = TB.mc_predict(tparams, tcfg, x, torch.Generator().manual_seed(4),
                      mode="machine")
    assert torch.equal(a, b)
    c = TB.mc_predict(tparams, tcfg, x, torch.Generator().manual_seed(5),
                      mode="machine")
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])          # samples differ
    assert_close(a.sum(-1), np.ones((10, 8)), atol=1e-6)
    m = TB.mc_predict(tparams, tcfg, x, mode="mean")
    assert torch.equal(m[0], m[9])


def test_surrogate_mode_runs_and_gradients_reach_rho():
    _, _, tcfg, tparams = _bnn()
    q = tparams["b3"]["dw"]
    q = TBa.GaussianVariational(mu=q.mu.clone().requires_grad_(True),
                                rho=q.rho.clone().requires_grad_(True))
    params = dict(tparams, b3=dict(tparams["b3"], dw=q))
    x = torch.from_numpy(_images()[:8])
    logits = TB.apply(params, tcfg, x, torch.Generator().manual_seed(1),
                      mode="surrogate")
    assert logits.shape == (8, 7) and torch.isfinite(logits).all()
    logits.logsumexp(-1).sum().backward()
    assert q.mu.grad.abs().sum() > 0 and q.rho.grad.abs().sum() > 0
    with pytest.raises(ValueError):
        TB.apply(params, tcfg, x, None, mode="analog")


# ---------------------------------------------------------------------------
# Bayesian layers
# ---------------------------------------------------------------------------

def test_variational_maps_and_kl_match_jax():
    r = np.random.default_rng(1)
    mu = r.standard_normal(64).astype(np.float32)
    rho = r.uniform(-5, 3, 64).astype(np.float32)
    eps = r.standard_normal(64).astype(np.float32)
    jq = JBa.GaussianVariational(mu=jnp.asarray(mu), rho=jnp.asarray(rho))
    tq = TBa.GaussianVariational(mu=torch.from_numpy(mu),
                                 rho=torch.from_numpy(rho))
    assert_close(tq.sigma, jq.sigma, atol=1e-7, rtol=1e-6)
    assert_close(TBa.inv_softplus(tq.sigma), rho, atol=1e-4, rtol=1e-5)
    y = np.linspace(0.0, 3.0, 31, dtype=np.float32)
    assert_close(TBa.inv_softplus(torch.from_numpy(y)),
                 JBa.inv_softplus(jnp.asarray(y)), atol=1e-6, rtol=1e-6)
    assert_close(tq.sample_with_eps(torch.from_numpy(eps)),
                 jq.sample_with_eps(jnp.asarray(eps)), atol=1e-6)
    for p in (1.0, 0.3):
        assert_close(tq.kl_to_prior(p), jq.kl_to_prior(p), rtol=1e-5,
                     atol=0)
    zero = TBa.GaussianVariational(mu=torch.zeros(5),
                                   rho=torch.full((5,), float(
                                       TBa.inv_softplus(1.0))))
    assert abs(float(zero.kl_to_prior(1.0))) < 1e-5


@pytest.mark.parametrize("stride,k", [(1, 3), (2, 3), (2, 2)])
def test_same_conv2d_matches_xla_same(stride, k):
    r = np.random.default_rng(stride * 10 + k)
    x = r.standard_normal((2, 4, 7, 6)).astype(np.float32)
    w = r.standard_normal((6, 2, k, k)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        feature_group_count=2, dimension_numbers=("NCHW", "OIHW", "NCHW"))
    got = TBa.same_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          stride=stride, groups=2)
    assert_close(got, want, atol=1e-5)


def test_bayes_layers_draw_around_the_mean():
    g = torch.Generator().manual_seed(0)
    q = TBa.GaussianVariational.init(g, (16, 8), fan_in=16, init_sigma=0.1)
    x = torch.randn((4, 16), generator=g)
    ys = TBa.mc_forward(lambda gen: TBa.bayes_dense(x, q, gen), g, 400)
    assert ys.shape == (400, 4, 8) and not torch.equal(ys[0], ys[1])
    std = torch.sqrt((x * x) @ q.sigma ** 2)
    z = (ys.mean(0) - x @ q.mu) / (std / 20.0)
    assert float(z.abs().mean()) < 1.5
    w = TBa.GaussianVariational.init(g, (3, 2, 3, 3), fan_in=18)
    xc = torch.randn((2, 2, 5, 5), generator=g)
    y = TBa.bayes_conv2d(xc, w, g, hardware_bits=8)
    assert y.shape == (2, 3, 5, 5) and torch.isfinite(y).all()


def test_bayes_dense_sampled_moments_and_determinism():
    g = torch.Generator().manual_seed(0)
    q = TBa.GaussianVariational.init(g, (16, 8), fan_in=16, init_sigma=0.1)
    x = torch.randn((4, 16), generator=g)
    src = KernelEntropy(seed=21)
    y = TBa.bayes_dense_sampled(x, q, src, num_samples=256)
    assert y.shape == (256, 4, 8)
    assert torch.equal(y, TBa.bayes_dense_sampled(x, q, src, 256))
    std = torch.sqrt((x * x) @ q.sigma ** 2)
    z = (y.mean(0) - x @ q.mu) / (std / 16.0)
    assert float(z.abs().mean()) < 1.5


def test_mc_forward_seeded_is_seed_deterministic():
    fn = lambda g: torch.randn((3,), generator=g)  # noqa: E731
    a = TBa.mc_forward_seeded(fn, KernelEntropy(seed=9), 6, device="cpu")
    assert torch.equal(a, TBa.mc_forward_seeded(fn, KernelEntropy(seed=9),
                                                6, device="cpu"))
    c = TBa.mc_forward_seeded(fn, KernelEntropy(seed=10), 6, device="cpu")
    assert a.shape == (6, 3) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])
    # the per-sample seeds are the JAX package's fold of the base seed
    assert KernelEntropy(seed=9).fold(2) == int(np.asarray(
        JKernelEntropy(seed=9).fold(2))) & 0xFFFFFFFF
