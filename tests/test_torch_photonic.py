"""core/entropy, core/photonic and core/surrogate of the port against the
JAX package, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, meshless_reference  # noqa: F401
from repro.core import entropy as JE
from repro.core import photonic as JP
from repro.core import surrogate as JS
from repro.core.bayesian import GaussianVariational as JGV
from repro.kernels import ref as JR
from repro_torch.core import entropy as E
from repro_torch.core import photonic as P
from repro_torch.core import surrogate as S
from repro_torch.core.bayesian import GaussianVariational

CONSTANTS = ("CENTER_FREQ_THZ", "CHANNEL_SPACING_GHZ", "NUM_CHANNELS",
             "BW_MIN_GHZ", "BW_MAX_GHZ", "ELEC_BW_GHZ",
             "GROUP_DELAY_PS_PER_THZ", "DAC_BITS", "ADC_BITS",
             "SAMPLES_PER_SYMBOL", "CONV_LATENCY_PS", "INTEGRATION_FACTOR")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# entropy sources
# ---------------------------------------------------------------------------

def test_entropy_constants_and_maps_match_jax():
    for name in CONSTANTS:
        assert getattr(E, name) == getattr(JE, name), name
    assert E.relstd_range() == JE.relstd_range()
    bw = np.linspace(10.0, 200.0, 41, dtype=np.float32)
    assert_close(E.modes_from_bandwidth(torch.from_numpy(bw)),
                 JE.modes_from_bandwidth(jnp.asarray(bw)), atol=0)
    rel = np.linspace(0.01, 0.9, 41, dtype=np.float32)
    assert_close(E.bandwidth_for_relstd(torch.from_numpy(rel)),
                 JE.bandwidth_for_relstd(jnp.asarray(rel)), atol=0,
                 rtol=1e-6)
    assert P.conv_throughput_estimate() == JP.conv_throughput_estimate()


@pytest.mark.parametrize("seed,ids", [(0, ()), (7, (1,)), (2 ** 31 + 5,
                                                             (3, 9, 0)),
                                      (123, (2 ** 32 - 1, 4))])
def test_kernel_entropy_fold_is_bit_equal(seed, ids):
    want = int(np.asarray(JE.KernelEntropy(seed=seed).fold(*ids))) \
        & 0xFFFFFFFF
    assert E.KernelEntropy(seed=seed).fold(*ids) == want


def test_kernel_entropy_stream_is_standard_and_deterministic():
    src = E.KernelEntropy(seed=5)
    a = src.sample(src.key(device="cpu"), (100_000,))
    assert torch.equal(a, src.sample(src.key(device="cpu"), (100_000,)))
    six = E.KernelEntropy(seed=6)
    assert not torch.equal(a, six.sample(six.key(device="cpu"), (100_000,)))
    # n = 1e5: the mean's sd is 0.0032 and the std's 0.0022; 5 sd bands
    assert abs(float(a.mean())) < 0.016
    assert abs(float(a.std()) - 1.0) < 0.011
    assert src.key(2, device="cpu").initial_seed() == src.fold(2)
    if not torch.cuda.is_available():
        # the seed's own stream is drawn on the GPU unless asked otherwise
        with pytest.raises(RuntimeError, match="CUDA"):
            src.sample(None, (4,))


@pytest.mark.parametrize("modes", [6.0, 30.0])
def test_ase_moments_and_skew(modes):
    """Standardised Gamma(M): mean 0, std 1, skew 2/sqrt(M).  n = 4e5:
    sd of the mean 0.0016, of the std ~0.0013, of the skew ~0.007 at
    M = 6 (Gamma's sixth moment); the bands are 5 sd."""
    n = 400_000
    eps = E.ASEEntropy(modes=modes).sample(_gen(1), (n,)).double().numpy()
    assert abs(eps.mean()) < 0.008
    assert abs(eps.std() - 1.0) < 0.0065
    skew = ((eps - eps.mean()) ** 3).mean() / eps.std() ** 3
    assert abs(skew - 2 / np.sqrt(modes)) < 0.035
    g = E.PRNGEntropy().sample(_gen(2), (n,)).double().numpy()
    assert abs(g.mean()) < 0.008 and abs(g.std() - 1.0) < 0.0065


def test_entropy_stream_wraparound_matches_jax():
    js = JE.EntropyStream.create(jax.random.key(2), 100)
    ts = E.EntropyStream(buffer=torch.from_numpy(np.array(js.buffer)))
    for shape in ((30,), (30,), (6, 10), (100,), (7,)):
        jv, js = js.draw(shape)
        tv, ts = ts.draw(shape)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert ts.cursor == int(js.cursor)
    with pytest.raises(ValueError, match="capacity"):
        ts.draw((101,))
    made = E.EntropyStream.create(_gen(3), 64)
    assert made.buffer.shape == (64,) and made.cursor == 0


def test_entropy_health_matches_jax():
    r = np.random.default_rng(4)
    eps = r.standard_normal(20_000).astype(np.float32)
    bits = E.gaussian_to_bits(eps)
    np.testing.assert_array_equal(bits, JE.gaussian_to_bits(eps))
    for b in (bits, np.zeros(4096, np.uint8), r.integers(0, 2, 999)):
        assert E.entropy_health(b) == JE.entropy_health(b)
    assert E.entropy_health(bits)["monobit_z"] < 4.0
    assert E.entropy_health(np.zeros(4096, np.uint8))["monobit_z"] > 10.0


# ---------------------------------------------------------------------------
# photonic twin
# ---------------------------------------------------------------------------

def test_quantize_ste_forward_matches_jax_and_gradient_is_identity():
    x = np.linspace(-1.3, 1.3, 1001, dtype=np.float32)
    for bits, x_max in ((8, 1.0), (8, 4.0), (5, 2.0)):
        want = JP.quantize_ste(jnp.asarray(x), bits, x_max)
        xt = torch.from_numpy(x).requires_grad_(True)
        got = P.quantize_ste(xt, bits, x_max)
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(want))
        got.sum().backward()
        assert torch.equal(xt.grad, torch.ones_like(xt))


def test_program_and_moments_match_jax():
    r = np.random.default_rng(6)
    mu = r.uniform(-1.2, 1.2, 9).astype(np.float32)
    sg = (np.abs(mu) * r.uniform(0.05, 0.5, 9)).astype(np.float32)
    jp = JP.program_for_target(jnp.asarray(mu), jnp.asarray(sg))
    tp = P.program_for_target(torch.from_numpy(mu), torch.from_numpy(sg))
    assert_close(tp.power, jp.power, atol=0)
    assert_close(tp.bandwidth, jp.bandwidth, atol=0, rtol=1e-6)
    for a, b in zip(tp.moments(), jp.moments()):
        assert_close(a, b, atol=0, rtol=1e-6)


def test_effective_bandwidth_quantizes_and_jitters():
    cfg = P.MachineConfig(bw_quant_ghz=12.5, bw_jitter_std=0.0)
    eff = P.effective_bandwidth(_gen(), torch.tensor([26.0, 99.0, 150.0]),
                                cfg)
    assert eff.tolist() == [25.0, 100.0, 150.0]
    cfg = P.MachineConfig(bw_quant_ghz=0.0, bw_jitter_std=0.1)
    effs = P.effective_bandwidth(_gen(1), torch.full((64,), 100.0), cfg,
                                 shots=(256,))
    rel = effs.numpy() / 100.0 - 1.0
    assert effs.shape == (256, 64)
    assert abs(rel.std() - 0.1) < 0.02
    assert (effs >= E.BW_MIN_GHZ).all() and (effs <= E.BW_MAX_GHZ).all()


def test_photonic_conv_matches_machine_twin():
    """The twin with its impairments off, fed the kernel's variates, is
    the photonic conv oracle (the JAX package's ``ref.photonic_conv``)."""
    cfg = P.MachineConfig(detector_noise=0.0, crosstalk=0.0, drift_std=0.0,
                          eom_mod_depth=0.0, bw_quant_ghz=0.0,
                          bw_jitter_std=0.0, gaussian_surrogate=True)
    r = np.random.default_rng(8)
    x = r.uniform(-1, 1, (3, 24)).astype(np.float32)
    mu = np.linspace(-0.5, 0.5, 9, dtype=np.float32)
    bw = np.full((9,), 100.0, np.float32)
    eps = r.standard_normal((3, 16, 9)).astype(np.float32)
    prog = P.ChannelProgram(power=torch.from_numpy(mu),
                            bandwidth=torch.from_numpy(bw))
    got = P.convolve(_gen(), torch.from_numpy(x), prog, cfg,
                     eps=torch.from_numpy(eps))
    sigma = np.abs(mu) / np.sqrt(np.asarray(JE.modes_from_bandwidth(bw)))
    want = JR.photonic_conv(jnp.asarray(x), jnp.asarray(mu),
                            jnp.asarray(sigma), jnp.asarray(eps))
    assert got.shape == (3, 16)
    # the twin sums the taps in a vector reduction, the oracle in XLA's
    # order: one ADC step (4/127) apart on a level boundary at most
    d = np.abs(got.numpy() - np.asarray(want))
    assert (d > 1e-5).sum() <= 1 and d.max() <= 4 / 127 + 1e-5


def test_convolve_mean_tracks_target():
    cfg = P.MachineConfig(detector_noise=0.0, crosstalk=0.0, drift_std=0.0,
                          eom_mod_depth=0.0)
    mu = torch.linspace(-0.6, 0.6, 9)
    prog = P.ChannelProgram(power=mu, bandwidth=torch.full((9,), 150.0))
    x = torch.rand((64,), generator=_gen(0)) * 2 - 1
    ys = P.convolve_shots(_gen(1), x, prog, 2000, cfg)
    idx = torch.arange(56)[:, None] + torch.arange(9)
    target = x[idx] @ mu.flip(0)
    # per-output std <= 0.6/sqrt(22.5) * ||x|| ~ 0.4: 2000 shots -> 0.01
    assert_close(ys.mean(0), target, atol=0.05)
    one = P.convolve(_gen(1), x, prog, cfg)
    assert one.shape == (56,) and torch.isfinite(one).all()


def test_calibration_reduces_error():
    mu_t = torch.tensor([0.5, -0.3, 0.7, -0.6, 0.2, 0.4, -0.5, 0.3, -0.2])
    sg_t = torch.abs(mu_t) * 0.15
    _, hist = P.calibrate(_gen(4), mu_t, sg_t, iters=8, n_shots=256)
    assert hist["mu_err"][-1] < hist["mu_err"][0]
    assert hist["mu_err"][-1] < 0.05


def test_computation_error_in_paper_band():
    """Fig. 2c/d: the twin lands in the paper's regime (mean error 0.158,
    std error 0.266), with the std axis the less accurate one — banded,
    at a reduced number of kernels."""
    r = P.computation_error(_gen(5), n_kernels=6, n_shots=256, seq_len=48)
    assert r["mean_error"] < 0.35
    assert r["std_error"] < 0.6
    assert r["mean_error"] < r["std_error"]


# ---------------------------------------------------------------------------
# surrogate
# ---------------------------------------------------------------------------

def test_surrogate_matches_jax_and_clamp_is_ste():
    r = np.random.default_rng(9)
    mu = r.uniform(-0.8, 0.8, 50).astype(np.float32)
    rho = r.uniform(-6, 3, 50).astype(np.float32)
    eps = r.standard_normal(50).astype(np.float32)
    jspec, tspec = JS.SurrogateSpec(), S.SurrogateSpec()
    jq = JGV(mu=jnp.asarray(mu), rho=jnp.asarray(rho))
    tq = GaussianVariational(mu=torch.from_numpy(mu),
                             rho=torch.from_numpy(rho).requires_grad_(True))
    assert_close(tspec.realizable_sigma(tq.mu, tq.sigma),
                 jspec.realizable_sigma(jq.mu, jq.sigma), atol=1e-7)
    w = tspec.apply_weight(tq, torch.from_numpy(eps))
    want = jspec.apply_weight(jq, jnp.asarray(eps))
    d = np.abs(w.detach().numpy() - np.asarray(want))
    assert (d > 1e-6).sum() <= 1 and d.max() <= 1 / 127 + 1e-6
    w.sum().backward()
    assert (tq.rho.grad.abs() > 0).all()      # the clamp passes gradients
    h = np.linspace(-5, 5, 301, dtype=np.float32)
    assert_close(tspec.apply_output(torch.from_numpy(h)),
                 jspec.apply_output(jnp.asarray(h)), atol=0)
    assert_close(tspec.apply_input(torch.from_numpy(h / 4)),
                 jspec.apply_input(jnp.asarray(h / 4)), atol=0)
    assert_close(S.ste_clip(torch.from_numpy(h), -1.0, 2.0),
                 JS.ste_clip(jnp.asarray(h), -1.0, 2.0), atol=0)
