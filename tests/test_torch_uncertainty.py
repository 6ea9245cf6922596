"""core/uncertainty, core/entropy and data/synthetic of the port against
the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, meshless_reference  # noqa: F401
from repro.core import uncertainty as JU
from repro.core.entropy import KernelEntropy as JKernelEntropy
from repro.data.synthetic import TokenStreamState as JState
from repro.data.synthetic import token_batch as j_token_batch
from repro_torch.core import uncertainty as TU
from repro_torch.core.entropy import KernelEntropy
from repro_torch.data.synthetic import TokenStreamState, token_batch


def _logits(seed, shape=(6, 5, 37), scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uncertainty_from_logits_matches(seed):
    lg = _logits(seed)
    want = JU.uncertainty_from_logits(jnp.asarray(lg))
    got = TU.uncertainty_from_logits(torch.from_numpy(lg))
    for k in ("p_mean", "H", "SE", "MI"):
        assert_close(got[k], want[k], atol=2e-6, msg=k)


def test_predictive_moments_matches():
    lg = _logits(3)
    probs = np.exp(lg) / np.exp(lg).sum(-1, keepdims=True)
    want = JU.predictive_moments(jnp.asarray(probs))
    got = TU.predictive_moments(torch.from_numpy(probs))
    for k in ("p_mean", "H", "SE", "MI"):
        assert_close(got[k], want[k], atol=2e-6, msg=k)


def test_decision_rules_match():
    rng = np.random.default_rng(4)
    pos = rng.standard_normal(50).astype(np.float32) + 1.0
    neg = rng.standard_normal(70).astype(np.float32)
    assert_close(TU.auroc(torch.from_numpy(pos), torch.from_numpy(neg)),
                 JU.auroc(jnp.asarray(pos), jnp.asarray(neg)), atol=1e-6)
    roc_t = TU.roc_curve(torch.from_numpy(pos), torch.from_numpy(neg), 64)
    roc_j = JU.roc_curve(jnp.asarray(pos), jnp.asarray(neg), 64)
    for k in ("thresholds", "tpr", "fpr"):
        assert_close(roc_t[k], roc_j[k], atol=1e-5, msg=k)

    p = rng.dirichlet(np.ones(5), size=40).astype(np.float32)
    mi = rng.random(40).astype(np.float32)
    labels = rng.integers(0, 5, 40)
    got = TU.rejection_accuracy(torch.from_numpy(p), torch.from_numpy(mi),
                                torch.from_numpy(labels), 0.5)
    want = JU.rejection_accuracy(jnp.asarray(p), jnp.asarray(mi),
                                 jnp.asarray(labels), 0.5)
    for k in want:
        assert_close(got[k], want[k], atol=1e-6, msg=k)
    t_got = TU.best_rejection_threshold(torch.from_numpy(mi),
                                        torch.from_numpy(p),
                                        torch.from_numpy(labels), 32)
    t_want = JU.best_rejection_threshold(jnp.asarray(mi), jnp.asarray(p),
                                         jnp.asarray(labels), 32)
    np.testing.assert_allclose(t_got, t_want, atol=1e-5)

    se = rng.random(40).astype(np.float32)
    ds = rng.integers(0, 3, 40)
    got = TU.disentangle_clusters(torch.from_numpy(mi), torch.from_numpy(se),
                                  torch.from_numpy(ds))
    want = JU.disentangle_clusters(jnp.asarray(mi), jnp.asarray(se),
                                   jnp.asarray(ds))
    for k in want:
        assert_close(got[k], want[k], atol=1e-6, msg=k)


@pytest.mark.parametrize("ids", [(), (3,), (1, 2, 3), (2 ** 31 + 5, 7)])
def test_kernel_entropy_fold_matches(ids):
    got = KernelEntropy(seed=11).fold(*ids)
    want = int(np.asarray(JKernelEntropy(seed=11).fold(*ids)).view(
        np.uint32))
    assert got == want


@pytest.mark.parametrize("seed,vocab", [(0, 512), (3, 151936)])
def test_token_stream_matches(seed, vocab):
    t, st = token_batch(TokenStreamState(seed, 0, 1), 4, 33, vocab)
    j, jst = j_token_batch(JState(seed, 0, 1), 4, 33, vocab)
    np.testing.assert_array_equal(t, j)
    assert st.step == jst.step
