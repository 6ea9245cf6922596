"""Training of the moe, ssm, hybrid and encdec families against the JAX
package on the CPU: the ELBO and every leaf's gradient.

The SVI loss (one weight-space draw of the Bayesian head + beta * KL / N;
for moe also 0.01 x the Switch aux loss) and the gradient of every leaf
are held against ``jax.value_and_grad(svi.elbo_loss(M.nll_loss))`` at
the reduced configs (f32) with the JAX package's eps injected
(``_torch_parity.jax_train_noise``): deepseek-moe-16b (``experts_ep``,
a shared expert), grok-1-314b (``experts_tp``, the logits soft-cap),
mamba2-370m, zamba2-7b at 4 layers and at 5 (a last group of one
layer) and seamless-m4t-medium with random frames.  The ssm and hybrid
rows run 40 tokens: two SSD chunks of 16 and a padded tail, so the
padding and the inter-chunk recurrence are differentiated; they run
again with the SSD's cumsum in the form the card's deterministic train
step takes.  The multi-step runs (moe routing, history, micro-batches,
the CLI's crash and resume) are in ``tests/test_torch_train_steps.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_every_gradient, encdec_pair,  # noqa: F401
                           hybrid_pair, jax_train_noise, meshless_reference,
                           moe_pair, ssm_pair, train_batch, train_pair)
from repro.core import svi as JS
from repro.models import registry as JM
from repro_torch.core import keys as K
from repro_torch.core import svi as TS
from repro_torch.core import tree as T
from repro_torch.models import registry as TM

# case -> (pair helper, its arguments, tokens a row)
CASES = {
    "deepseek_moe_16b": (moe_pair, ("deepseek_moe_16b",), 16),
    "grok_1_314b": (moe_pair, ("grok_1_314b",), 16),
    "mamba2_370m": (ssm_pair, (), 40),
    "zamba2_7b": (hybrid_pair, (), 40),
    "zamba2_7b-5-layers": (hybrid_pair, ("zamba2_7b", 0, 5), 40),
    "seamless_m4t_medium": (encdec_pair, (), 16),
}


def _jax_loss_grads(jcfg, jparams, jbatch, key, step, svi):
    def loss(p):
        return JS.elbo_loss(lambda pp, b, k: JM.nll_loss(pp, jcfg, b, k), p,
                            jbatch, key, jnp.asarray(step), svi)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)


def _port_loss_grads(tcfg, tparams, tbatch, key, step, svi, noise):
    leaves = T.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = TS.elbo_loss(
            lambda p, b, k: TM.nll_loss(p, tcfg, b, k, noise=noise),
            tparams, tbatch, key, step, svi)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_elbo_and_every_gradient_match_jax(case):
    """Loss, NLL, KL, beta, accuracy (and moe's ``aux_loss``) and the
    gradient of every leaf (router, experts, SSM decays, the shared block,
    both stacks of encdec, the head's mu and rho) against JAX with its eps
    injected: the loss within 1e-6 relative, the metrics within 1e-6,
    every gradient within 2e-6 absolute + 1e-4 relative."""
    _check_elbo_and_gradients(case)


@pytest.mark.parametrize("case", ["mamba2_370m", "zamba2_7b"])
def test_deterministic_ssd_form_matches_jax(monkeypatch, case):
    """The SSD's within-chunk cumsum as the card's train step runs it,
    under the deterministic mode (a product with the lower-triangular
    ones, ``ssm.chunk_cumsum``), turned on here on the CPU with
    ``torch.cumsum`` made to raise: the ELBO, its metrics and every
    gradient within the same tolerances."""
    from repro_torch.models import ssm
    x = torch.randn((2, 3, 16, 4), dtype=torch.float64)
    want = torch.cumsum(x, dim=2)

    def refused(*a, **kw):
        raise RuntimeError("cumsum has no deterministic CUDA form")

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    monkeypatch.setattr(torch, "cumsum", refused)
    try:
        torch.testing.assert_close(ssm.chunk_cumsum(x), want)
        _check_elbo_and_gradients(case)
    finally:
        torch.use_deterministic_algorithms(prev)


def _check_elbo_and_gradients(case):
    pair, args, tokens = CASES[case]
    jcfg, jparams, tcfg, tparams = train_pair(pair, *args)
    jb, tb = train_batch(tcfg, S_len=tokens)
    step = 3
    jsvi = JS.SVIConfig(kl_warmup_steps=4, num_train_examples=1000)
    tsvi = TS.SVIConfig(kl_warmup_steps=4, num_train_examples=1000)
    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    (jl, jaux), jg = _jax_loss_grads(jcfg, jparams, jb, key, step, jsvi)
    loss, aux, grads = _port_loss_grads(tcfg, tparams, tb,
                                        K.fold_in(K.root(0), step), step,
                                        tsvi, jax_train_noise)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    assert set(aux) == set(jaux)
    if tcfg.family == "moe":
        assert "aux_loss" in aux
    for name in sorted(aux):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    paths = assert_every_gradient(tparams, grads, jg)
    for path in ("head/rho", "blocks/router/w", "blocks/A_log",
                 "shared/attn/wq", "encoder/attn/wk",
                 "decoder/cross_attn/wk"):
        if path in paths:
            assert float(grads[paths.index(path)].abs().max()) > 0, path
