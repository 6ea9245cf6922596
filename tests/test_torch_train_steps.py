"""Multi-step training runs of the moe and encdec families against the
JAX package on the CPU.

The moe routing of the training forward (experts and keep mask, drops
included) is held equal to the reference's, layer by layer; a six-step
moe history is held against the JAX composition of step and AdamW;
micro-batching is held against the reference's own micro-batched step
(capacity is computed per dispatch, so for moe it differs from the full
batch by design, in both); and the train CLI crashed at step 6 and
resumed ends bit-equal to the uncrashed run for moe and encdec.  The
ELBO and every leaf's gradient are held in
``tests/test_torch_train_families.py``.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_every_gradient, jax_leaf,  # noqa: F401
                           jax_train_noise, meshless_reference, moe_pair,
                           to_numpy_tree, train_batch, train_pair)
from repro.core import svi as JS
from repro.launch import steps as JSteps
from repro.models import layers as JL
from repro.models import moe as JMoE
from repro.models import registry as JM
from repro.optim import adamw as JA
from repro_torch.core import svi as TS
from repro_torch.core import tree as T
from repro_torch.launch import steps as S
from repro_torch.launch import train as TT
from repro_torch.models import moe as TMoE
from repro_torch.optim import adamw as TA


def _jax_routing(monkeypatch):
    """The reference's top-k experts, one (T, K) array a layer."""
    seen = []
    top_k = jax.lax.top_k

    def recording(x, k):
        out = top_k(x, k)
        seen.append(np.asarray(out[1])[0])      # group axis G = 1
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    return seen


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "grok_1_314b"])
def test_training_forward_routes_as_jax(monkeypatch, arch):
    """The training forward's routing, layer by layer: the port's experts
    and keep mask equal the reference's (whose keep mask is its one-hot
    cumsum position against C), with experts dropped at capacity in the
    batch of the gradient test; the hidden states and the mean aux loss
    within 1e-5."""
    jcfg, jparams, tcfg, tparams = train_pair(moe_pair, arch)
    jb, tb = train_batch(tcfg)
    jh, jaux = JMoE.forward(jparams, jcfg, jb["tokens"])
    # the reference's layers one at a time, outside its scan, so that
    # top_k returns concrete experts
    seen = _jax_routing(monkeypatch)
    x = JL.apply_embed(jparams["embed"], jb["tokens"])
    positions = jnp.arange(jb["tokens"].shape[1])[None, :]
    for i in range(jcfg.num_layers):
        x, _ = JMoE._block_fwd(jax.tree.map(lambda a: a[i],
                                            jparams["blocks"]),
                               jcfg, x, positions)
    routes = []
    orig = TMoE.route

    def recording(*a, **kw):
        r = orig(*a, **kw)
        routes.append(r)
        return r

    monkeypatch.setattr(TMoE, "route", recording)
    th, taux = TMoE.forward(tparams, tcfg, tb["tokens"])
    assert len(seen) == len(routes) == tcfg.num_layers
    E, Kk = tcfg.num_experts, tcfg.top_k
    Tn = tb["tokens"].numel()
    C = max(int(Tn * Kk / E * tcfg.capacity_factor), 8)
    dropped = 0
    for want, r in zip(seen, routes):
        np.testing.assert_array_equal(r["topi"].numpy(), want)
        oh = np.eye(E, dtype=np.float32)[want].reshape(-1, E)
        pos = ((np.cumsum(oh, axis=0) - 1) * oh).sum(-1).reshape(want.shape)
        np.testing.assert_array_equal(r["keep"].numpy(), pos < C)
        dropped += int((pos >= C).sum())
    assert dropped > 0                          # the drop path ran
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_six_step_moe_history_matches_jax():
    """Six train steps of the reduced deepseek-moe-16b (warm-up, cosine,
    clipping, KL warm-up) with the JAX eps injected: the port's
    ``build_train_step`` against the JAX composition
    ``value_and_grad(elbo_loss(nll_loss))`` + ``apply_updates`` keyed
    ``fold_in(PRNGKey(seed), step)``: losses within 1e-5 relative, every
    final parameter within 1e-4 absolute (as for the dense family), but
    for the entries whose first-step reference gradient is not 0 and below
    Adam's eps, 1e-8: Adam's first move there, lr·g / (|g| + eps), follows
    the gradient's size, not its sign, and so bits far below the gradient
    test's 2e-6 (one entry of the shared expert's w1 gets 5.1e-9 from JAX
    and 1.8e-8 from the port, and ends 1.9e-4 apart); those are held
    within the 6 x lr that six steps can move them apart."""
    jcfg, jparams, tcfg, tparams = train_pair(moe_pair)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=6)
    jopt, topt = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    jsvi = JS.SVIConfig(kl_warmup_steps=3, num_train_examples=1000)
    tsvi = TS.SVIConfig(kl_warmup_steps=3, num_train_examples=1000)

    @jax.jit
    def jstep(params, opt, batch):
        step = opt["step"]
        key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        (loss, _), g = jax.value_and_grad(
            lambda p: JS.elbo_loss(
                lambda pp, b, k: JM.nll_loss(pp, jcfg, b, k), p, batch, key,
                step, jsvi), has_aux=True)(params)
        params, opt, _ = JA.apply_updates(params, g, opt, jopt)
        return params, opt, loss, g

    step_fn = S.build_train_step(tcfg, topt, tsvi, seed=0,
                                 noise=jax_train_noise)
    jp, jo = jparams, JA.init_state(jparams, jopt)
    state = {"params": T.map_tree(torch.clone, tparams),
             "opt": TA.init_state(tparams, topt)}
    jh, th = [], []
    for i in range(6):
        jb, tb = train_batch(tcfg, step=i)
        jp, jo, jl, jg = jstep(jp, jo, jb)
        if i == 0:
            g0 = to_numpy_tree(jg)
        state, m = step_fn(state, tb)
        assert "aux_loss" in m
        jh.append(float(jl))
        th.append(float(m["loss"]))
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    jpn = to_numpy_tree(jp)
    for path, t in T.items(state["params"]):
        want = jax_leaf(jpn, path)
        g = np.abs(jax_leaf(g0, path))
        flat = (g > 0) & (g < topt.eps)     # an expert no token reached: 0
        np.testing.assert_allclose(t.numpy()[~flat], want[~flat], atol=1e-4,
                                   err_msg=path)
        np.testing.assert_allclose(t.numpy()[flat], want[flat],
                                   atol=6 * kw["lr"], err_msg=path)


def _port_step_grads(tcfg, tparams, tb, micro_batches, noise, svi, opt):
    """The gradients (and metrics) one port train step hands AdamW."""
    seen = []

    def capture(params, grads, state, cfg):
        seen.append([g.clone() for g in T.leaves(grads)])
        return params, state, {"grad_norm": torch.zeros(()), "lr": 0.0}

    orig = S.adamw.apply_updates
    S.adamw.apply_updates = capture
    try:
        fn = S.build_train_step(tcfg, opt, svi, micro_batches=micro_batches,
                                noise=noise)
        _, m = fn({"params": tparams, "opt": TA.init_state(tparams, opt)},
                  tb)
    finally:
        S.adamw.apply_updates = orig
    return seen[0], m


def test_moe_micro_batches_match_the_reference_not_the_full_batch(
        monkeypatch):
    """Two micro-batches of the reduced deepseek-moe-16b: the gradients
    AdamW receives and the averaged metrics equal the reference's own
    micro-batched step (``repro.launch.steps.build_train_step``, its eps
    injected) within the gradient test's tolerances.  Capacity is
    computed per dispatch, so a micro-batch routes against its own C (8
    here, 10 for the full batch): with ONE eps for every draw the full
    batch still gives other drops, another loss and other gradients, in
    the port as in the reference.  A difference by design."""
    jcfg, jparams, tcfg, tparams = train_pair(moe_pair)
    jb, tb = train_batch(tcfg, B=4, S_len=8)
    kw = dict(lr=0.0, warmup_steps=0, schedule="constant", weight_decay=0.0)
    jsvi = JS.SVIConfig(num_train_examples=1000)
    tsvi = TS.SVIConfig(num_train_examples=1000)
    got, m = _port_step_grads(tcfg, tparams, tb, 2, jax_train_noise, tsvi,
                              TA.AdamWConfig(**kw))
    jseen = []

    def capture(params, grads, state, cfg):
        jseen.append(grads)
        return params, state, {}

    monkeypatch.setattr(JSteps.adamw, "apply_updates", capture)
    jfn = JSteps.build_train_step(jcfg, JA.AdamWConfig(**kw), jsvi,
                                  micro_batches=2, seed=0)
    _, jm = jfn({"params": jparams,
                 "opt": JA.init_state(jparams, JA.AdamWConfig(**kw))}, jb)
    for name in ("loss", "nll", "kl", "accuracy", "aux_loss"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert_every_gradient(tparams, got, jseen[0])

    eps = torch.randn(tparams["head"]["mu"].shape,
                      generator=torch.Generator().manual_seed(2))
    one = lambda k, s, d: eps  # noqa: E731
    full, mf = _port_step_grads(tcfg, tparams, tb, 1, one, tsvi,
                                TA.AdamWConfig(**kw))
    micro, mm = _port_step_grads(tcfg, tparams, tb, 2, one, tsvi,
                                 TA.AdamWConfig(**kw))
    assert abs(float(mf["aux_loss"]) - float(mm["aux_loss"])) > 1e-4
    assert not all(torch.allclose(a, b, atol=1e-6, rtol=1e-4)
                   for a, b in zip(full, micro))


# ---------------------------------------------------------------------------
# the train CLI: crash / resume
# ---------------------------------------------------------------------------

def _args(**kw):
    base = dict(arch="deepseek_moe_16b", reduced=True, device="cpu",
                steps=8, batch=2, seq=16, lr=1e-3, micro_batches=1,
                compress_topk=0.0, seed=0, ckpt_dir=None, ckpt_every=4,
                resume=False, fail_at_step=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "seamless_m4t_medium"])
def test_cli_crash_and_resume_is_bit_exact(tmp_path, arch):
    """Eight steps straight against a crash at step 6 and a resume from
    the step-4 checkpoint: the resumed losses and the final state
    (parameters, moments, step) bit for bit, no ``.tmp`` left behind."""
    ref = TT.train(_args(arch=arch, ckpt_dir=str(tmp_path / "a")))
    with pytest.raises(RuntimeError, match="injected failure"):
        TT.train(_args(arch=arch, ckpt_dir=str(tmp_path / "b"),
                       fail_at_step=6))
    assert sorted(os.listdir(tmp_path / "b")) == ["step_000000004"]
    out = TT.train(_args(arch=arch, ckpt_dir=str(tmp_path / "b"),
                         resume=True))
    assert out["history"] == ref["history"][4:]
    assert np.isfinite(ref["history"]).all()
    for (pa, a), (pb, b) in zip(T.items(ref["state"]), T.items(out["state"])):
        assert pa == pb and torch.equal(a, b), pa
    assert not [d for d in os.listdir(tmp_path / "b") if d.endswith(".tmp")]
