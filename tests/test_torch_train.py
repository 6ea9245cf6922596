"""The port's training path against the JAX package on the CPU.

The SVI loss (one weight-space draw of the Bayesian head + beta * KL / N)
and its gradients for every leaf, the head's ``rho`` included, are held
against ``jax.value_and_grad(svi.elbo_loss(M.nll_loss))`` at the reduced
qwen2 and phi-3-vision configs (f32) with the JAX package's eps injected
(``_torch_parity.jax_train_noise`` maps the port's step keys to the JAX
keys of the same path).  One AdamW update is held against
``adamw.apply_updates`` (meshless), and a six-step run against the JAX
composition of the two.  Then the reference's own training tests, held
on the port: micro-batching equals the full batch, the loss decreases,
compressed training converges, and the train CLI crashed at step 6 and
resumed ends bit-equal to the uncrashed run.
"""

import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, dense_pair, jax_train_noise,  # noqa: F401
                           meshless_reference, to_numpy_tree)
from repro.core import svi as JS
from repro.models import registry as JM
from repro.optim import adamw as JA
from repro_torch.core import keys as K
from repro_torch.core import svi as TS
from repro_torch.core import tree as T
from repro_torch.data.synthetic import TokenStreamState, token_batch
from repro_torch.launch import steps as S
from repro_torch.launch import train as TT
from repro_torch.models import registry as TM
from repro_torch.optim import adamw as TA

ARCHS = ("qwen2_1_5b", "phi_3_vision_4_2b")


def _pair(arch, seed=0):
    """(jcfg, jax params, tcfg, port TRAINING params) from one JAX init."""
    jcfg, jparams, tcfg, _ = dense_pair(arch, seed)
    tparams = TM.train_params_from_numpy(to_numpy_tree(jparams), tcfg, CPU)
    return jcfg, jparams, tcfg, tparams


def _batch(cfg, B=2, S_len=16, seed=0, step=0):
    """(jax batch, port batch): the token stream's batch, plus random
    prefix embeds (numpy, seeded) for vlm."""
    toks, _ = token_batch(TokenStreamState(seed=seed, host=0, num_hosts=1,
                                           step=step), B, S_len + 1,
                          cfg.vocab_size)
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        nb["prefix_embeds"] = np.random.default_rng(seed + 1) \
            .standard_normal((B, cfg.num_prefix_embeds, cfg.d_model)) \
            .astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v.copy()) for k, v in nb.items()})


def _leaf(tree, path):
    """The leaf of a numpy JAX tree at a port path (``head/mu`` is the
    JAX head's ``q/mu``)."""
    node = tree
    for part in path.split("/"):
        node = node["q"][part] if part in ("mu", "rho") and "q" in node \
            else node[part]
    return node


def _jax_loss_grads(jcfg, jparams, jbatch, key, step, svi):
    def loss(p):
        return JS.elbo_loss(lambda pp, b, k: JM.nll_loss(pp, jcfg, b, k), p,
                            jbatch, key, jnp.asarray(step), svi)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)


@pytest.mark.parametrize("arch", ARCHS)
def test_elbo_and_every_gradient_match_jax(arch):
    """Loss, NLL, KL, beta, accuracy and the gradient of every leaf (the
    head's mu and rho included) against JAX with its eps injected: the
    loss within 1e-6 relative (the KL sums 65,536 head weights in another
    order), every gradient within 2e-6 absolute + 1e-4 relative."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    jb, tb = _batch(tcfg)
    step = 3
    jsvi = JS.SVIConfig(kl_warmup_steps=4, num_train_examples=1000)
    tsvi = TS.SVIConfig(kl_warmup_steps=4, num_train_examples=1000)
    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    (jl, jaux), jg = _jax_loss_grads(jcfg, jparams, jb, key, step, jsvi)
    leaves = T.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = TS.elbo_loss(
        lambda p, b, k: TM.nll_loss(p, tcfg, b, k, noise=jax_train_noise),
        tparams, tb, K.fold_in(K.root(0), step), step, tsvi)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for name in ("nll", "kl", "beta", "accuracy"):
        np.testing.assert_allclose(float(aux[name].detach()),
                                   float(jaux[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    jgn = to_numpy_tree(jg)
    paths = [path for path, _ in T.items(tparams)]
    assert "head/rho" in paths and len(paths) == len(jax.tree.leaves(jg))
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), _leaf(jgn, path), atol=2e-6,
                                   rtol=1e-4, err_msg=path)
    assert float(grads[paths.index("head/rho")].abs().max()) > 0


def _opt_tree(rng):
    """A parameter tree with a 2-D f32 leaf, a 1-D leaf (no decay), a
    layer-stacked (L, d) leaf (decays) and a bf16 leaf."""
    return {"w": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal((6,)).astype(np.float32),
            "ln": (1 + 0.1 * rng.standard_normal((2, 6))).astype(np.float32),
            "emb": rng.standard_normal((5, 4)).astype(np.float32)}


OPT_CASES = {
    "clip+warmup+cosine": dict(lr=1e-2, warmup_steps=5, total_steps=20,
                               clip_norm=0.5),
    "linear-after-warmup": dict(lr=1e-2, warmup_steps=1, total_steps=4,
                                schedule="linear", clip_norm=100.0),
    "constant+compress": dict(lr=3e-3, warmup_steps=0, schedule="constant",
                              compress_topk=0.3),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_apply_updates_matches_jax(case):
    """Three AdamW updates (clipping, warm-up, cosine / linear / constant
    schedules, top-k compression with error feedback) on a tree holding
    a bf16 leaf, against ``adamw.apply_updates``: f32 leaves within 1e-6,
    the bf16 leaf within one bf16 ulp, moments within 1e-6, the same
    ``grad_norm`` and ``lr``."""
    kw = OPT_CASES[case]
    rng = np.random.default_rng(4)
    p0 = _opt_tree(rng)
    jcfg, tcfg = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "emb" else jnp.float32)
          for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()).to(torch.bfloat16 if k == "emb"
                                            else torch.float32)
          for k, v in p0.items()}
    js, ts = JA.init_state(jp, jcfg), TA.init_state(tp, tcfg)
    for i in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        jg = {k: jnp.asarray(v, jp[k].dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(v.copy()).to(tp[k].dtype)
              for k, v in g.items()}
        jp, js, jm = JA.apply_updates(jp, jg, js, jcfg)
        tp, ts, tm = TA.apply_updates(tp, tg, ts, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        assert ("compressed" in tm) == ("compressed" in jm)
        for k in p0:
            want = np.asarray(jp[k].astype(jnp.float32))
            tol = 2 ** -7 * np.abs(want).max() if k == "emb" else 1e-6
            np.testing.assert_allclose(tp[k].float().numpy(), want,
                                       atol=tol, err_msg=f"{k} step {i}")
            for mom in ("mu", "nu"):
                np.testing.assert_allclose(ts[mom][k].numpy(),
                                           np.asarray(js[mom][k]),
                                           atol=1e-6, rtol=1e-5)
        assert int(ts["step"]) == int(js["step"]) == i + 1


def test_quantile_matches_jnp_quantile():
    x = np.random.default_rng(3).standard_normal(1001).astype(np.float32)
    for q in (0.0, 0.3, 0.7, 0.999, 1.0):
        np.testing.assert_allclose(
            float(TA.quantile(torch.from_numpy(x), q)),
            float(jnp.quantile(jnp.asarray(x), q)), rtol=1e-6)


def test_six_step_history_matches_jax():
    """Six train steps (warm-up, cosine, clipping, KL warm-up) with the JAX
    eps injected: the port's ``build_train_step`` against the JAX
    composition ``value_and_grad(elbo_loss(nll_loss))`` +
    ``apply_updates`` keyed ``fold_in(PRNGKey(seed), step)``: losses within
    1e-5 relative, every final parameter within 1e-4 absolute (Adam
    divides by sqrt(nu), so six steps amplify the f32 differences of the
    gradients in the smallest entries)."""
    jcfg, jparams, tcfg, tparams = _pair("qwen2_1_5b")
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
        return params, opt, loss

    step_fn = S.build_train_step(tcfg, topt, tsvi, seed=0,
                                 noise=jax_train_noise)
    jp, jo = jparams, JA.init_state(jparams, jopt)
    state = {"params": tparams, "opt": TA.init_state(tparams, topt)}
    jh, th = [], []
    for i in range(6):
        jb, tb = _batch(tcfg, B=2, S_len=16, step=i)
        jp, jo, jl = jstep(jp, jo, jb)
        state, m = step_fn(state, tb)
        jh.append(float(jl))
        th.append(float(m["loss"]))
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    jpn = to_numpy_tree(jp)
    for path, t in T.items(state["params"]):
        np.testing.assert_allclose(t.numpy(), _leaf(jpn, path), atol=1e-4,
                                   err_msg=path)


def test_micro_batches_equal_the_full_batch():
    """Two micro-batches of equal token counts give the full batch's loss,
    metrics and every gradient (f32 accumulation, averaged), with one eps
    for every draw so the keys do not matter (the reference's test
    asserts only a loose loss band)."""
    _, _, tcfg, tparams = _pair("qwen2_1_5b")
    eps = torch.randn(tparams["head"]["mu"].shape,
                      generator=torch.Generator().manual_seed(2))
    opt = TA.AdamWConfig(lr=0.0, warmup_steps=0, schedule="constant",
                         weight_decay=0.0)
    svi = TS.SVIConfig(num_train_examples=1000)
    _, tb = _batch(tcfg, B=4, S_len=16)
    seen = []

    def capture(params, grads, state, cfg):
        seen.append([g.clone() for g in T.leaves(grads)])
        return params, state, {"grad_norm": torch.zeros(()), "lr": 0.0}

    out = []
    orig = S.adamw.apply_updates
    S.adamw.apply_updates = capture
    try:
        for mb in (1, 2):
            fn = S.build_train_step(tcfg, opt, svi, micro_batches=mb,
                                    noise=lambda k, s, d: eps)
            _, m = fn({"params": tparams,
                       "opt": TA.init_state(tparams, opt)}, tb)
            out.append(m)
    finally:
        S.adamw.apply_updates = orig
    for name in ("loss", "nll", "kl", "accuracy"):
        np.testing.assert_allclose(float(out[1][name]), float(out[0][name]),
                                   rtol=1e-6, err_msg=name)
    for a, b in zip(seen[0], seen[1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-7,
                                   rtol=1e-5)


def _overfit(opt, steps, num_train, seed):
    _, _, tcfg, tparams = _pair("qwen2_1_5b", seed)
    params = T.map_tree(torch.clone, tparams)
    fn = S.build_train_step(tcfg, opt,
                            TS.SVIConfig(num_train_examples=num_train))
    state = {"params": params, "opt": TA.init_state(params, opt)}
    _, tb = _batch(tcfg, B=4, S_len=32, seed=seed)
    losses = []
    for _ in range(steps):
        state, m = fn(state, tb)
        losses.append(float(m["loss"]))
    return losses


def test_train_step_decreases_loss():
    """``tests/test_fault_tolerance.py``'s bar on the port: 20 steps on
    one batch lower the loss by more than 0.3."""
    losses = _overfit(TA.AdamWConfig(lr=3e-3, warmup_steps=0,
                                     schedule="constant"), 20, 100_000, 0)
    assert losses[-1] < losses[0] - 0.3


def test_compressed_training_still_converges():
    losses = _overfit(TA.AdamWConfig(lr=3e-3, warmup_steps=0,
                                     schedule="constant", compress_topk=0.3),
                      15, int(1e8), 3)
    assert losses[-1] < losses[0]


def test_remat_changes_no_number():
    """``cfg.remat`` (per-layer ``torch.utils.checkpoint``) gives the same
    loss and gradients bit for bit."""
    _, _, tcfg, tparams = _pair("qwen2_1_5b")
    _, tb = _batch(tcfg)
    got = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        leaves = T.leaves(tparams)
        for p in leaves:
            p.requires_grad_(True)
        nll, _ = TM.nll_loss(tparams, cfg, tb, K.root(5))
        got.append([nll] + list(torch.autograd.grad(nll, leaves)))
        for p in leaves:
            p.requires_grad_(False)
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_training_params_serve_without_copying_the_body():
    """``serving_params`` shares every body tensor and the head's mu with
    the training state and computes sigma = softplus(rho); the engine
    serves it."""
    from repro_torch.launch.engine import Request, ServeEngine
    _, _, tcfg, tparams = _pair("qwen2_1_5b")
    served = TM.serving_params(tparams)
    assert served["blocks"]["attn"]["wq"] is tparams["blocks"]["attn"]["wq"]
    assert served["head"]["mu"] is tparams["head"]["mu"]
    assert set(served["head"]) == {"mu", "sigma"}
    assert torch.equal(served["head"]["sigma"],
                       torch.nn.functional.softplus(tparams["head"]["rho"]))
    _, _, _, want = dense_pair()
    assert torch.allclose(served["head"]["sigma"], want["head"]["sigma"],
                          atol=1e-7)
    eng = ServeEngine(served, tcfg, num_slots=2, max_len=24, chunk=4,
                      device="cpu")
    r = eng.run([Request(rid=i, prompt=np.arange(1, 9, dtype=np.int32) + i,
                         max_new_tokens=4) for i in range(2)])
    assert all(len(q.tokens) == 4 for q in r["requests"])


def test_other_families_refuse_training():
    """moe, ssm, hybrid and encdec train in the next slice: their
    training entry points raise, naming the roadmap."""
    from repro_torch.configs.registry import get_config, reduced
    for arch in ("deepseek_moe_16b", "mamba2_370m", "zamba2_7b",
                 "seamless_m4t_medium"):
        cfg = reduced(get_config(arch))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TM.init_train_params(cfg, torch.Generator(), CPU)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TM.nll_loss({}, cfg, {}, K.root(0))


def test_noise_keys_are_pure_functions_of_their_path():
    k = K.fold_in(K.root(3), 7)
    a = K.normal(k, (4, 5), CPU)
    assert torch.equal(a, K.normal(k, (4, 5), CPU))
    assert not torch.equal(a, K.normal(K.fold_in(K.root(3), 8), (4, 5), CPU))
    s0, s1 = K.split(k, 2)
    assert not torch.equal(K.normal(s0, (3,), CPU), K.normal(s1, (3,), CPU))
    want = jax.random.normal(jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(3), 7), 2)[1], (3,))
    np.testing.assert_array_equal(jax_train_noise(s1, (3,), CPU).numpy(),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# the train CLI: crash / resume, stragglers
# ---------------------------------------------------------------------------

def _args(**kw):
    base = dict(arch="qwen2_1_5b", reduced=True, device="cpu", steps=10,
                batch=2, seq=16, lr=1e-3, micro_batches=1,
                compress_topk=0.0, seed=0, ckpt_dir=None, ckpt_every=4,
                resume=False, fail_at_step=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_cli_crash_and_resume_is_bit_exact(tmp_path):
    """Ten steps straight against a crash at step 6 and a resume from the
    step-4 checkpoint: the resumed losses and the final state (parameters,
    moments, step) bit for bit, and no ``.tmp`` left behind."""
    ref = TT.train(_args(ckpt_dir=str(tmp_path / "a")))
    with pytest.raises(RuntimeError, match="injected failure"):
        TT.train(_args(ckpt_dir=str(tmp_path / "b"), fail_at_step=6))
    assert sorted(os.listdir(tmp_path / "b")) == ["step_000000004"]
    out = TT.train(_args(ckpt_dir=str(tmp_path / "b"), resume=True))
    assert out["history"] == ref["history"][4:]
    for (pa, a), (pb, b) in zip(T.items(ref["state"]), T.items(out["state"])):
        assert pa == pb and torch.equal(a, b), pa
    assert not [d for d in os.listdir(tmp_path / "b") if d.endswith(".tmp")]
    again = TT.train(_args(ckpt_dir=str(tmp_path / "b"), resume=True))
    assert again["history"] == []          # nothing left to do


def test_cli_micro_batched_run_and_parser():
    args = TT.build_parser().parse_args(["--device", "cpu", "--steps", "2",
                                         "--batch", "4", "--seq", "8",
                                         "--micro-batches", "2"])
    out = TT.train(args)
    assert len(out["history"]) == 2 and np.isfinite(out["history"]).all()
    assert TT.build_parser().parse_args([]).device == "cuda"


class TestStraggler:
    def test_monitor_flags_slow_step(self):
        m = TT.StragglerMonitor(factor=3.0)
        for _ in range(8):
            assert not m.observe(0.1)
        assert m.observe(1.0)
        assert m.flagged == 1

    def test_monitor_tolerates_jitter(self):
        m = TT.StragglerMonitor(factor=3.0)
        rng = np.random.default_rng(0)
        assert sum(m.observe(0.1 + 0.05 * rng.random())
                   for _ in range(50)) == 0
