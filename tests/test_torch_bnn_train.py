"""The blood-cell BNN's SVI training in the port.

One train step (the ELBO in surrogate mode, its gradients, the AdamW
update) is held against the JAX package's with the JAX eps injected.
Then the port trains the BNN 300 steps at the quickstart scale, as
``tests/test_paper_experiments.py::_train_bnn`` does, on that run's own
batches and eps (``_bnn_stream.reference_stream``: at this scale the OOD
bar is bimodal in the training stream, for the JAX package as for the
port, so the port replays the reference run rather than a stream of its
own), and must clear the reference's bars in machine mode with the
port's own Gamma draws: ID accuracy above 0.5, OOD AUROC of MI above
0.7, and rejection by MI raising ID accuracy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _bnn_stream import STREAM_FILE, reference_stream
from _torch_parity import (CPU, jax_train_noise,  # noqa: F401
                           meshless_reference, to_numpy_tree)
from repro.core import svi as JS
from repro.models import bnn_cnn as JB
from repro.optim import adamw as JA
from repro_torch.core import svi as TS
from repro_torch.core import tree as T
from repro_torch.core import uncertainty as U
from repro_torch.data import synthetic as TD
from repro_torch.launch import steps as S
from repro_torch.launch import train as TT
from repro_torch.models import bnn_cnn as TB
from repro_torch.optim import adamw as TA

CFG = dict(num_classes=7, in_channels=3, width=16, mc_samples=10)


@pytest.fixture(scope="module")
def trained():
    """The port's BNN after 300 SVI steps on the reference run's stream
    (about 20 s on one CPU thread)."""
    cfg = TB.BNNConfig(**CFG)
    xtr, ytr = TD.blood_cells(np.random.default_rng(0), 3000)
    with np.load(STREAM_FILE) as f:
        stream = (f["indices"], f["eps"])
    params, history = TT.train_bnn(cfg, xtr, ytr, steps=300, device="cpu",
                                   stream=stream)
    return cfg, params, history


def test_stream_file_is_the_reference_runs_stream():
    with np.load(STREAM_FILE) as f:
        indices, eps = f["indices"], f["eps"]
    want_i, want_e = reference_stream()
    np.testing.assert_array_equal(indices, want_i)
    np.testing.assert_array_equal(eps, want_e)


def test_one_train_step_matches_jax():
    """The ELBO, its gradients and one AdamW update from one JAX init on
    64 images with the JAX eps injected.  The ADC after the probabilistic
    conv can put a sum on the other side of a level where the frameworks
    add in another order (one ADC step, as in ``test_torch_bnn.py``), so
    gradients are held within 2e-3 of each leaf's largest entry (a flip
    moves the head's by 4e-4 of it) and the loss within 1e-5."""
    jcfg, tcfg = JB.BNNConfig(**CFG), TB.BNNConfig(**CFG)
    jparams = JB.init_params(jax.random.key(0), jcfg)
    tparams = TB.params_from_numpy(to_numpy_tree(jparams), tcfg, CPU)
    x, y = TD.blood_cells(np.random.default_rng(0), 64)
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=300, weight_decay=1e-4)
    jopt, topt = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    jsvi = JS.SVIConfig(num_train_examples=3000, kl_warmup_steps=100)
    tsvi = TS.SVIConfig(num_train_examples=3000, kl_warmup_steps=100)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    jb = {"images": jnp.asarray(x), "labels": jnp.asarray(y)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: JS.elbo_loss(JB.nll_fn(jcfg), p, jb, key, jnp.asarray(0),
                               jsvi), has_aux=True))(jparams)
    _, _, jm = jax.jit(lambda p, g: JA.apply_updates(
        p, g, JA.init_state(p, jopt), jopt))(jparams, jg)
    seen = []
    orig = S.adamw.apply_updates

    def capture(params, grads, state, cfg):
        seen.append(grads)
        return orig(params, grads, state, cfg)

    S.adamw.apply_updates = capture
    try:
        fn = S.build_train_step(
            tcfg, topt, tsvi, seed=0,
            nll_fn=TB.nll_fn(tcfg, noise=jax_train_noise))
        _, m = fn({"params": tparams, "opt": TA.init_state(tparams, topt)},
                  {"images": torch.from_numpy(x),
                   "labels": torch.from_numpy(y)})
    finally:
        S.adamw.apply_updates = orig
    for name, tol in (("loss", 1e-5), ("nll", 1e-5), ("accuracy", 0.0)):
        np.testing.assert_allclose(float(m[name]),
                                   float(jl if name == "loss"
                                         else jaux[name]), atol=tol)
    np.testing.assert_allclose(float(m["kl"]), float(jaux["kl"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    jgn = to_numpy_tree(jg)
    for path, g in T.items(seen[0]):
        node = jgn
        for part in path.split("/"):
            node = node[part]
        np.testing.assert_allclose(g.numpy(), node,
                                   atol=2e-3 * np.abs(node).max(),
                                   err_msg=path)
    assert float(seen[0]["b3"]["dw"].rho.abs().max()) > 0


def test_own_stream_is_a_function_of_the_seed():
    """Without a given stream, batches and eps come from the seed: the
    same seed trains to the same bits, another seed elsewhere."""
    cfg = TB.BNNConfig(**CFG)
    x, y = TD.blood_cells(np.random.default_rng(4), 200)
    runs = [TT.train_bnn(cfg, x, y, steps=4, batch=16, seed=s,
                         device="cpu")[0] for s in (1, 1, 2)]
    a, b, c = (T.leaves(r) for r in runs)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not all(torch.equal(u, v) for u, v in zip(a, c))


def _moments(params, cfg, x, seed):
    probs = TB.mc_predict(params, cfg, torch.from_numpy(x),
                          torch.Generator().manual_seed(seed),
                          mode="machine")
    return U.predictive_moments(probs)


def test_trained_loss_falls(trained):
    _, _, history = trained
    assert len(history) == 300 and np.isfinite(history).all()
    assert np.mean(history[-20:]) < 0.5 * np.mean(history[:20])


def test_id_accuracy_above_chance(trained):
    cfg, params, _ = trained
    xte, yte = TD.blood_cells(np.random.default_rng(1), 300)
    m = _moments(params, cfg, xte, 5)
    acc = float((m["p_mean"].argmax(-1) == torch.from_numpy(yte).long())
                .float().mean())
    assert acc > 0.5, f"ID accuracy {acc} barely above chance (1/7)"


def test_ood_has_higher_mi_and_auroc(trained):
    cfg, params, _ = trained
    rng = np.random.default_rng(2)
    xid, _ = TD.blood_cells(rng, 250)
    xood, _ = TD.blood_cells_ood(rng, 250)
    mi_id = _moments(params, cfg, xid, 6)["MI"]
    mi_ood = _moments(params, cfg, xood, 6)["MI"]
    a = float(U.auroc(mi_ood, mi_id))
    assert a > 0.7, f"OOD AUROC {a}"


def test_rejection_improves_id_accuracy(trained):
    cfg, params, _ = trained
    xte, yte = TD.blood_cells(np.random.default_rng(3), 400)
    m = _moments(params, cfg, xte, 7)
    y = torch.from_numpy(yte).long()
    t, _ = U.best_rejection_threshold(m["MI"], m["p_mean"], y)
    r = U.rejection_accuracy(m["p_mean"], m["MI"], y, t)
    assert float(r["accuracy_accepted"]) >= float(r["accuracy_all"])
