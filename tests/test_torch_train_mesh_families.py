"""The moe, ssm, hybrid and encdec families under the train mesh D x M,
on the CPU.

The moe family's grouped dispatch (each data rank one dispatch group, the
JAX package's ``_dispatch_groups``) against JAX with the group count
patched in: one layer's ``moe_ffn(groups=G)`` at G 2 and 4, and the
unsharded port step with ``groups=2`` (the ELBO and every leaf's
gradient).  Then the sharded step of the reduced deepseek-moe-16b (the
experts Megatron over ff), grok-1-314b (the sequence-parallel stream,
one kv head), mamba2-370m (head-parallel Mamba2 blocks), zamba2-7b (and
its shared block) and seamless-m4t-medium on four spawned gloo ranks at
2x2, 1x2, 2x1 and 1x4 against the port's unsharded step (moe with
``groups=D``) on the same draws and batches; two micro-batches for moe at
2x2; seamless at a vocabulary (510) that like its published 256206 is
even and not divisible by 4, so that the head stays whole at 2x2 and 1x4
and the embedding's vocabulary at 1x4; a deepseek checkpoint saved at 2x2
and restored at 1x4; the refusal of ``seq_parallel`` where a family keeps
the stream whole; the CLI.  The ranks' functions live in
``tests/_train_mesh_ranks.py``.
"""

import argparse
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_mesh_ranks as R
from _torch_parity import (assert_every_gradient, jax_train_noise,  # noqa: F401
                           meshless_reference, moe_pair, train_batch,
                           train_pair)
from repro.core import svi as JS
from repro.models import moe as JMOE
from repro.models import registry as JM
from repro_torch.core import keys as K
from repro_torch.core import svi as TS
from repro_torch.core import tree as T
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as S
from repro_torch.models import moe
from repro_torch.models import registry as M
from repro_torch.models import transformer as TR

ROOT = Path(__file__).resolve().parent.parent
MESHES = [(2, 2), (1, 2), (2, 1), (1, 4)]
FAMILIES = ["deepseek_moe_16b", "grok_1_314b", "mamba2_370m", "zamba2_7b",
            "seamless_m4t_medium"]


@pytest.fixture(scope="module")
def ranks():
    with meshlib.Ranks(4, "cpu", timeout_s=180) as r:
        yield r


# ---------------------------------------------------------------------------
# the grouped dispatch against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "grok_1_314b"])
def test_grouped_dispatch_matches_jax(monkeypatch, arch, groups):
    """One layer's ``moe_ffn(groups=G)`` on 4 x 16 tokens against the JAX
    ``moe_ffn`` with ``_dispatch_groups`` returning G: y within 1e-5 of
    its largest entry and the aux loss within 1e-6 relative; the groups'
    capacities drop other assignments than one group's (y moves)."""
    jcfg, jparams, tcfg, tparams = moe_pair(arch)
    monkeypatch.setattr(JMOE, "_dispatch_groups", lambda cfg, n: groups)
    x = np.random.default_rng(groups).standard_normal(
        (4, 16, tcfg.d_model)).astype(np.float32)
    jy, jaux = JMOE.moe_ffn(jax.tree.map(lambda a: a[0], jparams["blocks"]),
                            jcfg, jnp.asarray(x))
    bp = TR.layer(tparams["blocks"], 0)
    ty, taux = moe.moe_ffn(bp, tcfg, torch.from_numpy(x), groups=groups)
    jy = np.asarray(jy)
    scale = float(np.abs(jy).max())
    assert float(np.abs(ty.numpy() - jy).max()) <= 1e-5 * scale
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    one, _ = moe.moe_ffn(bp, tcfg, torch.from_numpy(x))
    assert float((one - ty).abs().max()) > 1e-3 * scale


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "grok_1_314b"])
def test_grouped_step_matches_jax(monkeypatch, arch):
    """The unsharded port ELBO with ``moe.nll_loss(groups=2)`` against the
    JAX ELBO with ``_dispatch_groups`` returning 2 (one row a group), the
    JAX eps injected: the loss within 1e-6 relative, the metrics within
    1e-6, every leaf's gradient within 2e-6 + 1e-4 relative."""
    monkeypatch.setattr(JMOE, "_dispatch_groups", lambda cfg, n: 2)
    jcfg, jparams, tcfg, tparams = train_pair(moe_pair, arch)
    jb, tb = train_batch(tcfg, S_len=16)
    step = 3
    jsvi = JS.SVIConfig(kl_warmup_steps=4, num_train_examples=1000)
    tsvi = TS.SVIConfig(kl_warmup_steps=4, num_train_examples=1000)
    key = jax.random.fold_in(jax.random.PRNGKey(0), step)

    def jloss(p):
        return JS.elbo_loss(lambda pp, b, k: JM.nll_loss(pp, jcfg, b, k), p,
                            jb, key, jnp.asarray(step), jsvi)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    leaves = T.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = TS.elbo_loss(
            lambda p, b, k: moe.nll_loss(p, tcfg, b, k,
                                         noise=jax_train_noise, groups=2),
            tparams, tb, K.fold_in(K.root(0), step), step, tsvi)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    assert set(aux) == set(jaux)
    for name in sorted(aux):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert_every_gradient(tparams, grads, jg)


# ---------------------------------------------------------------------------
# the sharded step against the unsharded one
# ---------------------------------------------------------------------------

def _groups_nll(cfg, groups: int):
    """The unsharded step's loss with the moe family's dispatch in
    ``groups`` groups (the data ranks of the sharded step); other
    families' default."""
    if cfg.family != "moe":
        return None
    return lambda p, b, k: moe.nll_loss(p, cfg, b, k, groups=groups)


@functools.lru_cache(maxsize=None)
def _unsharded(arch, data, micro_batches, changes=()):
    cfg = R.config(arch, **dict(changes))
    state = R.whole_state(cfg)
    fn = S.build_train_step(cfg, R.OPT, R.SVI, micro_batches=micro_batches,
                            seed=0, nll_fn=_groups_nll(cfg, data))
    metrics, grads = R.run_steps(cfg, state, fn, R.batches(cfg, 2),
                                 micro_batches=micro_batches)
    return metrics, grads[0]


# the second step's grad norm, relative: AdamW's first update is about
# lr · g / (|g| + eps) an entry, so the entries whose gradient is ~1e-7 of
# the leaf's largest (the model-partial sums of the router, the Mamba2
# mixer's gathered B / C columns) move up to 0.16 lr apart between the
# sharded and the unsharded step (measured on the reduced zamba2 at 1x4 and
# grok at 1x2), and the second step's grad norm reads 1.2e-5 to 1.4e-5
# apart; its loss, nll and kl stay within 1e-5
STEP2_GRAD_NORM = 1e-4


def _check_against_unsharded(ranks, arch, shape, micro_batches=1,
                             changes=()):
    """Two steps: loss, nll, kl (and moe's aux loss) within 1e-5 relative
    and the accuracy equal, each step; the grad norm within 1e-5 at the
    first step and ``STEP2_GRAD_NORM`` at the second; the first step's
    gradient of every leaf, gathered whole, within 1e-4 of the leaf's
    largest entry."""
    want_m, want_g = _unsharded(arch, shape[0], micro_batches, changes)
    got_m, got_g, _ = ranks.run(R.sharded_steps, arch, shape, micro_batches,
                                changes=dict(changes))[0]
    for i, (a, b) in enumerate(zip(want_m, got_m)):
        assert a.keys() == b.keys()
        for k in ("loss", "nll", "kl", "grad_norm", R.AUX):
            rel = STEP2_GRAD_NORM if (i, k) == (1, "grad_norm") else 1e-5
            if k in a:
                assert b[k] == pytest.approx(a[k], rel=rel), (i, k, a, b)
        assert b["beta"] == a["beta"]
        assert b["accuracy"] == pytest.approx(a["accuracy"], abs=1e-6)
    cfg = R.config(arch, **dict(changes))
    paths = [p for p, _ in T.items(R.whole_state(cfg)["params"])]
    assert len(got_g) == len(want_g) == len(paths)
    for path, a, b in zip(paths, want_g, got_g):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        scale = float(a.abs().max())
        assert scale > 0, path
        assert float((a - b).abs().max()) <= 1e-4 * scale, path


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_step_equals_the_unsharded_step(ranks, arch, shape):
    _check_against_unsharded(ranks, arch, shape)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "grok_1_314b"])
def test_moe_two_micro_batches_at_2x2(ranks, arch):
    """Two micro-batches at 2x2: each data rank's share of a micro-batch is
    one dispatch group, as in the unsharded step with ``groups=2``."""
    _check_against_unsharded(ranks, arch, (2, 2), micro_batches=2)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_seamless_whole_head_at_an_undivided_vocabulary(ranks, shape):
    """seamless reduced at V 510 (even, not divisible by 4, as 256206 is):
    the rules leave the head whole at 2x2 and 1x4 and the embedding's
    vocabulary at 1x4; the step still equals the unsharded one."""
    from repro_torch.sharding import partition as P
    cfg = R.config("seamless_m4t_medium", vocab_size=510)
    dims = P.train_dims(cfg, M.init_train_params(cfg, torch.Generator(),
                                                 "meta"), shape)
    assert dims["head"]["mu"] == (None, None)
    assert ("model" in P.spec_axes(dims["embed"]["table"])) == \
        (shape == (2, 2))
    _check_against_unsharded(ranks, "seamless_m4t_medium", shape,
                             changes=(("vocab_size", 510),))


def test_sliced_kl_equals_the_whole_kl(monkeypatch):
    """A posterior above ``svi.KL_SLICE`` elements (a full-width head: a
    whole one is held on every rank of a mesh that does not divide its
    vocabulary) sums its KL slice by slice, each slice recomputed in the
    backward pass: the value and both gradients as the whole
    ``kl_to_prior``'s (forced here at 1,000 elements a slice on a
    (128, 510) head), within 1e-6 relative."""
    from repro_torch.core.bayesian import GaussianVariational
    g = torch.Generator().manual_seed(0)
    mu = torch.randn((128, 510), generator=g).requires_grad_()
    rho = (torch.randn((128, 510), generator=g) - 4).requires_grad_()
    q = GaussianVariational(mu=mu, rho=rho)
    want = q.kl_to_prior(1.0)
    gw = torch.autograd.grad(want, (mu, rho))
    monkeypatch.setattr(TS, "KL_SLICE", 1000)
    got = TS._kl(q, 1.0)
    gg = torch.autograd.grad(got, (mu, rho))
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-6)
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_7b",
                                  "seamless_m4t_medium"])
def test_seq_parallel_is_refused_without_the_s_sharded_stream(arch):
    """The ssm, hybrid and encdec families keep the stream whole over
    ``model`` (their JAX forwards have no sequence-parallel constraint):
    a config asking for it is refused before a step, by name."""
    cfg = R.config(arch, seq_parallel=True)
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        M.check_trains_sharded(cfg)


# ---------------------------------------------------------------------------
# checkpoints across meshes, the CLI
# ---------------------------------------------------------------------------

def _args(**kw):
    base = dict(arch="deepseek_moe_16b", reduced=True, device="cpu",
                steps=2, batch=4, seq=16, lr=1e-3, micro_batches=1,
                compress_topk=0.0, seed=0, ckpt_dir=None, ckpt_every=2,
                resume=False, fail_at_step=None, mesh="2x2")
    base.update(kw)
    return argparse.Namespace(**base)


def test_deepseek_checkpoint_at_2x2_restores_at_1x4(ranks, tmp_path):
    """Two deepseek steps at 2x2 saved; the save restored at 1x4 gathers
    whole to the 2x2 state's bits, every leaf of parameters, moments and
    step."""
    at22 = ranks.run(R.train_gathered, _args(ckpt_dir=str(tmp_path)))[0]
    at14 = ranks.run(R.train_gathered, _args(ckpt_dir=str(tmp_path),
                                             resume=True, mesh="1x4"))[0]
    assert at22.keys() == at14.keys()
    assert any(k.startswith("params/blocks/experts_ep") for k in at22)
    for k, a in at22.items():
        assert torch.equal(a, at14[k]), k


def test_cli_trains_deepseek_at_2x2(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "deepseek_moe_16b", "--mesh", "2x2", "--device", "cpu", "--steps",
         "2", "--batch", "4", "--seq", "16"],
        env=env, capture_output=True, text=True, timeout=240,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and "final loss" in out.stdout
