"""Training-side sharding on the CPU: the train mesh D x M.

The port's train rule table (``sharding.partition.train_dims`` and
``state_pspecs``) against the JAX package's ``sanitize_pspecs(
param_pspecs(params, fsdp), params, mesh)`` and ``steps.state_pspecs``
for every LM arch at full width (the port's tree drawn on the meta
device, the JAX one by ``jax.eval_shape``), at 2x2, 1x2, 2x1 and 1x4,
FSDP on and off; the sharded train step of the reduced qwen2 (FSDP off,
and on) and phi-3-vision on four spawned gloo ranks against the port's
unsharded step (which ``tests/test_torch_train.py`` holds to JAX) on the
same draws and batches, every listed mesh, one and two micro-batches;
checkpoints across meshes; the CLI; the other families at 2x2 (held to
their unsharded steps in ``tests/test_torch_train_mesh_families.py``) and
the mesh a four-rank job picks for them; top-k compression at 2x2.  The
ranks' functions live in ``tests/_train_mesh_ranks.py``.
"""

import argparse
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _train_mesh_ranks as R
from _torch_parity import meshless_reference  # noqa: F401
from repro.configs.registry import get_config as jget
from repro.launch import steps as JS
from repro.models import registry as JM
from repro.sharding.partition import param_pspecs, sanitize_pspecs
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import tree as T
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as S
from repro_torch.launch import train as TT
from repro_torch.models import registry as M
from repro_torch.sharding import partition as P

ROOT = Path(__file__).resolve().parent.parent
MESHES = [(2, 2), (1, 2), (2, 1), (1, 4)]
LM_ARCHS = [a for a in ARCH_IDS]


@pytest.fixture(scope="module")
def ranks():
    with meshlib.Ranks(4, "cpu", timeout_s=180) as r:
        yield r


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------

class _Mesh:
    """What the JAX rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, d, m):
        self.shape = {"data": d, "model": m}
        self.axis_names = ("data", "model")


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(JAX shape tree, port meta-device tree) at full width."""
    jshapes = jax.eval_shape(
        lambda: JM.init_params(jax.random.key(0), jget(arch)))
    params = M.init_train_params(get_config(arch), torch.Generator(), "meta")
    return jshapes, params


def _flat(specs, shapes, path=""):
    """{port path: spec tuple padded to the leaf's ndim} of a JAX spec
    tree; the head's ``q`` GaussianVariational is the port's ``mu`` /
    ``rho``."""
    from repro.core.bayesian import GaussianVariational
    out = {}
    for k, s in specs.items():
        p = f"{path}/{k}" if path else k
        if isinstance(s, GaussianVariational):
            for name in ("mu", "rho"):
                nd = len(getattr(shapes[k], name).shape)
                out[f"{path}/{name}"] = _pad(getattr(s, name), nd)
            continue
        if isinstance(s, dict):
            out.update(_flat(s, shapes[k], p))
            continue
        out[p] = _pad(s, len(shapes[k].shape))
    return out


def _pad(spec, nd):
    return tuple(spec) + (None,) * (nd - len(spec))


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_dims_equal_the_jax_rules(arch, shape, fsdp):
    jshapes, params = _shapes(arch)
    mesh = _Mesh(*shape)
    want = _flat(sanitize_pspecs(param_pspecs(jshapes, fsdp), jshapes,
                                 mesh), jshapes)
    cfg = dataclasses.replace(get_config(arch), fsdp_params=fsdp)
    dims = P.train_dims(cfg, params, shape)
    got = dict(T.items(dims))
    assert got == want
    # the state: moments like their parameters, the step replicated
    jcfg = dataclasses.replace(jget(arch), fsdp_params=fsdp)
    jstate = JS.state_pspecs(jcfg, mesh, {"params": jshapes, "opt": {
        "mu": None, "nu": None, "step": None}})
    assert _flat(jstate["opt"]["nu"], jshapes) == got
    sdims = P.state_pspecs(dims, {"mu": 0, "nu": 0, "step": 0})
    assert sdims["opt"]["mu"] is dims and sdims["opt"]["step"] == ()
    assert tuple(jstate["opt"]["step"]) == sdims["opt"]["step"]


def test_rules_spelled_out_for_qwen2_at_2x2():
    """qwen2-1.5B (FSDP off) and with FSDP on, at 2x2: the column and row
    weights on ``model``, their other axis on ``data`` only with FSDP; the
    head's vocabulary on both axes either way."""
    _, params = _shapes("qwen2_1_5b")
    for fsdp in (False, True):
        cfg = dataclasses.replace(get_config("qwen2_1_5b"),
                                  fsdp_params=fsdp)
        d = dict(T.items(P.train_dims(cfg, params, (2, 2))))
        f = "data" if fsdp else None
        assert d["blocks/attn/wq"] == (None, f, "model")
        assert d["blocks/attn/wo"] == (None, "model", f)
        assert d["blocks/attn/bk"] == (None, "model")
        assert d["blocks/mlp/w2"] == (None, "model", f)
        assert d["embed/table"] == ("model", f)
        assert d["head/mu"] == d["head/rho"] == (None, ("data", "model"))
        assert d["blocks/ln1"] == (None, None)
        assert d["final_norm"] == (None,)


# ---------------------------------------------------------------------------
# shards, batches, the mesh flag
# ---------------------------------------------------------------------------

def test_shard_then_gather_gives_back_every_leaf(ranks):
    """Each rank's blocks of the reduced qwen2-7b training state (FSDP on)
    at 2x2 gathered whole again, bit for bit, and the shards' shapes."""
    assert ranks.run(R.state_roundtrip, "qwen2_7b", (2, 2)) == [[]] * 4


def test_shard_batch_takes_each_micro_batch_rows_in_turn():
    """B 8, D 2, two micro-batches: rank 1 holds global rows 2, 3 (its
    half of micro-batch 0 = rows 0-3) then 6, 7; one micro-batch its
    contiguous half."""
    rows = np.arange(8)[:, None] * np.ones((1, 3), np.int64)
    for d, want2, want1 in ((0, [0, 1, 4, 5], [0, 1, 2, 3]),
                            (1, [2, 3, 6, 7], [4, 5, 6, 7])):
        mesh = argparse.Namespace(data=meshlib.Axis("data", 2, d))
        got = shard_batch({"t": rows}, mesh, 2)["t"]
        assert got[:, 0].tolist() == want2
        assert shard_batch({"t": torch.from_numpy(rows)}, mesh)["t"][:, 0] \
            .tolist() == want1
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"t": rows[:6]}, mesh, 2)


@pytest.mark.parametrize("spec,want", [
    (None, None), ("none", None), ("1x1", None), ("2x2", (2, 2)),
    ("1X4", (1, 4)), ("2x1", (2, 1))])
def test_parse_train_mesh(spec, want):
    assert meshlib.parse_train_mesh(spec) == want


@pytest.mark.parametrize("spec", ["4", "2x0", "axb", "2x2x2"])
def test_parse_train_mesh_refuses(spec):
    with pytest.raises(ValueError):
        meshlib.parse_train_mesh(spec)


def test_default_train_mesh_is_the_jax_launchers(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert meshlib.default_train_mesh("cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert meshlib.default_train_mesh("cpu") == (2, 2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert meshlib.default_train_mesh("cpu") is None


def test_owned_counts_every_block_once():
    """Over the four ranks of a 2x2 mesh each leaf is counted by as many
    ranks as it has distinct blocks."""
    dims = {"rep": (None, None), "col": (None, "model"),
            "fsdp": ("data", "model"), "head": (None, ("data", "model"))}
    counts = dict.fromkeys(dims, 0)
    for r in range(4):
        mesh = argparse.Namespace(axis={
            "data": meshlib.Axis("data", 2, r // 2),
            "model": meshlib.Axis("model", 2, r % 2)}.__getitem__)
        for k, v in P.owned(dims, mesh).items():
            counts[k] += v
    assert counts == {"rep": 1, "col": 2, "fsdp": 4, "head": 4}


def _draws(rank, m):
    """(x, upstream gradient) a rank drew for each collective of
    ``collective_roundtrip`` on a 1 x m mesh, in its order."""
    g = torch.Generator().manual_seed(10 + rank)
    out = []
    for name, width in (("copy", 4), ("reduce", 4), ("gather_sum", 4 * m),
                        ("gather_split", 4 * m), ("reduce_scatter", 4 // m),
                        ("split", 4 // m)):
        x = torch.randn((2, 4, 6), generator=g)
        out.append((name, x, torch.randn((2, width, 6), generator=g)))
    return out


def test_collectives_forward_and_backward(ranks):
    """Each autograd collective on a 1 x 4 mesh, forward and backward,
    against what it should compute from every rank's draws: copy (the
    gradients summed), reduce (the inputs summed), gather (the inputs
    concatenated; the gradient reduce-scattered, or the rank's slice),
    reduce-scatter (the rank's slice of the sum; the gradients gathered)
    and split (the rank's slice; the gradients gathered)."""
    got = ranks.run(R.collective_roundtrip, "cpu")
    draws = [_draws(r, 4) for r in range(4)]
    for r in range(4):
        want = {}
        xs = {n: [d[k][1] for d in draws] for k, (n, _, _) in
              enumerate(draws[r])}
        ups = {n: [d[k][2] for d in draws] for k, (n, _, _) in
               enumerate(draws[r])}

        def part(t):
            return t[:, r:r + 1]

        want["copy"] = (xs["copy"][r], sum(ups["copy"]))
        want["reduce"] = (sum(xs["reduce"]), ups["reduce"][r])
        want["gather_sum"] = (torch.cat(xs["gather_sum"], 1),
                              sum(ups["gather_sum"])[:, 4 * r:4 * r + 4])
        want["gather_split"] = (torch.cat(xs["gather_split"], 1),
                                ups["gather_split"][r][:, 4 * r:4 * r + 4])
        want["reduce_scatter"] = (part(sum(xs["reduce_scatter"])),
                                  torch.cat(ups["reduce_scatter"], 1))
        want["split"] = (part(xs["split"][r]), torch.cat(ups["split"], 1))
        for name, y, gx in got[r]:
            wy, wg = want[name]
            torch.testing.assert_close(y, wy, rtol=1e-6, atol=1e-6,
                                       msg=f"rank {r} {name} forward")
            torch.testing.assert_close(gx, wg, rtol=1e-6, atol=1e-6,
                                       msg=f"rank {r} {name} backward")


def test_collectives_are_the_identity_on_one_rank():
    from repro_torch.sharding import collectives as C
    one = meshlib.Axis("model", 1, 0)
    x = torch.randn(2, 3)
    for y in (C.copy(x, one), C.reduce(x, one), C.gather(x, one, 0),
              C.reduce_scatter(x, one, 1), C.split(x, one, 1),
              C.all_reduce(x, one), C.all_gather(x, one, 0)):
        assert y is x
    with pytest.raises(ValueError, match="grad"):
        C.gather(x, meshlib.Axis("model", 2, 0), 0, grad="mean")


# ---------------------------------------------------------------------------
# the sharded step against the unsharded one
# ---------------------------------------------------------------------------

CASES = [("qwen2_1_5b", None), ("qwen2_1_5b", True),
         ("phi_3_vision_4_2b", None)]


@functools.lru_cache(maxsize=None)
def _unsharded(arch, fsdp, micro_batches):
    cfg = R.config(arch, fsdp)
    state = R.whole_state(cfg)
    fn = S.build_train_step(cfg, R.OPT, R.SVI, micro_batches=micro_batches,
                            seed=0)
    metrics, grads = R.run_steps(cfg, state, fn, R.batches(cfg, 2),
                                 micro_batches=micro_batches)
    return metrics, grads[0], [t.clone() for t in T.leaves(state["params"])]


@pytest.mark.parametrize("micro_batches", [1, 2])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch,fsdp", CASES,
                         ids=["qwen2", "qwen2-fsdp", "vlm"])
def test_sharded_step_equals_the_unsharded_step(ranks, arch, fsdp, shape,
                                                micro_batches):
    """Two steps: loss, nll and kl within 1e-5 relative, the grad norm
    within 1e-5 and the accuracy equal, each step; the first step's
    gradient of every leaf, gathered whole, within 1e-4 of the leaf's
    largest entry (f32 sums split over the ranks)."""
    want_m, want_g, _ = _unsharded(arch, fsdp, micro_batches)
    got_m, got_g, _ = ranks.run(R.sharded_steps, arch, shape, micro_batches,
                                fsdp)[0]
    for i, (a, b) in enumerate(zip(want_m, got_m)):
        for k in ("loss", "nll", "kl", "grad_norm"):
            assert b[k] == pytest.approx(a[k], rel=1e-5), (i, k, a, b)
        assert b["beta"] == a["beta"]
        assert b["accuracy"] == pytest.approx(a["accuracy"], abs=1e-6)
    cfg = R.config(arch, fsdp)
    paths = [p for p, _ in T.items(R.whole_state(cfg)["params"])]
    assert len(got_g) == len(want_g) == len(paths)
    for path, a, b in zip(paths, want_g, got_g):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        scale = float(a.abs().max())
        assert scale > 0, path
        assert float((a - b).abs().max()) <= 1e-4 * scale, path


def test_sharded_forward_runs_the_mesh_collectives(ranks):
    """At 2x2 with the sequence-parallel stream (reduced qwen2) the
    residual a rank holds between blocks has S / 2 rows, and at 1x4 the
    model ranks' vocabulary-parallel logits each cover V / 4 columns
    (recorded inside the ranks)."""
    seen = ranks.run(R.stream_shapes, "qwen2_1_5b", (2, 2))[0]
    assert seen["hidden"] == [2, R.SEQ // 2, 128] and seen["sp"]
    seen = ranks.run(R.stream_shapes, "qwen2_1_5b", (1, 4))[0]
    assert seen["hidden"] == [4, R.SEQ // 4, 128] and seen["sp"]
    seen = ranks.run(R.stream_shapes, "phi_3_vision_4_2b", (2, 2))[0]
    assert seen["hidden"] == [2, R.SEQ, 128] and not seen["sp"]


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------

def _args(**kw):
    base = dict(arch="qwen2_1_5b", reduced=True, device="cpu", steps=6,
                batch=4, seq=16, lr=1e-3, micro_batches=1,
                compress_topk=0.0, seed=0, ckpt_dir=None, ckpt_every=2,
                resume=False, fail_at_step=None, mesh="2x2")
    base.update(kw)
    return argparse.Namespace(**base)


def test_resume_at_2x2_is_bit_exact(ranks, tmp_path):
    """Six steps straight against a crash at step 4 resumed from the
    step-4 checkpoint, all at 2x2: the resumed losses and every rank's
    final state bit for bit; then that state restored at 1x1 (whole
    leaves, one process) equals the 2x2 state gathered whole, bit for
    bit, and a 2x2 save restored at 1x2 gathers to the same bits."""
    ref = ranks.run(R.train_rank_state, _args(ckpt_dir=str(tmp_path / "a")))
    crashed = ranks.run(R.train_rank_state,
                        _args(ckpt_dir=str(tmp_path / "b"), fail_at_step=4))
    assert all("injected failure" in c["failed"] for c in crashed)
    assert "step_000000004" in os.listdir(tmp_path / "b")
    out = ranks.run(R.train_rank_state,
                    _args(ckpt_dir=str(tmp_path / "b"), resume=True))
    assert out[0]["history"] == ref[0]["history"][4:]
    for r in range(4):
        assert out[r]["state"].keys() == ref[r]["state"].keys()
        for k, a in ref[r]["state"].items():
            assert torch.equal(a, out[r]["state"][k]), (r, k)
    assert not [d for d in os.listdir(tmp_path / "b") if d.endswith(".tmp")]
    # the 2x2 save of the final step restored unsharded
    from repro_torch.checkpoint.checkpoint import latest_step, restore
    cfg = R.config("qwen2_1_5b")
    whole = TT.train(_args(ckpt_dir=None, mesh=None, steps=0))["state"]
    step = latest_step(str(tmp_path / "b"))
    assert step == 6
    whole, extra = restore(str(tmp_path / "b"), step, whole)
    assert extra["step"] == 6
    gathered = ranks.run(R.train_gathered, _args(ckpt_dir=str(tmp_path / "b"),
                                                 resume=True))[0]
    flat = dict(T.items(whole))
    assert gathered.keys() == flat.keys()
    for k, a in gathered.items():
        assert torch.equal(a, flat[k]), k
    # and restored at 1x2: gathered again, the same bits
    at12 = ranks.run(R.train_gathered, _args(ckpt_dir=str(tmp_path / "b"),
                                             resume=True, mesh="1x2"))[0]
    for k, a in at12.items():
        assert torch.equal(a, flat[k]), k
    del cfg


# ---------------------------------------------------------------------------
# the CLI and the refusals
# ---------------------------------------------------------------------------

def test_cli_trains_at_2x2_on_four_cpu_ranks(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mesh", "2x2",
         "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16"],
        env=env, capture_output=True, text=True, timeout=240,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 3 and "final loss" in out.stdout


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mamba2_370m",
                                  "zamba2_7b", "seamless_m4t_medium"])
def test_other_families_refuse_the_train_mesh(ranks, arch):
    """The moe, ssm, hybrid and encdec families train at 2x2 (no longer
    refused): two steps of ``launch.train.train`` on every rank, finite
    losses equal on every rank.  (The name is the case's from when the
    families were refused, kept so that each case's record carries
    over.)"""
    out = ranks.run(R.train_rank_state, _args(arch=arch, steps=2))
    hist = out[0]["history"]
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert all(o["history"] == hist for o in out)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mamba2_370m",
                                  "zamba2_7b", "seamless_m4t_medium"])
def test_the_default_mesh_refusal_names_mesh_none(monkeypatch, arch):
    """A job of four ranks without --mesh trains that family at 2x2 (the
    JAX launcher's default; ``--mesh none`` still trains it unsharded):
    ``run`` spawns four ranks of ``train_rank`` (recorded here, not
    started).  (The name is the case's from when the families were
    refused, kept so that each case's record carries over.)"""
    monkeypatch.setenv("WORLD_SIZE", "4")
    seen = []

    def spawned(n, device, fn, args):
        seen.append((n, device, fn, TT.mesh_shape(args)))
        return [{"final_loss": 0.0, "history": [], "straggler_flags": 0}]

    monkeypatch.setattr(TT.meshlib, "spawn", spawned)
    TT.run(_args(arch=arch, mesh=None))
    assert seen == [(4, "cpu", TT.train_rank, (2, 2))]


def test_mesh_none_trains_unsharded_in_a_four_rank_job(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    out = TT.run(_args(arch="mamba2_370m", mesh="none", steps=1))
    assert len(out["history"]) == 1 and np.isfinite(out["final_loss"])


def test_compression_refuses_the_train_mesh(ranks):
    """Top-k compression (10%) under the train mesh: two compressed steps
    at 2x2 against two unsharded compressed steps of the reduced qwen2,
    each leaf's threshold the quantile of the whole leaf's |g + e|: the
    metrics within 1e-5 relative (the grad norm, of the sent entries,
    1e-4 at the second step, as ``test_torch_train_mesh_families``
    says), the parameters after both steps, gathered whole, within 1e-4
    of each leaf's largest entry.  (The name is the test's from when
    compression refused a mesh, kept so that its record carries
    over.)"""
    opt = dataclasses.replace(R.OPT, compress_topk=0.1)
    cfg = R.config("qwen2_1_5b")
    state = R.whole_state(cfg, opt=opt)
    fn = S.build_train_step(cfg, opt, R.SVI, seed=0)
    want_m, _ = R.run_steps(cfg, state, fn, R.batches(cfg, 2))
    got_m, _, final = ranks.run(R.sharded_steps, "qwen2_1_5b", (2, 2),
                                opt=opt)[0]
    for i, (a, b) in enumerate(zip(want_m, got_m)):
        for k in ("loss", "nll", "kl", "grad_norm"):
            rel = 1e-4 if (i, k) == (1, "grad_norm") else 1e-5
            assert b[k] == pytest.approx(a[k], rel=rel), (i, k, a, b)
    for (path, a), b in zip(T.items(state["params"]), final):
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale, path


def test_train_mesh_ranks_load_no_jax(ranks):
    import _mesh_ranks
    assert ranks.run(_mesh_ranks.loaded) == [[]] * 4
