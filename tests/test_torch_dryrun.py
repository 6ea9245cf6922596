"""The dry run (``repro_torch.launch.dryrun``) and its cost accounting
(``launch.op_cost``) on the CPU.

1. Every arch's per-rank block shapes at full width on 16 x 16 and on
   2 x 16 x 16 against the JAX rules (``sanitize_pspecs(param_pspecs(
   shapes, fsdp, pod_fsdp), shapes, mesh)`` and ``steps.state_pspecs``,
   the moments too), ``pod_fsdp`` on at 2 x 16 x 16, which the dry run
   reads as a 32 x 16 mesh.
2. Its pure functions against the JAX dry run's: ``pick_micro_batches``,
   ``cell_applicable``, the parameter counts, ``tokens``, and the link
   model (``op_cost.tally`` against ``parse_collectives`` on HLO lines
   built from the same triples).
3. A dry run on a fake group of 4 against a real step on four spawned
   gloo ranks (reduced qwen2 and deepseek-moe at 2 x 2): parameter,
   gradient and moment bytes and the bytes a rank puts into each axis'
   collectives equal; FLOPs equal ``FlopCounterMode`` around the real
   step; the peak against the real step's ``MemTracker`` peak.
4. FLOPs against ``repro.launch.hlo_cost.analyze`` of the JAX train step
   compiled on the one CPU device.
5. The JAX integration test's cells, mirrored through the CLI.
6. No process group and no fake train mesh outlive a dry run, a failed
   one included.
"""

import argparse
import dataclasses
import datetime
import functools
import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

import _dryrun_ranks as DR
import _train_mesh_ranks as R
from _torch_parity import dense_pair, to_numpy_tree, train_batch
from repro.configs import base as JB
from repro.configs.registry import get_config as jget
from repro.launch import hlo_cost
from repro.launch import steps as JS
from repro.models import registry as JM
from repro.optim import adamw as JA
from repro.sharding.partition import param_pspecs, sanitize_pspecs
from repro_torch.configs.base import SHAPE_CELLS, cell_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.svi import SVIConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import op_cost
from repro_torch.launch import steps as S
from repro_torch.models import registry as M
from repro_torch.optim import adamw


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun`` (its import pins 512 host devices in
    ``XLA_FLAGS``, which this process's JAX has read already; the
    variable is put back for the processes later tests start)."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


# ---------------------------------------------------------------------------
# 1. block shapes against the JAX rules
# ---------------------------------------------------------------------------

class _Mesh:
    """What the JAX rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, **sizes):
        self.shape = sizes
        self.axis_names = tuple(sizes)


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(JAX shape tree, port meta-device tree) at full width."""
    jshapes = jax.eval_shape(
        lambda: JM.init_params(jax.random.key(0), jget(arch)))
    return jshapes, M.init_train_params(get_config(arch), torch.Generator(),
                                        "meta")


def _jax_blocks(specs, shapes, sizes, path=""):
    """{port path: block shape} of a JAX spec tree (the head's ``q`` is
    the port's ``mu`` / ``rho``)."""
    from repro.core.bayesian import GaussianVariational
    out = {}
    for k, s in specs.items():
        if isinstance(s, GaussianVariational):
            for name in ("mu", "rho"):
                out[f"{path}/{name}"] = _block(getattr(s, name),
                                               getattr(shapes[k], name).shape,
                                               sizes)
            continue
        p = f"{path}/{k}" if path else k
        if isinstance(s, dict):
            out.update(_jax_blocks(s, shapes[k], sizes, p))
        else:
            out[p] = _block(s, shapes[k].shape, sizes)
    return out


def _block(spec, shape, sizes):
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, e in zip(shape, spec):
        names = () if e is None else (e,) if isinstance(e, str) else e
        out.append(n // int(np.prod([sizes[a] for a in names])))
    return tuple(out)


@pytest.mark.parametrize("tag", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_block_shapes_equal_the_jax_rules(arch, tag):
    """Every parameter's and moment's block on a rank of the production
    mesh: the dry run's cut (16 x 16, or 32 x 16 for 2 x 16 x 16) against
    the JAX rules' (``pod_fsdp`` on where FSDP is, at 2 x 16 x 16)."""
    jshapes, params = _shapes(arch)
    jcfg = jget(arch)
    sizes = {"data": 16, "model": 16} if tag == "single" else D.POD
    mesh = _Mesh(**sizes)
    fsdp = jcfg.fsdp_params
    want = _jax_blocks(sanitize_pspecs(
        param_pspecs(jshapes, fsdp, fsdp and tag == "multi"), jshapes, mesh),
        jshapes, sizes)
    got = D.rank_blocks(get_config(arch), params, tag)
    if tag == "multi":
        assert D.pod_reading(get_config(arch), params) == []
    assert got == want
    jstate = JS.state_pspecs(jcfg, mesh, {"params": jshapes, "opt": {
        "mu": None, "nu": None, "step": None}})
    for moment in ("mu", "nu"):
        assert _jax_blocks(jstate["opt"][moment], jshapes, sizes) == got


def test_pod_reading_names_a_leaf_whose_block_differs():
    """A head spec that ignores FSDP (as fsdp_params=False leaves the
    head's ("data", "model") unspread over the pod) on a vocabulary that
    512 divides: its 2 x 16 x 16 block is twice the 32 x 16 one."""
    cfg = dataclasses.replace(get_config("qwen2_1_5b"), vocab_size=512 * 64)
    params = M.init_train_params(cfg, torch.Generator(), "meta")
    assert D.pod_reading(cfg, params) == ["head/mu", "head/rho"]


# ---------------------------------------------------------------------------
# 2. pure functions
# ---------------------------------------------------------------------------

def test_pure_functions_equal_the_jax_dry_runs(jdry):
    """``pick_micro_batches`` for every (arch, train cell, data ranks of
    either mesh), ``cell_applicable``'s verdicts, the parameter counts
    and every cell's ``tokens``."""
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget(arch)
        assert (cfg.param_count, cfg.active_param_count) == \
            (jcfg.param_count, jcfg.active_param_count)
        for name, cell in SHAPE_CELLS.items():
            jcell = JB.SHAPE_CELLS[name]
            assert cell_applicable(cfg, cell) == \
                JB.cell_applicable(jcfg, jcell)
            assert D.cell_tokens(cell) == jcell.global_batch * (
                jcell.seq_len if jcell.kind != "decode" else 1)
            for dp in (16, 32):
                assert D.pick_micro_batches(cfg, cell, dp) == \
                    jdry.pick_micro_batches(jcfg, jcell, dp)


def test_link_model_equals_parse_collectives(jdry):
    """Collectives given as (kind, operand bytes, result bytes): the
    port's tally against the JAX ``parse_collectives`` of HLO lines of
    those shapes (f32 operands and results)."""
    rng = np.random.default_rng(0)
    triples, lines = [], []
    for i in range(40):
        kind = op_cost.KINDS[i % len(op_cost.KINDS)]
        n = int(rng.integers(1, 4096))
        r = n * int(rng.integers(2, 17)) if kind == "all-gather" else \
            n // int(rng.integers(2, 5)) + 1 if kind == "reduce-scatter" \
            else n
        lines.append(f"  %a{i} = f32[{n}]{{0}} parameter({i})")
        lines.append(f"  %c{i} = f32[{r}]{{0}} {kind}(%a{i}), "
                     "replica_groups={}")
        triples.append((kind, 4 * n, 4 * r))
    want = jdry.parse_collectives("\n".join(lines))
    got = op_cost.tally(triples)
    for kind in op_cost.KINDS:
        assert got[kind] == want[kind], kind
    assert got["total_link_bytes"] == want["total_link_bytes"]


# ---------------------------------------------------------------------------
# 3. against a real step on four ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    with meshlib.Ranks(4, "cpu", timeout_s=180) as r:
        yield r


# the peak's band: both sides are MemTracker's count of the same aten
# ops' outputs, on real CPU tensors and on meta ones (the CPU allocator
# keeps no peak to hold it to; the card's allocator is chip_smoke.py
# phase 20's); a meta op that allocates another temporary than the CPU
# kernel moves it by that temporary, a few KB at these widths
PEAK_BAND = 0.02


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2_1_5b", "deepseek_moe_16b"])
def test_dry_run_equals_a_real_step(ranks, arch, micro):
    real = ranks.run(DR.real_step, arch, micro)
    cfg = R.config(arch)
    for rank in (0, 3):
        dry = D.reckon_train(cfg, DR.SHAPE, R.BATCH, R.SEQ, micro,
                             rank=rank, opt_cfg=R.OPT, svi=R.SVI)
        mem, want = dry["memory"], real[rank]
        assert (mem["param_bytes"], mem["grad_bytes"],
                mem["moment_bytes"]) == (want["param_bytes"],
                                         want["grad_bytes"],
                                         want["moment_bytes"])
        assert dry["traffic"] == want["traffic"]
        assert dry["cost"]["flops"] == want["flops"]
        assert abs(mem["peak_bytes"] - want["peak"]) <= \
            PEAK_BAND * want["peak"]
        assert mem["peak_bytes"] > mem["param_bytes"] + mem["moment_bytes"]
        # the link model's all-reduces carry the axes' f32 traffic twice
        coll = dry["cost"]["collectives"]
        assert coll["all-reduce"]["count"] > 0
        assert coll["total_link_bytes"] > 0


# ---------------------------------------------------------------------------
# 4. FLOPs against the JAX step's compiled HLO
# ---------------------------------------------------------------------------

def test_flops_equal_hlo_cost_of_the_jax_step():
    """The reduced qwen2 train step (remat on, B 4, S 128) compiled by
    JAX on its one CPU device, ``hlo_cost.analyze``'s FLOPs, against
    ``FlopCounterMode`` on the port's step on the same config and batch:
    both count 2·M·N·K for every product (the dots of the HLO, aten's
    mm / bmm), the rematted forward included, so they are equal."""
    jcfg, jp, tcfg, _ = dense_pair("qwen2_1_5b")
    jcfg = dataclasses.replace(jcfg, remat=True)
    tcfg = dataclasses.replace(tcfg, remat=True)
    tp = M.train_params_from_numpy(to_numpy_tree(jp), tcfg, "cpu")
    jb, tb = train_batch(tcfg, B=4, S_len=128)
    jfn = JS.build_train_step(jcfg, JA.AdamWConfig(),
                              JS.SVIConfig(num_train_examples=1000))
    hlo = jax.jit(jfn).lower({"params": jp, "opt": JA.init_state(
        jp, JA.AdamWConfig())}, jb).compile().as_text()
    want = hlo_cost.analyze(hlo)["flops"]
    fn = S.build_train_step(tcfg, adamw.AdamWConfig(),
                            SVIConfig(num_train_examples=1000))
    with FlopCounterMode(display=False) as flops:
        fn({"params": tp, "opt": adamw.init_state(tp, adamw.AdamWConfig())},
           tb)
    assert want > 0
    assert flops.get_total_flops() == want


# ---------------------------------------------------------------------------
# 5. the JAX integration test's cells
# ---------------------------------------------------------------------------

def test_cheapest_cell_on_both_meshes(tmp_path, capsys):
    """mamba2-370m x long_500k: green on 16 x 16 and 2 x 16 x 16.  The
    JAX record's peak stays under 1 GB because its cell places the
    weights by the FSDP train rules; the port's serving engine keeps the
    ssm mixers and the fused head whole on every model rank (1.15 GB of
    weights), so the bound here is the JAX test's point: the peak beyond
    the weights stays under 1 GB and does not grow with the depth (a
    decode at 4096 tokens peaks the same)."""
    D.main(["--arch", "mamba2_370m", "--shape", "long_500k", "--mesh",
            "both", "--out", str(tmp_path)])
    assert "all dry-run cells green" in capsys.readouterr().out
    cfg = get_config("mamba2_370m")
    short = D.reckon_serve(cfg, "decode", 1, 4096)["memory"]["peak_bytes"]
    for tag, n in (("single", 256), ("multi", 512)):
        rec = json.load(open(tmp_path /
                             f"mamba2_370m__long_500k__{tag}.json"))
        mem = rec["memory"]
        assert rec["num_devices"] == n
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
        assert 0 < mem["peak_bytes"] - mem["param_bytes"] < 1e9
        assert mem["peak_bytes"] == short
        assert "batch_note" in rec       # B = 1 on every data line


def test_skip_rule(tmp_path, capsys):
    D.main(["--arch", "qwen2_7b", "--shape", "long_500k", "--mesh",
            "single", "--out", str(tmp_path)])
    assert "SKIP" in capsys.readouterr().out
    rec = json.load(open(tmp_path / "qwen2_7b__long_500k__single.json"))
    assert "skipped" in rec


# ---------------------------------------------------------------------------
# 6. nothing left behind
# ---------------------------------------------------------------------------

def test_no_group_or_train_mesh_outlives_a_dry_run():
    """After a dry run and after one that fails inside its step (a batch
    that does not split over the micro-batches), no group is initialised
    and the train-mesh cache holds what it held before; inside a group
    the dry run refuses to start."""
    before = set(meshlib._TRAIN_MESHES)
    cfg = R.config("qwen2_1_5b")
    D.reckon_train(cfg, (2, 2), 4, 16, 1)
    assert not dist.is_initialized()
    assert set(meshlib._TRAIN_MESHES) == before
    with pytest.raises(ValueError, match="does not split"):
        D.reckon_train(cfg, (2, 2), 6, 16, 2)
    assert not dist.is_initialized()
    assert set(meshlib._TRAIN_MESHES) == before
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(d, "rdv"), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=30))
        try:
            with pytest.raises(RuntimeError, match="outside any group"):
                D.reckon_train(cfg, (2, 2), 4, 16, 1)
        finally:
            dist.destroy_process_group()


def test_cost_scope_counts_attention_as_a_kernel():
    """``OpCost(skip_byte_scopes=)`` on one reduced qwen2 train step: the
    scoped bytes are fewer than the op-by-op bytes (the plain attention's
    tiles and their backward drop out, its operands and results stay);
    the FLOPs and collectives are the same either way, and the patched
    function is restored."""
    from repro_torch.models import layers
    cfg = R.config("qwen2_1_5b")
    orig = layers.flash_attention
    out = D.reckon_train(cfg, (1, 2), 4, 64, 1)
    assert layers.flash_attention is orig
    full, fused = out["cost"], out["cost_fused_attn"]
    assert 0 < fused["bytes"] < full["bytes"]
    assert fused["flops"] == full["flops"] > 0
    assert fused["collectives"] == full["collectives"]


def test_profile_cell_prints_the_top_contributors(capsys):
    """``profile_cell`` on a cheap cell with the kernels counted as
    kernels: the summary line and the largest byte movers attributed to
    the model's functions (the head's kernel among them)."""
    from repro_torch.launch import profile_cell
    out = profile_cell.profile("mamba2_370m", "decode_32k", fused_attn=True,
                               top=8)
    text = capsys.readouterr().out
    assert "flops/dev" in text and "top bytes" in text
    assert out["summary"]["flops"] > 0
    rows = [line for line in text.splitlines() if line.startswith("  ")]
    assert any("models." in line for line in rows)
    assert any("uncertainty_head_sampled" in line for line in rows)


def test_cli_help_says_no_card_is_needed():
    text = " ".join(D.build_parser().format_help().split())
    assert "allocates nothing" in text and "needs no card" in text
    assert isinstance(D.build_parser().parse_args([]), argparse.Namespace)
