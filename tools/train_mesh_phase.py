"""Phases 18 and 19 of ``chip_smoke.py``: training-side sharding on the
card.

    python3 tools/train_mesh_phase.py [--families-only]

runs both alone in a fresh process (it builds the kernels first, for the
serves of (c) and (g)); ``--families-only`` runs phase 19 alone.  The card machine has one card, so the four ranks of
the 2 x 2 train mesh form a gloo group on ``cuda:0``, every collective
staged through host memory (``sharding.collectives``): this shows the
sharded layout, its parity with the unsharded step and the memory a rank
holds, and says nothing of the speed of a sharded step.

  (a) qwen2-1.5B at full width, its own config (``fsdp_params`` False,
      ``seq_parallel`` True; d 1536, H 12, Hkv 2, ff 8960, V 151936,
      bf16 body, f32 head and moments, per-layer remat), cut in depth to
      ``DENSE_LAYERS`` = 4 of its 28 layers for the script's time, at
      ``--mesh 2x2``: data parallel 2 x tensor parallel 2 with the
      sequence-parallel stream, two steps at phase 16's batch 8 x seq 256
      against the unsharded port step on the same batches and keys (run
      here first, while the ranks start, and freed before they take
      their state: four ranks hold about twice the unsharded state).  Each step's loss, nll, kl and grad norm
      within ``TOL_A`` relative (step 2 follows a sharded update) and its
      accuracy within ``TOL_ACC``; every rank's block of step 1's
      gradients of ``GRAD_LEAVES`` (the vocabulary-parallel head and
      embedding, a column- and a row-parallel weight, the norms that the
      sequence-parallel stream leaves partial) against the same block of
      the unsharded step's, within ``TOL_GRAD`` of its norm; each rank's
      parameter, gradient and moment bytes and its peak beside the
      prediction (``PREDICTED``), the bytes it put into each axis'
      collectives a step, the step's wall time (not claimed).
  (b) qwen2-7b reduced (FSDP on) at 2 x 2: two steps against the
      unsharded step, a save at 2 x 2, a restore at 1 x 2 that equals
      the gathered 2 x 2 state bit for bit, and a third step at 1 x 2
      against the unsharded third step (``TOL_B``, f32).
  (c) the parameters of (a), gathered whole into rank 0 after the other
      ranks freed their state, serve 4 requests unsharded on the kernel
      path in rank 0 (``train_phase.serve_trained``): the paged decode /
      prefill and fused head launches are counted there.

Phase 19, on the same four ranks (``FAMILIES``; every case at full width,
its own config's FSDP choice, 2 x 2, bf16 body, f32 head and moments):

  (d) seamless-m4t-medium whole (12 + 12 layers; its 256206-id head whole
      on every rank, D·M = 4 not dividing it; the embedding's vocabulary
      over ``model``), mamba2-370m whole (48 head-parallel Mamba2
      blocks), zamba2-7b cut to 7 of 81 blocks (the shared block applied
      twice, FSDP on) and deepseek-moe-16b cut to 2 of 28 layers (FSDP
      on; all 64 experts on every model rank's half of their ff): one
      sharded step each against the unsharded step at the same depth on
      the card (moe dispatched in D groups, as each data rank is one):
      loss, nll, kl, grad norm (and the aux loss) within ``FAMILY_TOL``
      relative, every rank's metrics equal;
  (e) every rank's block of the step's gradients of the case's
      ``FAMILY_GRAD_LEAVES`` against the same block of the unsharded
      float32 step's from the same weights widened (T): within
      ``DRIFT_RATIO`` times the unsharded bf16 step's own distance from
      T on that block (``DRIFT_RATIO`` says why);
  (f) each rank's parameter, gradient and moment bytes and its peak
      beside ``FAMILY_PREDICTED``, and the bytes it put into each axis'
      collectives (``TrainMesh.traffic``);
  (g) the deepseek state gathered whole into rank 0 serves 4 requests on
      the kernel path (fused head, paged decode, paged prefill), its
      launches counted;
  (h) the four at their reduced configs (f32) the same way: the metrics
      within ``SMALL_TOL``, every leaf's gradient block within
      ``SMALL_TOL_GRAD`` of its largest entry.

Returns the serving kernels' launches of (c) and (g).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as C  # noqa: E402
import train_phase as TP  # noqa: E402

MESH = (2, 2)
ARCH, BATCH, SEQ, STEPS = "qwen2_1_5b", 8, 256, 2
# (a)'s layers (of 28), cut for the script's time: a step on gloo through
# host memory costs in proportion to the depth; the widths stay whole
DENSE_LAYERS = 4
SMALL, SMALL_BATCH, SMALL_SEQ = "qwen2_7b", 8, 32
# against the unsharded step, relative, a step (PERF.md §6, PR 33: set
# from the readings of step 1, 3.9e-5 and 1.2e-4, and step 2, nll 2.1e-4
# and grad norm 1.35e-3, with room on both sides); the bf16 body's
# row-parallel partial sums round once per rank before their f32 sum
TOL_A = ({"loss": 3e-4, "nll": 3e-4, "kl": 1e-5, "grad_norm": 2e-3},
         {"loss": 1e-5, "nll": 1e-3, "kl": 1e-5, "grad_norm": 1e-2})
TOL_ACC = 4 / (BATCH * SEQ)          # four tokens' argmax of 2048
# step 1's gradients, a rank's block against the unsharded step's:
# |got - want| / |want| (predicted before the run, PERF.md §6, PR 33)
GRAD_LEAVES = ("head/mu", "embed/table", "blocks/attn/wq",
               "blocks/attn/wo", "blocks/ln1", "final_norm")
TOL_GRAD = {"head/mu": 1e-2, "embed/table": 5e-2, "blocks/attn/wq": 5e-2,
            "blocks/attn/wo": 5e-2, "blocks/ln1": 5e-2, "final_norm": 5e-2}
TOL_B = 1e-5
# GB a rank holds at 2 x 2 and ``DENSE_LAYERS`` (from the shapes):
# parameters (the body's columns or rows, 46.8 MB a layer, and the
# embedding's vocabulary halved, 0.233 GB; the f32 head's vocabulary
# quartered, 0.467 GB), gradients alike, f32 moments; the peak band (the
# 28-layer step held 2.61 GB above its state, which the depth barely
# moves)
PREDICTED = {"params": 0.887, "grads": 0.887, "moments": 2.616,
             "peak": (5.5, 8.0)}
# bytes a rank puts into each axis' collectives a step (GB): model, the
# stream's gathers and f32 reduce-scatters (forward, remat, backward),
# about 47 MB a layer; data, the head's gather, its reduce-scatter
# (1.167 GB) and the f32 all-reduce of every data-replicated gradient
# (93.6 MB a layer); the 28-layer step put in 1.337 and 3.788 GB
PREDICTED_TRAFFIC = {"model": 0.20, "data": 1.541}
SERVING = TP.SERVING

# phase 19: arch -> (depth it is cut to, or None for the whole model;
# batch; seq), in the order the ranks run them (the largest state, the
# seamless one with its head whole on every rank, first)
FAMILIES = {"seamless_m4t_medium": (None, 4, 128),
            "mamba2_370m": (None, 4, 256),
            "zamba2_7b": (7, 4, 256),
            "deepseek_moe_16b": (2, 4, 256)}
FAMILY_SERVED = "deepseek_moe_16b"
# one sharded step against the unsharded one, relative (predicted before
# the first run, PERF.md §6: the bf16 body's row-parallel partial
# sums round once per rank, as in phase 18; deepseek's router may route
# a few tokens otherwise on those roundings)
FAMILY_TOL = {
    "seamless_m4t_medium": {"loss": 3e-4, "nll": 3e-4, "kl": 1e-5,
                            "grad_norm": 2e-3},
    "mamba2_370m": {"loss": 3e-4, "nll": 3e-4, "kl": 1e-5,
                    "grad_norm": 2e-3},
    "zamba2_7b": {"loss": 3e-4, "nll": 3e-4, "kl": 1e-5, "grad_norm": 2e-3},
    "deepseek_moe_16b": {"loss": 3e-4, "nll": 3e-4, "kl": 1e-5,
                         "grad_norm": 5e-3, "aux_loss": 1e-3}}
FAMILY_GRAD_LEAVES = {
    "seamless_m4t_medium": ("head/mu", "embed/table",
                            "decoder/cross_attn/wk", "encoder/mlp/w2"),
    "mamba2_370m": ("head/mu", "blocks/in_proj", "blocks/gate_ln",
                    "blocks/A_log", "blocks/out_proj"),
    "zamba2_7b": ("head/mu", "blocks/in_proj", "blocks/dt_bias",
                  "shared/attn/wq"),
    "deepseek_moe_16b": ("head/mu", "blocks/router/w",
                         "blocks/experts_ep/w1", "blocks/attn/wo")}
# the full-width cases' gradient blocks in bf16 cannot be held to the
# unsharded bf16 step's: bf16 rounding alone moves a step's gradients
# that far (mamba2's 48 blocks: the unsharded bf16 step 0.22-0.32 of a
# leaf's norm from the float32 one on the same weights, the sharded 0.26-
# 0.35; f32 sharded 1.5e-4; ``tools/train_mesh_drift.py``, PERF.md §6).
# So each block is held to the float32 step instead: the sharded bf16
# step no farther from it than ``DRIFT_RATIO`` times the unsharded bf16
# step (largest ratio read: 1.56, mamba2's dt_bias), which a layout that
# loses precision of its own would exceed
DRIFT_RATIO = 2.0
# The reduced f32 cases hold every leaf: metrics within ``SMALL_TOL``
# relative, every gradient block within ``SMALL_TOL_GRAD`` of its largest
# entry (the CPU tests' tolerances)
FAMILY_SMALL_SHAPE = (4, 40)                # batch x seq
SMALL_TOL, SMALL_TOL_GRAD = 1e-5, 1e-4
# GB a rank holds at 2 x 2 (from the shapes: ``sharding.partition``'s
# blocks of each leaf; the moments f32), and its training peak's band
FAMILY_PREDICTED = {
    "seamless_m4t_medium": {"params": 2.814, "grads": 2.814,
                            "moments": 7.060, "peak": (15.0, 20.0)},
    "mamba2_370m": {"params": 0.471, "grads": 0.471, "moments": 1.680,
                    "peak": (3.0, 5.5)},
    "zamba2_7b": {"params": 0.663, "grads": 0.663, "moments": 2.192,
                  "peak": (4.0, 7.0)},
    "deepseek_moe_16b": {"params": 1.113, "grads": 1.113,
                         "moments": 3.611, "peak": (8.0, 12.0)}}


def _opt(steps: int):
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=steps)


def _svi(batch: int, steps: int):
    from repro_torch.core.svi import SVIConfig
    return SVIConfig(num_train_examples=max(60_000, batch * steps),
                     kl_warmup_steps=max(steps // 4, 1))


def _host_batch(cfg, i: int, batch: int, seq: int) -> dict:
    toks = TP._tokens(cfg, i, batch, seq)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _config(name: str):
    import dataclasses

    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.launch.train import train_config
    if name == ARCH:
        return dataclasses.replace(train_config(ARCH, reduced_cfg=False),
                                   num_layers=DENSE_LAYERS)
    return reduced(get_config(name))


def _params(cfg, dev):
    from repro_torch.models import registry as M
    return M.init_train_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)


NAMES = ("loss", "nll", "kl", "grad_norm", "accuracy")


class _FirstGrads:
    """Wraps ``steps.adamw.apply_updates``: ``fn(grads)`` on the first
    step's gradients as the step hands them to AdamW, and the bytes of
    every step's."""

    def __init__(self, fn=None):
        from repro_torch.launch import steps as S
        self.fn, self.bytes, self._S = fn, [], S

    def __enter__(self):
        self._orig = orig = self._S.adamw.apply_updates

        def measured(p, g, st, c, **kw):
            if not self.bytes and self.fn is not None:
                self.fn(g)
            self.bytes.append(C.tree_bytes(g))
            return orig(p, g, st, c, **kw)

        self._S.adamw.apply_updates = measured
        return self

    def __exit__(self, *exc):
        self._S.adamw.apply_updates = self._orig


def unsharded(name: str, batch: int, seq: int, steps: int,
              keep: str | None = None) -> list:
    """The unsharded port step's metrics on the card, the state freed;
    step 1's gradients of ``GRAD_LEAVES`` saved to ``keep`` (host
    memory, ``torch.save``) where given."""
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw

    def save(g):
        flat = dict(T.items(g))
        torch.save({k: flat[k].detach().cpu() for k in GRAD_LEAVES}, keep)

    dev = torch.device("cuda")
    cfg = _config(name)
    params = _params(cfg, dev)
    state = {"params": params, "opt": adamw.init_state(params,
                                                       _opt(steps))}
    fn = S.build_train_step(cfg, _opt(steps), _svi(batch, steps), seed=0)
    rows = []
    with _FirstGrads(save if keep else None):
        for i in range(steps):
            b = to_device(_host_batch(cfg, i, batch, seq), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fn(state, b)
            torch.cuda.synchronize()
            rows.append({**{k: float(m[k]) for k in NAMES},
                         "ms": (time.perf_counter() - t0) * 1e3})
    del state, params
    TP._free()
    return rows


def _grad_errors(grads, dims, mesh, ref: str,
                 leaves: tuple = GRAD_LEAVES) -> dict:
    """path -> (|got - want| / |want|, max |got - want| / max |want|) of
    this rank's block of each of ``leaves`` against the same block of the
    unsharded step's gradient saved in ``ref``."""
    from repro_torch.core import tree as T
    from repro_torch.sharding import partition as P

    want_all = torch.load(ref, mmap=True)
    got_all, specs = dict(T.items(grads)), dict(T.items(dims))
    out = {}
    for k in leaves:
        want = P.shard_leaf(want_all[k], specs[k], mesh).float()
        d = got_all[k].detach().float().cpu() - want
        out[k] = (float(d.norm() / want.norm()),
                  float(d.abs().max() / want.abs().max()))
    return out


def _sharded_state(cfg, mesh, dev, steps):
    """This rank's blocks of the seed's parameters and their zero moments
    (the whole leaves freed before the moments exist)."""
    from repro_torch.optim import adamw
    from repro_torch.sharding import partition as P

    params = _params(cfg, dev)
    dims = P.train_dims(cfg, params, mesh.shape)
    params = P.shard_tree(params, dims, mesh)
    TP._free()
    return {"params": params, "opt": adamw.init_state(params, _opt(steps))}, \
        dims


def _steps(cfg, state, fn, mesh, dev, batch, seq, first, last):
    """Steps ``first``..``last - 1`` on the rank's rows: metrics a step
    with its wall ms and the bytes put into each axis' collectives."""
    from repro_torch.data.pipeline import shard_batch, to_device

    rows = []
    for i in range(first, last):
        b = to_device(shard_batch(_host_batch(cfg, i, batch, seq), mesh),
                      dev)
        for k in mesh.traffic:
            mesh.traffic[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, b)
        torch.cuda.synchronize()
        rows.append({**{k: float(m[k]) for k in NAMES},
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "traffic": dict(mesh.traffic)})
    return state, rows


def _gathered(tree, dims, mesh) -> dict:
    """path -> whole leaf in rank 0's host memory (the other ranks take
    part and keep nothing), one leaf at a time."""
    from repro_torch.core import tree as T
    from repro_torch.sharding import partition as P

    out = {}
    for (path, t), (_, spec) in zip(T.items(tree), T.items(dims)):
        whole = P.gather_leaf(t, spec, mesh, host=True)
        if mesh.rank == 0:
            out[path] = whole
    return out


def rank_full(tp, smi: str, ref: str) -> dict:
    """(a) and (c) on one rank."""
    import torch.distributed as dist

    from repro_torch.core import tree as T
    from repro_torch.kernels import launches
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps as S

    mesh = meshlib.train_mesh(tp, *MESH)
    dev = tp.device
    cfg = _config(ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, dims = _sharded_state(cfg, mesh, dev, STEPS)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    fn = S.build_train_step(cfg, _opt(STEPS), _svi(BATCH, STEPS), seed=0,
                            mesh=mesh, dims=dims)
    errors = {}
    with _FirstGrads(lambda g: errors.update(
            _grad_errors(g, dims, mesh, ref))) as grads:
        state, rows = _steps(cfg, state, fn, mesh, dev, BATCH, SEQ, 0, STEPS)
    grad_bytes = grads.bytes
    out = {"rank": mesh.rank, "mesh": mesh.describe(), "rows": rows,
           "grad_errors": errors,
           "init_s": init_s, "init_peak": init_peak,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "param_bytes": C.tree_bytes(state["params"]),
           "grad_bytes": grad_bytes[0],
           "moment_bytes": (C.tree_bytes(state["opt"]["mu"])
                            + C.tree_bytes(state["opt"]["nu"])),
           "shards": {p: tuple(t.shape) for p, t in
                      T.items(state["params"])}}
    out.update(peak=out["peak_bytes"] / 1e9,
               params=out["param_bytes"] / 1e9,
               grads=out["grad_bytes"] / 1e9,
               moments=out["moment_bytes"] / 1e9)
    # (c): the parameters whole into rank 0; every other rank frees its
    # state before rank 0 serves
    whole = _gathered(state["params"], dims, mesh)
    del state, fn
    TP._free()
    dist.barrier(group=mesh.world.group)
    if mesh.rank != 0:
        return out
    template = _params_template(cfg)
    params = T.unflatten(template, [whole.pop(p).to(dev)
                                    for p, _ in T.items(template)])
    out["served"] = TP.serve_trained(ARCH, cfg, {"params": params},
                                     launches)
    del params
    TP._free()
    return out


def _params_template(cfg):
    from repro_torch.models import registry as M
    return M.init_train_params(cfg, torch.Generator(), "meta")


def rank_small(tp, ckpt: str) -> dict:
    """(b) on one rank: two steps at 2 x 2, a save, a restore at 1 x 2
    (ranks 0 and 1), the restored state gathered, a third step."""
    from repro_torch.checkpoint import checkpoint as CK
    from repro_torch.core import tree as T
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps as S
    from repro_torch.sharding import partition as P

    steps = 3
    dev = tp.device
    cfg = _config(SMALL)
    svi = _svi(SMALL_BATCH, steps)
    mesh = meshlib.train_mesh(tp, *MESH)
    state, dims = _sharded_state(cfg, mesh, dev, steps)
    sdims = P.state_pspecs(dims, state["opt"])
    fn = S.build_train_step(cfg, _opt(steps), svi, seed=0, mesh=mesh,
                            dims=dims)
    state, rows = _steps(cfg, state, fn, mesh, dev, SMALL_BATCH, SMALL_SEQ,
                         0, 2)
    CK.save(ckpt, 2, state, {"step": 2}, mesh=mesh, dims=sdims)
    saved = _gathered(state, sdims, mesh)
    del state
    half = meshlib.train_mesh(tp, 1, 2)     # every rank creates its groups
    if half is None:
        return {"rows": rows}
    state, dims = _sharded_state(cfg, half, dev, steps)
    sdims = P.state_pspecs(dims, state["opt"])
    state, extra = CK.restore(ckpt, CK.latest_step(ckpt), state, mesh=half,
                              dims=sdims)
    restored = _gathered(state, sdims, half)
    fn = S.build_train_step(cfg, _opt(steps), svi, seed=0, mesh=half,
                            dims=dims)
    state, more = _steps(cfg, state, fn, half, dev, SMALL_BATCH, SMALL_SEQ,
                         extra["step"], steps)
    out = {"rows": rows + more}
    if half.rank == 0:
        out["same"] = saved.keys() == restored.keys() and all(
            torch.equal(saved[k], restored[k]) for k in saved)
        out["leaves"] = len(saved)
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def check_full(ref: list, outs: list, smi: str) -> None:
    """(a)'s assertions and lines."""
    r0 = outs[0]["rows"]
    for o in outs:
        if [r[k] for r in o["rows"] for k in NAMES] != \
                [r[k] for r in r0 for k in NAMES]:
            C.fail(f"train mesh: rank {o['rank']}'s metrics differ from "
                   "rank 0's")
    worst = [{k: _rel(r0[i][k], ref[i][k]) for k in TOL_A[i]}
             for i in range(STEPS)]
    for i in range(STEPS):
        bad = [k for k in TOL_A[i] if not (worst[i][k] <= TOL_A[i][k])]
        acc = abs(r0[i]["accuracy"] - ref[i]["accuracy"])
        if bad or not acc <= TOL_ACC or not (
                np.isfinite(r0[i]["loss"]) and np.isfinite(
                    r0[i]["grad_norm"])):
            C.fail(f"train mesh {ARCH} 2x2 vs unsharded: step {i + 1} "
                   f"relative differences {worst[i]} beyond {TOL_A[i]} "
                   f"({bad}), accuracy {acc} apart (at most {TOL_ACC})")
    grad = {k: max(o["grad_errors"][k] for o in outs) for k in GRAD_LEAVES}
    bad = [k for k in GRAD_LEAVES if not grad[k][0] <= TOL_GRAD[k]]
    if bad:
        C.fail(f"train mesh {ARCH} 2x2: step 1's gradient blocks differ "
               f"from the unsharded step's: {grad} beyond {TOL_GRAD} "
               f"({bad})")
    for i in range(STEPS):
        a, b = ref[i], r0[i]
        print(f"train mesh: {ARCH} full width, {DENSE_LAYERS} of 28 layers, "
              f"step {i + 1}, unsharded / "
              f"2x2: loss {a['loss']:.6f} / {b['loss']:.6f}, nll "
              f"{a['nll']:.6f} / {b['nll']:.6f}, kl {a['kl']:.6g} / "
              f"{b['kl']:.6g}, grad_norm {a['grad_norm']:.6f} / "
              f"{b['grad_norm']:.6f}, accuracy {a['accuracy']:.5f} / "
              f"{b['accuracy']:.5f}; wall {a['ms']:.1f} ms / {b['ms']:.1f} "
              f"ms (host-staged gloo on one shared card, not a sharded "
              f"speed)", flush=True)
    for i in range(STEPS):
        print(f"train mesh: step {i + 1} relative differences {worst[i]} "
              f"(tolerance {TOL_A[i]}), accuracy "
              f"{abs(r0[i]['accuracy'] - ref[i]['accuracy'])} apart (at most "
              f"{TOL_ACC}); every rank's metrics equal", flush=True)
    print("train mesh: step 1's gradient, each rank's block against the "
          "unsharded step's, worst rank (|d| / |want|, max |d| / max "
          "|want|): " + ", ".join(
              f"{k} {grad[k][0]:.3g} / {grad[k][1]:.3g} (at most "
              f"{TOL_GRAD[k]})" for k in GRAD_LEAVES), flush=True)
    for o in outs:
        t = o["rows"][-1]["traffic"]
        print(f"train mesh: rank {o['rank']} ({o['mesh']}): params "
              f"{o['params']:.3f} GB (predicted {PREDICTED['params']}), "
              f"grads {o['grads']:.3f} ({PREDICTED['grads']}), moments "
              f"{o['moments']:.3f} ({PREDICTED['moments']}); peak "
              f"{o['peak']:.3f} GB training (predicted "
              f"{PREDICTED['peak'][0]}-{PREDICTED['peak'][1]}), "
              f"{o['init_peak']:.3f} GB at init (the whole parameters "
              f"drawn before the share is kept), init {o['init_s']:.1f}s; "
              f"collectives a step: model {t['model'] / 1e9:.3f} GB "
              f"(predicted {PREDICTED_TRAFFIC['model']}), data "
              f"{t['data'] / 1e9:.3f} GB ({PREDICTED_TRAFFIC['data']}), "
              f"world {t['world']} B; {smi}", flush=True)
    print(f"train mesh: rank 0's blocks: " + ", ".join(
        f"{p} {s}" for p, s in outs[0]["shards"].items()
        if p.startswith(("head", "embed", "blocks/attn/w",
                         "blocks/mlp/w1"))), flush=True)


def check_small(ref: list, outs: list) -> None:
    """(b)'s assertions and line."""
    rows = outs[0]["rows"]
    for i, (a, b) in enumerate(zip(ref, rows)):
        worst = {k: _rel(b[k], a[k]) for k in ("loss", "nll", "kl",
                                               "grad_norm")}
        if max(worst.values()) > TOL_B:
            C.fail(f"train mesh {SMALL} reduced step {i + 1} "
                   f"({'2x2' if i < 2 else '1x2 after the restore'}) vs "
                   f"unsharded: {worst} beyond {TOL_B}")
    if not outs[0].get("same"):
        C.fail(f"train mesh {SMALL}: the state restored at 1x2 differs from "
               "the 2x2 state gathered")
    print(f"train mesh: {SMALL} reduced (FSDP on, f32): steps 1-2 at 2x2 and "
          f"step 3 at 1x2 after a 2x2 save within {TOL_B} relative of the "
          f"unsharded steps (losses {[round(r['loss'], 6) for r in rows]}); "
          f"the 1x2 restore equals the gathered 2x2 state bit for bit "
          f"({outs[0]['leaves']} leaves: parameters, moments, step)",
          flush=True)


def train_mesh_phase(launches, smi: str, dense: bool = True) -> tuple:
    """Phase 18 (unless not ``dense``) and phase 19 on one set of four
    ranks; returns the serving kernels' launches of (c) and (g), summed,
    and (a)'s readings (each rank's output, or None without ``dense``),
    which phase 20 (``tools/dryrun_phase.py``) holds the dry run to."""
    from repro_torch.launch import mesh as meshlib

    del launches            # (c) and (g) count in rank 0's process
    t0 = time.perf_counter()
    TP._free()
    ckpt = tempfile.mkdtemp(prefix="train_mesh_ckpt_")
    grads = os.path.join(ckpt, "unsharded_grads.pt")
    counts = dict.fromkeys(SERVING, 0)
    outs = None
    # the ranks' allocators map memory in growing segments: four
    # processes share the card, and phase 19's seamless ranks hold their
    # whole 256206-id head each
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    try:
        # the ranks start first: they reach the card and join their
        # groups while this process runs the unsharded references (the
        # ranks hold no state until their first task)
        with meshlib.Ranks(MESH[0] * MESH[1], "cuda", timeout_s=600) as ranks:
            if dense:
                ref = unsharded(ARCH, BATCH, SEQ, STEPS, keep=grads)
                ref_small = unsharded(SMALL, SMALL_BATCH, SMALL_SEQ, 3)
            refs = family_refs(ckpt)
            print(f"train mesh: unsharded references "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            if dense:
                t0 = time.perf_counter()
                outs = ranks.run(rank_full, smi, grads)
                print(f"train mesh: (a) + (c) "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
                check_full(ref, outs, smi)
                t0 = time.perf_counter()
                small = ranks.run(rank_small, os.path.join(ckpt, "ckpt"))
                check_small(ref_small, small)
                print(f"train mesh: (b) {time.perf_counter() - t0:.1f}s",
                      flush=True)
                served = outs[0]["served"]
                for name in SERVING:
                    if served[name] == 0:
                        C.fail(f"train mesh (c): the serve launched no "
                               f"{name}")
                    counts[name] += served[name]
            t0 = time.perf_counter()
            fam = families_phase(ranks, refs, smi)
            for name in SERVING:
                counts[name] += fam[name]
            print(f"phase 19 (train mesh families): "
                  f"{time.perf_counter() - t0:.1f}s, launches of (g) {fam}",
                  flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return counts, outs


# --------------------------------------------------------------------------
# phase 19: the moe, ssm, hybrid and encdec families at 2 x 2
# --------------------------------------------------------------------------

def family_config(arch: str, small: bool = False):
    """``arch`` at full width, cut in depth where ``FAMILIES`` says; or
    its reduced config (f32) with ``small``."""
    import dataclasses

    from repro_torch.configs.registry import get_config, reduced
    cfg = get_config(arch)
    if small:
        return reduced(cfg)
    depth = FAMILIES[arch][0]
    return cfg if depth is None else dataclasses.replace(cfg,
                                                         num_layers=depth)


def _shape(arch: str, small: bool) -> tuple:
    """(batch, seq) of a case."""
    return FAMILY_SMALL_SHAPE if small else FAMILIES[arch][1:]


def _leaves(arch: str, small: bool) -> tuple:
    """The gradient leaves a case compares: every leaf of a reduced one."""
    if not small:
        return FAMILY_GRAD_LEAVES[arch]
    from repro_torch.core import tree as T
    return tuple(p for p, _ in T.items(_params_template(
        family_config(arch, True))))


def family_batch(cfg, i: int, batch: int, seq: int) -> dict:
    """The host batch of step ``i``: the token stream's rows and labels,
    and for encdec N(0, 1) frames (numpy, seeded by the step; zero frames
    would make the encoder's output 0)."""
    out = _host_batch(cfg, i, batch, seq)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import ENC_LEN
        out["frames"] = np.random.default_rng(1000 + i).standard_normal(
            (batch, ENC_LEN, cfg.d_model)).astype(np.float32)
    return out


def family_nll(cfg, data: int):
    """The unsharded step's loss: the moe dispatch in ``data`` groups (the
    sharded step's data ranks, each one group); the others' default."""
    if cfg.family != "moe":
        return None
    from repro_torch.models import moe
    return lambda p, b, k: moe.nll_loss(p, cfg, b, k, groups=data)


FAMILY_NAMES = NAMES + ("aux_loss",)


def _row(m: dict) -> dict:
    return {k: float(m[k]) for k in FAMILY_NAMES if k in m}


def unsharded_family(arch: str, small: bool, keep: str,
                     f32: bool = False) -> dict:
    """The unsharded port step of a case on the card: its metrics and
    wall ms; its gradients of the case's leaves saved to ``keep``; the
    state freed.  ``f32``: the same weights widened to float32, the body
    computed in float32 (the witness of (e))."""
    import dataclasses

    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw

    batch, seq = _shape(arch, small)
    dev = torch.device("cuda")
    cfg = family_config(arch, small)

    def save(g):
        flat = dict(T.items(g))
        torch.save({k: flat[k].detach().cpu()
                    for k in _leaves(arch, small)}, keep)

    params = _params(cfg, dev)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32")
        params = T.map_tree(lambda t: t.float(), params)
    state = {"params": params, "opt": adamw.init_state(params, _opt(1))}
    fn = S.build_train_step(cfg, _opt(1), _svi(batch, 1), seed=0,
                            nll_fn=family_nll(cfg, MESH[0]))
    b = to_device(family_batch(cfg, 0, batch, seq), dev)
    with _FirstGrads(save):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, b)
        torch.cuda.synchronize()
    row = {**_row(m), "ms": (time.perf_counter() - t0) * 1e3}
    del state, params, b
    TP._free()
    return row


def _witness(dims, mesh, ref: str, ref_f32: str, leaves: tuple) -> dict:
    """path -> |U - T| / |T| on this rank's block of each of ``leaves``:
    the unsharded bf16 step's gradient (saved in ``ref``) against the
    float32 one's (``ref_f32``)."""
    from repro_torch.core import tree as T
    from repro_torch.sharding import partition as P

    u, t = torch.load(ref, mmap=True), torch.load(ref_f32, mmap=True)
    specs = dict(T.items(dims))
    out = {}
    for k in leaves:
        want = P.shard_leaf(t[k], specs[k], mesh).float()
        got = P.shard_leaf(u[k], specs[k], mesh).float()
        out[k] = float((got - want).norm() / want.norm())
    return out


def rank_family(tp, arch: str, small: bool, ref: str,
                ref_f32: str | None = None) -> dict:
    """(d)-(f) of one case on one rank (``small``: (h)), and (g) where
    the case is ``FAMILY_SERVED`` at full width.  ``ref_f32``: the
    float32 step's gradients, (e)'s witness."""
    import torch.distributed as dist

    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import shard_batch, to_device
    from repro_torch.kernels import launches
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps as S

    batch, seq = _shape(arch, small)
    mesh = meshlib.train_mesh(tp, *MESH)
    dev = tp.device
    cfg = family_config(arch, small)
    TP._free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, dims = _sharded_state(cfg, mesh, dev, 1)
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fn = S.build_train_step(cfg, _opt(1), _svi(batch, 1), seed=0,
                            mesh=mesh, dims=dims)
    b = to_device(shard_batch(family_batch(cfg, 0, batch, seq), mesh), dev)
    for k in mesh.traffic:
        mesh.traffic[k] = 0
    errors, to_f32 = {}, {}
    leaves = _leaves(arch, small)

    def compare(g):
        errors.update(_grad_errors(g, dims, mesh, ref, leaves))
        if ref_f32 is not None:
            to_f32.update(_grad_errors(g, dims, mesh, ref_f32, leaves))

    with _FirstGrads(compare) as grads:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, b)
        torch.cuda.synchronize()
    out = {"rank": mesh.rank, "mesh": mesh.describe(),
           "row": {**_row(m), "ms": (time.perf_counter() - t0) * 1e3},
           "traffic": dict(mesh.traffic), "grad_errors": errors,
           "to_f32": to_f32, "witness": {} if ref_f32 is None else
           _witness(dims, mesh, ref, ref_f32, leaves),
           "init_s": init_s,
           "peak": torch.cuda.max_memory_allocated() / 1e9,
           "params": C.tree_bytes(state["params"]) / 1e9,
           "grads": grads.bytes[0] / 1e9,
           "moments": (C.tree_bytes(state["opt"]["mu"])
                       + C.tree_bytes(state["opt"]["nu"])) / 1e9}
    if small or arch != FAMILY_SERVED:
        del state, fn, b
        TP._free()
        return out
    whole = _gathered(state["params"], dims, mesh)
    del state, fn, b
    TP._free()
    dist.barrier(group=mesh.world.group)
    if mesh.rank == 0:
        template = _params_template(cfg)
        params = T.unflatten(template, [whole.pop(p).to(dev)
                                        for p, _ in T.items(template)])
        out["served"] = TP.serve_trained(arch, cfg, {"params": params},
                                         launches)
        del params
        TP._free()
    dist.barrier(group=mesh.world.group)
    return out


def check_family(arch: str, small: bool, ref: dict, outs: list,
                 smi: str) -> list:
    """(d)-(f)'s, or (h)'s, lines for one case; returns what failed
    (messages)."""
    from repro_torch.configs.registry import get_config

    cfg = family_config(arch, small)
    r0 = outs[0]["row"]
    tol = dict.fromkeys(FAMILY_TOL[arch], SMALL_TOL) if small \
        else FAMILY_TOL[arch]
    failed = [f"train mesh {arch}: rank {o['rank']}'s metrics differ from "
              "rank 0's" for o in outs if _row(o["row"]) != _row(r0)]
    worst = {k: _rel(r0[k], ref[k]) for k in tol}
    bad = [k for k in tol if not worst[k] <= tol[k]]
    if bad or r0.keys() != ref.keys() or not all(
            np.isfinite(r0[k]) for k in tol):
        failed.append(f"train mesh {arch} 2x2 vs unsharded: relative "
                      f"differences {worst} beyond {tol} ({bad})")
    leaves = _leaves(arch, small)
    grad = {k: max(o["grad_errors"][k] for o in outs) for k in leaves}
    bad = [k for k in leaves if small and not grad[k][1] <= SMALL_TOL_GRAD]
    if bad:
        failed.append(f"train mesh {arch} reduced 2x2: gradient blocks of "
                      f"{bad} beyond {SMALL_TOL_GRAD} of their largest "
                      f"entry: {[grad[k] for k in bad]}")
    if small:
        worst = max(leaves, key=lambda k: grad[k][1])
        print(f"train mesh families: {arch} reduced (f32, {cfg.num_layers} "
              f"layers, d {cfg.d_model}), batch {FAMILY_SMALL_SHAPE[0]} x "
              f"{FAMILY_SMALL_SHAPE[1]}, 2x2 against unsharded: relative "
              + ", ".join(f"{k} {_rel(r0[k], ref[k]):.3g}" for k in tol)
              + f" (at most {SMALL_TOL}); every leaf's gradient block "
              f"within {grad[worst][1]:.3g} of its largest entry (worst "
              f"{worst}; at most {SMALL_TOL_GRAD}), {len(leaves)} leaves",
              flush=True)
        return failed
    full = get_config(arch).num_layers
    depth = f"{cfg.encoder_layers} + {cfg.decoder_layers} layers" \
        if cfg.family == "encdec" else f"{cfg.num_layers} of {full} layers"
    print(f"train mesh families: {arch} ({depth}, full width, FSDP "
          f"{'on' if cfg.fsdp_params else 'off'}), batch "
          f"{FAMILIES[arch][1]} x {FAMILIES[arch][2]}, unsharded / 2x2: "
          + ", ".join(f"{k} {ref[k]:.6g} / {r0[k]:.6g}"
                      for k in FAMILY_NAMES if k in ref)
          + f"; relative {worst} (tolerance {tol}); every rank's metrics "
          f"equal; wall {ref['ms']:.1f} ms / {r0['ms']:.1f} ms "
          "(host-staged gloo on one shared card, not a sharded speed)",
          flush=True)
    # (e): per rank and leaf, |Sb - T| against DRIFT_RATIO x |U - T|
    ratio = {k: max(o["to_f32"][k][0] / max(o["witness"][k], 1e-30)
                    for o in outs) for k in leaves}
    bad = [k for k in leaves if not ratio[k] <= DRIFT_RATIO]
    if bad:
        failed.append(f"train mesh {arch} 2x2: the bf16 gradient blocks of "
                      f"{bad} lie farther from the float32 step's than "
                      f"{DRIFT_RATIO} x the unsharded bf16 step's: ratios "
                      f"{[ratio[k] for k in bad]}")
    print(f"train mesh families: {arch} gradient blocks, worst rank, "
          "against the unsharded bf16 step (|Sb - U| / |U|), the bf16 "
          "steps against the float32 one (|U - T| / |T|, |Sb - T| / |T|) "
          "and their ratio: "
          + ", ".join(f"{k} {grad[k][0]:.3g}, "
                      f"{max(o['witness'][k] for o in outs):.3g}, "
                      f"{max(o['to_f32'][k][0] for o in outs):.3g}, "
                      f"{ratio[k]:.3g}" for k in leaves)
          + f" (ratio at most {DRIFT_RATIO})", flush=True)
    pred = FAMILY_PREDICTED[arch]
    for o in outs:
        t = o["traffic"]
        print(f"train mesh families: {arch} rank {o['rank']}: params "
              f"{o['params']:.3f} GB (predicted {pred['params']}), grads "
              f"{o['grads']:.3f} ({pred['grads']}), moments "
              f"{o['moments']:.3f} ({pred['moments']}); peak "
              f"{o['peak']:.3f} GB (predicted {pred['peak'][0]}-"
              f"{pred['peak'][1]}); init {o['init_s']:.1f}s; collectives a "
              f"step: model {t['model'] / 1e9:.3f} GB, data "
              f"{t['data'] / 1e9:.3f} GB, world {t['world']} B; {smi}",
              flush=True)
    return failed


def family_refs(ckpt: str) -> dict:
    """(arch, small) -> (the unsharded step's row, the path of its saved
    gradients, at full width the path of the float32 step's), every case
    of ``FAMILIES`` at full width and reduced, run before the ranks
    start."""
    refs = {}
    for small in (False, True):
        for arch in FAMILIES:
            keep = os.path.join(ckpt, f"{arch}_{small}_grads.pt")
            f32 = None
            if not small:
                f32 = os.path.join(ckpt, f"{arch}_f32_grads.pt")
                unsharded_family(arch, small, f32, f32=True)
            refs[arch, small] = (unsharded_family(arch, small, keep), keep,
                                 f32)
    return refs


def families_phase(ranks, refs: dict, smi: str) -> dict:
    """Phase 19 on ``ranks`` (four, on the card): every case runs, then
    the phase fails if any did; returns (g)'s launches."""
    served, failed = None, []
    for (arch, small), (ref, keep, f32) in refs.items():
        t0 = time.perf_counter()
        outs = ranks.run(rank_family, arch, small, keep, f32)
        failed += check_family(arch, small, ref, outs, smi)
        print(f"train mesh families: {arch}{' reduced' if small else ''} "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        if arch == FAMILY_SERVED and not small:
            served = outs[0]["served"]
    failed += [f"train mesh families (g): the serve launched no {name}"
               for name in SERVING if served[name] == 0]
    if failed:
        C.fail("; ".join(failed))
    return {k: served[k] for k in SERVING}


def main():
    if not torch.cuda.is_available():
        C.fail("no CUDA device: this script runs on a GPU")
    import repro_torch  # noqa: F401  (pins the precision flags)
    from repro_torch.kernels import build, launches

    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    only = "--families-only" in sys.argv[1:]
    print(f"train mesh launches "
          f"{train_mesh_phase(launches, smi, dense=not only)[0]}", flush=True)
    print(f"phase train mesh: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
