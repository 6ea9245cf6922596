"""Phase 18 of ``chip_smoke.py``: training-side sharding on the card.

    python3 tools/train_mesh_phase.py

runs the phase alone in a fresh process (it builds the kernels first, for
the serve of (c)).  The card machine has one card, so the four ranks of
the 2 x 2 train mesh form a gloo group on ``cuda:0``, every collective
staged through host memory (``sharding.collectives``): this shows the
sharded layout, its parity with the unsharded step and the memory a rank
holds, and says nothing of the speed of a sharded step.

  (a) qwen2-1.5B at full width, its own config (``fsdp_params`` False,
      ``seq_parallel`` True; 28 layers, d 1536, H 12, Hkv 2, ff 8960,
      V 151936, bf16 body, f32 head and moments, per-layer remat) at
      ``--mesh 2x2``: data parallel 2 x tensor parallel 2 with the
      sequence-parallel stream, two steps at phase 16's batch 8 x seq 256
      against the unsharded port step on the same batches and keys (run
      here first, and freed before the ranks start: four ranks hold about
      twice the unsharded state).  Each step's loss, nll, kl and grad norm
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

Returns the serving kernels' launches of (c).
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
# GB a rank holds at 2 x 2 (from the shapes): parameters (the body's
# columns or rows and the embedding's vocabulary halved, the f32 head's
# vocabulary quartered), gradients alike, f32 moments; the peak band
PREDICTED = {"params": 2.011, "grads": 2.011, "moments": 7.109,
             "peak": (13.0, 15.0)}
# bytes a rank puts into each axis' collectives a step (GB): model, the
# stream's gathers and f32 reduce-scatters (forward, remat, backward);
# data, the head's gather, its reduce-scatter and the f32 all-reduce of
# every data-replicated gradient
PREDICTED_TRAFFIC = {"model": 1.337, "data": 3.788}
SERVING = TP.SERVING


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
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.launch.train import train_config
    if name == ARCH:
        return train_config(ARCH, reduced_cfg=False)
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


def _grad_errors(grads, dims, mesh, ref: str) -> dict:
    """path -> (|got - want| / |want|, max |got - want| / max |want|) of
    this rank's block of each of ``GRAD_LEAVES`` against the same block
    of the unsharded step's gradient saved in ``ref``."""
    from repro_torch.core import tree as T
    from repro_torch.sharding import partition as P

    want_all = torch.load(ref, mmap=True)
    got_all, specs = dict(T.items(grads)), dict(T.items(dims))
    out = {}
    for k in GRAD_LEAVES:
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
           "peak": torch.cuda.max_memory_allocated() / 1e9,
           "params": C.tree_bytes(state["params"]) / 1e9,
           "grads": grad_bytes[0] / 1e9,
           "moments": (C.tree_bytes(state["opt"]["mu"])
                       + C.tree_bytes(state["opt"]["nu"])) / 1e9,
           "shards": {p: tuple(t.shape) for p, t in
                      T.items(state["params"])}}
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
        print(f"train mesh: {ARCH} full width step {i + 1}, unsharded / "
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


def train_mesh_phase(launches, smi: str) -> dict:
    from repro_torch.launch import mesh as meshlib

    del launches            # (c) counts in rank 0's process
    t0 = time.perf_counter()
    TP._free()
    ckpt = tempfile.mkdtemp(prefix="train_mesh_ckpt_")
    grads = os.path.join(ckpt, "unsharded_grads.pt")
    try:
        ref = unsharded(ARCH, BATCH, SEQ, STEPS, keep=grads)
        ref_small = unsharded(SMALL, SMALL_BATCH, SMALL_SEQ, 3)
        print(f"train mesh: unsharded references "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        with meshlib.Ranks(MESH[0] * MESH[1], "cuda", timeout_s=600) as ranks:
            print(f"train mesh: 4 ranks spawned in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            t0 = time.perf_counter()
            outs = ranks.run(rank_full, smi, grads)
            print(f"train mesh: (a) + (c) {time.perf_counter() - t0:.1f}s",
                  flush=True)
            check_full(ref, outs, smi)
            t0 = time.perf_counter()
            small = ranks.run(rank_small, os.path.join(ckpt, "ckpt"))
            check_small(ref_small, small)
            print(f"train mesh: (b) {time.perf_counter() - t0:.1f}s",
                  flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    counts = outs[0]["served"]
    for name in SERVING:
        if counts[name] == 0:
            C.fail(f"train mesh (c): the serve launched no {name}")
    return {k: counts[k] for k in SERVING}


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
    print(f"train mesh launches {train_mesh_phase(launches, smi)}",
          flush=True)
    print(f"phase train mesh: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
