"""Dry run: reckon every (arch x shape cell x production mesh) cell.

PyTorch counterpart of ``repro.launch.dryrun``.  The JAX dry run lowers
and compiles each cell for 512 placeholder devices; here the process
joins a FAKE process group (``torch.distributed``'s "fake" backend) as
one rank of the production mesh, builds that rank's share of the state
and inputs as tensors that hold no memory (the meta device, or
``FakeTensorMode`` on another device), and runs the port's own step on
them once, under ``MemTracker`` (peak bytes by kind) and
``launch.op_cost.OpCost`` (FLOPs, bytes, collectives).  It allocates
nothing and needs no card.

For each runnable cell it writes
``artifacts/dryrun_torch/<arch>__<shape>__<single|multi>.json``:

* train cells run ``steps.build_train_step`` (forward, remat, backward,
  the sharded gradient completion and AdamW) on the rank's blocks under
  ``partition.train_dims`` and the data rank's rows of the batch;
* prefill and decode cells run ``registry.prefill`` and
  ``steps.build_decode_step`` on the rank's parameters under the SERVE
  rules (``partition.serve_dims``) over ``model``, on the data line's
  rows: the port's serving shards nothing over ``data``, so each data
  line is one independent 1 x 16 engine (the JAX cells place the
  parameters by the FSDP train rules instead);
* the hand kernels cannot read tensors without memory: the plain
  versions are traced in their place (``kernels.ops``), as the JAX dry
  run traces the jnp paths.  ``cost`` counts them op by op;
  ``cost_fused_attn`` counts the plain attention's bytes as a kernel's,
  operands and results only, and the hand kernels' likewise
  (``FUSED_ATTN``): what the card moves where those are kernels.

``single`` is the 16 x 16 mesh (256 ranks).  ``multi`` is 2 x 16 x 16
(512): the port's train mesh has no ``pod`` axis, but with ``pod_fsdp``
every "data" of the JAX rules becomes ("pod", "data") and the batch
splits over both, so a rank's blocks are those of a 32 x 16 mesh, which
``multi`` runs (``"as": "32x16"``) where every leaf's block agrees
(``pod_reading``); the DCN / ICI split is not modelled.  The record
holds counts, never times.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2_370m \\
      --shape long_500k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch.configs.base import SHAPE_CELLS, cell_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import tree as T
from repro_torch.core.svi import SVIConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as S
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import layers as L
from repro_torch.models import registry as M
from repro_torch.optim import adamw
from repro_torch.sharding import partition as P

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

# mesh tag -> (the D x M mesh a rank's blocks are cut on, ranks, name)
MESHES = {"single": ((16, 16), 256, "16x16"),
          "multi": ((32, 16), 512, "2x16x16")}
POD = {"pod": 2, "data": 16, "model": 16}

# counted as kernels move bytes (operands and results) in
# ``cost_fused_attn``: the plain attention of training and prefill (the
# flash kernel's function), and the hand kernels' entry points, whose
# plain versions the dry run traces
KERNELS = tuple(f"repro_torch.kernels.ops:{name}" for name in (
    "uncertainty_head", "uncertainty_head_sampled", "flash_attention",
    "paged_decode_attention", "paged_prefill_attention", "bayes_matmul",
    "bayes_matmul_sampled", "lrt_matmul", "lrt_matmul_sampled",
    "photonic_conv", "photonic_conv_sampled"))
FUSED_ATTN = ("repro_torch.models.layers:flash_attention",) + KERNELS

GB = 1e9


def cell_tokens(cell) -> int:
    """The tokens a cell's step processes (the JAX record's formula)."""
    return cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                else 1)


def pick_micro_batches(cfg, cell, dp: int) -> int:
    """Bound the per-replica microbatch to ~4 sequences (the JAX dry
    run's rule)."""
    del cfg
    per_replica = max(cell.global_batch // dp, 1)
    micro = max(per_replica // 4, 1)
    while cell.global_batch % (micro * dp) and micro > 1:
        micro -= 1
    return micro


# ---------------------------------------------------------------------------
# the fake group and tensors that hold nothing
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world: int, rank: int, device):
    """This process as rank ``rank`` of a fake ``world``-rank group (no
    peers, no network): its ``launch.mesh.TP``.  Refuses to start inside
    a group; on exit, also after a failure, the group's train meshes are
    forgotten and the group destroyed."""
    if meshlib.in_group():
        raise RuntimeError("the dry run joins a fake process group of its "
                           "own: run it outside any group")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield meshlib.TP(rank=rank, size=world, backend="fake",
                         device=torch.device(device))
    finally:
        meshlib.drop_train_meshes()
        dist.destroy_process_group()


def _tensor_mode(device):
    """Where tensors hold nothing: the meta device as it is, any other
    device under ``FakeTensorMode``."""
    if torch.device(device).type == "meta":
        return contextlib.nullcontext()
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _like(tree: dict, device) -> dict:
    """Tensors of ``tree``'s shapes and dtypes on ``device`` (meta blocks
    become fake ones there)."""
    if torch.device(device).type == "meta":
        return tree
    return T.map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device=device), tree)


def _bytes(tree) -> int:
    """The bytes of a tensor or of a tree of them."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_bytes(t) for t in T.leaves(tree))


def _reckon(run, external: list, detail: bool):
    """``run()`` under ``MemTracker`` (``external`` the tensors that exist
    before it) and ``OpCost``: (peak bytes by kind, the cost, seconds)."""
    tracker = MemTracker()
    tracker.track_external(*external)
    t0 = time.perf_counter()
    with tracker, OpCost(detail, FUSED_ATTN) as cost:
        run()
    seconds = time.perf_counter() - t0
    snap = tracker.get_tracker_snapshot("peak")
    peak = {}
    for by_kind in snap.values():
        for kind, n in by_kind.items():
            name = getattr(kind, "value", kind)     # "Activation", ...
            peak[name] = peak.get(name, 0) + n
    return peak, cost, seconds


def _costs(cost: OpCost) -> dict:
    return {"cost": cost.summary(), "cost_fused_attn": cost.summary(True)}


# ---------------------------------------------------------------------------
# one rank's step
# ---------------------------------------------------------------------------

def train_batch(cfg, batch: int, seq: int, device) -> dict:
    """A global train batch's leaves (token ids int64, the encdec frames
    or vlm prefix embeds float32) as tensors that hold nothing."""
    out = {"tokens": torch.zeros((batch, seq), dtype=torch.long,
                                 device=device),
           "labels": torch.zeros((batch, seq), dtype=torch.long,
                                 device=device)}
    if cfg.family == "encdec":
        from repro_torch.models.encdec import ENC_LEN
        out["frames"] = torch.zeros((batch, ENC_LEN, cfg.d_model),
                                    device=device)
    if cfg.family == "vlm":
        out["prefix_embeds"] = torch.zeros(
            (batch, cfg.num_prefix_embeds, cfg.d_model), device=device)
    return out


def reckon_train(cfg, shape: tuple, batch: int, seq: int,
                 micro_batches: int = 1, *, rank: int = 0,
                 device="meta", opt_cfg=None, svi=None, seed: int = 0,
                 detail: bool = False) -> dict:
    """One train step of rank ``rank`` of a D x M mesh (``shape``) on a
    global batch of ``batch`` x ``seq`` tokens: the rank's state bytes
    (``memory``: parameters, gradients as the step hands them to AdamW,
    moments, and the peak with its breakdown), ``cost`` and
    ``cost_fused_attn``, the bytes the rank put into each axis'
    collectives (``traffic``, as ``TrainMesh.traffic`` counts them) and
    ``trace_s``; with ``detail`` the ``OpCost`` too (``op_cost``)."""
    d, m = shape
    opt_cfg = opt_cfg or adamw.AdamWConfig(moment_dtype=cfg.moment_dtype)
    svi = svi or SVIConfig(num_train_examples=batch * 1000)
    with fake_group(d * m, rank, device) as tp, _tensor_mode(device):
        mesh = meshlib.train_mesh(tp, d, m)
        whole = M.init_train_params(cfg, torch.Generator(), "meta")
        dims = P.train_dims(cfg, whole, shape)
        params = _like(P.shard_tree(whole, dims, mesh), device)
        state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
        rows = shard_batch(train_batch(cfg, batch, seq, device), mesh,
                           micro_batches)
        grads = []
        fn = S.build_train_step(cfg, opt_cfg, svi, micro_batches, seed,
                                mesh=mesh, dims=dims,
                                on_grads=lambda g: grads.append(
                                    sum(_bytes(x) for x in g)))
        for k in mesh.traffic:
            mesh.traffic[k] = 0
        peak, cost, seconds = _reckon(
            lambda: fn(state, rows),
            T.leaves(state) + list(rows.values()), detail)
        opt = state["opt"]
        out = {"memory": {
            "param_bytes": _bytes(params), "grad_bytes": grads[0],
            "moment_bytes": _bytes(opt["mu"]) + _bytes(opt["nu"]),
            "peak_bytes": peak["Total"], "peak_by_kind": peak},
            **_costs(cost), "traffic": dict(mesh.traffic),
            "trace_s": seconds}
    if detail:
        out["op_cost"] = cost
    return out


def serve_params(cfg, m: int, rank: int) -> dict:
    """A serving rank's parameters on the meta device, as the runner
    shards them over ``m`` model ranks (the serve rules; the fused head
    whole under kernel entropy)."""
    whole = M.serving_params(M.init_train_params(cfg, torch.Generator(),
                                                 "meta"))
    dims = P.serve_dims(whole, m)
    if cfg.head_entropy == "kernel":
        dims["head"] = dict.fromkeys(dims["head"])
    return P.shard_params(whole, rank, m, dims)


def reckon_serve(cfg, kind: str, rows: int, seq: int, m: int = 16, *,
                 rank: int = 0, detail: bool = False) -> dict:
    """One prefill of ``rows`` prompts of ``seq`` tokens, or one decode
    step of ``rows`` slots against a dense cache ``seq`` deep, on model
    rank ``rank`` of a 1 x ``m`` serving engine: its ``memory``
    (parameter and cache bytes, the peak), ``cost``, ``cost_fused_attn``
    and ``trace_s`` (on the meta device)."""
    device = torch.device("meta")
    with fake_group(m, rank, device) as tp, torch.no_grad():
        params = serve_params(cfg, m, rank)
        if kind == "prefill":
            batch = train_batch(cfg, rows, seq, device)
            tokens = batch["tokens"]
            modality = batch.get("frames", batch.get("prefix_embeds"))
            inputs = [tokens] + ([] if modality is None else [modality])
            cache = {}

            def run():
                M.prefill(params, cfg, tokens, seq, modality, tp=tp)
        else:
            shards = m if L.heads_local(cfg, tp) else 1
            cache = M.make_cache(cfg, rows, seq, device=device,
                                 kv_shards=shards)
            token = torch.zeros((rows,), dtype=torch.int32, device=device)
            inputs = [token] + T.leaves(cache)
            step = S.build_decode_step(cfg, tp=tp)

            def run():
                step(params, token, cache, 0)
        peak, cost, seconds = _reckon(run, T.leaves(params) + inputs, detail)
        out = {"memory": {"param_bytes": _bytes(params),
                          "cache_bytes": _bytes(cache),
                          "peak_bytes": peak["Total"], "peak_by_kind": peak},
               **_costs(cost), "trace_s": seconds}
    if detail:
        out["op_cost"] = cost
    return out


# ---------------------------------------------------------------------------
# the pod axis
# ---------------------------------------------------------------------------

def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _pod(entry):
    """A spec entry with "data" spread over ("pod", "data") (the JAX
    rules' ``pod_fsdp``)."""
    if entry is None:
        return None
    names = tuple(x for e in _names(entry)
                  for x in (("pod", "data") if e == "data" else (e,)))
    return names if len(names) > 1 else names[0]


def _walk(specs: dict, fn) -> dict:
    return {k: _walk(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in specs.items()}


def block_shapes(params: dict, specs: dict, sizes: dict) -> dict:
    """path -> a rank's block shape of each leaf under ``specs`` on a mesh
    of axis ``sizes``."""
    flat = dict(T.items(specs)) if specs else {}
    return {p: tuple(n // math.prod(sizes[a] for a in _names(e))
                     for n, e in zip(t.shape, flat[p]))
            for p, t in T.items(params)}


def rank_blocks(cfg, params: dict, tag: str) -> dict:
    """path -> the block of each parameter (and so of its moments) a rank
    of the ``tag`` mesh trains on, as the dry run cuts them."""
    shape = MESHES[tag][0]
    return block_shapes(params, P.train_dims(cfg, params, shape),
                        {"data": shape[0], "model": shape[1]})


def pod_specs(cfg, params: dict) -> dict:
    """The JAX rules' specs on the 2 x 16 x 16 production mesh, with
    ``pod_fsdp`` where FSDP is on (sanitized)."""
    specs = P.param_pspecs(params, fsdp=cfg.fsdp_params)
    if cfg.fsdp_params:
        specs = _walk(specs, lambda s: tuple(_pod(e) for e in s))
    return P.sanitize_pspecs(specs, params, POD)


def pod_reading(cfg, params: dict) -> list:
    """The leaves whose block on the 2 x 16 x 16 mesh (``pod_specs``)
    differs from the 32 x 16 train mesh's: [] where ``multi`` may run as
    32 x 16."""
    pod = block_shapes(params, pod_specs(cfg, params), POD)
    flat = rank_blocks(cfg, params, "multi")
    return [p for p in pod if pod[p] != flat[p]]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape: str, multi_pod: bool, rank: int = 0,
               detail: bool = False) -> dict:
    """One cell's record (``{"arch", "shape", "skipped"}`` for a cell the
    assignment skips; ``"unsupported"`` for one the port cannot run as
    the mesh asks)."""
    cfg = get_config(arch)
    cell = SHAPE_CELLS[shape]
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "shape": shape, "skipped": why}
    tag = "multi" if multi_pod else "single"
    (d, m), n, name = MESHES[tag]
    rec = {"arch": arch, "shape": shape, "mesh": name, "num_devices": n,
           "rank": rank, "kind": cell.kind}
    if multi_pod:
        rec["as"] = f"{d}x{m}"
        meta = M.init_train_params(cfg, torch.Generator(), "meta")
        differ = pod_reading(cfg, meta)
        if differ:
            return {**rec, "unsupported": (
                "the port's train mesh has no pod axis, and these leaves' "
                f"blocks on 2x16x16 are not those of 32x16: {differ}")}
    if cell.kind == "train":
        micro = pick_micro_batches(cfg, cell, d)
        try:
            out = reckon_train(
                cfg, (d, m), cell.global_batch, cell.seq_len, micro,
                rank=rank, detail=detail,
                svi=SVIConfig(num_train_examples=cell.global_batch * 1000))
        except NotImplementedError as e:
            return {**rec, "unsupported": str(e)}
        rec["micro_batches"] = micro
    else:
        whole = cell.global_batch % d == 0
        rows = cell.global_batch // d if whole else cell.global_batch
        rec["engine"] = (f"{d} independent 1x{m} serving engines (the serve "
                         "rules shard only model), one a data line")
        rec["rows"] = rows
        if not whole:
            rec["batch_note"] = (
                f"a batch of {cell.global_batch} does not split over {d} "
                "data lines: the whole batch sits on every line (the port "
                "has no sequence split of the KV over data)")
        try:
            out = reckon_serve(cfg, cell.kind, rows, cell.seq_len, m,
                               rank=rank % m, detail=detail)
        except NotImplementedError as e:
            return {**rec, "unsupported": str(e)}
    rec.update(
        trace_s=round(out.pop("trace_s"), 1),
        param_count=cfg.param_count,
        active_param_count=cfg.active_param_count,
        tokens=cell_tokens(cell), **out)
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             rank: int = 0) -> dict:
    rec = lower_cell(arch, shape, multi_pod, rank)
    tag = "multi" if multi_pod else "single"
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape}__{tag}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    if "skipped" in rec:
        print(f"SKIP  {arch:22s} {shape:12s} {tag:6s} {rec['skipped']}")
    elif "unsupported" in rec:
        print(f"UNSUP {arch:22s} {shape:12s} {tag:6s} {rec['unsupported']}")
    else:
        mem, cost = rec["memory"], rec["cost"]
        print(f"OK    {arch:22s} {shape:12s} {tag:6s} "
              f"trace {rec['trace_s']:6.1f}s  peak/dev "
              f"{mem['peak_bytes'] / GB:7.2f} GB  flops/dev "
              f"{cost['flops']:.3e}  coll "
              f"{cost['collectives']['total_link_bytes']:.3e}B", flush=True)
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Reckon the per-rank memory, FLOPs, bytes and "
        "collectives of every (arch x shape cell x production mesh) by "
        "running the port's step once on a fake process group with "
        "tensors that hold no memory: allocates nothing, needs no card.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the production mesh this process is")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPE_CELLS) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape, mp, args.out, args.rank)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape, mp, str(e)[:200]))
                    print(f"FAIL  {arch:22s} {shape:12s} "
                          f"{'multi' if mp else 'single'}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall dry-run cells green")


if __name__ == "__main__":
    main()
