"""How far a sharded train step drifts from the unsharded one, and how far
bfloat16 alone drifts from float32.

    python3 tools/train_mesh_drift.py --full --archs mamba2_370m \
        deepseek_moe_16b                 # on the card, at full width
    PYTHONPATH=src python3 tools/train_mesh_drift.py --device cpu

For qwen2-1.5b, mamba2-370m, zamba2-7b and deepseek-moe-16b (``--archs``)
at their reduced configs (``--full``: their published widths, zamba2 and
deepseek cut in depth as ``chip_smoke.py`` phase 19 cuts them,
``FULL_DEPTH``), from one set of bfloat16 weights (the float32 steps
take the same weights, widened exactly) and one batch, four steps:

  T   the unsharded step in float32 (the reference);
  U   the unsharded step in bfloat16;
  Sf  the step at ``--mesh 2x2`` on four spawned gloo ranks in float32;
  Sb  the same in bfloat16;

the moe dispatch in two groups in all four.  Prints each one's loss and,
for each compared leaf (every leaf of a reduced config; at full width
phase 19's read-out leaves and the Mamba2 blocks' (H,) leaves,
``FULL_LEAVES``), the gradients' distances relative to the reference's
norm: |Sf - T| (the layout, float32), |U - T| (what bfloat16 alone
costs), |Sb - T| and |Sb - U|.  Where the sharded layout adds no
precision fault of its own, |Sb - T| is of the size of |U - T|.  For the
moe family it also counts the top-k routing flips, per layer: the
tokens whose chosen experts differ between U and T, Sb and U, Sb and T.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

ARCHS = ("qwen2_1_5b", "mamba2_370m", "zamba2_7b", "deepseek_moe_16b")
MESH, BATCH, SEQ = (2, 2), 4, 40
FULL_SEQ = 256
# phase 19's depth cuts at full width (layers kept; the rest whole)
FULL_DEPTH = {"zamba2_7b": 7, "deepseek_moe_16b": 2}
# the leaves compared at full width: phase 19's read-out leaves and the
# Mamba2 blocks' per-head ones
FULL_LEAVES = {
    "qwen2_1_5b": ("head/mu", "embed/table", "blocks/attn/wq",
                   "blocks/attn/wo", "blocks/ln1", "final_norm"),
    "mamba2_370m": ("head/mu", "blocks/in_proj", "blocks/gate_ln",
                    "blocks/A_log", "blocks/dt_bias", "blocks/D",
                    "blocks/out_proj"),
    "zamba2_7b": ("head/mu", "blocks/in_proj", "blocks/A_log",
                  "blocks/dt_bias", "shared/attn/wq"),
    "deepseek_moe_16b": ("head/mu", "blocks/router/w",
                         "blocks/experts_ep/w1", "blocks/attn/wo")}


def _config(arch: str, dtype: str, full: bool):
    from repro_torch.configs.registry import get_config, reduced

    cfg = get_config(arch) if full else reduced(get_config(arch))
    if full and arch in FULL_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=FULL_DEPTH[arch])
    return dataclasses.replace(cfg, param_dtype=dtype)


def _setup(arch: str, dtype: str, device, full: bool = False,
           shard=None):
    """(cfg, state, opt, batch): the seed's bfloat16 weights (drawn on the
    host; with ``shard``, a function of the tree, only its result kept),
    widened to float32 where ``dtype`` says (exactly: T and U start
    equal), then moved to ``device`` and given their zero moments."""
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import make_batch
    from repro_torch.data.synthetic import TokenStreamState
    from repro_torch.models import registry as M
    from repro_torch.optim import adamw

    cfg = _config(arch, dtype, full)
    params = M.init_train_params(_config(arch, "bfloat16", full),
                                 torch.Generator().manual_seed(3), "cpu")
    if shard is not None:
        params = shard(params)
    params = T.map_tree(lambda t: t.to(device, torch.float32)
                        if dtype == "float32" else t.to(device), params)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    batch = make_batch(cfg, TokenStreamState(seed=0, host=0, num_hosts=1),
                       BATCH, FULL_SEQ if full else SEQ)[0]
    return cfg, {"params": params, "opt": adamw.init_state(params, opt)}, \
        opt, batch


def _leaves(arch: str, full: bool, paths) -> tuple:
    return FULL_LEAVES[arch] if full else tuple(paths)


class _Routes:
    """Records the experts ``moe.route`` chooses in the first ``n``
    calls (the forward's layers; a recomputation comes after them), as
    (tokens, K) sorted, B-major over the dispatch groups."""

    def __init__(self, n: int):
        from repro_torch.models import moe
        self.n, self.seen, self._moe = n, [], moe

    def __enter__(self):
        self._orig = orig = self._moe.route

        def route(*a, **kw):
            r = orig(*a, **kw)
            if len(self.seen) < self.n:
                top = r["topi"].detach().cpu()
                self.seen.append(torch.sort(
                    top.reshape(-1, top.shape[-1]), dim=-1).values)
            return r

        self._moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._orig


def _step(cfg, state, opt, batch, device, mesh=None, dims=None):
    """One step: (loss, the gradients as handed to AdamW, the routes)."""
    from repro_torch.core.svi import SVIConfig
    from repro_torch.data.pipeline import shard_batch, to_device
    from repro_torch.launch import steps as S
    from repro_torch.models import moe

    nll = None
    if cfg.family == "moe" and mesh is None:
        nll = lambda p, b, k: moe.nll_loss(p, cfg, b, k,  # noqa: E731
                                           groups=MESH[0])
    fn = S.build_train_step(cfg, opt, SVIConfig(num_train_examples=1000,
                                                kl_warmup_steps=2),
                            seed=0, nll_fn=nll, mesh=mesh, dims=dims)
    seen = []
    orig = S.adamw.apply_updates

    def record(p, g, st, c, **kw):
        seen.append(g)
        return orig(p, g, st, c, **kw)

    S.adamw.apply_updates = record
    try:
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        with _Routes(cfg.num_layers if cfg.family == "moe" else 0) as r:
            _, m = fn(state, to_device(batch, device))
    finally:
        S.adamw.apply_updates = orig
    return float(m["loss"]), seen[0], r.seen


def _dist(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def sharded(tp, arch: str, dtype: str, full: bool, refs: dict) -> dict:
    """One 2x2 step on this rank.  Rank 0 returns the loss and, for each
    compared leaf gathered whole, its distance to each gradient saved in
    ``refs`` (name -> file); the model-rank-0 ranks return their data
    rank's routes."""
    from repro_torch.core import tree as T
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import registry as M
    from repro_torch.sharding import partition as P

    mesh = meshlib.train_mesh(tp, *MESH)
    cfg = _config(arch, dtype, full)
    dims = P.train_dims(cfg, M.init_train_params(
        cfg, torch.Generator(), "meta"), MESH)
    cfg, state, opt, batch = _setup(
        arch, dtype, tp.device, full,
        shard=lambda params: P.shard_tree(params, dims, mesh))
    loss, grads, routes = _step(cfg, state, opt, batch, tp.device, mesh,
                                dims)
    del state
    specs = dict(T.items(dims))
    flat = dict(T.items(grads))
    wanted = {n: torch.load(f, mmap=True) for n, f in refs.items()}
    dist = {}
    for path in _leaves(arch, full, flat):
        whole = P.gather_leaf(flat[path], specs[path], mesh, host=True)
        if mesh.rank == 0:
            dist[path] = {n: _dist(whole, w[path])
                          for n, w in wanted.items()}
    out = {"routes": routes if mesh.model.index == 0 else None}
    if mesh.rank == 0:
        out.update(loss=loss, dist=dist)
    return out


def _flips(a: list, b: list) -> list:
    """Per layer, the tokens whose chosen experts differ."""
    return [int((x != y).any(-1).sum()) for x, y in zip(a, b)]


def main(argv=None):
    from repro_torch import resolve_device
    from repro_torch.core import tree as T
    from repro_torch.launch import mesh as meshlib

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--archs", nargs="+", default=list(ARCHS))
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="train_mesh_drift_")
    with meshlib.Ranks(MESH[0] * MESH[1], args.device) as ranks:
        for arch in args.archs:
            ref, loss, routes, files = {}, {}, {}, {}
            for name, dtype in (("T", "float32"), ("U", "bfloat16")):
                cfg, state, opt, batch = _setup(arch, dtype, device,
                                                args.full)
                loss[name], g, routes[name] = _step(cfg, state, opt, batch,
                                                    device)
                flat = dict(T.items(g))
                ref[name] = {p: flat[p].detach().float().cpu()
                             for p in _leaves(arch, args.full, flat)}
                files[name] = os.path.join(tmp, f"{name}.pt")
                torch.save(ref[name], files[name])
                del state, g, flat
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            ref_u = {p: {"U-T": _dist(ref["U"][p], ref["T"][p])}
                     for p in ref["T"]}
            del ref
            for name, dtype in (("Sf", "float32"), ("Sb", "bfloat16")):
                outs = ranks.run(sharded, arch, dtype, args.full, files)
                loss[name] = outs[0]["loss"]
                routes[name] = [torch.cat(layer) for layer in zip(
                    *(o["routes"] for o in outs if o["routes"] is not None))]
                for p, d in outs[0]["dist"].items():
                    ref_u[p].update({f"{name}-{n}": v for n, v in d.items()})
            for f in files.values():
                os.remove(f)
            print(f"{arch}{' full width' if args.full else ' reduced'} "
                  f"({cfg.num_layers} layers): loss T {loss['T']:.6f}, U "
                  f"{loss['U']:.6f}, Sf {loss['Sf']:.6f}, Sb "
                  f"{loss['Sb']:.6f}", flush=True)
            worst = sorted(ref_u.items(), key=lambda kv: -kv[1]["Sb-T"])
            for p, d in worst[:8] if not args.full else worst:
                print(f"  {p}: |Sf-T| {d['Sf-T']:.3g}, |U-T| "
                      f"{d['U-T']:.3g}, |Sb-T| {d['Sb-T']:.3g}, |Sb-U| "
                      f"{d['Sb-U']:.3g} (of the reference's norm)",
                      flush=True)
            ratio = max(d["Sb-T"] / max(d["U-T"], 1e-30)
                        for d in ref_u.values())
            print(f"  largest |Sb-T| / |U-T| over the leaves: {ratio:.3g}; "
                  f"largest |Sf-T|: "
                  f"{max(d['Sf-T'] for d in ref_u.values()):.3g}",
                  flush=True)
            if routes["T"]:
                n = routes["T"][0].shape[0]
                print(f"  top-k flips a layer, of {n} tokens: U vs T "
                      f"{_flips(routes['U'], routes['T'])}, Sb vs U "
                      f"{_flips(routes['Sb'], routes['U'])}, Sb vs T "
                      f"{_flips(routes['Sb'], routes['T'])}, Sf vs T "
                      f"{_flips(routes['Sf'], routes['T'])}", flush=True)
    os.rmdir(tmp)


if __name__ == "__main__":
    import repro_torch  # noqa: F401  (pins the precision flags)
    torch.set_num_threads(1)
    main()
