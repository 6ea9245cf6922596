"""How many cards does a full-width training state need?  A dry-run sweep
of ``train_4k`` over 2-D train meshes.

For each arch and each D x M mesh, rank 0's parameter, gradient, moment
and peak bytes from ``repro_torch.launch.dryrun.reckon_train`` (the
port's step on a fake group, tensors that hold no memory: no card, no
allocation), with the JAX dry run's micro-batch rule at D data ranks.
Where the state alone (parameters, gradients, moments) already exceeds
one 80 GB card, the step is not traced: its peak can only be larger.
Prints one line a cell and the smallest mesh whose peak fits the card,
and writes the rows as JSON.  Every number is reckoned, not measured.

  PYTHONPATH=src python tools/dryrun_sweep.py --arch grok_1_314b \\
      --meshes 4x4 8x8 8x16 16x16 [--out chiprun_out/dryrun_sweep.json]
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.configs.registry import get_config
from repro_torch.core import tree as T
from repro_torch.core.svi import SVIConfig
from repro_torch.launch import dryrun as D
from repro_torch.models import registry as M
from repro_torch.sharding import partition as P

GB = 1e9
CARD_GB = 80.0          # one H100's memory


def state_bytes(cfg, shape: tuple) -> dict:
    """Rank 0's parameter bytes and its f32-or-config moment bytes under
    the train rules, from the shapes alone; the gradient is taken at the
    parameters' bytes (its dtype, one micro-batch) or f32 (several)."""
    params = M.init_train_params(cfg, torch.Generator(), "meta")
    blocks = D.block_shapes(params, P.train_dims(cfg, params, shape),
                            {"data": shape[0], "model": shape[1]})
    moment = {"float32": 4, "bfloat16": 2}[cfg.moment_dtype]
    out = {"param_bytes": 0, "moment_bytes": 0, "f32_bytes": 0}
    for path, t in T.items(params):
        n = math.prod(blocks[path])
        out["param_bytes"] += n * t.element_size()
        out["moment_bytes"] += 2 * n * moment
        out["f32_bytes"] += 4 * n
    return out


def sweep(arch: str, meshes: list, card_gb: float = CARD_GB) -> list:
    cfg = get_config(arch)
    cell = SHAPE_CELLS["train_4k"]
    rows = []
    for d, m in meshes:
        micro = D.pick_micro_batches(cfg, cell, d)
        est = state_bytes(cfg, (d, m))
        grads = est["param_bytes"] if micro == 1 else est["f32_bytes"]
        row = {"arch": arch, "mesh": f"{d}x{m}", "cards": d * m,
               "micro_batches": micro}
        if est["param_bytes"] + grads + est["moment_bytes"] > card_gb * GB:
            row.update(param_bytes=est["param_bytes"], grad_bytes=grads,
                       moment_bytes=est["moment_bytes"], peak_bytes=None,
                       note="state alone exceeds the card: not traced")
        else:
            out = D.reckon_train(
                cfg, (d, m), cell.global_batch, cell.seq_len, micro,
                svi=SVIConfig(num_train_examples=cell.global_batch * 1000))
            row.update({k: out["memory"][k] for k in (
                "param_bytes", "grad_bytes", "moment_bytes", "peak_bytes")},
                flops=out["cost"]["flops"], trace_s=out["trace_s"])
        row["fits"] = row["peak_bytes"] is not None and \
            row["peak_bytes"] <= card_gb * GB
        rows.append(row)
        peak = "-" if row["peak_bytes"] is None else \
            f"{row['peak_bytes'] / GB:.2f}"
        print(f"{arch:18s} {row['mesh']:6s} micro {micro:2d}  params "
              f"{row['param_bytes'] / GB:.2f}  grads "
              f"{row['grad_bytes'] / GB:.2f}  moments "
              f"{row['moment_bytes'] / GB:.2f}  peak {peak} GB  "
              f"{'fits' if row['fits'] else 'does not fit'} {card_gb:g} GB "
              f"(reckoned){'; ' + row['note'] if 'note' in row else ''}",
              flush=True)
    fit = [r for r in rows if r["fits"]]
    best = min(fit, key=lambda r: r["cards"])["mesh"] if fit else None
    print(f"{arch}: smallest mesh of the sweep whose per-rank peak fits "
          f"{card_gb:g} GB: {best} (reckoned by the dry run)", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", required=True)
    ap.add_argument("--meshes", nargs="+",
                    default=["4x4", "8x8", "8x16", "16x16"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    meshes = [tuple(int(x) for x in s.split("x")) for s in args.meshes]
    rows = [r for a in args.arch for r in sweep(a, meshes)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
