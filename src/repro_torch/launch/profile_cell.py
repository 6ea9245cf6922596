"""Profile one dry-run cell: its top collective and byte contributors.

PyTorch counterpart of ``repro.launch.profile_cell``: reckons a cell as
``launch.dryrun`` does (a fake process group, tensors that hold no
memory, no card) with ``launch.op_cost.OpCost``'s ``detail`` on, and
attributes the counts to the port's functions, so a hypothesis like
"the head's gather moves the logits" is checkable directly.  It profiles
a RECKONED cell; ``chip_smoke.py`` phase 5 and ``tools/train_phase.py
--profile ARCH`` profile timed runs on the card with ``torch.profiler``.

  PYTHONPATH=src python -m repro_torch.launch.profile_cell \\
      --arch grok_1_314b --shape train_4k [--multi-pod] [--fused-attn]
"""

from __future__ import annotations

import argparse

from repro_torch.launch import dryrun


def profile(arch: str, shape: str, multi_pod: bool = False,
            fused_attn: bool = False, top: int = 14) -> dict:
    rec = dryrun.lower_cell(arch, shape, multi_pod, detail=True)
    cost = rec.pop("op_cost", None)
    if cost is None:
        print("cell not run:", rec.get("skipped") or rec.get("unsupported"))
        return {"record": rec}
    s = cost.summary(fused_attn)
    print(f"\n{arch} x {shape} x {rec['mesh']}   "
          f"flops/dev {s['flops']:.3e}  bytes/dev {s['bytes']:.3e}  "
          f"coll/dev {s['collectives']['total_link_bytes']:.3e}  "
          f"peak/dev {rec['memory']['peak_bytes']:.3e}")
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "all-to-all", "bytes"):
        rows = cost.top(kind, top, fused_attn)
        if not rows:
            continue
        print(f"\n top {kind}:")
        for amount, op, name in rows:
            print(f"  {amount:11.3e}  {op:24s} {name[:100]}")
    return {"record": rec, "summary": s}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Top collective / byte contributors of one dry-run "
        "cell (reckoned on a fake group: allocates nothing, needs no "
        "card).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fused-attn", action="store_true",
                    help="count the plain attention as the flash kernel "
                    "moves bytes (operands and results)")
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args(argv)
    profile(args.arch, args.shape, args.multi_pod, args.fused_attn,
            args.top)


if __name__ == "__main__":
    main()
