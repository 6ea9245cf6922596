"""Time the fused head under forced stream plans on one GPU: at each
served family's head widths (M 4, S 10, bf16 x, Philox draws; M 16 too at
qwen2-1.5b's and zamba2-7b's), ``head_plan``'s plan with its K cut into
1 to 16 slices (where the staged x allows), each by CUDA-graph replay,
beside the slices ``head_plan`` picks, its blocks, busiest-SM balance and
wave fill.  The first line is the card's name and power limit.

    python3 tools/head_plans.py
"""

from __future__ import annotations

import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402

UH = importlib.import_module("repro_torch.kernels.uncertainty_head")
WIDTHS = {"qwen2": (1536, 151936), "deepseek": (2048, 102400),
          "mamba2": (1024, 50280), "zamba2": (3584, 32000),
          "seamless": (1024, 256206), "phi3v": (3072, 32064)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times GPU kernels")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for name, (K, V) in WIDTHS.items():
        for M in (4, 16) if name in ("qwen2", "zamba2") else (4,):
            mu, sigma, g = C.head_case(dev, 1, K, V)
            x = torch.randn((M, K), generator=g,
                            device=dev).to(torch.bfloat16)
            base = UH.head_plan(M, K, V)
            cells = []
            for splits in (1, 2, 3, 4, 5, 6, 8, 10, 12, 16):
                k_slice = -(-(-(-K // splits)) // 8) * 8
                plan = dataclasses.replace(base, k_slice=k_slice)
                if plan.splits != splits or \
                        M * k_slice * 4 > UH.STREAM_X_BYTES:
                    continue
                ms = C.device_ms(lambda: UH.uncertainty_head_cuda(
                    x, mu, sigma, num_samples=10, seed=7, step=3,
                    plan=plan), 10)
                cells.append(f"{splits} slices ({plan.blocks} blocks, "
                             f"balance {plan.balance:.3f}, waves "
                             f"{plan.waves:.3f}) {ms:.4f} ms")
            print(f"{name} M {M} (head_plan: {base.splits} slices): "
                  + "; ".join(cells), flush=True)
            del mu, sigma


if __name__ == "__main__":
    main()
