"""Time variants of the fused head's stream (``head_stream`` in
``src/repro_torch/kernels/csrc/uncertainty_head.cu``) against each other
on one GPU, in one process.

Each variant is the source with text substitutions.  The script builds
every variant with nvcc (one process each, all at once) into
``build/head_variants/``, calls each through the head's own wrapper
(``uncertainty_head_cuda``, its C entry point swapped), checks that each
gives the kept source's outputs bit for bit, and times the whole head by
CUDA-graph replay at M 4, S 10 (Philox draws, bf16 x) at the six served
widths and at M 16 at qwen2-1.5b's, in turns: every variant once, then
again in reverse order.

    python3 tools/head_variants.py

Variants:
  kept        the source as it is
  async8_rowwise  on the cp.async routes, a lane's copies of a row of mu
              first, then of the row of sigma (not column by column)
  pitch260    stage rows 260 floats apart, so that they no longer start
              on 128 bytes
  stages6     a ring of 6 stages in place of 4

A substitution that no longer matches the source stops the script.
"""

from __future__ import annotations

import ctypes
import importlib
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

UH = importlib.import_module("repro_torch.kernels.uncertainty_head")
CSRC = build.CSRC
OUT = ROOT / "build" / "head_variants"

COLUMNWISE = """          for (int c = W * lane; c < nc; c += 32 * W) {
            if (W == 2) {
              cp_async_8(dm + c, gm + c);
              cp_async_8(ds + c, gs + c);
            } else {
              mma_tile::cp_async_4(dm + c, gm + c, true);
              mma_tile::cp_async_4(ds + c, gs + c, true);
            }
          }"""
ROWWISE = """          for (int h = 0; h < 2; ++h)
            for (int c = W * lane; c < nc; c += 32 * W) {
              if (W == 2)
                cp_async_8((h ? ds : dm) + c, (h ? gs : gm) + c);
              else
                mma_tile::cp_async_4((h ? ds : dm) + c, (h ? gs : gm) + c,
                                     true);
            }"""
STAGE = "constexpr int ST_STAGE_FLOATS = 2 * ST_ROWS * ST_TILE;"
PADDED = """constexpr int ST_STAGE_FLOATS = 2 * ST_ROWS * (ST_TILE + 4);"""
WIDTHS = {"qwen2": (1536, 151936), "deepseek": (2048, 102400),
          "mamba2": (1024, 50280), "zamba2": (3584, 32000),
          "seamless": (1024, 256206), "phi3v": (3072, 32064)}


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the source no longer holds:\n{old}")
    return text.replace(old, new)


def variants() -> dict[str, str]:
    """{name: uncertainty_head.cu source} for every variant."""
    cu = (CSRC / "uncertainty_head.cu").read_text()
    padded = _sub(cu, STAGE, PADDED)
    for old in ("r * ST_TILE, ", "(ST_ROWS + r) * ST_TILE",
                "dst + r * ST_TILE;", "ms + ST_ROWS * ST_TILE"):
        padded = _sub(padded, old, old.replace("ST_TILE", "(ST_TILE + 4)"))
    return {
        "kept": cu,
        "async8_rowwise": _sub(cu, COLUMNWISE, ROWWISE),
        "pitch260": padded,
        "stages6": _sub(cu, "constexpr int ST_STAGES = 4;",
                        "constexpr int ST_STAGES = 6;"),
    }


def build_all() -> dict[str, ctypes._CFuncPtr]:
    procs = {}
    for name, text in variants().items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in CSRC.iterdir():
            shutil.copy(f, d / f.name)
        (d / "uncertainty_head.cu").write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "uncertainty_head.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).repro_uncertainty_head
        fn.argtypes = UH._fn().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times GPU kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    dev = torch.device("cuda")
    fns = build_all()
    kept_fn = UH._fn
    cases = [(name, 4, K, V) for name, (K, V) in WIDTHS.items()]
    cases.append(("qwen2", 16, *WIDTHS["qwen2"]))
    try:
        for name, M, K, V in cases:
            mu, sigma, g = C.head_case(dev, 1, K, V)
            x = torch.randn((M, K), generator=g,
                            device=dev).to(torch.bfloat16)

            def run():
                return UH.uncertainty_head_cuda(x, mu, sigma, num_samples=10,
                                                seed=7, step=3)

            plan = UH.head_plan(M, K, V)
            UH._fn = lambda: fns["kept"]
            want = run()
            order = list(fns)
            for rnd, names in enumerate((order, order[::-1])):
                for v in names:
                    UH._fn = lambda v=v: fns[v]
                    got = run()
                    same = all(torch.equal(got[k].view(torch.int32),
                                           want[k].view(torch.int32))
                               for k in want)
                    ms = C.device_ms(run, 10)
                    print(f"{name} M {M} (route {plan.route}, {plan.splits} "
                          f"slices), {v}, round {rnd}: {ms:.4f} ms"
                          + ("" if same else ", OUTPUTS DIFFER from kept"),
                          flush=True)
            del mu, sigma
    finally:
        UH._fn = kept_fn


if __name__ == "__main__":
    main()
