"""Time variants of the tensor-core LRT kernel (``lrt_gemm_mma`` in
``src/repro_torch/kernels/csrc/bayes_matmul.cu``) against each other on one
GPU, in one process.

Each variant is the kernel's source with text substitutions.  The script
builds every variant with nvcc (one process each, all at once) into
``build/lrt_variants/``, calls each through the same C entry point
(``repro_lrt_matmul``, route 1), prints each one's error against the
plain f32 version (large for the timing-only variants), and times each
by CUDA-graph replay, in turns: every variant once, then again in
reverse order.

    python3 tools/lrt_variants.py

Variants:
  kept           the source as it is
  cvt_rna        hi and lo both rounded by cvt.rna.tf32.f32
  no_split       operands not split (hi = v, lo = 0); timing only
  one_pass       no split and one product per GEMM; timing only
  lane_epilogue  the S draws unrolled over a lane's column pairs, from
                 registers, in place of the loop over shared memory
  no_draws       constants in place of the Philox draws; timing only

A substitution that no longer matches the source stops the script.
"""

from __future__ import annotations

import ctypes
import re
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

CSRC = build.CSRC
OUT = ROOT / "build" / "lrt_variants"

SPLIT = """  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));"""
CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo)
      : "f"(v - __uint_as_float(hi)));"""
NO_SPLIT = """  hi = __float_as_uint(v);
  lo = 0u;"""
SMALL_PRODUCTS = re.compile(
    r"\n *mma_tf32\(p[mv]\[i\]\[j\], (?:[xq]l\[i\], [ws]h|[xq]h\[i\], [ws]l)"
    r"\[j\]\);")
DRAWS = """        const float4 a = repro::philox_normal4(
            (uint32_t)n, (uint32_t)m, (uint32_t)q, TAG_LRT, seed);
        const float4 b = repro::philox_normal4(
            (uint32_t)(n + 1), (uint32_t)m, (uint32_t)q, TAG_LRT, seed);"""
CONSTANTS = """        const float4 a = make_float4(0.5f, 0.25f, -0.5f, 1.f + q);
        const float4 b = make_float4(0.5f, 0.25f, -0.5f, 1.f - q);"""
LANE_EPILOGUE = """#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + wn * 16 + j * 8 + 2 * t;
        if (n >= N) continue;
        const float mean0 = am[i][j][2 * h], mean1 = am[i][j][2 * h + 1];
        const float v0 = av[i][j][2 * h], v1 = av[i][j][2 * h + 1];
        const float sd0 = sqrtf(v0 < 0.f ? 0.f : v0);
        const float sd1 = sqrtf(v1 < 0.f ? 0.f : v1);
        for (int q = 0; 4 * q < S; ++q) {
          float z0[4], z1[4];
          if (xi) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float2 v = make_float2(0.f, 0.f);
              if (4 * q + k < S)
                v = pair_f32(xi + ((size_t)(4 * q + k) * M + m) * N + n);
              z0[k] = v.x;
              z1[k] = v.y;
            }
          } else {
            const float4 a = repro::philox_normal4(
                (uint32_t)n, (uint32_t)m, (uint32_t)q, TAG_LRT, seed);
            const float4 b = repro::philox_normal4(
                (uint32_t)(n + 1), (uint32_t)m, (uint32_t)q, TAG_LRT, seed);
            z0[0] = a.x, z0[1] = a.y, z0[2] = a.z, z0[3] = a.w;
            z1[0] = b.x, z1[1] = b.y, z1[2] = b.z, z1[3] = b.w;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * q + k < S)
              *reinterpret_cast<float2*>(
                  y + ((size_t)(4 * q + k) * M + m) * N + n) =
                  make_float2(fmaf(sd0, z0[k], mean0), fmaf(sd1, z1[k], mean1));
        }
      }
    }
}
"""


def _epilogue(src: str) -> str:
    """The kept epilogue, from its first comment to the kernel's end."""
    a = src.index("  // the epilogue.")
    return src[a:src.index("\n}\n", a) + 3]


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the source no longer holds:\n{old}")
    return text.replace(old, new)


def variants() -> dict[str, dict[str, str]]:
    """{name: {file name: source}} for every variant."""
    cu = (CSRC / "bayes_matmul.cu").read_text()
    cuh = (CSRC / "mma_tile.cuh").read_text()
    one_pass, n = SMALL_PRODUCTS.subn("", cu)
    if n != 4:
        raise SystemExit(f"expected 4 small products, found {n}")
    return {
        "kept": {},
        "cvt_rna": {"mma_tile.cuh": _sub(cuh, SPLIT, CVT_SPLIT)},
        "no_split": {"mma_tile.cuh": _sub(cuh, SPLIT, NO_SPLIT)},
        "one_pass": {"mma_tile.cuh": _sub(cuh, SPLIT, NO_SPLIT),
                     "bayes_matmul.cu": one_pass},
        "lane_epilogue": {"bayes_matmul.cu": _sub(cu, _epilogue(cu),
                                                  LANE_EPILOGUE)},
        "no_draws": {"bayes_matmul.cu": _sub(cu, DRAWS, CONSTANTS)},
    }


def build_all() -> dict[str, ctypes.CDLL]:
    procs = {}
    for name, files in variants().items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in CSRC.iterdir():
            shutil.copy(f, d / f.name)
        for fname, text in files.items():
            (d / fname).write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "bayes_matmul.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).repro_lrt_matmul
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, ctypes.c_uint32, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times GPU kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    dev = torch.device("cuda")
    bm = C.kernel_module("bayes_matmul")
    libs = build_all()
    for M, K, N, dt in ((128, 1024, 4096, torch.float32),
                        (16, 1536, 151936, torch.bfloat16)):
        x, mu, sg, g = C.lrt_case(dev, M, K, N, dt, seed=14)
        xi = torch.randn((1, M, N), generator=g, device=dev)
        want = bm.lrt_matmul_plain(x, mu, sg, xi[0])
        calls = 10 if N < 10_000 else 3
        bufs = {s: torch.empty((s, M, N), device=dev) for s in (1, 10)}

        def run(fn, S, z):
            rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                    mu.data_ptr(), sg.data_ptr(),
                    None if z is None else z.data_ptr(), S, 21,
                    bufs[S].data_ptr(), M, K, N, 1,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")

        order = list(libs)
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                fn = libs[name]
                run(fn, 1, xi)
                torch.cuda.synchronize()
                err = float((bufs[1][0] - want).abs().max()
                            / want.abs().max())
                t1 = C.device_ms(lambda: run(fn, 1, xi), calls)
                t10 = C.device_ms(lambda: run(fn, 10, None), calls)
                print(f"M {M} K {K} N {N} {dt}, {name}, round {rnd}: "
                      f"lrt_matmul {t1:.4f} ms, S 10 seeded {t10:.4f} ms; "
                      f"max |err| {err:.3g} of max |y|", flush=True)


if __name__ == "__main__":
    main()
