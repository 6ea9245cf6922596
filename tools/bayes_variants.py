"""Time variants of the tensor-core weight-space kernel (``bayes_gemm_mma``
in ``src/repro_torch/kernels/csrc/bayes_matmul.cu``) against each other on
one GPU, in one process.

Each variant is the kernel's source with text substitutions.  The script
builds every variant with nvcc (one process each, all at once) into
``build/bayes_variants/``, calls each through the same C entry points
(``repro_bayes_matmul_sampled`` and ``repro_bayes_matmul``, route 1),
prints each one's error against the plain f32 version (large for the
timing-only variants), and times each by CUDA-graph replay, in turns:
every variant once, then again in reverse order.

    python3 tools/bayes_variants.py

Variants:
  kept       the source as it is
  no_draws   constants in place of the Philox draws; timing only
  no_form    W_s formed for the first k tile only (the MMAs of the others
             read whatever shared memory holds); timing only
  no_shift   every warp takes the products first, then the next W_s
  kk_rolled  the k8 steps of a k tile in a loop that is not unrolled
  no_mma     no products (the sums stay zero); timing only
  one_pass   one product (hi*hi) in place of three; timing only
  fast_math  the draws' logf and sincosf by the fast intrinsics __logf
             and __sincosf (a slightly different stream); timing only

A substitution that no longer matches the source stops the script.
"""

from __future__ import annotations

import ctypes
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
OUT = ROOT / "build" / "bayes_variants"

DRAW = """          const float4 v = repro::philox_normal4(
              (uint32_t)n, (uint32_t)k, (uint32_t)q, TAG_BAYES, seed);"""
CONSTANT = ("          const float4 v = "
            "make_float4(0.5f, 0.25f, -0.5f, 1.f + q);")
FORM = """        if (kt + 1 < nkt) form(st, kt + 1, (kt + 1) & 1);
"""
SHIFT = "const bool form_first = warp & 4;"
KK_UNROLLED = """#pragma unroll
    for (int kk = 0; kk < BG_BK / 8; ++kk) {"""
KK_ROLLED = """#pragma unroll 1
    for (int kk = 0; kk < BG_BK / 8; ++kk) {"""
NO_SHIFT = "const bool form_first = false;"
SMALL = """      // the small products of every sample, then the big ones
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(acc[j][i], al[i], bh[j]);
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(acc[j][i], ah[i], bl[j]);
"""
BIG = """#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(acc[j][i], ah[i], bh[j]);
"""
# the cases: (name, M, K, N, S, eps kind: "seeded", "eps" or "single")
CASES = (("M 128 S 10 seeded", 128, 1024, 4096, 10, "seeded"),
         ("M 128 S 10 eps", 128, 1024, 4096, 10, "eps"),
         ("M 128 one draw", 128, 1024, 4096, 1, "single"),
         ("im2col S 10 seeded", 156_800, 171, 32, 10, "seeded"))


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the source no longer holds:\n{old}")
    return text.replace(old, new)


def variants() -> dict[str, dict[str, str]]:
    """{name: {file name: source}} for every variant."""
    cu = (CSRC / "bayes_matmul.cu").read_text()
    philox = (CSRC / "philox.cuh").read_text()
    fast = philox
    for old, new in (("sqrtf(-2.0f * logf(", "__fsqrt_rn(-2.0f * __logf("),
                     ("sincosf(", "__sincosf(")):
        fast = _sub(fast, old, new)
    return {name: {"bayes_matmul.cu": text} for name, text in {
        "kept": cu,
        "no_draws": _sub(cu, DRAW, CONSTANT),
        "no_form": _sub(cu, FORM, ""),
        "no_shift": _sub(cu, SHIFT, NO_SHIFT),
        "kk_rolled": _sub(cu, KK_UNROLLED, KK_ROLLED),
        "no_mma": _sub(cu, SMALL + BIG, ""),
        "one_pass": _sub(cu, SMALL, ""),
    }.items()} | {"fast_math": {"philox.cuh": fast}}


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
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.repro_bayes_matmul, lib.repro_bayes_matmul_sampled):
            fn.argtypes = [p, p, p, p, i, ctypes.c_uint32, p, i, i, i, i, p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times GPU kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    dev = torch.device("cuda")
    import repro_torch  # noqa: F401  (pins the precision flags)
    bm = C.kernel_module("bayes_matmul")
    libs = build_all()
    for label, M, K, N, S, kind in CASES:
        x, mu, sg, g = C.gemm_case(dev, M, K, N, seed=6)
        eps = None
        if kind != "seeded":
            eps = torch.randn((S, K, N), generator=g, device=dev)
        want = bm.bayes_matmul_sampled_plain(x, mu, sg, num_samples=S,
                                             eps=eps, seed=3)
        y = torch.empty((S, M, N), device=dev)
        calls = 10 if M <= 4096 else 3

        def run(lib):
            fn = (lib.repro_bayes_matmul if kind == "single"
                  else lib.repro_bayes_matmul_sampled)
            rc = fn(x.data_ptr(), mu.data_ptr(), sg.data_ptr(),
                    None if eps is None else eps.data_ptr(), S, 3,
                    y.data_ptr(), M, K, N, 1,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")

        order = list(libs)
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                run(libs[name])
                torch.cuda.synchronize()
                err = float((y - want).abs().max() / want.abs().max())
                ms = C.device_ms(lambda: run(libs[name]), calls)
                print(f"  {label} {name} (turn {rnd + 1}): {ms:.4f} ms, "
                      f"{err:.3g} of max |y|", flush=True)


if __name__ == "__main__":
    main()
