"""Time variants of the seeded photonic conv kernel (``conv_sampled`` in
``src/repro_torch/kernels/csrc/photonic_conv.cu``) against each other on
one GPU, in one process.

Each variant is the kernel's source with text substitutions.  The script
builds every variant with nvcc (one process each, all at once) into
``build/conv_variants/``, prints each one's registers and spills, calls
each through the same C entry points (``repro_photonic_conv_sampled`` and
``repro_photonic_conv``, which shares the body) at B 1024, T 256 and
T 4096, C 9 (the paper phase's machine program), prints how many outputs
differ from the plain version (one ADC step each at most for the variants
that draw the kept stream) and times each by CUDA-graph replay, in turns:
every variant once, then again in reverse order.

    python3 tools/conv_variants.py

Variants:
  kept          the source as it is
  no_draws      constants in place of the Philox calls; timing only
  fast_math     the draws' logf and sincosf by the fast intrinsics __logf
                and __sincosf (a slightly different stream); timing only
  no_i2f        the words mapped to floats by their top 23 bits with a
                bit mask in place of the int->float conversion (a
                slightly different stream); timing only
  runtime_c     C 9 through the instance that reads C at run time (the
                tap loop rolled), in both kernels
  unrolled16    as runtime_c, with the tap loop unrolled over MAXC = 16
                channels, those past C predicated off
  minb6         the sampled kernel's registers capped for 6 blocks an SM
                (__launch_bounds__(SA_NT, 6))
  ex_minb8      the explicit kernel's registers capped for 8 blocks an SM
                (__launch_bounds__(EX_NT, 8))
  stage_first   the x window quantized and stored, and the moments
                stored, before the tile is filled (each thread waits for
                its loads before its first draw), in both kernels
  pr12          the design before this one, kept verbatim below: a thread
                an output, three Philox calls of four normals for its 9
                taps (12 drawn, 9 used) in registers; its stream differs,
                so timing only
  tt<TT>_nt<NT> outputs and threads a block (SA_TT, SA_NT), a sweep

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
OUT = ROOT / "build" / "conv_variants"

DRAW = """      const float4 z =
          repro::philox_normal4(q0 + k, (uint32_t)b, 0u, TAG_CONV, seed);"""
CONSTANT = "      const float4 z = make_float4(0.5f, 0.25f, -0.5f, 1.f + k);"
DISPATCH = "  if (C == 9)\n"
NO_DISPATCH = "  if (false)\n"
ROLLED = "    for (int k = 0; k < C; ++k) {"
UNROLLED = "    for (int k = 0; k < MAXC; ++k) if (k < C) {"
BOUNDS = "__global__ void __launch_bounds__(SA_NT)"
MINB6 = "__global__ void __launch_bounds__(SA_NT, 6)"
EX_BOUNDS = "__global__ void __launch_bounds__(EX_NT)"
EX_MINB8 = "__global__ void __launch_bounds__(EX_NT, 8)"
STAGE = """#pragma unroll
  for (int r = 0; r < NX; ++r) {
    const int i = tid + r * NT;
    if (i < nx) xs[i] = quant(xv[r], in_scale, in_levels);
  }
  if (tid < C) {
    wm[tid] = m;
    ws[tid] = s;
  }
"""
FILL = "  if (SAMPLED) {\n"
SIZES = "constexpr int SA_TT = 256, SA_NT = 288;"
SWEEP = ((256, 256), (256, 288), (256, 576), (128, 128), (512, 384),
         (512, 512))
LAUNCH = "    conv_sampled<9><<<grid, SA_NT, 0, (cudaStream_t)stream>>>("
PR12_LAUNCH = ("    pr12::conv_sampled<<<dim3((To + 255) / 256, B), 256, 0,"
               " (cudaStream_t)stream>>>(")
CHECK = "// the stream's counter j / 4 is 32 bits: To * C < 2^32\n"

# the sampled kernel as it was before the shared-memory eps tile, with the
# helpers it used: one thread an output, eps in registers from counters
# (t, b, c / 4)
PR12 = r'''
namespace pr12 {

constexpr int TT = 256;    // outputs per block, one per thread

// stage xq[b, t0 .. t0 + nt + C - 2] and mu / sigma; returns nt
__device__ __forceinline__ int stage(const float* __restrict__ x, int T,
                                     int To, int C,
                                     const float* __restrict__ mu,
                                     const float* __restrict__ sg,
                                     float in_scale, float in_levels,
                                     float* xs, float* wm, float* ws) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int nt = min(TT, To - t0);
  const float* xr = x + (size_t)b * T + t0;
  for (int i = threadIdx.x; i < nt + C - 1; i += TT)
    xs[i] = quant(xr[i], in_scale, in_levels);
  if (threadIdx.x < C) {
    wm[threadIdx.x] = mu[threadIdx.x];
    ws[threadIdx.x] = sg[threadIdx.x];
  }
  return nt;
}

// the tap loop over channels c = C-1 .. 0 (k = 0 .. C-1) with e[] indexed
// by compile-time c once unrolled, so it stays in registers
__device__ __forceinline__ float taps(const float* xs, const float* wm,
                                      const float* ws, const float (&e)[MAXC],
                                      int C, int tid) {
  float acc = 0.f;
#pragma unroll
  for (int c = MAXC - 1; c >= 0; --c) {
    if (c < C) {
      const float w = __fadd_rn(wm[c], __fmul_rn(ws[c], e[c]));
      acc = __fadd_rn(acc, __fmul_rn(xs[tid + C - 1 - c], w));
    }
  }
  return acc;
}

__global__ void __launch_bounds__(TT)
    conv_sampled(const float* __restrict__ x, int T, int C,
                 const float* __restrict__ mu, const float* __restrict__ sg,
                 uint32_t seed, float* __restrict__ y, float in_scale,
                 float in_levels, float out_scale, float out_levels) {
  __shared__ float xs[TT + MAXC - 1];
  __shared__ float wm[MAXC], ws[MAXC];
  const int To = T - C + 1;
  const int tid = threadIdx.x;
  const int nt =
      stage(x, T, To, C, mu, sg, in_scale, in_levels, xs, wm, ws);
  __syncthreads();
  if (tid >= nt) return;
  const uint32_t t = blockIdx.x * TT + tid;
  const uint32_t b = blockIdx.y;
  float e[MAXC];
#pragma unroll
  for (int g = 0; g < MAXC / 4; ++g) {
    float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * g < C) z = repro::philox_normal4(t, b, (uint32_t)g, TAG_CONV, seed);
    e[4 * g] = z.x;
    e[4 * g + 1] = z.y;
    e[4 * g + 2] = z.z;
    e[4 * g + 3] = z.w;
  }
  y[(size_t)b * To + t] =
      quant(taps(xs, wm, ws, e, C, tid), out_scale, out_levels);
}

}  // namespace pr12

'''


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the source no longer holds:\n{old}")
    return text.replace(old, new)


def variants() -> dict[str, dict[str, str]]:
    """{name: {file name: source}} for every variant."""
    cu = (CSRC / "photonic_conv.cu").read_text()
    philox = (CSRC / "philox.cuh").read_text()
    fast = philox
    for old, new in (("sqrtf(-2.0f * logf(", "__fsqrt_rn(-2.0f * __logf("),
                     ("sincosf(", "__sincosf(")):
        fast = _sub(fast, old, new)
    no_i2f = philox
    for w in ("x", "y", "z", "w"):
        no_i2f = _sub(no_i2f, f"(float)(o.{w} >> 8) * (1.0f / 16777216.0f)",
                      f"(__uint_as_float(0x3f800000u | (o.{w} >> 9)) - 1.0f)")
    out = {"kept": {"photonic_conv.cu": cu},
           "no_draws": {"photonic_conv.cu": _sub(cu, DRAW, CONSTANT)},
           "fast_math": {"philox.cuh": fast},
           "no_i2f": {"philox.cuh": no_i2f},
           "runtime_c": {"photonic_conv.cu": _sub(cu, DISPATCH,
                                                  NO_DISPATCH)},
           "unrolled16": {"photonic_conv.cu": _sub(_sub(
               cu, DISPATCH, NO_DISPATCH), ROLLED, UNROLLED)},
           "minb6": {"photonic_conv.cu": _sub(cu, BOUNDS, MINB6)},
           "ex_minb8": {"photonic_conv.cu": _sub(cu, EX_BOUNDS, EX_MINB8)},
           "stage_first": {"photonic_conv.cu": _sub(_sub(cu, STAGE, ""),
                                                    FILL, STAGE + FILL)},
           "pr12": {"photonic_conv.cu": _sub(_sub(cu, CHECK, PR12 + CHECK),
                                             LAUNCH, PR12_LAUNCH)}}
    _sub(cu, SIZES, SIZES)
    for tt, nt in SWEEP:
        if f"SA_TT = {tt}, SA_NT = {nt};" not in cu:
            out[f"tt{tt}_nt{nt}"] = {"photonic_conv.cu": _sub(
                cu, SIZES, f"constexpr int SA_TT = {tt}, SA_NT = {nt};")}
    return out


def ptxas_lines(log: str) -> str:
    """Registers and spills of each kernel in nvcc's -Xptxas -v log."""
    out, name, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = C.kernel_name(line.split("'")[1])
        elif "spill" in line:
            spills = line.split(",", 1)[1].strip()
        elif "registers" in line and name:
            regs = line.split(":", 1)[1].split(",")[0].strip()
            out.append(f"{name} {regs}, {spills}")
    return "; ".join(out)


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
               str(d / "photonic_conv.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        print(f"  {name}: {ptxas_lines(log)}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.repro_photonic_conv_sampled, lib.repro_photonic_conv):
            fn.argtypes = [p, i, i, p, p, i, p, ctypes.c_uint32, p, f, f, f,
                           f, p]
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
    pc = C.kernel_module("photonic_conv")
    libs = build_all()
    for T in (256, 4096):
        B, Cn = 1024, 9
        x, mu, sg, g = C.conv_case(dev, B, T)
        eps = torch.randn((B, T - Cn + 1, Cn), generator=g, device=dev)
        want = {"sampled": pc.photonic_conv_plain(x, mu, sg, seed=7),
                "explicit": pc.photonic_conv_plain(x, mu, sg, eps)}
        y = torch.empty_like(want["sampled"])
        calls = 20 if T == 256 else 4

        def run(lib, kind):
            fn = (lib.repro_photonic_conv_sampled if kind == "sampled"
                  else lib.repro_photonic_conv)
            rc = fn(x.data_ptr(), B, T, mu.data_ptr(), sg.data_ptr(), Cn,
                    eps.data_ptr(), 7, y.data_ptr(), 1.0 / 127, 127.0,
                    4.0 / 127, 127.0, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")

        order = list(libs)
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                for kind in ("sampled", "explicit"):
                    run(libs[name], kind)
                    torch.cuda.synchronize()
                    flips = int(((y - want[kind]).abs() > 0).sum())
                    ms = C.device_ms(lambda: run(libs[name], kind), calls)
                    print(f"  B={B} T={T} {name} {kind} (turn {rnd + 1}): "
                          f"{ms:.4f} ms, {B * (T - Cn + 1) / ms / 1e6:.4f} "
                          f"Gconv/s, {flips} of {y.numel()} outputs off the "
                          "plain version", flush=True)


if __name__ == "__main__":
    main()
