// The photonic machine's primitive, a 9-tap probabilistic convolution,
// for sm_90a.
//
// Replaces: repro/kernels/photonic_conv.py::photonic_conv_kernel (body
// _photonic_conv_kernel, explicit eps operand) and
// photonic_conv_fused_kernel (body _photonic_conv_fused_kernel, eps drawn
// in the kernel by pltpu.prng_random_bits + Box-Muller).
//
// Computes, for x (B, T), channel moments mu/sigma (C,), To = T - C + 1:
//   xq = clip(rint(x / s_in), -L_in, L_in) * s_in           (DAC)
//   acc = sum_{k=0..C-1} xq[b, t+k] * (mu[c] + sigma[c] * eps[b, t, c]),
//         c = C - 1 - k  (the chirped grating's one-symbol delay)
//   y[b, t] = clip(rint(acc / s_out), -L_out, L_out) * s_out  (ADC)
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA contraction) in the order k = 0..C-1, and quantization divides by
// the scale (rint: half to even), as the plain version does: a sum that
// lands near an ADC level then rounds the same way in both.
//
// What bounds it: photonic_conv reads x and the (B, To, C) eps operand and
// writes y, C + 2 floats per output and 9 + 2 flops per tap pair, far below
// the card's operations-per-byte line: it is bound by memory, and eps is
// ~80% of the bytes.  The design stages each block's x window and its
// (256, C) eps tile in shared memory with contiguous, coalesced loads (the
// eps rows are C = 9 floats apart, so a thread reading its own row would
// hit a new 32-byte sector per tap), and quantizes each x once per block.
// photonic_conv_sampled moves only x and y: it draws eps in registers
// from Philox4x32-10 (TAG_CONV stream, counter (t, b, c / 4), four normals
// per call, three calls per output at C = 9), so ~300 integer operations
// and a dozen special-function operations per output set its time, not
// memory.  Ragged To (the last block of a row) is masked in the kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int TT = 256;    // outputs per block, one per thread
constexpr int MAXC = 16;   // most channels
constexpr uint32_t TAG_CONV = 3;

__device__ __forceinline__ float quant(float v, float scale, float levels) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -levels), levels);
  return __fmul_rn(q, scale);
}

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
    conv_explicit(const float* __restrict__ x, int T, int C,
                  const float* __restrict__ mu, const float* __restrict__ sg,
                  const float* __restrict__ eps, float* __restrict__ y,
                  float in_scale, float in_levels, float out_scale,
                  float out_levels) {
  __shared__ float xs[TT + MAXC - 1];
  __shared__ float es[TT * MAXC];
  __shared__ float wm[MAXC], ws[MAXC];
  const int To = T - C + 1;
  const int tid = threadIdx.x;
  const int nt =
      stage(x, T, To, C, mu, sg, in_scale, in_levels, xs, wm, ws);
  const size_t row0 = (size_t)blockIdx.y * To + (size_t)blockIdx.x * TT;
  const float* er = eps + row0 * C;
  for (int i = tid; i < nt * C; i += TT) es[i] = er[i];
  __syncthreads();
  if (tid >= nt) return;
  float e[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) e[c] = c < C ? es[tid * C + c] : 0.f;
  y[row0 + tid] = quant(taps(xs, wm, ws, e, C, tid), out_scale, out_levels);
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

int check(int B, int T, int C) {
  if (B < 1 || B > 65535 || C < 1 || C > MAXC || T < C)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched).  x
// (B, T), mu/sigma (C,), eps (B, T - C + 1, C) and y (B, T - C + 1) are
// contiguous float32; seed is unused by the explicit kernel and eps by the
// sampled one.
extern "C" int repro_photonic_conv(const float* x, int B, int T,
                                   const float* mu, const float* sigma, int C,
                                   const float* eps, uint32_t seed, float* y,
                                   float in_scale, float in_levels,
                                   float out_scale, float out_levels,
                                   void* stream) {
  (void)seed;
  if (int e = check(B, T, C)) return e;
  if (!eps) return (int)cudaErrorInvalidValue;
  const int To = T - C + 1;
  const dim3 grid((To + TT - 1) / TT, B);
  conv_explicit<<<grid, TT, 0, (cudaStream_t)stream>>>(
      x, T, C, mu, sigma, eps, y, in_scale, in_levels, out_scale, out_levels);
  return (int)cudaGetLastError();
}

extern "C" int repro_photonic_conv_sampled(const float* x, int B, int T,
                                           const float* mu,
                                           const float* sigma, int C,
                                           const float* eps, uint32_t seed,
                                           float* y, float in_scale,
                                           float in_levels, float out_scale,
                                           float out_levels, void* stream) {
  (void)eps;
  if (int e = check(B, T, C)) return e;
  const int To = T - C + 1;
  const dim3 grid((To + TT - 1) / TT, B);
  conv_sampled<<<grid, TT, 0, (cudaStream_t)stream>>>(
      x, T, C, mu, sigma, seed, y, in_scale, in_levels, out_scale,
      out_levels);
  return (int)cudaGetLastError();
}
