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
// Both kernels run one body (conv_block): a block of TT outputs of one
// row stages its quantized x window and fills a (TT, C) eps tile in
// shared memory, then its threads run the tap loop over that tile and
// the ADC.  Only the filling differs.  C 9, the machine's channel count,
// runs an instance with C fixed at compile time (a tap loop unrolled
// whole, and fewer registers); any other C up to MAXC runs the instance
// that reads C at run time, with the tap loop rolled.
//
// photonic_conv (conv_explicit) reads x and the (B, To, C) eps operand
// and writes y, C + 2 floats per output: it is bound by memory, and eps
// is ~80% of the bytes.  The block copies its eps rows, contiguous and
// coalesced (a thread reading its own row would hit a new 32-byte sector
// per tap), and quantizes each x once.
//
// photonic_conv_sampled (conv_sampled) moves only x and y and draws eps
// from Philox4x32-10, so the draws' integer and special-function work
// sets its time.  The TAG_CONV stream is the (B, To, C) eps operand drawn
// four normals a call in row-major order: normal j = t * C + c of row b
// is element j % 4 (r0 cos, r0 sin, r1 cos, r1 sin) of the call with
// counter (j / 4, b, 0, TAG_CONV) and key (seed, 0)
// (repro_torch/kernels/rng.py::conv_normal is the twin).  So an output
// takes exactly C normals, C / 4 calls, none thrown away.  The block's
// threads share its calls, each thread making whole calls and storing
// each call's four normals into the eps tile as one 16-byte store: TT is
// a multiple of 4, so a block's first normal starts a call, and only a
// row's last call can run past the row's end (it is drawn whole and
// stored in part).  Ragged To (the last block of a row) is masked.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int MAXC = 16;   // most channels
constexpr uint32_t TAG_CONV = 3;
// outputs and threads a block: the explicit kernel one output a thread;
// the sampled kernel from tools/conv_variants.py's sweep
constexpr int EX_TT = 256, EX_NT = 256;
constexpr int SA_TT = 256, SA_NT = 288;

__device__ __forceinline__ float quant(float v, float scale, float levels) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -levels), levels);
  return __fmul_rn(q, scale);
}

// CC: the channel count fixed at compile time, or 0 to read Cn
template <int TT, int NT, int CC, bool SAMPLED>
__device__ __forceinline__ void conv_block(
    const float* __restrict__ x, int T, int Cn,
    const float* __restrict__ mu, const float* __restrict__ sg,
    const float* __restrict__ eps, uint32_t seed, float* __restrict__ y,
    float in_scale, float in_levels, float out_scale, float out_levels) {
  static_assert(TT % 4 == 0, "a block's first normal must start a call");
  constexpr int NC = CC ? CC : MAXC;
  __shared__ float xs[TT + NC - 1];
  __shared__ __align__(16) float es[TT * NC];
  __shared__ float wm[NC], ws[NC];
  const int C = CC ? CC : Cn;
  const int To = T - C + 1;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int nt = min(TT, To - t0);
  const int n = nt * C;           // the block's normals
  const float* xr = x + (size_t)b * T + t0;
  const int nx = nt + C - 1;      // the block's x window
  // the loads of the x window and the moments are issued first and used
  // after the tile is filled, so their latency hides behind the fill
  constexpr int NX = (TT + NC - 1 + NT - 1) / NT;
  float xv[NX];
#pragma unroll
  for (int r = 0; r < NX; ++r) {
    const int i = tid + r * NT;
    xv[r] = i < nx ? xr[i] : 0.f;
  }
  const float m = tid < C ? mu[tid] : 0.f;
  const float s = tid < C ? sg[tid] : 0.f;
  const size_t row0 = (size_t)b * To + t0;
  if (SAMPLED) {
    const uint32_t q0 = (uint32_t)t0 * (uint32_t)C / 4;
    for (int k = tid; 4 * k < n; k += NT) {
      const float4 z =
          repro::philox_normal4(q0 + k, (uint32_t)b, 0u, TAG_CONV, seed);
      float* e = es + 4 * k;
      if (4 * k + 4 <= n) {
        *reinterpret_cast<float4*>(e) = z;
      } else {                    // the row's last call
        e[0] = z.x;
        if (4 * k + 1 < n) e[1] = z.y;
        if (4 * k + 2 < n) e[2] = z.z;
      }
    }
  } else {
    const float* er = eps + row0 * C;
    for (int i = tid; i < n; i += NT) es[i] = er[i];
  }
#pragma unroll
  for (int r = 0; r < NX; ++r) {
    const int i = tid + r * NT;
    if (i < nx) xs[i] = quant(xv[r], in_scale, in_levels);
  }
  if (tid < C) {
    wm[tid] = m;
    ws[tid] = s;
  }
  __syncthreads();
  for (int o = tid; o < nt; o += NT) {
    const float* e = es + o * C;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = C - 1 - k;
      const float w = __fadd_rn(wm[c], __fmul_rn(ws[c], e[c]));
      acc = __fadd_rn(acc, __fmul_rn(xs[o + k], w));
    }
    y[row0 + o] = quant(acc, out_scale, out_levels);
  }
}

template <int CC>
__global__ void __launch_bounds__(EX_NT)
    conv_explicit(const float* __restrict__ x, int T, int C,
                  const float* __restrict__ mu, const float* __restrict__ sg,
                  const float* __restrict__ eps, float* __restrict__ y,
                  float in_scale, float in_levels, float out_scale,
                  float out_levels) {
  conv_block<EX_TT, EX_NT, CC, false>(x, T, C, mu, sg, eps, 0u, y,
                                      in_scale, in_levels, out_scale,
                                      out_levels);
}

template <int CC>
__global__ void __launch_bounds__(SA_NT)
    conv_sampled(const float* __restrict__ x, int T, int C,
                 const float* __restrict__ mu, const float* __restrict__ sg,
                 uint32_t seed, float* __restrict__ y, float in_scale,
                 float in_levels, float out_scale, float out_levels) {
  conv_block<SA_TT, SA_NT, CC, true>(x, T, C, mu, sg, nullptr, seed, y,
                                     in_scale, in_levels, out_scale,
                                     out_levels);
}

// the stream's counter j / 4 is 32 bits: To * C < 2^32
int check(int B, int T, int C) {
  if (B < 1 || B > 65535 || C < 1 || C > MAXC || T < C ||
      (uint64_t)(T - C + 1) * C >= (1ull << 32))
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
  const dim3 grid((To + EX_TT - 1) / EX_TT, B);
  if (C == 9)
    conv_explicit<9><<<grid, EX_NT, 0, (cudaStream_t)stream>>>(
        x, T, C, mu, sigma, eps, y, in_scale, in_levels, out_scale,
        out_levels);
  else
    conv_explicit<0><<<grid, EX_NT, 0, (cudaStream_t)stream>>>(
        x, T, C, mu, sigma, eps, y, in_scale, in_levels, out_scale,
        out_levels);
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
  const dim3 grid((To + SA_TT - 1) / SA_TT, B);
  if (C == 9)
    conv_sampled<9><<<grid, SA_NT, 0, (cudaStream_t)stream>>>(
        x, T, C, mu, sigma, seed, y, in_scale, in_levels, out_scale,
        out_levels);
  else
    conv_sampled<0><<<grid, SA_NT, 0, (cudaStream_t)stream>>>(
        x, T, C, mu, sigma, seed, y, in_scale, in_levels, out_scale,
        out_levels);
  return (int)cudaGetLastError();
}
