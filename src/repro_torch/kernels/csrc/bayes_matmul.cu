// The sampled-weight GEMM and the local-reparameterization (LRT) GEMM,
// for sm_90a.
//
// Replaces: repro/kernels/bayes_matmul.py::bayes_matmul_kernel (body
// _bayes_mm_kernel: one draw, explicit eps), bayes_matmul_fused_kernel
// (body _bayes_mm_fused_kernel: S weight-space samples per pass, eps
// explicit or drawn in the kernel by pltpu.prng_random_bits + Box-Muller),
// lrt_matmul_kernel (body _lrt_mm_kernel: one output-space draw, explicit
// xi) and lrt_matmul_fused_kernel (body _lrt_mm_fused_kernel: S samples
// from one mean and one variance GEMM, xi explicit or drawn in the kernel).
//
// Computes, for x (M, K), mu/sigma (K, N):
//   bayes_matmul          y = x @ W,  W = mu + sigma * eps,  eps (K, N)
//   bayes_matmul_sampled  y_s = x @ W_s, W_s = mu + sigma * eps_s, s < S,
//                         eps (S, K, N) or the TAG_BAYES Philox stream
// in float32 on the CUDA cores: no tensor cores, no TF32.  W is formed
// with __fmul_rn / __fadd_rn, so it equals the plain version's W bit for
// bit; the products accumulate with FMA in K order within a thread.
//
// What bounds it: at the benchmark shape (M 128, K 1024, N 4096) the
// single draw moves mu, sigma and eps (three K x N operands, 50 MB) for
// 2*M*K*N flops: near the card's f32 line, so bytes and f32 operations
// bound it about equally.  The sampled kernel reads mu/sigma ONCE for all
// S samples (the TPU kernel's point) and forms every W_s tile in shared
// memory from that one read, so its bound is the S-fold f32 work.
//
// Design: a block owns a (64 x 64) output tile (single draw) or a
// (64 x 32) tile with all S samples (sampled: S <= 16 accumulators per
// output, 8 outputs per thread, up to 128 accumulator registers).  K
// advances in tiles of 16: the x tile is staged transposed, the W tiles
// are formed while staging, then each thread accumulates its outputs.
// Ragged M, K and N are masked (zero-filled W and x, masked stores).  The
// in-kernel variates are keyed by the weight element alone, counter
// (n, k, s / 4, TAG_BAYES) with four normals per Philox call, so every
// row block draws the SAME W_s (one sampled weight matrix per sample, as
// repro/kernels/bayes_matmul.py:186-189 requires).  The price: each of the ceil(M/64)
// row blocks redraws the variates of its column block.  At the im2col
// shape (M 156,800) that is 2,450 redraws of each variate; keeping W_s
// drawn once in device memory would trade that Philox work for S*K*N*4
// bytes of reads per row block.
//
// The LRT GEMM (lrt_gemm below, one kernel behind both LRT entry points):
//   y_s = x@mu + sqrt(max((x*x)@sigma^2, 0)) * xi_s,  s < S (S = 1 with an
//   explicit (M, N) xi for the single draw; xi (S, M, N) or the TAG_LRT
//   Philox stream, counter (n, m, s / 4, TAG_LRT), for the S-sample GEMM).
// The S samples share the two GEMMs and differ only in the epilogue, so
// the kernel keeps two f32 accumulators per output (mean, variance), not
// S, and S is a loop bound, not a template argument.  What bounds it: at
// the head's shape (M 4, K 1536, N 151936) reading mu and sigma once,
// 1.87 GB; at bench_kernels' shape (M 128, K 1024, N 4096) the two f32
// GEMMs (2.15 GFLOP).  Design: as the head's pass 1, each thread owns one
// output column and MR rows (4, 8 or 16, the least that covers M, so a
// small M wastes no FMAs); x and x*x are staged in shared memory in K
// chunks, and each thread streams its column of mu and sigma from device
// memory once per row block, coalesced across the warp, squaring sigma in
// the load (no sigma^2 tensor).  Ragged M, K and N are masked, not
// padded; x may be float32 or bfloat16, mu and sigma are float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "philox.cuh"

namespace {

constexpr int NT = 256;    // threads per block
constexpr int BM = 64;     // rows per block
constexpr int BK = 16;     // K tile
constexpr int BN1 = 64;    // columns per block, single draw
constexpr int BN2 = 32;    // columns per block, sampled
constexpr int MAXS = 16;   // most samples per call
constexpr uint32_t TAG_BAYES = 2;

// stage x[m0:m0+64, k0:k0+16] transposed into xs[k][m], zero outside
__device__ __forceinline__ void stage_x(const float* __restrict__ x, int M,
                                       int K, int m0, int k0,
                                       float (*xs)[BM + 1]) {
#pragma unroll
  for (int r = 0; r < BM * BK / NT; ++r) {
    const int i = threadIdx.x + r * NT;
    const int row = i / BK, kk = i % BK;
    const int m = m0 + row, k = k0 + kk;
    xs[kk][row] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
  }
}

__global__ void __launch_bounds__(NT)
    mm_explicit(const float* __restrict__ x, const float* __restrict__ mu,
                const float* __restrict__ sg, const float* __restrict__ eps,
                float* __restrict__ y, int M, int K, int N) {
  __shared__ float xs[BK][BM + 1];
  __shared__ __align__(16) float ws[BK][BN1];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN1;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_x(x, M, K, m0, k0, xs);
#pragma unroll
    for (int r = 0; r < BK * BN1 / NT; ++r) {
      const int i = tid + r * NT;
      const int kk = i / BN1, col = i % BN1;
      const int k = k0 + kk, n = n0 + col;
      float w = 0.f;
      if (k < K && n < N) {
        const size_t at = (size_t)k * N + n;
        w = __fadd_rn(mu[at], __fmul_rn(sg[at], eps[at]));
      }
      ws[kk][col] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = xs[kk][ty * 4 + i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(NT)
    mm_sampled(const float* __restrict__ x, const float* __restrict__ mu,
               const float* __restrict__ sg, const float* __restrict__ eps,
               int S, uint32_t seed, float* __restrict__ y, int M, int K,
               int N) {
  __shared__ float xs[BK][BM + 1];
  __shared__ __align__(16) float ws[NS][BK][BN2];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN2;
  const int ty = tid / 8, tx = tid % 8;   // rows ty*2 + {0,1}, cols tx*4 + j
  float acc[NS][2][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_x(x, M, K, m0, k0, xs);
    // one read of each mu/sigma element, then all S perturbed copies
#pragma unroll
    for (int r = 0; r < BK * BN2 / NT; ++r) {
      const int i = tid + r * NT;
      const int kk = i / BN2, col = i % BN2;
      const int k = k0 + kk, n = n0 + col;
      const bool ok = k < K && n < N;
      const size_t at = (size_t)k * N + n;
      const float m = ok ? mu[at] : 0.f;
      const float sd = ok ? sg[at] : 0.f;
#pragma unroll
      for (int g = 0; g < NS / 4; ++g) {
        if (4 * g >= S) continue;
        float z[4] = {0.f, 0.f, 0.f, 0.f};
        if (ok && eps) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * g + j < S)
              z[j] = eps[((size_t)(4 * g + j) * K + k) * N + n];
        } else if (ok) {
          const float4 v = repro::philox_normal4(
              (uint32_t)n, (uint32_t)k, (uint32_t)g, TAG_BAYES, seed);
          z[0] = v.x;
          z[1] = v.y;
          z[2] = v.z;
          z[3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ws[4 * g + j][kk][col] =
              ok ? __fadd_rn(m, __fmul_rn(sd, z[j])) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = xs[kk][ty * 2];
      const float a1 = xs[kk][ty * 2 + 1];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s >= S) continue;
        const float4 b = *reinterpret_cast<const float4*>(&ws[s][kk][tx * 4]);
        acc[s][0][0] = fmaf(a0, b.x, acc[s][0][0]);
        acc[s][0][1] = fmaf(a0, b.y, acc[s][0][1]);
        acc[s][0][2] = fmaf(a0, b.z, acc[s][0][2]);
        acc[s][0][3] = fmaf(a0, b.w, acc[s][0][3]);
        acc[s][1][0] = fmaf(a1, b.x, acc[s][1][0]);
        acc[s][1][1] = fmaf(a1, b.y, acc[s][1][1]);
        acc[s][1][2] = fmaf(a1, b.z, acc[s][1][2]);
        acc[s][1][3] = fmaf(a1, b.w, acc[s][1][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s >= S) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + ty * 2 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < N) y[((size_t)s * M + m) * N + n] = acc[s][i][j];
      }
    }
  }
}

constexpr int LT = 128;            // LRT: columns per block, one per thread
constexpr int LKC = 64;            // LRT: K chunk of x staged in shared memory
constexpr int MAX_LRT_SAMPLES = 1024;
constexpr uint32_t TAG_LRT = 4;

using repro::to_f32;

template <typename XT, int MR>
__global__ void __launch_bounds__(LT)
    lrt_gemm(const XT* __restrict__ x, const float* __restrict__ mu,
             const float* __restrict__ sg, const float* __restrict__ xi,
             int S, uint32_t seed, float* __restrict__ y, int M, int K,
             int N) {
  __shared__ float4 xs[LKC][MR / 4];
  __shared__ float4 x2s[LKC][MR / 4];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * LT + tid;
  const int m0 = blockIdx.y * MR;
  const bool col_ok = n < N;
  float am[MR], av[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    am[r] = 0.f;
    av[r] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += LKC) {
    __syncthreads();
    for (int i = tid; i < MR * LKC; i += LT) {
      const int r = i % MR, kk = i / MR;
      const int m = m0 + r, k = k0 + kk;
      const float v = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
      reinterpret_cast<float*>(&xs[kk][0])[r] = v;
      reinterpret_cast<float*>(&x2s[kk][0])[r] = v * v;
    }
    __syncthreads();
    const int kn = min(LKC, K - k0);
    if (col_ok) {
      const float* mup = mu + (size_t)k0 * N + n;
      const float* sgp = sg + (size_t)k0 * N + n;
#pragma unroll 8
      for (int kk = 0; kk < kn; ++kk) {
        const float w = __ldg(mup + (size_t)kk * N);
        const float sd = __ldg(sgp + (size_t)kk * N);
        const float s2 = sd * sd;
#pragma unroll
        for (int r4 = 0; r4 < MR / 4; ++r4) {
          const float4 a = xs[kk][r4];
          const float4 b = x2s[kk][r4];
          am[4 * r4 + 0] = fmaf(a.x, w, am[4 * r4 + 0]);
          am[4 * r4 + 1] = fmaf(a.y, w, am[4 * r4 + 1]);
          am[4 * r4 + 2] = fmaf(a.z, w, am[4 * r4 + 2]);
          am[4 * r4 + 3] = fmaf(a.w, w, am[4 * r4 + 3]);
          av[4 * r4 + 0] = fmaf(b.x, s2, av[4 * r4 + 0]);
          av[4 * r4 + 1] = fmaf(b.y, s2, av[4 * r4 + 1]);
          av[4 * r4 + 2] = fmaf(b.z, s2, av[4 * r4 + 2]);
          av[4 * r4 + 3] = fmaf(b.w, s2, av[4 * r4 + 3]);
        }
      }
    }
  }
  if (!col_ok) return;
  // the epilogue: S outputs per (m, n) from one mean and one std
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int m = m0 + r;
    if (m >= M) continue;
    const float mean = am[r];
    const float sd = sqrtf(av[r] < 0.f ? 0.f : av[r]);  // NaN stays NaN
    for (int g = 0; 4 * g < S; ++g) {
      float z[4];
      if (xi) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          z[j] = 4 * g + j < S ? xi[((size_t)(4 * g + j) * M + m) * N + n]
                               : 0.f;
      } else {
        const float4 v = repro::philox_normal4(
            (uint32_t)n, (uint32_t)m, (uint32_t)g, TAG_LRT, seed);
        z[0] = v.x;
        z[1] = v.y;
        z[2] = v.z;
        z[3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < S)
          y[((size_t)(4 * g + j) * M + m) * N + n] = fmaf(sd, z[j], mean);
    }
  }
}

template <typename XT>
int launch_lrt(const XT* x, const float* mu, const float* sigma,
               const float* xi, int S, uint32_t seed, float* y, int M, int K,
               int N, cudaStream_t st) {
  const int mr = M <= 4 ? 4 : M <= 8 ? 8 : 16;
  const dim3 grid((N + LT - 1) / LT, (M + mr - 1) / mr);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (mr == 4)
    lrt_gemm<XT, 4><<<grid, LT, 0, st>>>(x, mu, sigma, xi, S, seed, y, M, K,
                                         N);
  else if (mr == 8)
    lrt_gemm<XT, 8><<<grid, LT, 0, st>>>(x, mu, sigma, xi, S, seed, y, M, K,
                                         N);
  else
    lrt_gemm<XT, 16><<<grid, LT, 0, st>>>(x, mu, sigma, xi, S, seed, y, M,
                                          K, N);
  return (int)cudaGetLastError();
}

bool bad_shape(int M, int K, int N) {
  return M < 1 || K < 1 || N < 1 || (N + BN2 - 1) / BN2 > 65535;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched).  All
// operands are contiguous float32: x (M, K), mu/sigma (K, N), y (M, N) or
// (S, M, N); eps is (K, N) for the single draw and (S, K, N) or null (the
// in-kernel stream keyed by seed) for the sampled kernel.
extern "C" int repro_bayes_matmul(const float* x, const float* mu,
                                  const float* sigma, const float* eps,
                                  int S, uint32_t seed, float* y, int M,
                                  int K, int N, void* stream) {
  (void)S;
  (void)seed;
  if (bad_shape(M, K, N) || !eps) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN1 - 1) / BN1);
  mm_explicit<<<grid, NT, 0, (cudaStream_t)stream>>>(x, mu, sigma, eps, y,
                                                     M, K, N);
  return (int)cudaGetLastError();
}

extern "C" int repro_bayes_matmul_sampled(const float* x, const float* mu,
                                          const float* sigma,
                                          const float* eps, int S,
                                          uint32_t seed, float* y, int M,
                                          int K, int N, void* stream) {
  if (bad_shape(M, K, N) || S < 1 || S > MAXS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN2 - 1) / BN2);
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 4)
    mm_sampled<4><<<grid, NT, 0, st>>>(x, mu, sigma, eps, S, seed, y, M, K, N);
  else if (S <= 8)
    mm_sampled<8><<<grid, NT, 0, st>>>(x, mu, sigma, eps, S, seed, y, M, K, N);
  else if (S <= 12)
    mm_sampled<12><<<grid, NT, 0, st>>>(x, mu, sigma, eps, S, seed, y, M, K,
                                        N);
  else
    mm_sampled<16><<<grid, NT, 0, st>>>(x, mu, sigma, eps, S, seed, y, M, K,
                                        N);
  return (int)cudaGetLastError();
}

// The LRT GEMM: x (M, K) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1),
// mu/sigma (K, N) float32, y (S, M, N) float32, all contiguous; xi is
// (S, M, N) or null (the in-kernel TAG_LRT stream keyed by seed).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_lrt_matmul(const void* x, int x_bf16, const float* mu,
                                const float* sigma, const float* xi, int S,
                                uint32_t seed, float* y, int M, int K, int N,
                                void* stream) {
  if (M < 1 || K < 1 || N < 1 || S < 1 || S > MAX_LRT_SAMPLES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return launch_lrt((const __nv_bfloat16*)x, mu, sigma, xi, S, seed, y, M,
                      K, N, st);
  return launch_lrt((const float*)x, mu, sigma, xi, S, seed, y, M, K, N, st);
}
