// The sampled-weight GEMM, for sm_90a.
//
// Replaces: repro/kernels/bayes_matmul.py::bayes_matmul_kernel (body
// _bayes_mm_kernel: one draw, explicit eps) and bayes_matmul_fused_kernel
// (body _bayes_mm_fused_kernel: S weight-space samples per pass, eps
// explicit or drawn in the kernel by pltpu.prng_random_bits + Box-Muller).
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
#include <cuda_runtime.h>
#include <stdint.h>

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
