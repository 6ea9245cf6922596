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
// W is formed in f32 with __fmul_rn / __fadd_rn, so it equals the plain
// version's W bit for bit.  The in-kernel variates are keyed by the weight
// element alone, counter (n, k, s / 4, TAG_BAYES) with four normals per
// Philox call, so every row block draws the SAME W_s (one sampled weight
// matrix per sample, as repro/kernels/bayes_matmul.py:186-189 requires).
// The single draw is the S = 1 instance of the sampled GEMM with an
// explicit eps: a (K, N) eps has the layout of a (1, K, N) one.  Two kernel
// families serve both entry points, chosen by the caller from shape, S and
// alignment (bayes_matmul.py::bayes_route), never by failure.
//
// bayes_gemm_mma (M >= BAYES_MMA_MIN_ROWS, N % 4 == 0, mu, sigma and eps on
// 16-byte boundaries; any K and any x).  What bounds it: at bench_kernels'
// shape (M 128, K 1024, N 4096, S 10) the S products, 10.7 GFLOP that must
// be f32-accurate (chip_smoke.py holds them to 1e-4 of max |y|): 0.160 ms on
// the CUDA cores at their peak, 0.065 ms as three TF32 products on the
// tensor cores; and the in-kernel draws, 12.6 M Philox calls when each
// variate is drawn once, 0.075 ms at the int32 peak.  The single draw is
// bound by reading mu, sigma and eps (50 MB, 0.0158 ms).  Design: a block
// of 16 warps owns all S samples of a 128 x 16 output tile: 4 warps along
// M (32 rows each) x 2 along N (8 columns each) x 2 over the samples (each
// warp the first or the second half of them: S / 2 x 8 f32 sums a thread,
// inside the 128 registers 512 threads may hold).  The single draw (the
// NS 1 instance) takes 128 x 32 tiles, 4 warps along N, and five stages,
// to keep more of mu, sigma and eps in flight.  128 rows are the JAX
// kernel's bm: at M <= 128 there is one row block and every variate is
// drawn exactly once; at the im2col shape (M 156,800) each of the 1,225 row
// blocks draws its column block's variates again.  K advances in tiles of
// 32 through a ring of cp.async stages (three; two at S > 12); slot j holds
// x tile j and the mu, sigma and explicit eps tiles of tile j + 1: 16-byte
// copies, and 4-byte copies of x where K % 4 != 0 or x is off a 16-byte
// boundary (the im2col's K 171).  Ragged edges are zero-filled by the copy;
// stores are masked.  Iteration j makes W_s of tile j + 1 into one of two
// f32 buffers while the products of tile j read the other, one barrier an
// iteration: each thread forms one weight element of all S samples (reads
// its mu and sigma once, draws four samples per Philox call in a loop over
// sample groups that is not unrolled, or reads eps, then W = mu + sd * z),
// and each warp splits its x fragments into tf32 hi and lo
// (mma_tile.cuh::split_tf32) once per k8 step for all its samples, loads
// and splits each sample's B pair (one 8-byte word a lane), and issues
// lo*hi, hi*lo, then hi*hi for every sample: no branch between samples, so
// a warp past its share (S odd or S < NS) multiplies stale W_s slots whose
// sums it never stores.  Half the warps of each scheduler form first and
// multiply second, the others the other way round (3% at S 10,
// tools/bayes_variants.py).  Within a k8 step the k order is permuted as
// in lrt_gemm_mma (logical k t and t + 4 sit in physical columns 2t and
// 2t + 1, for A and B alike), and the strides are padded (x 40 floats,
// mu / sigma / eps BN + 4) so that no fragment load, W_s store or mu /
// sigma / eps read conflicts in a bank.  The sums stay in the tensor core's f32
// accumulators over all of K: per-k-tile partial sums, as lrt_gemm_mma
// keeps, would double the sums a thread holds.
//
// What the card showed (tools/bayes_variants.py; PERF.md): the
// time is the sum of the products (an HMMA.1688 tf32 takes about 8.5
// cycles of its scheduler) and of every other instruction, the draws'
// most of all; taking them in other warps (a forming and a multiplying
// role), in the other order, or with the k8 steps not unrolled did not
// make them overlap.
//
// bayes_gemm_simt_explicit / bayes_gemm_simt_sampled (every other call,
// e.g. N % 4 != 0): f32 FMAs on the CUDA cores, bit-for-bit the same W.  A
// block owns a 64 x 64 output tile (single draw) or a 64 x 32 tile with all
// S samples (S accumulators per output, 8 outputs a thread); K advances in
// tiles of 16: the x tile staged transposed, the W tiles formed while
// staging, then each thread accumulates its outputs.  Each of the
// ceil(M / 64) row blocks draws the variates of its column block again.
//
// The LRT GEMM: two kernels behind both LRT entry points (replacing
// lrt_matmul_kernel and lrt_matmul_fused_kernel, whose bodies
// _lrt_mm_kernel and _lrt_mm_fused_kernel accumulate one mean and one
// variance GEMM and apply the noise on the last K step):
//   y_s = x@mu + sqrt(max((x*x)@sigma^2, 0)) * xi_s,  s < S (S = 1 with an
//   explicit (M, N) xi for the single draw; xi (S, M, N) or the TAG_LRT
//   Philox stream, counter (n, m, s / 4, TAG_LRT), for the S-sample GEMM).
// The S samples share the two GEMMs and differ only in the epilogue, so
// both kernels keep two f32 sums per output (mean, variance), not S, and
// S is a loop bound.  The caller picks the kernel by shape, type and
// alignment (bayes_matmul.py::lrt_route), never by failure.
//
// lrt_gemm_mma (M >= LRT_MMA_MIN_ROWS, 16-byte aligned operands, K % 4 == 0
// for f32 x or K % 8 == 0 for bf16 x, N % 4 == 0).  What bounds it: at
// bench_kernels' shape (M 128, K 1024, N 4096) the two GEMMs, 2.15 GFLOP
// that must be f32-accurate (chip_smoke.py holds them to 1e-5 of max |y|):
// 0.0321 ms on the CUDA cores at their peak, 0.0130 ms as three TF32
// products on the tensor cores; the bytes take 0.0114 ms (lrt_matmul) and
// 0.0164 ms with S = 10 outputs (lrt_matmul_sampled, bound by bytes).
// Design: warp-level mma.sync m16n8k8 tf32 tiles, 3xTF32: every operand
// value v is split into hi = tf32(v), rounded to nearest (ties away) by an
// integer add and mask, and lo = v - hi, which the tensor core reads
// truncated to tf32 (mma_tile.cuh::split_tf32); a product is hi*hi' +
// hi*lo' + lo*hi' (one pass of tf32 holds it to 2^-11 only, about 3e-4 of
// max |y| at K 1024).  cvt.rna.tf32.f32 is a sequence of several
// instructions with NaN checks: with it on both parts, as first written,
// the kernel took a quarter longer at M 128 (tools/lrt_variants.py).  x*x is
// squared from the f32 value of x (converted from bf16 where x is bf16)
// and sigma^2 = sd * sd in f32, both in registers, then split: no sigma^2
// tensor exists.  Eight warps own 32 x 16 outputs each; a block is the
// least of 32 x 128, 64 x 64 and 128 x 32 tiles that covers M in rows, so
// a small M wastes no MMA work beyond its 32-row tile.  At M 128, N 4096:
// 128 x 1 blocks of 128 x 32 (one an SM on 128 of the card's 132 SMs; mu
// and sigma read once); at M 9-32 and the head's N 151936: 1,187 x 1
// blocks of 32 x 128.  K advances in tiles of 32 through a ring of three
// stages in dynamic shared memory, filled by 16-byte cp.async (the x tile
// and the mu and sigma tiles; ragged M, K and N edges zero-filled by the
// copy, stores masked).  Within each k8 step the k order is permuted
// (logical k t and t + 4 sit in physical columns 2t and 2t + 1), the same
// for A and B, so a lane's two A values of a row are one 8-byte or 4-byte
// (bf16) shared load; the row strides are padded for that layout (x 40
// floats or 40 bf16, mu/sigma BN + 4 floats), which leaves every fragment
// load free of bank conflicts.  The tensor core adds in f32 with its own
// rounding, so each k tile's three products (the two small ones first)
// accumulate in a partial sum started at zero, and the partials are added
// to the running sums by f32 adds on the CUDA cores: a sum over K never
// runs through more than 12 tensor-core adds.  One accumulator for the
// small and the big products, not two, keeps the registers at 64 sums a
// thread (mean and variance, running and partial).  The epilogue takes
// std = sqrtf(max(var, 0)) (NaN stays NaN) from the C fragments, parks
// (mean, std) in the ring's shared memory, and walks the block's column
// pairs in one loop that is not unrolled: one copy of the Philox code
// (unrolled over a lane's eight column pairs, the draws ran 0.02 ms
// slower at S 10), whole 128-byte rows stored a warp.  It draws or reads
// xi four samples at a time and stores fmaf(std, z, mean) as float2, so
// the S draws never touch device memory.
//
// lrt_gemm_stream (every other call; the head's M 4).  What bounds it: at
// the head's shape (M 4, K 1536, N 151936) reading mu and sigma once,
// 1.87 GB.  Design: as the head's pass 1, each thread owns one output
// column and MR rows (4, 8 or 16, the least that covers M, so a small M
// wastes no FMAs); x and x*x are staged in shared memory in K chunks, and
// each thread streams its column of mu and sigma from device memory once
// per row block, coalesced across the warp, squaring sigma in the load:
// 1,187 x 1 blocks of 128 threads (MR 4) at the head's shape.  Ragged M, K
// and N are masked, not padded; x may be float32 or bfloat16, mu and sigma
// are float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "mma_tile.cuh"
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
    bayes_gemm_simt_explicit(const float* __restrict__ x,
                             const float* __restrict__ mu,
                             const float* __restrict__ sg,
                             const float* __restrict__ eps,
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
    bayes_gemm_simt_sampled(const float* __restrict__ x,
                            const float* __restrict__ mu,
                            const float* __restrict__ sg,
                            const float* __restrict__ eps, int S,
                            uint32_t seed, float* __restrict__ y, int M,
                            int K, int N) {
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

// bayes_gemm_mma: 16 warps, 4 along M (32 rows each) x 4 more, which are
// 2 along N (8 columns each) x 2 over the samples (each warp the products
// of half of them), or at NS 1 4 along N; K tiles of 32 through a ring of
// cp.async stages
constexpr int BG_NT = 512;
constexpr int BG_BM = 128;
constexpr int BG_BK = 32;
constexpr int BG_XLD = BG_BK + 8;   // x row stride, floats

// the NS instance's tile and dynamic shared memory: STAGES ring slots,
// slot j holding x tile j and the mu, sigma and eps tiles of k tile j + 1
// (the two that iteration j reads), and two W_s buffers of NS f32 tiles.
// The single draw (NS 1) is bound by bytes: it takes 32 columns a block
// and five stages, so that a block keeps four tiles of mu, sigma and eps
// in flight.
template <int NS>
struct BgTile {
  static constexpr int SH = NS == 1 ? 1 : 2;      // sample groups
  static constexpr int WN = 4 / SH;               // 8-column bands
  static constexpr int BN = 8 * WN;               // columns a block
  static constexpr int NH = (NS + SH - 1) / SH;   // samples a warp takes
  static constexpr int WLD = BN + 4;  // mu / sigma / eps row stride, floats
  static constexpr int STAGES = NS == 1 ? 5 : NS <= 12 ? 3 : 2;
  static constexpr int X = BG_BM * BG_XLD * 4;
  static constexpr int W = BG_BK * WLD * 4;            // each of mu, sigma
  static constexpr int STAGE = X + (2 + NS) * W;       // + NS eps tiles
  static constexpr int WS = NS * BG_BK * BN * 4;       // one W_s buffer
  static constexpr int TOTAL = STAGES * STAGE + 2 * WS;
};

template <int NS>
__global__ void __launch_bounds__(BG_NT, 1)
    bayes_gemm_mma(const float* __restrict__ x, const float* __restrict__ mu,
                   const float* __restrict__ sg, const float* __restrict__ eps,
                   int S, uint32_t seed, float* __restrict__ y, int M, int K,
                   int N, int x16) {
  using namespace mma_tile;
  using L = BgTile<NS>;
  constexpr int ST = L::STAGES, BN = L::BN, WLD = L::WLD, NH = L::NH;
  static_assert(L::TOTAL <= 232448, "one block's shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BG_BM;
  const int nkt = (K + BG_BK - 1) / BG_BK;
  // W_s as [s][k8 step][column][t] pairs (w(2t), w(2t + 1)) of f32: a
  // lane's B fragment of one sample is one 8-byte word
  float* wbuf = reinterpret_cast<float*>(smem + ST * L::STAGE);
  constexpr int WS_SAMPLE = BG_BK * BN;      // floats a sample
  constexpr int WS_FLOATS = NS * WS_SAMPLE;  // floats a buffer

  // x[m0:+128, k0:+32] into slot st
  auto load_x = [&](int st, int kt) {
    float* xs = reinterpret_cast<float*>(smem + st * L::STAGE);
    const int k0 = kt * BG_BK;
    if (x16) {  // K % 4 == 0, x on a 16-byte boundary: whole 16-byte copies
#pragma unroll
      for (int i = tid; i < BG_BM * BG_BK / 4; i += BG_NT) {
        const int r = i / (BG_BK / 4), c = (i % (BG_BK / 4)) * 4;
        const int m = m0 + r, k = k0 + c;
        const bool ok = m < M && k < K;
        cp_async_16(xs + r * BG_XLD + c, ok ? x + (size_t)m * K + k : x, ok);
      }
    } else {
#pragma unroll
      for (int i = tid; i < BG_BM * BG_BK; i += BG_NT) {
        const int r = i / BG_BK, c = i % BG_BK;
        const int m = m0 + r, k = k0 + c;
        const bool ok = m < M && k < K;
        cp_async_4(xs + r * BG_XLD + c, ok ? x + (size_t)m * K + k : x, ok);
      }
    }
  };
  // mu, sigma and eps[s][k0:+32, n0:+BN] into slot st.  N % 4 == 0: a
  // 16-byte copy of a row lies wholly inside or outside
  auto load_w = [&](int st, int kt) {
    float* ms = reinterpret_cast<float*>(smem + st * L::STAGE + L::X);
    float* ss = ms + BG_BK * WLD;
    float* es = ss + BG_BK * WLD;
    const int k0 = kt * BG_BK;
    if (tid < BG_BK * BN / 4) {
      const int r = tid / (BN / 4), c = (tid % (BN / 4)) * 4;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < K && n < N;
      const size_t at = ok ? (size_t)k * N + n : 0;
      cp_async_16(ms + r * WLD + c, mu + at, ok);
      cp_async_16(ss + r * WLD + c, sg + at, ok);
    }
    if (eps)
#pragma unroll 1
      for (int i = tid; i < S * BG_BK * BN / 4; i += BG_NT) {
        const int s = i / (BG_BK * BN / 4), j = i % (BG_BK * BN / 4);
        const int r = j / (BN / 4), c = (j % (BN / 4)) * 4;
        const int k = k0 + r, n = n0 + c;
        const bool ok = k < K && n < N;
        const size_t at = ok ? ((size_t)s * K + k) * N + n : 0;
        cp_async_16(es + (s * BG_BK + r) * WLD + c, eps + at, ok);
      }
  };
  // ring slot j: x tile j and the w operands of k tile j + 1
  auto load = [&](int j) {
    if (j < nkt) load_x(j % ST, j);
    if (j + 1 < nkt) load_w(j % ST, j + 1);
  };

  // W_s of all S samples for k tile kt, from the w operands in slot st,
  // into buffer b.  The thread's elements: tile row fk = 8 kq + 2 ft + fp
  // (logical k ft + 4 fp of k8 step kq), tile columns fn + 16 e, e < BN /
  // 16; a warp's 32 stores of one element are contiguous.
  const int fp = lane & 1, ft = (lane >> 1) & 3;
  const int fn = (lane >> 3) + 4 * (warp & 3), fk = 8 * (warp >> 2) + 2 * ft
                                                    + fp;
  auto form = [&](int st, int kt, int b) {
    const float* ms =
        reinterpret_cast<const float*>(smem + st * L::STAGE + L::X);
    const float* ss = ms + BG_BK * WLD;
    const float* es = ss + BG_BK * WLD;
    const int k = kt * BG_BK + fk;
#pragma unroll 1
    for (int c = fn; c < BN; c += 16) {
      const int n = n0 + c;
      const bool ok = k < K && n < N;
      const float m = ms[fk * WLD + c], d = ss[fk * WLD + c];
      float* dst = wbuf + b * WS_FLOATS + (((fk >> 3) * BN + c) * 4 + ft) * 2
                   + fp;
#pragma unroll 1
      for (int q = 0; 4 * q < S; ++q) {
        float z[4] = {0.f, 0.f, 0.f, 0.f};
        if (eps) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * q + j < S)
              z[j] = es[((4 * q + j) * BG_BK + fk) * WLD + c];
        } else if (ok) {
          const float4 v = repro::philox_normal4(
              (uint32_t)n, (uint32_t)k, (uint32_t)q, TAG_BAYES, seed);
          z[0] = v.x, z[1] = v.y, z[2] = v.z, z[3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * q + j;
          if (s >= S) break;
          dst[s * WS_SAMPLE] = ok ? __fadd_rn(m, __fmul_rn(d, z[j])) : 0.f;
        }
      }
    }
  };

  // the warp's outputs: rows wm * 32 + [0, 32), columns wn * 8 + [0, 8),
  // samples s0 + [0, ns): with two sample groups the first half of the S
  // samples for sh 0, the rest for sh 1
  const int wm = warp & 3, wn = (warp >> 2) % L::WN, sh = (warp >> 2) / L::WN;
  const int s0 = sh ? (S + 1) / 2 : 0;
  const int ns = L::SH == 1 ? S : sh ? S / 2 : (S + 1) / 2;
  float acc[NH][2][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;

  // the warp's products of k tile kt: x from slot st, W_s from buffer b.
  // Every warp multiplies NH samples (those past its ns read W_s slots of
  // samples s >= S, which hold stale values, and are never stored): no
  // branch between the samples, so the products of all of them interleave.
  auto mma = [&](int st, int b) {
    const float* xs = reinterpret_cast<const float*>(smem + st * L::STAGE);
    const float* wb = wbuf + b * WS_FLOATS + s0 * WS_SAMPLE +
                      ((wn * 8 + g) * 4 + t) * 2;
#pragma unroll
    for (int kk = 0; kk < BG_BK / 8; ++kk) {
      // A: a[h] = (row g + 8h, logical k t) at column 8 kk + 2t, a[h + 2] =
      // (row g + 8h, logical k t + 4) at column 8 kk + 2t + 1; split once
      // for all the warp's samples
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + i * 16 + g + 8 * h;
          const float2 v = *reinterpret_cast<const float2*>(
              xs + row * BG_XLD + 8 * kk + 2 * t);
          split_tf32(v.x, ah[i][h], al[i][h]);
          split_tf32(v.y, ah[i][h + 2], al[i][h + 2]);
        }
      uint32_t bh[NH][2], bl[NH][2];
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(
            wb + j * WS_SAMPLE + kk * BN * 8);
        split_tf32(w.x, bh[j][0], bl[j][0]);
        split_tf32(w.y, bh[j][1], bl[j][1]);
      }
      // the small products of every sample, then the big ones
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(acc[j][i], al[i], bh[j]);
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(acc[j][i], ah[i], bl[j]);
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(acc[j][i], ah[i], bh[j]);
    }
  };

  // prologue: the w operands of tile 0 into the last slot (free until the
  // first iteration loads it), slots 0 .. ST - 2, then W_s of tile 0
  load_w(ST - 1, 0);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    load(j);
    cp_async_commit();
  }
  cp_async_wait<ST - 1>();
  __syncthreads();
  form(ST - 1, 0, 0);
  // Iteration kt: W_s of tile kt + 1 and the products of tile kt, both
  // from slot kt.  Half the warps of each scheduler (warps w, w + 4, w + 8
  // and w + 12 share one) take them in the opposite order, so that the
  // tensor cores and the other pipes work at once.
  const bool form_first = warp & 4;
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // slot kt landed, W_s of tile kt formed; every warp
                      // is done with slot kt - 1 and W_s buffer kt + 1
    load(kt + ST - 1);
    cp_async_commit();
    const int st = kt % ST;
#pragma unroll 1
    for (int ph = 0; ph < 2; ++ph) {
      if ((ph == 0) == form_first) {
        if (kt + 1 < nkt) form(st, kt + 1, (kt + 1) & 1);
      } else {
        mma(st, kt & 1);
      }
    }
  }

  // C fragment: rows g and g + 8 of each 16-row tile, columns 2t and 2t + 1
  const int n = n0 + wn * 8 + 2 * t;  // N % 4 == 0: n < N means n + 1 < N
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    if (j >= ns) break;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (m < M && n < N)
          *reinterpret_cast<float2*>(y + ((size_t)(s0 + j) * M + m) * N + n) =
              make_float2(acc[j][i][2 * h], acc[j][i][2 * h + 1]);
      }
  }
}

template <int NS>
int launch_bayes_mma_ns(const float* x, const float* mu, const float* sigma,
                        const float* eps, int S, uint32_t seed, float* y,
                        int M, int K, int N, cudaStream_t st) {
  constexpr int smem = BgTile<NS>::TOTAL, BN = BgTile<NS>::BN;
  static bool attr_set = false;  // once per instantiation, before any capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        bayes_gemm_mma<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BG_BM - 1) / BG_BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int x16 = ((uintptr_t)x & 15) == 0 && K % 4 == 0;
  bayes_gemm_mma<NS><<<grid, BG_NT, smem, st>>>(x, mu, sigma, eps, S, seed,
                                                y, M, K, N, x16);
  return (int)cudaGetLastError();
}

// the least instance that holds S samples (S 10, the paper's, has its own)
int launch_bayes_mma(const float* x, const float* mu, const float* sigma,
                     const float* eps, int S, uint32_t seed, float* y, int M,
                     int K, int N, cudaStream_t st) {
  if (S == 1)
    return launch_bayes_mma_ns<1>(x, mu, sigma, eps, S, seed, y, M, K, N, st);
  if (S <= 4)
    return launch_bayes_mma_ns<4>(x, mu, sigma, eps, S, seed, y, M, K, N, st);
  if (S <= 8)
    return launch_bayes_mma_ns<8>(x, mu, sigma, eps, S, seed, y, M, K, N, st);
  if (S <= 10)
    return launch_bayes_mma_ns<10>(x, mu, sigma, eps, S, seed, y, M, K, N,
                                   st);
  if (S <= 12)
    return launch_bayes_mma_ns<12>(x, mu, sigma, eps, S, seed, y, M, K, N,
                                   st);
  return launch_bayes_mma_ns<16>(x, mu, sigma, eps, S, seed, y, M, K, N, st);
}

constexpr int LT = 128;            // LRT: columns per block, one per thread
constexpr int LKC = 64;            // LRT: K chunk of x staged in shared memory
constexpr int MAX_LRT_SAMPLES = 1024;
constexpr uint32_t TAG_LRT = 4;

using repro::to_f32;

template <typename XT, int MR>
__global__ void __launch_bounds__(LT)
    lrt_gemm_stream(const XT* __restrict__ x, const float* __restrict__ mu,
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
int launch_lrt_stream(const XT* x, const float* mu, const float* sigma,
                      const float* xi, int S, uint32_t seed, float* y, int M,
                      int K, int N, cudaStream_t st) {
  const int mr = M <= 4 ? 4 : M <= 8 ? 8 : 16;
  const dim3 grid((N + LT - 1) / LT, (M + mr - 1) / mr);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (mr == 4)
    lrt_gemm_stream<XT, 4><<<grid, LT, 0, st>>>(x, mu, sigma, xi, S, seed, y,
                                                M, K, N);
  else if (mr == 8)
    lrt_gemm_stream<XT, 8><<<grid, LT, 0, st>>>(x, mu, sigma, xi, S, seed, y,
                                                M, K, N);
  else
    lrt_gemm_stream<XT, 16><<<grid, LT, 0, st>>>(x, mu, sigma, xi, S, seed,
                                                 y, M, K, N);
  return (int)cudaGetLastError();
}

constexpr int MM_BK = 32;               // K per stage
constexpr int MM_STAGES = 3;            // cp.async ring
constexpr int MM_NT = 256;              // 8 warps of 32 x 16 outputs each
constexpr int MM_XLD = MM_BK + 8;       // x row stride, in elements of x

// A block of WM warps along M and 8 / WM along N owns a (32 WM) x (128 /
// WM) output tile; mu / sigma rows are padded to BN + 4 floats.
template <int WM>
struct MmaTile {
  static constexpr int BM = 32 * WM, BN = 16 * (8 / WM), WLD = BN + 4;
};

template <typename XT, int WM>
constexpr int mma_smem_bytes() {
  using T = MmaTile<WM>;
  return MM_STAGES *
         (T::BM * MM_XLD * (int)sizeof(XT) + 2 * MM_BK * T::WLD * 4);
}

__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename XT, int WM>
__global__ void __launch_bounds__(MM_NT, 1)
    lrt_gemm_mma(const XT* __restrict__ x, const float* __restrict__ mu,
                 const float* __restrict__ sg, const float* __restrict__ xi,
                 int S, uint32_t seed, float* __restrict__ y, int M, int K,
                 int N) {
  using namespace mma_tile;
  using T = MmaTile<WM>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XE = 16 / (int)sizeof(XT);         // x elements a copy
  constexpr int X_BYTES = T::BM * MM_XLD * (int)sizeof(XT);
  constexpr int W_BYTES = MM_BK * T::WLD * 4;
  constexpr int STAGE = X_BYTES + 2 * W_BYTES;
  constexpr int X_CHUNKS = T::BM * MM_BK / XE;     // 16-byte copies a stage
  constexpr int W_CHUNKS = MM_BK * T::BN / 4;      // each of mu, sigma
  static_assert(T::BM * T::BN * 8 <= MM_STAGES * STAGE,
                "the epilogue's (mean, std) tile fits the ring");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;  // 32-row band, 16-column band
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  const int nkt = (K + MM_BK - 1) / MM_BK;

  // one stage: x[m0:+BM, k0:+32], mu and sigma[k0:+32, n0:+BN]; 16-byte
  // copies, zero-filled outside (K % XE == 0 and N % 4 == 0: a copy lies
  // wholly inside or wholly outside)
  auto load = [&](int st, int kt) {
    unsigned char* base = smem + st * STAGE;
    XT* xs = reinterpret_cast<XT*>(base);
    float* ms = reinterpret_cast<float*>(base + X_BYTES);
    float* ss = reinterpret_cast<float*>(base + X_BYTES + W_BYTES);
    const int k0 = kt * MM_BK;
#pragma unroll
    for (int i = tid; i < X_CHUNKS; i += MM_NT) {
      const int r = i / (MM_BK / XE), col = (i % (MM_BK / XE)) * XE;
      const int m = m0 + r, k = k0 + col;
      const bool ok = m < M && k < K;
      cp_async_16(xs + r * MM_XLD + col, ok ? x + (size_t)m * K + k : x, ok);
    }
#pragma unroll
    for (int i = tid; i < W_CHUNKS; i += MM_NT) {
      const int r = i / (T::BN / 4), col = (i % (T::BN / 4)) * 4;
      const int k = k0 + r, n = n0 + col;
      const bool ok = k < K && n < N;
      const size_t at = ok ? (size_t)k * N + n : 0;
      cp_async_16(ms + r * T::WLD + col, mu + at, ok);
      cp_async_16(ss + r * T::WLD + col, sg + at, ok);
    }
  };

  float am[2][2][4], av[2][2][4];  // running sums: [m tile][n tile][C]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) am[i][j][e] = av[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < MM_STAGES - 1; ++st) {
    if (st < nkt) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + MM_STAGES - 1 < nkt)
      load((kt + MM_STAGES - 1) % MM_STAGES, kt + MM_STAGES - 1);
    cp_async_commit();
    const unsigned char* base = smem + (kt % MM_STAGES) * STAGE;
    const XT* xs = reinterpret_cast<const XT*>(base);
    const float* ms = reinterpret_cast<const float*>(base + X_BYTES);
    const float* ss = reinterpret_cast<const float*>(base + X_BYTES + W_BYTES);
    float pm[2][2][4], pv[2][2][4];  // this tile's partial sums
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pm[i][j][e] = pv[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MM_BK; kk += 8) {
      // A (x and x*x): a[h] = (row g + 8h, logical k t) at column kk + 2t,
      // a[h + 2] = (row g + 8h, logical k t + 4) at column kk + 2t + 1
      uint32_t xh[2][4], xl[2][4], qh[2][4], ql[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + i * 16 + g + 8 * h;
          const float2 v = pair_f32(xs + r * MM_XLD + kk + 2 * t);
          split_tf32(v.x, xh[i][h], xl[i][h]);
          split_tf32(v.y, xh[i][h + 2], xl[i][h + 2]);
          split_tf32(__fmul_rn(v.x, v.x), qh[i][h], ql[i][h]);
          split_tf32(__fmul_rn(v.y, v.y), qh[i][h + 2], ql[i][h + 2]);
        }
      // B (mu and sigma^2): b[h] = (logical k t + 4h, column g) at row
      // kk + 2t + h
      uint32_t wh[2][2], wl[2][2], sh[2][2], sl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (kk + 2 * t + h) * T::WLD + wn * 16 + j * 8 + g;
          const float sd = ss[at];  // squared unfused, as the plain version
          split_tf32(ms[at], wh[j][h], wl[j][h]);
          split_tf32(__fmul_rn(sd, sd), sh[j][h], sl[j][h]);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_tf32(pm[i][j], xl[i], wh[j]);
          mma_tf32(pm[i][j], xh[i], wl[j]);
          mma_tf32(pm[i][j], xh[i], wh[j]);
          mma_tf32(pv[i][j], ql[i], sh[j]);
          mma_tf32(pv[i][j], qh[i], sl[j]);
          mma_tf32(pv[i][j], qh[i], sh[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          am[i][j][e] += pm[i][j][e];
          av[i][j][e] += pv[i][j][e];
        }
  }

  // the epilogue.  Each lane's C fragments (rows g and g + 8, columns 2t
  // and 2t + 1 of each 16 x 8 tile) go to shared memory as (mean, std)
  // pairs; then one loop over column pairs, not unrolled, draws or reads
  // the S variates and stores: a single copy of the Philox code (the
  // instruction cache holds it) and whole 128-byte rows a warp.
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float2* ep = reinterpret_cast<float2*>(smem);  // [BM][BN] (mean, std)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = av[i][j][2 * h + c];
          ep[(wm * 32 + i * 16 + g + 8 * h) * T::BN + wn * 16 + j * 8 +
             2 * t + c] = make_float2(am[i][j][2 * h + c],
                                      sqrtf(v < 0.f ? 0.f : v));  // NaN stays
        }
  __syncthreads();
#pragma unroll 1
  for (int idx = tid; idx < T::BM * T::BN / 2; idx += MM_NT) {
    const int r = idx / (T::BN / 2), c = 2 * (idx % (T::BN / 2));
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;  // N even: n + 1 < N too
    const float4 e = *reinterpret_cast<const float4*>(ep + r * T::BN + c);
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
          *reinterpret_cast<float2*>(y + ((size_t)(4 * q + k) * M + m) * N +
                                     n) =
              make_float2(fmaf(e.y, z0[k], e.x), fmaf(e.w, z1[k], e.z));
    }
  }
}

template <typename XT, int WM>
int launch_lrt_mma_tile(const XT* x, const float* mu, const float* sigma,
                        const float* xi, int S, uint32_t seed, float* y,
                        int M, int K, int N, cudaStream_t st) {
  using T = MmaTile<WM>;
  constexpr int smem = mma_smem_bytes<XT, WM>();
  static bool attr_set = false;  // once per instantiation, before any capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        lrt_gemm_mma<XT, WM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  lrt_gemm_mma<XT, WM><<<grid, MM_NT, smem, st>>>(x, mu, sigma, xi, S, seed,
                                                   y, M, K, N);
  return (int)cudaGetLastError();
}

// the least block rows that cover M: 32 x 128, 64 x 64 or 128 x 32 tiles
template <typename XT>
int launch_lrt_mma(const XT* x, const float* mu, const float* sigma,
                   const float* xi, int S, uint32_t seed, float* y, int M,
                   int K, int N, cudaStream_t st) {
  if (M <= 32)
    return launch_lrt_mma_tile<XT, 1>(x, mu, sigma, xi, S, seed, y, M, K, N,
                                      st);
  if (M <= 64)
    return launch_lrt_mma_tile<XT, 2>(x, mu, sigma, xi, S, seed, y, M, K, N,
                                      st);
  return launch_lrt_mma_tile<XT, 4>(x, mu, sigma, xi, S, seed, y, M, K, N,
                                    st);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool bad_shape(int M, int K, int N) {
  return M < 1 || K < 1 || N < 1 || (N + BN2 - 1) / BN2 > 65535;
}

// route 1: bayes_gemm_mma, refused (nothing launched) unless N % 4 == 0 and
// mu, sigma, eps and y start on 16-byte boundaries; route 0: the SIMT
// kernel of the entry point (single: the explicit single draw)
int bayes_gemm(const float* x, const float* mu, const float* sigma,
               const float* eps, int S, uint32_t seed, float* y, int M,
               int K, int N, bool single, int route, cudaStream_t st) {
  if (bad_shape(M, K, N) || S < 1 || S > MAXS || (single && (!eps || S != 1))
      || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (N % 4 || !aligned16(mu) || !aligned16(sigma) || !aligned16(eps) ||
        !aligned16(y))
      return (int)cudaErrorInvalidValue;
    return launch_bayes_mma(x, mu, sigma, eps, S, seed, y, M, K, N, st);
  }
  if (single) {
    const dim3 grid((M + BM - 1) / BM, (N + BN1 - 1) / BN1);
    bayes_gemm_simt_explicit<<<grid, NT, 0, st>>>(x, mu, sigma, eps, y, M, K,
                                                  N);
    return (int)cudaGetLastError();
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN2 - 1) / BN2);
  if (S <= 4)
    bayes_gemm_simt_sampled<4><<<grid, NT, 0, st>>>(x, mu, sigma, eps, S,
                                                    seed, y, M, K, N);
  else if (S <= 8)
    bayes_gemm_simt_sampled<8><<<grid, NT, 0, st>>>(x, mu, sigma, eps, S,
                                                    seed, y, M, K, N);
  else if (S <= 12)
    bayes_gemm_simt_sampled<12><<<grid, NT, 0, st>>>(x, mu, sigma, eps, S,
                                                     seed, y, M, K, N);
  else
    bayes_gemm_simt_sampled<16><<<grid, NT, 0, st>>>(x, mu, sigma, eps, S,
                                                     seed, y, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched).  All
// operands are contiguous float32: x (M, K), mu/sigma (K, N), y (M, N) or
// (S, M, N); eps is (K, N) for the single draw (S = 1) and (S, K, N) or
// null (the in-kernel stream keyed by seed) for the sampled GEMM.  route 1
// runs bayes_gemm_mma and refuses (cudaErrorInvalidValue, nothing
// launched) a call with N % 4 != 0 or with mu, sigma, eps or y off a
// 16-byte boundary; route 0 runs the entry point's SIMT kernel.
extern "C" int repro_bayes_matmul(const float* x, const float* mu,
                                  const float* sigma, const float* eps,
                                  int S, uint32_t seed, float* y, int M,
                                  int K, int N, int route, void* stream) {
  return bayes_gemm(x, mu, sigma, eps, S, seed, y, M, K, N, true, route,
                    (cudaStream_t)stream);
}

extern "C" int repro_bayes_matmul_sampled(const float* x, const float* mu,
                                          const float* sigma,
                                          const float* eps, int S,
                                          uint32_t seed, float* y, int M,
                                          int K, int N, int route,
                                          void* stream) {
  return bayes_gemm(x, mu, sigma, eps, S, seed, y, M, K, N, false, route,
                    (cudaStream_t)stream);
}

// The LRT GEMM: x (M, K) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1),
// mu/sigma (K, N) float32, y (S, M, N) float32, all contiguous; xi is
// (S, M, N) or null (the in-kernel TAG_LRT stream keyed by seed).  route 1
// runs lrt_gemm_mma and refuses (cudaErrorInvalidValue, nothing launched) a
// call whose operands do not all start on a 16-byte boundary or whose K is
// not a multiple of 4 (f32 x) or 8 (bf16 x) or N of 4; route 0 runs
// lrt_gemm_stream.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int repro_lrt_matmul(const void* x, int x_bf16, const float* mu,
                                const float* sigma, const float* xi, int S,
                                uint32_t seed, float* y, int M, int K, int N,
                                int route, void* stream) {
  if (M < 1 || K < 1 || N < 1 || S < 1 || S > MAX_LRT_SAMPLES ||
      (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    if (!aligned16(x) || !aligned16(mu) || !aligned16(sigma) ||
        !aligned16(xi) || !aligned16(y) || K % (x_bf16 ? 8 : 4) || N % 4)
      return (int)cudaErrorInvalidValue;
    if (x_bf16)
      return launch_lrt_mma((const __nv_bfloat16*)x, mu, sigma, xi, S, seed,
                            y, M, K, N, st);
    return launch_lrt_mma((const float*)x, mu, sigma, xi, S, seed, y, M, K, N,
                          st);
  }
  if (x_bf16)
    return launch_lrt_stream((const __nv_bfloat16*)x, mu, sigma, xi, S, seed,
                             y, M, K, N, st);
  return launch_lrt_stream((const float*)x, mu, sigma, xi, S, seed, y, M, K,
                           N, st);
}
