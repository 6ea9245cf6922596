// GQA flash attention, forward, for sm_90a.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_kernel (body
// _flash_kernel).
//
// Computes, for q (B, Sq, H, D) and k/v (B, Sk, Hkv, D) in the port's
// layout (read by stride; the last dimension contiguous), query head h
// attending to kv head h / (H / Hkv):
//   o = softmax(q k^T / sqrt(D), masked) v,  causal or not,
// with query row i at absolute position q_offset + i; a key at or past Sk
// is masked, and under causal so is a key past the query's position.  The
// online state is the TPU kernel's: m from -1e30, masked scores -1e30, p
// set to 0 where masked (a row whose first kv tile is fully masked would
// otherwise take exp(0) = 1 per masked key), o = acc / max(l, 1e-20), so
// a row with no visible key gives 0.  The scale multiplies the f32 scores
// after the product.  Math and state are float32; o takes q's type.
//
// Two kernels, chosen by the caller (flash_route in flash_attention.py)
// from dtype, head dim and alignment, never by failure:
//
// flash_fwd_mma<D> (+ flash_merge): bf16, D a multiple of 16 up to 128,
//   q/k/v 16-byte aligned with strides a multiple of 8 elements.
//   Bound at B 4, Sq = Sk = 2048, H 12, Hkv 2, D 128, causal: 51.5 GFLOP
//   of QK^T and PV -> 0.0521 ms on the bf16 tensor cores, against 25 MB
//   of q/k/v/o (0.0075 ms at the memory rate): operations.  The kernel
//   issues twice those products (P.V three times, below): 0.1042 ms at
//   the tensor cores' peak.  What the design does about the three limits
//   of the SIMT kernel below:
//   - f32 FMAs on the CUDA cores: Q.K^T and P.V are mma.sync m16n8k16
//     bf16 tiles with f32 accumulators (mma_tile.cuh).  A warp owns 16
//     query rows; the block's Q rows are copied into shared memory once
//     and read each tile through ldmatrix (held in registers, they
//     pushed D 128 further into spills), K through ldmatrix, V through
//     ldmatrix.trans, each lane addressing shared memory from one 32-bit
//     base.  P.V runs as four independent accumulator chains.  The
//     softmax works in base 2 (the scale carries log2(e), p = 2^(s - m)
//     is one ex2) and skips the mask on tiles every row of the warp sees
//     whole.  P is split into three bf16 parts (hi = bf16(p), mid and
//     lo of what is left), so P.V = hi.V + mid.V + lo.V holds P to about
//     2^-24, as f32 does: one rounding of P to bf16 puts a sixth of the
//     outputs, and two parts (P to 2^-16) a few in a million, beyond one
//     bf16 ulp of the f32 result that chip_smoke.py's check allows.
//     Each tile's P.V starts from zero in the tensor cores and is added
//     to the running output in f32 (o = o * corr + pv), as the TPU kernel
//     adds its tile's product.  The row sums take the f32 p.
//   - K and V staged one after the other, no copy in flight while the
//     products run: 64-key K and V tiles come with 16-byte cp.async into
//     a two-stage ring (row pitch D + 8 bf16, so the eight rows of an
//     ldmatrix fall on distinct banks), tile t + 1 in flight while tile t
//     is computed, all 4 warps of a block sharing each tile's copy; two
//     barriers a tile.  Keys past Sk are zero-filled, never read.
//   - a grid of (Sq / 64, B * H), each block walking every kv tile in
//     series: rows are packed per (b, kv head), row r = replica * Sq +
//     query, so the H / Hkv heads of a group share every K/V tile (the
//     decode window's 48 one-row blocks become 8 blocks of 6 rows), and
//     when the row blocks alone do not fill the card the kv tiles are cut
//     into chunks (grid z, flash_split in flash_attention.py): each
//     (row block, chunk) block writes an f32 partial (acc[D], m, l) and
//     flash_merge combines them, weighting each chunk by 2^(m_c - max m).
//     A chunk with no visible key for a row holds (m -1e30, l 0, acc 0)
//     and weighs 0 (or 1 against an all -1e30 row, whose l is 0 too).
//     A warp whose 16 rows all lie past the last row copies its share
//     of each tile and computes nothing.
//   Under causal no tile is loaded or computed whose first key lies above
//   the block's highest query position: under the guards such a tile
//   changes no (m, l, acc).  The mask position and the output address
//   are computed per row, since a warp's rows cross a replica when Sq is
//   not a multiple of 16.  Row blocks are launched highest first, so the
//   longest causal walks start early.
//   ptxas -v on an H100 build (sm_90a, CUDA 12.8), registers per
//   thread: D 128 255 (20 bytes of spill stores), D 112 252, D 96 224,
//   D 80 168 (24 bytes), D 64 172, D 48 154, D 32 128, D 16 106.  SASS:
//   256 HMMA at D 128 (64 for Q.K^T, 192 for P.V's three parts per
//   tile).  At 255 registers two blocks (8 warps) fit on an SM.
//
// flash_fwd_simt<T, D>: f32 operands, bf16 at other head dims (to 256)
//   or at strides cp.async cannot take.  One block of 256 threads per
//   (b * H + h, 64 query rows); the q tile stays in shared memory as f32;
//   each 64-key tile of K, then of V, is staged as f32 into one shared
//   buffer (rows padded by 4 floats so the float4 reads of 16 lanes hit
//   distinct banks).  A thread owns 4 query rows and 4 key columns of the
//   score tile (columns tx + 16 j, conflict-free), and 4 rows x D/16
//   dimensions of the output; the 16 lanes sharing a row reduce its max
//   and sum by shuffles.  Under causal the loop stops at the last key any
//   row of the block may see.  f32 FMAs on the CUDA cores: the bound at
//   the shape above is 0.77 ms at their peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "convert.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int NT = 256;    // threads: 16 row groups x 16 lanes
constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // keys per kv tile
constexpr int PAD = 4;     // row padding of the shared tiles, in floats
constexpr int LP = BK + PAD;
constexpr float NEG = -1e30f;

using repro::put;
using repro::to_f32;

struct Strides {
  long long b, s, h;
};

// rows [0, rows) of one head, starting at `base`, as f32 into a
// (rows x (DM + PAD)) tile; zero past `valid` rows and past D
template <typename T, int DM>
__device__ __forceinline__ void stage(const T* __restrict__ base,
                                      long long ss, int valid, int D,
                                      float* __restrict__ tile, int rows) {
  for (int i = threadIdx.x; i < rows * DM; i += NT) {
    const int r = i / DM, d = i % DM;
    tile[r * (DM + PAD) + d] =
        (r < valid && d < D) ? to_f32(base[(long long)r * ss + d]) : 0.f;
  }
}

template <typename T, int DM>
__global__ void __launch_bounds__(NT)
    flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int H,
                   int Hkv, int Sq, int Sk, int D, Strides qs, Strides ks,
                   Strides vs, int causal, int q_offset, float scale) {
  constexpr int LD = DM + PAD;
  constexpr int ND = DM / 64;  // float4 groups of output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // BQ x LD
  float* KVs = Qs + BQ * LD;     // BK x LD: the K tile, then the V tile
  float* Ps = KVs + BK * LD;     // BQ x LP
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  stage<T, DM>(q + b * qs.b + h * qs.h + (long long)q0 * qs.s, qs.s, Sq - q0,
               D, Qs, BQ);

  float acc[4][ND][4];
  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = NEG;
    lrow[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }
  // the last key any row of this block may see (exclusive)
  int kend = Sk;
  if (causal) kend = max(0, min(Sk, q_offset + min(q0 + BQ, Sq)));

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's PV reads are done
    stage<T, DM>(kb + (long long)k0 * ks.s, ks.s, Sk - k0, D, KVs, BK);
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = sc[i][j];
          t = fmaf(a[i].x, kk[j].x, t);
          t = fmaf(a[i].y, kk[j].y, t);
          t = fmaf(a[i].z, kk[j].z, t);
          t = fmaf(a[i].w, kk[j].w, t);
          sc[i][j] = t;
        }
    }
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Sk && (!causal || kpos <= qpos);
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(mrow[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(mrow[i] - m_new);
      lrow[i] = lrow[i] * corr[i] + sum;
      mrow[i] = m_new;
    }
    __syncthreads();  // the K tile is no longer read; Ps is complete
    stage<T, DM>(vb + (long long)k0 * vs.s, vs.s, Sk - k0, D, KVs, BK);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= corr[i];
#pragma unroll 2
    for (int c0 = 0; c0 < BK; c0 += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * LP + c0]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &KVs[(c0 + cc) * LD + tx * 4 + 64 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0   ? p4[i].x
                            : cc == 1 ? p4[i].y
                            : cc == 2 ? p4[i].z
                                      : p4[i].w;
            acc[i][j][0] = fmaf(p, vv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(p, vv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(p, vv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(p, vv.w, acc[i][j][3]);
          }
        }
      }
    }
  }
  // o is (B, Sq, H, D), contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float den = fmaxf(lrow[i], 1e-20f);
    T* orow = o + (((long long)b * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = tx * 4 + 64 * j + c;
        if (d < D) put(orow + d, acc[i][j][c] / den);
      }
  }
}

template <typename T, int DM>
int launch_simt(const T* q, const T* k, const T* v, T* o, int B, int H,
                int Hkv, int Sq, int Sk, int D, Strides qs, Strides ks,
                Strides vs, int causal, int q_offset, cudaStream_t st) {
  constexpr int LD = DM + PAD;
  constexpr size_t smem = (size_t)(BQ * LD + BK * LD + BQ * LP) * 4;
  static bool attr_set = false;  // once per instantiation, before any capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_simt<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_simt<T, DM><<<grid, NT, smem, st>>>(
      q, k, v, o, H, Hkv, Sq, Sk, D, qs, ks, vs, causal, q_offset,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int Hkv, int Sq, int Sk, int D, Strides qs,
                  Strides ks, Strides vs, int causal, int q_offset,
                  cudaStream_t st) {
  const T *qq = (const T*)q, *kk = (const T*)k, *vv = (const T*)v;
  T* oo = (T*)o;
  if (D <= 64)
    return launch_simt<T, 64>(qq, kk, vv, oo, B, H, Hkv, Sq, Sk, D, qs, ks,
                              vs, causal, q_offset, st);
  if (D <= 128)
    return launch_simt<T, 128>(qq, kk, vv, oo, B, H, Hkv, Sq, Sk, D, qs, ks,
                               vs, causal, q_offset, st);
  return launch_simt<T, 256>(qq, kk, vv, oo, B, H, Hkv, Sq, Sk, D, qs, ks,
                             vs, causal, q_offset, st);
}

// ---------------------------------------------------------------------------
// the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int MW = 4;            // warps per block, 16 rows each
constexpr int MROWS = 16 * MW;   // packed query rows per block
constexpr int MKT = 64;          // keys per tile
constexpr int MPAD = 8;          // bf16 of padding per smem row
constexpr int MERGE_NT = 128;    // merge threads: one per head dim

// 2^x by the special-function unit (ex2.approx.ftz: about 2^-22 relative
// error; 0 below 2^-126, so 2^(-1e30) = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
constexpr size_t mma_smem() {  // 2 stages x (K, V) x MKT rows, then Q
  return sizeof(__nv_bfloat16) * (2 * 2 * MKT + MROWS) * (D + MPAD);
}

// Grid (row block, b * Hkv + g, kv chunk).  With one chunk the block
// writes o; with several, an f32 partial (acc[D], m, l) per row and chunk
// into part, at ((output row) * chunks + chunk) * (D + 2).
template <int D>
__global__ void __launch_bounds__(MW * 32)
    flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ part,
                  int H, int Hkv, int Sq, int Sk, Strides qs, Strides ks,
                  Strides vs, int causal, int q_offset, int tiles_per_chunk,
                  float scale_log2) {
  using namespace mma_tile;
  constexpr int P = D + MPAD;  // smem row pitch (bf16)
  constexpr int KS = D / 16;   // k-steps of Q.K^T
  constexpr int DN = D / 8;    // 8-wide n-tiles of the output
  constexpr int CH = D / 8;    // 16-byte chunks of a key row
  extern __shared__ __align__(16) __nv_bfloat16 kv_s[];  // [2][K, V][KT][P]
  __nv_bfloat16* q_s = kv_s + 2 * 2 * MKT * P;           // [MROWS][P]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the lane's group and quad place
  const int b = blockIdx.y / Hkv, g = blockIdx.y % Hkv;
  const int rep = H / Hkv, R = rep * Sq;
  const int chunks = gridDim.z, chunk = blockIdx.z;
  const int rb = (gridDim.x - 1 - blockIdx.x) * MROWS;  // highest first

  // the tiles this block walks: its chunk's, below the block's diagonal
  int kend = Sk;
  if (causal) {
    const int last = min(rb + MROWS, R) - 1;
    const int qmax = q_offset + (last / Sq != rb / Sq ? Sq - 1 : last % Sq);
    kend = max(0, min(Sk, qmax + 1));
  }
  const int t0 = chunk * tiles_per_chunk;
  const int t1 = min((kend + MKT - 1) / MKT, t0 + tiles_per_chunk);

  const __nv_bfloat16* kb = k + b * ks.b + g * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + g * vs.h;
  // the block's threads share a tile's 16-byte copies, neighbouring
  // threads on neighbouring chunks of a key row
  auto load_tile = [&](int t) {
    __nv_bfloat16* kt = kv_s + ((t - t0) & 1) * 2 * MKT * P;
    __nv_bfloat16* vt = kt + MKT * P;
#pragma unroll
    for (int j = 0; j < MKT * CH / (MW * 32); ++j) {
      const int i = tid + j * MW * 32;
      const int key = i / CH, c = i % CH;
      const int pos = t * MKT + key;
      const bool live = pos < Sk;  // past Sk: zero-filled
      const long long at = live ? pos : 0;
      cp_async_16(kt + key * P + c * 8, kb + at * ks.s + c * 8, live);
      cp_async_16(vt + key * P + c * 8, vb + at * vs.s + c * 8, live);
    }
    cp_async_commit();
  };
  // the block's Q rows into shared memory with the first tile's copy
  // (zero past the last row), each thread on 16-byte chunks of a row
  if (t0 < t1) {
#pragma unroll
    for (int j = 0; j < MROWS * CH / (MW * 32); ++j) {
      const int i = tid + j * MW * 32;
      const int row = i / CH, c = i % CH, r = rb + row;
      const bool live = r < R;
      const __nv_bfloat16* src =
          live ? q + b * qs.b + (r % Sq) * qs.s + (g * rep + r / Sq) * qs.h
               : q;
      cp_async_16(q_s + row * P + c * 8, src + (live ? c * 8 : 0), live);
    }
    load_tile(t0);
  }

  // this lane's two rows (those of c[0..1] and of c[2..3])
  const bool warp_live = rb + warp * 16 < R;
  const int r_lo = rb + warp * 16 + gq, r_hi = r_lo + 8;
  const int h_lo = g * rep + r_lo / Sq, h_hi = g * rep + r_hi / Sq;
  const int qp_lo = q_offset + r_lo % Sq, qp_hi = q_offset + r_hi % Sq;

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = NEG, m_hi = NEG;
  float l_lo = 0.f, l_hi = 0.f;  // this lane's share of its rows' sums

  // 32-bit shared addresses of this lane's ldmatrix rows in stage 0; the
  // k-step, n-tile and stage offsets are constants
  const uint32_t k_lane =
      smem_u32(kv_s) +
      2 * (((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8);
  const uint32_t v_lane =
      smem_u32(kv_s + MKT * P) +
      2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8);
  const uint32_t q_lane =
      smem_u32(q_s) + 2 * ((warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               P + (lane >> 4) * 8);
  constexpr uint32_t STAGE = 2 * 2 * MKT * P;  // bytes of one (K, V) stage

  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) {
      load_tile(t + 1);  // into the other buffer, freed by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const uint32_t stage = ((t - t0) & 1) * STAGE;

      // s = Q.K^T: 8 n-tiles of 8 keys; an x4 ldmatrix gives the A
      // fragment of a k-step (Q rows), another the B fragments of two
      // n-tiles (K rows are B's columns)
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4(qa, q_lane + 2 * kk * 16);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, k_lane + stage + 2 * (jp * 16 * P + kk * 16));
          mma_bf16(s[2 * jp], qa, bk[0], bk[1]);
          mma_bf16(s[2 * jp + 1], qa, bk[2], bk[3]);
        }
      }

      // scale, mask (-1e30), and the tile's online softmax step with the
      // TPU kernel's guards (p = 0 where masked), in base 2: the scale
      // carries log2(e), so p = 2^(s - m) is one ex2.  Key column
      // 8 j + 2 tq + (e & 1) of the tile is visible to a row while
      // 8 j + (e & 1) <= its limit; a tile every row of the warp sees
      // whole takes the path without the mask
      const int k0 = t * MKT;
      const int cap = Sk - 1 - k0 - 2 * tq;
      const int lim_lo = causal ? min(cap, qp_lo - k0 - 2 * tq) : cap;
      const int lim_hi = causal ? min(cap, qp_hi - k0 - 2 * tq) : cap;
      float mn_lo, mn_hi, c_lo, c_hi;
      auto softmax = [&](auto masked) {
        constexpr bool M = decltype(masked)::value;
        auto ok = [&](int j, int e) {
          return !M || 8 * j + (e & 1) <= (e < 2 ? lim_lo : lim_hi);
        };
        float mx_lo = NEG, mx_hi = NEG;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = ok(j, e) ? s[j][e] * scale_log2 : NEG;
          mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
          mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
        }
        mn_lo = fmaxf(m_lo, quad_max(mx_lo));
        mn_hi = fmaxf(m_hi, quad_max(mx_hi));
        c_lo = exp2_approx(m_lo - mn_lo);
        c_hi = exp2_approx(m_hi - mn_hi);
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                ok(j, e) ? exp2_approx(s[j][e] - (e < 2 ? mn_lo : mn_hi))
                         : 0.f;
            s[j][e] = p;
            (e < 2 ? sum_lo : sum_hi) += p;
          }
        }
        l_lo = l_lo * c_lo + sum_lo;
        l_hi = l_hi * c_hi + sum_hi;
      };
      if (__all_sync(0xffffffffu, min(lim_lo, lim_hi) >= 57))
        softmax(std::false_type{});
      else
        softmax(std::true_type{});
      m_lo = mn_lo;
      m_hi = mn_hi;

      // P in three bf16 parts, as the A fragments of 4 k-steps of 16
      // keys; then per two pairs of output n-tiles (four independent
      // accumulator chains), this tile's P.V from zero (an x4
      // ldmatrix.trans gives the B fragments of a pair), added to the
      // rescaled running output in f32
      uint32_t ph[4][4], pm[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        c_to_a_split3(ph[kk], pm[kk], pl[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; dp += 2) {
        const bool two = dp + 1 < D / 16;  // D / 16 may be odd
        float pv[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t b0[4], b1[4];
          const uint32_t at = v_lane + stage + 2 * (kk * 16 * P + dp * 16);
          ldmatrix_x4_trans(b0, at);
          if (two) ldmatrix_x4_trans(b1, at + 2 * 16);
          auto product = [&](const uint32_t(&a)[4]) {
            mma_bf16(pv[0], a, b0[0], b0[1]);
            mma_bf16(pv[1], a, b0[2], b0[3]);
            if (two) {
              mma_bf16(pv[2], a, b1[0], b1[1]);
              mma_bf16(pv[3], a, b1[2], b1[3]);
            }
          };
          product(ph[kk]);
          product(pm[kk]);
          product(pl[kk]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n < 2 || two)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[2 * dp + n][e] =
                  fmaf(acc[2 * dp + n][e], e < 2 ? c_lo : c_hi, pv[n][e]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  if (!warp_live) return;

  const float lt_lo = quad_sum(l_lo), lt_hi = quad_sum(l_hi);
  const long long or_lo = ((long long)b * Sq + r_lo % Sq) * H + h_lo;
  const long long or_hi = ((long long)b * Sq + r_hi % Sq) * H + h_hi;
  if (chunks == 1) {
    // acc / max(l, 1e-20), per row, as bf16 pairs (one reciprocal a row)
    const float d_lo = 1.f / fmaxf(lt_lo, 1e-20f);
    const float d_hi = 1.f / fmaxf(lt_hi, 1e-20f);
    if (r_lo < R) {
      __nv_bfloat16* dst = o + or_lo * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < DN; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(acc[n][0] * d_lo, acc[n][1] * d_lo);
    }
    if (r_hi < R) {
      __nv_bfloat16* dst = o + or_hi * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < DN; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(acc[n][2] * d_hi, acc[n][3] * d_hi);
    }
    return;
  }
  // the chunk's partial: acc unnormalised, m and l of the row
  if (r_lo < R) {
    float* dst = part + (or_lo * chunks + chunk) * (D + 2);
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n + 2 * tq) =
          make_float2(acc[n][0], acc[n][1]);
    if (tq == 0) {
      dst[D] = m_lo;
      dst[D + 1] = lt_lo;
    }
  }
  if (r_hi < R) {
    float* dst = part + (or_hi * chunks + chunk) * (D + 2);
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n + 2 * tq) =
          make_float2(acc[n][2], acc[n][3]);
    if (tq == 0) {
      dst[D] = m_hi;
      dst[D + 1] = lt_hi;
    }
  }
}

// one block per output row (b, query, head), one thread per head dim:
// combines the chunks' partials (m in base 2, as the kernel keeps it),
// each weighted by 2^(m_c - max m), taken as expf of that times ln 2: the
// merge's time follows the loads in flight, and with expf the compiler
// unrolls the chunk loops 16 deep (with ex2.approx, unrolled by hand or
// not, the merge was slower on an H100).  A
// chunk without a visible key holds (-1e30, 0, 0): its weight is 0, or 1
// where every chunk is so, and then l = 0 and the row gives 0.
__global__ void __launch_bounds__(MERGE_NT)
    flash_merge(const float* __restrict__ part, __nv_bfloat16* __restrict__ o,
                int D, int chunks) {
  const int d = threadIdx.x;
  if (d >= D) return;
  const float* src = part + (size_t)blockIdx.x * chunks * (D + 2);
  float m = NEG;
  for (int c = 0; c < chunks; ++c) m = fmaxf(m, src[(size_t)c * (D + 2) + D]);
  float l = 0.f, a = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float* pc = src + (size_t)c * (D + 2);
    const float w = expf((pc[D] - m) * 0.6931471805599453f);
    l += pc[D + 1] * w;
    a += pc[d] * w;
  }
  o[(size_t)blockIdx.x * D + d] = __float2bfloat16(a / fmaxf(l, 1e-20f));
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* part, int B, int H, int Hkv, int Sq, int Sk, Strides qs,
               Strides ks, Strides vs, int causal, int q_offset, int chunks,
               cudaStream_t st) {
  constexpr size_t smem = mma_smem<D>();
  static bool attr_set = false;  // once per instantiation, before any capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int R = (H / Hkv) * Sq;
  const int tiles = (Sk + MKT - 1) / MKT;
  const dim3 grid((R + MROWS - 1) / MROWS, B * Hkv, chunks);
  flash_fwd_mma<D><<<grid, MW * 32, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, part, H, Hkv, Sq, Sk, qs,
      ks, vs, causal, q_offset, (tiles + chunks - 1) / chunks,
      1.4426950408889634f / sqrtf((float)D));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return (int)e;
  flash_merge<<<B * Sq * H, MERGE_NT, 0, st>>>(part, (__nv_bfloat16*)o, D,
                                              chunks);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hkv, D): element strides of the batch,
// sequence and head dimensions (the last dimension contiguous), all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1); o (B, Sq, H, D)
// contiguous, of the same type.  mma = 1 launches the tensor-core kernel
// (bf16, D % 16 == 0, D <= 128, q/k/v 16-byte aligned, strides a multiple
// of 8) over `chunks` kv chunks; with chunks > 1, part holds
// B * Sq * H * chunks * (D + 2) floats of scratch.  mma = 0 launches the
// SIMT kernel.  Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int bf16, int B,
    int H, int Hkv, int Sq, int Sk, int D, long long qb, long long qsq,
    long long qh, long long kb, long long ksk, long long kh, long long vb,
    long long vsk, long long vh, int causal, int q_offset, int mma,
    int chunks, float* part, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1 || D < 1 ||
      D > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qb, qsq, qh}, ks{kb, ksk, kh}, vs{vb, vsk, vh};
  cudaStream_t st = (cudaStream_t)stream;
  if (mma) {
    bool ok = bf16 && D % 16 == 0 && D <= 128 && chunks >= 1 &&
              chunks <= 65535 && (chunks == 1 || part != nullptr) &&
              aligned16(q) && aligned16(k) && aligned16(v);
    const long long strides[] = {qb, qsq, qh, kb, ksk, kh, vb, vsk, vh};
    for (long long s : strides) ok = ok && s % 8 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    switch (D) {
#define FLASH_MMA(d)                                                         \
  case d:                                                                    \
    return launch_mma<d>(q, k, v, o, part, B, H, Hkv, Sq, Sk, qs, ks, vs,    \
                         causal, q_offset, chunks, st);
      FLASH_MMA(16) FLASH_MMA(32) FLASH_MMA(48) FLASH_MMA(64)
      FLASH_MMA(80) FLASH_MMA(96) FLASH_MMA(112) FLASH_MMA(128)
#undef FLASH_MMA
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (bf16)
    return dispatch_simt<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, qs,
                                        ks, vs, causal, q_offset, st);
  return dispatch_simt<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, qs, ks, vs,
                              causal, q_offset, st);
}
