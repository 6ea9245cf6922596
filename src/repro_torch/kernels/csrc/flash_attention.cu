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
// otherwise take exp(0) = 1 per masked key), o = acc / max(l, 1e-20).
// Math and state are float32; q, k, v and o are float32 or bfloat16 (o
// takes q's type).  D <= 256.
//
// What bounds it: at B 4, Sq = Sk = 2048, H 12, D 128, causal, 51.5 GFLOP
// of QK^T and PV against 25 MB of q/k/v/o: operations, by far.  This is
// the SIMT port (f32 FMAs on the CUDA cores, 0.77 ms at their peak); the
// bf16 tensor cores (wgmma) would take 0.052 ms and are later work.
//
// Design: one block of 256 threads per (b * H + h, 64 query rows).  The q
// tile stays in shared memory as f32; each 64-key tile of K, then of V,
// is staged into one shared buffer (rows padded by 4 floats so the float4
// reads of 16 lanes hit distinct banks).  A thread owns 4 query rows and
// 4 key columns of the score tile (columns tx + 16 j, conflict-free), and
// 4 rows x D/16 dimensions of the output; the 16 lanes sharing a row
// reduce its max and sum by shuffles, so the (m, l) state and the
// correction factor stay in registers.  Under causal the loop stops at the
// last key any row of the block may see: tiles wholly above the diagonal
// are skipped (their p is 0 and their correction 1, so nothing changes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "convert.cuh"

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
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
              int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs,
              int causal, int q_offset, float scale) {
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
int launch(const T* q, const T* k, const T* v, T* o, int B, int H, int Hkv,
           int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs,
           int causal, int q_offset, cudaStream_t st) {
  constexpr int LD = DM + PAD;
  constexpr size_t smem = (size_t)(BQ * LD + BK * LD + BQ * LP) * 4;
  static bool attr_set = false;  // once per instantiation, before any capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd<T, DM><<<grid, NT, smem, st>>>(
      q, k, v, o, H, Hkv, Sq, Sk, D, qs, ks, vs, causal, q_offset,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int Sq, int Sk, int D, Strides qs, Strides ks,
             Strides vs, int causal, int q_offset, cudaStream_t st) {
  const T *qq = (const T*)q, *kk = (const T*)k, *vv = (const T*)v;
  T* oo = (T*)o;
  if (D <= 64)
    return launch<T, 64>(qq, kk, vv, oo, B, H, Hkv, Sq, Sk, D, qs, ks, vs,
                         causal, q_offset, st);
  if (D <= 128)
    return launch<T, 128>(qq, kk, vv, oo, B, H, Hkv, Sq, Sk, D, qs, ks, vs,
                          causal, q_offset, st);
  return launch<T, 256>(qq, kk, vv, oo, B, H, Hkv, Sq, Sk, D, qs, ks, vs,
                        causal, q_offset, st);
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hkv, D): element strides of the batch,
// sequence and head dimensions (the last dimension contiguous), all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1); o (B, Sq, H, D)
// contiguous, of the same type.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int bf16, int B,
    int H, int Hkv, int Sq, int Sk, int D, long long qb, long long qsq,
    long long qh, long long kb, long long ksk, long long kh, long long vb,
    long long vsk, long long vh, int causal, int q_offset, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1 || D < 1 ||
      D > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qb, qsq, qh}, ks{kb, ksk, kh}, vs{vb, vsk, vh};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, qs, ks,
                                   vs, causal, q_offset, st);
  return dispatch<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, qs, ks, vs, causal,
                         q_offset, st);
}
