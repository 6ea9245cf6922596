// Block-sparse paged attention over the KV block pool, for sm_90a.
//
// Pool layout (NB, BS, Hkv, D): physical block, token in block, kv head,
// head dim; q/out (B or 1, S, H, D) with head h = g * rep + r for kv head g.
//
// paged_decode_split + paged_decode_merge (flash-decoding)
//   Replaces repro/kernels/paged_attention.py::paged_decode_attention_kernel
//   (body _paged_decode_kernel).  Grid (slot b, kv head g, split): each
//   block takes its own run of NB_SPLIT logical blocks of b's table row,
//   clipped to the readable prefix: below ceil(cache_len / BS) and before
//   the row's first -1 entry (mapped entries form a prefix of a row, so
//   this is the gather reference's mapped_span clamp; block 0 is never
//   read in place of an unmapped entry).  Its 4 warps take the run's
//   tokens in turn; a warp holds the rep = H / Hkv query rows of the group
//   across its lanes (head dim d on lane d % 32), reduces each score with
//   shuffles and keeps an online softmax and p @ V in f32 registers.  The
//   warps merge in shared memory into one (max, sum, acc) partial per
//   (b, head, split); the merge kernel combines the splits.  A slot with no
//   readable position returns NaN, like the reference softmax over an
//   all -inf row.
//   Bound: bytes of K and V actually cached (each read once) over the
//   memory rate; at serving batch that is well under a microsecond, so
//   latency bounds it: the splits spread a slot's walk over many SMs
//   (one block per (slot, kv head) left 124 of 132 SMs idle and walked
//   the blocks one after another).
//
// Prefill: both kernels replace
//   repro/kernels/paged_attention.py::paged_prefill_attention_kernel (body
//   _paged_prefill_kernel).  Causal multi-query attention of one slot's
//   prompt chunk (S queries at absolute positions offset + [0, S)) over the
//   leading `span` tokens of its table row; -1 entries read physical block
//   0 and are NOT masked, exactly like the gather reference.  Query rows
//   are packed per kv head, row r = replica * S + query, so the rep heads
//   of a group share every K/V tile.  The softmax is online with the
//   reference's -inf guards (m2s = 0 where m2 = -inf, p = 0 where
//   s = -inf, corr = 0 where m = -inf), and the output is
//   acc / max(l, 1e-20): a fully masked row gives 0, not NaN.
//
// paged_prefill_mma (bf16, D a multiple of 16)
//   Bound at the served shape (S 64, span 256, H 12, Hkv 2, D 128): Q, the
//   span's K and V and the output, each moved once, 0.66 MB, 0.000196 ms
//   at the memory rate; about 50 MFLOP of products, 0.05 us at the bf16
//   tensor-core rate.  The call is therefore latency-bound: its time is a
//   chain of dependent loads, products and reductions.  What the design
//   does about it:
//   - a warp owns 16 query rows and a block PF_WARPS = 4 warps, so the
//     served shape (384 rows per kv head, Hkv 2) runs 48 warps in 12
//     blocks.  A tile's 32 KB copy, not its products, sets the time per
//     tile: with 2 warps per block (24 blocks) a warp waited on its
//     copies for longer than its products and softmax took, and the
//     wait shrank with more warps sharing the copy.  4 warps measured
//     fastest on an H100; 8 (6 blocks) were slower again;
//   - keys come in tiles of 64, gathered through the block row with
//     16-byte cp.async into shared memory (row pitch D + 8 bf16, so the
//     eight rows of an ldmatrix fall on distinct banks), double-buffered:
//     tile t + 1 is in flight while tile t is computed; keys past the
//     span are zero-filled, never read;
//   - Q.K^T and P.V run on the tensor cores (mma.sync m16n8k16 bf16, f32
//     accumulators; mma_tile.cuh): the warp's Q fragment stays in
//     registers for the whole walk, P is rounded to bf16 once and feeds
//     P.V from registers, V comes through ldmatrix.trans;
//   - one sweep with an online rescale per tile (the SIMT kernel sweeps
//     twice per kv_chunk group); kv_chunk is a schedule of the TPU kernel
//     and does not change the function, so this kernel ignores it;
//   - a tile whose first key lies above the block's highest query
//     position is neither loaded nor computed: under the guards it adds
//     nothing.  At offset 0 and span 256 a block walks 1 tile of 4.
//   The scale 1/sqrt(D) multiplies the f32 scores after the product, as
//   in the TPU kernel.  The mask position and the output address are
//   computed per row: rows of a warp cross a replica boundary when S is
//   not a multiple of 16.
//   The epilogue multiplies by one reciprocal a row: 64 divisions a
//   thread took longer than a tile's products.
//   ptxas -v on an H100 build (sm_90a, CUDA 12.8), registers per
//   thread: D 128 226, D 112 211, D 96 168, D 80 157, D 64 128, D 48 122,
//   D 32 96, D 16 80; no spills.  SASS: 128 HMMA at D 128 (64 for
//   Q.K^T, 64 for P.V per tile).
//
// paged_prefill_simt (f32, or bf16 with D not a multiple of 16)
//   Grid (kv head, tile of 16 query rows); each block walks the keys in
//   16-token tiles, per kv_chunk group twice: a first sweep takes the
//   group's row max, a second accumulates p = exp(s - m) and p @ V after
//   rescaling by exp(m_old - m).  SIMT f32 arithmetic, one head-dim
//   column per thread.
//
// All keep D <= 128 and rep <= 16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int NTH = 128;     // threads per block
constexpr int MAXREP = 16;   // query heads per kv head
constexpr int MAXD = 128;    // head dim
constexpr int KT = 16;       // keys per tile (prefill)
constexpr int QT = 16;       // query rows per block (prefill)
constexpr int DW = NTH / 32; // warps per block (decode)
constexpr int DPL = MAXD / 32;  // head dims per lane (decode)

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NTH)
    paged_decode_split(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ table,
                       const int* __restrict__ lens, float* __restrict__ part,
                       int H, int Hkv, int D, int BS, int MB, int NS,
                       int nb_split, float scale) {
  extern __shared__ float sm[];  // [DW][rep][D] acc, [DW][rep] max, sum
  __shared__ int readable;
  const int b = blockIdx.x, g = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rep = H / Hkv;
  const int len = lens[b];
  const int j0 = sp * nb_split;
  const int j1 = min(min((len + BS - 1) / BS, MB), j0 + nb_split);

  // the readable prefix ends at the first -1 entry below j1
  if (tid == 0) readable = j1;
  __syncthreads();
  for (int j = tid; j < j1; j += NTH)
    if (table[(size_t)b * MB + j] < 0) atomicMin(&readable, j);
  __syncthreads();
  const int t_end = min(readable * BS, len);

  float qr[MAXREP][DPL], acc[MAXREP][DPL], mx[MAXREP], sum[MAXREP];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    mx[r] = -INFINITY;
    sum[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[r][i] = (r < rep && d < D)
                     ? ld(q + ((size_t)b * H + g * rep + r) * D + d) * scale
                     : 0.f;
      acc[r][i] = 0.f;
    }
  }

  for (int t = j0 * BS + warp; t < t_end; t += DW) {
    const int phys = table[(size_t)b * MB + t / BS];
    const size_t row = (((size_t)phys * BS + t % BS) * Hkv + g) * D;
    float kk[DPL], vv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kk[i] = d < D ? ld(kp + row + d) : 0.f;
      vv[i] = d < D ? ld(vp + row + d) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r < rep) {  // uniform across the warp
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) s += qr[r][i] * kk[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        const float m_new = fmaxf(mx[r], s);
        const float corr = expf(mx[r] - m_new);  // 0 on the first token
        const float p = expf(s - m_new);
        sum[r] = sum[r] * corr + p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * corr + p * vv[i];
        mx[r] = m_new;
      }
    }
  }

  // merge the warps: a warp that saw no token holds (-inf, 0, 0)
  float* acc_s = sm;                          // [DW][rep][D]
  float* mx_s = acc_s + (size_t)DW * rep * D;  // [DW][rep]
  float* sum_s = mx_s + DW * rep;              // [DW][rep]
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r < rep) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc_s[((size_t)warp * rep + r) * D + d] = acc[r][i];
      }
      if (lane == 0) {
        mx_s[warp * rep + r] = mx[r];
        sum_s[warp * rep + r] = sum[r];
      }
    }
  }
  __syncthreads();
  // part (B, H, NS, D + 2): acc[D], max, sum of this split
  for (int p = tid; p < rep * D; p += NTH) {
    const int r = p / D, d = p % D;
    float m = -INFINITY;
    for (int w = 0; w < DW; ++w) m = fmaxf(m, mx_s[w * rep + r]);
    float l = 0.f, a = 0.f;
    if (m != -INFINITY) {
      for (int w = 0; w < DW; ++w) {
        const float mw = mx_s[w * rep + r];
        if (mw == -INFINITY) continue;
        const float c = expf(mw - m);
        l += sum_s[w * rep + r] * c;
        a += acc_s[((size_t)w * rep + r) * D + d] * c;
      }
    }
    float* dst = part + (((size_t)b * H + g * rep + r) * NS + sp) * (D + 2);
    dst[d] = a;
    if (d == 0) {
      dst[D] = m;
      dst[D + 1] = l;
    }
  }
}

// one block per (slot, head), one thread per head dim: combines the splits
template <typename T>
__global__ void __launch_bounds__(MAXD)
    paged_decode_merge(const float* __restrict__ part, T* __restrict__ out,
                       int D, int NS) {
  const int bh = blockIdx.x, d = threadIdx.x;
  if (d >= D) return;
  const float* src = part + (size_t)bh * NS * (D + 2);
  float m = -INFINITY;
  for (int s = 0; s < NS; ++s) m = fmaxf(m, src[(size_t)s * (D + 2) + D]);
  float l = 0.f, a = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < NS; ++s) {
      const float* ps = src + (size_t)s * (D + 2);
      if (ps[D] == -INFINITY) continue;
      const float c = expf(ps[D] - m);
      l += ps[D + 1] * c;
      a += ps[d] * c;
    }
  }
  // nothing readable: NaN, the reference's fully masked softmax
  st(out + (size_t)bh * D + d, l > 0.f ? a / l : NAN);
}

// scores of the block's query rows against one key tile; masked -> -inf
__device__ __forceinline__ void prefill_scores(
    const float* q_s, const float* k_s, float* s_s, int r0, int R, int S,
    int offset, int kt, int nkeys, int D, float scale) {
  for (int p = threadIdx.x; p < QT * KT; p += NTH) {
    const int i = p / KT, t = p % KT;
    const int r = r0 + i;
    float s = -INFINITY;
    if (r < R && t < nkeys && kt + t <= offset + r % S) {
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += q_s[i * D + d] * k_s[t * (D + 1) + d];
      s = dot * scale;
    }
    s_s[p] = s;
  }
}

template <typename T>
__device__ __forceinline__ void prefill_load(
    const T* __restrict__ pool, const int* __restrict__ row, float* dst,
    int kt, int nkeys, int Hkv, int g, int D, int BS, int pitch) {
  for (int i = threadIdx.x; i < KT * D; i += NTH) {
    const int t = i / D, d = i % D;
    if (t < nkeys) {
      const int pos = kt + t;
      const int phys = max(row[pos / BS], 0);  // -1 reads block 0, unmasked
      dst[t * pitch + d] =
          ld(pool + (((size_t)phys * BS + pos % BS) * Hkv + g) * D + d);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTH)
    paged_prefill_simt(const T* __restrict__ q, const T* __restrict__ kp,
                         const T* __restrict__ vp,
                         const int* __restrict__ row, int offset, int span,
                         int kc, T* __restrict__ out, int S, int H, int Hkv,
                         int D, int BS, float scale) {
  __shared__ float q_s[QT * MAXD];
  __shared__ float k_s[KT * (MAXD + 1)];
  __shared__ float v_s[KT * MAXD];
  __shared__ float s_s[QT * KT];
  __shared__ float gmax_s[QT], m_s[QT], l_s[QT], c_s[QT], m2s_s[QT];
  const int g = blockIdx.x, tid = threadIdx.x;
  const int rep = H / Hkv;
  const int R = rep * S;  // rows (replica, query) -> replica * S + query
  const int r0 = blockIdx.y * QT;

  for (int i = tid; i < QT * D; i += NTH) {
    const int ii = i / D, d = i % D;
    const int r = r0 + ii;
    float val = 0.f;
    if (r < R) {
      const int h = g * rep + r / S, qi = r % S;
      val = ld(q + ((size_t)qi * H + h) * D + d);
    }
    q_s[i] = val;
  }
  if (tid < QT) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int k_lo = 0; k_lo < span; k_lo += kc) {
    const int k_hi = min(k_lo + kc, span);
    // sweep 1: the group's row max
    if (tid < QT) gmax_s[tid] = -INFINITY;
    for (int kt = k_lo; kt < k_hi; kt += KT) {
      const int nkeys = min(KT, k_hi - kt);
      __syncthreads();
      prefill_load(kp, row, k_s, kt, nkeys, Hkv, g, D, BS, D + 1);
      __syncthreads();
      prefill_scores(q_s, k_s, s_s, r0, R, S, offset, kt, nkeys, D, scale);
      __syncthreads();
      if (tid < QT) {
        float mx = gmax_s[tid];
        for (int t = 0; t < KT; ++t) mx = fmaxf(mx, s_s[tid * KT + t]);
        gmax_s[tid] = mx;
      }
    }
    __syncthreads();
    // group boundary: the reference's guarded rescale
    if (tid < QT) {
      const float m_old = m_s[tid];
      const float m2 = fmaxf(m_old, gmax_s[tid]);
      const float m2s = isinf(m2) ? 0.f : m2;
      const float corr = isinf(m_old) ? 0.f : expf(m_old - m2s);
      l_s[tid] *= corr;
      c_s[tid] = corr;
      m2s_s[tid] = m2s;
      m_s[tid] = m2;
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
      for (int i = 0; i < QT; ++i) acc[i] *= c_s[i];
    }
    // sweep 2: p = exp(s - m) and p @ V
    for (int kt = k_lo; kt < k_hi; kt += KT) {
      const int nkeys = min(KT, k_hi - kt);
      __syncthreads();
      prefill_load(kp, row, k_s, kt, nkeys, Hkv, g, D, BS, D + 1);
      prefill_load(vp, row, v_s, kt, nkeys, Hkv, g, D, BS, D);
      __syncthreads();
      prefill_scores(q_s, k_s, s_s, r0, R, S, offset, kt, nkeys, D, scale);
      __syncthreads();
      for (int p = tid; p < QT * KT; p += NTH) {
        const float s = s_s[p];
        s_s[p] = isinf(s) ? 0.f : expf(s - m2s_s[p / KT]);
      }
      __syncthreads();
      if (tid < QT) {
        float sum = 0.f;
        for (int t = 0; t < KT; ++t) sum += s_s[tid * KT + t];
        l_s[tid] += sum;
      }
      if (tid < D) {
        for (int t = 0; t < nkeys; ++t) {
          const float vv = v_s[t * D + tid];
#pragma unroll
          for (int i = 0; i < QT; ++i) acc[i] += s_s[i * KT + t] * vv;
        }
      }
    }
    __syncthreads();
  }
  if (tid < D) {
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const int r = r0 + i;
      if (r < R) {
        const int h = g * rep + r / S, qi = r % S;
        st(out + ((size_t)qi * H + h) * D + tid,
           acc[i] / fmaxf(l_s[i], 1e-20f));
      }
    }
  }
}

constexpr int PF_WARPS = 4;              // warps per block, 16 rows each
constexpr int PF_ROWS = 16 * PF_WARPS;   // query rows per block
constexpr int PF_KT = 64;                // keys per tile
constexpr int PF_PAD = 8;                // bf16 of padding per smem row

template <int D>
constexpr size_t prefill_mma_smem() {  // 2 stages x (K, V) x PF_KT rows
  return sizeof(__nv_bfloat16) * 2 * 2 * PF_KT * (D + PF_PAD);
}

template <int D>
__global__ void __launch_bounds__(PF_WARPS * 32)
    paged_prefill_mma(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ kp,
                      const __nv_bfloat16* __restrict__ vp,
                      const int* __restrict__ row, int offset, int span,
                      __nv_bfloat16* __restrict__ out, int S, int H, int Hkv,
                      int BS, float scale) {
  using namespace mma_tile;
  constexpr int P = D + PF_PAD;  // smem row pitch (bf16)
  constexpr int KS = D / 16;     // k-steps of Q.K^T
  constexpr int DN = D / 8;      // 8-wide n-tiles of the output
  constexpr int CH = D / 8;      // 16-byte chunks of a key row
  extern __shared__ __align__(16) __nv_bfloat16 kv_s[];  // [2][K, V][KT][P]
  const int g = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the lane's group and quad place
  const int rep = H / Hkv, R = rep * S;
  const int rb = blockIdx.y * PF_ROWS;      // the block's first row

  // walk no tile whose first key lies above the block's highest position
  const int last = min(rb + PF_ROWS, R) - 1;
  const int qmax = offset + (last / S != rb / S ? S - 1 : last % S);
  const int ntiles =
      qmax < 0 ? 0 : min((span + PF_KT - 1) / PF_KT, qmax / PF_KT + 1);

  // the block's threads share a tile's 16-byte copies, neighbouring
  // threads on neighbouring chunks of a key row
  auto load_tile = [&](int t) {
    __nv_bfloat16* ks = kv_s + (t & 1) * 2 * PF_KT * P;
    __nv_bfloat16* vs = ks + PF_KT * P;
#pragma unroll
    for (int j = 0; j < PF_KT * CH / (PF_WARPS * 32); ++j) {
      const int i = tid + j * PF_WARPS * 32;
      const int key = i / CH, c = i % CH;
      const int pos = t * PF_KT + key;
      const bool live = pos < span;  // past the span: zero-filled
      size_t src = 0;
      if (live) {
        const int phys = max(row[pos / BS], 0);  // -1 reads block 0
        src = (((size_t)phys * BS + pos % BS) * Hkv + g) * D + c * 8;
      }
      cp_async_16(ks + key * P + c * 8, kp + src, live);
      cp_async_16(vs + key * P + c * 8, vp + src, live);
    }
    cp_async_commit();
  };
  if (ntiles > 0) load_tile(0);

  // this lane's two rows (those of c[0..1] and of c[2..3]); Q fragments
  // straight from global memory, zero past the last row
  const int r_lo = rb + warp * 16 + gq, r_hi = r_lo + 8;
  const __nv_bfloat16* q_lo =
      r_lo < R ? q + ((size_t)(r_lo % S) * H + g * rep + r_lo / S) * D
               : nullptr;
  const __nv_bfloat16* q_hi =
      r_hi < R ? q + ((size_t)(r_hi % S) * H + g * rep + r_hi / S) * D
               : nullptr;
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * tq;
    qf[kk][0] = q_lo ? *reinterpret_cast<const uint32_t*>(q_lo + c) : 0u;
    qf[kk][1] = q_hi ? *reinterpret_cast<const uint32_t*>(q_hi + c) : 0u;
    qf[kk][2] = q_lo ? *reinterpret_cast<const uint32_t*>(q_lo + c + 8) : 0u;
    qf[kk][3] = q_hi ? *reinterpret_cast<const uint32_t*>(q_hi + c + 8) : 0u;
  }
  const int qp_lo = offset + r_lo % S, qp_hi = offset + r_hi % S;

  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;  // this lane's share of its rows' sums

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1);  // into the other buffer, freed by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kv_s + (t & 1) * 2 * PF_KT * P;
    const __nv_bfloat16* vs = ks + PF_KT * P;

    // s = Q.K^T: 8 n-tiles of 8 keys; an x4 ldmatrix gives the B
    // fragments of two n-tiles (K rows are B's columns)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        const int key = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b, ks + key * P + col);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask, and the tile's online softmax step with the guards
    const int k0 = t * PF_KT;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
        const bool ok = kpos < span && kpos <= (e < 2 ? qp_lo : qp_hi);
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float ms_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float ms_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float c_lo = m_lo == -INFINITY ? 0.f : __expf(m_lo - ms_lo);
    const float c_hi = m_hi == -INFINITY ? 0.f : __expf(m_hi - ms_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p =
            x == -INFINITY ? 0.f : __expf(x - (e < 2 ? ms_lo : ms_hi));
        s[j][e] = p;
        (e < 2 ? sum_lo : sum_hi) += p;
      }
    }
    l_lo = l_lo * c_lo + sum_lo;
    l_hi = l_hi * c_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      o[n][0] *= c_lo;
      o[n][1] *= c_lo;
      o[n][2] *= c_hi;
      o[n][3] *= c_hi;
    }

    // o += P.V: P (rounded to bf16) from registers, 16 keys per k-step;
    // an x4 ldmatrix.trans gives the B fragments of two output n-tiles
#pragma unroll
    for (int kk = 0; kk < PF_KT / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, vs + key * P + col);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  // acc / max(l, 1e-20), per row, as bf16 pairs (one reciprocal a row)
  const float d_lo = 1.f / fmaxf(quad_sum(l_lo), 1e-20f);
  const float d_hi = 1.f / fmaxf(quad_sum(l_hi), 1e-20f);
  if (r_lo < R) {
    __nv_bfloat16* dst =
        out + ((size_t)(r_lo % S) * H + g * rep + r_lo / S) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(o[n][0] * d_lo, o[n][1] * d_lo);
  }
  if (r_hi < R) {
    __nv_bfloat16* dst =
        out + ((size_t)(r_hi % S) * H + g * rep + r_hi / S) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(o[n][2] * d_hi, o[n][3] * d_hi);
  }
}

template <int D>
int launch_prefill_mma(const void* q, const void* kp, const void* vp,
                       const int* row, int offset, int span, void* out, int S,
                       int H, int Hkv, int BS, cudaStream_t st) {
  constexpr size_t smem = prefill_mma_smem<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      paged_prefill_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int R = (H / Hkv) * S;
  const dim3 grid(Hkv, (R + PF_ROWS - 1) / PF_ROWS);
  paged_prefill_mma<D><<<grid, PF_WARPS * 32, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, row, offset, span, (__nv_bfloat16*)out, S, H,
      Hkv, BS, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

bool shapes_ok(int H, int Hkv, int D, int BS) {
  return Hkv > 0 && H % Hkv == 0 && H / Hkv <= MAXREP && D > 0 &&
         D <= MAXD && BS > 0;
}

}  // namespace

// q (B, 1, H, D); pools (NB, BS, Hkv, D); table (B, MB); lens (B,); out like
// q; part: B * H * NS * (D + 2) floats of scratch, NS = ceil(MB / nb_split).
// Returns cudaGetLastError() after the two launches.
extern "C" int repro_paged_decode(const void* q, const void* kp,
                                  const void* vp, const int* table,
                                  const int* lens, void* out, float* part,
                                  int B, int H, int Hkv, int D, int BS, int MB,
                                  int nb_split, int bf16, void* stream) {
  if (B < 1 || MB < 1 || nb_split < 1 || !shapes_ok(H, Hkv, D, BS))
    return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  const int NS = (MB + nb_split - 1) / nb_split;
  const size_t smem = sizeof(float) * (size_t)DW * rep * (D + 2);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv, NS);
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    paged_decode_split<__nv_bfloat16><<<grid, NTH, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
        (const __nv_bfloat16*)vp, table, lens, part, H, Hkv, D, BS, MB, NS,
        nb_split, scale);
    paged_decode_merge<__nv_bfloat16><<<B * H, MAXD, 0, st>>>(
        part, (__nv_bfloat16*)out, D, NS);
  } else {
    paged_decode_split<float><<<grid, NTH, smem, st>>>(
        (const float*)q, (const float*)kp, (const float*)vp, table, lens, part,
        H, Hkv, D, BS, MB, NS, nb_split, scale);
    paged_decode_merge<float><<<B * H, MAXD, 0, st>>>(part, (float*)out, D,
                                                      NS);
  }
  return (int)cudaGetLastError();
}

// q (1, S, H, D) at absolute positions offset + [0, S); pools (NB, BS, Hkv,
// D); row (NBLK,) covering span tokens; out like q.  mma = 1 launches the
// tensor-core kernel (bf16 and D % 16 == 0 only), mma = 0 the SIMT one.
extern "C" int repro_paged_prefill(const void* q, const void* kp,
                                   const void* vp, const int* row, int offset,
                                   int span, int kv_chunk, void* out, int S,
                                   int H, int Hkv, int D, int BS, int NBLK,
                                   int bf16, int mma, void* stream) {
  if (S < 1 || span < 1 || kv_chunk < 1 || NBLK * BS < span ||
      !shapes_ok(H, Hkv, D, BS) || (mma && (!bf16 || D % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mma) {
    switch (D) {
#define PREFILL_MMA(d)                                                        \
  case d:                                                                     \
    return launch_prefill_mma<d>(q, kp, vp, row, offset, span, out, S, H,     \
                                 Hkv, BS, st);
      PREFILL_MMA(16) PREFILL_MMA(32) PREFILL_MMA(48) PREFILL_MMA(64)
      PREFILL_MMA(80) PREFILL_MMA(96) PREFILL_MMA(112) PREFILL_MMA(128)
#undef PREFILL_MMA
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const int kc = kv_chunk < span ? kv_chunk : span;
  const int R = (H / Hkv) * S;
  const dim3 grid(Hkv, (R + QT - 1) / QT);
  const float scale = 1.0f / sqrtf((float)D);
  if (bf16)
    paged_prefill_simt<__nv_bfloat16><<<grid, NTH, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
        (const __nv_bfloat16*)vp, row, offset, span, kc, (__nv_bfloat16*)out,
        S, H, Hkv, D, BS, scale);
  else
    paged_prefill_simt<float><<<grid, NTH, 0, st>>>(
        (const float*)q, (const float*)kp, (const float*)vp, row, offset,
        span, kc, (float*)out, S, H, Hkv, D, BS, scale);
  return (int)cudaGetLastError();
}
