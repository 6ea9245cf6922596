// Block-sparse paged attention over the KV block pool, for sm_90a.
//
// Pool layout (NB, BS, Hkv, D): physical block, token in block, kv head,
// head dim; q/out (B or 1, S, H, D) with head h = g * rep + r for kv head g.
//
// Decode: both kernels replace
//   repro/kernels/paged_attention.py::paged_decode_attention_kernel (body
//   _paged_decode_kernel).  One query per slot over the readable prefix of
//   its table row: below ceil(cache_len / BS) and before the row's first -1
//   entry (mapped entries form a prefix of a row, so this is the gather
//   reference's mapped_span clamp; block 0 is never read in place of an
//   unmapped entry).  A slot with no readable position returns NaN, like
//   the reference softmax over an all -inf row.  Bound: the bytes of K and
//   V actually cached (each read once) over the memory rate; at serving
//   batch that is well under a microsecond, so latency bounds both: the
//   (slot, kv head, split) grid spreads a slot's walk over many SMs.
//
// paged_decode_mma (bf16, D a multiple of 16): one launch
//   - a warp holds the group's rep <= 16 query rows as one m16 A fragment
//     (rows rep..15 zero), loaded once, and walks 16-key tiles: S = Q.K^T
//     and P.V run on the tensor cores (mma.sync m16n8k16 bf16, f32
//     accumulators; mma_tile.cuh), 16 + 16 HMMA a tile at D 128.  The
//     scale 1/sqrt(D) multiplies the f32 scores after the product, as in
//     the TPU kernel; P is rounded to bf16 once and feeds P.V from
//     registers (the row sums keep the f32 P);
//   - the table row is scanned for a -1 entry while Q and the depth load;
//     a tile is gathered key by key through it (any BS), each key row
//     D bf16 copied with 16-byte cp.async into shared memory
//     (row pitch D + 8, so the eight rows of an ldmatrix fall on distinct
//     banks), DK_STAGES tiles a warp in flight.  Keys past the readable
//     prefix are zero-filled and masked to -inf, never read from the pool;
//   - grid (slot, kv head, split): a split is `tiles` consecutive tiles,
//     its DK_WARPS warps take them in turn and merge in shared memory.
//     The splits that read a key (nlive, the same in every block: it
//     follows from lens and the table) each write one f32 (max, sum, acc)
//     partial; the last to finish for its (slot, kv head), found by one
//     acq_rel atomicAdd on a device counter, merges them, writes the
//     output and sets the counter back to 0.  With one live split the
//     block writes the output itself; splits past the prefix return.
//     Partials and counters live in a workspace the wrapper allocates
//     once per device: nothing is zeroed per call and no host value
//     changes per call, so a captured CUDA graph replays it with new
//     depths in lens.
//   What bounds it: latency.  At the served case (B 4, depths 288 / 150 /
//   17 / 0, 4 tiles a split, one tile a warp) clock stamps of one call on
//   an H100 (repro_torch.kernels.decode_variants --timeline) read, per
//   block: Q, the depth and the table in 0.86 us, the tile landed 1.1 us
//   later, its products and softmax 0.8 us, the warps' merge 0.5, the
//   partial and the counter 1.1, then the last block's copy of the
//   partials 0.7 and its merge 1.0-1.4 us.  That merge runs once per (slot, kv head), on
//   an SM whose instruction cache has not seen it: fully unrolled loops
//   over 16 elements and 8 splits took 2.1 us there with their loads and
//   sums removed, so the merges take float4s and roll the split loops.
//   ptxas (sm_90a, CUDA 12.8): 151 registers at D 128, no spills; SASS:
//   32 HMMA at D 128 (16 for Q.K^T, 16 for P.V per tile).
//
// paged_decode_simt + paged_decode_simt_merge (f32, or bf16 with D not a
//   multiple of 16): flash-decoding in two launches.  Grid (slot, kv head,
//   split): each block takes its own run of NB_SPLIT logical blocks of the
//   row, clipped to the readable prefix.  Its 4 warps take the run's tokens
//   in turn; a warp holds the rep query rows of the group across its lanes
//   (head dim d on lane d % 32), reduces each score with shuffles and keeps
//   an online softmax and p @ V in f32 registers.  The warps merge in
//   shared memory into one (max, sum, acc) partial per (b, head, split);
//   the merge kernel combines the splits.
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
    paged_decode_simt(const T* __restrict__ q, const T* __restrict__ kp,
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
    paged_decode_simt_merge(const float* __restrict__ part, T* __restrict__ out,
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

constexpr int DK_WARPS = 4;    // warps per block (decode mma)
constexpr int DK_T = 16;       // keys per tile (decode mma)
constexpr int DK_STAGES = 2;   // tiles a warp has in flight
constexpr int DK_PAD = 8;      // bf16 of padding per smem K/V row
constexpr int DK_APAD = 8;     // f32 of padding per smem acc row (the merge)
constexpr int DK_CHUNK = 8;    // splits the last block merges at a time
static_assert(DK_CHUNK >= DK_WARPS, "the merges share their weights' array");

// shared memory of the K/V buffers, in floats: per warp DK_STAGES x (K, V)
// x DK_T rows of D + DK_PAD bf16.  The warps' merge (acc [DK_WARPS][16][D +
// DK_APAD]) and the last block's partials reuse it.
template <int D>
__host__ __device__ constexpr int decode_mma_floats() {
  return DK_WARPS * DK_STAGES * 2 * DK_T * (D + DK_PAD) / 2;
}

// v * scale as four bf16 at dst (8-byte aligned)
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v,
                                             float scale) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(mma_tile::pack_bf16(v.x * scale, v.y * scale),
                 mma_tile::pack_bf16(v.z * scale, v.w * scale));
}

template <int D>
__global__ void __launch_bounds__(DK_WARPS * 32)
    paged_decode_mma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ kp,
                     const __nv_bfloat16* __restrict__ vp,
                     const int* __restrict__ table,
                     const int* __restrict__ lens,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                     int* __restrict__ count, int H, int Hkv, int BS, int MB,
                     int NS, int tiles, float scale) {
  using namespace mma_tile;
  constexpr int P = D + DK_PAD;    // smem K/V row pitch (bf16)
  constexpr int AP = D + DK_APAD;  // smem acc row pitch (f32)
  constexpr int PP = D + 4;  // partial row (f32): acc[D], max, sum, and 2
                             // of padding, 16-byte aligned for cp.async
  constexpr int KS = D / 16;       // k-steps of Q.K^T
  constexpr int DN = D / 8;        // 8-wide n-tiles of the output
  constexpr int CH = D / 8;        // 16-byte chunks of a key row
  constexpr int NT = DK_WARPS * 32;
  constexpr int E4 = (4 * D + NT - 1) / NT;  // float4s of the output a
                                             // thread takes, rep 16
  extern __shared__ __align__(16) unsigned char dk_smem[];
  __shared__ float wt_s[DK_CHUNK * 16], sum_s[DK_WARPS * 16];  // the merges:
  __shared__ float rowm_s[16], rowl_s[16], rowf_s[16];  // weights, sums
  __shared__ int readable_s;
  __shared__ bool last_s;
  const int b = blockIdx.x, g = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the lane's group and quad place
  const int rep = H / Hkv;
  const int* trow = table + (size_t)b * MB;

  // the Q fragment of the group's rows (rows rep..15 zero), the depth and
  // the table row in flight at once; this lane's rows are gq and gq + 8
  const __nv_bfloat16* qg = q + ((size_t)b * H + g * rep) * D;
  const bool lo_ok = gq < rep, hi_ok = gq + 8 < rep;
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * tq;
    const __nv_bfloat16* lo = qg + gq * D + c;
    const __nv_bfloat16* hi = lo + 8 * D;
    qf[kk][0] = lo_ok ? *reinterpret_cast<const uint32_t*>(lo) : 0u;
    qf[kk][1] = hi_ok ? *reinterpret_cast<const uint32_t*>(hi) : 0u;
    qf[kk][2] = lo_ok ? *reinterpret_cast<const uint32_t*>(lo + 8) : 0u;
    qf[kk][3] = hi_ok ? *reinterpret_cast<const uint32_t*>(hi + 8) : 0u;
  }
  const int len = lens[b];
  if (tid == 0) readable_s = MB;
  __syncthreads();
  // the readable prefix ends at the first -1 entry below ceil(len / BS)
  const int j1 = min((len + BS - 1) / BS, MB);
  for (int j = tid; j < MB; j += NT)
    if (trow[j] < 0) atomicMin(&readable_s, j);
  __syncthreads();
  const int nkeys = min(min(readable_s, j1) * BS, len);
  const int ntiles = (nkeys + DK_T - 1) / DK_T;
  const int nlive = (ntiles + tiles - 1) / tiles;  // splits that read a key
  __nv_bfloat16* og = out + ((size_t)b * H + g * rep) * D;
  if (sp >= nlive) {
    if (sp == 0)  // nothing readable: NaN, the reference's masked softmax
      for (int i = tid; i < rep * D; i += NT) og[i] = __float2bfloat16(NAN);
    return;
  }

  // this warp's tiles: t0 = sp * tiles + warp, then every DK_WARPS-th,
  // DK_STAGES of them in flight (an empty group where none is left)
  const int t0 = sp * tiles + warp;
  const int t_stop = min(sp * tiles + tiles, ntiles);
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(dk_smem) +
                        warp * DK_STAGES * 2 * DK_T * P;
  // a lane copies key lane % 16 of the tile, the chunks of parity lane / 16
  const int ck = lane & 15, cpar = lane >> 4;
  auto load_tile = [&](int t, int stage) {
    if (t < t_stop) {
      __nv_bfloat16* ks = wbuf + stage * 2 * DK_T * P;
      __nv_bfloat16* vs = ks + DK_T * P;
      const int pos = t * DK_T + ck;
      const bool live = pos < nkeys;  // past the prefix: zero-filled
      size_t src = 0;
      if (live)
        src = (((size_t)trow[pos / BS] * BS + pos % BS) * Hkv + g) * D;
#pragma unroll
      for (int c = cpar; c < CH; c += 2) {
        cp_async_16(ks + ck * P + c * 8, kp + src + c * 8, live);
        cp_async_16(vs + ck * P + c * 8, vp + src + c * 8, live);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < DK_STAGES - 1; ++i) load_tile(t0 + i * DK_WARPS, i);

  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;  // this lane's share of its rows' sums

  for (int i = 0, t = t0; t < t_stop; ++i, t += DK_WARPS) {
    load_tile(t + (DK_STAGES - 1) * DK_WARPS, (i + DK_STAGES - 1) % DK_STAGES);
    cp_async_wait<DK_STAGES - 1>();  // tile t has landed
    __syncwarp();
    const __nv_bfloat16* ks = wbuf + (i % DK_STAGES) * 2 * DK_T * P;
    const __nv_bfloat16* vs = ks + DK_T * P;

    // s = Q.K^T over the tile's 16 keys: one x4 ldmatrix gives the B
    // fragments of both 8-key n-tiles (K rows are B's columns)
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bb[4];
      const int key = (lane & 7) + ((lane >> 4) << 3);
      const int col = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(bb, ks + key * P + col);
      mma_bf16(s[0], qf[kk], bb[0], bb[1]);
      mma_bf16(s[1], qf[kk], bb[2], bb[3]);
    }

    // scale, mask, and the tile's online softmax step with the guards
    const int k0 = t * DK_T;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + 8 * j + 2 * tq + (e & 1) < nkeys;
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
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe =
            x == -INFINITY ? 0.f : __expf(x - (e < 2 ? ms_lo : ms_hi));
        s[j][e] = pe;
        (e < 2 ? sum_lo : sum_hi) += pe;
      }
    }
    l_lo = l_lo * c_lo + sum_lo;
    l_hi = l_hi * c_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;

    // o = o * c + P.V: P (rounded to bf16) from registers, the tile's 16
    // keys as one k-step; an x4 ldmatrix.trans gives the B fragments of
    // two output n-tiles
    uint32_t a[4];
    c_to_a(a, s[0], s[1]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bb[4];
      const int key = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = dp * 16 + (lane >> 4) * 8;
      ldmatrix_x4_trans(bb, vs + key * P + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[2 * dp + h][0] *= c_lo;
        o[2 * dp + h][1] *= c_lo;
        o[2 * dp + h][2] *= c_hi;
        o[2 * dp + h][3] *= c_hi;
        mma_bf16(o[2 * dp + h], a, bb[2 * h], bb[2 * h + 1]);
      }
    }
    __syncwarp();  // this buffer is refilled DK_STAGES tiles on
  }

  // merge the warps in shared memory (over the K/V buffers: every warp
  // must be done with its own first): a thread a row takes the warps'
  // weights c_w = exp(m_w - m) and the sum once, then every thread sums
  // its elements.  A warp that walked no tile holds (-inf, 0, 0) and
  // weighs 0.  Every live split reads a key for each row (warp 0 walks the
  // split's first tile, whose first key is readable), so m is finite.
  cp_async_wait<0>();  // the empty groups
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(dk_smem);  // [DK_WARPS][16][AP]
  {
    float* w = acc_s + warp * 16 * AP + gq * AP + 2 * tq;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      *reinterpret_cast<float2*>(w + 8 * n) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(w + 8 * AP + 8 * n) =
          make_float2(o[n][2], o[n][3]);
    }
    if (tq == 0) {
      wt_s[warp * 16 + gq] = m_lo;
      wt_s[warp * 16 + gq + 8] = m_hi;
      sum_s[warp * 16 + gq] = l_lo;
      sum_s[warp * 16 + gq + 8] = l_hi;
    }
  }
  __syncthreads();
  if (tid < rep) {
    float m = -INFINITY, l = 0.f;
#pragma unroll
    for (int w = 0; w < DK_WARPS; ++w) m = fmaxf(m, wt_s[w * 16 + tid]);
#pragma unroll
    for (int w = 0; w < DK_WARPS; ++w) {
      const float mw = wt_s[w * 16 + tid];
      const float c = mw == -INFINITY ? 0.f : __expf(mw - m);
      wt_s[w * 16 + tid] = c;
      l += sum_s[w * 16 + tid] * c;
    }
    rowm_s[tid] = m;
    rowl_s[tid] = l;
  }
  __syncthreads();
  // a thread takes the float4 elements i = tid + NT * e of the rep x D
  // output (few and short loops: this code and the last block's run once
  // per block, from a cold instruction cache)
  const size_t bg = (size_t)b * Hkv + g;
  float* pg = part + bg * NS * rep * PP;
#pragma unroll
  for (int e = 0; e < E4; ++e) {
    const int i = tid + NT * e;
    if (i >= rep * D / 4) break;
    const int r = i / (D / 4), d = 4 * (i % (D / 4));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < DK_WARPS; ++w) {
      const float c = wt_s[w * 16 + r];
      const float4 a =
          *reinterpret_cast<const float4*>(acc_s + (w * 16 + r) * AP + d);
      acc.x += c * a.x;
      acc.y += c * a.y;
      acc.z += c * a.z;
      acc.w += c * a.w;
    }
    if (nlive == 1) {
      store_bf16x4(og + r * D + d, acc, 1.f / rowl_s[r]);
    } else {  // part (B, Hkv, NS, rep, PP): acc[D], max, sum
      float* dst = pg + ((size_t)sp * rep + r) * PP;
      *reinterpret_cast<float4*>(dst + d) = acc;
      if (d == 0) {
        dst[D] = rowm_s[r];
        dst[D + 1] = rowl_s[r];
      }
    }
  }
  if (nlive == 1) return;

  // the last live split to finish for (b, g) merges the partials.  The
  // barrier orders the block's partial writes before thread 0's release;
  // its acquire, then the barrier, order the merge's reads after every
  // other split's release.
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(count + bg)
                 : "memory");
    last_s = prev == nlive - 1;
    if (last_s) count[bg] = 0;  // every live split has arrived
  }
  __syncthreads();
  if (!last_s) return;
  // the partials of up to DK_CHUNK splits at a time copied into shared
  // memory at once (16-byte cp.async through L2), then merged there as
  // the warps were, online across chunks: a thread a row takes the
  // weights and the factor of the running sums, then every thread its
  // elements
  float* ps = reinterpret_cast<float*>(dk_smem);
  const int per = rep * PP;  // floats a split
  const int chunk = min(DK_CHUNK, decode_mma_floats<D>() / per);
  if (tid < rep) {
    rowm_s[tid] = -INFINITY;
    rowl_s[tid] = 0.f;
  }
  float4 ar[E4];
#pragma unroll
  for (int e = 0; e < E4; ++e) ar[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < nlive; s0 += chunk) {
    const int n = min(chunk, nlive - s0);
    const float* src = pg + (size_t)s0 * per;
    for (int c = tid; c < n * per / 4; c += NT)
      cp_async_16(ps + 4 * c, src + 4 * c, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (tid < rep) {
      const float m0 = rowm_s[tid];
      float m = m0;
      for (int s2 = 0; s2 < n; ++s2) m = fmaxf(m, ps[s2 * per + tid * PP + D]);
      const float f = m0 == -INFINITY ? 0.f : __expf(m0 - m);
      float l = rowl_s[tid] * f;
      for (int s2 = 0; s2 < n; ++s2) {
        const float* pr = ps + s2 * per + tid * PP;
        const float c = __expf(pr[D] - m);
        wt_s[s2 * 16 + tid] = c;
        l += pr[D + 1] * c;
      }
      rowm_s[tid] = m;
      rowl_s[tid] = l;
      rowf_s[tid] = f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E4; ++e) {
      const int i = tid + NT * e;
      if (i >= rep * D / 4) break;
      const int r = i / (D / 4), d = 4 * (i % (D / 4));
      const float f = rowf_s[r];
      float4 acc = ar[e];
      acc.x *= f;
      acc.y *= f;
      acc.z *= f;
      acc.w *= f;
      for (int s2 = 0; s2 < n; ++s2) {
        const float c = wt_s[s2 * 16 + r];
        const float4 a =
            *reinterpret_cast<const float4*>(ps + s2 * per + r * PP + d);
        acc.x += c * a.x;
        acc.y += c * a.y;
        acc.z += c * a.z;
        acc.w += c * a.w;
      }
      ar[e] = acc;
    }
    __syncthreads();  // before the next chunk lands
  }
#pragma unroll
  for (int e = 0; e < E4; ++e) {
    const int i = tid + NT * e;
    if (i >= rep * D / 4) break;
    const int r = i / (D / 4), d = 4 * (i % (D / 4));
    store_bf16x4(og + r * D + d, ar[e], 1.f / rowl_s[r]);
  }
}

template <int D>
int launch_decode_mma(const void* q, const void* kp, const void* vp,
                      const int* table, const int* lens, void* out,
                      float* part, int* count, int B, int H, int Hkv, int BS,
                      int MB, int NS, int tiles, cudaStream_t st) {
  constexpr int floats = decode_mma_floats<D>();
  static_assert(DK_WARPS * 16 * (D + DK_APAD) <= floats,
                "the warps' merge must fit in the K/V buffers");
  static_assert(16 * (D + 4) <= floats,
                "one split's partial must fit in the K/V buffers");
  constexpr size_t smem = sizeof(float) * floats;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_decode_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  paged_decode_mma<D><<<dim3(B, Hkv, NS), DK_WARPS * 32, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, table, lens, (__nv_bfloat16*)out, part, count,
      H, Hkv, BS, MB, NS, tiles, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
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
// q.  mma = 1 launches the tensor-core kernel (bf16 and D % 16 == 0 only):
// `split` is its 16-key tiles per split, NS = ceil(ceil(MB * BS / 16) /
// split); part holds B * H * NS * (D + 4) floats and count B * Hkv ints,
// zero before the first call (each call leaves them so).  The workspace
// assumes the calls on one device run on one stream.  mma = 0 launches the
// SIMT kernel and its merge: `split` is its table blocks per split, NS =
// ceil(MB / split), part as above, count unused.  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_paged_decode(const void* q, const void* kp,
                                  const void* vp, const int* table,
                                  const int* lens, void* out, float* part,
                                  int* count, int B, int H, int Hkv, int D,
                                  int BS, int MB, int split, int bf16, int mma,
                                  void* stream) {
  if (B < 1 || MB < 1 || split < 1 || !shapes_ok(H, Hkv, D, BS) ||
      (mma && (!bf16 || D % 16 != 0 || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mma) {
    const int NS = ((MB * BS + DK_T - 1) / DK_T + split - 1) / split;
    switch (D) {
#define DECODE_MMA(d)                                                         \
  case d:                                                                     \
    return launch_decode_mma<d>(q, kp, vp, table, lens, out, part, count, B, \
                                H, Hkv, BS, MB, NS, split, st);
      DECODE_MMA(16) DECODE_MMA(32) DECODE_MMA(48) DECODE_MMA(64)
      DECODE_MMA(80) DECODE_MMA(96) DECODE_MMA(112) DECODE_MMA(128)
#undef DECODE_MMA
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const int rep = H / Hkv;
  const int NS = (MB + split - 1) / split;
  const size_t smem = sizeof(float) * (size_t)DW * rep * (D + 2);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv, NS);
  const float scale = 1.0f / sqrtf((float)D);
  if (bf16) {
    paged_decode_simt<__nv_bfloat16><<<grid, NTH, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
        (const __nv_bfloat16*)vp, table, lens, part, H, Hkv, D, BS, MB, NS,
        split, scale);
    paged_decode_simt_merge<__nv_bfloat16><<<B * H, MAXD, 0, st>>>(
        part, (__nv_bfloat16*)out, D, NS);
  } else {
    paged_decode_simt<float><<<grid, NTH, smem, st>>>(
        (const float*)q, (const float*)kp, (const float*)vp, table, lens, part,
        H, Hkv, D, BS, MB, NS, split, scale);
    paged_decode_simt_merge<float><<<B * H, MAXD, 0, st>>>(part, (float*)out,
                                                           D, NS);
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
