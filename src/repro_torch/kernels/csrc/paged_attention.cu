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
// paged_prefill_kernel
//   Replaces repro/kernels/paged_attention.py::paged_prefill_attention_kernel
//   (body _paged_prefill_kernel).  Causal multi-query attention of one
//   slot's prompt chunk (S queries at absolute positions offset + [0, S))
//   over the leading `span` tokens of its table row; -1 entries read
//   physical block 0 and are NOT masked, exactly like the gather reference.
//   Grid (kv head, tile of 16 of the rep * S query rows); the TPU kernel's
//   (rows, span) score scratch does not fit shared memory, so each block
//   walks the keys in 16-token tiles.  The softmax is the reference's
//   online recurrence per kv_chunk group with the same -inf guards: a
//   first sweep over the group takes its row max, a second accumulates
//   p = exp(s - m) and p @ V after rescaling by exp(m_old - m).  K is
//   therefore read twice per group (from L2 at these sizes).  The output is
//   acc / max(l, 1e-20): a fully masked row gives 0, not NaN.
//   Bound: Q, the span's K and V, and the output, each moved once.
//
// Both keep D <= 128 (decode: 4 dims per lane; prefill: one head-dim
// column per thread, accumulators in registers) and rep <= 16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
    paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
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
// D); row (NBLK,) covering span tokens; out like q.
extern "C" int repro_paged_prefill(const void* q, const void* kp,
                                   const void* vp, const int* row, int offset,
                                   int span, int kv_chunk, void* out, int S,
                                   int H, int Hkv, int D, int BS, int NBLK,
                                   int bf16, void* stream) {
  if (S < 1 || span < 1 || kv_chunk < 1 || NBLK * BS < span ||
      !shapes_ok(H, Hkv, D, BS))
    return (int)cudaErrorInvalidValue;
  const int kc = kv_chunk < span ? kv_chunk : span;
  const int R = (H / Hkv) * S;
  const dim3 grid(Hkv, (R + QT - 1) / QT);
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    paged_prefill_kernel<__nv_bfloat16><<<grid, NTH, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
        (const __nv_bfloat16*)vp, row, offset, span, kc, (__nv_bfloat16*)out,
        S, H, Hkv, D, BS, scale);
  else
    paged_prefill_kernel<float><<<grid, NTH, 0, st>>>(
        (const float*)q, (const float*)kp, (const float*)vp, row, offset,
        span, kc, (float*)out, S, H, Hkv, D, BS, scale);
  return (int)cudaGetLastError();
}
