// Bayesian LM head with the uncertainty readout, fused and two-pass, for
// sm_90a.
//
// Replaces: repro/kernels/uncertainty_head.py::uncertainty_head_fused_kernel
// (bodies _head_stats_fused_kernel, _head_entropy_fused_kernel,
// _sampled_logits_tile, _tile_xi), the in-kernel normal draw of
// repro/kernels/rng.py (uniform_from_bits, normal_draw, seed_from_key),
// and uncertainty_head_kernel (bodies _head_stats_kernel and
// _head_entropy_kernel: the two-pass head with an (S, M, V) logits
// scratch, explicit xi only).
//
// Computes, for x (M, K) and the variational head mu/sigma (K, V), S LRT
// draws  l_s = x@mu + sqrt((x*x)@sigma^2) * xi_s  and reduces them to
//   H = -sum_v pbar log(pbar + 1e-12),  pbar = mean_s softmax(l_s),
//   SE = mean_s (mx_s + log Z_s - A_s / Z_s),  MI = max(H - SE, 0),
//   pred = argmax pbar (lowest index on ties),  p_max = max pbar.
//
// What bounds it: at decode M (the slot count) is tiny next to K and V,
// so the work is reading mu and sigma once: 2*K*V*4 bytes (1.87 GB for
// qwen2-1.5b's 1536 x 151936 head) over the card's memory rate.  The TPU
// kernel regenerates the logits in its second pass by re-reading mu and
// sigma, which doubles that term; here pass 1 streams mu/sigma ONCE and
// keeps the (M, V) mean and std in a scratch (2*M*V*4 bytes, about 1% of
// the weight bytes at M = 4), and pass 2 rebuilds the logits from that
// scratch and the REPLAYED Philox stream.  No (S, M, V) tensor and no
// variate tensor ever exists in device memory.
//
// Launches (one stream, no host sync):
//   pass1   grid (V/128, M/16): each thread owns one vocab column and
//           up to 16 rows; x is staged in shared memory in K chunks, the
//           column of mu/sigma is read once, coalesced across the warp.
//           Writes mean/std and per-tile online (max, Z, A) per (s, m).
//   merge   one block per (s, m): merges the tile partials -> (3, S, M).
//   pass2   same grid as pass1: pbar per column from mean/std, the stats
//           and the regenerated variates; per-tile partial H and
//           (p_max, index).
//   final   one block per row: H, SE, MI, pred, p_max.
//
// The two-pass head (repro_uncertainty_head_two_pass) runs the same four
// launches with the TPU kernel's scratch: pass 1 writes the (S, M, V) f32
// logits (V unpadded, the ragged last tile masked) instead of mean/std,
// and pass 2 re-reads them instead of rebuilding them.  Its floor is the
// mu/sigma read plus writing and re-reading the scratch: 1.87 GB +
// 2 x 24.3 MB at M 4 (V 151936, S 10).  The TPU's grid carried the online
// stats sequentially across vocab tiles; here tiles run in parallel, so
// both passes write per-tile partials and the merge / final launches
// combine them, with the fused head's merge code and argmax rule.
//
// Padded columns (V is not a tile multiple) are masked with -1e30, never
// -inf, so no inf - inf NaN appears; they add 0 to Z, A and H.  A row of x
// holding NaN (an idle decode slot) yields NaN in that row only: every
// reduction is per (s, m) or per m.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "convert.cuh"
#include "philox.cuh"

namespace {

constexpr int TV = 128;    // vocab columns per block, one per thread
constexpr int MR = 16;     // rows per block
constexpr int KC = 64;     // K chunk staged in shared memory
constexpr int MAXS = 64;   // most MC samples per call
constexpr int NRED = 256;  // threads of the merge / final blocks
constexpr float NEG = -1e30f;
constexpr uint32_t TAG_KERNEL = 0;

using repro::to_f32;

// online-softmax partial over a set of logits: mx = max, z = sum e^(l-mx),
// a = sum l e^(l-mx); z == 0 marks the empty set
struct Triple {
  float mx, z, a;
};

__device__ __forceinline__ Triple merge(Triple p, Triple q) {
  if (q.z == 0.f) return p;
  if (p.z == 0.f) return q;
  const float mx = fmaxf(p.mx, q.mx);
  const float c1 = expf(p.mx - mx);
  const float c2 = expf(q.mx - mx);
  return {mx, p.z * c1 + q.z * c2, p.a * c1 + q.a * c2};
}

__device__ __forceinline__ Triple warp_merge(Triple t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Triple u = {__shfl_xor_sync(0xffffffffu, t.mx, o),
                __shfl_xor_sync(0xffffffffu, t.z, o),
                __shfl_xor_sync(0xffffffffu, t.a, o)};
    t = merge(t, u);
  }
  return t;
}

// (best, idx) with the lowest index winning ties; a NaN wins over any
// number, so a NaN row's p_max is NaN like the plain version's max
__device__ __forceinline__ bool better(float b, int i, float best, int bi) {
  return b > best || (b == best && i < bi) || (isnan(b) && !isnan(best));
}

// The head stream's step: *step_at + step_off, read from device memory so
// that a CUDA graph replays the launch at the step written there before
// the replay (a captured chunk passes one step tensor and offsets 0, 1,
// ...; a host int is the offset over a zero).  Unread with an explicit xi.
// A volatile load stays where it is written: pass 1 reads the step after
// its streaming loop.  Loaded above that loop, the step made the head 11%
// slower at M 4 (1.168 against 1.054 ms; tools/head_ab.py, H100 at
// 700 W).
__device__ __forceinline__ uint32_t stream_step(const float* xi,
                                                const uint32_t* step_at,
                                                uint32_t step_off) {
  if (xi) return 0u;
  uint32_t step;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(step) : "l"(step_at));
  return step + step_off;
}

__device__ __forceinline__ float variate(const float* __restrict__ xi,
                                         uint32_t seed, uint32_t step, int S,
                                         int M, int V, int s, int m, int v) {
  return xi ? xi[((size_t)s * M + m) * V + v]
            : repro::philox_normal(seed, step, (uint32_t)v, (uint32_t)m,
                                   (uint32_t)s, TAG_KERNEL);
}

// At least 6 blocks an SM: 80 registers a thread with or without it, but
// with it ptxas schedules the streaming loop so that the head takes 1.036
// ms at M 4 against 1.052 without (with the step a launch argument:
// 1.027; tools/head_ab.py, H100 at 700 W, in turns within one run).
template <typename XT>
__global__ void __launch_bounds__(TV, 6)
    head_pass1(const XT* __restrict__ x, int M, int K,
               const float* __restrict__ mu, const float* __restrict__ sg,
               int V, const float* __restrict__ xi, int S, uint32_t seed,
               const uint32_t* __restrict__ step_at, uint32_t step_off,
               float* __restrict__ mean_out,
               float* __restrict__ std_out, float* __restrict__ logits_out,
               float* __restrict__ part, int NT) {
  __shared__ float4 xs[KC][MR / 4];
  __shared__ float4 x2s[KC][MR / 4];
  __shared__ Triple red[TV / 32][MAXS];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int v = tile * TV + tid;
  const int m0 = blockIdx.y * MR;
  const bool col_ok = v < V;

  float am[MR], av[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    am[r] = 0.f;
    av[r] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < MR * KC; i += TV) {
      const int r = i % MR, kk = i / MR;
      const int m = m0 + r, k = k0 + kk;
      const float val = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
      reinterpret_cast<float*>(&xs[kk][0])[r] = val;
      reinterpret_cast<float*>(&x2s[kk][0])[r] = val * val;
    }
    __syncthreads();
    const int kn = min(KC, K - k0);
    if (col_ok) {
      const float* mup = mu + (size_t)k0 * V + v;
      const float* sgp = sg + (size_t)k0 * V + v;
#pragma unroll 8
      for (int kk = 0; kk < kn; ++kk) {
        const float w = __ldg(mup + (size_t)kk * V);
        const float s = __ldg(sgp + (size_t)kk * V);
        const float s2 = s * s;
#pragma unroll
        for (int r4 = 0; r4 < MR / 4; ++r4) {
          const float4 a = xs[kk][r4];
          const float4 b = x2s[kk][r4];
          am[4 * r4 + 0] += a.x * w;
          am[4 * r4 + 1] += a.y * w;
          am[4 * r4 + 2] += a.z * w;
          am[4 * r4 + 3] += a.w * w;
          av[4 * r4 + 0] += b.x * s2;
          av[4 * r4 + 1] += b.y * s2;
          av[4 * r4 + 2] += b.z * s2;
          av[4 * r4 + 3] += b.w * s2;
        }
      }
    }
  }

  const uint32_t step = stream_step(xi, step_at, step_off);
  const int warp = tid >> 5, lane = tid & 31;
  const size_t plane = (size_t)S * M * NT;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int m = m0 + r;
    if (m < M) {  // uniform across the block
      // sqrt(max(var, 0)) that keeps a NaN variance NaN
      av[r] = sqrtf(av[r] < 0.f ? 0.f : av[r]);
      if (col_ok && mean_out) {
        mean_out[(size_t)m * V + v] = am[r];
        std_out[(size_t)m * V + v] = av[r];
      }
      for (int s = 0; s < S; ++s) {
        float l = NEG;
        if (col_ok) {
          l = am[r] + av[r] * variate(xi, seed, step, S, M, V, s, m, v);
          if (logits_out) logits_out[((size_t)s * M + m) * V + v] = l;
        }
        Triple t = warp_merge({l, 1.f, l});
        if (lane == 0) red[warp][s] = t;
      }
      __syncthreads();
      for (int s = tid; s < S; s += TV) {
        Triple t = red[0][s];
#pragma unroll
        for (int w = 1; w < TV / 32; ++w) t = merge(t, red[w][s]);
        const size_t at = ((size_t)s * M + m) * NT + tile;
        part[at] = t.mx;
        part[plane + at] = t.z;
        part[2 * plane + at] = t.a;
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(NRED)
    head_merge(const float* __restrict__ part, int SM, int NT,
               float* __restrict__ stats) {
  __shared__ Triple red[NRED / 32];
  const int sm = blockIdx.x;
  const size_t plane = (size_t)SM * NT;
  Triple t = {-INFINITY, 0.f, 0.f};
  for (int j = threadIdx.x; j < NT; j += NRED) {
    const size_t at = (size_t)sm * NT + j;
    t = merge(t, {part[at], part[plane + at], part[2 * plane + at]});
  }
  t = warp_merge(t);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    Triple u = red[0];
    for (int w = 1; w < NRED / 32; ++w) u = merge(u, red[w]);
    stats[sm] = u.mx;
    stats[SM + sm] = u.z;
    stats[2 * SM + sm] = u.a;
  }
}

__global__ void __launch_bounds__(TV)
    head_pass2(const float* __restrict__ mean, const float* __restrict__ sd,
               const float* __restrict__ logits, int M, int V,
               const float* __restrict__ xi, int S, uint32_t seed,
               const uint32_t* __restrict__ step_at, uint32_t step_off,
               const float* __restrict__ stats, float* __restrict__ part2,
               int NT) {
  __shared__ float smx[MAXS], sz[MAXS];
  __shared__ float rh[TV / 32], rb[TV / 32];
  __shared__ int ri[TV / 32];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int v = tile * TV + tid;
  const int m0 = blockIdx.y * MR;
  const bool col_ok = v < V;
  const uint32_t step = stream_step(xi, step_at, step_off);
  const int warp = tid >> 5, lane = tid & 31;
  const int SM = S * M;
  const size_t plane = (size_t)M * NT;
  for (int r = 0; r < MR; ++r) {
    const int m = m0 + r;
    if (m >= M) break;  // uniform across the block
    __syncthreads();
    for (int s = tid; s < S; s += TV) {
      smx[s] = stats[s * M + m];
      sz[s] = stats[SM + s * M + m];
    }
    __syncthreads();
    float contrib = 0.f, pb = -1.f;
    if (col_ok) {
      // the two-pass head re-reads its scratch; the fused one rebuilds
      // the logits from mean/std and the replayed variates
      float mn = 0.f, dv = 0.f;
      if (!logits) {
        mn = mean[(size_t)m * V + v];
        dv = sd[(size_t)m * V + v];
      }
      float acc = 0.f;
      for (int s = 0; s < S; ++s) {
        const float l =
            logits ? logits[((size_t)s * M + m) * V + v]
                   : mn + dv * variate(xi, seed, step, S, M, V, s, m, v);
        acc += expf(l - smx[s]) / sz[s];
      }
      pb = acc / (float)S;
      contrib = pb * logf(pb + 1e-12f);
    }
    float h = contrib, best = pb;
    int bi = col_ok ? v : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      h += __shfl_xor_sync(0xffffffffu, h, o);
      const float b2 = __shfl_xor_sync(0xffffffffu, best, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(b2, i2, best, bi)) {
        best = b2;
        bi = i2;
      }
    }
    if (lane == 0) {
      rh[warp] = h;
      rb[warp] = best;
      ri[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      float hs = rh[0], bb = rb[0];
      int ii = ri[0];
      for (int w = 1; w < TV / 32; ++w) {
        hs += rh[w];
        if (better(rb[w], ri[w], bb, ii)) {
          bb = rb[w];
          ii = ri[w];
        }
      }
      const size_t at = (size_t)m * NT + tile;
      part2[at] = hs;
      part2[plane + at] = bb;
      part2[2 * plane + at] = (float)ii;  // exact: V < 2^24
    }
  }
}

__global__ void __launch_bounds__(NRED)
    head_final(const float* __restrict__ part2, const float* __restrict__ stats,
               int M, int S, int NT, float* __restrict__ H,
               float* __restrict__ SE, float* __restrict__ MI,
               float* __restrict__ pmax, int* __restrict__ pred) {
  __shared__ float rh[NRED / 32], rb[NRED / 32];
  __shared__ int ri[NRED / 32];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)M * NT;
  float h = 0.f, best = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = tid; j < NT; j += NRED) {
    const size_t at = (size_t)m * NT + j;
    h += part2[at];
    const float b = part2[plane + at];
    const int i = (int)part2[2 * plane + at];
    if (better(b, i, best, bi)) {
      best = b;
      bi = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    h += __shfl_xor_sync(0xffffffffu, h, o);
    const float b2 = __shfl_xor_sync(0xffffffffu, best, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(b2, i2, best, bi)) {
      best = b2;
      bi = i2;
    }
  }
  if ((tid & 31) == 0) {
    rh[tid >> 5] = h;
    rb[tid >> 5] = best;
    ri[tid >> 5] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    float hs = rh[0], bb = rb[0];
    int ii = ri[0];
    for (int w = 1; w < NRED / 32; ++w) {
      hs += rh[w];
      if (better(rb[w], ri[w], bb, ii)) {
        bb = rb[w];
        ii = ri[w];
      }
    }
    const int SM = S * M;
    float se = 0.f;
    for (int s = 0; s < S; ++s) {
      const float mx = stats[s * M + m];
      const float z = stats[SM + s * M + m];
      const float a = stats[2 * SM + s * M + m];
      se += mx + logf(z) - a / z;
    }
    se /= (float)S;
    const float hh = -hs;
    const float d = hh - se;
    H[m] = hh;
    SE[m] = se;
    MI[m] = d < 0.f ? 0.f : d;  // max(H - SE, 0), NaN stays NaN
    pmax[m] = bb;
    pred[m] = ii == 0x7fffffff ? 0 : ii;
  }
}

// The four launches of either head.  logits == null: the fused head
// (mean/std scratch, variates from xi or the Philox stream); otherwise the
// two-pass head (the (S, M, V) logits scratch, xi required).
int launch_head(const void* x, int x_bf16, int M, int K, const float* mu,
                const float* sigma, int V, const float* xi, int S,
                uint32_t seed, const uint32_t* step_at, uint32_t step_off,
                int tile, float* mean, float* sd,
                float* logits, float* part1, float* stats, float* part2,
                float* H, float* SE, float* MI, float* pmax, int* pred,
                cudaStream_t st) {
  if (tile != TV || M < 1 || K < 1 || V < 1 || V >= (1 << 24) || S < 1 ||
      S > MAXS || (logits && !xi) || (!xi && !step_at))
    return (int)cudaErrorInvalidValue;
  const int NT = (V + TV - 1) / TV;
  const dim3 grid(NT, (M + MR - 1) / MR);
  if (x_bf16)
    head_pass1<__nv_bfloat16><<<grid, TV, 0, st>>>(
        (const __nv_bfloat16*)x, M, K, mu, sigma, V, xi, S, seed, step_at,
        step_off, mean, sd, logits, part1, NT);
  else
    head_pass1<float><<<grid, TV, 0, st>>>((const float*)x, M, K, mu, sigma,
                                           V, xi, S, seed, step_at, step_off,
                                           mean, sd, logits, part1, NT);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  head_merge<<<S * M, NRED, 0, st>>>(part1, S * M, NT, stats);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  head_pass2<<<grid, TV, 0, st>>>(mean, sd, logits, M, V, xi, S, seed,
                                  step_at, step_off, stats, part2, NT);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  head_final<<<M, NRED, 0, st>>>(part2, stats, M, S, NT, H, SE, MI, pmax,
                                 pred);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return cudaGetLastError() after the launches (0 = launched).
// Scratch sizes (floats), NT = ceil(V / tile): part1 3*S*M*NT, stats
// 3*S*M, part2 3*M*NT; the fused head's mean/std M*V each, the two-pass
// head's logits S*M*V.
//
// The fused head: xi may be null, the variates are then drawn in-kernel
// from Philox keyed by (seed, step), step = *step_at + step_off read on
// the device (step_at a device uint32 / int32, required without xi).
extern "C" int repro_uncertainty_head(
    const void* x, int x_bf16, int M, int K, const float* mu,
    const float* sigma, int V, const float* xi, int S, uint32_t seed,
    const uint32_t* step_at, uint32_t step_off, int tile, float* mean,
    float* sd, float* part1, float* stats, float* part2, float* H, float* SE,
    float* MI, float* pmax, int* pred, void* stream) {
  if (!mean || !sd) return (int)cudaErrorInvalidValue;
  return launch_head(x, x_bf16, M, K, mu, sigma, V, xi, S, seed, step_at,
                     step_off, tile, mean, sd, nullptr, part1, stats, part2,
                     H, SE, MI, pmax, pred, (cudaStream_t)stream);
}

// The two-pass head: xi (S, M, V) is required.
extern "C" int repro_uncertainty_head_two_pass(
    const void* x, int x_bf16, int M, int K, const float* mu,
    const float* sigma, int V, const float* xi, int S, int tile,
    float* logits, float* part1, float* stats, float* part2, float* H,
    float* SE, float* MI, float* pmax, int* pred, void* stream) {
  if (!logits) return (int)cudaErrorInvalidValue;
  return launch_head(x, x_bf16, M, K, mu, sigma, V, xi, S, 0u, nullptr, 0u,
                     tile, nullptr, nullptr, logits, part1, stats, part2, H,
                     SE, MI, pmax, pred, (cudaStream_t)stream);
}
