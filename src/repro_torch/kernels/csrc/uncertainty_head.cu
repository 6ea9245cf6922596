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
// sigma, which doubles that term; here the stream reads mu/sigma ONCE, the
// (M, V) mean and std are kept in a scratch (2*M*V*4 bytes, about 1% of
// the weight bytes at M = 4), and pass 2 rebuilds the logits from that
// scratch and the REPLAYED Philox stream.  No (S, M, V) tensor and no
// variate tensor ever exists in device memory.
//
// Launches (one stream, no host sync):
//   stream  one block per (row group, K slice, vocab tile) work item of
//           head_plan (uncertainty_head.py): the mean and variance
//           partials of its K slice, for its 256 columns and its rows,
//           written to a (KS, 2, M, V) f32 scratch.
//   stats   grid (V/128, M/16): sums the KS partials of each (m, v) in
//           slice order, takes std = sqrt(max(var, 0)), writes mean/std
//           (or the two-pass head's logits) and the per-128-column-tile
//           online (max, Z, A) per (s, m).
//   merge   one block per (s, m): merges the tile partials -> (3, S, M).
//   pass2   same grid as stats: pbar per column from mean/std, the stats
//           and the regenerated variates; per-tile partial H and
//           (p_max, index).
//   final   one block per row: H, SE, MI, pred, p_max.
//
// The stream (redesigned for Hopper; the previous pass 1 gave each block
// 128 columns and ALL of K, one 4-byte column load a thread and row, and
// ran the softmax epilogue behind the loads: at V 32000 its 250 blocks
// filled a third of the card and reached 30% of the bytes bound):
//   - work items: K is cut into KS slices and V into 256-column tiles, so
//     that the items deal near-equal bytes to the 132 SMs at every served
//     width (head_plan picks KS from the shape: the busiest SM within
//     1.1x of the mean, the scratch under 5% of the weight bytes at
//     M <= 16);
//   - a block is 4 consumer warps (2 columns and MR rows of accumulators a
//     thread; MR = 4, 8 or 16 by M, so M 4 carries 8 accumulators a
//     column, not 32) and one producer warp.  The producer fills a ring
//     of 4 shared-memory stages of 8 rows of mu and of sigma (16 KB a
//     stage) while the consumers read the stages that have landed: up to
//     64 KB in flight a block, two blocks an SM, against the ~25 KB an SM
//     needs at 3.35 TB/s and ~1 us of latency;
//   - copy routes, by alignment (never by failure): where V % 4 == 0 and
//     mu/sigma start on 16 bytes, one thread issues a stage as TMA bulk
//     copies of whole 1 KB rows (cp.async.bulk) completing on the stage's
//     mbarrier with the expected bytes (stream_copy.cuh).  Where rows are
//     8-byte aligned only (V 256206 makes every odd row so), the producer
//     warp's lanes copy 8 bytes each by cp.async (4 at an odd V), mu and
//     sigma column by column, and hand their copies' completion to the
//     same barrier (16-byte copies of each row's aligned interior, the
//     row shifted in shared memory to keep the chunks aligned, ran slower
//     on the card and were not kept);
//   - x is staged once per K slice as f32 [k][row] (at most 40 KB); x^2
//     is formed in registers as it is used, which halves the staging so
//     the slices can be twice as long at the same shared memory;
//   - the stream reads no step and draws no variate.  Folding the stats
//     launch into the stream (the last slice of each tile, found by a
//     device counter, summing the partials and drawing the tile's
//     variates while other blocks stream) was slower on the card: the
//     epilogue's registers slowed the stream, and the last tiles' draws
//     still ran behind it.
// Tensor cores are not the limit and are not used: at M <= 16 the stream
// does 4*M*K*V f32 operations on 8*K*V bytes, 2 operations a byte at M 4:
// at qwen2-1.5b's widths 0.056 ms at M 4 and 0.22 ms at M 16 on the CUDA
// cores' 67 TFLOP/s, against 0.557 ms of bytes.  A 3xTF32 mma.sync would
// cost registers and move nothing.
//
// Determinism: each (m, v) sums its K rows in order within a slice and
// the slices in slice order (no atomics), so the same inputs give the
// same bits, eager or replayed in a CUDA graph.  The step is read from
// device memory by the stats and pass-2 launches only.
//
// The two-pass head (repro_uncertainty_head_two_pass) runs the same five
// launches with the TPU kernel's scratch: stats writes the (S, M, V) f32
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
#include "stream_copy.cuh"

namespace {

constexpr int TV = 128;    // vocab columns per stats / pass-2 block
constexpr int MR = 16;     // rows per stats / pass-2 block
constexpr int MAXS = 64;   // most MC samples per call
constexpr int NRED = 256;  // threads of the merge / final blocks
constexpr float NEG = -1e30f;
constexpr uint32_t TAG_KERNEL = 0;
// the stream (uncertainty_head.py's STREAM_* constants)
constexpr int ST_TILE = 256;                      // columns a block
constexpr int ST_COLS = 2;                        // columns a thread
constexpr int ST_CONSUMERS = ST_TILE / ST_COLS;   // consumer threads
constexpr int ST_THREADS = ST_CONSUMERS + 32;     // + the producer warp
constexpr int ST_ROWS = 8;                        // K rows a stage
constexpr int ST_STAGES = 4;
constexpr int ST_BAR_BYTES = 128;                 // the ring's barriers
constexpr int ST_X_BYTES = 40 * 1024;             // staged x, at most
enum Route { BULK = 0, ASYNC8 = 1, ASYNC4 = 2 };  // ROUTES in the wrapper
constexpr int ST_STAGE_FLOATS = 2 * ST_ROWS * ST_TILE;  // mu rows, sigma rows
constexpr int ST_RING_BYTES = ST_STAGES * ST_STAGE_FLOATS * 4;

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
// A volatile load stays where it is written: the stats launch reads the
// step after its loads of the partials, which do not depend on it.  In
// the previous design, whose pass 1 streamed mu/sigma itself, the step
// loaded above the streaming loop made the head 11% slower at M 4 (1.168
// against 1.054 ms; tools/head_ab.py, H100 at 700 W).
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

// One (row group, K slice, vocab tile) work item: the partial mean
// x@mu and variance (x*x)@sigma^2 of rows [m0, m0 + MR), K rows
// [k0, k0 + nk), columns [c0, c0 + nc), into part (KS, 2, M, V).
template <int MR_, int ROUTE>
__global__ void __launch_bounds__(ST_THREADS, 2)
    head_stream(const void* __restrict__ x, int x_bf16, int M, int K,
                const float* __restrict__ mu, const float* __restrict__ sg,
                int V, int k_slice, int splits, int tiles,
                float* __restrict__ part) {
  using namespace stream_copy;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + ST_STAGES;
  float* ring = reinterpret_cast<float*>(smem + ST_BAR_BYTES);
  float* xs = ring + ST_STAGES * ST_STAGE_FLOATS;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles;
  const int ks = (blockIdx.x / tiles) % splits;
  const int m0 = blockIdx.x / (tiles * splits) * MR_;
  const int c0 = tile * ST_TILE;
  const int nc = min(ST_TILE, V - c0);
  const int k0 = ks * k_slice;
  const int nk = min(k_slice, K - k0);
  const int nstage = (nk + ST_ROWS - 1) / ST_ROWS;

  if (tid == 0) {
    for (int i = 0; i < ST_STAGES; ++i) {
      mbar_init(&full[i], ROUTE == BULK ? 1 : 32);
      mbar_init(&empty[i], ST_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= ST_CONSUMERS) {  // the producer warp
    const int lane = tid - ST_CONSUMERS;
    for (int j = 0; j < nstage; ++j) {
      const int slot = j % ST_STAGES;
      if (j >= ST_STAGES) mbar_wait(&empty[slot], ((j / ST_STAGES) - 1) & 1);
      const int nr = min(ST_ROWS, nk - j * ST_ROWS);
      float* dst = ring + slot * ST_STAGE_FLOATS;
      const size_t g0 = (size_t)(k0 + j * ST_ROWS) * V + c0;
      if (ROUTE == BULK) {
        if (lane == 0) {
          const uint32_t row_bytes = (uint32_t)nc * 4;
          mbar_arrive_expect_tx(&full[slot], 2 * nr * row_bytes);
          for (int r = 0; r < nr; ++r) {
            bulk_copy(dst + r * ST_TILE, mu + g0 + (size_t)r * V, row_bytes,
                      &full[slot]);
            bulk_copy(dst + (ST_ROWS + r) * ST_TILE, sg + g0 + (size_t)r * V,
                      row_bytes, &full[slot]);
          }
        }
      } else {
        // a lane's copies of mu and of sigma interleaved column by column
        // (a row of mu, then the row of sigma, made the head about a third
        // slower at V 256206: tools/head_variants.py, async8_rowwise)
        constexpr int W = ROUTE == ASYNC8 ? 2 : 1;  // floats a copy
        for (int r = 0; r < nr; ++r) {
          const float* gm = mu + g0 + (size_t)r * V;
          const float* gs = sg + g0 + (size_t)r * V;
          float* dm = dst + r * ST_TILE;
          float* ds = dst + (ST_ROWS + r) * ST_TILE;
          for (int c = W * lane; c < nc; c += 32 * W) {
            if (W == 2) {
              cp_async_8(dm + c, gm + c);
              cp_async_8(ds + c, gs + c);
            } else {
              mma_tile::cp_async_4(dm + c, gm + c, true);
              mma_tile::cp_async_4(ds + c, gs + c, true);
            }
          }
        }
        cp_async_arrive(&full[slot]);
      }
    }
    if (ROUTE != BULK) cp_async_wait_all();
    return;
  }

  // the consumers: x rows [m0, m0 + MR) over the slice, staged once as f32
  // [k][row] (rows past M are 0), read from L2 while the first stages land
  for (int i = tid; i < MR_ * nk; i += ST_CONSUMERS) {
    const int r = i / nk, kk = i - r * nk;
    const int m = m0 + r;
    float val = 0.f;
    if (m < M) {
      const size_t at = (size_t)m * K + k0 + kk;
      val = x_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(x)[at])
                   : static_cast<const float*>(x)[at];
    }
    xs[kk * MR_ + r] = val;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(ST_CONSUMERS) : "memory");

  float am[MR_][ST_COLS], av[MR_][ST_COLS];
#pragma unroll
  for (int r = 0; r < MR_; ++r)
#pragma unroll
    for (int c = 0; c < ST_COLS; ++c) am[r][c] = av[r][c] = 0.f;

  const int col = tid * ST_COLS;
  auto row = [&](const float* ms, const float* ss, const float* xk) {
    const float2 w = *reinterpret_cast<const float2*>(ms);
    const float2 s = *reinterpret_cast<const float2*>(ss);
    const float s0 = s.x * s.x, s1 = s.y * s.y;
#pragma unroll
    for (int q = 0; q < MR_ / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(xk + 4 * q);
      const float xv[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * q + e;
        const float x2 = xv[e] * xv[e];
        am[r][0] += xv[e] * w.x;
        am[r][1] += xv[e] * w.y;
        av[r][0] += x2 * s0;
        av[r][1] += x2 * s1;
      }
    }
  };
  for (int j = 0; j < nstage; ++j) {
    const int slot = j % ST_STAGES;
    mbar_wait(&full[slot], (j / ST_STAGES) & 1);
    const float* ms = ring + slot * ST_STAGE_FLOATS + col;
    const float* ss = ms + ST_ROWS * ST_TILE;
    const float* xk = xs + j * ST_ROWS * MR_;
    const int nr = min(ST_ROWS, nk - j * ST_ROWS);
    if (nr == ST_ROWS) {
#pragma unroll
      for (int r = 0; r < ST_ROWS; ++r)
        row(ms + r * ST_TILE, ss + r * ST_TILE, xk + r * MR_);
    } else {
      for (int r = 0; r < nr; ++r)
        row(ms + r * ST_TILE, ss + r * ST_TILE, xk + r * MR_);
    }
    mbar_arrive(&empty[slot]);
  }

  // columns past the ragged tile's end read stale shared memory: dropped
  const size_t plane = (size_t)M * V;
  float* pm = part + (size_t)ks * 2 * plane;
#pragma unroll
  for (int r = 0; r < MR_; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < ST_COLS; ++c) {
      if (col + c < nc) {
        const size_t at = (size_t)m * V + c0 + col + c;
        pm[at] = am[r][c];
        pm[plane + at] = av[r][c];
      }
    }
  }
}

// Sums the stream's KS partials of each (m, v) in slice order, then writes
// mean/std (fused head) or the (S, M, V) logits (two-pass head) and the
// per-tile (max, Z, A) of every (s, m).  A thread sums one column's
// partials for the block's rows into shared memory; then each warp takes
// whole (row, sample) pairs in turn, a lane 4 columns of the tile (lane +
// 32 i), with no block barrier per row.
__global__ void __launch_bounds__(TV)
    head_stats(const float* __restrict__ part, int splits, int M, int V,
               const float* __restrict__ xi, int S, uint32_t seed,
               const uint32_t* __restrict__ step_at, uint32_t step_off,
               float* __restrict__ mean_out, float* __restrict__ std_out,
               float* __restrict__ logits_out, float* __restrict__ tstats,
               int NT) {
  __shared__ float smn[MR][TV], ssd[MR][TV];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int v = tile * TV + tid;
  const int m0 = blockIdx.y * MR;
  const int rows = min(MR, M - m0);
  const size_t plane = (size_t)M * V;

#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int m = m0 + r;
    if (m < M && v < V) {
      const float* p = part + (size_t)m * V + v;
      float am = p[0], av = p[plane];
      for (int ks = 1; ks < splits; ++ks) {
        am += p[2 * ks * plane];
        av += p[(2 * ks + 1) * plane];
      }
      // sqrt(max(var, 0)) that keeps a NaN variance NaN
      av = sqrtf(av < 0.f ? 0.f : av);
      if (mean_out) {
        mean_out[(size_t)m * V + v] = am;
        std_out[(size_t)m * V + v] = av;
      }
      smn[r][tid] = am;
      ssd[r][tid] = av;
    }
  }

  const uint32_t step = stream_step(xi, step_at, step_off);
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  const size_t tplane = (size_t)S * M * NT;
  for (int pair = warp; pair < rows * S; pair += TV / 32) {
    const int r = pair / S, s = pair - r * S;
    const int m = m0 + r;
    float l[TV / 32];
#pragma unroll
    for (int i = 0; i < TV / 32; ++i) {
      const int c = lane + 32 * i, vv = tile * TV + c;
      l[i] = NEG;
      if (vv < V) {
        l[i] = smn[r][c] + ssd[r][c] * variate(xi, seed, step, S, M, V, s, m,
                                               vv);
        if (logits_out) logits_out[((size_t)s * M + m) * V + vv] = l[i];
      }
    }
    // the tile's max first, then one exp a logit and plain sums across
    // the warp (an online merge at every step costs two exps a step)
    float mx = l[0];
#pragma unroll
    for (int i = 1; i < TV / 32; ++i) mx = fmaxf(mx, l[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    Triple t = {mx, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < TV / 32; ++i) {
      const float e = expf(l[i] - mx);
      t.z += e;
      t.a += e * l[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      t.z += __shfl_xor_sync(0xffffffffu, t.z, o);
      t.a += __shfl_xor_sync(0xffffffffu, t.a, o);
    }
    if (lane == 0) {
      const size_t at = ((size_t)s * M + m) * NT + tile;
      tstats[at] = t.mx;
      tstats[tplane + at] = t.z;
      tstats[2 * tplane + at] = t.a;
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

template <int MR_, int ROUTE>
cudaError_t launch_stream(int blocks, size_t x_bytes, const void* x,
                          int x_bf16, int M, int K, const float* mu,
                          const float* sigma, int V, int k_slice, int splits,
                          int tiles, float* part, cudaStream_t st) {
  static bool attr_set = false;  // once per instantiation, before any capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_stream<MR_, ROUTE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ST_BAR_BYTES + ST_RING_BYTES + ST_X_BYTES);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const size_t smem = ST_BAR_BYTES + ST_RING_BYTES + x_bytes;
  head_stream<MR_, ROUTE><<<blocks, ST_THREADS, smem, st>>>(
      x, x_bf16, M, K, mu, sigma, V, k_slice, splits, tiles, part);
  return cudaGetLastError();
}

template <int MR_>
cudaError_t launch_stream_route(int route, int blocks, size_t x_bytes,
                                const void* x, int x_bf16, int M, int K,
                                const float* mu, const float* sigma, int V,
                                int k_slice, int splits, int tiles,
                                float* part, cudaStream_t st) {
  auto launch = route == BULK     ? &launch_stream<MR_, BULK>
                : route == ASYNC8 ? &launch_stream<MR_, ASYNC8>
                                  : &launch_stream<MR_, ASYNC4>;
  return launch(blocks, x_bytes, x, x_bf16, M, K, mu, sigma, V, k_slice,
                splits, tiles, part, st);
}

// The five launches of either head.  logits == null: the fused head
// (mean/std scratch, variates from xi or the Philox stream); otherwise the
// two-pass head (the (S, M, V) logits scratch, xi required).  The plan
// (rows, k_slice, route) is head_plan's; a route the operands' alignment
// does not allow is refused, never replaced.
int launch_head(const void* x, int x_bf16, int M, int K, const float* mu,
                const float* sigma, int V, const float* xi, int S,
                uint32_t seed, const uint32_t* step_at, uint32_t step_off,
                int tile, int rows, int k_slice, int route, float* part0,
                float* mean, float* sd, float* logits, float* part1,
                float* stats, float* part2, float* H, float* SE, float* MI,
                float* pmax, int* pred, cudaStream_t st) {
  const uintptr_t align = (uintptr_t)mu | (uintptr_t)sigma;
  const bool route_ok =
      route == BULK     ? V % 4 == 0 && align % 16 == 0
      : route == ASYNC8 ? V % 2 == 0 && align % 8 == 0
                        : route == ASYNC4 && align % 4 == 0;
  if (tile != TV || M < 1 || K < 1 || V < 1 || V >= (1 << 24) || S < 1 ||
      S > MAXS || (logits && !xi) || (!xi && !step_at) || !route_ok ||
      !(rows == 4 || rows == 8 || rows == 16) || k_slice < 1 ||
      k_slice % ST_ROWS != 0 || rows * k_slice * 4 > ST_X_BYTES || !part0)
    return (int)cudaErrorInvalidValue;
  const int splits = (K + k_slice - 1) / k_slice;
  const int tiles = (V + ST_TILE - 1) / ST_TILE;
  const long blocks = (long)((M + rows - 1) / rows) * splits * tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t x_bytes = (size_t)rows * k_slice * 4;
  auto stream = rows == 4   ? &launch_stream_route<4>
                : rows == 8 ? &launch_stream_route<8>
                            : &launch_stream_route<16>;
  cudaError_t e = stream(route, (int)blocks, x_bytes, x, x_bf16, M, K, mu,
                         sigma, V, k_slice, splits, tiles, part0, st);
  if (e != cudaSuccess) return (int)e;
  const int NT = (V + TV - 1) / TV;
  const dim3 grid(NT, (M + MR - 1) / MR);
  head_stats<<<grid, TV, 0, st>>>(part0, splits, M, V, xi, S, seed, step_at,
                                  step_off, mean, sd, logits, part1, NT);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
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
// The plan: rows (4, 8 or 16) of x a stream block, k_slice (a multiple of
// 8, rows * k_slice * 4 <= 40 KB) and route (0 bulk: V % 4 == 0 and
// mu/sigma 16-byte aligned; 1 cp.async of 8 bytes: V even, 8-byte
// aligned; 2 cp.async of 4 bytes).  Scratch sizes (floats), KS =
// ceil(K / k_slice), NT = ceil(V / tile): part0 KS*2*M*V, part1 3*S*M*NT,
// stats 3*S*M, part2 3*M*NT; the fused head's mean/std M*V each, the
// two-pass head's logits S*M*V.
//
// The fused head: xi may be null, the variates are then drawn in-kernel
// from Philox keyed by (seed, step), step = *step_at + step_off read on
// the device (step_at a device uint32 / int32, required without xi).
extern "C" int repro_uncertainty_head(
    const void* x, int x_bf16, int M, int K, const float* mu,
    const float* sigma, int V, const float* xi, int S, uint32_t seed,
    const uint32_t* step_at, uint32_t step_off, int tile, int rows,
    int k_slice, int route, float* part0, float* mean, float* sd,
    float* part1, float* stats, float* part2, float* H, float* SE,
    float* MI, float* pmax, int* pred, void* stream) {
  if (!mean || !sd) return (int)cudaErrorInvalidValue;
  return launch_head(x, x_bf16, M, K, mu, sigma, V, xi, S, seed, step_at,
                     step_off, tile, rows, k_slice, route, part0, mean, sd,
                     nullptr, part1, stats, part2, H, SE, MI, pmax, pred,
                     (cudaStream_t)stream);
}

// The two-pass head: xi (S, M, V) is required.
extern "C" int repro_uncertainty_head_two_pass(
    const void* x, int x_bf16, int M, int K, const float* mu,
    const float* sigma, int V, const float* xi, int S, int tile, int rows,
    int k_slice, int route, float* part0, float* logits, float* part1,
    float* stats, float* part2, float* H, float* SE, float* MI, float* pmax,
    int* pred, void* stream) {
  if (!logits) return (int)cudaErrorInvalidValue;
  return launch_head(x, x_bf16, M, K, mu, sigma, V, xi, S, 0u, nullptr, 0u,
                     tile, rows, k_slice, route, part0, nullptr, nullptr,
                     logits, part1, stats, part2, H, SE, MI, pmax, pred,
                     (cudaStream_t)stream);
}
