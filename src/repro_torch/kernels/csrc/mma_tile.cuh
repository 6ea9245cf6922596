// Warp-level tensor-core tile helpers (sm_80 and later; built for
// sm_90a): bf16 mma.sync m16n8k16, ldmatrix, 16- and 4-byte cp.async, the
// packing of f32 C fragments into bf16 A fragments (rounded once, or split
// into three bf16 parts), row reductions over a quad, and tf32 mma.sync
// m16n8k8 with the split of an f32 value into two tf32 parts (3xTF32).
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 (the lane's group) and t = lane % 4
// (its place in the group, the "quad"):
//   A, 16 x 16 row-major, four b32 of two bf16 each:
//     a[0] = row g,     cols 2t, 2t+1       a[1] = row g + 8, cols 2t, 2t+1
//     a[2] = row g,     cols 2t+8, 2t+9     a[3] = row g + 8, cols 2t+8, 2t+9
//   B, 16 x 8 (k x n) with each column contiguous in k ("col"), two b32:
//     b[0] = k rows 2t, 2t+1 of col g       b[1] = k rows 2t+8, 2t+9 of col g
//   C and D, 16 x 8 f32, four floats:
//     c[0], c[1] = row g,     cols 2t, 2t+1
//     c[2], c[3] = row g + 8, cols 2t, 2t+1
// In every b32 the lower 16 bits hold the element of the lower column (A)
// or of the lower k row (B).  The four lanes of a quad hold the same rows
// of a C fragment, so a row's max or sum is a reduction over the quad.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tile {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a * b for one 16 x 8 x 16 tile, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory.  Lanes 8j .. 8j + 7 pass the
// (16-byte aligned) addresses of rows 0 .. 7 of matrix j; r[j] receives
// row g, elements 2t and 2t + 1 of matrix j.  The address is a generic
// pointer or a 32-bit shared-window address (smem_u32): a kernel that
// keeps one 32-bit base a lane and adds constant offsets holds one
// register where a generic pointer a tile takes two.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row_addr) {
  ldmatrix_x4(r, smem_u32(row_addr));
}

// The same, each matrix transposed: r[j] receives rows 2t and 2t + 1 of
// column g of matrix j (as stored).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row_addr) {
  ldmatrix_x4_trans(r, smem_u32(row_addr));
}

// (lo, hi) rounded to bf16 (to nearest even), lo in the lower 16 bits
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The C fragments of two 16 x 8 tiles side by side (columns 0-7 in c0,
// 8-15 in c1) as the A fragment of that 16 x 16 block, rounded to bf16:
// a product's result feeds the next product from registers.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);  // row g,     cols 2t, 2t+1
  a[1] = pack_bf16(c0[2], c0[3]);  // row g + 8, cols 2t, 2t+1
  a[2] = pack_bf16(c1[0], c1[1]);  // row g,     cols 2t+8, 2t+9
  a[3] = pack_bf16(c1[2], c1[3]);  // row g + 8, cols 2t+8, 2t+9
}

// (x, y) as three bf16 pairs, hi = bf16(x, y), mid = bf16 of what hi
// leaves out, lo = bf16 of what hi and mid leave out: hi + mid + lo holds
// each value to about 2^-24 of itself (two pairs hold it to 2^-16 only)
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;  // exact in f32
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(rx - mf.x, ry - mf.y);
}

// c_to_a with each value split into three bf16 parts (split3_bf16): the
// products of one B fragment with all three A fragments, summed in f32,
// give the product with the f32 values to about 2^-24
__device__ __forceinline__ void c_to_a_split3(uint32_t (&hi)[4],
                                              uint32_t (&mid)[4],
                                              uint32_t (&lo)[4],
                                              const float (&c0)[4],
                                              const float (&c1)[4]) {
  split3_bf16(c0[0], c0[1], hi[0], mid[0], lo[0]);  // row g,   cols 2t, 2t+1
  split3_bf16(c0[2], c0[3], hi[1], mid[1], lo[1]);  // row g+8, cols 2t, 2t+1
  split3_bf16(c1[0], c1[1], hi[2], mid[2], lo[2]);  // row g,   cols 2t+8, +9
  split3_bf16(c1[2], c1[3], hi[3], mid[3], lo[3]);  // row g+8, cols 2t+8, +9
}

// Fragment layouts of mma.m16n8k8 with tf32 operands (PTX ISA, "Matrix
// fragments for mma.m16n8k8"), g and t as above, one tf32 per b32:
//   A, 16 x 8 row-major:  a[0] = (row g, col t)
//                         a[1] = (row g + 8, col t)
//                         a[2] = (row g, col t + 4)
//                         a[3] = (row g + 8, col t + 4)
//   B, 8 x 8 (k x n):     b[0] = (k t, col g)   b[1] = (k t + 4, col g)
//   C and D: as for m16n8k16.
// The products of tf32 values are exact in f32; the tensor core adds them
// and the accumulator in f32.

// d += a * b for one 16 x 8 x 8 tile of tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v as hi + lo for 3xTF32.  hi is v rounded to tf32 (10 mantissa bits, to
// nearest, ties away from zero: half an ulp added to the magnitude, the
// low 13 bits cleared, as cvt.rna.tf32.f32 rounds); lo = v - hi, exact in
// f32, goes to the tensor core whole: an mma reads a tf32 operand's top 19
// bits, so it takes lo truncated to tf32.  Three instructions, where
// cvt.rna.tf32.f32 is a sequence of several with its own NaN checks.  A
// NaN v may wrap hi to a zero or an infinity, but lo = v - hi is NaN, so
// every product with v is NaN.  hi*hi' + hi*lo' + lo*hi' holds a product
// to about 2^-21 of itself, where hi*hi' alone holds it to 2^-11 only.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// max and sum over the four lanes of a quad (one row of a C fragment)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 bytes global -> shared, asynchronously (L2 only).  With fill false
// the 16 bytes are zeroed and nothing is read from src.  cp_async_4 copies
// 4 bytes (through L1: the L2-only form takes 16 bytes alone), for rows
// that are not 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma_tile
