// Philox4x32-10 (Salmon et al., SC'11) and the head's normal draw.
//
// Counter-based: the value at an element depends only on (key, counter),
// so a kernel can regenerate any variate it drew before without storing
// it.  The head kernel keys the stream by (seed, step) and gives every
// element its own counter (v, m, s, tag), which makes the stream
// independent of the tile shape and identical to the plain PyTorch twin in
// repro_torch/kernels/rng.py.  Known answers: counter 0 / key 0 gives
// 6627e8d5 e169c58d bc57ac4c 9b00dbd8; all-ones gives
// 408f276d 41c83b0e a20bc7c6 6d5451fd.
#pragma once

#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Box-Muller over the first two words, each mapped to U[0, 1) by its top
// 24 bits: sqrt(-2 log(1 - u1)) * cos(2 pi u2), as the JAX package's
// kernels/rng.py draws its normals.  1 - u1 lies in (0, 1], so the log is
// finite.
__device__ __forceinline__ float philox_normal(uint32_t seed, uint32_t step,
                                               uint32_t v, uint32_t m,
                                               uint32_t s, uint32_t tag) {
  const uint4 o = philox4x32_10(make_uint4(v, m, s, tag), seed, step);
  const float u1 = (float)(o.x >> 8) * (1.0f / 16777216.0f);
  const float u2 = (float)(o.y >> 8) * (1.0f / 16777216.0f);
  const float r = sqrtf(-2.0f * logf(1.0f - u1));
  return r * cosf(6.2831853071795865f * u2);
}

}  // namespace repro
