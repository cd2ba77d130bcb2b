// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), written out as device functions: the Monte-Carlo stage's
// random stream. No curand. The plain torch version is
// ldpc_tpu_torch/ops/rng.py; both give Random123's philox4x32_R(10, ...)
// known answers.
//
// Stream contract (shared with ops/rng.py): key = the 64-bit batch seed
// (lo, hi); word w of codeword lane b is output w % 4 of the block at
// counter (w / 4, b lo, b hi, 0). A lane's words depend on (seed, b, w)
// only, not on the block shape or the batch size.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ldpc {

__device__ inline uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// Word w of lane b under key (k0, k1).
__device__ inline uint32_t philox_word(uint32_t k0, uint32_t k1, long long b,
                                       int w) {
  const uint4 r = philox4x32_10(
      make_uint4(uint32_t(w) >> 2, uint32_t(b), uint32_t(b >> 32), 0u),
      make_uint2(k0, k1));
  switch (w & 3) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

}  // namespace ldpc
