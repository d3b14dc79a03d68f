// The port's in-kernel sampler: Philox4x32-10 and Box-Muller, the device
// twin of vae_training_tpu_torch/ops/rng.py (shared by every kernel that
// samples). key = the 64-bit run seed, counter = (absolute step, row, draw,
// stream); one Philox call gives four words and four normals. The words
// equal ops/rng.py's bitwise; the normals need the precise logf/sincosf, so
// the kernels are built without --use_fast_math.
#pragma once

#include <stdint.h>

namespace philox {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv2p24 = 5.9604644775390625e-08f;

// ops/rng.py stream ids
constexpr uint32_t kStreamManifold = 0;
constexpr uint32_t kStreamZ1 = 1;
constexpr uint32_t kStreamZ2 = 2;
constexpr uint32_t kStreamObs = 3;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
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

__device__ __forceinline__ float uniform24(uint32_t w) {
  return (static_cast<float>(w >> 8) + 0.5f) * kInv2p24;
}

// Four normals from one word quadruple: Box-Muller on words (0,1) and (2,3).
__device__ __forceinline__ void box_muller4(uint4 w, float out[4]) {
  float sn, cs;
  float r = sqrtf(-2.0f * logf(uniform24(w.x)));
  sincosf(kTwoPi * uniform24(w.y), &sn, &cs);
  out[0] = r * cs;
  out[1] = r * sn;
  r = sqrtf(-2.0f * logf(uniform24(w.z)));
  sincosf(kTwoPi * uniform24(w.w), &sn, &cs);
  out[2] = r * cs;
  out[3] = r * sn;
}

// Normals 4·draw .. 4·draw+3 of row `row` of one stream at one step.
__device__ __forceinline__ void normals4(uint32_t step, int row, int draw, uint32_t stream,
                                         uint32_t k0, uint32_t k1, float out[4]) {
  box_muller4(philox4x32_10(make_uint4(step, static_cast<uint32_t>(row),
                                       static_cast<uint32_t>(draw), stream),
                            k0, k1),
              out);
}

}  // namespace philox
