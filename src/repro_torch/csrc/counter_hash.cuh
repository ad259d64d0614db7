// The repository's counter hash (core/rng.py), shared by the two IC tile
// kernels (csrc/fused_expand.cu, csrc/fused_expand_q.cu):
//
//   hash_u32(seed, level, counter, word)
//     = fold(fold(fold(seed * kGolden, level), counter), word)
//
// in native uint32 arithmetic, bit for bit the reference's.
#pragma once

#include <stdint.h>

namespace counter_hash {

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;

// murmur3's fmix32 finalizer.
__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

// One counter step: mix(h ^ (v + kGolden + (h << 6) + (h >> 2))).
__host__ __device__ __forceinline__ uint32_t fold(uint32_t h, uint32_t v) {
  return mix32(h ^ (v + kGolden + (h << 6) + (h >> 2)));
}

// The state after seed and level, shared by one launch.
__host__ __device__ __forceinline__ uint32_t level_prefix(uint32_t seed,
                                                          uint32_t level) {
  return fold(seed * kGolden, level);
}

}  // namespace counter_hash
