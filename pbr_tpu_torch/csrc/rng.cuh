// The counter-based RNG of ops/rng.py (and pbr_tpu's), on uint32: every
// uniform is a chain of lowbias32 hashes of (frame seed, pixel, sample,
// bounce, stream). The plain version emulates uint32 in int64 tensors; here
// it is native, and the bits are the same. A lane's key is
// PixelRng._base, fold(lowbias32(seed), pixel), read from its int64 tensor
// (the values lie in [0, 2^32)), so a compacted stage reads the keys its
// rows gathered.

#pragma once

#include <cuda_runtime.h>

namespace pbr {
namespace shade {

// Stream ids (ops/rng.py).
constexpr unsigned kAaR = 0, kAaPhi = 1, kDofR = 2, kDofPhi = 3, kTrans = 4, kRefr = 5,
                   kBrdfA = 6, kBrdfB = 7, kBrdfC = 8, kExtend = 9, kRr = 10;

__device__ __forceinline__ unsigned lowbias32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ unsigned fold(unsigned h, unsigned v) {
  return lowbias32(h ^ (v * 0x9E3779B9u));
}

// _to_uniform: the top 24 bits over 2^24, exact in float32.
__device__ __forceinline__ float to_uniform(unsigned h) {
  return static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
}

// BounceRng: the (sample, bounce) prefix folded once, a draw per stream.
struct BounceRng {
  unsigned h;
  __device__ __forceinline__ BounceRng(long long base, int sample, int bounce)
      : h(fold(fold(static_cast<unsigned>(base), static_cast<unsigned>(sample)),
               static_cast<unsigned>(bounce))) {}
  __device__ __forceinline__ float u(unsigned stream) const { return to_uniform(fold(h, stream)); }
};

}  // namespace shade
}  // namespace pbr
