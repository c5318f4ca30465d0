// A nearest result (t, face) as one 64-bit key whose unsigned order is the
// (t, face) lexicographic order: t's bits made order-preserving, then the
// face with its sign bit flipped. A shared 64-bit atomicMin of such keys
// keeps the least t and, among equal t, the least face, whatever the order
// of the merges. Shared by the row sweep K5 (row_sweep.cu), the slab
// walk K7 (bvh_packet.cu) and the Phong cluster search K10
// (phong_clusters.cu).

#pragma once

#include <cuda_runtime.h>

namespace pbr {

__device__ __forceinline__ unsigned long long pack_key(float t, int face) {
  const unsigned u = __float_as_uint(t);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) | (static_cast<unsigned>(face) ^ 0x80000000u);
}

__device__ __forceinline__ float key_t(unsigned long long k) {
  const unsigned ord = static_cast<unsigned>(k >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord ^ 0x80000000u) : ~ord);
}

__device__ __forceinline__ int key_face(unsigned long long k) {
  return static_cast<int>(static_cast<unsigned>(k) ^ 0x80000000u);
}

}  // namespace pbr
