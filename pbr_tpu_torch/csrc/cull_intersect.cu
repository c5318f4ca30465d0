// Cull-and-sweep for Hopper (sm_90a): kernels K4 (slotted) and K4m (masked).
//
// K4 replaces the TPU kernel pbr_tpu/ops/pallas_cull.py::_kernel (launched by
// ::_build_call) around ::_dot_k; K4m replaces ::_kernel_masked (launched by
// ::_build_call_masked). They compute exactly what those kernels compute:
//   - the scene's faces, in memory order, are cut into C clusters of S = 64
//     or 128 faces; cluster c holds faces [c * S, (c + 1) * S). Its (16, 4S)
//     f32 coefficient block (accel/clusters.py) contracted with a ray's
//     features f = [o, d, o x d, 1, t_limit] gives, in lane group g of the
//     block, det (g 0), tnum (1), unum (2) and vnum (3) of the linear-form
//     Moller-Trumbore for each of the S faces; then inv = 1 / det,
//     t = tnum * inv, u = unum * inv, v = vnum * inv, and the face is valid
//     iff t >= 1e-5, u >= 0, v >= 0 and u + v <= 1 (a padding face has
//     det 0, so t is NaN and never valid);
//   - K4, per ray tile and slot l in order: the tile's candidate
//     cand[t, l] runs unless l >= cnt[t], its CAND_MISS bit (1 << 20) is
//     set, or the tile is done. With early_out, after each executed slot
//     the tile is done once every ray's best t (any-hit: every unoccluded
//     ray's t_limit) is at most tent[t, l + 1], the next slot's entry bound
//     (pallas_cull.py:155-158, :177-180);
//   - K4m, per ray tile: every cluster in ascending order, gated by the
//     tile's verdict byte (the TPU packed 16 verdicts a word only for its
//     SMEM sign rules);
//   - nearest mode: within a cluster the least valid t, first face on a
//     strict '<' in ascending order; merged into the running best on
//     (tmin < tb) | (tmin == tb & fid < fb), so the first face in memory
//     order wins ties whatever the sweep order. A dead lane's seed
//     t = -3e38 never updates;
//   - any-hit mode: occ = max(occ_seed, valid & (t < t_limit)).
// The wrapper (ops/cuda_cull.py) sorts the rays, computes the candidate
// lists or verdicts (ops/cull.py), the seeds and the NEE shadow rays, and
// pads the batch to whole tiles, so every thread holds a real (maybe dead)
// ray.
//
// What bounds it on this card: per executed (ray, face) pair, the four
// 11-term sums (44 multiplies, 40 adds), one IEEE division, three
// multiplies and the gates, about 95 f32 operations, against 28 B read per
// ray (six f32 and a seed, t_limit in the any-hit pass) and 8 B written,
// plus 11 x 4S x 4 B of coefficients per executed slot, which each block
// reads once from device memory (mostly L2: the scene's blocks are 24.5 MiB
// at 100,000 faces). A tile that runs k slots does ~95 x S x k operations a
// ray: FP32 issue bounds it, at 33.5 T op/s without FMA (132 SMs x 128
// lanes x 1.98 GHz; --fmad=false), and the candidate lists and the
// early-out set how much of it there is.
//
// The design, for that bound and for this card (not the TPU's block by
// block):
//   - one thread block per ray tile, one ray a thread: the TPU grid's
//     sequential slot axis is a loop inside the block, and each block reads
//     its own cand/cnt/tent row (the TPU's scalar prefetch). A skipped slot
//     is a branch uniform over the block, so no warp diverges on it;
//   - each executed cluster's rows 0-10 (11 x 4S floats, 11 KB at S = 64,
//     22.5 KB at S = 128) are staged into shared memory by the whole block,
//     face-major: face j's 44 constants (det, tnum, unum, vnum groups of 11
//     rows) are 11 float4 broadcast loads. Row 11, the AABB lanes, is left
//     out: its feature is 0, but a padding cluster's infinite bounds times
//     0 would be NaN;
//   - the contraction is written out here in f32 without FMA contraction,
//     each sum in ascending row order, left to right: not a matrix unit and
//     not TF32 (reduced-precision passes flip the t ~ 0 self-hit gate,
//     pallas_cull.py:59-69, docs/PERF.md round 3). The plain version
//     (ops/cuda_cull.py::_face_test) sums in the same order;
//   - the early-out is one __syncthreads_and over the block per executed
//     slot.
// Later work: skip the zero coefficients of the layout (the linear form
// needs ~49 operations, not ~95), several rays a thread, cp.async/TMA
// double-buffering of the blocks.
//
// Numerics: built with --fmad=false, no --use_fast_math and IEEE division,
// so each operation rounds as the unfused torch ops do and the kernels
// equal their plain versions (ops/cuda_cull.py) bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 11;        // feature rows 0-10: o, d, o x d, 1, t_limit
constexpr int kBlockRows = 16;   // rows of a coefficient block in memory
constexpr int kFace4 = kRows;    // float4s a face: 4 groups x 11 rows
constexpr int kCandMiss = 1 << 20;
constexpr float kEps5 = 1.0e-5f;
constexpr float kBigNeg = -3.0e38f;
constexpr int kTile = 256;        // rays a tile: one block, one ray a thread

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Stage rows 0-10 of cluster `cid`'s block into shared memory, face-major:
// sm[j * 44 + g * 11 + i] = block[i][g * S + j].
template <int S>
__device__ __forceinline__ void stage(const float* __restrict__ coeffs, int cid, float* sm) {
  const float* blk = coeffs + static_cast<long long>(cid) * kBlockRows * 4 * S;
  for (int k = threadIdx.x; k < kRows * 4 * S; k += kTile) {
    const int i = k / (4 * S), lane = k - i * (4 * S);
    const int g = lane / S, j = lane - g * S;
    sm[j * (4 * kRows) + g * kRows + i] = blk[k];
  }
}

// sum_i c[i] * f[i], i = 0..10, in that order.
__device__ __forceinline__ float contract(const float* c, const float* f) {
  float acc = c[0] * f[0];
#pragma unroll
  for (int i = 1; i < kRows; ++i) acc = acc + c[i] * f[i];
  return acc;
}

// One cluster for one ray: the face test over its S faces, then the
// nearest merge or the any-hit OR. f[10] is the ray's t_limit (0 when
// nearest).
template <int S, bool ANY_HIT>
__device__ __forceinline__ void sweep_cluster(const float4* sm4, const float* f, int cid,
                                              float& best, int& face) {
  float tmin = inf_f();
  int fsub = 0;
  for (int j = 0; j < S; ++j) {
    float c[4 * kRows];
#pragma unroll
    for (int q = 0; q < kFace4; ++q) {
      const float4 v = sm4[j * kFace4 + q];
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
    const float det = contract(c, f);
    const float tnum = contract(c + kRows, f);
    const float unum = contract(c + 2 * kRows, f);
    const float vnum = contract(c + 3 * kRows, f);
    const float inv = 1.0f / det;
    const float t = tnum * inv;
    const float u = unum * inv;
    const float v = vnum * inv;
    const bool valid = (t >= kEps5) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
    if constexpr (ANY_HIT) {
      if (valid && t < f[10]) best = 1.0f;
    } else if (valid && t < tmin) {
      tmin = t;
      fsub = j;
    }
  }
  if constexpr (!ANY_HIT) {
    const int fid = cid * S + fsub;
    if (tmin < inf_f() && (tmin < best || (tmin == best && fid < face))) {
      best = tmin;
      face = fid;
    }
  }
}

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *t_limit;  // t_limit null: nearest
  const float* seed_t;
  const int* seed_f;
  float* t_out;
  int* f_out;
  int* occ_out;
};

// The ray's features and seeds, from lane i.
template <bool ANY_HIT>
__device__ __forceinline__ void load_ray(const Rays& r, long long i, float* f, float& best,
                                         int& face) {
  f[0] = r.ox[i];
  f[1] = r.oy[i];
  f[2] = r.oz[i];
  f[3] = r.dx[i];
  f[4] = r.dy[i];
  f[5] = r.dz[i];
  f[6] = f[1] * f[5] - f[2] * f[4];  // c = o x d (ops/cuda_intersect.py::cross_od)
  f[7] = f[2] * f[3] - f[0] * f[5];
  f[8] = f[0] * f[4] - f[1] * f[3];
  f[9] = 1.0f;
  f[10] = ANY_HIT ? r.t_limit[i] : 0.0f;
  best = r.seed_t[i];
  face = ANY_HIT ? 0 : r.seed_f[i];
}

template <bool ANY_HIT>
__device__ __forceinline__ void store_ray(const Rays& r, long long i, float best, int face) {
  if constexpr (ANY_HIT) {
    r.occ_out[i] = best > 0.0f ? 1 : 0;
  } else {
    r.t_out[i] = best;
    r.f_out[i] = face;
  }
}

template <int S, bool ANY_HIT>
__global__ void __launch_bounds__(kTile)
    slotted_kernel(Rays r, const float* __restrict__ coeffs, int n_clusters,
                   const int* __restrict__ cand, const int* __restrict__ cnt,
                   const float* __restrict__ tent, int early_out) {
  __shared__ float4 sm4[S * kFace4];
  const long long i = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  float f[kRows], best;
  int face;
  load_ray<ANY_HIT>(r, i, f, best, face);
  const int* cand_t = cand + static_cast<long long>(blockIdx.x) * n_clusters;
  const float* tent_t = tent + static_cast<long long>(blockIdx.x) * (n_clusters + 1);
  const int count = min(cnt[blockIdx.x], n_clusters);
  for (int l = 0; l < count; ++l) {
    const int entry = cand_t[l];
    if (entry >= kCandMiss) continue;  // the frustum misses it: uniform over the block
    __syncthreads();                   // the previous block is no longer read
    stage<S>(coeffs, entry, reinterpret_cast<float*>(sm4));
    __syncthreads();
    sweep_cluster<S, ANY_HIT>(sm4, f, entry, best, face);
    if (early_out) {
      const float key = ANY_HIT ? (best > 0.0f ? kBigNeg : f[10]) : best;
      if (__syncthreads_and(key <= tent_t[l + 1])) break;
    }
  }
  store_ray<ANY_HIT>(r, i, best, face);
}

template <int S, bool ANY_HIT>
__global__ void __launch_bounds__(kTile)
    masked_kernel(Rays r, const float* __restrict__ coeffs, int n_clusters,
                  const unsigned char* __restrict__ mask) {
  __shared__ float4 sm4[S * kFace4];
  const long long i = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  float f[kRows], best;
  int face;
  load_ray<ANY_HIT>(r, i, f, best, face);
  const unsigned char* bits = mask + static_cast<long long>(blockIdx.x) * n_clusters;
  for (int c = 0; c < n_clusters; ++c) {
    if (bits[c] == 0) continue;  // one tile per block: uniform over the block
    __syncthreads();
    stage<S>(coeffs, c, reinterpret_cast<float*>(sm4));
    __syncthreads();
    sweep_cluster<S, ANY_HIT>(sm4, f, c, best, face);
  }
  store_ray<ANY_HIT>(r, i, best, face);
}

bool shape_ok(int n_clusters, int size) { return n_clusters >= 0 && (size == 64 || size == 128); }

Rays rays_of(const float* ox, const float* oy, const float* oz, const float* dx,
             const float* dy, const float* dz, const float* t_limit, const float* seed_t,
             const int* seed_f, float* t_out, int* f_out, int* occ_out) {
  return Rays{ox, oy, oz, dx, dy, dz, t_limit, seed_t, seed_f, t_out, f_out, occ_out};
}

}  // namespace

// C entry points, bound with ctypes (ops/cuda_cull.py). Pointers are device
// pointers to n_tiles x 256 rays (a whole number of tiles), the (C, 16, 4S)
// f32 coefficient blocks, and the gate tables: K4 takes cand (n_tiles, C)
// int32, cnt (n_tiles,) int32 and tent (n_tiles, C + 1) f32 and a flag for
// the early-out; K4m takes (n_tiles, C) verdict bytes. `t_limit` null:
// nearest mode, seeds seed_t / seed_f, outputs t_out / f_out. Otherwise
// any-hit mode: seed_t is the 0/1 occlusion seed, output occ_out. `size`
// is 64 or 128. Each launches one 256-thread block a tile (ops/cuda_cull.py's
// TILE) on `stream` without synchronising and returns cudaGetLastError() of
// the launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int pbr_cull_slotted(const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                const float* t_limit, const float* coeffs, int n_clusters,
                                int size, int n_tiles, const int* cand, const int* cnt,
                                const float* tent, int early_out,
                                const float* seed_t, const int* seed_f, float* t_out,
                                int* f_out, int* occ_out, void* stream) {
  if (!shape_ok(n_clusters, size)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rays r = rays_of(ox, oy, oz, dx, dy, dz, t_limit, seed_t, seed_f, t_out, f_out, occ_out);
  if (size == 64 && t_limit) {
    slotted_kernel<64, true><<<n_tiles, kTile, 0, s>>>(r, coeffs, n_clusters, cand, cnt, tent,
                                                      early_out);
  } else if (size == 64) {
    slotted_kernel<64, false><<<n_tiles, kTile, 0, s>>>(r, coeffs, n_clusters, cand, cnt, tent,
                                                       early_out);
  } else if (t_limit) {
    slotted_kernel<128, true><<<n_tiles, kTile, 0, s>>>(r, coeffs, n_clusters, cand, cnt, tent,
                                                       early_out);
  } else {
    slotted_kernel<128, false><<<n_tiles, kTile, 0, s>>>(r, coeffs, n_clusters, cand, cnt,
                                                        tent, early_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pbr_cull_masked(const float* ox, const float* oy, const float* oz,
                               const float* dx, const float* dy, const float* dz,
                               const float* t_limit, const float* coeffs, int n_clusters,
                               int size, int n_tiles, const unsigned char* mask,
                               const float* seed_t, const int* seed_f, float* t_out,
                               int* f_out, int* occ_out, void* stream) {
  if (!shape_ok(n_clusters, size)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rays r = rays_of(ox, oy, oz, dx, dy, dz, t_limit, seed_t, seed_f, t_out, f_out, occ_out);
  if (size == 64 && t_limit) {
    masked_kernel<64, true><<<n_tiles, kTile, 0, s>>>(r, coeffs, n_clusters, mask);
  } else if (size == 64) {
    masked_kernel<64, false><<<n_tiles, kTile, 0, s>>>(r, coeffs, n_clusters, mask);
  } else if (t_limit) {
    masked_kernel<128, true><<<n_tiles, kTile, 0, s>>>(r, coeffs, n_clusters, mask);
  } else {
    masked_kernel<128, false><<<n_tiles, kTile, 0, s>>>(r, coeffs, n_clusters, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
