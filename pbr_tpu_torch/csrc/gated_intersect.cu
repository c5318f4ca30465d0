// Gated brute-force sweep for Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel pbr_tpu/ops/pallas_gated.py::_kernel (launched by
// ::_build_call) around ::_mt_lin_update. It computes exactly what that
// kernel computes:
//   - the faces are the scene's, in memory order, grouped in 64-face
//     clusters (the ClusterSet's fine granularity), zero-padded to C x 64
//     faces (a padding face has det 0, so t is NaN and never valid);
//   - per ray tile (the wrapper's `rows` x 128 rays) and per cluster c in
//     ascending order, the cull verdict (tile, c) gates the whole 64-face
//     section; inside it, each face runs the linear-form Moller-Trumbore of
//     pbr::mt_lin (mt_lin.cuh), with c = o x d once per ray;
//   - nearest mode starts from the seeds (t, face) and updates on a strict
//     '<', so the first face in memory order wins ties (a dead lane's seed
//     t = -3e38 never updates);
//   - any-hit mode computes occ = max(occ_seed, valid & (t < t_limit)).
// The wrapper (ops/cuda_gated.py) computes the verdicts (ops/cull.py), the
// seeds and the NEE shadow rays, pads the batch to whole tiles with dead
// lanes and reads the face-major table that scene/device.py::to_torch
// builds once a scene.
//
// What bounds it on this card: FP32 issue. A (ray, face) test is ~44
// operations of the linear form, against 40 bytes a ray; multiroom's camera
// rays meet ~830 gated-in real faces each. Of those tests only a few can
// change the result: t must reach 1e-5 and beat the ray's running best
// (nearest) or its t_limit (any-hit, on a ray not occluded yet). So the
// work itself is what to cut (tools/k3_tiles.py measures it; PERF.md has
// each design step, those that lost included):
//   - t first: every test computes det, the IEEE 1 / det and t (about 15
//     operations) from the face's first 16 bytes, {m, km}; only where t
//     can change the result does it load the face's other 48 bytes and
//     compute u and v (29 more), in the operation order of mt_lin, so the
//     result is bitwise the full test's. kBatch faces' t go first, then
//     their u and v in face order, so the updates stay in face order. A
//     warp pays for u and v where any of its lanes needs them: coherent
//     (camera) rays gain most, incoherent bounce rays little;
//   - early exits: a lane that can no longer change (nearest: a dead lane,
//     best <= 1e-5; any-hit: occluded, or seeded 1) tests nothing more,
//     and a warp none of whose lanes can change leaves the sweep (one vote
//     per gated-in section). The answer of such a lane is its seed or the
//     max it already holds, so the exit is exact;
//   - no staging: the table is read through L1 (a broadcast 16-byte load a
//     face and warp), so warps need no barrier and a warp that leaves does
//     not hold its block. Under auto the table reaches 12,288 faces (the
//     top of K3's band, ops/traverse.py::AUTO_BANDS; 768 KB), and an
//     explicit 'gated' more: no design may need it whole in shared memory;
//   - one ray a thread in 64-ray blocks: a 1,024-ray tile is 16 blocks,
//     each reading its tile's verdict row, so 1M rays make 16,384 blocks
//     and the last wave is short; 16 blocks an SM, 48 / 46 registers.
// Tiles heaviest first, the rays of a tile in direction order, a lane
// looping over its own candidates, a batch's u-v tests dealt over the warp,
// 2 or 4 rays a thread and other block sizes lost or tied (PERF.md).
//
// Numerics: built with the flags of brute_intersect.cu (--fmad=false, no
// --use_fast_math, IEEE division), so it equals its plain torch version
// (ops/cuda_gated.py::_sweep_plain) bitwise.

#include <cuda_runtime.h>

#include "mt_lin.cuh"

namespace {

constexpr int kCluster = 64;                         // faces per gated section
constexpr int kFace4 = pbr::kLinRows / 4;            // float4s a face
constexpr int kWarps = 2;                            // warps a block, one ray a thread
constexpr int kMinBlocks = 16;                       // blocks an SM (launch bounds)
constexpr int kBatch = 4;                            // faces whose t go first together
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;
static_assert(128 % kThreads == 0, "a block's rays divide the smallest tile");
static_assert(kCluster % kBatch == 0, "batches divide a section");

template <bool ANY_HIT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gated_kernel(const float* __restrict__ ox_p, const float* __restrict__ oy_p,
                 const float* __restrict__ oz_p, const float* __restrict__ dx_p,
                 const float* __restrict__ dy_p, const float* __restrict__ dz_p,
                 const float4* __restrict__ tab, const unsigned char* __restrict__ verdict,
                 int n_clusters, int tile, const float* __restrict__ seed_t,
                 const int* __restrict__ seed_f, const float* __restrict__ t_limit,
                 float* __restrict__ t_out, int* __restrict__ f_out,
                 int* __restrict__ occ_out) {
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;  // the ray
  const long long tid = first / tile;  // a block's rays lie in one tile
  const float ox = ox_p[first], oy = oy_p[first], oz = oz_p[first];
  const float dx = dx_p[first], dy = dy_p[first], dz = dz_p[first];
  float cx, cy, cz;
  pbr::cross_od(ox, oy, oz, dx, dy, dz, &cx, &cy, &cz);
  float best = seed_t[first];  // nearest: t; any-hit: occlusion, 0 or 1
  const float lim = ANY_HIT ? t_limit[first] : 0.0f;
  int face = ANY_HIT ? 0 : seed_f[first];

  const unsigned char* bits = verdict + tid * n_clusters;
  for (int c = 0; c < n_clusters; ++c) {
    if (bits[c] == 0) continue;  // one tile per block: uniform over the block
    // Lanes that can still change: nearest, best > 1e-5 (a test must reach
    // 1e-5 and beat it); any-hit, not occluded and t_limit > 1e-5.
    const bool open = ANY_HIT ? (best == 0.0f && lim > pbr::kLinEps5) : (best > pbr::kLinEps5);
    if (!__any_sync(kAll, open)) break;
    const float4* sec = tab + static_cast<long long>(c) * kCluster * kFace4;
#pragma unroll 1
    for (int j0 = 0; j0 < kCluster; j0 += kBatch) {
      float t[kBatch], inv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const float4 mk = __ldg(sec + (j0 + k) * kFace4);  // {m, km}
        const pbr::LinFace f{mk.x, mk.y, mk.z, mk.w};
        inv[k] = 1.0f / pbr::lin_det(f, dx, dy, dz);
        t[k] = pbr::lin_tnum(f, ox, oy, oz) * inv[k];
      }
      // In face order: u and v only where t can change the result.
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool cand = ANY_HIT ? (best == 0.0f && t[k] >= pbr::kLinEps5 && t[k] < lim)
                                  : (t[k] >= pbr::kLinEps5 && t[k] < best);
        if (!cand) continue;
        const float4* g = sec + (j0 + k) * kFace4;
        const float4 b = __ldg(g + 1), e = __ldg(g + 2), h = __ldg(g + 3);
        const pbr::LinFace f{0.0f, 0.0f, 0.0f, 0.0f, b.x, b.y, b.z, b.w,
                             e.x,  e.y,  e.z,  e.w,  h.x, h.y, h.z, h.w};
        if (!pbr::lin_uv(f, dx, dy, dz, cx, cy, cz, inv[k])) continue;
        if constexpr (ANY_HIT) {
          best = 1.0f;
        } else {
          best = t[k];
          face = c * kCluster + j0 + k;
        }
      }
    }
  }

  if constexpr (ANY_HIT) {
    occ_out[first] = best > 0.0f ? 1 : 0;
  } else {
    t_out[first] = best;
    f_out[first] = face;
  }
}

}  // namespace

// C entry point, bound with ctypes (ops/cuda_gated.py). Pointers are device
// pointers to n_tiles x tile rays (a whole number of tiles), a face-major
// (n_clusters x 64, 16) f32 table (16-byte aligned), (n_tiles,
// n_clusters) verdict bytes. `t_limit` null: nearest mode, seeds seed_t / seed_f, outputs
// t_out / f_out. Otherwise any-hit mode: seed_t is the 0/1 occlusion seed,
// output occ_out. `tile` is a multiple of 128 up to 1,024. Launches on
// `stream` without synchronising and returns cudaGetLastError() of the
// launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int pbr_gated_intersect(const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz,
                                   const float* tab, const unsigned char* verdict,
                                   int n_clusters, int n_tiles, int tile,
                                   const float* seed_t, const int* seed_f,
                                   const float* t_limit, float* t_out, int* f_out,
                                   int* occ_out, void* stream) {
  if (tile <= 0 || tile % 128 != 0 || tile > 1024 || n_clusters < 0 || n_tiles < 0 ||
      static_cast<long long>(n_tiles) * (tile / kThreads) > 0x7fffffffLL ||
      reinterpret_cast<unsigned long long>(tab) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* tab4 = reinterpret_cast<const float4*>(tab);
  const dim3 grid(n_tiles * (tile / kThreads));
  if (t_limit != nullptr) {
    gated_kernel<true><<<grid, kThreads, 0, s>>>(ox, oy, oz, dx, dy, dz, tab4, verdict,
                                                 n_clusters, tile, seed_t, seed_f,
                                                 t_limit, t_out, f_out, occ_out);
  } else {
    gated_kernel<false><<<grid, kThreads, 0, s>>>(ox, oy, oz, dx, dy, dz, tab4, verdict,
                                                  n_clusters, tile, seed_t, seed_f,
                                                  t_limit, t_out, f_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}
