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
// seeds and the NEE shadow rays, and pads the batch to whole tiles with
// dead lanes, so every thread of a block holds a real (maybe dead) ray.
//
// What bounds it on this card: per gated-in cluster and ray, 64 face tests
// of about 49 f32 operations each (the linear form; one IEEE division per
// test), against 32 B read per ray (six f32 and two seeds) and 8 B
// written. At the multiroom scene's 1,428 faces in 32 clusters a ray that
// sweeps k clusters does ~3,100 k operations per 40 bytes: FP32 issue
// bounds it, as it bounds K1, and the verdicts set how much of it there
// is. Expected time at 1M rays: (rays x gated-in clusters x 64 x 49 ops) /
// 33.5 T op/s (132 SMs x 128 lanes x 1.98 GHz; no FMA under --fmad=false).
//
// The design, for that bound and for this card (not the TPU's block by
// block):
//   - one thread block per ray tile, so the gate bit is uniform over the
//     block: the branch costs one byte read and no warp diverges on it;
//   - each thread carries RPT rays (4 at the default 1,024-ray tile, 256
//     threads), so each face's 16 constants, read once from shared memory,
//     feed RPT independent tests;
//   - each gated-in cluster's 16 x 64 f32 section (4 KB, face-major so one
//     face is four 16-byte loads, a broadcast across the block) is staged
//     into shared memory by the whole block and then swept. F has no
//     shared-memory ceiling: the TPU's 12,288-face SMEM bound is only a
//     dispatch bound here;
//   - the verdicts arrive as one byte per (tile, cluster) (the TPU packs 16
//     bits per int32 word only to fit its SMEM sign rules).
// Later work: cp.async/TMA double-buffering of sections, early exit of
// fully occluded tiles.
//
// Numerics: built with the flags of brute_intersect.cu (--fmad=false, no
// --use_fast_math, IEEE division), so it equals its plain torch version
// (ops/cuda_gated.py::_sweep_plain) bitwise.

#include <cuda_runtime.h>

#include "mt_lin.cuh"

namespace {

constexpr int kCluster = 64;                            // faces per gated section
constexpr int kSec4 = kCluster * pbr::kLinRows / 4;     // float4s per section

template <int RPT, bool ANY_HIT>
__global__ void __launch_bounds__(RPT == 1 ? 1024 : 256)
    gated_kernel(const float* __restrict__ ox_p, const float* __restrict__ oy_p,
                 const float* __restrict__ oz_p, const float* __restrict__ dx_p,
                 const float* __restrict__ dy_p, const float* __restrict__ dz_p,
                 const float4* __restrict__ tab, const unsigned char* __restrict__ verdict,
                 int n_clusters, const float* __restrict__ seed_t,
                 const int* __restrict__ seed_f, const float* __restrict__ t_limit,
                 float* __restrict__ t_out, int* __restrict__ f_out,
                 int* __restrict__ occ_out) {
  __shared__ float4 sec[kSec4];
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x * RPT + threadIdx.x;
  float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT], cx[RPT], cy[RPT], cz[RPT];
  float best[RPT];  // nearest: t; any-hit: occlusion, 0 or 1
  float lim[RPT];   // any-hit: t_limit
  int face[RPT];    // nearest: face
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const long long i = first + static_cast<long long>(r) * blockDim.x;
    ox[r] = ox_p[i];
    oy[r] = oy_p[i];
    oz[r] = oz_p[i];
    dx[r] = dx_p[i];
    dy[r] = dy_p[i];
    dz[r] = dz_p[i];
    pbr::cross_od(ox[r], oy[r], oz[r], dx[r], dy[r], dz[r], &cx[r], &cy[r], &cz[r]);
    best[r] = seed_t[i];
    if constexpr (ANY_HIT) {
      lim[r] = t_limit[i];
      face[r] = 0;
    } else {
      lim[r] = 0.0f;
      face[r] = seed_f[i];
    }
  }

  const unsigned char* bits = verdict + static_cast<long long>(blockIdx.x) * n_clusters;
  for (int c = 0; c < n_clusters; ++c) {
    if (bits[c] == 0) continue;  // one tile per block: uniform over the block
    __syncthreads();             // the previous section is no longer read
    for (int k = threadIdx.x; k < kSec4; k += blockDim.x) {
      sec[k] = tab[static_cast<long long>(c) * kSec4 + k];
    }
    __syncthreads();
    for (int j = 0; j < kCluster; ++j) {
      const float4 a = sec[4 * j], b = sec[4 * j + 1], e = sec[4 * j + 2], g = sec[4 * j + 3];
      const pbr::LinFace f{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                           e.x, e.y, e.z, e.w, g.x, g.y, g.z, g.w};
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float t;
        const bool valid =
            pbr::mt_lin(f, ox[r], oy[r], oz[r], dx[r], dy[r], dz[r], cx[r], cy[r], cz[r], &t);
        if constexpr (ANY_HIT) {
          if (valid && t < lim[r]) best[r] = 1.0f;
        } else if (valid && t < best[r]) {
          best[r] = t;
          face[r] = c * kCluster + j;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const long long i = first + static_cast<long long>(r) * blockDim.x;
    if constexpr (ANY_HIT) {
      occ_out[i] = best[r] > 0.0f ? 1 : 0;
    } else {
      t_out[i] = best[r];
      f_out[i] = face[r];
    }
  }
}

template <int RPT>
void launch(int n_tiles, int threads, cudaStream_t s, const float* ox, const float* oy,
            const float* oz, const float* dx, const float* dy, const float* dz,
            const float4* tab, const unsigned char* verdict, int n_clusters,
            const float* seed_t, const int* seed_f, const float* t_limit, float* t_out,
            int* f_out, int* occ_out) {
  if (t_limit != nullptr) {
    gated_kernel<RPT, true><<<n_tiles, threads, 0, s>>>(ox, oy, oz, dx, dy, dz, tab, verdict,
                                                        n_clusters, seed_t, seed_f, t_limit,
                                                        t_out, f_out, occ_out);
  } else {
    gated_kernel<RPT, false><<<n_tiles, threads, 0, s>>>(ox, oy, oz, dx, dy, dz, tab,
                                                         verdict, n_clusters, seed_t, seed_f,
                                                         t_limit, t_out, f_out, occ_out);
  }
}

}  // namespace

// C entry point, bound with ctypes (ops/cuda_gated.py). Pointers are device
// pointers to n_tiles x tile rays (a whole number of tiles), a face-major
// (n_clusters x 64, 16) f32 table (16-byte aligned) and (n_tiles,
// n_clusters) verdict bytes. `t_limit` null: nearest mode, seeds seed_t /
// seed_f, outputs t_out / f_out. Otherwise any-hit mode: seed_t is the 0/1
// occlusion seed, output occ_out. `tile` is a multiple of 128 up to 1,024.
// Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a shape it
// does not take).
extern "C" int pbr_gated_intersect(const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz,
                                   const float* tab, const unsigned char* verdict,
                                   int n_clusters, int n_tiles, int tile,
                                   const float* seed_t, const int* seed_f,
                                   const float* t_limit, float* t_out, int* f_out,
                                   int* occ_out, void* stream) {
  if (tile <= 0 || tile % 128 != 0 || tile > 1024 || n_clusters < 0 ||
      reinterpret_cast<unsigned long long>(tab) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* tab4 = reinterpret_cast<const float4*>(tab);
  if (tile % 512 == 0) {
    launch<4>(n_tiles, tile / 4, s, ox, oy, oz, dx, dy, dz, tab4, verdict, n_clusters, seed_t,
              seed_f, t_limit, t_out, f_out, occ_out);
  } else {
    launch<1>(n_tiles, tile, s, ox, oy, oz, dx, dy, dz, tab4, verdict, n_clusters, seed_t,
              seed_f, t_limit, t_out, f_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}
