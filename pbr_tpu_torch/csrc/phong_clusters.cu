// Phong cluster search for Hopper (sm_90a): kernel K10.
//
// The H100 form of the JAX package's Phong cluster search, which is no
// Pallas kernel but an XLA while_loop: pbr_tpu/ops/phongtess.py::
// intersect_clusters_phongtess (the loop at :730; tiles_done :681, cond
// :685, body :689-728). One block a 128-ray tile, one thread a ray; the
// block runs the tile's rounds over its near-to-far cluster list
// (ops/cull.py::candidates_fine, torch ops outside the kernel, as JAX
// keeps it outside its loop). Round r:
//   - the tile stops when its list has run out (cnt <= r) or no ray's best
//     t lies beyond the entry bound tent[r] (__syncthreads_or): the port's
//     per-tile stop (the JAX loop runs every tile until the last one is
//     done, which differs only where a face lies exactly at an entry bound;
//     a listed divergence);
//   - otherwise the cluster's faces are staged in shared memory (80 B a
//     face) and each live ray tests them all in id order (phong.cuh:
//     Moller-Trumbore for a flat face, the patch test bounded by the ray's
//     best t at the start of the round for a curved one, t >= EPSILON5),
//     takes the first face of the least t (argmin's tie rule) and merges it
//     by (t, face) lexicographic order.
// A dead lane starts at t = -3e38 and face -1, as the plain version seeds
// it: it never wins, and never keeps its tile open.
//
// What bounds it on this card: operations. A ray reads 25 B and writes
// 12 B; a tile-round reads 5 KB of faces, once a block from L2; each ray
// does a patch test (several hundred float32 operations, two divisions, a
// square root, and transcendentals on the cubic's three-root branch) per
// curved face and 51 operations per flat face. What the design does about
// it: the faces come once a block into shared memory and are broadcast to
// the 128 rays; the ray's planes and dominant axis are computed once a ray;
// each solve evaluates the branch it takes; dead lanes skip the tests.
//
// Numerics as K1-K9 (--fmad=false, IEEE division and sqrt): bitwise equal
// to the plain version, ops/phongtess.py::intersect_clusters_phongtess.

#include <cuda_runtime.h>
#include <math.h>

#include "phong.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kMaxSize = 128;  // faces a cluster (64 or 128, scene/build.py)
constexpr float kDead = -3.0e38f;

struct Params {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const unsigned char* alive;  // (n,) bool (null: all live)
  int n;
  const float4* faces;  // (C * size, 5) Phong face records
  int size;
  const int* cand;    // (T, n_cand) cluster ids, near to far
  const int* cnt;     // (T,) valid entries
  const float* tent;  // (T, n_cand) entry bounds
  int n_cand;
  float alpha, oma;  // float32(alpha), float32(1 - alpha)
  int* f_out;
  float *u_out, *v_out;
  int* rounds_out;  // (T,) or null
};

__global__ void __launch_bounds__(kTile) phong_clusters_kernel(const Params p) {
  extern __shared__ float4 staged[];  // size * 5 words
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int ray = tile * kTile + lane;
  const bool live = ray < p.n && (p.alive == nullptr || p.alive[ray] != 0);
  float t_b = live ? INFINITY : kDead, u_b = 0.0f, v_b = 0.0f;
  int f_b = -1;
  pbr::PhongRay pr{};
  if (live) pr = pbr::phong_ray(p.ox[ray], p.oy[ray], p.oz[ray], p.dx[ray], p.dy[ray], p.dz[ray]);
  const int cnt = p.cnt[tile];
  const size_t row = static_cast<size_t>(tile) * p.n_cand;
  const int words = p.size * pbr::kPhongWords;
  int r = 0;
  for (; r < p.n_cand && r < cnt; ++r) {
    // Also the barrier after the previous round's reads of the staged faces.
    if (!__syncthreads_or(t_b > p.tent[row + r])) break;
    const int cid = p.cand[row + r];
    const float4* src = p.faces + static_cast<size_t>(cid) * words;
    for (int j = lane; j < words; j += kTile) staged[j] = __ldg(src + j);
    __syncthreads();
    if (live) {
      const float tb0 = t_b;  // the round's bound for every patch test
      float tm = INFINITY, um = 0.0f, vm = 0.0f;
      int km = -1;
      for (int k = 0; k < p.size; ++k) {
        const float4* w = staged + k * pbr::kPhongWords;
        const pbr::PatchHit h = pbr::phong_face_hit(pbr::phong_face(w[0], w[1], w[2], w[3], w[4]),
                                                    pr, p.alpha, p.oma, tb0);
        if (h.t < tm) {
          tm = h.t;
          km = k;
          um = h.u;
          vm = h.v;
        }
      }
      const int fid = cid * p.size + km;
      if (tm < INFINITY && (tm < t_b || (tm == t_b && fid < f_b))) {
        t_b = tm;
        f_b = fid;
        u_b = um;
        v_b = vm;
      }
    }
  }
  if (ray < p.n) {
    p.f_out[ray] = f_b;
    p.u_out[ray] = u_b;
    p.v_out[ray] = v_b;
  }
  if (lane == 0 && p.rounds_out != nullptr) p.rounds_out[tile] = r;
}

}  // namespace

// C entry point, bound with ctypes (ops/cuda_phong.py). Pointers are device
// pointers; faces are the (C * size, 20) Phong face records; cand, cnt and
// tent the (T, n_cand), (T,) and (T, n_cand) lists of ceil(n / 128) tiles.
// rounds_out null: no per-tile rounds. Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int pbr_phong_clusters(const float* ox, const float* oy, const float* oz,
                                  const float* dx, const float* dy, const float* dz,
                                  const unsigned char* alive, int n, const float* faces,
                                  int size, const int* cand, const int* cnt, const float* tent,
                                  int n_cand, float alpha, float one_minus_alpha, int* f_out,
                                  float* u_out, float* v_out, int* rounds_out, void* stream) {
  if (n < 0 || size < 1 || size > kMaxSize || n_cand < 1 || f_out == nullptr ||
      u_out == nullptr || v_out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Params p{ox,    oy,   oz,   dx,     dy,    dz,
                 alive, n,    reinterpret_cast<const float4*>(faces),
                 size,  cand, cnt,  tent,   n_cand, alpha,
                 one_minus_alpha,   f_out,  u_out, v_out, rounds_out};
  const int tiles = (n + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(size) * pbr::kPhongWords * sizeof(float4);
  phong_clusters_kernel<<<tiles, kTile, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
