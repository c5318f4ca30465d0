// Packet BVH walks for Hopper (sm_90a): kernel K6 (five instances) and its
// leaf-slab variant K7 (two instances).
//
// K6 replaces pbr_tpu/ops/pallas_bvh.py::_kernel (nearest), ::_kernel_nee
// (nearest + fused NEE shadow any-hit), ::_kernel_shadow (any-hit against
// t_limit), ::_kernel_seeded (nearest from a running best) and
// ::_kernel_shadow_seeded (any-hit from a running occlusion mask), all
// around ::_traverse_tile; the seeded pair carries the forest's chain over
// its sub-trees (ops/cuda_bvh.py::intersect_bvh_forest). K7 replaces
// ::_kernel_hbm and ::_kernel_hbm_nee around ::_traverse_tile_hbm. One
// template, packet_kernel<MODE, SLAB>, computes what they compute:
//   - the stackless walk of bvh.cuh with a cursor shared by a packet of
//     rays: the packet steps to i + 1 when any live ray of it hits node i
//     (box, t_far > EPSILON5, the empty-box guard, and t_best > t_near, or
//     for any-hit "not yet occluded and t_limit > t_near"), else to
//     exit[i]; at a leaf each ray that hits it tests the leaf's
//     min(leaf_count, max_leaf) faces with the classic Moller-Trumbore of
//     mt.cuh, strict '<' in ascending face order (the first face in memory
//     order wins ties), face ids offset by face_base;
//   - any-hit: a ray is occluded by a valid face with t < t_limit; the
//     packet stops once every live ray is occluded;
//   - NEE: after the nearest walk, the shadow ray is re-derived with the
//     integrator's guarded math, exactly as _kernel_nee :222-245 and K1 do
//     (ts = hit ? t : 1; t_light = len2 > 0 ? sqrt(len2) : 0; inv =
//     |t_light| > 1e-12 ? 1/t_light : 0), then walked any-hit.
// A ray's results do not depend on its packet: a node's box holds its
// children's, so a ray that hits a node hit every node above it with a
// larger t_best, and the packet visits every node the ray's own walk
// visits, in the same order. That is why the plain version
// (ops/cuda_bvh.py::walk_plain) walks each ray alone and still agrees
// bitwise.
//
// The design keeps the TPU kernel's: there the cursor belongs to a tile of
// 1,024 rays and a node record is a scalar row read; here it belongs to a
// warp. Each lane holds one ray and its state (t, face, occlusion) in
// registers; every lane of the warp, the padding lanes past n and the dead
// lanes included, takes part in the vote (__any_sync / __all_sync on the
// full mask), voting false when it is not live, so the cursor is uniform
// and no lane leaves the loop early. Rays come in the order the wrapper
// sorts them by (octant, Morton code of the origin in the root box), so
// the 32 rays of a warp are coherent. K6 reads the nodes and the leaf
// faces from global memory through the read-only cache: every lane reads
// the same node, a broadcast. K7 reads the nodes the same way (4,523 nodes,
// 163 KB for soup:100000) and, when the warp lands on a leaf that some live
// ray hits, stages that leaf's faces (9 floats each, at most max_leaf of
// them: 2.3 KB at 64) into the warp's part of shared memory and tests them
// there. It copies nothing at a node no ray hits: the TPU kernel's "copy a
// slab at every step" was a Mosaic control-flow workaround.
//
// What bounds it on this card: per ray it reads 24 B and writes 9-12 B,
// and does ~25 float32 operations a node step and ~51 a face test over
// hundreds of steps, so the least time is set by operations; a warp's
// walk is the union of its rays' walks, so its lanes idle on the nodes
// only some of them hit. Making that fast (wider packets, a node stack,
// better sorting) is later work.
//
// Numerics: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false,
// no --use_fast_math (default IEEE division and sqrt), as K1-K4: every
// operation rounds as the plain torch version does.

#include <cuda_runtime.h>
#include <math.h>

#include "bvh.cuh"
#include "mt.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kSlabMaxLeaf = 256;  // ops/cuda_bvh.py::SLAB_MAX_LEAF

enum Mode : int { kNearest = 0, kNee = 1, kAnyHit = 2, kSeeded = 3, kSeededAnyHit = 4 };

struct Params {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const int* order;            // (n,) launch order (null: identity)
  const unsigned char* alive;  // (n,) bool (null: all live)
  int n;
  pbr::Tree tree;
  const float* faces;  // (9, stride) table: face f of row r at r * stride + f
  int stride;
  int face_base;  // added to the face ids written
  int max_leaf;
  const float* light;    // (3,) light 0 (kNee)
  const float* t_limit;  // (n,) (any-hit modes)
  const float* t_seed;   // (n,) (kSeeded)
  const int* f_seed;
  const unsigned char* occ_seed;  // (n,) bool (kSeededAnyHit)
  float* t_out;
  int* f_out;
  unsigned char* occ_out;  // (n,) bool
};

template <bool SLAB>
__device__ __forceinline__ pbr::Face leaf_face(const Params& p, const float* slab, int lf,
                                               int k) {
  if constexpr (SLAB) {
    const int m = p.max_leaf;
    return pbr::Face{slab[k],         slab[m + k],     slab[2 * m + k],
                     slab[3 * m + k], slab[4 * m + k], slab[5 * m + k],
                     slab[6 * m + k], slab[7 * m + k], slab[8 * m + k]};
  } else {
    return pbr::load_face(p.faces, p.stride, lf + k);
  }
}

// The warp's walk of one tree. Nearest (ANY false): updates *t_best /
// *f_best. Any-hit: sets *occ. Every lane of the warp calls it together.
template <bool ANY, bool SLAB>
__device__ void walk(const Params& p, const pbr::Ray& r, bool live, float t_limit,
                     float* t_best, int* f_best, bool* occ, float* slab) {
  const int lane = threadIdx.x & 31;
  int i = 0;
  while (i < p.tree.n) {
    if constexpr (ANY) {
      if (__all_sync(kAll, *occ || !live)) return;
    }
    float t_near;
    bool hit = pbr::box_hit(p.tree, i, r, &t_near) && live;
    if constexpr (ANY) {
      hit = hit && !*occ && t_limit > t_near;
    } else {
      hit = hit && *t_best > t_near;
    }
    if (!__any_sync(kAll, hit)) {
      i = __ldg(p.tree.exit + i);
      continue;
    }
    const int lf = __ldg(p.tree.leaf_first + i);
    if (lf >= 0) {
      const int cnt = min(__ldg(p.tree.leaf_count + i), p.max_leaf);
      if constexpr (SLAB) {
        __syncwarp();  // every lane is done with the previous slab
        for (int j = lane; j < 9 * cnt; j += 32) {
          const int row = j / cnt;
          const int k = j - row * cnt;
          slab[row * p.max_leaf + k] = __ldg(p.faces + row * p.stride + lf + k);
        }
        __syncwarp();
      }
      if (hit) {
        for (int k = 0; k < cnt; ++k) {
          float t;
          const bool valid =
              pbr::moller_trumbore(leaf_face<SLAB>(p, slab, lf, k), r.ox, r.oy, r.oz, r.dx,
                                   r.dy, r.dz, &t);
          if constexpr (ANY) {
            if (valid && t < t_limit) {
              *occ = true;
              break;
            }
          } else if (valid && t < *t_best) {
            *t_best = t;
            *f_best = p.face_base + lf + k;
          }
        }
      }
    }
    ++i;
  }
}

template <int MODE, bool SLAB>
__global__ void __launch_bounds__(kThreads) packet_kernel(const Params p) {
  extern __shared__ float smem[];
  float* slab = SLAB ? smem + (threadIdx.x >> 5) * 9 * p.max_leaf : nullptr;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const bool in = g < p.n;
  const int ray = in ? (p.order != nullptr ? p.order[g] : g) : 0;
  // Lanes past the tail and dead lanes walk with the warp and vote false.
  const bool live = in && (p.alive == nullptr || p.alive[ray] != 0);
  const float ox = in ? p.ox[ray] : 0.0f;
  const float oy = in ? p.oy[ray] : 0.0f;
  const float oz = in ? p.oz[ray] : 0.0f;
  const float dx = in ? p.dx[ray] : 0.0f;
  const float dy = in ? p.dy[ray] : 0.0f;
  const float dz = in ? p.dz[ray] : 1.0f;
  const pbr::Ray r = pbr::make_ray(ox, oy, oz, dx, dy, dz);

  if constexpr (MODE == kAnyHit || MODE == kSeededAnyHit) {
    bool occ = (MODE == kSeededAnyHit && in) ? p.occ_seed[ray] != 0 : false;
    const float t_limit = in ? p.t_limit[ray] : 0.0f;
    walk<true, SLAB>(p, r, live, t_limit, nullptr, nullptr, &occ, slab);
    if (in) p.occ_out[ray] = occ ? 1 : 0;
    return;
  }

  float t_best = INFINITY;
  int f_best = -1;
  if (MODE == kSeeded && in) {
    t_best = p.t_seed[ray];
    f_best = p.f_seed[ray];
  }
  walk<false, SLAB>(p, r, live, 0.0f, &t_best, &f_best, nullptr, slab);
  if (in) {
    p.t_out[ray] = t_best;
    p.f_out[ray] = f_best;
  }
  if constexpr (MODE == kNee) {
    const float ts = (t_best < INFINITY) ? t_best : 1.0f;
    const float hx = ox + dx * ts;
    const float hy = oy + dy * ts;
    const float hz = oz + dz * ts;
    const float lx = p.light[0] - hx;
    const float ly = p.light[1] - hy;
    const float lz = p.light[2] - hz;
    const float len2 = lx * lx + ly * ly + lz * lz;
    const float t_light = (len2 > 0.0f) ? sqrtf(len2) : 0.0f;
    const float inv = (fabsf(t_light) > 1.0e-12f) ? 1.0f / t_light : 0.0f;
    const pbr::Ray s = pbr::make_ray(hx, hy, hz, lx * inv, ly * inv, lz * inv);
    bool occ = false;
    walk<true, SLAB>(p, s, live, t_light, nullptr, nullptr, &occ, slab);
    if (in) p.occ_out[ray] = occ ? 1 : 0;
  }
}

template <int MODE, bool SLAB>
void launch(const Params& p, cudaStream_t s) {
  const dim3 grid((p.n + kThreads - 1) / kThreads);
  const size_t smem = SLAB ? sizeof(float) * kWarps * 9 * p.max_leaf : 0;
  packet_kernel<MODE, SLAB><<<grid, kThreads, smem, s>>>(p);
}

}  // namespace

// C entry point, bound with ctypes (ops/cuda_bvh.py). Pointers are device
// pointers (null where the mode reads or writes nothing). mode: 0 nearest,
// 1 nearest + NEE, 2 any-hit, 3 seeded nearest, 4 seeded any-hit; slab 1
// runs K7 (modes 0 and 1 only, 1 <= max_leaf <= 256), 0 runs K6. Launches
// on `stream` without synchronising and returns cudaGetLastError() of the
// launch (cudaErrorInvalidValue for arguments it does not take).
extern "C" int pbr_bvh_packet(int mode, int slab, const float* ox, const float* oy,
                              const float* oz, const float* dx, const float* dy,
                              const float* dz, const int* order, const unsigned char* alive,
                              int n, const float* bmin, const float* bmax,
                              const int* leaf_first, const int* leaf_count, const int* exit_,
                              int n_nodes, const float* faces, int stride, int face_base,
                              int max_leaf, const float* light, const float* t_limit,
                              const float* t_seed, const int* f_seed,
                              const unsigned char* occ_seed, float* t_out, int* f_out,
                              unsigned char* occ_out, void* stream) {
  if (mode < kNearest || mode > kSeededAnyHit || max_leaf < 1 ||
      (slab && (mode > kNee || max_leaf > kSlabMaxLeaf))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const Params p{ox,       oy,    oz,     dx,     dy,       dz,
                 order,    alive, n,      {bmin, bmax, leaf_first, leaf_count, exit_, n_nodes},
                 faces,    stride, face_base, max_leaf, light, t_limit,
                 t_seed,   f_seed, occ_seed, t_out, f_out, occ_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab) {
    if (mode == kNee) launch<kNee, true>(p, s); else launch<kNearest, true>(p, s);
  } else {
    switch (mode) {
      case kNearest: launch<kNearest, false>(p, s); break;
      case kNee: launch<kNee, false>(p, s); break;
      case kAnyHit: launch<kAnyHit, false>(p, s); break;
      case kSeeded: launch<kSeeded, false>(p, s); break;
      default: launch<kSeededAnyHit, false>(p, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
