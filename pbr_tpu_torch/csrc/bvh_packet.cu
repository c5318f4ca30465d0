// Packet BVH walks for Hopper (sm_90a): kernel K6 (five instances) and the
// leaf-slab walk K7 (two instances).
//
// K6 replaces pbr_tpu/ops/pallas_bvh.py::_kernel (nearest), ::_kernel_nee
// (nearest + fused NEE shadow any-hit), ::_kernel_shadow (any-hit against
// t_limit), ::_kernel_seeded (nearest from a running best) and
// ::_kernel_shadow_seeded (any-hit from a running occlusion mask), all
// around ::_traverse_tile; the seeded pair carries the forest's chain over
// its sub-trees (ops/cuda_bvh.py::intersect_bvh_forest). K7 replaces
// ::_kernel_hbm and ::_kernel_hbm_nee around ::_traverse_tile_hbm. Both
// compute what those kernels compute:
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
//     |t_light| > 1e-12 ? 1/t_light : 0), then walked any-hit, but only by
//     the lanes whose nearest walk hit: the bit of a lane that missed is
//     false without a walk. The integrator reads the bit only where the
//     nearest walk hit (models/integrator.py: casts = hit & alive & ...),
//     and there it is the TPU kernel's.
// A ray's results do not depend on its packet: a node's box holds its
// children's, so a ray that hits a node hit every node above it with a
// larger t_best, and the packet visits every node the ray's own walk
// visits, in the same order. That is why the plain version
// (ops/cuda_bvh.py::walk_plain) walks each ray alone and still agrees
// bitwise.
//
// The cursor belongs to a warp (on the TPU, to a tile of 1,024 rays). Each
// lane holds one ray; every lane of the warp, the padding lanes past n and
// the dead lanes included, takes part in the vote on the full mask, voting
// false when it is not live, so the cursor is uniform and no lane leaves
// the loop early. Rays come in the order the wrapper sorts them by
// (octant, Morton code of the origin in the root box), so the 32 rays of a
// warp are coherent.
//
// K6 keeps its first design: the nodes (SoA tables) and the leaf faces are
// read from global memory through the read-only cache, every lane the
// same node, and each lane that hits a leaf tests its faces one after
// another.
//
// K7, the slab walk (soup:100000: 4,523 nodes, 64-face leaves), is built
// for what bounds it here: operations, ~25 a node step and ~51 a face test,
// over a walk that is the union of the warp's 32 walks, so a warp that
// tests a leaf's faces one after another on the lanes that hit it idles
// the others (on a frame's second bounce 7 of 32 lanes hit a leaf the warp
// tests). tools/k7_walk.py measures its warps; PERF.md has each design
// step, those that lost included. Its design:
//   - packed records (ops/cuda_bvh.py::node_records, face_records, built
//     once a scene): a node step is two 16-byte broadcast loads, {bb_min,
//     exit} and {bb_max, leaf word}, a face three, {v0}, {e1}, {e2}; the
//     same floats, so the same operations;
//   - at a leaf that some lane hits, the warp stages its faces into
//     shared memory (3 x count 16-byte loads, no division);
//   - when at most kDealMax lanes hit it, the warp deals the leaf's
//     (hitting ray, face) pairs over all 32 lanes: pair p = (ray p / count,
//     face p % count), lane l taking p = l, l + 32, ... The hitting lanes'
//     rays, bounds and running results live in shared memory; a lane whose
//     test is valid and beats the ray's bound at the leaf's entry merges it
//     by a shared 64-bit atomicMin on a key whose unsigned order is the
//     (t, face) order (key.cuh; any-hit: a store of 1). The minimum does not depend
//     on the order of the merges, so the answer is the sequential one: the
//     leaf's first face of least t that beats the entry bound, exactly as
//     the strict '<' in face order. With more lanes hitting, a dealt pair
//     (rays and results through shared memory) costs more than the idle
//     lanes it saves, and each hitting lane tests the faces itself;
//   - the shadow leg only on the lanes that need it (above);
//   - one warp a block, at most 64 registers: 32 blocks an SM (the most it
//     takes), and a warp that ends frees its slot without waiting for a
//     slower warp of its block;
//   - it copies nothing at a node no ray hits: the TPU kernel's "copy a
//     slab at every step" was a Mosaic control-flow workaround.
//
// Numerics: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false,
// no --use_fast_math (default IEEE division and sqrt), as K1-K4: every
// operation rounds as the plain torch version does.

#include <cuda_runtime.h>
#include <math.h>

#include "bvh.cuh"
#include "key.cuh"
#include "mt.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlabThreads = 32;  // K7's block: one warp
constexpr int kSlabMinBlocks = 32;  // K7's blocks an SM (the most it takes): at most 64 registers
// K7 deals a leaf's tests over the warp when at most this many lanes hit it;
// with more, each hitting lane tests the faces itself.
constexpr int kDealMax = 16;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kSlabMaxLeaf = 256;  // ops/cuda_bvh.py::SLAB_MAX_LEAF
// A leaf's record word: first face << kCountBits | (face count - 1); -1 for
// an inner node (ops/cuda_bvh.py::node_records).
constexpr int kCountBits = 8;

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

// K7's inputs: the rays as K6's, the tree and its faces as packed records.
struct SlabParams {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const int* order;
  const unsigned char* alive;
  int n;
  const float4* nodes;  // (n_nodes, 2) node records
  int n_nodes;
  const float4* faces;  // (F, 3) face records
  int max_leaf;
  const float* light;  // (3,) light 0 (kNee)
  float* t_out;
  int* f_out;
  unsigned char* occ_out;
};

// The shadow ray of a lane's nearest result (the guarded math of the
// header); returns t_light.
__device__ __forceinline__ float shadow_ray(const float* light, float ox, float oy, float oz,
                                            float dx, float dy, float dz, float t_best,
                                            pbr::Ray* s) {
  const float ts = (t_best < INFINITY) ? t_best : 1.0f;
  const float hx = ox + dx * ts;
  const float hy = oy + dy * ts;
  const float hz = oz + dz * ts;
  const float lx = light[0] - hx;
  const float ly = light[1] - hy;
  const float lz = light[2] - hz;
  const float len2 = lx * lx + ly * ly + lz * lz;
  const float t_light = (len2 > 0.0f) ? sqrtf(len2) : 0.0f;
  const float inv = (fabsf(t_light) > 1.0e-12f) ? 1.0f / t_light : 0.0f;
  *s = pbr::make_ray(hx, hy, hz, lx * inv, ly * inv, lz * inv);
  return t_light;
}

// ------------------------------------------------------------------ K6 --

// The warp's walk of one tree. Nearest (ANY false): updates *t_best /
// *f_best. Any-hit: sets *occ. Every lane of the warp calls it together.
template <bool ANY>
__device__ void walk(const Params& p, const pbr::Ray& r, bool live, float t_limit,
                     float* t_best, int* f_best, bool* occ) {
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
    const int first = __ldg(p.tree.leaf_first + i);
    if (first >= 0 && hit) {
      const int cnt = min(__ldg(p.tree.leaf_count + i), p.max_leaf);
      for (int k = 0; k < cnt; ++k) {
        float t;
        const bool valid = pbr::moller_trumbore(pbr::load_face(p.faces, p.stride, first + k),
                                                r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, &t);
        if constexpr (ANY) {
          if (valid && t < t_limit) {
            *occ = true;
            break;
          }
        } else if (valid && t < *t_best) {
          *t_best = t;
          *f_best = p.face_base + first + k;
        }
      }
    }
    ++i;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) packet_kernel(const Params p) {
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
    walk<true>(p, r, live, t_limit, nullptr, nullptr, &occ);
    if (in) p.occ_out[ray] = occ ? 1 : 0;
    return;
  }

  float t_best = INFINITY;
  int f_best = -1;
  if (MODE == kSeeded && in) {
    t_best = p.t_seed[ray];
    f_best = p.f_seed[ray];
  }
  walk<false>(p, r, live, 0.0f, &t_best, &f_best, nullptr);
  if (in) {
    p.t_out[ray] = t_best;
    p.f_out[ray] = f_best;
  }
  if constexpr (MODE == kNee) {
    pbr::Ray s;
    const float t_light = shadow_ray(p.light, ox, oy, oz, dx, dy, dz, t_best, &s);
    bool occ = false;
    walk<true>(p, s, live && t_best < INFINITY, t_light, nullptr, nullptr, &occ);
    if (in) p.occ_out[ray] = occ ? 1 : 0;
  }
}

// ------------------------------------------------------------------ K7 --

// K7's shared memory (its block is one warp), followed by the staged faces
// (3 x max_leaf float4): each lane's ray, and for the lanes that hit the leaf at
// hand their bound at its entry, their running result and their list.
struct WarpSlab {
  float ray[6][32];              // o, d
  float bound[32];               // t_best (nearest) or t_limit (any-hit)
  unsigned long long key[32];    // nearest: the (t, face) key; any-hit: 1 once occluded
  int list[32];                  // the hitting lanes, ascending
};

constexpr int kWarpSlabBytes = static_cast<int>(sizeof(WarpSlab));
static_assert(kWarpSlabBytes % 16 == 0, "the staged faces follow 16-byte aligned");
static_assert(kWarpSlabBytes + 3 * 16 * kSlabMaxLeaf <= 48 * 1024,
              "K7's dynamic shared memory stays within the default 48 KB");

__device__ __forceinline__ pbr::Face slab_face(const float4* slab, int k) {
  const float4 a = slab[3 * k], b = slab[3 * k + 1], c = slab[3 * k + 2];
  return pbr::Face{a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
}

// The staged leaf's (hitting ray, face) pairs dealt over the warp: `h`
// rays listed in w.list, `cnt` faces, ids from `base`.
template <bool ANY>
__device__ __forceinline__ void leaf_tests(WarpSlab& w, const float4* slab, int h, int cnt,
                                           int base, int lane) {
  int s = 0, k = lane;  // pair s * cnt + k = lane, then every 32nd
  while (k >= cnt) {
    k -= cnt;
    ++s;
  }
  while (s < h) {
    const int rl = w.list[s];
    float t;
    const bool valid = pbr::moller_trumbore(slab_face(slab, k), w.ray[0][rl], w.ray[1][rl],
                                            w.ray[2][rl], w.ray[3][rl], w.ray[4][rl],
                                            w.ray[5][rl], &t);
    if (valid && t < w.bound[rl]) {
      if constexpr (ANY) {
        w.key[rl] = 1;
      } else {
        atomicMin(&w.key[rl], pbr::pack_key(t, base + k));
      }
    }
    k += 32;
    while (k >= cnt) {
      k -= cnt;
      ++s;
    }
  }
}

// The staged leaf's faces in order for the lane's own ray (strict '<', the
// first face wins ties; any-hit: up to the first occluder).
template <bool ANY>
__device__ __forceinline__ void own_tests(const float4* slab, int cnt, int first,
                                          const pbr::Ray& r, float t_limit, float* t_best,
                                          int* f_best, bool* occ) {
  for (int k = 0; k < cnt; ++k) {
    float t;
    const bool valid = pbr::moller_trumbore(slab_face(slab, k), r.ox, r.oy, r.oz, r.dx, r.dy,
                                            r.dz, &t);
    if constexpr (ANY) {
      if (valid && t < t_limit) {
        *occ = true;
        break;
      }
    } else if (valid && t < *t_best) {
      *t_best = t;
      *f_best = first + k;
    }
  }
}

// The warp's slab walk of the tree, as K6's walk; `w` and `slab` are its
// block's shared memory. Every lane of the warp calls it together.
template <bool ANY>
__device__ void slab_walk(const SlabParams& p, const pbr::Ray& r, bool live, float t_limit,
                          float* t_best, int* f_best, bool* occ, WarpSlab& w, float4* slab) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  __syncwarp();  // the previous walk no longer reads the rays
  w.ray[0][lane] = r.ox;
  w.ray[1][lane] = r.oy;
  w.ray[2][lane] = r.oz;
  w.ray[3][lane] = r.dx;
  w.ray[4][lane] = r.dy;
  w.ray[5][lane] = r.dz;
  int i = 0;
  while (i < p.n_nodes) {
    if constexpr (ANY) {
      if (__all_sync(kAll, *occ || !live)) break;
    }
    const float4 lo = __ldg(p.nodes + 2 * i), hi = __ldg(p.nodes + 2 * i + 1);
    float t_near;
    bool hit = pbr::box_hit(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, r, &t_near) && live;
    if constexpr (ANY) {
      hit = hit && !*occ && t_limit > t_near;
    } else {
      hit = hit && *t_best > t_near;
    }
    const unsigned m = __ballot_sync(kAll, hit);
    if (m == 0) {
      i = __float_as_int(lo.w);
      continue;
    }
    const int lf = __float_as_int(hi.w);
    if (lf >= 0) {
      const int first = lf >> kCountBits;
      const int cnt = min((lf & ((1 << kCountBits) - 1)) + 1, p.max_leaf);
      const int h = __popc(m);
      const bool deal = h <= kDealMax;
      __syncwarp();  // every lane is done with the previous slab
      const float4* src = p.faces + 3 * first;
      for (int j = lane; j < 3 * cnt; j += 32) slab[j] = __ldg(src + j);
      if (deal && hit) {
        w.list[__popc(m & below)] = lane;
        if constexpr (ANY) {
          w.bound[lane] = t_limit;
          w.key[lane] = 0;
        } else {
          w.bound[lane] = *t_best;
          w.key[lane] = pbr::pack_key(*t_best, *f_best);
        }
      }
      __syncwarp();
      if (!deal) {
        if (hit) own_tests<ANY>(slab, cnt, first, r, t_limit, t_best, f_best, occ);
      } else {
        leaf_tests<ANY>(w, slab, h, cnt, first, lane);
        __syncwarp();
        if (hit) {
          if constexpr (ANY) {
            *occ = w.key[lane] != 0;
          } else {
            *t_best = pbr::key_t(w.key[lane]);
            *f_best = pbr::key_face(w.key[lane]);
          }
        }
      }
    }
    ++i;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kSlabThreads, kSlabMinBlocks) slab_kernel(const SlabParams p) {
  extern __shared__ float4 smem4[];
  WarpSlab& w = *reinterpret_cast<WarpSlab*>(smem4);
  float4* slab = smem4 + kWarpSlabBytes / 16;
  const int g = blockIdx.x * kSlabThreads + threadIdx.x;
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
  float t_best = INFINITY;
  int f_best = -1;
  slab_walk<false>(p, r, live, 0.0f, &t_best, &f_best, nullptr, w, slab);
  if (in) {
    p.t_out[ray] = t_best;
    p.f_out[ray] = f_best;
  }
  if constexpr (MODE == kNee) {
    pbr::Ray s;
    const float t_light = shadow_ray(p.light, ox, oy, oz, dx, dy, dz, t_best, &s);
    const bool casts = live && t_best < INFINITY;
    bool occ = false;
    slab_walk<true>(p, s, casts, t_light, nullptr, nullptr, &occ, w, slab);
    if (in) p.occ_out[ray] = occ ? 1 : 0;
  }
}

template <int MODE>
void launch(const Params& p, cudaStream_t s) {
  const dim3 grid((p.n + kThreads - 1) / kThreads);
  packet_kernel<MODE><<<grid, kThreads, 0, s>>>(p);
}

template <int MODE>
void launch_slab(const SlabParams& p, cudaStream_t s) {
  const size_t smem = kWarpSlabBytes + 3 * 16 * p.max_leaf;
  const dim3 grid((p.n + kSlabThreads - 1) / kSlabThreads);
  slab_kernel<MODE><<<grid, kSlabThreads, smem, s>>>(p);
}

}  // namespace

// C entry points, bound with ctypes (ops/cuda_bvh.py). Pointers are device
// pointers (null where the mode reads or writes nothing). Each launches on
// `stream` without synchronising and returns cudaGetLastError() of the
// launch (cudaErrorInvalidValue for arguments it does not take).
//
// K6: mode 0 nearest, 1 nearest + NEE, 2 any-hit, 3 seeded nearest, 4
// seeded any-hit; the tree as (3, n_nodes) bounds and (n_nodes,) indices,
// the faces as a (9, stride) table.
extern "C" int pbr_bvh_packet(int mode, const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              const int* order, const unsigned char* alive, int n,
                              const float* bmin, const float* bmax, const int* leaf_first,
                              const int* leaf_count, const int* exit_, int n_nodes,
                              const float* faces, int stride, int face_base, int max_leaf,
                              const float* light, const float* t_limit, const float* t_seed,
                              const int* f_seed, const unsigned char* occ_seed, float* t_out,
                              int* f_out, unsigned char* occ_out, void* stream) {
  if (mode < kNearest || mode > kSeededAnyHit || max_leaf < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const Params p{ox,       oy,    oz,     dx,     dy,       dz,
                 order,    alive, n,      {bmin, bmax, leaf_first, leaf_count, exit_, n_nodes},
                 faces,    stride, face_base, max_leaf, light, t_limit,
                 t_seed,   f_seed, occ_seed, t_out, f_out, occ_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kNearest: launch<kNearest>(p, s); break;
    case kNee: launch<kNee>(p, s); break;
    case kAnyHit: launch<kAnyHit>(p, s); break;
    case kSeeded: launch<kSeeded>(p, s); break;
    default: launch<kSeededAnyHit>(p, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: mode 0 nearest, 1 nearest + NEE; the tree's (n_nodes, 8) node
// records and (F, 12) face records (16-byte aligned); 1 <= max_leaf <= 256.
extern "C" int pbr_bvh_slab(int mode, const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const int* order, const unsigned char* alive, int n,
                            const float* node_rec, int n_nodes, const float* face_rec,
                            int max_leaf, const float* light, float* t_out, int* f_out,
                            unsigned char* occ_out, void* stream) {
  if (mode < kNearest || mode > kNee || max_leaf < 1 || max_leaf > kSlabMaxLeaf) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const SlabParams p{ox,       oy,       oz,       dx,    dy,    dz,
                     order,    alive,    n,        reinterpret_cast<const float4*>(node_rec),
                     n_nodes,  reinterpret_cast<const float4*>(face_rec), max_leaf,
                     light,    t_out,    f_out,    occ_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kNee) launch_slab<kNee>(p, s); else launch_slab<kNearest>(p, s);
  return static_cast<int>(cudaGetLastError());
}
