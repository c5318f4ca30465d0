// BVH walks for Hopper (sm_90a): kernel K6 (five instances: three of
// packet_kernel, a per-ray walk, and the seeded chain's two of
// chain_kernel, a packet walk) and the leaf-slab packet walk K7 (two
// instances).
//
// K6 replaces pbr_tpu/ops/pallas_bvh.py::_kernel (nearest), ::_kernel_nee
// (nearest + fused NEE shadow any-hit), ::_kernel_shadow (any-hit against
// t_limit), ::_kernel_seeded (nearest from a running best) and
// ::_kernel_shadow_seeded (any-hit from a running occlusion mask), all
// around ::_traverse_tile; the seeded pair carries the forest's chain over
// its sub-trees (ops/cuda_bvh.py::intersect_bvh_forest), each sub-tree's
// walk seeded by the best of those before it, in ascending order. K7 replaces
// ::_kernel_hbm and ::_kernel_hbm_nee around ::_traverse_tile_hbm. All
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
// In the packet walks (the chain, K7) the cursor belongs to a warp (on the
// TPU, to a tile of 1,024 rays). Each
// lane holds one ray; every lane of the warp, the padding lanes past n and
// the dead lanes included, takes part in the vote on the full mask, voting
// false when it is not live, so the cursor is uniform and no lane leaves
// the loop early. Rays come in the order the wrapper sorts them by
// (octant, Morton code of the origin in the root box), so the 32 rays of a
// warp are coherent.
//
// K6's nearest, NEE and any-hit instances (packet_kernel; soup:10000: 11,953
// nodes, 2-face leaves; the forest's sub-tree 0: 4-face leaves) walk each
// ray alone, which gives the same answers (above). What bounds them is
// operations, ~25 a node step and ~51 a face test; the packet walk ran the
// union of its 32 rays' walks, and a warp of soup:10000's camera rays took
// 106 node steps of which a lane needed 72 (68%), on a frame's second
// bounce 296 of which it needed 73 (25%), the shadow leg 37% and 17%
// (tools/k6_walk.py; PERF.md has each design step, those that lost
// included). Their design, the per-ray walk of bvh_walk.cu (K8):
//   - packed records (node_records, face_records, as K7, K8 and the
//     chain): a node step is two 16-byte loads, a face three;
//   - a while-while loop: a lane steps through inner nodes to its next
//     hit leaf, then tests the leaf's faces, each ray in its own order of
//     nodes and faces, so its answer is the per-ray walk's;
//   - NEE's two legs in one loop: a lane whose nearest walk has ended
//     derives its shadow ray and walks on at once, gated by t_light, while
//     other lanes of its warp are still on their nearest walks, in the
//     same instructions, and the shadow rays keep the nearest walk's
//     launch order (no second sort, no second launch);
//   - 128-ray blocks, no shared memory, 40-48 registers. 64- and 256-ray
//     blocks tied; the warp cursor on the same packed records won on the
//     coherent camera rays (by 2-4% on soup:10000's, 5-28% on the forest's
//     sub-tree 0) and took 45-58% longer on every bounce 1.
//
// K6's seeded chain (chain_kernel) is the forest's walk over sub-trees
// 1..K-1 (soup:100000: 12 sub-trees of 8,192 faces, 4-face leaves) in one
// launch a pass. The TPU launched one kernel a sub-tree, each re-reading
// the rays and seeds and writing the running best; here a warp loads its
// rays, alive bits and seeds once, walks the sub-trees in ascending order
// with t_best / f_best (or occ) in registers and writes once. The walk is
// the packet walk (record_walk) over packed records (node_records, 32
// bytes a node, and face_records, 48 bytes a face, built once a scene for
// the whole forest), the same floats in the same operations. The
// forest's padding nodes (inverted boxes, exit = n) pack as inner nodes
// and still miss by the empty-box guard. The any-hit chain leaves once
// every lane of the warp is occluded or not walking, before the next
// sub-tree's root. Four-warp blocks at most 64 registers (8 blocks an SM;
// one- and two-warp blocks, and loading node i + 1 with node i, lost:
// tools/k6_chain.py, PERF.md). The order of the sub-trees stays
// ascending: a nearest-first order is not exact at equal t (a node whose
// t_near equals the running best is pruned, so a tie in an earlier
// sub-tree would be lost).
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

constexpr int kRayThreads = 128;  // K6's block: one ray a thread
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

constexpr int kChainThreads = 128;  // the chain's block: four warps
constexpr int kChainMinBlocks = 8;  // its blocks an SM: at most 64 registers

enum Mode : int { kNearest = 0, kNee = 1, kAnyHit = 2 };

// K6's inputs: the rays, the tree and its faces as packed records.
struct Params {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const int* order;            // (n,) launch order (null: identity)
  const unsigned char* alive;  // (n,) bool (null: all live)
  int n;
  const float4* nodes;  // (n_nodes, 2) node records
  int n_nodes;
  const float4* faces;  // (F, 3) face records
  int max_leaf;
  const float* light;    // (3,) light 0 (kNee)
  const float* t_limit;  // (n,) (kAnyHit)
  float* t_out;
  int* f_out;
  unsigned char* occ_out;  // (n,) bool
};

// The seeded chain's inputs: the rays as K6's, n_trees sub-trees of n_nodes
// packed node records each, their faces' records, `chunk` a sub-tree.
struct ChainParams {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const int* order;
  const unsigned char* alive;
  int n;
  const float4* nodes;  // (n_trees, n_nodes, 2) node records
  int n_nodes;
  int n_trees;
  const float4* faces;  // (n_trees * chunk, 3) face records
  int chunk;
  int face_base;  // the first sub-tree's, added to the face ids written
  int max_leaf;
  const float* t_limit;  // (n,) (any-hit)
  const float* t_seed;   // (n,) (nearest)
  const int* f_seed;
  const unsigned char* occ_seed;  // (n,) bool (any-hit)
  float* t_out;
  int* f_out;
  unsigned char* occ_out;
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

// One ray's walk of the tree, while-while (as bvh_walk.cu): the lane steps
// through inner nodes to its next hit leaf, then tests the leaf's faces.
// The nearest leg gates on the running best; with kNee, when it ends the
// lane derives its shadow ray and walks on in the same loop, gated by
// t_light, up to its first occluder, so that a lane starts its shadow walk
// while other lanes of its warp are still on their nearest walks, and both
// legs run the same instructions. kAnyHit walks the shadow leg alone.
template <int MODE>
__device__ __forceinline__ void ray_walk(const Params& p, pbr::Ray r, bool live, float gate,
                                         float* t_best, int* f_best, bool* occ, int ray) {
  bool shadow = MODE == kAnyHit;
  int i = live ? 0 : p.n_nodes;
  for (;;) {
    int first = -1, count = 0;
    while (i < p.n_nodes) {
      const float4 lo = __ldg(p.nodes + 2 * i), hi = __ldg(p.nodes + 2 * i + 1);
      float t_near;
      const bool hit = pbr::box_hit(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, r, &t_near) &&
                       gate > t_near;
      const int lf = __float_as_int(hi.w);
      if (hit && lf >= 0) {
        first = lf >> kCountBits;
        count = (lf & ((1 << kCountBits) - 1)) + 1;
        break;
      }
      i = hit ? i + 1 : __float_as_int(lo.w);
    }
    if (first >= 0) {
      // The leaf's faces in order: nearest, strict '<' against the running
      // best (the first face of the least t wins); shadow, the first face
      // below t_limit ends the walk.
      const int cnt = min(count, p.max_leaf);
      for (int k = 0; k < cnt; ++k) {
        const float4* g = p.faces + 3 * (first + k);
        const float4 a = __ldg(g), b = __ldg(g + 1), c = __ldg(g + 2);
        float t;
        if (pbr::moller_trumbore(pbr::Face{a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z}, r.ox,
                                 r.oy, r.oz, r.dx, r.dy, r.dz, &t) &&
            t < gate) {
          if (shadow) {
            *occ = true;
            break;
          }
          gate = t;
          *f_best = first + k;
        }
      }
      i = *occ ? p.n_nodes : i + 1;
      continue;
    }
    if (MODE != kNee || shadow) break;
    // The nearest leg has ended: its result, then the shadow ray.
    *t_best = gate;
    if (ray >= 0) {
      p.t_out[ray] = gate;
      p.f_out[ray] = *f_best;
    }
    pbr::Ray s;
    gate = shadow_ray(p.light, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, *t_best, &s);
    r = s;
    shadow = true;
    i = live && *t_best < INFINITY ? 0 : p.n_nodes;
  }
  if (MODE == kNearest) *t_best = gate;
}

template <int MODE>
__global__ void __launch_bounds__(kRayThreads) packet_kernel(const Params p) {
  const int g = blockIdx.x * kRayThreads + threadIdx.x;
  const bool in = g < p.n;
  const int ray = in ? (p.order != nullptr ? p.order[g] : g) : 0;
  // Lanes past the tail and dead lanes walk nothing.
  const bool live = in && (p.alive == nullptr || p.alive[ray] != 0);
  const pbr::Ray r = pbr::make_ray(in ? p.ox[ray] : 0.0f, in ? p.oy[ray] : 0.0f,
                                   in ? p.oz[ray] : 0.0f, in ? p.dx[ray] : 0.0f,
                                   in ? p.dy[ray] : 0.0f, in ? p.dz[ray] : 1.0f);
  float t_best = INFINITY;
  int f_best = -1;
  bool occ = false;
  const float gate = MODE == kAnyHit ? (in ? p.t_limit[ray] : 0.0f) : INFINITY;
  ray_walk<MODE>(p, r, live, gate, &t_best, &f_best, &occ, in ? ray : -1);
  if (in) {
    if (MODE == kNearest) {
      p.t_out[ray] = t_best;
      p.f_out[ray] = f_best;
    } else {
      p.occ_out[ray] = occ ? 1 : 0;
    }
  }
}

// The warp's walk of one sub-tree of packed records, as walk: nodes (n, 2)
// records, faces the sub-tree's face records, ids written from base.
template <bool ANY>
__device__ void record_walk(const float4* __restrict__ nodes, int n,
                            const float4* __restrict__ faces, int base, int max_leaf,
                            const pbr::Ray& r, bool live, float t_limit, float* t_best,
                            int* f_best, bool* occ) {
  int i = 0;
  while (i < n) {
    if constexpr (ANY) {
      if (__all_sync(kAll, *occ || !live)) return;
    }
    float t_near;
    const float4 lo = __ldg(nodes + 2 * i), hi = __ldg(nodes + 2 * i + 1);
    bool hit = pbr::box_hit(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, r, &t_near) && live;
    if constexpr (ANY) {
      hit = hit && !*occ && t_limit > t_near;
    } else {
      hit = hit && *t_best > t_near;
    }
    if (!__any_sync(kAll, hit)) {
      i = __float_as_int(lo.w);
      continue;
    }
    const int lf = __float_as_int(hi.w);
    if (lf >= 0 && hit) {
      const int first = lf >> kCountBits;
      const int cnt = min((lf & ((1 << kCountBits) - 1)) + 1, max_leaf);
      for (int k = 0; k < cnt; ++k) {
        const float4* g = faces + 3 * (first + k);
        const float4 a = __ldg(g), b = __ldg(g + 1), c = __ldg(g + 2);
        float t;
        const bool valid = pbr::moller_trumbore(
            pbr::Face{a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z}, r.ox, r.oy, r.oz, r.dx,
            r.dy, r.dz, &t);
        if constexpr (ANY) {
          if (valid && t < t_limit) {
            *occ = true;
            break;
          }
        } else if (valid && t < *t_best) {
          *t_best = t;
          *f_best = base + first + k;
        }
      }
    }
    ++i;
  }
}

// The seeded chain: sub-trees 0..n_trees-1 of p in ascending order, each
// seeded by the best so far, from the rays' seeds.
template <bool ANY>
__global__ void __launch_bounds__(kChainThreads, kChainMinBlocks)
    chain_kernel(const ChainParams p) {
  const int g = blockIdx.x * kChainThreads + threadIdx.x;
  const bool in = g < p.n;
  const int ray = in ? (p.order != nullptr ? p.order[g] : g) : 0;
  // Lanes past the tail and dead lanes walk with the warp and vote false.
  const bool live = in && (p.alive == nullptr || p.alive[ray] != 0);
  const pbr::Ray r = pbr::make_ray(in ? p.ox[ray] : 0.0f, in ? p.oy[ray] : 0.0f,
                                   in ? p.oz[ray] : 0.0f, in ? p.dx[ray] : 0.0f,
                                   in ? p.dy[ray] : 0.0f, in ? p.dz[ray] : 1.0f);
  const long long node_stride = 2LL * p.n_nodes, face_stride = 3LL * p.chunk;
  bool occ = false;
  float t_best = INFINITY, t_limit = 0.0f;
  int f_best = -1;
  if (in) {
    if constexpr (ANY) {
      occ = p.occ_seed[ray] != 0;
      t_limit = p.t_limit[ray];
    } else {
      t_best = p.t_seed[ray];
      f_best = p.f_seed[ray];
    }
  }
  for (int s = 0; s < p.n_trees; ++s) {
    if constexpr (ANY) {
      if (__all_sync(kAll, occ || !live)) break;
    }
    record_walk<ANY>(p.nodes + s * node_stride, p.n_nodes, p.faces + s * face_stride,
                     p.face_base + s * p.chunk, p.max_leaf, r, live, t_limit, &t_best, &f_best,
                     &occ);
  }
  if (in) {
    if constexpr (ANY) {
      p.occ_out[ray] = occ ? 1 : 0;
    } else {
      p.t_out[ray] = t_best;
      p.f_out[ray] = f_best;
    }
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
  const dim3 grid((p.n + kRayThreads - 1) / kRayThreads);
  packet_kernel<MODE><<<grid, kRayThreads, 0, s>>>(p);
}

template <bool ANY>
void launch_chain(const ChainParams& p, cudaStream_t s) {
  const dim3 grid((p.n + kChainThreads - 1) / kChainThreads);
  chain_kernel<ANY><<<grid, kChainThreads, 0, s>>>(p);
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
// K6: mode 0 nearest, 1 nearest + NEE, 2 any-hit; the tree's (n_nodes, 8)
// node records and (F, 12) face records (16-byte aligned).
extern "C" int pbr_bvh_packet(int mode, const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              const int* order, const unsigned char* alive, int n,
                              const float* node_rec, int n_nodes, const float* face_rec,
                              int max_leaf, const float* light, const float* t_limit,
                              float* t_out, int* f_out, unsigned char* occ_out, void* stream) {
  if (mode < kNearest || mode > kAnyHit || max_leaf < 1 ||
      (mode == kAnyHit ? (t_limit == nullptr || occ_out == nullptr)
                       : (t_out == nullptr || f_out == nullptr)) ||
      (mode == kNee && (light == nullptr || occ_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const Params p{ox,       oy,      oz,       dx,    dy,    dz,
                 order,    alive,   n,        reinterpret_cast<const float4*>(node_rec),
                 n_nodes,  reinterpret_cast<const float4*>(face_rec), max_leaf,
                 light,    t_limit, t_out,    f_out, occ_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kNearest: launch<kNearest>(p, s); break;
    case kNee: launch<kNee>(p, s); break;
    default: launch<kAnyHit>(p, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K6's seeded chain: any_hit 0 (seeds t_seed / f_seed, outputs t_out /
// f_out) or 1 (seeds occ_seed, t_limit, output occ_out); n_trees sub-trees
// of (n_nodes, 8) node records each, back to back, and their (n_trees *
// chunk, 12) face records (16-byte aligned), face ids written from
// face_base + i * chunk for sub-tree i.
extern "C" int pbr_bvh_chain(int any_hit, const float* ox, const float* oy, const float* oz,
                             const float* dx, const float* dy, const float* dz,
                             const int* order, const unsigned char* alive, int n,
                             const float* node_rec, int n_nodes, int n_trees,
                             const float* face_rec, int chunk, int face_base, int max_leaf,
                             const float* t_limit, const float* t_seed, const int* f_seed,
                             const unsigned char* occ_seed, float* t_out, int* f_out,
                             unsigned char* occ_out, void* stream) {
  if (max_leaf < 1 || n_trees < 1 || n_nodes < 0 || chunk < 1 ||
      (any_hit ? (t_limit == nullptr || occ_seed == nullptr || occ_out == nullptr)
               : (t_seed == nullptr || f_seed == nullptr || t_out == nullptr ||
                  f_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const ChainParams p{ox,       oy,       oz,      dx,       dy,      dz,
                      order,    alive,    n,       reinterpret_cast<const float4*>(node_rec),
                      n_nodes,  n_trees,  reinterpret_cast<const float4*>(face_rec),
                      chunk,    face_base, max_leaf, t_limit, t_seed, f_seed,
                      occ_seed, t_out,    f_out,   occ_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) launch_chain<true>(p, s); else launch_chain<false>(p, s);
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
