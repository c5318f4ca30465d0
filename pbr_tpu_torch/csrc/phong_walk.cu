// Per-ray Phong BVH walk for Hopper (sm_90a): kernel K9, nearest and any-hit.
//
// The H100 form of the JAX package's Phong walk, which is no Pallas kernel
// but an XLA while_loop: pbr_tpu/ops/phongtess.py::intersect_bvh_phongtess
// (the loop at :458 over the step at :414-452). For each ray, the
// stackless walk of bvh.cuh over a tree built on the curved-patch-inflated
// face bounds, with the ray's own node cursor: i + 1 on a hit of node i
// (slab test, t_far > EPSILON5, the empty-box guard, bound > t_near) and
// exit[i] on a miss; at a hit leaf its min(leaf_count, max_leaf) faces, each
// by phong.cuh (Moller-Trumbore for a flat face, the patch test for a curved
// one, t >= EPSILON5) against the ray's bound at the leaf's start.
//
// Two instances of one template:
//   - nearest (phong_walk_kernel<false>): the bound is the running best t;
//     the leaf's faces with t below it are merged by the least (t, face),
//     which is the ascending strict-'<' loop's winner, so the kernel is
//     bitwise its plain version, ops/phongtess.py::intersect_bvh_phongtess
//     (which tests a leaf against the best t at the leaf's start too);
//   - any-hit (phong_walk_kernel<true>), the Phong shadow leg: the bound is
//     the ray's t_limit; the ray is occluded, and ends, at its first leaf
//     holding a face with t < t_limit. The patch test returns the least root
//     in [0, bound], so for any bound at or above the nearest t it returns
//     the same t: the bit is the nearest search's t < t_limit. Plain
//     version: ops/phongtess.py::occluded_bvh_phongtess.
// A dead lane walks nothing and returns t = +inf, face -1, u = v = 0, or
// False.
//
// What bounds it on this card: operations, and how many lanes of a warp do
// them. A ray reads 28 B and writes 16 B (any-hit 1 B); a node step is ~25
// float32 operations, a flat face test 51, a curved one several hundred
// with a square root, two divisions, a float64 pow and, on the cubic's
// three-root branch, an acosf, a powf and three cosf. Run where each lane
// meets it in its own leaf, the curved test holds the warp for every
// distinct (lane, face) position with most lanes idle. What the design does
// about it:
//   - K8's while-while loop (Aila and Laine, HPG 2009): a lane steps
//     through inner nodes until it stands at a hit leaf or has ended, then
//     the warp's lanes at leaves test them together;
//   - at a leaf step, each lane tests its leaf's flat faces itself (t first,
//     u and v only below the bound); then the curved faces, one (ray,
//     face) pair a lane, every lane running the same patch test on the
//     pair's ray (its planes and bound staged in shared memory once a ray
//     and once a leaf), the results merged into each ray's slot by a
//     shared 64-bit atomicMin of packed (t, face) keys (key.cuh), the
//     tester whose key won giving u and v. The warp forms the pairs in one
//     of two ways, chosen at the step from what it sees:
//       - every lane at a leaf stands at the same leaf (__match_any_sync on
//         the leaf's first face) and the leaf's curved faces number no
//         more than the drains the deal would need (a drain per 32 pairs):
//         each lane takes its own ray's face of each step, with no queue
//         (a coherent warp);
//       - else each lane puts its curved (lane, face) pairs in the warp's
//         queue in shared memory, and the warp drains it 32 pairs at a
//         time (one lane, or lanes at different leaves, whose faces the
//         deal spreads over the warp);
//     either way a curved face is tested against its ray's bound at the
//     leaf's start and the least key wins; a step at which no lane has a
//     curved face skips both;
//   - the any-hit instance tests a leaf's flat faces first and tests no
//     curved face of a lane that a flat face already occludes;
//   - the ray's two planes and dominant axis are computed once a ray, not
//     once a face; each solve evaluates the branch it takes, not all three;
//   - a face is five 16-byte loads through the read-only cache (the Phong
//     scenes' tables stay in the 50 MB L2);
//   - the wrappers (ops/cuda_phong.py) launch the rays as given: on the
//     card's table (tools/k9_walk.py, docs/K9_ORDER_H100.json) a sort ahead
//     of the walk cost more than it saved on every kind of Phong pass.
// Built with -DPBR_K9_DIAG (tools/k9_walk.py) the kernel also counts, for a
// warp, the curved tests dealt, the drains that ran them and the leaf-face
// steps at which some lane met a curved face; the curved tests of the
// one-leaf leaf steps and the face steps that ran them (their SIMD
// efficiency, and as each lane's own loop would run every step); and the
// warp's clock cycles in node steps, flat tests and curved tests.
//
// Numerics as K1-K8 (--fmad=false, IEEE division and sqrt).

#include <cuda_runtime.h>
#include <math.h>

#include "bvh.cuh"
#include "key.cuh"
#include "phong.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// A warp's queue: a leaf-face step adds at most 32 pairs and the warp
// drains whenever 32 wait, so at most 63 wait.
constexpr int kQueue = 64;
// A leaf's record word: first face << kCountBits | (face count - 1); -1 for
// an inner node (ops/cuda_bvh.py::node_records). A queued pair is
// face << 5 | lane: faces lie below 2^23 + 2^8.
constexpr int kCountBits = 8;
constexpr unsigned long long kNoKey = ~0ull;
// Blocks an SM must hold (__launch_bounds__'s minimum): ptxas caps the
// registers at 80 for 6, 24 warps an SM, and spills some (its report:
// tools/k9_walk.py, docs/K9_ORDER_H100.json), against ~100 registers, 20
// warps and no spill uncapped. The tool builds other values and times
// them in interleaved rounds on a frame's passes: on an H100, 6 and 8
// blocks tie over a frame (8 ahead on the bounces, 6 on the camera pass
// and the shadow legs), and uncapped is slower on all but the camera pass.
#ifndef PBR_K9_MIN_BLOCKS
#define PBR_K9_MIN_BLOCKS 6
#endif

#ifdef PBR_K9_DIAG
// Curved tests dealt, drains, dealt leaf-face steps with a curved face,
// curved tests of one-leaf leaf steps, their face steps; then a warp's clock
// cycles in its node steps, its flat tests, its curved tests and in all,
// each summed over the warps.
constexpr int kDiag = 9;
__device__ unsigned long long g_diag[kDiag];
#endif

struct Params {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const int* order;            // (n,) launch order (null: identity)
  const unsigned char* alive;  // (n,) bool (null: all live)
  const float* t_limit;        // (n,) any-hit bound
  int n;
  const float4* nodes;  // (n_nodes, 2) node records
  int n_nodes;
  const float4* faces;  // (F, 5) Phong face records
  int max_leaf;
  float alpha, oma;  // float32(alpha), float32(1 - alpha)
  float *t_out, *u_out, *v_out;
  int* f_out;
  unsigned char* occ_out;
};

// A warp's shared state: each lane's ray planes and leaf-start bound, its
// curved tests' merge slot, and the queue of curved (lane, face) pairs.
struct WarpShared {
  float ray[pbr::kPhongRayWords + 1][32];  // PhongRay, then the leaf's bound
  unsigned long long key[32];  // nearest: least key; any-hit: nonzero if occluded
  float u[32], v[32];
  int queue[kQueue];
};

__device__ __forceinline__ void put_ray(WarpShared& s, int lane, const pbr::PhongRay& r) {
  const float w[pbr::kPhongRayWords] = {r.ox,  r.oy,  r.oz,  r.dx,  r.dy, r.dz,
                                        r.n1x, r.n1y, r.n1z, r.n2x, r.n2y, r.n2z,
                                        r.o1,  r.o2,  __int_as_float(r.domain)};
#pragma unroll
  for (int i = 0; i < pbr::kPhongRayWords; ++i) s.ray[i][lane] = w[i];
}

__device__ __forceinline__ pbr::PhongRay get_ray(const WarpShared& s, int a) {
  pbr::PhongRay r;
  r.ox = s.ray[0][a]; r.oy = s.ray[1][a]; r.oz = s.ray[2][a];
  r.dx = s.ray[3][a]; r.dy = s.ray[4][a]; r.dz = s.ray[5][a];
  r.n1x = s.ray[6][a]; r.n1y = s.ray[7][a]; r.n1z = s.ray[8][a];
  r.n2x = s.ray[9][a]; r.n2y = s.ray[10][a]; r.n2z = s.ray[11][a];
  r.o1 = s.ray[12][a]; r.o2 = s.ray[13][a];
  r.domain = __float_as_int(s.ray[14][a]);
  return r;
}

__device__ __forceinline__ bool is_flat(const float4* faces, int f) {
  return __ldg(faces + pbr::kPhongWords * f + 4).z > 0.5f;
}

// Flat face f against ray r: its t where it lies in [EPSILON5, bound] and
// the face is hit (u and v only there), else +inf (phong_face_hit_within).
__device__ __forceinline__ float flat_t(const float4* faces, int f, const pbr::Ray& r,
                                        float bound) {
  const float4* rec = faces + pbr::kPhongWords * f;
  const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
  const pbr::Face fc{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
  const pbr::MtParts m = pbr::mt_t(fc, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
  const float inv = 1.0f / m.det;
  const float t = m.tnum * inv;
  const bool hit = t >= pbr::kMtEps5 && t <= bound && pbr::mt_uv(m, r.dx, r.dy, r.dz, inv);
  return hit ? t : INFINITY;
}

// Curved face f against lane a's ray staged in s, with the bound given.
__device__ __forceinline__ pbr::PatchHit curved_hit(const Params& p, const WarpShared& s, int a,
                                                    int f, float bound) {
  const float4* rec = p.faces + pbr::kPhongWords * f;
  return pbr::phong_face_hit(pbr::phong_face(__ldg(rec), __ldg(rec + 1), __ldg(rec + 2),
                                             __ldg(rec + 3), __ldg(rec + 4)),
                             get_ray(s, a), p.alpha, p.oma, bound);
}

// A pair a lane (face << 5 | owner, or -1 for none): the patch test on the
// owner's ray against its leaf-start bound, merged into the owner's slot.
// Every lane of the warp calls it.
template <bool kAnyHit>
__device__ __forceinline__ void take(const Params& p, WarpShared& s, int pair) {
  const int owner = pair & 31;
  const int face = pair >> 5;
  unsigned long long key = kNoKey;
  pbr::PatchHit h{INFINITY, 0.0f, 0.0f};
  if (pair >= 0) {
    const float bound = s.ray[pbr::kPhongRayWords][owner];
    h = curved_hit(p, s, owner, face, bound);
    if (h.t < bound) {
      if (kAnyHit) {
        s.key[owner] = 1;
      } else {
        key = pbr::pack_key(h.t, face);
        atomicMin(&s.key[owner], key);
      }
    }
  }
  if (!kAnyHit) {
    __syncwarp();
    if (key != kNoKey && s.key[owner] == key) {
      s.u[owner] = h.u;
      s.v[owner] = h.v;
    }
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, PBR_K9_MIN_BLOCKS) phong_walk_kernel(const Params p) {
  __shared__ WarpShared warps[kWarps];
  const int lane = threadIdx.x & 31;
  WarpShared& s = warps[threadIdx.x >> 5];
  const unsigned below = (1u << lane) - 1u;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int ray = g >= p.n ? -1 : p.order != nullptr ? p.order[g] : g;
  const bool live = ray >= 0 && (p.alive == nullptr || p.alive[ray] != 0);
  // nearest: the running best t; any-hit: t_limit
  float bound = INFINITY, u_best = 0.0f, v_best = 0.0f;
  int f_best = -1;
  bool occluded = false;
  pbr::Ray r{};
  if (live) {
    r = pbr::make_ray(p.ox[ray], p.oy[ray], p.oz[ray], p.dx[ray], p.dy[ray], p.dz[ray]);
    put_ray(s, lane, pbr::phong_ray(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz));
    if (kAnyHit) bound = p.t_limit[ray];
  }
  int i = live ? 0 : p.n_nodes;
#ifdef PBR_K9_DIAG
  unsigned long long cycles[3] = {0, 0, 0};
  const long long c_start = clock64();
  long long c_mark = c_start;
#define PBR_K9_TICK(j)                 \
  do {                                 \
    const long long c_ = clock64();    \
    cycles[j] += c_ - c_mark;          \
    c_mark = c_;                       \
  } while (0)
#else
#define PBR_K9_TICK(j) \
  do {                 \
  } while (0)
#endif
  while (true) {
    // Node steps up to the next hit leaf, or to the end of the walk.
    int first = -1, count = 0;
    while (i < p.n_nodes) {
      const float4 a = __ldg(p.nodes + 2 * i), b = __ldg(p.nodes + 2 * i + 1);
      float t_near;
      const bool hit =
          pbr::box_hit(a.x, a.y, a.z, b.x, b.y, b.z, r, &t_near) && bound > t_near;
      const int leaf = __float_as_int(b.w);
      if (hit && leaf >= 0) {
        first = leaf >> kCountBits;
        count = (leaf & ((1 << kCountBits) - 1)) + 1;
        break;
      }
      i = hit ? i + 1 : __float_as_int(a.w);
    }
    const bool at_leaf = first >= 0;
    const bool any_leaf = __any_sync(kFull, at_leaf);
    PBR_K9_TICK(0);
    if (!any_leaf) break;  // every lane's walk has ended
    const int cnt = at_leaf ? min(count, p.max_leaf) : 0;
    // The flat faces, each lane its own: the first of the least t below
    // the leaf-start bound (any-hit: up to the first below t_limit).
    float t_flat = bound;
    int f_flat = -1, n_curved = 0;
    for (int k = 0; k < cnt && !(kAnyHit && occluded); ++k) {
      if (!is_flat(p.faces, first + k)) {
        ++n_curved;
        continue;
      }
      const float t = flat_t(p.faces, first + k, r, bound);
      if (t < t_flat) {
        t_flat = t;
        f_flat = first + k;
        if (kAnyHit) occluded = true;
      }
    }
    // The curved faces, where some lane has one to test, each against its
    // ray's leaf-start bound and merged into the ray's slot (take). Where
    // every lane at a leaf stands at the same leaf and its own loop takes
    // no more steps than the deal would take drains, each lane takes its
    // own face of each step; else the pairs are queued and dealt 32 at a
    // time. kc: the least key of the leaf's curved faces below its start
    // bound (any-hit: nonzero if one occludes).
    unsigned long long kc = kAnyHit ? 0ull : kNoKey;  // the slot's empty value
    const int mine = kAnyHit && occluded ? 0 : n_curved;
    const int most = __reduce_max_sync(kFull, mine);
    PBR_K9_TICK(1);
    if (most > 0) {
      const unsigned at = __ballot_sync(kFull, at_leaf);
      const unsigned same = __match_any_sync(kFull, first);
      const int pairs = __reduce_add_sync(kFull, mine);
      const bool own = __all_sync(kFull, !at_leaf || same == at) && (pairs + 31) / 32 >= most;
      const int steps = __reduce_max_sync(kFull, cnt);
      s.ray[pbr::kPhongRayWords][lane] = bound;
      s.key[lane] = kc;
      int queued = 0, k = 0;
#ifdef PBR_K9_DIAG
      unsigned long long tests = 0, busy = 0, runs = 0;
#endif
      __syncwarp();  // the leaf's bounds and slots are set
      while (true) {
        int pair = -1;
        if (own) {  // face k of the leaf, each lane its own ray
          if (k == steps) break;
          const bool curved =
              k < cnt && !(kAnyHit && occluded) && !is_flat(p.faces, first + k);
          const unsigned m = __ballot_sync(kFull, curved);
          if (curved) pair = ((first + k) << 5) | lane;
          ++k;
          if (m == 0u) continue;
#ifdef PBR_K9_DIAG
          tests += __popc(m);
#endif
        } else {  // queue the steps' pairs until 32 wait, then drain 32
          for (; k < steps && queued < 32; ++k) {
            const bool curved =
                k < cnt && !(kAnyHit && occluded) && !is_flat(p.faces, first + k);
            const unsigned m = __ballot_sync(kFull, curved);
            if (curved) s.queue[queued + __popc(m & below)] = ((first + k) << 5) | lane;
            queued += __popc(m);
#ifdef PBR_K9_DIAG
            tests += __popc(m);
            busy += m != 0u;
#endif
          }
          if (queued == 0) break;
          const int n = min(queued, 32);
          queued -= n;
          __syncwarp();  // the pushes are in the queue
          if (lane < n) pair = s.queue[queued + lane];
          __syncwarp();  // the queue slots read are free for the next pushes
        }
#ifdef PBR_K9_DIAG
        ++runs;
#endif
        take<kAnyHit>(p, s, pair);
      }
#ifdef PBR_K9_DIAG
      if (lane == 0) {
        const int at0 = own ? 3 : 0;  // one-leaf steps: [3], [4]; dealt: [0], [1], [2]
        atomicAdd(&g_diag[at0], tests);
        atomicAdd(&g_diag[at0 + 1], runs);
        if (!own) atomicAdd(&g_diag[2], busy);
      }
#endif
      __syncwarp();  // the drains' merges are in the slots
      kc = s.key[lane];
      if (!kAnyHit && kc != kNoKey) {
        u_best = s.u[lane];
        v_best = s.v[lane];
      }
      __syncwarp();  // the slots are read before the next leaf rewrites them
    }
    PBR_K9_TICK(2);
    if (kAnyHit) {
      occluded = occluded || kc != 0ull;
      if (occluded) i = p.n_nodes;
    } else if (kc != kNoKey && (f_flat < 0 || kc < pbr::pack_key(t_flat, f_flat))) {
      // The leaf's winner, the least (t, face) of its flat and curved faces
      // below the leaf-start bound, is curved (its u and v read above).
      bound = pbr::key_t(kc);
      f_best = pbr::key_face(kc);
    } else if (f_flat >= 0) {
      bound = t_flat;
      f_best = f_flat;
      u_best = 0.0f;
      v_best = 0.0f;
    }
    if (at_leaf && i < p.n_nodes) ++i;
  }
#ifdef PBR_K9_DIAG
  if (lane == 0) {
    for (int j = 0; j < 3; ++j) atomicAdd(&g_diag[5 + j], cycles[j]);
    atomicAdd(&g_diag[8], static_cast<unsigned long long>(clock64() - c_start));
  }
#endif
#undef PBR_K9_TICK
  if (ray >= 0) {
    if (kAnyHit) {
      p.occ_out[ray] = live && occluded;
    } else {
      p.t_out[ray] = bound;
      p.f_out[ray] = f_best;
      p.u_out[ray] = u_best;
      p.v_out[ray] = v_best;
    }
  }
}

}  // namespace

// C entry point, bound with ctypes (ops/cuda_phong.py). Pointers are device
// pointers; nodes and faces are the (n_nodes, 8) node records and the
// (F, 20) Phong face records. A null t_limit launches the nearest instance
// (t_out, f_out, u_out and v_out its outputs), a t_limit the any-hit one
// (occ_out). Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for arguments it
// does not take).
extern "C" int pbr_phong_walk(const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              const int* order, const unsigned char* alive,
                              const float* t_limit, int n, const float* nodes, int n_nodes,
                              const float* faces, int max_leaf, float alpha,
                              float one_minus_alpha, float* t_out, int* f_out, float* u_out,
                              float* v_out, unsigned char* occ_out, void* stream) {
  const bool any_hit = t_limit != nullptr;
  if (max_leaf < 1 || max_leaf > (1 << kCountBits) || n < 0 ||
      (any_hit ? occ_out == nullptr
               : (t_out == nullptr || f_out == nullptr || u_out == nullptr ||
                  v_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Params p{ox,      oy,      oz, dx, dy, dz, order, alive, t_limit, n,
           reinterpret_cast<const float4*>(nodes), n_nodes,
           reinterpret_cast<const float4*>(faces), max_leaf, alpha, one_minus_alpha,
           t_out,   u_out,   v_out, f_out, occ_out};
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    phong_walk_kernel<true><<<blocks, kThreads, 0, st>>>(p);
  } else {
    phong_walk_kernel<false><<<blocks, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef PBR_K9_DIAG
// The diagnostic build's counters since the last call (g_diag's kDiag
// words), then zeroed.
extern "C" int pbr_phong_walk_diag(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_diag, sizeof(g_diag));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kDiag] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_diag, zero, sizeof(zero)));
}
#endif
