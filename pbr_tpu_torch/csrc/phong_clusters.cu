// Phong cluster search for Hopper (sm_90a): kernel K10.
//
// The H100 form of the JAX package's Phong cluster search, which is no
// Pallas kernel but an XLA while_loop: pbr_tpu/ops/phongtess.py::
// intersect_clusters_phongtess (the loop at :730; tiles_done :681, cond
// :685, body :689-728). One block a 128-ray tile of rays the wrapper has
// sorted by (octant, Morton code of the origin); the block runs the tile's
// rounds over its near-to-far cluster list (ops/cull.py::candidates_fine,
// torch ops outside the kernel, as JAX keeps it outside its loop).
//
// Each ray culls and closes on its own:
//   - first each live ray finds the last entry of the list whose cluster
//     box (the inflated bounds the lists are built from) it hits, scanning
//     the list from its end (bvh.cuh's NaN-conservative slab test with
//     t_far > EPSILON5 and the empty-box guard);
//   - at round r a ray is open while its best t lies beyond the entry bound
//     tent[r] (best t <= tent[r]: the JAX loop's tile rule, one ray at a
//     time) and r is not past its last hit entry; the tile stops when no
//     ray is open (__syncthreads_or) or its list has run out;
//   - an open ray takes part in the round only where it hits the round's
//     cluster box with an entry before its best t.
// The round's (ray, face) pairs are dealt over the block: the active rays
// are compacted into A slots (warp ballots), the cluster's faces staged in
// shared memory (80 B a face), and each slot's faces dealt over q = min(128
// / A, size) threads: thread j < A q takes slot j mod A and faces j / A,
// j / A + q, ... So the lanes of a warp test one face against consecutive
// slots (a shared-memory broadcast, and one branch where their rays
// agree), as one ray a thread does, and a round of few active rays
// still spreads over the block. Every test is bounded by the ray's best t
// at the round's start (phong.cuh: Moller-Trumbore with t first for a flat
// face, the patch test for a curved one, t >= EPSILON5). A thread merges
// its tests into a packed (t, face) key (key.cuh), whose order is the (t,
// face) lexicographic order, and a shared 64-bit atomicMin merges the keys
// into the slot, seeded with the ray's best: argmin's first-face tie rule
// and the (t, face) merge in one step. The thread whose key won writes its
// u and v to the slot; the ray's own thread takes the slot's key.
//
// What bounds it on this card: operations. A ray reads 25 B and writes
// 12 B; each patch test is several hundred float32 operations, two
// divisions, a square root, and transcendentals on the cubic's three-root
// branch. What the design does about it: a ray whose path misses a
// cluster's box costs one slab test there, not size face tests; a ray that
// has closed, or has no listed box left to enter, costs nothing and stops
// holding its tile; a round's tests keep at least half the block busy
// however few rays are active; a flat face's u and v are skipped where its
// t cannot win; the faces come once a block into shared memory.
//
// Numerics as K1-K9 (--fmad=false, IEEE division and sqrt): bitwise equal
// to the plain version, ops/phongtess.py::intersect_clusters_phongtess,
// which takes the same per-ray rules.

#include <cuda_runtime.h>
#include <math.h>

#include "bvh.cuh"
#include "key.cuh"
#include "phong.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kWarps = kTile / 32;
constexpr int kMaxSize = 128;  // faces a cluster (64 or 128, scene/build.py)
constexpr float kDead = -3.0e38f;
constexpr unsigned long long kNoKey = ~0ull;

struct Params {
  const float *ox, *oy, *oz, *dx, *dy, *dz;  // the rays in tile order
  const unsigned char* alive;                // (n,) bool (null: all live)
  const int* order;                          // (n,) output index of each ray (null: identity)
  int n;
  const float4* faces;  // (C * size, 5) Phong face records
  int size;
  const float4* boxes;  // (C, 2) cluster boxes {min.xyz, 0} {max.xyz, 0}
  const int* cand;      // (T, n_cand) cluster ids, near to far
  const int* cnt;       // (T,) valid entries
  const float* tent;    // (T, n_cand) entry bounds
  int n_cand;
  float alpha, oma;  // float32(alpha), float32(1 - alpha)
  int* f_out;
  float *u_out, *v_out;
  int* rounds_out;  // (T,) or null
};

// The round's active rays, slot-major (structure of arrays), and their
// merge slots.
struct Slots {
  float ray[pbr::kPhongRayWords + 1][kTile];  // PhongRay, then the round's bound
  unsigned long long key[kTile];
  float u[kTile], v[kTile];
  int warp_n[kWarps];
};

__device__ __forceinline__ bool cluster_box(const Params& p, int cid, const pbr::Ray& r,
                                            float* t_near) {
  const float4 lo = __ldg(p.boxes + 2 * cid), hi = __ldg(p.boxes + 2 * cid + 1);
  return pbr::box_hit(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, r, t_near);
}

__device__ __forceinline__ void put_ray(Slots& s, int a, const pbr::PhongRay& r, float bound) {
  const float w[pbr::kPhongRayWords] = {r.ox,  r.oy,  r.oz,  r.dx,  r.dy, r.dz,
                                        r.n1x, r.n1y, r.n1z, r.n2x, r.n2y, r.n2z,
                                        r.o1,  r.o2,  __int_as_float(r.domain)};
#pragma unroll
  for (int i = 0; i < pbr::kPhongRayWords; ++i) s.ray[i][a] = w[i];
  s.ray[pbr::kPhongRayWords][a] = bound;
}

__device__ __forceinline__ pbr::PhongRay get_ray(const Slots& s, int a) {
  pbr::PhongRay r;
  r.ox = s.ray[0][a]; r.oy = s.ray[1][a]; r.oz = s.ray[2][a];
  r.dx = s.ray[3][a]; r.dy = s.ray[4][a]; r.dz = s.ray[5][a];
  r.n1x = s.ray[6][a]; r.n1y = s.ray[7][a]; r.n1z = s.ray[8][a];
  r.n2x = s.ray[9][a]; r.n2y = s.ray[10][a]; r.n2z = s.ray[11][a];
  r.o1 = s.ray[12][a]; r.o2 = s.ray[13][a];
  r.domain = __float_as_int(s.ray[14][a]);
  return r;
}

// Slot a against faces k0, k0 + q, ... of the staged cluster cid: the
// least (t, face) key of its tests (kNoKey if none hit) with that test's u
// and v, merged into the slot.
__device__ __forceinline__ void run_faces(const Params& p, Slots& s, const float4* staged,
                                          int cid, int a, int k0, int q,
                                          unsigned long long* key, float* u, float* v) {
  const pbr::PhongRay r = get_ray(s, a);
  const float bound = s.ray[pbr::kPhongRayWords][a];
  unsigned long long best = kNoKey;
  float bu = 0.0f, bv = 0.0f;
  for (int k = k0; k < p.size; k += q) {
    const float4* w = staged + k * pbr::kPhongWords;
    const pbr::PatchHit h = pbr::phong_face_hit_within(
        pbr::phong_face(w[0], w[1], w[2], w[3], w[4]), r, p.alpha, p.oma, bound);
    if (h.t < INFINITY) {
      const unsigned long long kk = pbr::pack_key(h.t, cid * p.size + k);
      if (kk < best) {
        best = kk;
        bu = h.u;
        bv = h.v;
      }
    }
  }
  if (best != kNoKey) atomicMin(&s.key[a], best);
  *key = best;
  *u = bu;
  *v = bv;
}

__global__ void __launch_bounds__(kTile) phong_clusters_kernel(const Params p) {
  extern __shared__ float4 staged[];  // size * 5 words
  __shared__ Slots s;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x, warp = lane >> 5, wl = lane & 31;
  const int ray = tile * kTile + lane;
  const bool live = ray < p.n && (p.alive == nullptr || p.alive[ray] != 0);
  float t_b = live ? INFINITY : kDead, u_b = 0.0f, v_b = 0.0f;
  int f_b = -1;
  const int cnt = min(p.cnt[tile], p.n_cand);
  const size_t row = static_cast<size_t>(tile) * p.n_cand;
  pbr::Ray br{};
  pbr::PhongRay pr{};
  int last = -1;  // the last entry whose box the ray hits
  if (live) {
    br = pbr::make_ray(p.ox[ray], p.oy[ray], p.oz[ray], p.dx[ray], p.dy[ray], p.dz[ray]);
    pr = pbr::phong_ray(br.ox, br.oy, br.oz, br.dx, br.dy, br.dz);
    float tn;
    for (int r = cnt - 1; r >= 0; --r) {
      if (cluster_box(p, p.cand[row + r], br, &tn)) {
        last = r;
        break;
      }
    }
  }
  const int words = p.size * pbr::kPhongWords;
  int r = 0;
  for (; r < cnt; ++r) {
    const bool open = live && t_b > p.tent[row + r] && r <= last;
    // Also the barrier after the previous round's reads of the slots.
    if (!__syncthreads_or(open)) break;
    const int cid = p.cand[row + r];
    float tn;
    const bool act = open && cluster_box(p, cid, br, &tn) && t_b > tn;
    const unsigned ball = __ballot_sync(0xffffffffu, act);
    if (wl == 0) s.warp_n[warp] = __popc(ball);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s.warp_n[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (total == 0) continue;  // the same on every thread
    int slot = -1;
    if (act) {
      slot = base + __popc(ball & ((1u << wl) - 1u));
      put_ray(s, slot, pr, t_b);
      s.key[slot] = pbr::pack_key(t_b, f_b);
    }
    const float4* src = p.faces + static_cast<size_t>(cid) * words;
    for (int j = lane; j < words; j += kTile) staged[j] = __ldg(src + j);
    __syncthreads();
    // Slot a's faces over q threads: thread j < total * q takes slot
    // j mod total and faces j / total + q i.
    const int q = min(kTile / total, p.size);
    int a = -1;
    unsigned long long key = kNoKey;
    float uk = 0.0f, vk = 0.0f;
    if (lane < total * q) {
      a = lane % total;
      run_faces(p, s, staged, cid, a, lane / total, q, &key, &uk, &vk);
    }
    __syncthreads();
    // Keys are unique (a face is tested once a ray): one winner a slot.
    if (key != kNoKey && s.key[a] == key) {
      s.u[a] = uk;
      s.v[a] = vk;
    }
    __syncthreads();
    if (act) {
      const unsigned long long k = s.key[slot];
      if (k != pbr::pack_key(t_b, f_b)) {
        t_b = pbr::key_t(k);
        f_b = pbr::key_face(k);
        u_b = s.u[slot];
        v_b = s.v[slot];
      }
    }
  }
  if (ray < p.n) {
    const int out = p.order == nullptr ? ray : p.order[ray];
    p.f_out[out] = f_b;
    p.u_out[out] = u_b;
    p.v_out[out] = v_b;
  }
  if (lane == 0 && p.rounds_out != nullptr) p.rounds_out[tile] = r;
}

}  // namespace

// C entry point, bound with ctypes (ops/cuda_phong.py). Pointers are device
// pointers; the rays are in tile order, order (null: identity) gives each
// one's output index; faces are the (C * size, 20) Phong face records,
// boxes the (C, 8) cluster boxes; cand, cnt and tent the (T, n_cand), (T,)
// and (T, n_cand) lists of ceil(n / 128) tiles. rounds_out null: no
// per-tile rounds. Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for arguments it
// does not take).
extern "C" int pbr_phong_clusters(const float* ox, const float* oy, const float* oz,
                                  const float* dx, const float* dy, const float* dz,
                                  const unsigned char* alive, const int* order, int n,
                                  const float* faces, int size, const float* boxes,
                                  const int* cand, const int* cnt, const float* tent,
                                  int n_cand, float alpha, float one_minus_alpha, int* f_out,
                                  float* u_out, float* v_out, int* rounds_out, void* stream) {
  if (n < 0 || size < 1 || size > kMaxSize || n_cand < 1 || f_out == nullptr ||
      u_out == nullptr || v_out == nullptr || boxes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Params p{ox,    oy,    oz,   dx,
                 dy,    dz,    alive, order,
                 n,     reinterpret_cast<const float4*>(faces),
                 size,  reinterpret_cast<const float4*>(boxes),
                 cand,  cnt,   tent, n_cand,
                 alpha, one_minus_alpha,
                 f_out, u_out, v_out, rounds_out};
  const int tiles = (n + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(size) * pbr::kPhongWords * sizeof(float4);
  phong_clusters_kernel<<<tiles, kTile, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
