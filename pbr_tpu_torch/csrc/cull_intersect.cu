// Cull-and-sweep for Hopper (sm_90a): kernels K4 (slotted) and K4m (masked).
//
// K4 replaces the TPU kernel pbr_tpu/ops/pallas_cull.py::_kernel (launched by
// ::_build_call) around ::_dot_k; K4m replaces ::_kernel_masked (launched by
// ::_build_call_masked). They compute exactly what those kernels compute:
//   - the scene's faces, in memory order, are cut into C clusters of S = 64
//     or 128 faces; cluster c holds faces [c * S, (c + 1) * S). Its (16, 4S)
//     f32 coefficient block (accel/clusters.py) contracted with a ray's
//     features f = [o, d, o x d, 1, t_limit] gives det, tnum, unum and vnum
//     of the linear-form Moller-Trumbore for each of the S faces; then
//     inv = 1 / det, t = tnum * inv, u = unum * inv, v = vnum * inv, and the
//     face is valid iff t >= 1e-5, u >= 0, v >= 0 and u + v <= 1 (a padding
//     face has det 0, so t is NaN and never valid);
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
// lists or verdicts (ops/cull.py), the seeds, the NEE shadow rays and K4's
// tile order, and pads the batch to whole tiles, so every ray slot holds a
// real (maybe dead) ray.
//
// The compact linear form. Of a block's 44 entries a face in rows 0-10,
// only 19 can be nonzero (accel/clusters.py): det = d.m (rows 3-5),
// tnum = -o.m + km (rows 0-2 and row 9, whose feature is 1), unum =
// -d.w + c.e2 (rows 3-8), vnum = -d.q - c.e1 (rows 3-8). The wrapper repacks
// them once a scene (ops/cuda_cull.py::compact_table) into a (C, S, 20) f32
// table, face-major, five float4s a face. Each sum keeps ascending row
// order and leaves out only zero terms; for finite features a zero term
// c * f is +-0, and acc + (+-0) == acc up to the sign of a zero result,
// which no gate sees (a det of +-0 is never valid, a tnum of +-0 gives
// t < 1e-5, a unum or vnum of +-0 passes u >= 0 and u + v <= 1 as either
// sign). So validity and every winning t are what the 11-row sums give.
//
// What bounds it on this card: per executed (ray, face) pair, 18 multiplies,
// 15 adds, one IEEE division, three multiplies and the gates: about 49 f32
// operations (95 with the 11-row sums), against 28 B read per ray and 8 B
// written, plus 80 B of table a face per executed slot, read from L2 (the
// scene's table is 7.7 MiB at 100,000 faces). FP32 issue bounds it, at
// 33.5 T op/s without FMA (132 SMs x 128 lanes x 1.98 GHz; --fmad=false);
// the candidate lists and the early-out set how much work there is, and
// the unequal tiles how much of the card it keeps busy: on soup:100000's
// camera rays a tile runs 57 slots on average and the heaviest 782. With
// one thread a ray that tile alone outlasted the rest of the launch; with
// two the launch lasts as long as its blocks' balanced share, and issue
// bounds it (~69% of the no-FMA ceiling on an H100 at 700 W); four lose,
// one 1,024-thread block an SM idling at every barrier
// (pbr_tpu_torch/tools/k4_tiles.py measures the blocks, PERF.md has the
// numbers).
//
// K4's design, for that bound and for this card (not the TPU's block by
// block):
//   - one thread block per ray tile, K = kThreadsPerRay = 2 threads a ray:
//     thread k of a ray takes faces k, k + K, ... of each cluster, and the
//     K partial (t, face) minima are merged by shuffles on the same
//     lexicographic rule, which does not depend on the order of the merge,
//     so the answer is the same for any K. More threads a tile shorten the
//     heavy tiles, which bound the launch;
//   - K4's blocks take the tiles heaviest first (the wrapper's `order`:
//     tiles by listed slots, descending), so the longest lists start in the
//     first wave and the light tiles fill in behind them;
//   - the TPU grid's sequential slot axis is a loop inside the block, which
//     reads its own cand/cnt/tent row (the TPU's scalar prefetch). A skipped
//     slot is a branch uniform over the block;
//   - staged ahead: the block knows its whole list, so while it sweeps one
//     cluster's table in shared memory, cp.async copies the next listed
//     cluster's table (10 KB at S = 128) into the other of two buffers. A
//     slot costs one __syncthreads (the table it sweeps has landed, and no
//     thread still reads the buffer the next copy overwrites) and, with the
//     early-out, one __syncthreads_and after the sweep. The early-out
//     decides only whether the prefetched table is used;
//   - the sums are written out here in f32 without FMA contraction: not a
//     matrix unit and not TF32 (reduced-precision passes flip the t ~ 0
//     self-hit gate, pallas_cull.py:59-69, docs/PERF.md round 3). The plain
//     version (ops/cuda_cull.py::_face_test) sums in the same order.
//
// K4m (multiroom: 32 clusters of 64, 10-23 gated in a tile) spends most of
// its work on u and v that cannot matter: on the camera rays only 19% /
// 12% of its tests (nearest / any-hit) can change the result, on a frame's
// second bounce 17% / 10% (tools/k4_tiles.py --masked; PERF.md has each
// design step, those that lost included). Its design:
//   - t first: every test computes det, the IEEE 1 / det and t from the
//     face's first two float4s; the other three are read and u and v
//     computed only where 1e-5 <= t < the ray's bound (MaskBest: nearest,
//     its best t, or the next float above while the seed's face may still
//     lose a tie to a smaller id; any-hit, t_limit until occluded). Two
//     compares a face, so the incoherent bounce rays, where some lane of a
//     warp needs u and v on almost every face, lose nothing to it;
//   - exits: a lane whose bound is at most 1e-5 tests nothing more (a dead
//     lane, an occluded or seeded-1 any-hit lane), a warp none of whose
//     lanes can change skips the cluster, and the block leaves at the first
//     cluster where none of its lanes can;
//   - 128-ray blocks (two a tile), one ray a thread, the tile's gated-in
//     clusters staged ahead into shared memory with cp.async as K4's (a
//     barrier a cluster). Reading the table through L1 instead, without
//     barriers, lost by 8-12% on every ray set; one-, two- and eight-warp
//     blocks, batches of 2 or 8 faces, and the whole test on a warp's
//     dense clusters lost or tied.
//
// Numerics: built with --fmad=false, no --use_fast_math and IEEE division,
// so each operation rounds as the unfused torch ops do and the kernels
// equal their plain versions (ops/cuda_cull.py) bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kFace4 = 5;        // float4s a face of the compact table: 20 floats
constexpr int kCandMiss = 1 << 20;
constexpr float kEps5 = 1.0e-5f;
constexpr float kBigNeg = -3.0e38f;
constexpr int kTile = 256;       // rays a tile
constexpr int kThreadsPerRay = 2;  // K4's threads a ray (K4m: 1)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaskThreads = 128;   // K4m's block: 4 warps, one ray a thread, half a tile
constexpr int kMaskMinBlocks = 8;   // its blocks an SM (launch bounds): at most 64 registers
constexpr int kBatch = 4;           // faces whose t go first together
static_assert(kTile % kMaskThreads == 0, "a K4m block's rays lie in one tile");
static_assert(64 % kBatch == 0, "batches divide a cluster");

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying cluster `cid`'s S x 5 float4s into `buf` (NT threads).
template <int S, int NT>
__device__ __forceinline__ void stage_async(const float4* __restrict__ table, int cid,
                                            float4* buf) {
  const float4* src = table + static_cast<long long>(cid) * S * kFace4;
  for (int k = threadIdx.x; k < S * kFace4; k += NT) cp_async16(buf + k, src + k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One cluster for one ray, this thread's faces sub, sub + K, ...: the face
// test, then the nearest merge over the ray's K threads and into the
// running best, or the any-hit OR. f: o (0-2), d (3-5), o x d (6-8).
template <int S, bool ANY_HIT, int K>
__device__ __forceinline__ void sweep_cluster(const float4* sm4, const float* f, float tlim,
                                              int cid, int sub, float& best, int& face) {
  float tmin = inf_f();
  int fsub = 0;
  for (int j = sub; j < S; j += K) {
    float c[4 * kFace4];
#pragma unroll
    for (int q = 0; q < kFace4; ++q) {
      const float4 v = sm4[j * kFace4 + q];
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
    const float det = c[0] * f[3] + c[1] * f[4] + c[2] * f[5];
    const float tnum = c[3] * f[0] + c[4] * f[1] + c[5] * f[2] + c[6];
    const float unum = c[7] * f[3] + c[8] * f[4] + c[9] * f[5] + c[10] * f[6] + c[11] * f[7] +
                       c[12] * f[8];
    const float vnum = c[13] * f[3] + c[14] * f[4] + c[15] * f[5] + c[16] * f[6] + c[17] * f[7] +
                       c[18] * f[8];
    const float inv = 1.0f / det;
    const float t = tnum * inv;
    const float u = unum * inv;
    const float v = vnum * inv;
    const bool valid = (t >= kEps5) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
    if constexpr (ANY_HIT) {
      if (valid && t < tlim) best = 1.0f;
    } else if (valid && t < tmin) {
      tmin = t;
      fsub = j;
    }
  }
  if constexpr (ANY_HIT) {
#pragma unroll
    for (int off = K / 2; off >= 1; off >>= 1) best = fmaxf(best, __shfl_xor_sync(kFull, best, off));
  } else {
    int fid = cid * S + fsub;
#pragma unroll
    for (int off = K / 2; off >= 1; off >>= 1) {
      const float t2 = __shfl_xor_sync(kFull, tmin, off);
      const int f2 = __shfl_xor_sync(kFull, fid, off);
      if (t2 < tmin || (t2 == tmin && f2 < fid)) {
        tmin = t2;
        fid = f2;
      }
    }
    if (tmin < inf_f() && (tmin < best || (tmin == best && fid < face))) {
      best = tmin;
      face = fid;
    }
  }
}

// Sweep the clusters that `list` yields, in order, each table staged while
// the previous one is swept. list.next(l): the first slot >= l that runs
// (list.count when none); list.cluster(l): its cluster. With early_out the
// tile stops after a slot l once every ray's key is at most tent_t[l + 1].
template <int S, bool ANY_HIT, int K, class List>
__device__ __forceinline__ void sweep_list(const float4* __restrict__ table, const List& list,
                                           const float* tent_t, int early_out, const float* f,
                                           float tlim, int sub, float& best, int& face) {
  __shared__ float4 buf[2][S * kFace4];
  int l = list.next(0);
  if (l < list.count) stage_async<S, kTile * K>(table, list.cluster(l), buf[0]);
  for (int b = 0; l < list.count; b ^= 1) {
    const int cid = list.cluster(l);
    const int l_next = list.next(l + 1);
    cp_async_wait_all();
    __syncthreads();  // buf[b] has landed; no thread still reads buf[b ^ 1]
    if (l_next < list.count) stage_async<S, kTile * K>(table, list.cluster(l_next), buf[b ^ 1]);
    sweep_cluster<S, ANY_HIT, K>(buf[b], f, tlim, cid, sub, best, face);
    if (early_out) {
      const float key = ANY_HIT ? (best > 0.0f ? kBigNeg : tlim) : best;
      if (__syncthreads_and(key <= tent_t[l + 1])) break;
    }
    l = l_next;
  }
  cp_async_wait_all();  // no copy in flight when the block ends
}

struct SlotList {  // K4: the tile's candidate row, slots within cnt without the miss bit
  const int* cand;
  int count;
  __device__ int next(int l) const {
    while (l < count && cand[l] >= kCandMiss) ++l;
    return l;
  }
  __device__ int cluster(int l) const { return cand[l]; }
};

struct MaskList {  // K4m: the clusters whose verdict byte is set, ascending
  const unsigned char* bits;
  int count;
  __device__ int next(int l) const {
    while (l < count && bits[l] == 0) ++l;
    return l;
  }
  __device__ int cluster(int l) const { return l; }
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *t_limit;  // t_limit null: nearest
  const float* seed_t;
  const int* seed_f;
  float* t_out;
  int* f_out;
  int* occ_out;
};

// The ray's features, t_limit and seeds, from lane i.
template <bool ANY_HIT>
__device__ __forceinline__ void load_ray(const Rays& r, long long i, float* f, float& tlim,
                                         float& best, int& face) {
  f[0] = r.ox[i];
  f[1] = r.oy[i];
  f[2] = r.oz[i];
  f[3] = r.dx[i];
  f[4] = r.dy[i];
  f[5] = r.dz[i];
  f[6] = f[1] * f[5] - f[2] * f[4];  // c = o x d (ops/cuda_intersect.py::cross_od)
  f[7] = f[2] * f[3] - f[0] * f[5];
  f[8] = f[0] * f[4] - f[1] * f[3];
  tlim = ANY_HIT ? r.t_limit[i] : 0.0f;
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
__global__ void __launch_bounds__(kTile * kThreadsPerRay)
    slotted_kernel(Rays r, const float4* __restrict__ table, int n_clusters,
                   const int* __restrict__ cand, const int* __restrict__ cnt,
                   const float* __restrict__ tent, const int* __restrict__ order,
                   int early_out) {
  constexpr int K = kThreadsPerRay;
  const int tile = order[blockIdx.x];
  const int sub = static_cast<int>(threadIdx.x) % K;
  const long long i = static_cast<long long>(tile) * kTile + threadIdx.x / K;
  float f[9], tlim, best;
  int face;
  load_ray<ANY_HIT>(r, i, f, tlim, best, face);
  const SlotList list{cand + static_cast<long long>(tile) * n_clusters,
                      min(cnt[tile], n_clusters)};
  sweep_list<S, ANY_HIT, K>(table, list, tent + static_cast<long long>(tile) * (n_clusters + 1),
                            early_out, f, tlim, sub, best, face);
  if (sub == 0) store_ray<ANY_HIT>(r, i, best, face);
}

// ------------------------------------------------------------------ K4m --

// A ray's running result in K4m. best, face: nearest, the (t, face) so
// far; any-hit, the occlusion, 0 or 1 (a seed <= 0 is not occluded).
// bound: a test can change the result only where 1e-5 <= t < bound.
// Nearest: bound = best, or the next float above it while the seed's face
// may still lose a tie to a smaller face id (seed face > 0; faces come in
// ascending order, so after the first update no tie can win); any-hit:
// t_limit while not occluded, else -inf. A dead lane's -3e38 and a NaN
// give a bound no t passes. The lane can still change iff bound > 1e-5.
struct MaskBest {
  float best;
  int face;
  float bound;
};

template <bool ANY_HIT>
__device__ __forceinline__ MaskBest mask_best(float best, int face, float tlim) {
  if constexpr (ANY_HIT) {
    return MaskBest{best, face, best <= 0.0f ? tlim : -inf_f()};
  } else {
    return MaskBest{best, face, face > 0 ? nextafterf(best, inf_f()) : best};
  }
}

// Test (t, fid), whose u and v passed, against the running result.
template <bool ANY_HIT>
__device__ __forceinline__ void mask_update(MaskBest& m, float t, int fid) {
  if constexpr (ANY_HIT) {
    m.best = 1.0f;
    m.bound = -inf_f();
  } else if (t < m.best || (t == m.best && fid < m.face)) {
    m.best = t;
    m.face = fid;
    m.bound = t;
  }
}

// One gated-in cluster of the staged table `sec` for one ray, t first:
// kBatch faces' det, 1 / det and t from their first 7 terms (two float4s),
// then in face order u and v (the other three float4s) only where 1e-5 <=
// t < bound. In ascending face order the lexicographic update gives what
// sweep_cluster's per-cluster minimum and merge give.
template <int S, bool ANY_HIT>
__device__ __forceinline__ void sweep_t_first(const float4* sec, const float* f, int fid0,
                                              MaskBest& m) {
#pragma unroll 1
  for (int j0 = 0; j0 < S; j0 += kBatch) {
    float t[kBatch], inv[kBatch], c7[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const float4 a = sec[(j0 + k) * kFace4], b = sec[(j0 + k) * kFace4 + 1];
      const float det = a.x * f[3] + a.y * f[4] + a.z * f[5];
      const float tnum = a.w * f[0] + b.x * f[1] + b.y * f[2] + b.z;
      inv[k] = 1.0f / det;
      t[k] = tnum * inv[k];
      c7[k] = b.w;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (!(t[k] >= kEps5 && t[k] < m.bound)) continue;
      const float4* g = sec + (j0 + k) * kFace4;
      const float4 c = g[2], d = g[3], e = g[4];
      const float unum =
          c7[k] * f[3] + c.x * f[4] + c.y * f[5] + c.z * f[6] + c.w * f[7] + d.x * f[8];
      const float vnum = d.y * f[3] + d.z * f[4] + d.w * f[5] + e.x * f[6] + e.y * f[7] +
                         e.z * f[8];
      const float u = unum * inv[k];
      const float v = vnum * inv[k];
      if ((u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f)) {
        mask_update<ANY_HIT>(m, t[k], fid0 + j0 + k);
      }
    }
  }
}

template <int S, bool ANY_HIT>
__global__ void __launch_bounds__(kMaskThreads, kMaskMinBlocks)
    masked_kernel(Rays r, const float4* __restrict__ table, int n_clusters,
                  const unsigned char* __restrict__ mask) {
  const long long i = static_cast<long long>(blockIdx.x) * kMaskThreads + threadIdx.x;
  const long long tile = i / kTile;  // a block's rays lie in one tile
  float f[9], tlim, best;
  int face;
  load_ray<ANY_HIT>(r, i, f, tlim, best, face);
  MaskBest m = mask_best<ANY_HIT>(best, face, tlim);
  // The tile's gated-in clusters in ascending order, each table staged
  // ahead into shared memory; the block leaves once no lane can change.
  const MaskList list{mask + tile * n_clusters, n_clusters};
  __shared__ float4 buf[2][S * kFace4];
  int l = list.next(0);
  if (l < list.count) stage_async<S, kMaskThreads>(table, l, buf[0]);
  for (int b = 0; l < list.count; b ^= 1) {
    const int l_next = list.next(l + 1);
    cp_async_wait_all();
    // buf[b] has landed; no thread still reads buf[b ^ 1]
    if (!__syncthreads_or(m.bound > kEps5)) break;
    if (l_next < list.count) stage_async<S, kMaskThreads>(table, l_next, buf[b ^ 1]);
    if (__any_sync(kFull, m.bound > kEps5)) sweep_t_first<S, ANY_HIT>(buf[b], f, l * S, m);
    l = l_next;
  }
  cp_async_wait_all();  // no copy in flight when the block ends
  store_ray<ANY_HIT>(r, i, m.best, m.face);
}

bool shape_ok(int n_clusters, int size) { return n_clusters >= 0 && (size == 64 || size == 128); }

Rays rays_of(const float* ox, const float* oy, const float* oz, const float* dx,
             const float* dy, const float* dz, const float* t_limit, const float* seed_t,
             const int* seed_f, float* t_out, int* f_out, int* occ_out) {
  return Rays{ox, oy, oz, dx, dy, dz, t_limit, seed_t, seed_f, t_out, f_out, occ_out};
}

}  // namespace

// C entry points, bound with ctypes (ops/cuda_cull.py). Pointers are device
// pointers to n_tiles x 256 rays (a whole number of tiles), the (C, S, 20)
// f32 compact table (16-byte aligned), and the gate tables: K4 takes cand
// (n_tiles, C) int32, cnt (n_tiles,) int32, tent (n_tiles, C + 1) f32, order
// (n_tiles,) int32 (block b sweeps tile order[b]) and a flag for the
// early-out; K4m takes (n_tiles, C) verdict bytes. `t_limit` null: nearest
// mode, seeds seed_t / seed_f, outputs t_out / f_out. Otherwise any-hit
// mode: seed_t is the 0/1 occlusion seed, output occ_out. `size` is 64 or
// 128. K4 launches one 512-thread block a tile, K4m two 128-thread blocks,
// on `stream` without synchronising, and each returns cudaGetLastError()
// of the launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int pbr_cull_slotted(const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                const float* t_limit, const float* table, int n_clusters,
                                int size, int n_tiles, const int* cand, const int* cnt,
                                const float* tent, const int* order, int early_out,
                                const float* seed_t, const int* seed_f, float* t_out,
                                int* f_out, int* occ_out, void* stream) {
  if (!shape_ok(n_clusters, size)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rays r = rays_of(ox, oy, oz, dx, dy, dz, t_limit, seed_t, seed_f, t_out, f_out, occ_out);
  const float4* t4 = reinterpret_cast<const float4*>(table);
  constexpr int nt = kTile * kThreadsPerRay;
  if (size == 64 && t_limit) {
    slotted_kernel<64, true><<<n_tiles, nt, 0, s>>>(r, t4, n_clusters, cand, cnt, tent, order,
                                                    early_out);
  } else if (size == 64) {
    slotted_kernel<64, false><<<n_tiles, nt, 0, s>>>(r, t4, n_clusters, cand, cnt, tent, order,
                                                     early_out);
  } else if (t_limit) {
    slotted_kernel<128, true><<<n_tiles, nt, 0, s>>>(r, t4, n_clusters, cand, cnt, tent, order,
                                                     early_out);
  } else {
    slotted_kernel<128, false><<<n_tiles, nt, 0, s>>>(r, t4, n_clusters, cand, cnt, tent, order,
                                                      early_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pbr_cull_masked(const float* ox, const float* oy, const float* oz,
                               const float* dx, const float* dy, const float* dz,
                               const float* t_limit, const float* table, int n_clusters,
                               int size, int n_tiles, const unsigned char* mask,
                               const float* seed_t, const int* seed_f, float* t_out,
                               int* f_out, int* occ_out, void* stream) {
  if (!shape_ok(n_clusters, size)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rays r = rays_of(ox, oy, oz, dx, dy, dz, t_limit, seed_t, seed_f, t_out, f_out, occ_out);
  const float4* t4 = reinterpret_cast<const float4*>(table);
  const dim3 grid(n_tiles * (kTile / kMaskThreads));
  if (size == 64 && t_limit) {
    masked_kernel<64, true><<<grid, kMaskThreads, 0, s>>>(r, t4, n_clusters, mask);
  } else if (size == 64) {
    masked_kernel<64, false><<<grid, kMaskThreads, 0, s>>>(r, t4, n_clusters, mask);
  } else if (t_limit) {
    masked_kernel<128, true><<<grid, kMaskThreads, 0, s>>>(r, t4, n_clusters, mask);
  } else {
    masked_kernel<128, false><<<grid, kMaskThreads, 0, s>>>(r, t4, n_clusters, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
