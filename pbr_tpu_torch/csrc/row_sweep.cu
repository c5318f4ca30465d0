// The row sweep for Hopper (sm_90a): kernels K5 (slotted) and K5m (masked).
//
// K5 replaces the TPU kernel pbr_tpu/ops/pallas_sweep.py::_kernel_rows
// (launched by ::_build_call), with ::_section, ::_row_done, ::_init_state
// and ::_finalize; K5m replaces ::_kernel_masked_rows (launched by
// ::_build_call_masked). They compute exactly what those kernels compute:
//   - the scene's faces, in memory order, are cut into CL lin clusters of
//     128 faces; lin cluster c holds faces [c * 128, (c + 1) * 128) and a
//     table of the linear form's 16 per-face constants (accel/clusters.py:
//     m, km, w, q, e1, e2; padding faces all 0, so det = 0, t = NaN, never
//     valid), which the kernels read face-major, (CL, 128, 16) f32
//     (scene/device.py builds it once a scene: SceneParams.clu_lin_fm);
//   - a ray tile is 256 rays in 8 rows of 32. A row's verdict bit says
//     whether the row's frustum may hit a lin cluster (ops/cull.py);
//   - K5, per tile and slot l in order: the slot's entry cand[t, l] holds a
//     lin cluster id (bits 0-15) and the 8 rows' bits (16-23); it runs for
//     l < cnt[t], and for each row whose bit is set and which is not done.
//     With early_out, a row is done once every ray's best t (any-hit:
//     every unoccluded ray's t_limit) is at most the next slot's entry
//     bound tent[t, l + 1], checked before the first slot against
//     tent[t, 0] and after each slot the row ran (pallas_sweep.py:142-150,
//     :171-197);
//   - K5m, per tile: every lin cluster in ascending order, each row gated by
//     its bit (words[t, c / 2] >> ((c % 2) * 8 + g)) & 1; no early-out;
//   - the face test is pallas_sweep.py::_section's: det = d . m,
//     inv = 1 / det, t = (km - o . m) * inv, u = (e2 . c - d . w) * inv,
//     v = (-(e1 . c) - d . q) * inv with c = o x d, valid iff t >= 1e-5,
//     u >= 0, v >= 0 and u + v <= 1 (mt_lin.cuh, whose operation order is
//     the same term for term);
//   - nearest mode: the (t, face)-lexicographic minimum over the seed and
//     every valid face tested, so the first face in memory order wins ties
//     whatever the order of the sweep. A dead lane's seed t = -3e38 never
//     updates;
//   - any-hit mode: occ = max(occ_seed, valid & (t < t_limit)).
// The wrapper (ops/cuda_sweep.py) sorts the rays, computes the candidate
// lists or verdict words (ops/cull.py), the seeds, the NEE shadow rays and
// K5's tile order, and pads the batch to whole tiles, so every thread holds
// a real (maybe dead) ray and every warp is full.
//
// What bounds it on this card: per executed (row, lin cluster) pair, 32
// rays x 128 faces of the linear form, about 44 f32 operations a test
// (det 5, 1 / det 1, t 7, u 12, v 13, the gates 5, the minimum 1), against
// 8 KB of lin table staged per executed slot (the table is 6.4 MB at
// 100,000 faces: L2-resident) and 28-36 B a ray. FP32 issue bounds it: the
// candidate lists, the row bits and the early-out set how much work there
// is. --fmad=false caps issue at 33.5 T op/s (132 SMs x 128 lanes x
// 1.98 GHz) against the 67 T op/s of the published peak.
//
// K5's design, for that bound and for this card (not the TPU's blocks;
// pbr_tpu_torch/tools/k5_rows.py measures its blocks, PERF.md has the
// numbers of each step):
//   - one 256-thread block per ray tile, taken heaviest first: block b
//     sweeps tile order[b] (the wrapper's row_order: listed (row, slot)
//     pairs, descending), so the longest lists start in the first wave;
//   - no warp idles while its block sweeps. The TPU's 32-ray row is not
//     one warp: the tile's rays (o, d, o x d, t_limit) and running results
//     live in shared memory, the nearest result as one 64-bit key whose
//     unsigned order is the (t, face) order. For each staged slot, warp w
//     takes faces [16 w, 16 w + 16) of every row that runs the slot, and
//     merges each ray's partial minimum by a shared atomicMin on the key
//     (any-hit: a store of 1). The lexicographic minimum does not depend on
//     the order of the merges, so the answer is the sequential one (with
//     a warp a row, 3.2 of 8 warps ran a staged slot on soup:100000's
//     camera rays);
//   - the face test computes t first, and u and v only where t can change
//     the result: t >= 1e-5 and t < t_limit on an unoccluded ray; for the
//     nearest, t below the chunk's minimum so far and at most the ray's
//     best t when its chunk began (a tie keeps the earlier face, and the
//     best only falls). Every face that can win is tested whole, in
//     mt_lin.cuh's operation order;
//   - a slot's table is one straight 8 KB copy of the face-major table
//     (two 16-byte loads and stores a thread) and a __syncthreads; after
//     the sweep a second one: every merge is in and the buffer is free.
//     Each warp then checks the early-out of the rows that ran (every warp
//     reaches the same verdicts). Staging the next slot's table with
//     cp.async into a second buffer while the block sweeps, with one
//     barrier a slot, was measured and lost: staging was 0.2-3% of a
//     block's time, and six blocks an SM hide it;
//   - the TPU grid's sequential slot axis is a loop inside the block, which
//     reads its own cand/cnt/tent row (the TPU's scalar prefetch);
//   - at most 40 registers (six blocks an SM) and the face loop unrolled by
//     four: unrolled once it takes 15% longer, by 16 it spills.
// K5m is K5's design on the masked loop: one 256-thread block a tile, the
// tile's state in shared memory, every lin cluster that some row of the
// tile gates in staged in ascending order (the whole table, up to 48 x 8
// KB, would not fit in shared memory), every warp taking faces [16 w, 16 w
// + 16) of every row whose bit is set, merged as above, t first, unrolled
// by four, six blocks an SM. It has no early-out, as the TPU kernel has
// none. With one warp a row (its first design) 7.8 of 8 rows ran a staged
// table on multiroom's camera rays: its gain is the t-first test, the
// unrolled loop and the residency, not the idle warps.
//
// Numerics: built with --fmad=false, no --use_fast_math and IEEE division,
// so each operation rounds as the unfused torch ops do and the kernels
// equal their plain versions (ops/cuda_sweep.py) bitwise.

#include <cuda_runtime.h>

#include "key.cuh"
#include "mt_lin.cuh"

namespace {

constexpr int kTile = 256;        // rays a tile: one block, one ray a thread
constexpr int kRowRays = 32;      // rays a row
constexpr int kRows = kTile / kRowRays;
constexpr int kLin = 128;         // faces a lin cluster
constexpr int kFace4 = pbr::kLinRows / 4;  // float4s a face of the face-major table
constexpr int kTable4 = kLin * kFace4;     // float4s a lin cluster's table: 8 KB
constexpr int kChunk = kLin / kRows;       // faces a warp takes of each row a slot runs
constexpr int kMinBlocks = 6;     // blocks an SM: at most 40 registers
constexpr int kMaxLin = 1 << 16;  // lin cluster ids fill bits 0-15 of an entry
constexpr float kBigNeg = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *t_limit;  // t_limit null: nearest
  const float* seed_t;
  const int* seed_f;
  float* t_out;
  int* f_out;
  int* occ_out;
};

// One thread's ray and running result.
struct Ray {
  float ox, oy, oz, dx, dy, dz, cx, cy, cz, t_limit;
  float best;  // nearest: best t; any-hit: 0/1 occlusion
  int face;
};

template <bool ANY_HIT>
__device__ __forceinline__ Ray load_ray(const Rays& r, long long i) {
  Ray y;
  y.ox = r.ox[i];
  y.oy = r.oy[i];
  y.oz = r.oz[i];
  y.dx = r.dx[i];
  y.dy = r.dy[i];
  y.dz = r.dz[i];
  pbr::cross_od(y.ox, y.oy, y.oz, y.dx, y.dy, y.dz, &y.cx, &y.cy, &y.cz);
  y.t_limit = ANY_HIT ? r.t_limit[i] : 0.0f;
  y.best = r.seed_t[i];
  y.face = ANY_HIT ? 0 : r.seed_f[i];
  return y;
}

template <bool ANY_HIT>
__device__ __forceinline__ void store_ray(const Rays& r, long long i, const Ray& y) {
  if constexpr (ANY_HIT) {
    r.occ_out[i] = y.best > 0.0f ? 1 : 0;
  } else {
    r.t_out[i] = y.best;
    r.f_out[i] = y.face;
  }
}

// Copy lin cluster `cid`'s face-major table into `buf`: 16-byte loads and
// stores, two a thread, every warp's stores on consecutive banks.
__device__ __forceinline__ void stage(const float4* __restrict__ lin4, int cid, float4* buf) {
  const float4* src = lin4 + static_cast<long long>(cid) * kTable4;
  for (int k = threadIdx.x; k < kTable4; k += kTile) buf[k] = src[k];
}

__device__ __forceinline__ pbr::LinFace face_of(const float4* sm4, int j) {
  const float4 a = sm4[kFace4 * j], b = sm4[kFace4 * j + 1], c = sm4[kFace4 * j + 2],
               e = sm4[kFace4 * j + 3];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, e.x, e.y, e.z, e.w};
}

// K5's tile in shared memory, so that any warp can sweep any row: o, d,
// o x d and t_limit a ray, column by column, and the nearest key or the 0/1
// occlusion.
struct RowState {
  float ray[10][kTile];
  unsigned long long key[kTile];
  int occ[kTile];
};

// A thread's ray and seed into the tile's shared state, and its result
// back out.
template <bool ANY_HIT>
__device__ __forceinline__ void put_state(const Ray& y, RowState& s) {
  const float v[10] = {y.ox, y.oy, y.oz, y.dx, y.dy, y.dz, y.cx, y.cy, y.cz, y.t_limit};
#pragma unroll
  for (int q = 0; q < 10; ++q) s.ray[q][threadIdx.x] = v[q];
  if constexpr (ANY_HIT) {
    s.occ[threadIdx.x] = y.best > 0.0f ? 1 : 0;
  } else {
    s.key[threadIdx.x] = pbr::pack_key(y.best, y.face);
  }
}

template <bool ANY_HIT>
__device__ __forceinline__ void take_state(const RowState& s, Ray& y) {
  if constexpr (ANY_HIT) {
    y.best = s.occ[threadIdx.x] ? 1.0f : 0.0f;
  } else {
    y.best = pbr::key_t(s.key[threadIdx.x]);
    y.face = pbr::key_face(s.key[threadIdx.x]);
  }
}

// Warp `warp`'s share of row `row`'s run of the staged lin cluster `cid`:
// faces [warp * kChunk, (warp + 1) * kChunk) for the row's 32 rays, merged
// into the shared results. t comes first, u and v only where t can change
// the result (the header says why that is exact).
template <bool ANY_HIT>
__device__ __forceinline__ void deal(const float4* sm4, int cid, int row, int warp, int lane,
                                     RowState& s) {
  const int k = row * kRowRays + lane;
  const float ox = s.ray[0][k], oy = s.ray[1][k], oz = s.ray[2][k];
  const float dx = s.ray[3][k], dy = s.ray[4][k], dz = s.ray[5][k];
  const float cx = s.ray[6][k], cy = s.ray[7][k], cz = s.ray[8][k];
  // any-hit: t_limit, and hit 1 once occluded; nearest: the ray's best t
  // when the chunk began, and the chunk's minimum (tmin, jmin)
  const float bound = ANY_HIT ? s.ray[9][k] : pbr::key_t(s.key[k]);
  bool hit = ANY_HIT && s.occ[k];
  float tmin = inf_f();
  int jmin = 0;
#pragma unroll 4
  for (int q = 0; q < kChunk; ++q) {
    const int j = warp * kChunk + q;
    const pbr::LinFace f = face_of(sm4, j);
    const float inv = 1.0f / pbr::lin_det(f, dx, dy, dz);
    const float t = pbr::lin_tnum(f, ox, oy, oz) * inv;
    const bool gate = ANY_HIT ? (!hit && t < bound) : (t < tmin && t <= bound);
    if (t >= pbr::kLinEps5 && gate && pbr::lin_uv(f, dx, dy, dz, cx, cy, cz, inv)) {
      if constexpr (ANY_HIT) {
        hit = true;
      } else {
        tmin = t;
        jmin = j;
      }
    }
  }
  if constexpr (ANY_HIT) {
    if (hit) s.occ[k] = 1;
  } else if (tmin < inf_f()) {
    atomicMin(&s.key[k], pbr::pack_key(tmin, cid * kLin + jmin));
  }
}

// _row_done: every ray of row `row` has its key at most `bound`, from the
// shared results. Called by all 32 lanes of a warp.
template <bool ANY_HIT>
__device__ __forceinline__ bool row_done(const RowState& s, int row, int lane, float bound) {
  const int k = row * kRowRays + lane;
  const float key = ANY_HIT ? (s.occ[k] ? kBigNeg : s.ray[9][k]) : pbr::key_t(s.key[k]);
  return __all_sync(kFull, key <= bound);
}

// The first slot >= l within count whose rows include one not done (count
// when none).
__device__ __forceinline__ int next_slot(const int* __restrict__ cand_t, int l, int count,
                                         unsigned done) {
  while (l < count && !((cand_t[l] >> 16) & 0xFF & ~done)) ++l;
  return l;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(kTile, kMinBlocks)
    slotted_rows_kernel(Rays r, const float4* __restrict__ lin4, int n_lin,
                        const int* __restrict__ cand, const int* __restrict__ cnt,
                        const float* __restrict__ tent, const int* __restrict__ order,
                        int early_out) {
  __shared__ float4 buf[kTable4];
  __shared__ RowState s;
  const int tile = order[blockIdx.x];
  const int warp = threadIdx.x / kRowRays, lane = threadIdx.x % kRowRays;
  const long long i = static_cast<long long>(tile) * kTile + threadIdx.x;
  Ray y = load_ray<ANY_HIT>(r, i);
  const int* cand_t = cand + static_cast<long long>(tile) * n_lin;
  const float* tent_t = tent + static_cast<long long>(tile) * (n_lin + 1);
  const int count = min(cnt[tile], n_lin);
  put_state<ANY_HIT>(y, s);
  __syncthreads();
  // The rows done, the same in every thread. Rows whose seeds already beat
  // the first entry bound skip everything.
  unsigned done = 0;
  if (early_out) {
    for (int row = 0; row < kRows; ++row) {
      if (row_done<ANY_HIT>(s, row, lane, tent_t[0])) done |= 1u << row;
    }
  }
  for (int l = next_slot(cand_t, 0, count, done); l < count;
       l = next_slot(cand_t, l + 1, count, done)) {
    const int entry = cand_t[l];
    const int cid = entry & 0xFFFF;
    const unsigned act = (entry >> 16) & 0xFF & ~done;  // the rows that run this slot
    stage(lin4, cid, buf);
    __syncthreads();  // slot l's table is staged
    for (unsigned m = act; m; m &= m - 1) deal<ANY_HIT>(buf, cid, __ffs(m) - 1, warp, lane, s);
    __syncthreads();  // slot l is swept: every merge is in, no thread still reads buf
    if (early_out) {
      const float bound = tent_t[l + 1];
      for (unsigned m = act; m; m &= m - 1) {
        const int row = __ffs(m) - 1;
        if (row_done<ANY_HIT>(s, row, lane, bound)) done |= 1u << row;
      }
    }
  }
  take_state<ANY_HIT>(s, y);
  store_ray<ANY_HIT>(r, i, y);
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(kTile, kMinBlocks)
    masked_rows_kernel(Rays r, const float4* __restrict__ lin4, int n_lin,
                       const int* __restrict__ words) {
  __shared__ float4 buf[kTable4];
  __shared__ RowState s;
  const int tile = blockIdx.x;
  const int warp = threadIdx.x / kRowRays, lane = threadIdx.x % kRowRays;
  const long long i = static_cast<long long>(tile) * kTile + threadIdx.x;
  Ray y = load_ray<ANY_HIT>(r, i);
  put_state<ANY_HIT>(y, s);
  const int* words_t = words + static_cast<long long>(tile) * ((n_lin + 1) / 2);
  for (int cid = 0; cid < n_lin; ++cid) {
    // the rows gated in; one tile a block, so uniform over the block
    const unsigned act = (words_t[cid / 2] >> ((cid % 2) * 8)) & 0xFF;
    if (act == 0) continue;
    stage(lin4, cid, buf);
    __syncthreads();  // the table is staged (the first time: and the tile's state)
    for (unsigned m = act; m; m &= m - 1) deal<ANY_HIT>(buf, cid, __ffs(m) - 1, warp, lane, s);
    __syncthreads();  // every merge is in, no thread still reads buf
  }
  take_state<ANY_HIT>(s, y);
  store_ray<ANY_HIT>(r, i, y);
}

bool shape_ok(int n_lin) { return n_lin > 0 && n_lin <= kMaxLin; }

}  // namespace

// C entry points, bound with ctypes (ops/cuda_sweep.py). Pointers are device
// pointers to n_tiles x 256 rays (a whole number of tiles), the face-major
// (n_lin, 128, 16) f32 lin tables (16-byte aligned), and the gate tables:
// K5 takes cand (n_tiles, n_lin) int32, cnt (n_tiles,) int32, tent
// (n_tiles, n_lin + 1) f32, order (n_tiles,) int32 (block b sweeps tile
// order[b]) and a flag for the early-out; K5m takes the (n_tiles,
// ceil(n_lin / 2)) int32 verdict
// words. `t_limit` null: nearest mode, seeds seed_t / seed_f, outputs t_out
// / f_out. Otherwise any-hit mode: seed_t is the 0/1 occlusion seed, output
// occ_out. Each launches one 256-thread block a tile on `stream` without
// synchronising and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for a table it does not take).
extern "C" int pbr_row_sweep(const float* ox, const float* oy, const float* oz,
                             const float* dx, const float* dy, const float* dz,
                             const float* t_limit, const float* lin, int n_lin, int n_tiles,
                             const int* cand, const int* cnt, const float* tent,
                             const int* order, int early_out,
                             const float* seed_t, const int* seed_f, float* t_out, int* f_out,
                             int* occ_out, void* stream) {
  if (!shape_ok(n_lin)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rays r{ox, oy, oz, dx, dy, dz, t_limit, seed_t, seed_f, t_out, f_out, occ_out};
  const float4* lin4 = reinterpret_cast<const float4*>(lin);
  if (t_limit) {
    slotted_rows_kernel<true><<<n_tiles, kTile, 0, s>>>(r, lin4, n_lin, cand, cnt, tent, order,
                                                        early_out);
  } else {
    slotted_rows_kernel<false><<<n_tiles, kTile, 0, s>>>(r, lin4, n_lin, cand, cnt, tent, order,
                                                         early_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pbr_row_sweep_masked(const float* ox, const float* oy, const float* oz,
                                    const float* dx, const float* dy, const float* dz,
                                    const float* t_limit, const float* lin, int n_lin,
                                    int n_tiles, const int* words, const float* seed_t,
                                    const int* seed_f, float* t_out, int* f_out, int* occ_out,
                                    void* stream) {
  if (!shape_ok(n_lin)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rays r{ox, oy, oz, dx, dy, dz, t_limit, seed_t, seed_f, t_out, f_out, occ_out};
  const float4* lin4 = reinterpret_cast<const float4*>(lin);
  if (t_limit) {
    masked_rows_kernel<true><<<n_tiles, kTile, 0, s>>>(r, lin4, n_lin, words);
  } else {
    masked_rows_kernel<false><<<n_tiles, kTile, 0, s>>>(r, lin4, n_lin, words);
  }
  return static_cast<int>(cudaGetLastError());
}
