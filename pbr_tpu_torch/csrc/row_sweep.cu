// The row sweep for Hopper (sm_90a): kernels K5 (slotted) and K5m (masked).
//
// K5 replaces the TPU kernel pbr_tpu/ops/pallas_sweep.py::_kernel_rows
// (launched by ::_build_call), with ::_section, ::_row_done, ::_init_state
// and ::_finalize; K5m replaces ::_kernel_masked_rows (launched by
// ::_build_call_masked). They compute exactly what those kernels compute:
//   - the scene's faces, in memory order, are cut into CL lin clusters of
//     128 faces; lin cluster c holds faces [c * 128, (c + 1) * 128) and a
//     (16, 128) f32 table of the linear form's per-face constants
//     (accel/clusters.py: rows m, km, w, q, e1, e2; padding faces all 0, so
//     det = 0, t = NaN, never valid);
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
// lists or verdict words (ops/cull.py), the seeds and the NEE shadow rays,
// and pads the batch to whole tiles, so every thread holds a real (maybe
// dead) ray and every warp is full.
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
// The design, for that bound and for this card (not the TPU's blocks):
//   - one 256-thread block per ray tile; the TPU's 32-ray row is one warp,
//     and each thread holds its ray (o, d, o x d, t_limit) and its running
//     (t, face), or occlusion, in registers. The TPU kept per-(ray, lane)
//     state in VMEM and reduced it once per tile (_finalize); the
//     lexicographic minimum does not depend on the order of its updates, so
//     a sequential per-thread update gives the same answer;
//   - the TPU grid's sequential slot axis is a loop inside the block, and
//     each block reads its own cand/cnt/tent row (the TPU's scalar
//     prefetch). A slot no row needs costs one __syncthreads_or; a needed
//     lin cluster's (16, 128) table is staged into shared memory by the
//     whole block, face-major, so a face's 16 constants are 4 float4
//     broadcast loads; only the warps whose bit is set run it;
//   - a row's early-out is one __all_sync over its warp; the block leaves
//     once every row is done (__syncthreads_and);
//   - K5m stages only the lin clusters some row of the tile gates in: the
//     whole table (up to 48 x 8 KB) would not fit in shared memory, and
//     multiroom's 128 KB would cap occupancy.
// Later work: a persistent block, TMA staging of the next slot's table
// while the current one runs, several rays a thread.
//
// Numerics: built with --fmad=false, no --use_fast_math and IEEE division,
// so each operation rounds as the unfused torch ops do and the kernels
// equal their plain versions (ops/cuda_sweep.py) bitwise.

#include <cuda_runtime.h>

#include "mt_lin.cuh"

namespace {

constexpr int kTile = 256;        // rays a tile: one block, one ray a thread
constexpr int kRowRays = 32;      // rays a row: one warp
constexpr int kLin = 128;         // faces a lin cluster
constexpr int kMaxLin = 1 << 16;  // lin cluster ids fill bits 0-15 of an entry
constexpr float kBigNeg = -3.0e38f;

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

// Stage lin cluster `cid`'s (16, 128) table into shared memory,
// face-major: sm[j * 16 + k] = lin[cid][k][j].
__device__ __forceinline__ void stage(const float* __restrict__ lin, int cid, float* sm) {
  const float* blk = lin + static_cast<long long>(cid) * pbr::kLinRows * kLin;
  for (int i = threadIdx.x; i < pbr::kLinRows * kLin; i += kTile) {
    const int k = i / kLin, j = i - k * kLin;
    sm[j * pbr::kLinRows + k] = blk[i];
  }
}

// _section: the 128 faces of the staged lin cluster `cid` for one ray.
template <bool ANY_HIT>
__device__ __forceinline__ void section(const float4* sm4, int cid, Ray& y) {
  for (int j = 0; j < kLin; ++j) {
    const float4 a = sm4[4 * j], b = sm4[4 * j + 1], c = sm4[4 * j + 2], e = sm4[4 * j + 3];
    const pbr::LinFace f{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                         c.x, c.y, c.z, c.w, e.x, e.y, e.z, e.w};
    float t;
    const bool valid = pbr::mt_lin(f, y.ox, y.oy, y.oz, y.dx, y.dy, y.dz, y.cx, y.cy, y.cz, &t);
    if constexpr (ANY_HIT) {
      if (valid && t < y.t_limit) y.best = 1.0f;
    } else {
      const int fid = cid * kLin + j;
      if (valid && (t < y.best || (t == y.best && fid < y.face))) {
        y.best = t;
        y.face = fid;
      }
    }
  }
}

// _row_done: every ray of the warp's row has its key at most `bound`. Called
// by all 32 lanes of a warp.
template <bool ANY_HIT>
__device__ __forceinline__ bool row_done(const Ray& y, float bound) {
  const float key = ANY_HIT ? (y.best > 0.0f ? kBigNeg : y.t_limit) : y.best;
  return __all_sync(0xffffffffu, key <= bound);
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(kTile)
    slotted_rows_kernel(Rays r, const float* __restrict__ lin, int n_lin,
                        const int* __restrict__ cand, const int* __restrict__ cnt,
                        const float* __restrict__ tent, int early_out) {
  __shared__ float4 sm4[kLin * pbr::kLinRows / 4];
  const long long i = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  const int row = threadIdx.x / kRowRays;
  Ray y = load_ray<ANY_HIT>(r, i);
  const int* cand_t = cand + static_cast<long long>(blockIdx.x) * n_lin;
  const float* tent_t = tent + static_cast<long long>(blockIdx.x) * (n_lin + 1);
  // Rows whose seeds already beat the first entry bound skip everything.
  bool done = early_out && row_done<ANY_HIT>(y, tent_t[0]);
  const int count = min(cnt[blockIdx.x], n_lin);
  if (!(early_out && __syncthreads_and(done))) {
    for (int l = 0; l < count; ++l) {
      const int entry = cand_t[l];
      const bool run = !done && ((entry >> (16 + row)) & 1);  // uniform over the warp
      if (!__syncthreads_or(run)) continue;  // no row needs it; also: sm4 is free
      const int cid = entry & 0xFFFF;
      stage(lin, cid, reinterpret_cast<float*>(sm4));
      __syncthreads();
      if (run) {
        section<ANY_HIT>(sm4, cid, y);
        if (early_out) done = row_done<ANY_HIT>(y, tent_t[l + 1]);
      }
      if (early_out && __syncthreads_and(done)) break;
    }
  }
  store_ray<ANY_HIT>(r, i, y);
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(kTile)
    masked_rows_kernel(Rays r, const float* __restrict__ lin, int n_lin,
                       const int* __restrict__ words) {
  __shared__ float4 sm4[kLin * pbr::kLinRows / 4];
  const long long i = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  const int row = threadIdx.x / kRowRays;
  Ray y = load_ray<ANY_HIT>(r, i);
  const int* words_t = words + static_cast<long long>(blockIdx.x) * ((n_lin + 1) / 2);
  for (int c = 0; c < n_lin; ++c) {
    const int bits = (words_t[c / 2] >> ((c % 2) * 8)) & 0xFF;
    if (bits == 0) continue;  // one tile per block: uniform over the block
    __syncthreads();          // the previous table is no longer read
    stage(lin, c, reinterpret_cast<float*>(sm4));
    __syncthreads();
    if ((bits >> row) & 1) section<ANY_HIT>(sm4, c, y);
  }
  store_ray<ANY_HIT>(r, i, y);
}

bool shape_ok(int n_lin) { return n_lin > 0 && n_lin <= kMaxLin; }

}  // namespace

// C entry points, bound with ctypes (ops/cuda_sweep.py). Pointers are device
// pointers to n_tiles x 256 rays (a whole number of tiles), the (n_lin, 16,
// 128) f32 lin tables, and the gate tables: K5 takes cand (n_tiles, n_lin)
// int32, cnt (n_tiles,) int32, tent (n_tiles, n_lin + 1) f32 and a flag for
// the early-out; K5m takes the (n_tiles, ceil(n_lin / 2)) int32 verdict
// words. `t_limit` null: nearest mode, seeds seed_t / seed_f, outputs t_out
// / f_out. Otherwise any-hit mode: seed_t is the 0/1 occlusion seed, output
// occ_out. Each launches one 256-thread block a tile on `stream` without
// synchronising and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for a table it does not take).
extern "C" int pbr_row_sweep(const float* ox, const float* oy, const float* oz,
                             const float* dx, const float* dy, const float* dz,
                             const float* t_limit, const float* lin, int n_lin, int n_tiles,
                             const int* cand, const int* cnt, const float* tent, int early_out,
                             const float* seed_t, const int* seed_f, float* t_out, int* f_out,
                             int* occ_out, void* stream) {
  if (!shape_ok(n_lin)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rays r{ox, oy, oz, dx, dy, dz, t_limit, seed_t, seed_f, t_out, f_out, occ_out};
  if (t_limit) {
    slotted_rows_kernel<true><<<n_tiles, kTile, 0, s>>>(r, lin, n_lin, cand, cnt, tent,
                                                        early_out);
  } else {
    slotted_rows_kernel<false><<<n_tiles, kTile, 0, s>>>(r, lin, n_lin, cand, cnt, tent,
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
  if (t_limit) {
    masked_rows_kernel<true><<<n_tiles, kTile, 0, s>>>(r, lin, n_lin, words);
  } else {
    masked_rows_kernel<false><<<n_tiles, kTile, 0, s>>>(r, lin, n_lin, words);
  }
  return static_cast<int>(cudaGetLastError());
}
