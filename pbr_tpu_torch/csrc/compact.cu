// Live-path compaction for Hopper (sm_90a): kernels K13 (a stage's row
// gather) and K14 (the fold back), and their backward, K13 bwd and K14 bwd.
//
// They replace no Pallas kernel. The JAX package compacts the live lanes
// between the stages of a frame's bounce loop with XLA's gathers
// (pbr_tpu/models/integrator.py::_take_rows, :243-245, at the stage
// gathers :863-876) and folds the deeper stages' colours back out with
// gathers too (:899-911); under jax.grad XLA turns each into its transpose,
// a scatter-add. The port ran them as torch's advanced indexing, whose
// backward (index_put with accumulate) sorts the indices: 11-14 ms of a
// 1024² forward+backward frame on the H100. The rows that a stage gathers
// are unique by construction (src is a stable partition of the live rows;
// past the live count n_ok it repeats row 0, whose lanes are masked dead;
// the fold's slot map is src's inverse), so every backward here is a
// gather through the inverse map: no sort, no atomics, no zero-fill pass.
//
// Lanes group into rows of `block` consecutive lanes. A compaction plan
// (ops/cuda_compact.py::Plan, from models/integrator.py::_compact_rows):
// src (cap,) the source row of each compact slot, slot (R,) each row's
// compact slot (cap where it has none), n_ok the slots that hold a live row,
// read on the device. One template, one launch over every field of a call
// (blockIdx.y picks the field), MODE picks the instance:
//   - kTake ("K13"):     out[j] = in[src[j]]; the alive field (kBoolLive)
//                        also masked by j < n_ok;
//   - kTakeBwd ("K13 bwd"): g_in[r] = slot[r] < n_ok ? g_out[slot[r]] : 0;
//   - kFold ("K14"):     out[r] = prev[r] + (slot[r] < cap ? cur[slot[r]] : 0),
//                        the add on every lane, + 0 where the row has no slot
//                        (as the plain fold adds a select's +0.0);
//   - kFoldBwd ("K14 bwd"): g_cur[j] = j < n_ok ? g[src[j]] : 0;
// where x[i] is row i's `block` lanes of x. A padding slot (j >= n_ok) adds
// nothing to row 0 in the backward: the scatter-add's number wherever the
// padding lanes' upstream gradient is 0, which tests/test_torch_compact.py
// holds on whole frames.
//
// What bounds them on this card: bytes. Each reads the rows it needs of
// its inputs once and writes its outputs once: K13 a stage's live rows of
// 13 fields of 1-8 bytes and the stage's capacity of them, K13 bwd and K14
// full-width outputs (8,192 rows of 128 lanes at 1024²). A stage of the
// bench's probed schedules holds at most a few hundred rows, so a launch is
// a few microseconds, near its launch latency (PERF.md §6). The design:
// one thread a group of V lanes of one row and one field, V = 4 where the
// block and every pointer allow 16-byte loads of the 4-byte fields (a
// thread then moves 16 B, 32 B of an 8-byte field, 4 B of a bool), else 1.
// Copies and one add: bitwise the plain versions (--fmad=false is moot).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 16;
constexpr int kTake = 0, kTakeBwd = 1, kFold = 2, kFoldBwd = 3;
// A field's element type (ops/cuda_compact.py::_KINDS).
constexpr int kF32 = 0, kI32 = 1, kI64 = 2, kBool = 3, kBoolLive = 4;

struct Field {
  const void* in;    // the gathered tensor: (rows_in * block,)
  const void* prev;  // kFold: the outer stage's tensor, (rows * block,)
  void* out;         // (rows * block,)
  int kind;
};

struct CompactArgs {
  Field f[kMaxFields];
  const int* idx;   // src (kTake, kFoldBwd) or slot (kTakeBwd, kFold), (rows,)
  const int* n_ok;  // () the slots that hold a live row
  int rows;         // output rows
  int block;        // lanes a row
  int cap;          // kFold: a slot below cap holds a live row
};

// V consecutive elements of T, loaded and stored as one vector.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <int MODE, int V, typename T>
__device__ __forceinline__ void move(const Field& f, long long o, long long s, bool valid,
                                     bool live) {
  using P = Pack<T, V>;
  P r;
  if (valid) {
    r = reinterpret_cast<const P*>(f.in)[s];
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = T(0);
  }
  if (MODE == kTake && !live) {  // kBoolLive past the live count
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = T(0);
  }
  if (MODE == kFold) {
    const P p = reinterpret_cast<const P*>(f.prev)[o];
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = p.v[k] + r.v[k];
  }
  reinterpret_cast<P*>(f.out)[o] = r;
}

template <int MODE, int V>
__global__ void __launch_bounds__(kThreads) row_gather_kernel(CompactArgs a) {
  // The block's field, picked by constant indices: a kernel parameter
  // indexed at run time would be copied to local memory.
  Field f = a.f[0];
#pragma unroll
  for (int k = 1; k < kMaxFields; ++k) {
    if (k == static_cast<int>(blockIdx.y)) f = a.f[k];
  }
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g * V >= static_cast<long long>(a.rows) * a.block) return;
  const long long lane = g * V;
  const int i = static_cast<int>(lane / a.block);  // the output row
  const int l = static_cast<int>(lane - static_cast<long long>(i) * a.block);
  const int x = a.idx[i];
  bool valid = true, live = true;
  if (MODE == kTake) {
    live = f.kind != kBoolLive || i < *a.n_ok;
  } else if (MODE == kTakeBwd) {
    valid = x < *a.n_ok;
  } else if (MODE == kFold) {
    valid = x < a.cap;
  } else {
    valid = i < *a.n_ok;
  }
  const long long s = (static_cast<long long>(x) * a.block + l) / V;  // in units of V lanes
  switch (f.kind) {
    case kF32:
      move<MODE, V, float>(f, g, s, valid, live);
      break;
    case kI32:
      move<MODE, V, int>(f, g, s, valid, live);
      break;
    case kI64:
      move<MODE, V, long long>(f, g, s, valid, live);
      break;
    default:  // kBool, kBoolLive: bytes of 0 or 1
      move<MODE, V, unsigned char>(f, g, s, valid, live);
      break;
  }
}

template <int MODE>
cudaError_t launch(const CompactArgs& a, int fields, int vec, cudaStream_t stream) {
  const long long groups = static_cast<long long>(a.rows) * a.block / vec;
  const dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads),
                  static_cast<unsigned>(fields));
  if (vec == 4) {
    row_gather_kernel<MODE, 4><<<grid, kThreads, 0, stream>>>(a);
  } else {
    row_gather_kernel<MODE, 1><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of instance `mode` (0 K13, 1 K13 bwd, 2 K14, 3 K14 bwd) over
// `fields` fields: ptrs holds (in, prev, out) a field, kinds its element
// type; idx, n_ok, rows, block and cap as in CompactArgs; vec the lanes a
// thread (4: block % 4 == 0 and every pointer aligned to 4 elements; else
// 1). Returns the launch's cudaError (0 for no lanes).
int pbr_compact(int mode, const void* const* ptrs, const int* kinds, int fields, const int* idx,
                const int* n_ok, int rows, int block, int cap, int vec, void* stream) {
  if (fields < 1 || fields > kMaxFields || (vec != 1 && vec != 4) || block % vec != 0 ||
      mode < kTake || mode > kFoldBwd) {
    return cudaErrorInvalidValue;
  }
  if (rows == 0 || block == 0) return 0;
  CompactArgs a{};
  for (int k = 0; k < fields; ++k) {
    a.f[k].in = ptrs[3 * k];
    a.f[k].prev = ptrs[3 * k + 1];
    a.f[k].out = const_cast<void*>(ptrs[3 * k + 2]);
    a.f[k].kind = kinds[k];
  }
  a.idx = idx;
  a.n_ok = n_ok;
  a.rows = rows;
  a.block = block;
  a.cap = cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kTake:
      return static_cast<int>(launch<kTake>(a, fields, vec, s));
    case kTakeBwd:
      return static_cast<int>(launch<kTakeBwd>(a, fields, vec, s));
    case kFold:
      return static_cast<int>(launch<kFold>(a, fields, vec, s));
    default:
      return static_cast<int>(launch<kFoldBwd>(a, fields, vec, s));
  }
}

}  // extern "C"
