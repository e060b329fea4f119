// Row gather by id over the three table layouts (K1).
//
// Replaces: goctr_tpu/ops/pallas/row_gather.py::_kernel /
// gather_rows_packed (pallas_call at :74), and the `jnp.take` + lane
// slice + one-hot select + `.astype(cd)` of `rows_of`
// (goctr_tpu/serve/scorer.py:88-99, goctr_tpu/parallel/scanned.py:92-100).
//
// One kernel serves the three layouts through (stride, group, dim):
//   plain   [V, D]        group 1, stride D
//   packed  [V, 128]      group 1, stride 128, first D lanes
//   grouped [L, 128]      group G = 128 / (D+1): line id / G,
//                         lanes (id % G)·(D+1) … +D
// The output is written in the compute dtype (f32 or bf16, round to
// nearest even), so the cast is folded into the copy. An id outside
// [0, n_rows) is never read: its output row is NaN, which is what
// `jnp.take` returns for it in the JAX package.
//
// What bounds it on the H100: bytes. Each output row reads D·4 bytes of
// table (256 B at D = 64) from a random place in a multi-GB table and
// writes D·2 or D·4 bytes; there is no arithmetic. The TPU kernel keeps a
// ring of row DMAs in flight; here the latency of each row's load has to
// be hidden by many loads in flight a thread, not by warps alone (one
// row a warp left each warp one dependent id → row → store chain and ran
// at a third of the bound).
// Design:
//   - chunks: a warp takes R = 32·k consecutive output rows (k = 1 … 4,
//     so that each lane has at least 8 units), reads their ids with k
//     coalesced loads and turns each into its row's float offset (−1 for
//     an id out of range) in shared memory;
//   - units: a row is Ur units of 16 output bytes (4 floats in f32, 8 in
//     bf16); the chunk's R·Ur units are spread over the 32 lanes in order
//     (unit u at lane u % 32), so every lane has work at any width, and
//     a warp's stores cover whole contiguous output rows;
//   - a lane issues the loads of kLoads float4s (kLoads / loads-a-unit
//     units) before it converts and stores any of them;
//   - layouts: plain and packed rows start on 16 bytes (aligned: one or
//     two float4 loads a unit); grouped rows start at (id % G)·(D+1)
//     floats, so a unit reads the aligned float4s that cover it, one
//     more than it needs, and shifts the floats into place (shifted);
//     widths that are not a whole number of units, or unaligned
//     pointers, take element loads and stores (scalar);
//   - a grid of one chunk a warp, 8 warps a block: the card's block
//     scheduler balances the warps' uneven times (a persistent grid
//     whose warps walk chunks w, w + W, ... measured slower: its last
//     wave is part empty; PERF.md).
// Plain version: gather_rows_plain in
// goctr_tpu_torch/ops/kernels/row_gather.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps a block
constexpr int kMaxK = 4;           // 32-row id groups a chunk, at most
constexpr int kUnitsPerLane = 8;   // units a lane a chunk, at least (sets k)
constexpr int kLoads = 8;          // float4 (or element) loads a lane issues
                                   // before its first store
// the output is stored with the streaming hint (st.global.cs), so that
// it does not push the table's hot rows out of L2 (faster than plain
// stores at the training shapes: scripts/gather_run_sweep.py, PERF.md)
constexpr bool kStreamStores = true;

enum Mode { kAligned = 0, kShifted = 1, kScalar = 2 };

struct Params {
  const float* table;
  const int* ids;
  void* out;
  long long n, n_rows, stride;
  int group, dim;
  int units;         // Ur: units a row (elements in the scalar mode)
  int k;             // 32-row id groups a chunk
  int q, rm;         // 32 / units, 32 % units: the step of a lane's unit
  long long n_chunks;
};

template <typename Out>
struct Unit;  // kW output elements in 16 bytes
template <>
struct Unit<float> {
  static constexpr int kW = 4;
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <>
struct Unit<__nv_bfloat16> {
  static constexpr int kW = 8;
  static __device__ __forceinline__ uint32_t two(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(two(v[0], v[1]), two(v[2], v[3]), two(v[4], v[5]),
                      two(v[6], v[7]));
  }
};

__device__ __forceinline__ void store16(void* p, uint4 v) {
  if (kStreamStores) {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  } else {
    *reinterpret_cast<uint4*>(p) = v;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The ids of chunk `chunk` this lane reads (rows 32·i + lane), -1 past
// the end of the ids.
__device__ __forceinline__ void load_ids(const Params& p, long long chunk,
                                         int lane, int (&id)[kMaxK]) {
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    const long long row = chunk * (32ll * p.k) + 32 * i + lane;
    id[i] = i < p.k && row < p.n ? __ldg(p.ids + row) : -1;
  }
}

// The next unit of this lane: 32 units on.
__device__ __forceinline__ void advance(const Params& p, int& row, int& col) {
  col += p.rm;
  row += p.q;
  if (col >= p.units) {
    col -= p.units;
    ++row;
  }
}

// Copy the chunk's units_here units (rows of `off`, -1 = NaN row) to out.
template <typename Out, int kMode>
__device__ __forceinline__ void copy_units(const Params& p,
                                           const long long* off, Out* out,
                                           long long units_here, int row,
                                           int col, int lane) {
  constexpr int kW = kMode == kScalar ? 1 : Unit<Out>::kW;
  // float4 loads a unit: kW / 4, one more when the row is shifted
  constexpr int kL = kMode == kScalar ? 1 : kW / 4 + (kMode == kShifted);
  constexpr int kU = kLoads / kL > 0 ? kLoads / kL : 1;  // units a batch
  const float nan = __int_as_float(0x7fc00000);
  for (long long u0 = lane; u0 < units_here; u0 += 32 * kU) {
    int rr[kU], cc[kU];
    long long src[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      rr[j] = row;
      cc[j] = col;
      advance(p, row, col);
      src[j] = u0 + 32 * j < units_here ? off[rr[j]] : -2;
      if (src[j] >= 0) src[j] += static_cast<long long>(cc[j]) * kW;
    }
    if constexpr (kMode == kScalar) {
      float v[kU];
#pragma unroll
      for (int j = 0; j < kU; ++j)
        v[j] = src[j] >= 0 ? __ldg(p.table + src[j]) : nan;
#pragma unroll
      for (int j = 0; j < kU; ++j)
        if (src[j] != -2)
          store1(out + static_cast<long long>(rr[j]) * p.dim + cc[j], v[j]);
    } else {
      float4 v[kU][kL];
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        const long long f = src[j] >= 0 ? src[j] : 0;
        const float4* s4 = reinterpret_cast<const float4*>(p.table + (f & ~3ll));
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          // the shifted mode's extra float4 only when the row is not on
          // 16 bytes (else it may lie past the table's end)
          const bool need = src[j] >= 0 &&
                            (kMode != kShifted || l < kL - 1 || (f & 3) != 0);
          v[j][l] = need ? __ldg(s4 + l) : make_float4(nan, nan, nan, nan);
        }
      }
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        if (src[j] == -2) continue;
        float w[kW];
        const int s = kMode == kShifted && src[j] >= 0
                          ? static_cast<int>(src[j] & 3) : 0;
#pragma unroll
        for (int e = 0; e < kW; ++e) {
          // element e of the unit is float s + e of its loads
          const float a = comp(v[j][e / 4], e % 4);
          if constexpr (kMode == kShifted) {
            const float b1 = comp(v[j][(e + 1) / 4], (e + 1) % 4);
            const float b2 = comp(v[j][(e + 2) / 4], (e + 2) % 4);
            const float b3 = comp(v[j][(e + 3) / 4], (e + 3) % 4);
            w[e] = s == 0 ? a : s == 1 ? b1 : s == 2 ? b2 : b3;
          } else {
            w[e] = a;
          }
        }
        store16(out + static_cast<long long>(rr[j]) * p.dim + cc[j] * kW,
                Unit<Out>::pack(w));
      }
    }
  }
}

template <typename Out, int kMode>
__global__ void __launch_bounds__(kWarps * 32)
row_gather_kernel(const __grid_constant__ Params p) {
  __shared__ long long offs[kWarps][32 * kMaxK];
  const int lane = threadIdx.x & 31;
  long long* off = offs[threadIdx.x >> 5];
  const long long chunk = static_cast<long long>(blockIdx.x) * kWarps +
                          (threadIdx.x >> 5);
  if (chunk >= p.n_chunks) return;
  int id[kMaxK];
  load_ids(p, chunk, lane, id);
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    if (i >= p.k) break;
    long long o = -1;
    if (id[i] >= 0 && id[i] < p.n_rows)
      o = p.group == 1
              ? static_cast<long long>(id[i]) * p.stride
              : static_cast<long long>(id[i] / p.group) * p.stride +
                    static_cast<long long>(id[i] % p.group) * (p.dim + 1);
    off[32 * i + lane] = o;
  }
  __syncwarp();
  const long long first = chunk * (32ll * p.k);
  const long long left = p.n - first;
  const long long rows = left < 32ll * p.k ? left : 32ll * p.k;
  copy_units<Out, kMode>(p, off, static_cast<Out*>(p.out) + first * p.dim,
                         rows * p.units, lane / p.units, lane % p.units, lane);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Out, int kMode>
cudaError_t launch_mode(const Params& p, cudaStream_t s) {
  const long long blocks = (p.n_chunks + kWarps - 1) / kWarps;
  row_gather_kernel<Out, kMode><<<static_cast<unsigned>(blocks), kWarps * 32,
                                  0, s>>>(p);
  return cudaGetLastError();
}

template <typename Out>
int launch(const void* table, const void* ids, void* out, long long n,
           long long n_rows, long long stride, int group, int dim,
           void* stream) {
  if (n <= 0) return 0;
  if (dim <= 0 || group <= 0) return cudaErrorInvalidValue;
  constexpr int kW = Unit<Out>::kW;
  const bool vec = dim % kW == 0 && stride % 4 == 0 && aligned(table, 16) &&
                   aligned(out, 16);
  const int mode = !vec ? kScalar : group == 1 ? kAligned : kShifted;
  Params p;
  p.table = static_cast<const float*>(table);
  p.ids = static_cast<const int*>(ids);
  p.out = out;
  p.n = n;
  p.n_rows = n_rows;
  p.stride = stride;
  p.group = group;
  p.dim = dim;
  p.units = mode == kScalar ? dim : dim / kW;
  p.k = (kUnitsPerLane + p.units - 1) / p.units;
  if (p.k > kMaxK) p.k = kMaxK;
  p.q = 32 / p.units;
  p.rm = 32 % p.units;
  p.n_chunks = (n + 32ll * p.k - 1) / (32ll * p.k);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = mode == kAligned   ? launch_mode<Out, kAligned>(p, s)
                        : mode == kShifted ? launch_mode<Out, kShifted>(p, s)
                                           : launch_mode<Out, kScalar>(p, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" int row_gather_f32(const void* table, const void* ids, void* out,
                              long long n, long long n_rows, long long stride,
                              int group, int dim, void* stream) {
  return launch<float>(table, ids, out, n, n_rows, stride, group, dim, stream);
}

extern "C" int row_gather_bf16(const void* table, const void* ids, void* out,
                               long long n, long long n_rows, long long stride,
                               int group, int dim, void* stream) {
  return launch<__nv_bfloat16>(table, ids, out, n, n_rows, stride, group, dim,
                               stream);
}

extern "C" const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
