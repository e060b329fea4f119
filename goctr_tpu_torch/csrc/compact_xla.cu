// The fused table update's "xla" compaction as one device pass.
//
// Replaces: no Pallas kernel. The JAX trainer's compact_impl="xla" front
// end is XLA glue (goctr_tpu/parallel/scanned.py:296-311, the rank-sort
// compaction over `_cumsum_rows`, goctr_tpu/ops/segsum.py); its kernel
// counterpart there, compact_impl="kernel", is K9
// (goctr_tpu/ops/pallas/compact.py, here csrc/compact_runsums.cu). In the
// port the glue was ~20 PyTorch operations a step: the cast of the bf16
// row gradients to f32, the pad mask, the permutation of every row into id
// order, the two-level blocked cumsum, a second stable sort that moves the
// real run ends to the front, the gather of their cumsum rows, their
// differences and the packing into [capr, 128] rows. This kernel does that
// work from the ids' stable sort (which stays a PyTorch sort) and the rows
// as autograd gives them, bit for bit with those operations on the card.
//
// Input: the raw ids [n0] int32 (-1 = pad), the sorted ids s_ids [n]
// int32 (pads and the stream's padding carry id `vocab`; n is n0 rounded
// up to 1024), the sort's permutation order [n] int64, the row gradients
// g [n0, D] bf16 or f32 in batch order, capr <= n. Output:
//   tgt  [capr] int32: the real runs' ids (id < vocab) in id order, then
//        junk targets vocab + 1 + k for the slots k past them;
//   rows [capr, 128] f32 (packed: Σg | ‖Σg‖² | 0, the row update's input
//        at G = 1, D <= 127) or [capr, D] f32 (Σg: the grouped lines'
//        input, and at D = 128 the split row update's, weights and
//        accumulator kept apart);
//   overflow [1] int32: max(#real runs − capr, 0).
//
// The arithmetic is the glue's, add for add. The sorted stream is cut
// into 1024-row blocks (segsum.py's _BLOCK); within a block each column
// is a sequential f32 sum from 0 (PyTorch's tensor_kernel_scan_outer_dim,
// cb); the block totals' sequential sum gives incl_b, and each block's
// offset is off_b = incl_b − tot_b; c = cb + off_b; the k-th real run end's
// row is c[end_k] − c[end_(k−1)], with c[end_(−1)] = 0. A pad row is
// g · 0 (the glue's mask multiply, so its sign and a NaN survive), the
// stream's padding rows are +0. Pads sort after every real run, so they
// enter only the totals of the block where the real rows end. Every term
// is written with __fadd_rn / __fsub_rn / __fmul_rn, so nvcc contracts
// nothing. ‖Σg‖² (lane D) is summed in f64 from the f32 row and rounded
// once: within f32 rounding of PyTorch's (rows · rows).sum(1), whose order
// of adds is PyTorch's own.
//
// What bounds it on the H100: bytes, and the rate at which the card
// gathers scattered rows. It reads the rows once in id order (a gather:
// each row lies wherever its example put it), the ids and the
// permutation, and writes capr output rows once. At the headline step
// (n = 2,162,688, D = 64 bf16, capr = 596,992, packed): 276.8 MB of rows,
// 26.0 MB of ids and permutation, 307.9 MB of output: 0.61 GB needed,
// 0.18 ms at 3.35 TB/s. The real runs' cumsum rows (R · 256 B, R ~ 24%
// of n there) go out and back in once more. The adds (n·D) are far below
// the card's f32 rate.
//
// Design: five launches, none of which waits on another block.
//   - end counts (xla_end_counts): one warp a 1024-row block counts the
//     real run ends in its ids; end slots (xla_end_slots), one block,
//     turns the counts into each block's first output slot (an exclusive
//     prefix of integers), the total and `overflow`;
//   - block sums (xla_block_sums): one warp a 1024-row block, lanes over
//     P = 2 columns (P = 4 above D = 64), so a D = 64 bf16 row is one
//     4-byte load a lane. A block whose first row is a pad holds no real
//     run and is skipped. The warp walks its block in 32-row chunks: the
//     chunk's ids, run-end flags and permutation indices are one coalesced
//     load a lane, read a chunk ahead; the 32 rows' loads are all issued
//     before the first add, then added in row order. At each real run
//     end it writes the target and the cumsum so far (cb) into the run's
//     output slot; at the end, the block's total and its cumsum at its
//     last real run end. Warps past the blocks fill the junk slots while
//     the gathers run;
//   - offsets (xla_block_offsets): the block totals' sequential sum, one
//     block of threads for four columns: a window of 2048 blocks' totals
//     staged in shared memory, then a thread a column walks it;
//   - run rows (xla_run_rows): one warp a block reads its slots' cb back
//     (contiguous), adds the block's offset, takes differences and writes
//     each output row once, whole, with streaming stores (st.global.cs).
//     The c before the block's first slot is the cb at the last real end
//     of the nearest earlier block that has one, plus that block's
//     offset.
// On the H100 (PERF.md §6) the gathers set the pace: the block sums take
// ~2/3 of the time at ~8-12 G rows/s whatever the row's width (D = 16 or
// 64), about the card's rate for scattered rows. Loading the next chunk's
// rows while this chunk's add, 8 or 32 slots a run-rows batch, more
// run-rows blocks an SM and loads that skip L1 gave nothing or lost.
// Plain version: compact_xla_rows_plain in
// goctr_tpu_torch/ops/kernels/compact_xla.py (the glue itself).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 1024;  // segsum.py _BLOCK, ROWS_PER_STEP
constexpr int kChunk = 32;        // rows a warp loads at once
constexpr int kChunks = kBlockRows / kChunk;
constexpr int kWarps = 4;         // warps a block of the row passes
constexpr int kLanes = 128;       // floats of a packed row
constexpr int kMaxPackedDim = 127;  // a packed row keeps a lane for ‖Σg‖²
constexpr int kCountWarps = 8;       // warps a block of the end counts
constexpr int kSlotThreads = 1024;   // the end slots' one block
constexpr int kChainCols = 4;        // columns a block of the offsets
constexpr int kChainThreads = 256;
constexpr int kChainWindow = 2048;   // block totals staged at a time
constexpr int kSlotBatch = 32;       // slots a run-rows warp reads at once
constexpr int kFillSlots = 256;      // junk slots a fill warp writes
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kRow = 0, kMasked = 1, kPad = 2 };

__device__ __forceinline__ long long lmin(long long x, long long y) {
  return x < y ? x : y;
}
__device__ __forceinline__ long long lmax(long long x, long long y) {
  return x > y ? x : y;
}

struct Args {
  const int* ids;          // [n0] raw ids
  const int* s_ids;        // [n] sorted
  const long long* order;  // [n] the sort's permutation
  const void* g;           // [n0, d] bf16 or f32
  long long n0, n, nb, capr;
  int d, vocab;
  int width;               // floats an output row: 128 packed, else d
  bool out_vec;            // a lane's P output floats are one vector
  int* tgt;
  float* rows;             // [capr, width]
  int* overflow;
  float *tot, *cbl, *off;  // [nb, d] each
  int *cnt, *k0, *total;   // [nb], [nb], [1]
};

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kBytes = 2;
};
template <>
struct Elem<float> {
  static constexpr int kBytes = 4;
};

// A lane's P columns of one row, as raw 32-bit words.
template <typename T, int P>
struct Raw {
  static constexpr int kWords = P * Elem<T>::kBytes / 4;
  unsigned w[kWords];
};

template <typename T, int P, bool kVec>
__device__ __forceinline__ Raw<T, P> load_cols(const Args& a, long long row,
                                               int c0) {
  Raw<T, P> r;
  const char* p = static_cast<const char*>(a.g) +
                  (row * a.d + c0) * Elem<T>::kBytes;
  if constexpr (kVec) {
    if constexpr (Raw<T, P>::kWords == 1) {
      r.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else if constexpr (Raw<T, P>::kWords == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      r.w[0] = v.x;
      r.w[1] = v.y;
    } else {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      r.w[0] = v.x;
      r.w[1] = v.y;
      r.w[2] = v.z;
      r.w[3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < Raw<T, P>::kWords; ++i) r.w[i] = 0u;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (c0 + q >= a.d) break;
      if constexpr (Elem<T>::kBytes == 2) {
        const unsigned h =
            __ldg(reinterpret_cast<const unsigned short*>(p) + q);
        r.w[q / 2] |= (q % 2 == 0) ? h : (h << 16);
      } else {
        r.w[q] = __ldg(reinterpret_cast<const unsigned*>(p) + q);
      }
    }
  }
  return r;
}

// Column q of a lane's raw words as f32 (bf16 → f32 is exact: the bits
// moved up 16).
template <typename T, int P>
__device__ __forceinline__ float col(const Raw<T, P>& r, int q) {
  if constexpr (Elem<T>::kBytes == 2) {
    const unsigned w = r.w[q / 2];
    return __uint_as_float(q % 2 == 0 ? w << 16 : w & 0xffff0000u);
  } else {
    return __uint_as_float(r.w[q]);
  }
}

// What the warp needs of sorted position p: its id and the next one, and
// where its row lies (loaded a chunk ahead), then what the glue made of
// the row and whether a real run ends there (worked out when used).
struct Meta {
  long long o;
  int sid, nxt, kind;
  bool end;
};

__device__ __forceinline__ Meta fetch(const Args& a, long long p) {
  Meta m;
  m.sid = __ldg(a.s_ids + p);
  m.nxt = p + 1 < a.n ? __ldg(a.s_ids + p + 1) : ~m.sid;
  m.o = __ldg(a.order + p);
  return m;
}

__device__ __forceinline__ void finish(const Args& a, Meta& m) {
  m.kind = kRow;
  if (m.o >= a.n0)
    m.kind = kPad;  // the stream's padding: a +0 row
  else if (m.sid >= a.vocab && __ldg(a.ids + m.o) < 0)
    m.kind = kMasked;  // a -1 pad: its row times 0
  m.end = m.nxt != m.sid && m.sid < a.vocab;
}

// Loads of one 32-row chunk, all issued before any is used.
template <typename T, int P, bool kVec>
__device__ __forceinline__ void load_chunk(const Args& a, Meta& m, int c0,
                                           Raw<T, P> (&raw)[kChunk]) {
  finish(a, m);
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    const long long o = __shfl_sync(kFull, m.o, r);
    const int kind = __shfl_sync(kFull, m.kind, r);
    if (kind != kPad && c0 < a.d) {
      raw[r] = load_cols<T, P, kVec>(a, o, c0);
    } else {
#pragma unroll
      for (int i = 0; i < Raw<T, P>::kWords; ++i) raw[r].w[i] = 0u;
    }
  }
}

// Row r of a chunk added into the lane's column sums, as the glue's
// in-block cumsum adds it.
template <typename T, int P>
__device__ __forceinline__ void add_row(const Raw<T, P>& raw, bool masked,
                                        float (&acc)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    float x = col<T, P>(raw, q);
    if (masked) x = __fmul_rn(x, 0.0f);
    acc[q] = __fadd_rn(acc[q], x);
  }
}

// A lane's P f32 columns at `out`, its first column c0.
template <int P>
__device__ __forceinline__ void store_cols(float* out, int c0, int d,
                                           bool vec, const float (&v)[P]) {
  if (c0 >= d) return;
  if (vec) {
    if constexpr (P == 2)
      *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
    else
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (c0 + q < d) out[q] = v[q];
  }
}

template <int P>
__device__ __forceinline__ void load_f32(const float* in, int c0, int d,
                                         bool vec, float (&v)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) v[q] = 0.0f;
  if (c0 >= d) return;
  if (vec) {
    if constexpr (P == 2) {
      const float2 x = *reinterpret_cast<const float2*>(in);
      v[0] = x.x;
      v[1] = x.y;
    } else {
      const float4 x = *reinterpret_cast<const float4*>(in);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (c0 + q < d) v[q] = in[q];
  }
}

template <int P>
__device__ __forceinline__ void store_cs(float* p, const float (&v)[P]) {
  if constexpr (P == 2) {
    asm volatile("st.global.cs.v2.f32 [%0], {%1, %2};\n" ::"l"(p),
                 "f"(v[0]), "f"(v[1])
                 : "memory");
  } else {
    asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
                 : "memory");
  }
}

// Output slot k's row from a lane's P columns of Σg: packed, the whole
// 128-float row (Σg | ‖Σg‖² | 0); else the D floats of Σg.
template <int P, bool kOutVec, bool kPacked>
__device__ __forceinline__ void write_row(const Args& a, long long k, int c0,
                                          const float (&row)[P]) {
  if constexpr (kPacked) {
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (c0 + q < a.d) {
        const double x = static_cast<double>(row[q]);
        s = __fma_rn(x, x, s);  // f32 squares are exact in f64
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    const float nsq = __double2float_rn(s);
    float* out = a.rows + k * kLanes;
#pragma unroll
    for (int h = 0; h < kLanes / (32 * P); ++h) {
      const int i0 = h * 32 * P + c0;
      float v[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int i = i0 + q;
        v[q] = (h == 0 && i < a.d) ? row[q] : (i == a.d ? nsq : 0.0f);
      }
      store_cs<P>(out + i0, v);
    }
  } else {
    float* out = a.rows + k * a.d + c0;
    if (c0 >= a.d) return;
    if constexpr (kOutVec) {
      store_cs<P>(out, row);
    } else {
#pragma unroll
      for (int q = 0; q < P; ++q)
        if (c0 + q < a.d) __stcs(out + q, row[q]);
    }
  }
}

// Junk slots [max(lo, total), hi): targets vocab + 1 + k, zero rows.
template <bool kPacked>
__device__ __forceinline__ void fill_junk(const Args& a, long long f,
                                          int lane) {
  const long long lo = lmax(f * kFillSlots, *a.total);
  const long long hi = lmin((f + 1) * kFillSlots, a.capr);
  for (long long s = lo + lane; s < hi; s += 32)
    a.tgt[s] = a.vocab + 1 + static_cast<int>(s);
  if constexpr (kPacked) {
    const float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (long long s = lo; s < hi; ++s)
      store_cs<4>(a.rows + s * kLanes + lane * 4, z);
  } else {
    for (long long i = lo * a.d + lane; i < hi * a.d; i += 32)
      __stcs(a.rows + i, 0.0f);
  }
}

__global__ void __launch_bounds__(kCountWarps * 32)
    xla_end_counts(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kCountWarps + (threadIdx.x >> 5);
  if (b >= a.nb) return;
  int ends = 0;
#pragma unroll 8
  for (int c = 0; c < kChunks; ++c) {
    const long long p = b * kBlockRows + c * kChunk + lane;
    const int sid = __ldg(a.s_ids + p);
    int nxt = __shfl_down_sync(kFull, sid, 1);
    if (lane == 31) nxt = p + 1 < a.n ? __ldg(a.s_ids + p + 1) : ~sid;
    ends += __popc(__ballot_sync(kFull, sid < a.vocab && nxt != sid));
  }
  if (lane == 0) a.cnt[b] = ends;
}

__global__ void __launch_bounds__(kSlotThreads) xla_end_slots(const Args a) {
  __shared__ int sums[kSlotThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long carry = 0;
  for (long long start = 0; start < a.nb; start += kSlotThreads) {
    const long long b = start + tid;
    const int v = b < a.nb ? a.cnt[b] : 0;
    int x = v;  // inclusive prefix within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      sums[lane] = w;
    }
    __syncthreads();
    if (b < a.nb)
      a.k0[b] = static_cast<int>(carry + (warp ? sums[warp - 1] : 0) + x - v);
    carry += sums[31];
    __syncthreads();
  }
  if (tid == 0) {
    *a.total = static_cast<int>(carry);
    *a.overflow = static_cast<int>(lmax(carry - a.capr, 0));
  }
}

// A chunk's rows added in row order; at each real run end the target and
// the cumsum so far go to the run's slot k (while k < capr).
template <typename T, int P>
__device__ __forceinline__ void sum_chunk(const Args& a, const Meta& m,
                                          const Raw<T, P> (&raw)[kChunk],
                                          int c0, long long& k,
                                          float (&acc)[P], float (&last)[P]) {
  const unsigned endm = __ballot_sync(kFull, m.end);
  const unsigned mulm = __ballot_sync(kFull, m.kind == kMasked);
  if (m.end) {  // the targets, by the lanes that hold their ids
    const long long kk =
        k + __popc(endm & ((1u << (threadIdx.x & 31)) - 1u));
    if (kk < a.capr) a.tgt[kk] = m.sid;
  }
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    add_row<T, P>(raw[r], (mulm >> r) & 1u, acc);
    if ((endm >> r) & 1u) {
#pragma unroll
      for (int q = 0; q < P; ++q) last[q] = acc[q];
      if (k < a.capr)
        store_cols<P>(a.rows + k * a.width + c0, c0, a.d, a.out_vec, acc);
      ++k;
    }
  }
}

template <typename T, int P, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    xla_block_sums(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= a.nb) {  // the warps past the blocks: junk slots
    if (a.width == kLanes)
      fill_junk<true>(a, b - a.nb, lane);
    else
      fill_junk<false>(a, b - a.nb, lane);
    return;
  }
  const int c0 = lane * P;
  float acc[P], last[P];
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = last[q] = 0.0f;
  const long long p0 = b * kBlockRows;
  if (__ldg(a.s_ids + p0) < a.vocab) {  // else no real row: nothing reads it
    long long k = __ldg(a.k0 + b);
    Meta m = fetch(a, p0 + lane);
    for (int c = 0; c < kChunks; ++c) {
      Raw<T, P> raw[kChunk];
      load_chunk<T, P, kVec>(a, m, c0, raw);
      const Meta cur = m;  // the next chunk's ids in flight while these add
      if (c + 1 < kChunks) m = fetch(a, p0 + (c + 1) * kChunk + lane);
      sum_chunk<T, P>(a, cur, raw, c0, k, acc, last);
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (c0 + q < a.d) {
      a.tot[b * a.d + c0 + q] = acc[q];
      a.cbl[b * a.d + c0 + q] = last[q];
    }
  }
}

__global__ void __launch_bounds__(kChainThreads)
    xla_block_offsets(const Args a) {
  __shared__ float win[kChainWindow * kChainCols];
  const int j0 = blockIdx.x * kChainCols, tid = threadIdx.x;
  const int cols = a.d - j0 < kChainCols ? a.d - j0 : kChainCols;
  float incl = 0.0f;
  for (long long w0 = 0; w0 < a.nb; w0 += kChainWindow) {
    const int m = static_cast<int>(lmin(kChainWindow, a.nb - w0));
    for (int i = tid; i < m * kChainCols; i += kChainThreads) {
      const int j = i % kChainCols;
      if (j < cols) win[i] = a.tot[(w0 + i / kChainCols) * a.d + j0 + j];
    }
    __syncthreads();
    if (tid < cols) {
#pragma unroll 8
      for (int j = 0; j < m; ++j) {
        const float t = win[j * kChainCols + tid];
        incl = __fadd_rn(incl, t);
        win[j * kChainCols + tid] = __fsub_rn(incl, t);
      }
    }
    __syncthreads();
    for (int i = tid; i < m * kChainCols; i += kChainThreads) {
      const int j = i % kChainCols;
      if (j < cols) a.off[(w0 + i / kChainCols) * a.d + j0 + j] = win[i];
    }
    __syncthreads();
  }
}

template <int P, bool kOutVec, bool kPacked>
__global__ void __launch_bounds__(kWarps * 32) xla_run_rows(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= a.nb) return;
  const long long k0 = __ldg(a.k0 + b);
  const long long k1 = lmin(k0 + __ldg(a.cnt + b), a.capr);
  if (k0 >= k1) return;
  const int c0 = lane * P;
  // the c before the first slot: the nearest earlier block with a real
  // run end, its cumsum there plus its offset (0 if there is none)
  long long bp = -1;
  for (long long e = b - 1; e >= 0 && bp < 0; e -= 32) {
    const long long q = e - lane;
    const unsigned has = __ballot_sync(kFull, q >= 0 && __ldg(a.cnt + q) > 0);
    if (has) bp = e - (__ffs(has) - 1);
  }
  float off[P], prev[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const bool in = c0 + q < a.d;
    off[q] = in ? a.off[b * a.d + c0 + q] : 0.0f;
    prev[q] = in && bp >= 0 ? __fadd_rn(a.cbl[bp * a.d + c0 + q],
                                        a.off[bp * a.d + c0 + q])
                            : 0.0f;
  }
  for (long long k = k0; k < k1; k += kSlotBatch) {
    const int nk = static_cast<int>(lmin(kSlotBatch, k1 - k));
    float cb[kSlotBatch][P];
#pragma unroll
    for (int s = 0; s < kSlotBatch; ++s)
      if (s < nk)
        load_f32<P>(a.rows + (k + s) * a.width + c0, c0, a.d, kOutVec,
                    cb[s]);
#pragma unroll
    for (int s = 0; s < kSlotBatch; ++s) {
      if (s >= nk) break;
      float row[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float cq = __fadd_rn(cb[s][q], off[q]);
        row[q] = __fsub_rn(cq, prev[q]);
        prev[q] = cq;
      }
      write_row<P, kOutVec, kPacked>(a, k + s, c0, row);
    }
  }
}

template <typename T, int P, bool kVec>
cudaError_t launch(const Args& a, bool packed, cudaStream_t s) {
  // the block sums' warps past the blocks fill the junk slots
  const long long sum_warps = a.nb + (a.capr + kFillSlots - 1) / kFillSlots;
  xla_end_counts<<<static_cast<unsigned>((a.nb + kCountWarps - 1) /
                                         kCountWarps),
                   kCountWarps * 32, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  xla_end_slots<<<1, kSlotThreads, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  xla_block_sums<T, P, kVec>
      <<<static_cast<unsigned>((sum_warps + kWarps - 1) / kWarps),
         kWarps * 32, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  xla_block_offsets<<<(a.d + kChainCols - 1) / kChainCols, kChainThreads, 0,
                      s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const unsigned row_blocks =
      static_cast<unsigned>((a.nb + kWarps - 1) / kWarps);
  if (packed)
    xla_run_rows<P, true, true><<<row_blocks, kWarps * 32, 0, s>>>(a);
  else if (a.out_vec)
    xla_run_rows<P, true, false><<<row_blocks, kWarps * 32, 0, s>>>(a);
  else
    xla_run_rows<P, false, false><<<row_blocks, kWarps * 32, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_type(Args& a, bool packed, uintptr_t g, cudaStream_t s) {
  const int p = a.d <= 64 ? 2 : 4;
  a.out_vec = a.width % p == 0;
  const bool vec = a.d % p == 0 && g % (p * Elem<T>::kBytes) == 0;
  if (p == 2)
    return vec ? launch<T, 2, true>(a, packed, s)
               : launch<T, 2, false>(a, packed, s);
  return vec ? launch<T, 4, true>(a, packed, s)
             : launch<T, 4, false>(a, packed, s);
}

}  // namespace

// ids [n0] int32, s_ids [n] int32, order [n] int64, g [n0, dim] (bf16 when
// bf16, else f32), tgt [capr] int32, rows [capr, 128] (packed) or
// [capr, dim] f32, overflow [1] int32; scratch: tot, cbl and off,
// [n / 1024, dim] f32 each, then 2·(n / 1024) + 1 int32 (counts, first
// slots, the total), as compact_xla.py `scratch_floats` sizes it; n a
// multiple of 1024, n0 <= n, 1 <= capr <= n.
extern "C" int compact_xla(const void* ids, const void* s_ids,
                           const void* order, const void* g, long long n0,
                           long long n, int dim, int bf16, int vocab,
                           long long capr, int packed, void* tgt, void* rows,
                           void* overflow, void* scratch, void* stream) {
  if (dim < 1 || dim > (packed ? kMaxPackedDim : kLanes) || n < kBlockRows || n % kBlockRows != 0 ||
      n >= (1ll << 31) || n0 < 1 || n0 > n || capr < 1 || capr > n)
    return cudaErrorInvalidValue;
  Args a;
  a.ids = static_cast<const int*>(ids);
  a.s_ids = static_cast<const int*>(s_ids);
  a.order = static_cast<const long long*>(order);
  a.g = g;
  a.n0 = n0;
  a.n = n;
  a.nb = n / kBlockRows;
  a.capr = capr;
  a.d = dim;
  a.vocab = vocab;
  a.width = packed ? kLanes : dim;
  a.tgt = static_cast<int*>(tgt);
  a.rows = static_cast<float*>(rows);
  a.overflow = static_cast<int*>(overflow);
  float* f = static_cast<float*>(scratch);
  const long long plane = a.nb * dim;
  a.tot = f;
  a.cbl = f + plane;
  a.off = f + 2 * plane;
  a.cnt = reinterpret_cast<int*>(f + 3 * plane);
  a.k0 = a.cnt + a.nb;
  a.total = a.k0 + a.nb;
  auto s = static_cast<cudaStream_t>(stream);
  const auto gp = reinterpret_cast<uintptr_t>(g);
  const cudaError_t e =
      bf16 ? launch_type<__nv_bfloat16>(a, packed != 0, gp, s)
           : launch_type<float>(a, packed != 0, gp, s);
  return static_cast<int>(e);
}

extern "C" const char* compact_xla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
