// Fused gather + sum/mean pool over the K ids of each batch row.
//
// Replaces: goctr_tpu/ops/pallas/embedding_lookup.py::_kernel /
// fused_gather_pool_pallas (pallas_call at :106), the forward of the
// custom VJP gather_pool_mean (:146-178), and fused_gather_pool_jnp
// (:114-122), the path JAX takes at the trainer's shapes (D = 64 fails
// the TPU kernel's D % 128 gate).
//
//   out[b] = sum_k [ids[b,k] >= 0] * table[ids[b,k]]        (sum)
//   out[b] = that / max(#{k : ids[b,k] >= 0}, 1)            (mean)
//
// or, with F bags a row at column offsets off[0] = 0 <= ... <= off[F] = K
// (DLRM's multi-hot features), out[b, f] the same over k in
// [off[f], off[f+1]): each (b, f) is a bag of its own, pooled by the same
// code as a batch row (bag r = b * F + f reads ids[b, off[f]:off[f+1]] and
// writes out row r), so F = 1 with no offsets is the one-bag pool, add for
// add.
//
// table [V, D] f32, ids [B, K] int32 (-1 = pad), out [B, D] or [B, F, D]
// f32. Pads add
// nothing and a fully padded row gives 0; an id >= V is never read and adds
// a NaN row (what `jnp.take` returns for it, and what K1 returns), but it
// counts as valid, as in the JAX function. The TPU kernel's three gates
// (D % 128 == 0, B % 8 == 0, K >= 8) are Mosaic tiling limits, not
// semantics: this kernel takes any B, any K and any D >= 1.
//
// What bounds it on the H100: bytes. Each batch row reads its K ids and
// the table rows of its real ones (D * 4 bytes each, 256 B at D = 64) from
// random places of a table that may not fit in L2, and writes D * 4 bytes;
// the adds are ~K * D flops, far under the card's rate. Counting the ids
// and the output once and each distinct row once: at the dense trainer's
// shape (B = 65,536, K = 32, D = 64, no pads, zipf ids over 10M rows) 8.4
// MB of ids, 16.8 MB of output and ~0.5M distinct rows (~130 MB), ~0.046
// ms at 3.35 TB/s; on each rank of the mesh 2×2 (B = 32,768, K = 32, about
// half the ids masked to -1 as another shard's, a [500k, 64] shard) 4.2 MB
// of ids, 8.4 MB of output and ~99k distinct rows (~25 MB), ~0.0113 ms.
// Reading every occurrence from HBM would take 3-4× that; hot rows repeat
// enough that L2 serves much of it.
// What the earlier design lost: one warp a batch row ran every slot of
// each 32-id chunk, kUnroll x slots of them a round, a pad holding its
// place in the round without a load. On the mesh half the ids are pads;
// but on the H100 80GB HBM3 (700 W) that design took only 1.02-1.06x its
// own time on the same rows with their real ids first
// (scripts/gather_pool_sweep.py): its empty slots cost little. What its
// time went on was the shape of a warp's work, one batch row on 32 lanes
// (at D = 64 two table rows a load instruction, combined by shuffles at
// the end): the same compaction on that shape ran within 3% of it.
// Design: kWarpsPerBlock = 4 warps a block, kRowsPerWarp = 4 batch rows
// a warp, each on 8 lanes: a table row is covered by at most kLanesPerRow
// = 8 lanes, a lane loading up to kLaneFloats = 8 floats of it a pass (at
// D = 64 two float4; a wider row takes more column passes, a narrower one
// fewer lanes and so more slots a row). For each window of up to kWindow
// ids of its rows the warp first compacts each row's real ids: the ids
// are read once, coalesced (lane j id j of each 32), a ballot marks the
// ids >= 0, each real id goes to its place in the row's list in shared
// memory (the popcount of the ballot under the lane's lanemask_lt), in
// order, and the count of valid ids is the popcount of the same ballots.
// Then each row's lanes, cut into slots of lpr lanes (a slot covers one
// table row with 16-byte float4 loads, float2 or scalar where D or the
// pointers do not allow it), walk the row's list in rounds of kUnroll
// entries a slot whose loads are all issued before any add:
// ceil(real / (kUnroll * slots)) rounds, so every load slot of a round
// but the last holds a real row. A row's slots are combined by xor
// shuffles; the first slot divides (IEEE division, as JAX's `/`) and
// writes. A row wider than lpr * kLaneFloats floats is pooled in column
// chunks (the windows run again a chunk). The [B, K, D] rows never leave
// registers. The TPU kernel's double-buffered row DMAs have no
// counterpart to port: many warps in flight hide the latency instead.
// Each slot adds its rows in list order and the slots are combined by a
// butterfly, so the sum is not bit-exact with the plain version's
// (another order of the same f32 adds; within f32 TOL).
// Plain version: fused_gather_pool_plain in
// goctr_tpu_torch/ops/kernels/embedding_lookup.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kRowsPerWarp = 4;   // batch rows a warp, where they fit
constexpr int kLanesPerRow = 8;   // at most, lanes covering one table row
constexpr int kLaneFloats = 8;    // at most, floats a lane loads of a row
constexpr int kUnroll = 4;        // list entries a slot loads a round
constexpr int kWindow = 128;      // ids of a batch row compacted at once
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]);
template <>
__device__ __forceinline__ void load<1>(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load<2>(const float* p, float (&v)[2]) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = t.x;
  v[1] = t.y;
}
template <>
__device__ __forceinline__ void load<4>(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]);
template <>
__device__ __forceinline__ void store<1>(float* p, const float (&v)[1]) {
  *p = v[0];
}
template <>
__device__ __forceinline__ void store<2>(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <>
__device__ __forceinline__ void store<4>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A bag's ids: they start at ids + start and are len long (bag r of F a
// batch row at column offsets off, or with off null row r's K ids).
__device__ __forceinline__ void bag(const int* __restrict__ off, int n_feat,
                                    int k, long long r, long long& start,
                                    int& len) {
  if (off == nullptr) {
    start = r * k;
    len = k;
  } else {
    const int f = static_cast<int>(r % n_feat);
    const int o0 = __ldg(off + f);
    start = (r / n_feat) * k + o0;
    len = __ldg(off + f + 1) - o0;
  }
}

// VEC floats a load, CH loads a lane per table row (lpr lanes cover a
// chunk of cw = CH * lpr * VEC columns; the chunks cover D), MEAN divides
// by the valid count; rpw bags a warp (kRowsPerWarp, halved until
// rpw * lpr <= 32), each on 32 / rpw lanes. A bag is a batch row, or one
// of its F bags at column offsets `off` (n_feat = F).
template <int VEC, int CH, bool MEAN>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_pool_kernel(const float* __restrict__ table,
                   const int* __restrict__ ids, float* __restrict__ out,
                   long long bags, int k, long long n_rows, int dim,
                   int lpr, int cw, int rpw, const int* __restrict__ off,
                   int n_feat) {
  __shared__ int lists[kWarpsPerBlock][kRowsPerWarp][kWindow];
  const int warp = threadIdx.x / 32;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp) * rpw;
  if (row0 >= bags) return;  // the whole warp: its rows start at row0
  // each of the warp's bags' ids, the same on every lane, and the longest
  long long starts[kRowsPerWarp];
  int lens[kRowsPerWarp];
  int kmax = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    starts[r] = 0;
    lens[r] = 0;
    if (r < rpw && row0 + r < bags)
      bag(off, n_feat, k, row0 + r, starts[r], lens[r]);
    kmax = max(kmax, lens[r]);
  }
  const int lane = threadIdx.x & 31;
  const int glanes = 32 / rpw;         // lanes of one bag
  const int grp = lane / glanes;       // which of the warp's rows
  const int slot = (lane % glanes) / lpr;
  const int col = lane % lpr;
  const int slots = glanes / lpr;
  const long long row = row0 + grp;
  const unsigned lt = lanemask_lt();
  const float nan = __int_as_float(0x7fc00000);
  const int* list = lists[warp][grp];
  for (int c0 = 0; c0 < dim; c0 += cw) {
    float acc[CH][VEC];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[c][e] = 0.f;
    int count = 0;  // valid ids of this lane's row (ids >= V included)
    for (int w0 = 0; w0 < kmax; w0 += kWindow) {
      // the window's ids of each of the warp's rows, read before any
      // ballot so that the loads overlap
      int my[kRowsPerWarp][kWindow / 32];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int q = 0; q < kWindow / 32; ++q) {
          const int j = q * 32 + lane;
          const bool in = j < min(kWindow, lens[r] - w0);
          my[r][q] = in ? __ldg(ids + starts[r] + w0 + j) : -1;
        }
      const int nq = (min(kWindow, kmax - w0) + 31) / 32;  // on every lane
      int n_real = 0;  // list entries of this lane's row
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        int base = 0;
#pragma unroll
        for (int q = 0; q < kWindow / 32; ++q) {
          if (q >= nq) break;
          const unsigned real = __ballot_sync(kFull, my[r][q] >= 0);
          if (my[r][q] >= 0) lists[warp][r][base + __popc(real & lt)] =
              my[r][q];
          base += __popc(real);
        }
        if (r == grp) n_real = base;
      }
      count += n_real;
      __syncwarp();
      for (int j0 = 0; j0 < n_real; j0 += slots * kUnroll) {
        float v[kUnroll][CH][VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * slots + slot;
          const bool live = j < n_real;
          const int id = live ? list[j] : 0;
          const float* src = table + static_cast<long long>(id) * dim;
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const int d0 = c0 + (col + c * lpr) * VEC;
            if (live && d0 < dim && id < n_rows) {
              load<VEC>(src + d0, v[u][c]);
            } else {
              const float fill = live ? nan : 0.f;  // id >= V: a NaN row
#pragma unroll
              for (int e = 0; e < VEC; ++e) v[u][c][e] = fill;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int c = 0; c < CH; ++c)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[c][e] += v[u][c][e];
      }
      __syncwarp();  // the next window rewrites the lists
    }
    // combine the slots: lanes lpr apart (inside a row's lanes) hold the
    // same columns
    for (int off = lpr; off < glanes; off <<= 1)
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[c][e] += __shfl_xor_sync(kFull, acc[c][e], off);
    if (slot == 0 && row < bags) {
      const float denom = fmaxf(static_cast<float>(count), 1.f);
      float* dst = out + row * dim;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int d0 = c0 + (col + c * lpr) * VEC;
        if (d0 >= dim) continue;
        float r[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          r[e] = MEAN ? acc[c][e] / denom : acc[c][e];
        store<VEC>(dst + d0, r);
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int VEC, int CH>
void launch_vc(const float* t, const int* i, float* o, long long batch,
               int k, long long n_rows, int dim, int lpr, bool mean,
               const int* off, int nf, cudaStream_t s) {
  const int cw = CH * lpr * VEC;
  int rpw = kRowsPerWarp;  // a power of two
  while (rpw * lpr > 32) rpw >>= 1;
  const long long per_block = static_cast<long long>(kWarpsPerBlock) * rpw;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((batch + per_block - 1) / per_block));
  if (mean) {
    gather_pool_kernel<VEC, CH, true><<<grid, block, 0, s>>>(
        t, i, o, batch, k, n_rows, dim, lpr, cw, rpw, off, nf);
  } else {
    gather_pool_kernel<VEC, CH, false><<<grid, block, 0, s>>>(
        t, i, o, batch, k, n_rows, dim, lpr, cw, rpw, off, nf);
  }
}

// the instance of `ch` loads a lane per row: CH = 1, 2, 4, ... while
// CH * VEC <= kLaneFloats
template <int VEC, int CH = 1>
void launch_ch(int ch, const float* t, const int* i, float* o,
               long long batch, int k, long long n_rows, int dim, int lpr,
               bool mean, const int* off, int nf, cudaStream_t s) {
  if constexpr (CH * VEC <= kLaneFloats) {
    if (ch == CH) {
      launch_vc<VEC, CH>(t, i, o, batch, k, n_rows, dim, lpr, mean, off, nf,
                         s);
    } else {
      launch_ch<VEC, CH * 2>(ch, t, i, o, batch, k, n_rows, dim, lpr, mean,
                             off, nf, s);
    }
  }
}

template <int VEC>
void launch_v(const float* t, const int* i, float* o, long long batch,
              int k, long long n_rows, int dim, bool mean, const int* off,
              int nf, cudaStream_t s) {
  const int nvec = dim / VEC;
  int lpr = 1;
  while (lpr < nvec && lpr < kLanesPerRow) lpr <<= 1;
  // loads a lane per row a column chunk; wider rows take more chunks
  int ch = 1;
  while (ch * lpr < nvec && 2 * ch * VEC <= kLaneFloats) ch <<= 1;
  launch_ch<VEC>(ch, t, i, o, batch, k, n_rows, dim, lpr, mean, off, nf, s);
}

}  // namespace

// table [n_rows, dim] f32, ids [batch, k] int32, out [batch, n_feat, dim]
// f32; off null (n_feat 1: one bag a row) or [n_feat + 1] int32 column
// offsets on the device, 0 = off[0] <= ... <= off[n_feat] = k; mean != 0
// divides by the valid count. Returns cudaGetLastError().
extern "C" int gather_pool_f32(const void* table, const void* ids, void* out,
                               long long batch, int k, long long n_rows,
                               int dim, int mean, const void* off,
                               int n_feat, void* stream) {
  if (dim < 1 || k < 0 || n_feat < 1 || (off == nullptr && n_feat != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0) return 0;
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int*>(ids);
  auto* o = static_cast<float*>(out);
  const auto* f = static_cast<const int*>(off);
  const long long bags = batch * n_feat;
  auto s = static_cast<cudaStream_t>(stream);
  if (dim % 4 == 0 && aligned(table, 16) && aligned(out, 16)) {
    launch_v<4>(t, i, o, bags, k, n_rows, dim, mean != 0, f, n_feat, s);
  } else if (dim % 2 == 0 && aligned(table, 8) && aligned(out, 8)) {
    launch_v<2>(t, i, o, bags, k, n_rows, dim, mean != 0, f, n_feat, s);
  } else {
    launch_v<1>(t, i, o, bags, k, n_rows, dim, mean != 0, f, n_feat, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
