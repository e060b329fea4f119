// Run-sum compaction of the sorted update stream (K9).
//
// Replaces: goctr_tpu/ops/pallas/compact.py::_kernel /
// compact_runsums_block (pallas_call at :129), the compact_impl="kernel"
// front end of the fused table update (goctr_tpu/parallel/scanned.py:
// 288-294).
//
// Input: ids [n] int32 sorted ascending (pads carry id `vocab` and sort
// last), their gradient rows g [n, D] f32 (D < 127), and capr. Output:
//   tgt  [capr] int32: the ids of the real runs (id < vocab), in id order,
//        then junk targets vocab + 1 + k for the slots k past them;
//   rows [capr, 128] f32: Σg of each run | ‖Σg‖² | 0 ... (junk slots 0);
//   overflow [1] int32: max(#real runs − capr, 0) — those runs' updates
//        are dropped, as in the JAX kernel.
//
// What bounds it on the H100: bytes. It reads the ids and the gradient
// rows once and writes capr 512-byte rows and their targets. At the
// headline step (n = 2,162,688, D = 64, capr = 596,992) that is 8.7 MB +
// 553.6 MB + 308.0 MB = 870 MB, 0.260 ms at 3.35 TB/s; at the grouped
// 100M × 16 step (D = 16, capr = 768,000) 8.7 + 138.4 + 396.3 = 543 MB,
// 0.162 ms: there the output is 73% of the bytes. The adds (n·D) are far
// below the card's f32 rate.
//
// Design: the TPU kernel walks 512-row blocks in grid order, carries the
// open run's sum from block to block in VMEM scratch (:90-95) and writes
// each block's [512, 128] rows whole, ‖Σg‖² included (:85-89). CUDA
// blocks run in no fixed order, so this kernel is one ordered pass, one
// warp a 128-row tile, and writes each output row once, with no
// read-back:
//   - ticket: a warp takes its tile from an atomic counter, not from
//     blockIdx, so a tile only ever waits on tiles that running warps
//     already hold (no deadlock, whatever order the blocks start in);
//   - ids: the tile's 128 ids are read once (four coalesced loads a lane,
//     the neighbours by shuffle); the warp publishes its tile word at
//     once: its real-run count and whether a run starts in the tile;
//   - slots: its first output slot is a decoupled look-back over the
//     predecessors' words; the counts are integers, so the prefix is
//     exact in any order. It then writes its targets;
//   - rows: a ring of kStages bulk copies of up to 2 KB each
//     (csrc/bulk_copy.cuh), issued right after the ticket, brings the
//     tile's rows into shared memory. Lanes are (row, 4-dim group) pairs,
//     R = 32 / ceil(D/4) rows (a power of 2) a step, so no lane idles at
//     D <= 32 (D = 16: 8 rows a warp instruction); each step's run sums
//     are a segmented scan over its R rows by shuffles, added to the open
//     run's sum, in an order that depends on the data alone;
//   - output: each run that ends in the tile is written once, as its full
//     512-byte row (Σg, ‖Σg‖² in lane D, zeros), one 16-byte streaming
//     store a lane (st.global.cs);
//   - carry: only a tile whose first run began before it and ends in it
//     (a real run with a slot) needs one. Every tile whose last row leaves
//     a run open stores that run's part (its tail) before it waits for
//     anything. The tails start as a NaN that no sum produces (one memset
//     sets the scratch to all ones), so a tail is its own flag and needs
//     no fence. The carry is the sum of the tails from the nearest
//     earlier tile in which a run starts up to the tile before, added in
//     an order fixed by the data (lanes over (tail, 4-dim group), then
//     the partial sums in order), so a run repeats bit for bit.
//     Pass-through tiles write no slot and wait for nothing;
//   - junk: the slots [total, capr) and `overflow` need the total, which
//     only the last tile knows: the warps whose tickets follow the last
//     tile's wait for its word and fill them.
// A call is two device operations: the memset of the scratch (8 B a tile
// and its tail) and the pass. kUseRing, kStages, kTileRows, kFillInPass,
// kLookBack, kTailsInFlight and kMinBlocks are the choices that
// scripts/gather_run_sweep.py varies; kProfile turns on clock64 phase
// timers for it. On the H100 (PERF.md §6) the pass moves ~2.5 TB/s at
// D = 64, where PyTorch's own copy reaches 3.0; at D = 16 each tile's
// waits (ticket, ids, look-back) weigh more against its 8 KB of rows.
// ptxas (nvcc 12.9, sm_90a; `_build.resources("compact_runsums")`):
// pass_kernel<kRing>, the main path's, 64 registers (kMinBlocks caps
// them: 8 blocks of 4 warps an SM), no spills, and per warp 2 stages of
// up to 2 KB + 128 B of dynamic shared memory; pass_kernel<kRegs> and
// <kScalar> 64 registers and 8 bytes of spills; fill_kernel 32.
// The sums run in another association than the plain version's
// index_add_: they agree to f32 rounding (RUNSUM_RTOL), not bit for bit.
// Plain version: compact_runsums_plain in
// goctr_tpu_torch/ops/kernels/compact.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kTileRows = 128;        // rows a tile (compact.py: TILE_ROWS)
constexpr int kChunks = kTileRows / 32;  // 32-row chunks of the ids
constexpr int kLanes = 128;
constexpr int kWarps = 4;             // warps a block
constexpr int kMinBlocks = 8;         // blocks an SM: <= 64 registers
constexpr int kLoads = 4;             // steps a batch (a ring part's most)
constexpr int kTailsInFlight = 8;     // tails a lane loads at once
constexpr int kLookBack = 1;          // windows of 32 tile words at once
constexpr int kStages = 2;            // ring stages a warp
constexpr int kStageBytes = 2048;     // a ring stage's most bytes
constexpr bool kUseRing = true;       // rows through bulk copies to smem
constexpr bool kFillInPass = true;    // junk slots by the pass's warps
constexpr bool kProfile = false;      // phase timers (k9_prof)
constexpr int kFillSlots = 512;       // junk slots an extra warp is for
constexpr int kFillChunk = 64;        // slots a warp of the fill launch
constexpr unsigned kFull = 0xffffffffu;

// A tile's word: flags in the top bits, a count or prefix below. The
// scratch starts as all ones (one memset), which reads as "nothing yet"
// in a word and as kUnset in a tail's floats.
constexpr unsigned long long kAgg = 1ull << 62;     // real-run count
constexpr unsigned long long kPrefix = 2ull << 62;  // inclusive prefix
constexpr unsigned long long kFlags = 3ull << 62;   // both: nothing yet
constexpr unsigned long long kHasStart = 1ull << 61;  // a run starts here
constexpr unsigned long long kValue = 0xffffffffull;
// A float no tail holds: a tail is stored as x + 0, so a NaN is stored
// as the canonical NaN 0x7fffffff, never as this one.
constexpr unsigned kUnset = 0xffffffffu;

enum Route { kRegs, kScalar, kRing };

struct Args {
  const int* ids;
  const float* g;
  long long n;
  int d, vocab;
  long long capr;
  int* tgt;
  float* rows;
  int* overflow;
  unsigned long long* status;  // n_tiles words, then the ticket
  float* tails;                // [n_tiles, 4·c]
  long long n_tiles, n_fill;   // n_fill: extra warps that fill junk
  int c, r;                    // float4 groups a row; rows a step
  int part_rows;               // ring route: rows a stage, and
  int stage_bytes, warp_smem;  // its bytes; shared memory a warp
};

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float4 load_tail(const float* p) {
  float4 v;
  asm volatile("ld.relaxed.gpu.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_tail(float* p, float4 v) {
  asm volatile("st.relaxed.gpu.global.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ bool unset(float4 v) {
  return __float_as_uint(v.x) == kUnset || __float_as_uint(v.y) == kUnset ||
         __float_as_uint(v.z) == kUnset || __float_as_uint(v.w) == kUnset;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

__device__ __forceinline__ float4 shfl_up4(float4 v, int delta) {
  return make_float4(__shfl_up_sync(kFull, v.x, delta),
                     __shfl_up_sync(kFull, v.y, delta),
                     __shfl_up_sync(kFull, v.z, delta),
                     __shfl_up_sync(kFull, v.w, delta));
}

__device__ __forceinline__ void store_stream(float* p, float4 v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// m[i] for an index the code does not know at compile time, with no
// local memory
template <typename T>
__device__ __forceinline__ T pick(const T (&m)[kChunks], int i) {
  T v = m[0];
#pragma unroll
  for (int k = 1; k < kChunks; ++k)
    if (i == k) v = m[k];
  return v;
}

// A tile as its warp sees it: per 32-row chunk, the ballots of the rows
// that start a run and of those that end a real one, the real ends
// before the chunk, and this lane's id.
struct Tile {
  long long s;     // its first row
  int rows;        // rows in the tile (128 but in the last)
  unsigned start[kChunks], real[kChunks];
  int pre[kChunks];
  int id[kChunks];
  int cnt;         // real runs that end in the tile
  bool any_start;
  bool open_end;   // its last row does not end a run
};

// The tile's 128 ids (and its neighbours: ids[s − 1] in lane 0, the id
// after the tile in lane 31), loaded; flag_ids reads them.
__device__ __forceinline__ void load_ids(const Args& a, Tile& tl, int lane,
                                         int& edge) {
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int row = 32 * k + lane;
    tl.id[k] = row < tl.rows ? __ldg(a.ids + tl.s + row) : 0;
  }
  edge = 0;
  if (lane == 0 && tl.s > 0) edge = __ldg(a.ids + tl.s - 1);
  if (lane == 31 && tl.s + tl.rows < a.n) edge = __ldg(a.ids + tl.s + tl.rows);
}

__device__ __forceinline__ void flag_ids(const Args& a, Tile& tl, int lane,
                                         int edge) {
  const int before = __shfl_sync(kFull, edge, 0);
  const int after = __shfl_sync(kFull, edge, 31);
  tl.cnt = 0;
  tl.open_end = false;
  unsigned any = 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int row = 32 * k + lane;
    const long long j = tl.s + row;
    const int id = tl.id[k];
    const int last_prev = __shfl_sync(kFull, tl.id[k > 0 ? k - 1 : 0], 31);
    const int first_next =
        __shfl_sync(kFull, tl.id[k + 1 < kChunks ? k + 1 : k], 0);
    int prev = __shfl_up_sync(kFull, id, 1);
    int next = __shfl_down_sync(kFull, id, 1);
    if (lane == 0) prev = k > 0 ? last_prev : before;
    if (lane == 31) next = first_next;
    if (row == tl.rows - 1) next = after;
    const bool valid = row < tl.rows;
    const bool st = valid && (j == 0 || prev != id);
    const bool en = valid && (j == a.n - 1 || next != id);
    tl.start[k] = __ballot_sync(kFull, st);
    tl.real[k] = __ballot_sync(kFull, en && id < a.vocab);
    if (__ballot_sync(kFull, row == tl.rows - 1 && !en)) tl.open_end = true;
    tl.pre[k] = tl.cnt;
    tl.cnt += __popc(tl.real[k]);
    any |= tl.start[k];
  }
  tl.any_start = any != 0;
}

// The words of tiles base − 32k − lane (k < kLookBack), loaded at once;
// tiles before the first read as `before`.
__device__ __forceinline__ void load_words(const Args& a, long long base,
                                           int lane, unsigned long long before,
                                           unsigned long long (&w)[kLookBack]) {
#pragma unroll
  for (int k = 0; k < kLookBack; ++k) {
    const long long u = base - 32 * k - lane;
    w[k] = u < 0 ? before : load_word(a.status + u);
  }
}

// The tile's first output slot: the real runs of all tiles before it, by
// a decoupled look-back over their words, 32·kLookBack a round trip (lane
// i of window k reads tile t − 1 − 32k − i): the counts back to the
// nearest published prefix.
__device__ long long look_back(const Args& a, long long t, int lane) {
  long long excl = 0;
  for (long long base = t - 1;; base -= 32 * kLookBack) {
    unsigned long long w[kLookBack];
    load_words(a, base, lane, kPrefix, w);
#pragma unroll
    for (int k = 0; k < kLookBack; ++k) {
      while (true) {
        const unsigned waiting =
            __ballot_sync(kFull, (w[k] & kFlags) == kFlags);
        const unsigned done =
            __ballot_sync(kFull, (w[k] & kFlags) == kPrefix);
        const unsigned upto = done ? (done ^ (done - 1)) : kFull;
        if ((waiting & upto) == 0) {
          long long v = (upto >> lane) & 1u
                            ? static_cast<long long>(w[k] & kValue) : 0;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
          excl += v;
          if (done) return excl;
          break;
        }
        if ((w[k] & kFlags) == kFlags)
          w[k] = load_word(a.status + (base - 32 * k - lane));
      }
    }
  }
}

// The nearest tile before t in which a run starts: the words back to the
// first one with kHasStart, each waited for until it is published;
// 32·kLookBack words a round trip.
__device__ long long run_start_tile(const Args& a, long long t, int lane) {
  for (long long base = t - 1;; base -= 32 * kLookBack) {
    unsigned long long w[kLookBack];
    load_words(a, base, lane, kAgg | kHasStart, w);
#pragma unroll
    for (int k = 0; k < kLookBack; ++k) {
      while (true) {
        const unsigned waiting =
            __ballot_sync(kFull, (w[k] & kFlags) == kFlags);
        const unsigned starts =
            __ballot_sync(kFull, (w[k] & kFlags) != kFlags &&
                                     (w[k] & kHasStart) != 0);
        // lanes 0 … (first lane still waiting) − 1
        const unsigned lead =
            waiting ? (waiting & (0u - waiting)) - 1u : kFull;
        const unsigned found = starts & lead;
        if (found) return base - 32 * k - (__ffs(found) - 1);
        if (lead == kFull) break;
        if ((w[k] & kFlags) == kFlags)
          w[k] = load_word(a.status + (base - 32 * k - lane));
      }
    }
  }
}

// The sum of the tails of tiles [u0, t): lane (q, c) sums tails u0 + q,
// u0 + q + r, … of float4 group c in order, kTailsInFlight loads at once,
// each loaded again until its tile has stored it (no float of it kUnset);
// then the r partial sums in q order. Every lane returns the sum of its
// group c. Every tile from u0 to t − 1 leaves the run open at its last
// row, so each stores its tail.
__device__ float4 sum_tails(const Args& a, long long u0, long long t,
                            int rr, int cc) {
  const bool act = rr < a.r;
  float4 acc = zero4();
  for (long long b = u0; b < t;
       b += static_cast<long long>(a.r) * kTailsInFlight) {
    float4 v[kTailsInFlight];
#pragma unroll
    for (int k = 0; k < kTailsInFlight; ++k) {
      const long long u = b + static_cast<long long>(k) * a.r + rr;
      v[k] = act && u < t ? load_tail(a.tails + u * 4 * a.c + 4 * cc)
                          : zero4();
    }
#pragma unroll
    for (int k = 0; k < kTailsInFlight; ++k) {
      const long long u = b + static_cast<long long>(k) * a.r + rr;
      while (unset(v[k])) v[k] = load_tail(a.tails + u * 4 * a.c + 4 * cc);
    }
#pragma unroll
    for (int k = 0; k < kTailsInFlight; ++k) acc = add4(acc, v[k]);
  }
  float4 total = shfl4(acc, cc);
  for (int q = 1; q < a.r; ++q) total = add4(total, shfl4(acc, q * a.c + cc));
  return total;
}

// Slot `slot`'s full row from x (lane l holds dims 4l … 4l + 3 of Σg,
// zero past D): Σg, ‖Σg‖² in lane D, zeros; one 16-byte store a lane.
__device__ __forceinline__ void write_row(const Args& a, long long slot,
                                          float4 x, int lane) {
  float sq = __fmul_rn(x.x, x.x);
  sq = __fmaf_rn(x.y, x.y, sq);
  sq = __fmaf_rn(x.z, x.z, sq);
  sq = __fmaf_rn(x.w, x.w, sq);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq = __fadd_rn(sq, __shfl_xor_sync(kFull, sq, o));
  const int b = 4 * lane;
  const int d = a.d;
  if (b >= d) x.x = b == d ? sq : 0.f;
  if (b + 1 >= d) x.y = b + 1 == d ? sq : 0.f;
  if (b + 2 >= d) x.z = b + 2 == d ? sq : 0.f;
  if (b + 3 >= d) x.w = b + 3 == d ? sq : 0.f;
  store_stream(a.rows + slot * kLanes + b, x);
}

// The warp's walk over its tile's rows.
struct Walk {
  float4 run;           // the open run's sum so far (lane: its group)
  float4 held;          // the tile's first run's part, while it waits
  long long held_slot;  // for its carry (−1: none)
};

// One step: rows b … b + r − 1 of the tile, lane (rr, cc) holding group
// cc of row b + rr in v (zero past the tile or past D).
__device__ __forceinline__ void walk_step(const Args& a, const Tile& tl,
                                          long long first, bool carried,
                                          int b, float4 v, Walk& w, int lane,
                                          int rr, int cc) {
  const int row = b + rr;
  const int chunk = b >> 5, off = b & 31;
  const unsigned step_mask = a.r == 32 ? kFull : (1u << a.r) - 1u;
  bool h = rr < a.r && row < tl.rows &&
           ((pick(tl.start, chunk) >> (off + rr)) & 1u);
  // segmented inclusive scan over the step's rows (a run start cuts it)
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o >= a.r) break;
    const float4 u = shfl_up4(v, o * a.c);
    const bool hu = __shfl_up_sync(kFull, h ? 1 : 0, o * a.c) != 0;
    if (rr >= o) {
      if (!h) v = add4(u, v);
      h = h || hu;
    }
  }
  if (!h) v = add4(w.run, v);
  w.run = shfl4(v, (a.r - 1) * a.c + cc);
  unsigned reals = (pick(tl.real, chunk) >> off) & step_mask;
  while (reals) {
    const int re = __ffs(reals) - 1;
    reals &= reals - 1;
    const int row_e = b + re;
    const int rank = pick(tl.pre, row_e >> 5) +
                     __popc(pick(tl.real, row_e >> 5) &
                            ((1u << (row_e & 31)) - 1u));
    const long long slot = first + rank;
    float4 x = shfl4(v, re * a.c + (lane < a.c ? lane : 0));
    if (lane >= a.c) x = zero4();
    if (rank == 0 && carried) {
      w.held = x;
      w.held_slot = slot < a.capr ? slot : -1;
    } else if (slot < a.capr) {
      write_row(a, slot, x, lane);
    }
  }
}

// Lane (rr, cc)'s float4 of row `row` of the tile from device memory
// (zero past the tile, past D, or for an idle lane).
template <Route kRoute>
__device__ __forceinline__ float4 load_row(const Args& a, const Tile& tl,
                                           int row, bool act, int cc) {
  float4 v = zero4();
  if (!act || row >= tl.rows) return v;
  const float* p = a.g + (tl.s + row) * a.d + 4 * cc;
  if constexpr (kRoute == kRegs) {
    v = __ldcs(reinterpret_cast<const float4*>(p));
  } else {
    const int left = a.d - 4 * cc;
    v.x = __ldcs(p);
    if (left > 1) v.y = __ldcs(p + 1);
    if (left > 2) v.z = __ldcs(p + 2);
    if (left > 3) v.w = __ldcs(p + 3);
  }
  return v;
}

// Phase timers, off in the committed build (scripts/gather_run_sweep.py
// builds a variant with kProfile on): each warp sums its clock64 cycles
// by phase and adds them to k9_prof once; k9_prof[kPhases] counts the
// carried tiles.
enum Phase { kBegin, kLookBackPhase, kWalk, kTailPhase, kCarryWait,
             kCarrySum, kFill, kPhases };
__device__ unsigned long long k9_prof[kPhases + 1];

struct Timers {
  long long last;
  unsigned long long c[kPhases];
  unsigned long long carried;
  __device__ __forceinline__ void start() {
    if constexpr (kProfile) {
      last = clock64();
#pragma unroll
      for (int i = 0; i < kPhases; ++i) c[i] = 0;
      carried = 0;
    }
  }
  __device__ __forceinline__ void mark(Phase i) {
    if constexpr (kProfile) {
      const long long now = clock64();
      c[i] += static_cast<unsigned long long>(now - last);
      last = now;
    }
  }
  __device__ __forceinline__ void flush(int lane) {
    if constexpr (kProfile) {
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kPhases; ++i) atomicAdd(&k9_prof[i], c[i]);
        atomicAdd(&k9_prof[kPhases], carried);
      }
    }
  }
};

// The warp's ring of kStages stages, each a buffer in shared memory and
// an mbarrier. Parts are issued (lane 0) and waited for (every lane) in
// one order across the warp's tiles, so part i sits in stage
// i % kStages and completes phase (i / kStages) & 1 of its barrier.
struct Ring {
  unsigned char* stages;
  uint64_t* bars;
  int issued, waited;
};

// Lane 0: part p (rows p·part_rows …) of the tile into the next stage,
// one bulk copy, if the tile has it.
__device__ __forceinline__ void issue_part(const Args& a, const Tile& tl,
                                           Ring& ring, int p) {
  const int p0 = p * a.part_rows;
  const int rows_p = tl.rows - p0 < a.part_rows ? tl.rows - p0 : a.part_rows;
  if (rows_p <= 0) return;
  const int st = ring.issued % kStages;
  bulk_copy::bulk_load(ring.stages + st * a.stage_bytes,
                       a.g + (tl.s + p0) * a.d,
                       static_cast<uint32_t>(rows_p * a.d * 4),
                       ring.bars + st);
  ++ring.issued;
}

__device__ __forceinline__ long long take_ticket(const Args& a, int lane) {
  long long t = 0;
  if (lane == 0)
    t = static_cast<long long>(atomicAdd(a.status + a.n_tiles, 1ull) + 1ull);
  return __shfl_sync(kFull, t, 0);
}

// Begin tile t: its ids' loads, then its first rows' (bulk copies or
// float4 loads into v), then its flags and its tile word.
template <Route kRoute>
__device__ __forceinline__ void begin_tile(const Args& a, long long t,
                                           Tile& tl, float4 (&v)[kLoads],
                                           Ring& ring, int lane, int rr,
                                           int cc, bool act) {
  tl.s = t * kTileRows;
  tl.rows = a.n - tl.s < kTileRows ? static_cast<int>(a.n - tl.s) : kTileRows;
  int edge;
  load_ids(a, tl, lane, edge);
  if constexpr (kRoute == kRing) {
    if (lane == 0)
      for (int p = 0; p < kStages; ++p) issue_part(a, tl, ring, p);
  } else {
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      v[k] = load_row<kRoute>(a, tl, k * a.r + rr, act, cc);
  }
  flag_ids(a, tl, lane, edge);
  if (lane == 0)
    store_word(a.status + t, kAgg | (tl.any_start ? kHasStart : 0ull) |
                                 static_cast<unsigned long long>(tl.cnt));
}

// Junk slots [total, capr): share f of n_fill, once the last tile has
// published the total.
__device__ void fill_junk(const Args& a, long long f, int lane) {
  const unsigned long long* last = a.status + a.n_tiles - 1;
  unsigned long long w = load_word(last);
  while ((w & kFlags) != kPrefix) {
    __nanosleep(256);
    w = load_word(last);
  }
  const long long total = static_cast<long long>(w & kValue);
  const long long junk = a.capr - total;
  if (junk <= 0) return;
  const long long span = (junk + a.n_fill - 1) / a.n_fill;
  const long long k0 = total + f * span;
  const long long k1 = k0 + span < a.capr ? k0 + span : a.capr;
  for (long long k = k0; k < k1; ++k)
    store_stream(a.rows + k * kLanes + 4 * lane, zero4());
  for (long long k = k0 + lane; k < k1; k += 32)
    a.tgt[k] = static_cast<int>(a.vocab + 1 + k);
}

// The pass: one warp a ticket: a tile, or a share of the junk fill.
// kRegs: float4 loads (D % 4 == 0, g on 16 bytes); kScalar: element
// loads (any D, any alignment); kRing: bulk copies (as kRegs).
template <Route kRoute>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
pass_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  Timers tm;
  tm.start();
  const long long t = take_ticket(a, lane);
  if (t >= a.n_tiles) {
    if (t < a.n_tiles + a.n_fill) fill_junk(a, t - a.n_tiles, lane);
    tm.mark(kFill);
    tm.flush(lane);
    return;
  }
  Ring ring;
  ring.stages = smem + (threadIdx.x >> 5) * a.warp_smem;
  ring.bars = reinterpret_cast<uint64_t*>(ring.stages + kStages * a.stage_bytes);
  ring.issued = ring.waited = 0;
  if constexpr (kRoute == kRing) {
    if (lane == 0) {
      for (int st = 0; st < kStages; ++st) bulk_copy::mbar_init(ring.bars + st);
      bulk_copy::fence_mbar_init();
    }
    __syncwarp();
  }
  const int rr = lane / a.c, cc = lane - rr * a.c;
  const bool act = rr < a.r;
  Tile tl;
  float4 v[kLoads];
  begin_tile<kRoute>(a, t, tl, v, ring, lane, rr, cc, act);
  tm.mark(kBegin);
  const long long first = look_back(a, t, lane);
  const unsigned long long word =
      kPrefix | (tl.any_start ? kHasStart : 0ull) |
      static_cast<unsigned long long>(first + tl.cnt);
  if (lane == 0) {
    store_word(a.status + t, word);
    if (t == a.n_tiles - 1) {
      const long long over = first + tl.cnt - a.capr;
      *a.overflow = over > 0 ? static_cast<int>(over) : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if ((tl.real[k] >> lane) & 1u) {
      const long long slot =
          first + tl.pre[k] + __popc(tl.real[k] & ((1u << lane) - 1u));
      if (slot < a.capr) a.tgt[slot] = tl.id[k];
    }
  }
  tm.mark(kLookBackPhase);
  const bool carried = !(tl.start[0] & 1u);
  Walk w;
  w.run = zero4();
  w.held = zero4();
  w.held_slot = -1;
  if constexpr (kRoute != kRing) {
    const int batch = kLoads * a.r;
    for (int b0 = 0; b0 < tl.rows; b0 += batch) {
      if (b0 > 0) {
#pragma unroll
        for (int k = 0; k < kLoads; ++k)
          v[k] = load_row<kRoute>(a, tl, b0 + k * a.r + rr, act, cc);
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int b = b0 + k * a.r;
        if (b >= tl.rows) break;
        walk_step(a, tl, first, carried, b, v[k], w, lane, rr, cc);
      }
    }
  } else {
    // a part is at most kLoads steps: its rows' loads from shared memory
    // are issued together, then summed
    for (int p = 0; p * a.part_rows < tl.rows; ++p) {
      const int p0 = p * a.part_rows;
      const int st = ring.waited % kStages;
      bulk_copy::mbar_wait(ring.bars + st,
                           static_cast<uint32_t>((ring.waited / kStages) & 1));
      ++ring.waited;
      const uint32_t s0 = bulk_copy::smem_addr(ring.stages + st * a.stage_bytes);
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int row = p0 + k * a.r + rr;
        v[k] = zero4();
        if (act && row - p0 < a.part_rows && row < tl.rows)
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(v[k].x), "=f"(v[k].y), "=f"(v[k].z), "=f"(v[k].w)
                       : "r"(s0 + 4 * ((row - p0) * a.d + 4 * cc)));
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int b = p0 + k * a.r;
        if (k * a.r >= a.part_rows || b >= tl.rows) break;
        walk_step(a, tl, first, carried, b, v[k], w, lane, rr, cc);
      }
      __syncwarp();
      if (lane == 0) issue_part(a, tl, ring, p + kStages);
    }
  }
  tm.mark(kWalk);
  // the run open at the tile's last row: store its part (its floats
  // are what a later tile waits for)
  if (tl.open_end && lane < a.c)
    store_tail(a.tails + t * 4 * a.c + 4 * lane, add4(w.run, zero4()));
  tm.mark(kTailPhase);
  if (w.held_slot >= 0) {
    const long long u0 = run_start_tile(a, t, lane);
    tm.mark(kCarryWait);
    float4 x = add4(sum_tails(a, u0, t, rr, cc), w.held);
    if (lane >= a.c) x = zero4();
    write_row(a, w.held_slot, x, lane);
    tm.mark(kCarrySum);
    if constexpr (kProfile) tm.carried = 1;
  }
  tm.flush(lane);
}

// The fill launch (kFillInPass false): kFillChunk slots a warp; the ones
// at or past the total get zero rows and junk targets.
__global__ void __launch_bounds__(kWarps * 32)
fill_kernel(const __grid_constant__ Args a) {
  const int lane = threadIdx.x & 31;
  const long long k0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kFillChunk;
  const long long total =
      static_cast<long long>(a.status[a.n_tiles - 1] & kValue);
  const long long lo = k0 > total ? k0 : total;
  const long long hi = k0 + kFillChunk < a.capr ? k0 + kFillChunk : a.capr;
  for (long long k = lo; k < hi; ++k)
    store_stream(a.rows + k * kLanes + 4 * lane, zero4());
  for (long long k = lo + lane; k < hi; k += 32)
    a.tgt[k] = static_cast<int>(a.vocab + 1 + k);
}

unsigned blocks_for(long long items, long long per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

// The pass: a warp for every ticket.
template <Route kRoute>
cudaError_t launch_pass(const Args& a, cudaStream_t s) {
  auto* kernel = pass_kernel<kRoute>;
  const int smem = kWarps * a.warp_smem;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks_for(a.n_tiles + a.n_fill, kWarps), kWarps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// scratch: the tile words and the ticket, (n_tiles + 1) 8-byte words
// rounded up to an even count, then the tails, n_tiles · 4·ceil(dim / 4)
// floats (n_tiles = ceil(n / 128)); set to all ones here.
extern "C" int compact_runsums(const void* ids, const void* g, long long n,
                               int dim, int vocab, long long capr, void* tgt,
                               void* rows, void* overflow, void* scratch,
                               void* stream) {
  if (dim < 1 || dim >= kLanes - 1 || n <= 0 || n >= (1ll << 31) ||
      capr <= 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  Args a;
  a.ids = static_cast<const int*>(ids);
  a.g = static_cast<const float*>(g);
  a.n = n;
  a.d = dim;
  a.vocab = vocab;
  a.capr = capr;
  a.tgt = static_cast<int*>(tgt);
  a.rows = static_cast<float*>(rows);
  a.overflow = static_cast<int*>(overflow);
  a.n_tiles = (n + kTileRows - 1) / kTileRows;
  const long long words = (a.n_tiles + 2) / 2 * 2;
  a.status = static_cast<unsigned long long*>(scratch);
  a.tails = reinterpret_cast<float*>(a.status + words);
  a.n_fill = kFillInPass ? (capr + kFillSlots - 1) / kFillSlots : 0;
  a.c = (dim + 3) / 4;
  a.r = 1;
  while (a.r * 2 * a.c <= 32) a.r *= 2;
  // ring parts: a power of 2 of rows, at most kLoads steps, 32 rows and
  // kStageBytes (at least one step)
  a.part_rows = a.r;
  while (a.part_rows * 2 <= 32 && a.part_rows * 2 <= kLoads * a.r &&
         a.part_rows * 2 * dim * 4 <= kStageBytes)
    a.part_rows *= 2;
  a.stage_bytes = (a.part_rows * dim * 4 + 127) / 128 * 128;
  a.warp_smem = kStages * a.stage_bytes + 128;
  cudaError_t e = cudaMemsetAsync(
      scratch, 0xff, words * 8 + a.n_tiles * 4 * a.c * 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = dim % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (!vec) {
    a.stage_bytes = a.warp_smem = 0;
    e = launch_pass<kScalar>(a, s);
  } else if (kUseRing) {
    e = launch_pass<kRing>(a, s);
  } else {
    a.stage_bytes = a.warp_smem = 0;
    e = launch_pass<kRegs>(a, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!kFillInPass)
    fill_kernel<<<blocks_for(capr, kWarps * kFillChunk), kWarps * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The phase timers' sums (kProfile; zeros otherwise): kPhases + 1
// 8-byte counters.
extern "C" int compact_runsums_prof(void* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, k9_prof, sizeof(k9_prof)));
}

extern "C" const char* compact_runsums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
