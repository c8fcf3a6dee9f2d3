// Stable partition of feature-major columns by a per-column flag, for
// Hopper (sm_90a): the core shared by the partition move (partition.cu)
// and the GOSS compaction (compact.cu).
//
// Both kernels move whole columns of
//
//   bins [F, n] uint8 or uint16, vals [C, n] f32 (and, for the move, leaf
//   ids [n] i32)
//
// to the positions a stable partition of the columns gives: the columns of
// one class keep their source order inside one contiguous run of the
// output. The pieces, each a device function below:
//
// - Tiles. A CTA takes a tile of kTile columns at a time from a global
//   atomic counter, not from blockIdx, so a tile's predecessors were all
//   taken by CTAs that are running: a tile that waits for them never waits
//   for a CTA that is not scheduled. The grid is as many CTAs as fit on
//   the card at once, each looping over tiles.
// - Scan. Thread t of the CTA holds the tile's columns t + kThreads k
//   (k < kStrips), so a warp's 32 columns are consecutive: a ballot per k
//   gives each column's rank inside its warp, and one warp scans the
//   (k, warp) counts. Then the decoupled look-back of Merrill and Garland
//   ("Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA,
//   2016): the tile publishes its count in its status word, warp 0 reads
//   the 32 preceding status words at once and sums back to the nearest
//   inclusive prefix, and the tile publishes its own inclusive prefix.
// - Status words. One 64-bit word per tile, stored and polled with
//   relaxed device-scope accesses (the word is the whole message): epoch
//   (30 bits) | flag (2 bits) | count (32 bits). The caller passes a new
//   epoch to every launch, so a word left by an earlier launch never
//   reads as valid and nothing is reset between launches. The tile
//   counters sit in two slots picked by the epoch's parity: a launch uses
//   its own slot and zeroes the other one, which the next launch on the
//   stream uses.
// - Data. Each stage of the tile (four uint8 feature rows, two uint16
//   ones, or one 4-byte row: 4 kTile bytes at most) is copied into shared
//   memory with 16-byte cp.async loads, kBufs - 1 stages ahead of the one
//   being moved. The CTA writes each column to its
//   place in a shared buffer laid out like the destination runs (the four
//   rows of a stage in one pass over the positions), then stores each run
//   as 16-byte chunks (the run's partial first and last chunks element by
//   element, so two tiles whose runs share a chunk write disjoint bytes).
//
// The bin rows' element size kBe (1 or 2 bytes) is a template parameter
// of every function that reads them; the kernels are instantiated for
// both, and the uint8 instances are the code they were before uint16
// bins.
//
// What bounds it: bytes, and per stage a chain of load, barrier, reorder,
// barrier, store that a CTA runs in order; the shape (4096-column tiles of
// 256 threads, one stage in flight, four CTAs an SM) was the fastest of
// the variants chip_variants.py measures (PERF.md).
//
// Scratch (caller-owned, zeroed once when allocated, grown as needed):
// 2 x kCounters unsigned counters, then one status word per tile
// (scratch_bytes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sp {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 1024 / kThreads;      // per SM: 64 registers
constexpr int kWarps = kThreads / 32;
constexpr int kStrips = 16;                      // columns per thread
constexpr int kTile = kThreads * kStrips;        // columns per tile
constexpr int kInBytes = 4 * kTile;              // one stage: 16 KiB
constexpr int kBufs = 2;                         // stages in flight + 1
constexpr int kOutRow = kTile + 64;              // one u8 row, reordered
constexpr int kOutBytes = 4 * kOutRow;   // four u8, two u16 or one f32 row
constexpr int kSmemBytes = kBufs * kInBytes + kOutBytes;
constexpr unsigned short kNone = 0xFFFF;         // column not written
constexpr int kCounters = 4;                     // per epoch parity
constexpr long long kHeaderBytes = 2 * kCounters * sizeof(unsigned);
enum Counter { kClaimScan = 0, kDone = 1, kClaimMove = 2 };
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

__host__ __device__ inline long long num_tiles(long long n) {
  return (n + kTile - 1) / kTile;
}

inline long long scratch_bytes(long long n) {
  return kHeaderBytes + 8 * num_tiles(n);
}

// Columns of the tile that starts at column t0.
__device__ __forceinline__ int tile_cols(long long n, long long t0) {
  return static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
}

// ---- memory-model helpers --------------------------------------------------
// A status word carries its whole message (the count), so it is stored and
// polled with relaxed device-scope accesses: no other data is read on the
// strength of it.
__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- status words ----------------------------------------------------------
__device__ __forceinline__ unsigned long long pack(unsigned epoch,
                                                   unsigned long long flag,
                                                   unsigned count) {
  return (static_cast<unsigned long long>(epoch) << 34) | (flag << 32) |
         count;
}

__device__ __forceinline__ unsigned long long flag_of(unsigned long long s) {
  return (s >> 32) & 3;
}

// Spin until the word holds this launch's epoch and at least `need`
// (kAggregate: any published count; kPrefix: an inclusive prefix).
__device__ __forceinline__ unsigned long long wait_status(
    const unsigned long long* p, unsigned epoch, unsigned long long need) {
  unsigned long long s;
  do {
    s = ld_relaxed(p);
  } while ((s >> 34) != epoch || flag_of(s) < need);
  return s;
}

// The two counter slots: this launch's, picked by the epoch's parity.
__device__ __forceinline__ unsigned* counters(unsigned char* scratch,
                                              unsigned epoch) {
  return reinterpret_cast<unsigned*>(scratch) + (epoch & 1) * kCounters;
}

__device__ __forceinline__ unsigned long long* status_words(
    unsigned char* scratch) {
  return reinterpret_cast<unsigned long long*>(scratch + kHeaderBytes);
}

// Block 0 zeroes the other slot for the next launch on this stream (the
// previous launch, which used it, has finished).
__device__ __forceinline__ void reset_next_counters(unsigned char* scratch,
                                                    unsigned epoch) {
  if (blockIdx.x == 0 && threadIdx.x < kCounters)
    counters(scratch, epoch + 1)[threadIdx.x] = 0;
}

// Thread 0 takes the next tile; every thread gets it.
__device__ __forceinline__ int claim_tile(unsigned* counter, int* s_tile) {
  if (threadIdx.x == 0) *s_tile = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  return *s_tile;
}

// ---- scan ------------------------------------------------------------------
// bits: bit k set when the thread's column k * kThreads + tid is flagged.
// On return le[k] is the number of flagged columns of the tile before that
// column; the tile's flagged count is returned. s_cnt holds
// kStrips * kWarps + 1 words.
__device__ __forceinline__ unsigned block_scan(
    unsigned bits, unsigned* s_cnt, unsigned short (&le)[kStrips]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1;
  unsigned ball[kStrips];
#pragma unroll
  for (int k = 0; k < kStrips; ++k) {
    ball[k] = __ballot_sync(0xffffffffu, (bits >> k) & 1);
    if (lane == 0) s_cnt[k * kWarps + warp] = __popc(ball[k]);
  }
  __syncthreads();
  if (warp == 0) {       // the counts in column order, kPer per lane
    constexpr int kPer = kStrips * kWarps / 32;
    static_assert(kPer * 32 == kStrips * kWarps, "counts per lane");
    unsigned a[kPer], sum = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) sum += (a[i] = s_cnt[lane * kPer + i]);
    unsigned incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    unsigned run = incl - sum;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      s_cnt[lane * kPer + i] = run;
      run += a[i];
    }
    if (lane == 31) s_cnt[kStrips * kWarps] = incl;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kStrips; ++k)
    le[k] = static_cast<unsigned short>(s_cnt[k * kWarps + warp] +
                                        __popc(ball[k] & lt));
  return s_cnt[kStrips * kWarps];
}

// Decoupled look-back, run by all 32 lanes of one warp: publishes tile t's
// count `agg`, sums the counts of its predecessors back to the nearest
// inclusive prefix, publishes t's inclusive prefix and returns t's
// exclusive prefix (in every lane).
__device__ __forceinline__ unsigned lookback(unsigned long long* status,
                                             int t, unsigned agg,
                                             unsigned epoch) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) st_relaxed(&status[0], pack(epoch, kPrefix, agg));
    return 0;
  }
  if (lane == 0) st_relaxed(&status[t], pack(epoch, kAggregate, agg));
  unsigned excl = 0;
  for (int j = t - 1;; j -= 32) {
    const int idx = j - lane;          // lane 0 is the nearest predecessor
    const unsigned long long s =
        idx >= 0 ? wait_status(&status[idx], epoch, kAggregate)
                 : pack(epoch, kPrefix, 0);
    const unsigned pmask = __ballot_sync(0xffffffffu, flag_of(s) == kPrefix);
    const int first = pmask ? __ffs(pmask) - 1 : 31;
    unsigned v = lane <= first ? static_cast<unsigned>(s) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (pmask) break;
  }
  if (lane == 0) st_relaxed(&status[t], pack(epoch, kPrefix, excl + agg));
  return excl;
}

// ---- data ------------------------------------------------------------------
// The rows that move: F feature rows of kBe-byte bin ids, C f32 rows and L
// (0 or 1) i32 leaf rows; row r of a source has stride n elements, of an
// output on.
struct Rows {
  const char* bins;
  const char* vals;
  const char* leaf;
  char* obins;
  char* ovals;
  char* oleaf;
  int F, C, L;
  long long n, on;
};

// A stage: up to 4 / kBe bin rows (kBe kTile bytes each) or one 4-byte
// row.
template <int kBe>
__device__ __forceinline__ int num_stages(const Rows& a) {
  constexpr int kPer = 4 / kBe;
  return (a.F + kPer - 1) / kPer + a.C + a.L;
}

template <int kBe>
__device__ __forceinline__ void stage_rows(const Rows& a, int s, int& r0,
                                           int& cnt, int& es) {
  constexpr int kPer = 4 / kBe;
  const int sb = (a.F + kPer - 1) / kPer;
  if (s < sb) {
    r0 = kPer * s;
    cnt = min(kPer, a.F - r0);
    es = kBe;
  } else {
    r0 = a.F + (s - sb);
    cnt = 1;
    es = 4;
  }
}

template <int kBe>
__device__ __forceinline__ const char* src_row(const Rows& a, int r) {
  if (r < a.F) return a.bins + static_cast<size_t>(r) * a.n * kBe;
  if (r < a.F + a.C) return a.vals + static_cast<size_t>(r - a.F) * a.n * 4;
  return a.leaf;
}

template <int kBe>
__device__ __forceinline__ char* dst_row(const Rows& a, int r) {
  if (r < a.F) return a.obins + static_cast<size_t>(r) * a.on * kBe;
  if (r < a.F + a.C) return a.ovals + static_cast<size_t>(r - a.F) * a.on * 4;
  return a.oleaf;
}

// Copy `bytes` bytes from global memory to shared memory: 16-byte cp.async
// chunks where the source is 16-byte aligned, bytes otherwise.
__device__ __forceinline__ void copy_row(const char* src, int bytes,
                                         char* dst) {
  const int full =
      (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? bytes >> 4 : 0;
  for (int c = threadIdx.x; c < full; c += kThreads)
    cp_async16(dst + 16 * c, src + 16 * c);
  for (int b = 16 * full + threadIdx.x; b < bytes; b += kThreads)
    dst[b] = src[b];
}

// Start loading stage s of the tile [t0, t0 + cols) into buf (one
// cp.async group, empty when there is no stage s); row j of the stage at
// buf + j * kTile * es.
template <int kBe>
__device__ __forceinline__ void issue_stage(const Rows& a, int s,
                                            long long t0, int cols,
                                            char* buf) {
  if (s < num_stages<kBe>(a)) {
    int r0, cnt, es;
    stage_rows<kBe>(a, s, r0, cnt, es);
    for (int j = 0; j < cnt; ++j)
      copy_row(src_row<kBe>(a, r0 + j) + t0 * es, cols * es,
               buf + j * kTile * es);
  }
  cp_async_commit();
}

// Where a row's runs sit in the shared output buffer (in elements): the
// front run's first element at fa, the back run's at sb + ba, so that each
// 16-byte chunk of shared memory maps onto a 16-byte aligned chunk of the
// destination.
struct Layout {
  int fa, sb, ba;
};

__device__ __forceinline__ Layout layout(const char* dst, int es,
                                         long long f0, long long b0,
                                         int nf) {
  const int V = 16 / es;
  Layout L;
  L.fa = static_cast<int>((reinterpret_cast<uintptr_t>(dst + f0 * es) & 15)
                          / es);
  L.ba = static_cast<int>((reinterpret_cast<uintptr_t>(dst + b0 * es) & 15)
                          / es);
  L.sb = (L.fa + nf + V - 1) / V * V;
  return L;
}

// Put each of the thread's columns at its place in the shared output
// buffers of the stage's CNT rows of T (row j: input at inb + j * kTile *
// sizeof(T), output at outb + j * kOutRow * sizeof(T); one layout for
// all): local destination d < nf is the front run's element d, d >= nf the
// back run's element d - nf. The CNT loads of a column issue before its
// CNT stores.
template <typename T, int CNT>
__device__ __forceinline__ void scatter_rows(
    const char* inb, char* outb, const unsigned short (&ld)[kStrips], int nf,
    Layout L) {
#pragma unroll
  for (int k = 0; k < kStrips; ++k) {
    const int d = ld[k];
    if (d == kNone) continue;
    const int p = d < nf ? L.fa + d : L.sb + L.ba + (d - nf);
    const int c = k * kThreads + threadIdx.x;
    T v[CNT];
#pragma unroll
    for (int j = 0; j < CNT; ++j)
      v[j] = reinterpret_cast<const T*>(inb + j * kTile * sizeof(T))[c];
#pragma unroll
    for (int j = 0; j < CNT; ++j)
      reinterpret_cast<T*>(outb + j * kOutRow * sizeof(T))[p] = v[j];
  }
}

// Store the stage's CNT rows (row j of the shared buffer at out + j *
// kOutRow * es, of the destination at dst + j * row_bytes): the front run's
// first nfe elements at column f0 and the back run's nb elements at b0,
// whole 16-byte chunks as one store, the partial chunks at either end of a
// run element by element.
template <int CNT>
__device__ __forceinline__ void store_rows(const char* out, char* dst,
                                           long long row_bytes, int es,
                                           long long f0, long long b0,
                                           int nfe, int nb, Layout L) {
  const int V = 16 / es;
  const int nfc = nfe > 0 ? (L.fa + nfe + V - 1) / V : 0;
  const int nbc = nb > 0 ? (L.ba + nb + V - 1) / V : 0;
  char* gf = dst + (f0 - L.fa) * es;
  char* gb = dst + (b0 - L.ba) * es;
  for (int c = threadIdx.x; c < nfc + nbc; c += kThreads) {
    int base, lo, hi;
    char* g;
    if (c < nfc) {
      base = c * V;
      lo = L.fa;
      hi = L.fa + nfe;
      g = gf + static_cast<size_t>(c) * 16;
    } else {
      const int cc = c - nfc;
      base = L.sb + cc * V;
      lo = L.sb + L.ba;
      hi = lo + nb;
      g = gb + static_cast<size_t>(cc) * 16;
    }
    if (base >= lo && base + V <= hi) {
      uint4 v[CNT];
#pragma unroll
      for (int j = 0; j < CNT; ++j)
        v[j] = *reinterpret_cast<const uint4*>(out + j * kOutRow * es
                                               + base * es);
#pragma unroll
      for (int j = 0; j < CNT; ++j)
        *reinterpret_cast<uint4*>(g + j * row_bytes) = v[j];
    } else {
      const int b1 = (min(hi, base + V) - base) * es;
#pragma unroll
      for (int j = 0; j < CNT; ++j)
        for (int b = (max(lo, base) - base) * es; b < b1; ++b)
          g[j * row_bytes + b] = out[j * kOutRow * es + base * es + b];
    }
  }
}

// Move every row of the tile [t0, t0 + cols): column k * kThreads + tid
// goes to local destination ld[k] (kNone: nowhere); the front run (nf
// columns, the first nfe of them stored) starts at output column f0, the
// back run (nb columns) at b0. Stage 0 must already be issued into the
// first input buffer; kBufs - 1 stages are in flight while one is moved.
// A stage of 4 / kBe bin rows whose output stride is a multiple of 16
// bytes shares one layout (one pass over the positions for all its rows);
// otherwise each row is laid out and moved on its own.
template <int kBe>
__device__ __forceinline__ void move_tile(const Rows& a, long long t0,
                                          int cols,
                                          const unsigned short (&ld)[kStrips],
                                          int nf, int nfe, long long f0,
                                          long long b0, int nb, char* smem) {
  constexpr int kPer = 4 / kBe;             // bin rows of a full stage
  char* outb = smem + kBufs * kInBytes;
  const int S = num_stages<kBe>(a);
  for (int s = 1; s < kBufs - 1; ++s)
    issue_stage<kBe>(a, s, t0, cols, smem + s * kInBytes);
  for (int s = 0; s < S; ++s) {
    // the buffer of stage s - 1, free since the last barrier
    issue_stage<kBe>(a, s + kBufs - 1, t0, cols,
                     smem + ((s + kBufs - 1) % kBufs) * kInBytes);
    cp_async_wait<kBufs - 1>();
    __syncthreads();             // stage s has landed; outb is free
    const char* inb = smem + (s % kBufs) * kInBytes;
    int r0, cnt, es;
    stage_rows<kBe>(a, s, r0, cnt, es);
    const long long row_bytes = a.on * es;
    const int per = cnt == kPer && (row_bytes & 15) == 0 ? kPer : 1;
    for (int q = 0; q < cnt; q += per) {
      const Layout L = layout(dst_row<kBe>(a, r0 + q), es, f0, b0, nf);
      const char* in_q = inb + q * kTile * es;
      char* out_q = outb + q * kOutRow * es;
      if (es == 4)
        scatter_rows<uint32_t, 1>(inb, outb, ld, nf, L);
      else if constexpr (kBe == 1) {
        if (per == 4)
          scatter_rows<uint8_t, 4>(in_q, out_q, ld, nf, L);
        else
          scatter_rows<uint8_t, 1>(in_q, out_q, ld, nf, L);
      } else {
        if (per == 2)
          scatter_rows<uint16_t, 2>(in_q, out_q, ld, nf, L);
        else
          scatter_rows<uint16_t, 1>(in_q, out_q, ld, nf, L);
      }
    }
    __syncthreads();             // the stage is reordered
    for (int q = 0; q < cnt; q += per) {
      char* dst = dst_row<kBe>(a, r0 + q);
      const Layout L = layout(dst, es, f0, b0, nf);
      char* out_q = outb + q * kOutRow * es;
      if (per == 4)
        store_rows<4>(out_q, dst, row_bytes, es, f0, b0, nfe, nb, L);
      else if (per == 2)
        store_rows<2>(out_q, dst, row_bytes, es, f0, b0, nfe, nb, L);
      else
        store_rows<1>(out_q, dst, row_bytes, es, f0, b0, nfe, nb, L);
    }
  }
}

// ---- launch ----------------------------------------------------------------
// As many CTAs as fit on the device at once (at most `want`, at least 1),
// after allowing the kernel its dynamic shared memory; worked out once per
// device into the caller's `cap` (one table per kernel instance: each
// needs its own shared-memory attribute set, and a static local of an
// inline or template function would be one symbol shared by every loaded
// library).
constexpr int kMaxDevices = 64;

static int resident_grid(const void* kernel, long long want,
                         int (&cap)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int c = dev < kMaxDevices ? cap[dev] : 0;
  if (c == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, kSmemBytes);
    if (err != cudaSuccess) return -static_cast<int>(err);
    c = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
    if (dev < kMaxDevices) cap[dev] = c;
  }
  return static_cast<int>(want < 1 ? 1 : (want < c ? want : c));
}

}  // namespace sp
