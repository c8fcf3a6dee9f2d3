// Two histogram probe kernels for Hopper (sm_90a): variants of the
// multi-leaf histogram (csrc/histogram.cu, "kernel A") that answer design
// questions about it. Both compute kernel A's f32-mode function
//
//   hist[k, f, b, c] = sum_r [bins_t[f, r] == b] * [leaf_id[r] == small_ids[k]]
//                            * bf16(vals_t[c, r])
//
// bins_t [F, n] uint8, vals_t [C, n] f32, leaf_id [n] i32, small_ids [K] i32
// (K <= 32; a row with a negative leaf id matches no lane, and a lane
// whose id matches no row -- e.g. -1 -- gets a zero histogram), output
// [K, F, B, C] f32; sums in f32 (atomics, so the order varies from run to
// run).
//
// What bounds both on an H100: bytes -- every leaf id, the bins and values
// of the rows that match a lane, and the output, once each; the adds
// (one per matching row, feature and channel) are far below the float32
// rate.
//
// 1. lgbt_hist_probe_1d replaces the TPU probe benchmarks/kernel_probe.py
//    (hist1d), whose grid runs over row blocks only. Here too the grid is
//    row chunks only: each CTA reads its chunk's leaf ids and values ONCE,
//    staging the rows' lane bitmasks and bf16-rounded values in shared
//    memory, then loops over feature tiles whose [K][tile][B][C]
//    accumulator fits beside them, flushing each tile with global atomics
//    into an output the caller zeroed. Kernel A instead gives each CTA one
//    feature, so every CTA re-reads the values and ids (through L2). Only
//    lanes that some row of the chunk matches are zeroed and flushed.
// 2. lgbt_hist_probe_nibble replaces the TPU probe
//    benchmarks/nibble_probe.py (hist_nibble), which splits a bin as
//    b = nb*u + v and keeps an [nb][K][C] tile per group u. nb is a
//    parameter (the TPU probe tried 16, 32 and 64).
//
//    What held its first design back (one CTA per feature, bin group and
//    row chunk, 256 threads, global atomics into a zeroed output; 1.66 /
//    1.16 / 0.78 ms at nb = 16 / 32 / 64 at the probe's shape, F=28,
//    n=2^20, B=256, K=32, C=3, against one index_add_'s 0.75 ms): read
//    amplification. Each of the B/nb CTAs of a feature and chunk read all
//    its bins, and gathered the id and values of the 1-in-B/nb rows whose
//    bin fell in its group with scattered 4-byte loads, so the id and value
//    sectors were fetched 3.6-6.4 times per feature, 28 times over: by
//    count 1.7-3.4 GB of L2/HBM traffic for 44 MB of input. The TPU probe
//    reads each row block once and loops over the groups inside.
//
//    The cluster design: the histogram is cut into tiles, one per (feature
//    f, bin group u) pair, of [K][w][C] f32 with w = nb (capped at B, and
//    at what fits in one CTA). The pairs, numbered f * G + u, are cut into
//    chunks; a thread-block cluster of Q CTAs (Q <= 16, non-portable at
//    16) holds one chunk's tiles in its shared memory, CTA i owning the
//    i-th run of slots consecutive pairs (so about slots / G whole
//    features). Each cluster takes one chunk and one part of the rows,
//    split among its CTAs. A step: every CTA stages 1024 of its rows in
//    its own shared memory -- lane mask, values rounded to bf16 (exact in
//    2 bytes), the chunk's bins -- each row read from global memory once,
//    coalesced; after cluster.sync() every CTA reads the staged rows of
//    the whole cluster over DSMEM (16-byte mask, 8-byte value and 4-byte
//    bin loads, 4 rows a thread), keeps the (row, feature)s of its own
//    pairs and adds them to its tiles with local shared atomics; a second
//    cluster.sync() frees the stages. After the last step a CTA adds its
//    tiles into the caller's zeroed output with global atomics (one add
//    per element and row part) and exits: no CTA reads another's shared
//    memory after that barrier.
//
//    Tried first and measured slower (PERF.md): the same tiles with every
//    (row, feature) sent to the owner as a remote
//    red.shared::cluster.add.f32. On sm_90a that compiles to a generic
//    ATOM.E.ADD.F32 behind a local/remote branch (ATOMS.CAST.SPIN for the
//    local case), and ran 2-4x slower than the first design. Remote f32
//    adds are the cost; bulk DSMEM reads of staged rows are not.
//
//    The host picks Q and the chunk (plan_nibble) from the shared-memory
//    budget and cudaOccupancyMaxActiveClusters; a cluster that cannot be
//    scheduled is an error, not a retry.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLanes = 32;      // lanes (one bit each)
constexpr int kTable = 2048;       // leaf ids with a direct table entry
constexpr size_t kSmemLimit = 232448;   // dynamic shared memory per CTA

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Fill the leaf -> lane bitmask table and the lane ids (caller syncs).
__device__ void load_lanes(uint32_t* table, int32_t* ids,
                           const int32_t* __restrict__ small_ids, int K) {
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) table[i] = 0u;
  __syncthreads();
  if (threadIdx.x < K) {
    const int id = small_ids[threadIdx.x];
    ids[threadIdx.x] = id;
    if (id >= 0 && id < kTable) atomicOr(&table[id], 1u << threadIdx.x);
  }
}

__device__ __forceinline__ uint32_t lanes_of(int lid, const uint32_t* table,
                                             const int32_t* ids, int K) {
  if (lid < 0) return 0u;               // a negative id matches no lane
  if (lid < kTable) return table[lid];
  uint32_t mask = 0u;
  for (int k = 0; k < K; ++k) mask |= (ids[k] == lid) ? (1u << k) : 0u;
  return mask;
}

// ---- probe 1: row-chunk grid, feature tiles ------------------------------
constexpr int k1dThreads = 512;

template <int kC>
__global__ void __launch_bounds__(k1dThreads)
probe_1d_kernel(const uint8_t* __restrict__ bins_t,
                const float* __restrict__ vals_t,
                const int32_t* __restrict__ leaf_id,
                const int32_t* __restrict__ small_ids, int n, int F, int K,
                int B, int rows, int tile_f, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);          // [kTable]
  int32_t* ids = reinterpret_cast<int32_t*>(table + kTable);     // [32]
  uint32_t* used = reinterpret_cast<uint32_t*>(ids + kMaxLanes); // [4]
  uint32_t* lane_mask = used + 4;                                // [rows]
  float* stage = reinterpret_cast<float*>(lane_mask + rows);     // [C][rows]
  float* acc = stage + static_cast<size_t>(kC) * rows;  // [K][tile][B][C]

  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);
  if (threadIdx.x == 0) used[0] = 0u;
  load_lanes(table, ids, small_ids, K);
  __syncthreads();

  // stage the chunk: each row's leaf id and values are read once
  uint32_t seen = 0u;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    uint32_t m = 0u;
    if (i < nr) m = lanes_of(leaf_id[r0 + i], table, ids, K);
    lane_mask[i] = m;
    if (m) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        stage[c * rows + i] =
            bf16_round(vals_t[static_cast<size_t>(c) * n + r0 + i]);
      }
    }
    seen |= m;
  }
  if (seen) atomicOr(&used[0], seen);
  __syncthreads();
  const uint32_t used_lanes = used[0];
  if (used_lanes == 0u) return;

  const int cell_stride = tile_f * B * kC;      // one lane's tile
  for (int f0 = 0; f0 < F; f0 += tile_f) {
    const int tf = min(tile_f, F - f0);
    const int cells = tf * B * kC;
    for (uint32_t m = used_lanes; m; m &= m - 1u) {
      float* a = acc + static_cast<size_t>(__ffs(m) - 1) * cell_stride;
      for (int i = threadIdx.x; i < cells; i += blockDim.x) a[i] = 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr; i += blockDim.x) {
      const uint32_t m0 = lane_mask[i];
      if (!m0) continue;
      float v[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) v[c] = stage[c * rows + i];
      for (int fl = 0; fl < tf; ++fl) {
        const int b = bins_t[static_cast<size_t>(f0 + fl) * n + r0 + i];
        if (b >= B) continue;
        const int base = (fl * B + b) * kC;
        for (uint32_t m = m0; m; m &= m - 1u) {
          float* cell = acc + static_cast<size_t>(__ffs(m) - 1) * cell_stride
                        + base;
#pragma unroll
          for (int c = 0; c < kC; ++c) atomicAdd(&cell[c], v[c]);
        }
      }
    }
    __syncthreads();
    // flush: a lane's tile is one contiguous run of its output
    for (uint32_t m = used_lanes; m; m &= m - 1u) {
      const int k = __ffs(m) - 1;
      const float* a = acc + static_cast<size_t>(k) * cell_stride;
      float* o = out + (static_cast<size_t>(k) * F + f0) * B * kC;
      for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        const float x = a[i];
        if (x != 0.f) atomicAdd(&o[i], x);
      }
    }
    __syncthreads();
  }
}

size_t smem_1d(int rows, int tile_f, int K, int B, int C) {
  return (kTable + kMaxLanes + 4) * sizeof(uint32_t)
         + static_cast<size_t>(rows) * (1 + C) * sizeof(float)
         + static_cast<size_t>(K) * tile_f * B * C * sizeof(float);
}

template <int kC>
int launch_1d(const uint8_t* bins_t, const float* vals_t,
              const int32_t* leaf_id, const int32_t* small_ids, int n, int F,
              int K, int B, float* out, cudaStream_t stream) {
  // the largest row chunk (<= 2048) beside at least one feature's tile,
  // then as many features per tile as still fit
  int rows = 2048;
  while (rows > 256 && smem_1d(rows, 1, K, B, kC) > kSmemLimit) rows /= 2;
  if (smem_1d(rows, 1, K, B, kC) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile_f = 1;
  while (tile_f < F && smem_1d(rows, tile_f + 1, K, B, kC) <= kSmemLimit) {
    ++tile_f;
  }
  const size_t smem = smem_1d(rows, tile_f, K, B, kC);
  cudaFuncSetAttribute(probe_1d_kernel<kC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const unsigned grid = (n + rows - 1) / rows;
  probe_1d_kernel<kC><<<grid, k1dThreads, smem, stream>>>(
      bins_t, vals_t, leaf_id, small_ids, n, F, K, B, rows, tile_f, out);
  return static_cast<int>(cudaGetLastError());
}

// ---- probe 2: bin groups of nb, one thread-block cluster per tile chunk --
constexpr int kNibThreads = 1024;      // also the rows a CTA stages a step
constexpr int kOwnBatch = 4;           // features whose bins load together
// shared memory besides the tiles and the stage: the lane table, the lane
// ids and the bin -> (group, offset) table
constexpr int kNibFixed = (kTable + kMaxLanes) * 4 + 256 * 2;
constexpr int kNibBudget = static_cast<int>(kSmemLimit) - kNibFixed;

// The launch's shape (computed by plan_nibble, also for the plan query).
struct NibPlan {
  int w;         // bins of one tile: nb, capped at B and at what fits
  int groups;    // G: tiles per feature
  int q;         // cluster size Q (a power of two, at most 16)
  int chunk;     // (feature, group) pairs per chunk
  int chunks;    // chunks in all
  int clusters;  // clusters launched: chunks x row parts
  int slots;     // tiles per CTA
  int smem;      // dynamic shared memory per CTA
  int max_clusters;   // cudaOccupancyMaxActiveClusters at Q and smem
  int rows;      // rows per CTA
  int f_span;    // features a chunk spans, at most (bins staged per row)
};

// staged bytes per row: lane mask, C bf16 values, f_span bins (padded to 4)
constexpr int stage_row_bytes(int C, int f_span) {
  return 4 + 2 * C + (f_span + 3) / 4 * 4;
}

template <int kC>
__global__ void __launch_bounds__(kNibThreads, 1)
probe_nibble_kernel(const uint8_t* __restrict__ bins_t,
                    const float* __restrict__ vals_t,
                    const int32_t* __restrict__ leaf_id,
                    const int32_t* __restrict__ small_ids, int n, int F,
                    int K, int B, NibPlan p, float* __restrict__ out) {
  constexpr int T = kNibThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);          // [kTable]
  int32_t* ids = reinterpret_cast<int32_t*>(table + kTable);     // [32]
  uint16_t* bin_gv = reinterpret_cast<uint16_t*>(ids + kMaxLanes);  // [256]
  uint32_t* st_mask = reinterpret_cast<uint32_t*>(bin_gv + 256);  // [T]
  // [C][T] values, rounded to bf16 (so kept exactly in 2 bytes)
  __nv_bfloat16* st_vals = reinterpret_cast<__nv_bfloat16*>(st_mask + T);
  uint8_t* st_bins = reinterpret_cast<uint8_t*>(st_vals + kC * T);  // [span][T]
  float* tiles = reinterpret_cast<float*>(
      st_bins + (p.f_span + 3) / 4 * 4 * T);           // [slots][K][w][C]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / p.q;
  const int w = p.w;
  const int G = p.groups;
  const int lane_words = w * kC;
  const int tile_words = K * lane_words;
  // this cluster's chunk of (feature, group) pairs and its row part
  const int parts = p.clusters / p.chunks;
  const int chunk = cid / parts;
  const int p0 = chunk * p.chunk;
  const int np = min(p.chunk, F * G - p0);
  const int f_lo = p0 / G;
  const int f_hi = (p0 + np - 1) / G;            // inclusive
  // this CTA's own pairs [p0 + o0, p0 + o1) and the features they span
  const int o0 = min(np, rank * p.slots);
  const int o1 = min(np, o0 + p.slots);
  const int g_lo = (p0 + o0) / G;
  const int g_hi = o1 > o0 ? (p0 + o1 - 1) / G : g_lo - 1;
  // this CTA's rows: piece (part * Q + rank) of the row space
  const long long r_begin = min(static_cast<long long>(n),
      static_cast<long long>((cid % parts) * p.q + rank) * p.rows);
  const long long r_end = min(static_cast<long long>(n), r_begin + p.rows);

  load_lanes(table, ids, small_ids, K);
  // bin b -> u << 8 | v with b = w * u + v
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    bin_gv[b] = static_cast<uint16_t>(((b / w) << 8) | (b % w));
  }
  for (int i = threadIdx.x; i < p.slots * tile_words; i += blockDim.x) {
    tiles[i] = 0.f;
  }
  __syncthreads();

  // one staged (row, feature): the row's values into this CTA's tile of
  // the pair, if it owns the pair
  auto add = [&](int f, int b, uint32_t m, const float (&v)[kC]) {
    if (m == 0u || b >= B) return;
    const int gv = bin_gv[b];
    const int pr = f * G + (gv >> 8) - p0 - o0;
    if (static_cast<unsigned>(pr) >= static_cast<unsigned>(o1 - o0)) return;
    float* cell = tiles + pr * tile_words + (gv & 0xFF) * kC;
    for (; m; m &= m - 1u) {
      float* a = cell + (__ffs(m) - 1) * lane_words;
#pragma unroll
      for (int c = 0; c < kC; ++c) atomicAdd(a + c, v[c]);
    }
  };
  const int steps = (p.rows + T - 1) / T;
  for (int step = 0; step < steps; ++step) {
    // stage one row per thread: lane mask, bf16-rounded values, the bins
    // of the chunk's features, all loads issued together (a row past the
    // end: mask 0)
    {
      const long long r = r_begin + static_cast<long long>(step) * T
                          + threadIdx.x;
      uint32_t m = 0u;
      if (r < r_end) {
        m = lanes_of(leaf_id[r], table, ids, K);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          st_vals[c * T + threadIdx.x] =
              __float2bfloat16_rn(vals_t[static_cast<size_t>(c) * n + r]);
        }
        for (int f = f_lo; f <= f_hi; ++f) {
          st_bins[(f - f_lo) * T + threadIdx.x] =
              bins_t[static_cast<size_t>(f) * n + r];
        }
      }
      st_mask[threadIdx.x] = m;
    }
    cluster.sync();        // every CTA's stage is full
    // every CTA's staged rows, over DSMEM: a thread takes 4 rows of one
    // source CTA, four sources at a time (the own stage first), loads
    // their masks (16 bytes), values (8 bytes a channel) and this CTA's
    // features' bins (4 bytes) together, and adds the (row, feature)s
    // whose pair this CTA owns into its tiles, locally
    const int i4 = 4 * (threadIdx.x % (T / 4));
    for (int j = threadIdx.x / (T / 4); j < p.q; j += 4) {
      const unsigned src = static_cast<unsigned>((rank + j) & (p.q - 1));
      const uint4 m4 = *cluster.map_shared_rank(
          reinterpret_cast<uint4*>(st_mask + i4), src);
      const __nv_bfloat16* sv = cluster.map_shared_rank(st_vals + i4, src);
      uint2 x[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        x[c] = *reinterpret_cast<const uint2*>(sv + c * T);
      }
      const uint8_t* sb = cluster.map_shared_rank(st_bins + i4, src);
      if ((m4.x | m4.y | m4.z | m4.w) == 0u) continue;
      float v[4][kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        // a bf16 is the top half of the f32 of the same value
        v[0][c] = __uint_as_float(x[c].x << 16);
        v[1][c] = __uint_as_float(x[c].x & 0xffff0000u);
        v[2][c] = __uint_as_float(x[c].y << 16);
        v[3][c] = __uint_as_float(x[c].y & 0xffff0000u);
      }
      for (int f0 = g_lo; f0 <= g_hi; f0 += kOwnBatch) {
        uchar4 b4[kOwnBatch];
#pragma unroll
        for (int e = 0; e < kOwnBatch; ++e) {
          if (f0 + e <= g_hi) {
            b4[e] = *reinterpret_cast<const uchar4*>(sb + (f0 + e - f_lo)
                                                     * T);
          }
        }
#pragma unroll
        for (int e = 0; e < kOwnBatch; ++e) {
          if (f0 + e > g_hi) break;
          add(f0 + e, b4[e].x, m4.x, v[0]);
          add(f0 + e, b4[e].y, m4.y, v[1]);
          add(f0 + e, b4[e].z, m4.z, v[2]);
          add(f0 + e, b4[e].w, m4.w, v[3]);
        }
      }
    }
    // every CTA is done reading the stages: they may be refilled, and
    // after the last step no CTA touches another's shared memory again
    cluster.sync();
  }

  // this CTA's tiles into the zeroed output (one add per element from
  // each row part); a lane's bins of a tile are one contiguous run
  for (int s = 0; s < o1 - o0; ++s) {
    const int f = (p0 + o0 + s) / G;
    const int lo = (p0 + o0 + s - f * G) * w;
    const int run = min(w, B - lo) * kC;
    const float* t = tiles + s * tile_words;
    float* o = out + static_cast<size_t>(f) * B * kC + lo * kC;
    for (int i = threadIdx.x; i < K * run; i += blockDim.x) {
      const int k = i / run;
      const int j = i - k * run;
      const float x = t[k * lane_words + j];
      if (x != 0.f) atomicAdd(o + static_cast<size_t>(k) * F * B * kC + j, x);
    }
  }
}

// clusters of q CTAs with smem bytes each that fit on the card at once
// (0: none can be scheduled); the kernel's attributes are set, and each
// answer kept, once per instance and process
template <int kC>
int max_active_clusters(int q, int smem) {
  auto kernel = probe_nibble_kernel<kC>;
  static std::map<std::pair<int, int>, int> known;
  if (known.empty()) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmemLimit));
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  const auto key = std::make_pair(q, smem);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(q);
  cfg.blockDim = dim3(kNibThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int num = 0;
  if (cudaOccupancyMaxActiveClusters(&num, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();                  // a size the card refuses: none
    num = 0;
  }
  known[key] = num;
  return num;
}

// The rule that picks the launch. For each Q in 16, 8, 4, 2, 1: the
// fewest chunks of pairs whose tiles (and the stage of the bins they
// span) fit in Q CTAs' shared memory; as many row parts per chunk as the
// resident clusters allow (at least one); the CTAs resident at once are
// min(chunks x parts, resident clusters) x Q. The largest Q that keeps at
// least 7/8 of the best of these resident wins. cudaErrorInvalidValue
// when no Q fits, cudaErrorInvalidConfiguration when no cluster of a Q
// that fits can be scheduled.
template <int kC>
int plan_nibble(int n, int F, int K, int B, int nb, NibPlan* out) {
  const int cell_bytes = K * kC * 4;           // one bin of a tile
  // one tile fits beside a stage of up to 4 bins a row (a chunk of one
  // pair, at Q = 1, stages 1)
  const int w = std::min(std::min(nb, B),
                         (kNibBudget - kNibThreads * stage_row_bytes(kC, 4))
                         / cell_bytes);
  if (w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int G = (B + w - 1) / w;
  const int tile_bytes = w * cell_bytes;
  const long long P = static_cast<long long>(F) * G;
  NibPlan cand[5] = {};
  long long resident[5] = {};
  int rc = static_cast<int>(cudaErrorInvalidValue);
  for (int lg = 4; lg >= 0; --lg) {
    const int q = 1 << lg;
    // the most tiles per CTA that fit beside the stage of their chunk
    int slots = static_cast<int>(std::min<long long>(
        (P + q - 1) / q, kNibBudget / tile_bytes));
    long long chunk = 0;
    int span = 0;
    for (; slots >= 1; --slots) {
      chunk = std::min<long long>(P, static_cast<long long>(q) * slots);
      span = static_cast<int>(std::min<long long>(F, (chunk + G - 2) / G + 1));
      const int stage = kNibThreads * stage_row_bytes(kC, span);
      if (stage + static_cast<long long>(slots) * tile_bytes <= kNibBudget) {
        break;
      }
    }
    if (slots < 1) continue;
    slots = static_cast<int>((chunk + q - 1) / q);
    const int smem = kNibFixed
        + kNibThreads * stage_row_bytes(kC, span)
        + slots * tile_bytes;
    const int active = max_active_clusters<kC>(q, smem);
    if (active < 1) {
      rc = static_cast<int>(cudaErrorInvalidConfiguration);
      continue;
    }
    const long long chunks = (P + chunk - 1) / chunk;
    const long long parts = std::max(1LL, active / chunks);
    NibPlan& p = cand[lg];
    p.w = w;
    p.groups = G;
    p.q = q;
    p.chunk = static_cast<int>(chunk);
    p.chunks = static_cast<int>(chunks);
    p.clusters = static_cast<int>(chunks * parts);
    p.slots = slots;
    p.smem = smem;
    p.max_clusters = active;
    p.rows = static_cast<int>((n + parts * q - 1) / (parts * q));
    p.f_span = span;
    resident[lg] = std::min<long long>(p.clusters, active) * q;
  }
  const long long best = *std::max_element(resident, resident + 5);
  if (best == 0) return rc;
  for (int lg = 4; lg >= 0; --lg) {
    if (8 * resident[lg] >= 7 * best) {
      *out = cand[lg];
      return 0;
    }
  }
  return rc;                           // not reached
}

template <int kC>
int launch_nibble(const uint8_t* bins_t, const float* vals_t,
                  const int32_t* leaf_id, const int32_t* small_ids, int n,
                  int F, int K, int B, int nb, float* out,
                  cudaStream_t stream) {
  NibPlan p;
  const int rc = plan_nibble<kC>(n, F, K, B, nb, &p);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(p.clusters * p.q));
  cfg.blockDim = dim3(kNibThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, probe_nibble_kernel<kC>, bins_t, vals_t,
                     leaf_id, small_ids, n, F, K, B, p, out);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int C, int K, int B) {
  return C < 1 || C > 8 || K > kMaxLanes || B < 1 || B > 256;
}

}  // namespace

// Plain C entry points (bound with ctypes). `out` is [K, F, B, C] f32,
// zeroed by the caller. Return cudaGetLastError(), or cudaErrorInvalidValue
// for shapes the probes do not take (K > 32, C > 8, B > 256, a tile that
// does not fit in shared memory), or cudaErrorInvalidConfiguration when no
// cluster of the nibble probe can be scheduled.
#define LGBT_SWITCH_C(CALL)                                               \
  switch (C) {                                                            \
    case 1: return CALL(1);                                               \
    case 2: return CALL(2);                                               \
    case 3: return CALL(3);                                               \
    case 4: return CALL(4);                                               \
    case 5: return CALL(5);                                               \
    case 6: return CALL(6);                                               \
    case 7: return CALL(7);                                               \
    case 8: return CALL(8);                                               \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
  }

extern "C" int lgbt_hist_probe_1d(
    const void* bins_t, const void* vals_t, const void* leaf_id,
    const void* small_ids, int n, int F, int C, int K, int B, void* out,
    void* stream) {
  if (n <= 0 || F <= 0 || K <= 0) return 0;
  if (bad_shape(C, K, B)) return static_cast<int>(cudaErrorInvalidValue);
  auto b = static_cast<const uint8_t*>(bins_t);
  auto v = static_cast<const float*>(vals_t);
  auto l = static_cast<const int32_t*>(leaf_id);
  auto k = static_cast<const int32_t*>(small_ids);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define LGBT_1D(c) launch_1d<c>(b, v, l, k, n, F, K, B, o, s)
  LGBT_SWITCH_C(LGBT_1D)
#undef LGBT_1D
}

extern "C" int lgbt_hist_probe_nibble(
    const void* bins_t, const void* vals_t, const void* leaf_id,
    const void* small_ids, int n, int F, int C, int K, int B, int nb,
    void* out, void* stream) {
  if (F <= 0 || K <= 0) return 0;                 // an empty output
  if (n < 0 || bad_shape(C, K, B) || nb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto b = static_cast<const uint8_t*>(bins_t);
  auto v = static_cast<const float*>(vals_t);
  auto l = static_cast<const int32_t*>(leaf_id);
  auto k = static_cast<const int32_t*>(small_ids);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define LGBT_NIB(c) launch_nibble<c>(b, v, l, k, n, F, K, B, nb, o, s)
  LGBT_SWITCH_C(LGBT_NIB)
#undef LGBT_NIB
}

// The nibble probe's launch for these arguments, as the eleven ints of
// NibPlan (w, groups, Q, pairs per chunk, chunks, clusters, tiles
// per CTA, shared memory per CTA, resident clusters, rows per CTA,
// features a chunk spans) in `plan`. Returns 0 or the launch's error code.
extern "C" int lgbt_hist_probe_nibble_plan(int n, int F, int C, int K,
                                           int B, int nb, int* plan) {
  if (F <= 0 || K <= 0 || n < 0 || bad_shape(C, K, B) || nb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(sizeof(NibPlan) == 11 * sizeof(int), "NibPlan: 11 ints");
  NibPlan* p = reinterpret_cast<NibPlan*>(plan);
#define LGBT_PLAN(c) plan_nibble<c>(n, F, K, B, nb, p)
  LGBT_SWITCH_C(LGBT_PLAN)
#undef LGBT_PLAN
}
