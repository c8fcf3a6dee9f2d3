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
//    (hist1d), whose grid runs over row blocks only. Its question: does
//    reading each row's leaf id and values once for every feature beat
//    kernel A, which re-reads them for each block of 1-2 features?
//
//    What held its first design back (a CTA per 2048-row chunk, 512 CTAs,
//    a [K][tile][B][C] accumulator for every lane, 0.571 ms at the probe's
//    shape, F=28, n=2^20, B=256, K=16, C=3, every row in lane 0): tiles
//    for all 16 lanes left room for 3 features, so 10 feature tiles ran in
//    turn, each a zero pass, an add pass and a flush; 3.9 waves of CTAs,
//    each flushing its 28 x 768 live words with global atomics (~11M, 512
//    to an address) into an output a separate launch zeroed; one byte load
//    per (row, feature); and an f32 shared atomicAdd, a compare-and-swap
//    loop on sm_90a (ATOMS.CAST.SPIN), per (row, feature, channel).
//
//    The design:
//    - Slots for the lanes that rows carry. A CTA first numbers the
//      distinct non-negative ids of small_ids (a repeated id shares its
//      slot); in phase 0 each CTA looks up an equal part of the leaf ids
//      and stores the slots they carry in its word of the scratch, and
//      after a grid-wide barrier every CTA keeps only the slots some row
//      carries (one at the probe's shape). Lanes without one get zeros.
//    - Passes. The shared budget holds T slot tiles of W = B*C (made odd)
//      words. Where one feature's tiles fit with 32 replicas each, a pass
//      takes the features that fit with 32 replicas (two at one live
//      lane): thread lane t adds into replica t, so the f32 atomicAdd of
//      a warp never meets a bank conflict or a second lane on its address.
//      Else a pass takes as many features as fit, one replica (two at 32
//      live lanes). Each feature block of a pass is one more read of the
//      rows' ids and values (from L2).
//    - Grid: one 1024-thread CTA per SM (a cooperative launch, the CTAs
//      resident by cudaOccupancyMaxActiveBlocksPerMultiprocessor), each
//      an equal share of the (feature block, row) space. Rows are read 4
//      at a time, 16-byte loads of ids and values and 4-byte loads of the
//      bins of 4 features, issued before any is used (8 features a batch
//      spill registers at 1024 threads).
//    - No global atomics, no zero-fill: after a pass a CTA sums its
//      replicas and stores its slot tiles as a partial histogram in the
//      caller's scratch; after a second grid-wide barrier the elements of
//      the live output rows are cut into one equal run per CTA, each
//      element's partials summed with eight loads in flight (by several
//      threads where a run is short), and every output element is written.
//
//    Measured on an H100 80GB HBM3 at 700 W (PERF.md): 0.109 ms at the
//    probe's shape against 0.556 for the first design, 0.239 for kernel A
//    and 2.55 for one index_add_; 0.257 at 32 live lanes (ids uniform),
//    kernel A 0.254. Reading every row once for all 28 features (as many
//    features a pass as fit: two replicas a tile at one live lane), the
//    same kernel takes 0.219 ms: the f32 compare-and-swap loop on
//    bank-conflicted tiles costs more than 13 more reads of the ids and
//    values. With int32 adds in place of the
//    f32 loop (a stripped copy) it takes 0.076 ms, 0.070 rows-once. Tried
//    and slower (0.265 ms at the probe's shape, 7.6 ms at 32 lanes): each
//    tile owned by one warp, rows staged in shared memory, lanes that hit
//    one bin merged with __match_any_sync and no atomics.
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

// ---- probe 1: a grid of row shares, slot tiles of the carried lanes ----
constexpr int k1dThreads = 1024;
constexpr int k1dWarps = k1dThreads / 32;
constexpr int k1dMaxReplicas = 32;
// rows staged at once for the warp-owned tiles (four a thread)
constexpr int k1dStage = 4 * k1dThreads;
constexpr long long k1dMinShare = 8192;  // (block, row) units a CTA, at least
// CTAs at most
constexpr int k1dMaxCtas = 256;
constexpr int k1dOffsets = 4096;         // reduction offsets held at once
constexpr int k1dBinBatch = 4;           // features whose bins load together
// replicas a slot tile gets where one feature's tiles fit with them
// (design b): 32 make the adds free of bank conflicts, at two features a
// pass at one live lane; where they do not fit, as many features a pass
// as fit. 1 reads every row once for all the features that fit.
constexpr int k1dMinReplicas = 32;
// How a pass adds a (row, feature) into the slot tiles: false, replicas
// and shared f32 atomicAdd (design b); true, warp-owned tiles and no
// atomics (design a). The other design is timed as a variant.
constexpr bool k1dWarpTiles = false;

// the slots of small_ids, shared by the CTA: first one per distinct
// non-negative id, then one per such id that some row carries (live)
struct Meta1d {
  int live;                        // L: slots
  int tsize;                       // table entries in use (largest id + 1)
  int big;                         // a slot's id >= kTable
  int nlive;                       // lanes with a slot
  unsigned used;                   // slots the CTA's rows carry (phase 0)
  int slot_id[kMaxLanes];          // each slot's leaf id
  int lane_slot[kMaxLanes];        // each lane's slot, or -1
  int lane_order[kMaxLanes];       // lanes with a slot first, then the rest
};

constexpr int kMeta1dBytes = (sizeof(Meta1d) + 15) / 16 * 16;

// design a's stage: bf16 values [C][k1dStage] and slots [k1dStage]
template <bool kWarp, int kC>
__host__ __device__ constexpr int stage_1d_bytes() {
  return kWarp ? (k1dStage * (2 * kC + 1) + 15) / 16 * 16 : 0;
}

// the launch's shape
struct Plan1d {
  int W;        // words of one slot tile: B * C, made odd
  int tiles;    // T: slot tiles that fit in shared memory
  int grid;     // CTAs launched, all resident (a cooperative launch)
  int smem;     // dynamic shared memory per CTA
};

// the passes for L live slots, computed alike on the host and in every CTA
struct Pass1d {
  int ft;            // features per pass: as many as fit, L tiles each
  int reps;          // R: replicas of each slot tile (1 for warp tiles)
  int nfb;           // feature blocks: the times every row is read
  int ctas;          // CTAs with a share of the (block, row) space
  int smax;          // feature blocks one share touches, at most
  long long share;   // (feature block, row) units per CTA
};

__host__ __device__ inline Pass1d plan_pass(int L, int n, int F, int tiles,
                                            int grid, int vec,
                                            bool warp_tiles) {
  Pass1d q;
  const int per_feature = L * (warp_tiles ? 1 : k1dMinReplicas);
  q.ft = L > 0 ? min(F, tiles / per_feature > 0 ? tiles / per_feature
                                                : tiles / L) : F;
  int r = 1;
  if (!warp_tiles && L > 0) {
    r = tiles / (q.ft * L);
    if (r > k1dMaxReplicas) r = k1dMaxReplicas;
    while (r & (r - 1)) r &= r - 1;          // a power of two
  }
  q.reps = r;
  q.nfb = (F + q.ft - 1) / q.ft;
  const long long total = static_cast<long long>(q.nfb) * n;
  long long ctas = (total + k1dMinShare - 1) / k1dMinShare;
  if (ctas > grid) ctas = grid;
  long long share = (total + ctas - 1) / ctas;
  share = (share + vec - 1) / vec * vec;
  q.share = share;
  q.ctas = static_cast<int>((total + share - 1) / share);
  const long long smax = (share - 1) / n + 2;
  q.smax = static_cast<int>(smax < q.nfb ? smax : q.nfb);
  return q;
}

// Warp 0: one slot for each distinct non-negative id of small_ids whose
// slot so far (the rank of its first lane among the first lanes of such
// ids) is in `keep`, numbered in lane order; the leaf -> slot + 1 table
// entries of the ids dropped are cleared.
__device__ void make_slots(Meta1d& meta, uint8_t* table,
                           const int32_t* __restrict__ small_ids, int K,
                           unsigned keep) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int id = lane < K ? small_ids[lane] : -1;
  int first_of = -1;                         // first lane with this id
  for (int j = 0; j < 32; ++j) {
    const int other = __shfl_sync(full, id, j);
    if (first_of < 0 && id >= 0 && other == id) first_of = j;
  }
  const bool first = id >= 0 && first_of == lane;
  const unsigned named = __ballot_sync(full, first);
  const bool kept = id >= 0
      && (keep >> __popc(named & ((1u << first_of) - 1u)) & 1u);
  const unsigned live = __ballot_sync(full, first && kept);
  const int slot = kept ? __popc(live & ((1u << first_of) - 1u)) : -1;
  const int L = __popc(live);
  const unsigned maxid = __reduce_max_sync(
      full, kept ? static_cast<unsigned>(id) : 0u);
  meta.lane_slot[lane] = slot;
  const unsigned has = __ballot_sync(full, slot >= 0);
  const unsigned below = (1u << lane) - 1u;
  if (lane < K) {
    meta.lane_order[slot >= 0 ? __popc(has & below)
                    : __popc(has) + __popc(~has & below)] = lane;
  }
  if (first && id < kTable) {
    table[id] = kept ? static_cast<uint8_t>(slot + 1) : 0;
  }
  if (first && kept) meta.slot_id[slot] = id;
  if (lane == 0) {
    meta.live = L;
    meta.nlive = __popc(has);
    meta.used = 0u;
    meta.tsize = L > 0 ? min(static_cast<int>(maxid) + 1, kTable) : 0;
    meta.big = L > 0 && maxid >= static_cast<unsigned>(kTable);
  }
}

// slot of a leaf id, or -1: one compare skips negative ids
__device__ __forceinline__ int slot_of(int lid, const uint8_t* table,
                                       int tsize, bool big, const Meta1d& m) {
  if (static_cast<unsigned>(lid) < static_cast<unsigned>(tsize)) {
    return static_cast<int>(table[lid]) - 1;
  }
  if (big && lid >= kTable) {
    for (int s = 0; s < m.live; ++s) {
      if (m.slot_id[s] == lid) return s;
    }
  }
  return -1;
}

// four consecutive rows: their slots and bf16-rounded values
template <int kC>
struct Quad1d {
  int s[4];
  float v[4][kC];
};

// load four rows' ids (16 bytes) and values (16 bytes a channel), all
// issued before any is used, then look up the slots
template <int kC>
__device__ __forceinline__ void load_quad1d(
    Quad1d<kC>& q, int r, const float* __restrict__ vals_t,
    const int32_t* __restrict__ leaf_id, int n, const uint8_t* table,
    int tsize, bool big, const Meta1d& m) {
  const int4 lid = *reinterpret_cast<const int4*>(leaf_id + r);
  float4 x[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    x[c] = *reinterpret_cast<const float4*>(vals_t + static_cast<size_t>(c)
                                            * n + r);
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    q.v[0][c] = bf16_round(x[c].x);
    q.v[1][c] = bf16_round(x[c].y);
    q.v[2][c] = bf16_round(x[c].z);
    q.v[3][c] = bf16_round(x[c].w);
  }
  q.s[0] = slot_of(lid.x, table, tsize, big, m);
  q.s[1] = slot_of(lid.y, table, tsize, big, m);
  q.s[2] = slot_of(lid.z, table, tsize, big, m);
  q.s[3] = slot_of(lid.w, table, tsize, big, m);
}

// design b: one row's values into slot s's tile of pass feature fi,
// replica rep, with shared atomicAdd
template <int kC>
__device__ __forceinline__ void add_rep(float* tile, int tile_words, int L,
                                        int R, int rep, int B, int fi, int s,
                                        int b, const float (&v)[kC]) {
  if (s < 0 || b >= B) return;
  float* cell = tile + (fi * L + s) * tile_words + b * kC * R + rep;
#pragma unroll
  for (int c = 0; c < kC; ++c) atomicAdd(cell + c * R, v[c]);
}

// design a: 32 rows of one warp (one a lane) into the warp's own tile, no
// atomics. Lanes whose rows hit one bin are merged (__match_any_sync); the
// lowest lane of each group adds the group's sum, summed in lane order.
template <int kC>
__device__ __forceinline__ void add_warp(float* tl, bool hit, int b,
                                         const float (&v)[kC], int lane) {
  const unsigned full = 0xffffffffu;
  const unsigned peers = __match_any_sync(full, hit ? b : 256 + lane);
  if (__all_sync(full, !hit || peers == (1u << lane))) {
    if (hit) {
#pragma unroll
      for (int c = 0; c < kC; ++c) tl[b * kC + c] += v[c];
    }
    return;
  }
  const bool lead = hit && __ffs(peers) - 1 == lane;
  unsigned todo = lead ? peers & (peers - 1u) : 0u;
  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = v[c];
  while (__any_sync(full, todo != 0u)) {
    const int src = todo ? __ffs(todo) - 1 : lane;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float x = __shfl_sync(full, v[c], src);
      if (todo) acc[c] += x;
    }
    todo &= todo - 1u;
  }
  if (lead) {
#pragma unroll
    for (int c = 0; c < kC; ++c) tl[b * kC + c] += acc[c];
  }
}

template <bool kWarp, int kVec, int kC>
__global__ void __launch_bounds__(k1dThreads, 1)
probe_1d_kernel(const uint8_t* __restrict__ bins_t,
                const float* __restrict__ vals_t,
                const int32_t* __restrict__ leaf_id,
                const int32_t* __restrict__ small_ids, int n, int F, int K,
                int B, Plan1d p, float* __restrict__ scratch,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Meta1d& meta = *reinterpret_cast<Meta1d*>(smem);
  uint8_t* table = smem + kMeta1dBytes;                         // [kTable]
  unsigned char* work = table + kTable;        // the stage, then the tiles
  uint16_t* st_val = reinterpret_cast<uint16_t*>(work);   // [C][k1dStage]
  uint8_t* st_slot = reinterpret_cast<uint8_t*>(st_val + kC * k1dStage);
  float* tile = reinterpret_cast<float*>(
      work + stage_1d_bytes<kWarp, kC>());                      // [T][W]

  const int lane = threadIdx.x & 31;
  const int BC = B * kC;
  for (int i = threadIdx.x; i < kTable / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(table)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (threadIdx.x < 32) make_slots(meta, table, small_ids, K, ~0u);
  __syncthreads();

  // ---- phase 0: the slots some row carries -----------------------------
  // Each CTA looks up the ids of an equal part of the rows and stores the
  // slots they carry in its word of the scratch; after a grid-wide
  // barrier every CTA ORs the words and keeps only those slots, so tiles
  // exist only for lanes that rows fill.
  const int G = gridDim.x;
  unsigned* hits = reinterpret_cast<unsigned*>(scratch);        // [G]
  float* part = scratch + (G + 3) / 4 * 4;
  if (meta.live > 0) {
    const int tsize0 = meta.tsize;
    const bool big0 = meta.big != 0;
    const long long per = (static_cast<long long>(n) + G - 1) / G
                          / kVec * kVec + kVec;
    const long long h0 = min(static_cast<long long>(n), blockIdx.x * per);
    const long long h1 = min(static_cast<long long>(n), h0 + per);
    unsigned m = 0u;
    auto bit = [&](int lid) {
      const int s = slot_of(lid, table, tsize0, big0, meta);
      return s >= 0 ? 1u << s : 0u;
    };
    if constexpr (kVec == 4) {
      for (long long r = h0 + 4 * threadIdx.x; r < h1; r += 4 * blockDim.x) {
        const int4 lid = *reinterpret_cast<const int4*>(leaf_id + r);
        m |= bit(lid.x) | bit(lid.y) | bit(lid.z) | bit(lid.w);
      }
    } else {
      for (long long r = h0 + threadIdx.x; r < h1; r += blockDim.x) {
        m |= bit(leaf_id[r]);
      }
    }
    m = __reduce_or_sync(0xffffffffu, m);
    if (lane == 0 && m) atomicOr(&meta.used, m);
  }
  __syncthreads();
  if (threadIdx.x == 0) hits[blockIdx.x] = meta.used;
  cg::this_grid().sync();
  if (threadIdx.x < 32) {
    unsigned m = 0u;
    for (int i = lane; i < G; i += 32) m |= __ldcg(hits + i);
    make_slots(meta, table, small_ids, K,
               __reduce_or_sync(0xffffffffu, m));
  }
  __syncthreads();
  const int L = meta.live;
  const int tsize = meta.tsize;
  const bool big = meta.big != 0;
  const Pass1d q = plan_pass(L, n, F, p.tiles, gridDim.x, kVec, kWarp);
  const int R = q.reps;
  const int rep = lane & (R - 1);
  const int tile_words = R * p.W;      // one slot tile with its replicas
  // this CTA's partials: [smax][ft][L][B*C]
  const size_t seg_words = static_cast<size_t>(q.ft) * L * BC;
  const size_t cta_words = q.smax * seg_words;
  float* my_part = part + blockIdx.x * cta_words;

  // ---- phase 1: this CTA's share of (feature block, row), each block's
  // features histogrammed in one pass over its rows -------------------
  const long long total = static_cast<long long>(q.nfb) * n;
  long long pos = static_cast<long long>(blockIdx.x) * q.share;
  const long long end = min(total, pos + q.share);
  const int fb_first = static_cast<int>(pos / n);
  if (L > 0) {
    const int words = q.ft * L * tile_words;
    for (int i = threadIdx.x; i < words; i += blockDim.x) tile[i] = 0.f;
  }
  while (L > 0 && pos < end) {
    const int fb = static_cast<int>(pos / n);
    const int r0 = static_cast<int>(pos - static_cast<long long>(fb) * n);
    const int r1 = static_cast<int>(min(static_cast<long long>(n),
                                        r0 + (end - pos)));
    const int f_lo = fb * q.ft;
    const int nf = min(q.ft, F - f_lo);
    const uint8_t* bins = bins_t + static_cast<size_t>(f_lo) * n;
    __syncthreads();                     // the tiles are clear

    if constexpr (!kWarp) {
      auto add = [&](int fi, int s, int b, const float (&v)[kC]) {
        add_rep<kC>(tile, tile_words, L, R, rep, B, fi, s, b, v);
      };
      if constexpr (kVec == 4) {
        for (int r = r0 + 4 * threadIdx.x; r < r1; r += 4 * blockDim.x) {
          Quad1d<kC> g;
          load_quad1d<kC>(g, r, vals_t, leaf_id, n, table, tsize, big, meta);
          if ((g.s[0] & g.s[1] & g.s[2] & g.s[3]) < 0) continue;  // no match
          for (int f0 = 0; f0 < nf; f0 += k1dBinBatch) {
            uchar4 b4[k1dBinBatch];
#pragma unroll
            for (int e = 0; e < k1dBinBatch; ++e) {
              if (f0 + e < nf) {
                b4[e] = *reinterpret_cast<const uchar4*>(
                    bins + static_cast<size_t>(f0 + e) * n + r);
              }
            }
#pragma unroll
            for (int e = 0; e < k1dBinBatch; ++e) {
              if (f0 + e >= nf) break;
              add(f0 + e, g.s[0], b4[e].x, g.v[0]);
              add(f0 + e, g.s[1], b4[e].y, g.v[1]);
              add(f0 + e, g.s[2], b4[e].z, g.v[2]);
              add(f0 + e, g.s[3], b4[e].w, g.v[3]);
            }
          }
        }
      } else {
        for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
          const int s = slot_of(leaf_id[r], table, tsize, big, meta);
          if (s < 0) continue;
          float v[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            v[c] = bf16_round(vals_t[static_cast<size_t>(c) * n + r]);
          }
          for (int fi = 0; fi < nf; ++fi) {
            add(fi, s, bins[static_cast<size_t>(fi) * n + r], v);
          }
        }
      }
    } else {
      const int warp = threadIdx.x >> 5;
      for (int c0 = r0; c0 < r1; c0 += k1dStage) {
        const int cn = min(k1dStage, r1 - c0);
        // stage the chunk: slots (0xFF: no lane; also past its end) and
        // bf16 values, each row's id and values read once
        if constexpr (kVec == 4) {
          const int i = 4 * threadIdx.x;
          if (i < cn) {
            Quad1d<kC> g;
            load_quad1d<kC>(g, c0 + i, vals_t, leaf_id, n, table, tsize, big,
                            meta);
            uint32_t sl = 0u;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sl |= static_cast<uint32_t>(g.s[j] & 0xFF) << (8 * j);
            }
            *reinterpret_cast<uint32_t*>(st_slot + i) = sl;
#pragma unroll
            for (int c = 0; c < kC; ++c) {
              *reinterpret_cast<uint2*>(st_val + c * k1dStage + i) =
                  make_uint2((__float_as_uint(g.v[0][c]) >> 16)
                                 | (__float_as_uint(g.v[1][c]) & 0xffff0000u),
                             (__float_as_uint(g.v[2][c]) >> 16)
                                 | (__float_as_uint(g.v[3][c]) & 0xffff0000u));
            }
          }
        } else {
          for (int i = threadIdx.x; i < (cn + 3) / 4 * 4; i += blockDim.x) {
            int s = -1;
            if (i < cn) {
              s = slot_of(leaf_id[c0 + i], table, tsize, big, meta);
#pragma unroll
              for (int c = 0; c < kC; ++c) {
                st_val[c * k1dStage + i] = static_cast<uint16_t>(
                    __float_as_uint(bf16_round(
                        vals_t[static_cast<size_t>(c) * n + c0 + i])) >> 16);
              }
            }
            st_slot[i] = static_cast<uint8_t>(s & 0xFF);
          }
        }
        __syncthreads();
        // warp w adds to the tiles t = w, w + 32, ... (t = fi * L + s):
        // 4 rows a lane, 128 a warp, their bins read with one 4-byte load
        for (int t = warp; t < nf * L; t += k1dWarps) {
          const int fi = t / L;
          const int s = t - fi * L;
          const uint8_t* bf = bins + static_cast<size_t>(fi) * n + c0;
          float* tl = tile + t * p.W;
          for (int i0 = 0; i0 < cn; i0 += 128) {
            const int i = i0 + 4 * lane;
            uint32_t sl = 0xffffffffu;
            uint32_t b4 = 0u;
            uint2 x[kC] = {};
            if (i < cn) {
              sl = *reinterpret_cast<const uint32_t*>(st_slot + i);
              if constexpr (kVec == 4) {
                b4 = *reinterpret_cast<const uint32_t*>(bf + i);
              } else {
                for (int j = 0; j < 4 && i + j < cn; ++j) {
                  b4 |= static_cast<uint32_t>(bf[i + j]) << (8 * j);
                }
              }
#pragma unroll
              for (int c = 0; c < kC; ++c) {
                x[c] = *reinterpret_cast<const uint2*>(st_val + c * k1dStage
                                                       + i);
              }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int b = (b4 >> (8 * j)) & 0xFF;
              const bool hit = static_cast<int>((sl >> (8 * j)) & 0xFF) == s
                               && b < B;
              float v[kC];
#pragma unroll
              for (int c = 0; c < kC; ++c) {
                // a bf16 is the top half of the f32 of the same value
                const uint32_t w = j < 2 ? x[c].x : x[c].y;
                v[c] = __uint_as_float(j % 2 == 0 ? w << 16
                                                  : w & 0xffff0000u);
              }
              add_warp<kC>(tl, hit, b, v, lane);
            }
          }
        }
        __syncthreads();                 // the stage may be refilled
      }
    }
    __syncthreads();

    // the block's tiles -> this CTA's partials: sum the replicas (in an
    // order rotated by the cell, so a warp's reads fall in distinct
    // banks) and clear them for the next block (cell i = t * BC + rem)
    float* seg = my_part + static_cast<size_t>(fb - fb_first) * seg_words;
    const int cells = nf * L * BC;
    int t = threadIdx.x / BC;
    int rem = threadIdx.x - t * BC;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      float* w = tile + t * tile_words + rem * R;
      float v;
      if (R == 1) {
        v = w[0];
        w[0] = 0.f;
      } else {
        v = 0.f;
        for (int j = 0; j < R; ++j) {
          const int x = (j + i) & (R - 1);
          v += w[x];
          w[x] = 0.f;
        }
      }
      seg[i] = v;
      rem += blockDim.x;
      while (rem >= BC) {
        rem -= BC;
        ++t;
      }
    }
    pos += r1 - r0;
  }

  // ---- phase 2: partials -> output rows (k, f), in CTA order ----------
  cg::this_grid().sync();
  // The elements of the output rows (k, f) of lanes with a slot, in row
  // order, are cut into one equal run per CTA. A CTA takes its run in
  // batches of whole rows whose (row, contributing CTA) partial offsets
  // fit in shared memory (the stage and tiles are free now). Where a
  // batch has fewer elements than threads, the threads form groups of
  // one thread per element, each group sums an equal share of the
  // contributing CTAs and the group sums are added in group order; else
  // each thread sums all partials of its elements. Eight loads in flight.
  // The zero rows of the other lanes follow.
  float* gsum = reinterpret_cast<float*>(work);           // [k1dThreads]
  long long* off = reinterpret_cast<long long*>(
      work + sizeof(float) * k1dThreads);                 // [k1dOffsets]
  const int max_nc = min(q.ctas, static_cast<int>((n + q.share - 1)
                                                  / q.share) + 1);
  const int batch_rows = max(1, k1dOffsets / max_nc);
  const long long total_e = static_cast<long long>(meta.nlive) * F * BC;
  const long long run = (total_e + G - 1) / G;
  long long e_lo = min(total_e, blockIdx.x * run);
  const long long e_end = min(total_e, e_lo + run);
  while (e_lo < e_end) {
    const int row0 = static_cast<int>(e_lo / BC);
    const long long e_hi = min(e_end, static_cast<long long>(row0
                                                             + batch_rows)
                                          * BC);
    const int ne = static_cast<int>(e_hi - e_lo);
    const int nrows = static_cast<int>((e_hi - 1) / BC) - row0 + 1;
    __syncthreads();                           // off and gsum are free
    for (int x = threadIdx.x; x < nrows * max_nc; x += blockDim.x) {
      const int t = x / max_nc;
      const int row = row0 + t;
      const int kl = meta.lane_order[row / F];
      const int f = row % F;
      const int fb = f / q.ft;
      const int c = static_cast<int>(static_cast<long long>(fb) * n
                                     / q.share) + x - t * max_nc;
      const bool in = c < q.ctas
          && static_cast<long long>(c) * q.share
             < static_cast<long long>(fb + 1) * n;
      const int j = in ? fb - static_cast<int>(static_cast<long long>(c)
                                               * q.share / n) : 0;
      off[x] = in ? static_cast<long long>(
          static_cast<size_t>(c) * cta_words + j * seg_words
          + (static_cast<size_t>(f - fb * q.ft) * L + meta.lane_slot[kl])
            * BC) : -1;
    }
    __syncthreads();
    const int groups = max(1, min(max_nc, static_cast<int>(blockDim.x)
                                          / ne));
    const int per = (max_nc + groups - 1) / groups;
    for (int x = threadIdx.x; x < ne * groups; x += blockDim.x) {
      const int g = x / ne;
      const long long e = e_lo + (x - g * ne);
      const int row = static_cast<int>(e / BC);
      const int i = static_cast<int>(e - static_cast<long long>(row) * BC);
      const long long* o_t = off + (row - row0) * max_nc;
      const int c_end = min(max_nc, (g + 1) * per);
      float v = 0.f;
      for (int c0 = g * per; c0 < c_end; c0 += 8) {
        float y[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const long long o = c0 + t < c_end ? o_t[c0 + t] : -1;
          y[t] = o >= 0 ? __ldcg(part + o + i) : 0.f;
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) v += y[t];
      }
      if (groups == 1) {
        out[(static_cast<size_t>(meta.lane_order[row / F]) * F + row % F)
            * BC + i] = v;
      } else {
        gsum[x] = v;
      }
    }
    if (groups > 1) {
      __syncthreads();
      for (int x = threadIdx.x; x < ne; x += blockDim.x) {
        const long long e = e_lo + x;
        const int row = static_cast<int>(e / BC);
        const int i = static_cast<int>(e - static_cast<long long>(row) * BC);
        float v = gsum[x];
        for (int h = 1; h < groups; ++h) v += gsum[h * ne + x];
        out[(static_cast<size_t>(meta.lane_order[row / F]) * F + row % F)
            * BC + i] = v;
      }
    }
    e_lo = e_hi;
  }
  const int dead_rows = (K - meta.nlive) * F;
  for (int row = blockIdx.x; row < dead_rows; row += G) {
    const int kl = meta.lane_order[meta.nlive + row / F];
    float* o = out + (static_cast<size_t>(kl) * F + row % F) * BC;
    for (int i = threadIdx.x; i < BC; i += blockDim.x) o[i] = 0.f;
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// The launch for these arguments: slot tiles and shared memory from the
// budget, one CTA per SM (as many as are resident with that shared
// memory: cudaOccupancyMaxActiveBlocksPerMultiprocessor), capped by the
// work. cudaErrorInvalidValue when the tiles of min(K, 32) slots of one
// feature do not fit, cudaErrorCooperativeLaunchTooLarge when no CTA is
// resident.
template <bool kWarp, int kVec, int kC>
int plan_1d(int n, int F, int K, int B, Plan1d* p) {
  auto kernel = probe_1d_kernel<kWarp, kVec, kC>;
  static std::map<int, int> resident;        // smem -> CTAs per SM
  p->W = (B * kC) | 1;                       // odd: tiles never alias banks
  const int fixed = kMeta1dBytes + kTable + stage_1d_bytes<kWarp, kC>();
  p->tiles = (static_cast<int>(kSmemLimit) - fixed) / (p->W * 4);
  if (p->tiles < std::min(K, kMaxLanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p->smem = fixed + p->tiles * p->W * 4;
  if (resident.empty()) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmemLimit));
  }
  auto it = resident.find(p->smem);
  if (it == resident.end()) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, k1dThreads, p->smem) != cudaSuccess) {
      cudaGetLastError();
      per_sm = 0;
    }
    it = resident.emplace(p->smem, per_sm).first;
  }
  if (it->second < 1) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  long long grid = std::min<long long>(it->second * num_sms(), k1dMaxCtas);
  grid = std::min(grid, (static_cast<long long>(F) * n + k1dMinShare - 1)
                        / k1dMinShare);
  p->grid = static_cast<int>(std::max(1LL, grid));
  return 0;
}

// scratch words for any number of live slots up to min(K, 32): a word
// per CTA (phase 0), then the partial histograms
size_t scratch_1d(const Plan1d& p, int n, int F, int K, int B, int C,
                  int vec, bool warp_tiles) {
  size_t most = 0;
  for (int L = 1; L <= std::min(K, kMaxLanes); ++L) {
    const Pass1d q = plan_pass(L, n, F, p.tiles, p.grid, vec, warp_tiles);
    most = std::max(most, static_cast<size_t>(q.ctas) * q.smax * q.ft * L
                              * B * C);
  }
  return (p.grid + 3) / 4 * 4 + most;
}

template <bool kWarp, int kVec, int kC>
int launch_1d(const uint8_t* bins_t, const float* vals_t,
              const int32_t* leaf_id, const int32_t* small_ids, int n, int F,
              int K, int B, float* scratch, float* out, cudaStream_t stream) {
  Plan1d p;
  const int rc = plan_1d<kWarp, kVec, kC>(n, F, K, B, &p);
  if (rc != 0) return rc;
  auto kernel = probe_1d_kernel<kWarp, kVec, kC>;
  void* args[] = {&bins_t, &vals_t, &leaf_id, &small_ids, &n, &F, &K, &B,
                  &p, &scratch, &out};
  cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                              dim3(static_cast<unsigned>(p.grid)),
                              dim3(k1dThreads), args,
                              static_cast<size_t>(p.smem), stream);
  return static_cast<int>(cudaGetLastError());
}

// the 4-row path needs whole groups of 4 and 16-byte aligned rows
bool vec_rows(const void* bins_t, const void* vals_t, const void* leaf_id,
              int n) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(vals_t) % 16 == 0
      && reinterpret_cast<uintptr_t>(leaf_id) % 16 == 0
      && reinterpret_cast<uintptr_t>(bins_t) % 4 == 0;
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

// Plain C entry points (bound with ctypes). Return cudaGetLastError(), or
// cudaErrorInvalidValue for shapes the probes do not take (K > 32, C > 8,
// B > 256, tiles that do not fit in shared memory),
// cudaErrorInvalidConfiguration when no cluster of the nibble probe can
// be scheduled, or cudaErrorCooperativeLaunchTooLarge when no CTA of the
// 1-D probe is resident.
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

// The 1-D probe's launch shape for these arguments with `live` distinct
// non-negative lane ids, as eleven long longs in `plan`: words of a slot
// tile, slot tiles, CTAs launched, shared memory per CTA, features per
// pass, replicas, feature blocks (reads of every row), CTAs with a share,
// feature blocks per share at most, (block, row) units per share, and
// the scratch bytes of the launch. Returns 0 or the launch's error code.
extern "C" int lgbt_hist_probe_1d_plan(const void* bins_t, const void* vals_t,
                                       const void* leaf_id, int n, int F,
                                       int C, int K, int B, int live,
                                       long long* plan) {
  if (n <= 0 || F <= 0 || K <= 0 || bad_shape(C, K, B) || live < 0
      || live > std::min(K, kMaxLanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = vec_rows(bins_t, vals_t, leaf_id, n) ? 4 : 1;
  Plan1d p;
#define LGBT_P(c) (vec == 4 ? plan_1d<k1dWarpTiles, 4, c>(n, F, K, B, &p) \
                            : plan_1d<k1dWarpTiles, 1, c>(n, F, K, B, &p))
  const int rc = [&]() -> int { LGBT_SWITCH_C(LGBT_P) }();
#undef LGBT_P
  if (rc != 0) return rc;
  const Pass1d q = plan_pass(live, n, F, p.tiles, p.grid, vec, k1dWarpTiles);
  const long long v[11] = {
      p.W, p.tiles, p.grid, p.smem, q.ft, q.reps, q.nfb, q.ctas, q.smax,
      q.share,
      4LL * q.ctas * q.smax * q.ft * live * B * C};
  std::copy(v, v + 11, plan);
  return 0;
}

// Bytes of scratch lgbt_hist_probe_1d needs for these arguments (0 when
// the shape is refused).
extern "C" long long lgbt_hist_probe_1d_scratch(
    const void* bins_t, const void* vals_t, const void* leaf_id, int n,
    int F, int C, int K, int B) {
  if (n <= 0 || F <= 0 || K <= 0 || bad_shape(C, K, B)) return 0;
  const int vec = vec_rows(bins_t, vals_t, leaf_id, n) ? 4 : 1;
  Plan1d p;
#define LGBT_P(c) (vec == 4 ? plan_1d<k1dWarpTiles, 4, c>(n, F, K, B, &p) \
                            : plan_1d<k1dWarpTiles, 1, c>(n, F, K, B, &p))
  const int rc = [&]() -> int { LGBT_SWITCH_C(LGBT_P) }();
#undef LGBT_P
  if (rc != 0) return 0;
  return 4LL * static_cast<long long>(
      scratch_1d(p, n, F, K, B, C, vec, k1dWarpTiles));
}

// Writes every element of `out` ([K, F, B, C] float32); `scratch` holds
// at least the bytes lgbt_hist_probe_1d_scratch gives, in any state. n, F
// and K are positive.
extern "C" int lgbt_hist_probe_1d(
    const void* bins_t, const void* vals_t, const void* leaf_id,
    const void* small_ids, int n, int F, int C, int K, int B, void* scratch,
    void* out, void* stream) {
  if (n <= 0 || F <= 0 || K <= 0 || bad_shape(C, K, B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto b = static_cast<const uint8_t*>(bins_t);
  auto v = static_cast<const float*>(vals_t);
  auto l = static_cast<const int32_t*>(leaf_id);
  auto k = static_cast<const int32_t*>(small_ids);
  auto w = static_cast<float*>(scratch);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_rows(bins_t, vals_t, leaf_id, n);
#define LGBT_1D(c) (vec ? launch_1d<k1dWarpTiles, 4, c>(b, v, l, k, n, F, K, \
                                                        B, w, o, s)          \
                        : launch_1d<k1dWarpTiles, 1, c>(b, v, l, k, n, F, K, \
                                                        B, w, o, s))
  LGBT_SWITCH_C(LGBT_1D)
#undef LGBT_1D
}

// `out` is [K, F, B, C] f32, zeroed by the caller.
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
