// Multi-leaf histogram kernel for Hopper (sm_90a): kernel A.
//
// Replaces the Pallas TPU kernel lightgbm_tpu/ops/pallas_histogram.py
// (multi_leaf_histogram, body _hist_kernel). Contract:
//
//   hist[k, f, b, c] = sum_r [bins_t[f, r] == b] * [leaf_id[r] == small_ids[k]]
//                            * vals_t[c, r]      (rows with leaf_id[r] >= 0)
//
// bins_t [F, n] uint8 (B <= 256) or uint16 (B <= 65,536), vals_t [C, n]
// f32, leaf_id [n] i32, small_ids [K] i32, output [K, F, B, C] f32, every
// element written. A row with a negative
// leaf id matches no lane and a lane with a negative id gets a zero
// histogram (the rule the reference documents for -1 lanes). In f32 mode
// each added value is rounded to bf16 first and summed in f32 (the TPU
// kernel's bf16 operands, f32 accumulation); in int mode the values are
// integer levels summed exactly in int32 and converted to f32 at the end.
//
// What bounds it on an H100: bytes. One call must read leaf_id (4 n B),
// the bins and values of the rows that match a lane ((F + 4 C) B each)
// and write K F B C 4 B: 0.014-0.027 ms at 2M rows. The TPU kernel's
// one-hot matmul existed because the TPU has no scatter-add; in tensor
// cores it would need 2 F B K C operations a row, 0.7 ms at 1M rows at
// the int8 peak. On the card the CUDA LightGBM form is the right one:
// per-CTA shared-memory histograms built with shared atomics.
//
// What held the first design back, measured on the nine calls of real
// trees (PERF.md; grid feature x row chunk x lane group, a
// [bin][lane][channel] tile, 512 threads, two CTAs per SM, a zeroed int32
// output and a cast in the wrapper):
// - Bank aliasing. At 32 lanes and 3 channels a bin's stride was 96 words,
//   0 mod 32 banks, so all bins of one (lane, channel) sat in one bank. At
//   the root (one live lane, every row) the shared atomics took 0.55 of
//   0.69 ms at 1M rows and 1.10 of 1.34 ms at 2M rows.
// - f32 shared atomicAdd is a compare-and-swap loop on sm_90a
//   (ATOMS.CAST.SPIN in the SASS; int32 is a native ATOMS.ADD), so under
//   that contention f32 mode took 11.1 ms at the 1M-row root.
// - The scan alone (no atomics) took 0.09 ms at 1M rows and 0.20 ms at 2M:
//   each of the 28 feature CTAs re-read a row's id and values (16 B) for
//   1 B of bins.
// - The wrapper's zero-fill and cast took 0.02-0.05 ms a call, two more
//   launches; the global-atomic flush 0.004-0.026 ms.
// - -1 rows of span rounds matched the -1 lanes and piled into them.
//
// Design:
// - Live-lane compaction. A CTA reads small_ids once: each distinct
//   non-negative id gets a compact slot (a repeated id shares its slot and
//   every lane that names it gets the slot's sums). Tiles exist only for
//   live slots.
// - A leaf -> slot table in shared memory for ids below kTable. One
//   unsigned compare against the largest live id skips a negative (or
//   unknown) leaf id before any lookup; larger ids fall back to a scan of
//   the live ids only when one of them is that large.
// - Feature blocks and replicas. The shared budget (~224 KiB, one CTA of
//   1024 threads per SM) holds T slot tiles of W = B*C (made odd) words.
//   A CTA's share of rows covers a block of fbw features (2 from 2^19
//   rows on, else 1: two halve the re-reads of ids and values but double
//   the partial histograms). With L live slots it histograms Ft <= fbw
//   features per pass, reading each row's id and values once for them,
//   and keeps R = 2^j <= 32 replicas of each tile (Ft * L * R <= T);
//   thread lane t adds into replica t % R. At one live lane that is 32
//   replicas: no two threads of a warp touch one address, whatever the
//   bins.
// - No bank aliasing: a slot tile's words are [bin][channel][replica] and
//   the tile stride R * W is R times an odd number, so for one (bin,
//   channel) the L x R (slot, replica) words of a warp fall in distinct
//   banks.
// - Grid: one CTA per SM, each taking an equal share of its lane group's
//   (feature block, row) space, so all SMs finish together. Rows are read
//   4 at a time, the ids, values and bins of a group all issued before
//   any is used: 16-byte loads of ids and values and a 4-byte load of
//   bins per feature (n % 4 == 0 and aligned rows; a scalar loop
//   otherwise). One group per thread in flight: two spill registers at
//   1024 threads and ran 1.4x slower.
// - No global atomics, no zeroed output, no cast: after a pass a CTA sums
//   its replicas (in an order rotated by the cell, so a warp's reads fall
//   in distinct banks) and stores its slot tiles as a partial histogram in
//   the caller's scratch. The launch is cooperative; after a grid-wide
//   barrier the CTAs share out the output rows of live lanes, sum each
//   element's partials in CTA order with eight loads in flight, and write
//   every output element as f32 (zeros for inactive lanes). One launch.
//
// Wide bins (uint16 bin ids, B up to 65,536; lgbt_multi_leaf_histogram_u16):
// the same kernel, instantiated for 2-byte bins (8-byte loads of a row
// group's bins). A slot tile of B C words grows with B: about 12 KiB at
// B = 1024 and C = 3, so 18 tiles fit and a lane group holds 18 lanes (K =
// 32 runs as two groups, each reading the rows once); 48 KiB at B = 4096
// (4 tiles). Where one tile cannot hold B bins (B C > ~58k words, B >
// ~19k at C = 3) each feature is cut into nw bin windows of bw bins, and
// (feature, window) pairs take the place of features: a pass adds only
// the rows whose bin falls in its window, so every row is read once a
// window. Int mode stays exact in any order; f32 mode sums in another
// order than the plain version, within the same tolerance as at B <= 256.
// The uint8 instances are unchanged.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLanes = 32;     // lanes per group (one bit each)
constexpr int kMaxChannels = 8;
constexpr int kMaxReplicas = 32;
constexpr int kFeatBlock = 2;     // features of one share's block, at most
constexpr int kWideRows = 1 << 19;  // from this n on, blocks of 2 features
constexpr int kTable = 2048;      // leaf ids with a direct table entry
constexpr int kSmemBytes = 232448;     // 227 KiB: one CTA's shared memory
constexpr long long kMinShare = 8192;  // (feature block, row) units a CTA
// CTAs of one lane group, at most (it bounds the reduction's offset
// table, kRowBatch x contributing CTAs x 8 B, inside the tiles)
constexpr int kMaxCtas = 256;
constexpr int kRowBatch = 32;          // output rows per reduction step

// bins of one row group: 4 bytes for uint8 ids, 8 for uint16
template <typename BinT>
using Bins4 = typename std::conditional<sizeof(BinT) == 1, uchar4,
                                        ushort4>::type;

// the lane group's live slots, shared by the CTA
struct Meta {
  int live;                        // L: distinct non-negative ids
  int reps;                        // R
  int ftile;                       // Ft
  int tsize;                       // table entries in use (largest id + 1)
  int big;                         // a live id >= kTable
  int nlive;                       // lanes with a live slot
  int slot_id[kMaxLanes];          // each slot's leaf id
  int lane_slot[kMaxLanes];        // each lane's slot, or -1
  int lane_order[kMaxLanes];       // lanes with a slot first, then the rest
};

constexpr int kMetaBytes = (sizeof(Meta) + 15) / 16 * 16;

// the launch's shape, computed the same way for the scratch query
struct Plan {
  int bw;           // bins of one window (B, unless one tile cannot hold B)
  int nw;           // windows a feature (1 unless the tile cannot hold B)
  int fv;           // features x windows: the row space's "features"
  int W;            // words of one slot tile (odd)
  int tiles;        // T
  int lanes;        // lanes per group
  int groups;
  int ctas;         // CTAs per group
  int smax;         // feature blocks one CTA's share touches, at most
  int fbw;          // features of one block (1 or kFeatBlock; 1 if nw > 1)
  long long share;  // (feature block, row) units per CTA
  int smem;
  size_t scratch;   // partial words
};

constexpr int kFixedBytes = kMetaBytes + kTable;

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

Plan make_plan(int n, int F, int C, int K, int B, int vec) {
  Plan p;
  // bin windows: as few as let one tile (bw C words, made odd) fit
  const int bw_max = ((kSmemBytes - kFixedBytes) / 4 - 1) / C;
  p.nw = (B + bw_max - 1) / bw_max;
  p.bw = (B + p.nw - 1) / p.nw;
  p.fv = F * p.nw;
  p.W = (p.bw * C) | 1;               // odd: tiles never alias banks
  const int fixed = kFixedBytes;
  p.tiles = (kSmemBytes - fixed) / (p.W * 4);
  p.lanes = min(min(kMaxLanes, K), p.tiles);
  p.groups = (K + p.lanes - 1) / p.lanes;
  p.smem = fixed + p.tiles * p.W * 4;
  // one CTA per SM in all (a cooperative launch), each group's (feature
  // block, row) space cut into equal shares of whole groups of vec rows
  // two features a block halve the rows' re-reads, at twice the
  // partial histograms; below kWideRows rows the partials cost more. A
  // (feature, bin window) pair takes a block of its own
  p.fbw = n >= kWideRows && p.nw == 1 ? kFeatBlock : 1;
  const long long nfb = (p.fv + p.fbw - 1) / p.fbw;
  const long long total = nfb * n;
  long long ctas = max(1, min(num_sms() / p.groups, kMaxCtas));
  ctas = min(ctas, (total + kMinShare - 1) / kMinShare);
  long long share = (total + ctas - 1) / ctas;
  share = (share + vec - 1) / vec * vec;
  p.share = share;
  p.ctas = static_cast<int>((total + share - 1) / share);
  p.smax = static_cast<int>((share - 1) / n + 2);
  p.scratch = static_cast<size_t>(p.groups) * p.ctas * p.smax * p.fbw
              * p.lanes * p.bw * C;
  return p;
}

// one row's channel values, passed by value so they stay in registers
template <typename T, int kC>
struct Row {
  T x[kC];
};

template <bool kIntMode, int kC>
__device__ __forceinline__ auto to_acc(const float (&x)[kC]) {
  using acc_t = typename std::conditional<kIntMode, int32_t, float>::type;
  Row<acc_t, kC> v;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if constexpr (kIntMode) {
      v.x[c] = __float2int_rn(x[c]);
    } else {
      v.x[c] = __bfloat162float(__float2bfloat16_rn(x[c]));
    }
  }
  return v;
}

// slot of a leaf id, or -1: one compare skips negative ids
__device__ __forceinline__ int slot_of(int lid, const uint8_t* table,
                                       int tsize, bool big, const Meta& m) {
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

// four consecutive rows: their slots, values and the pass's bins
template <typename BinT, bool kIntMode, int kC>
struct Quad {
  using acc_t = typename std::conditional<kIntMode, int32_t, float>::type;
  int s[4];
  Bins4<BinT> b[kFeatBlock];
  Row<acc_t, kC> v[4];
};

// load four consecutive rows' ids, values and the pass's bins (all loads
// issued together), then look up the ids' slots
template <typename BinT, bool kIntMode, int kC>
__device__ __forceinline__ void load_quad(
    Quad<BinT, kIntMode, kC>& q, int r, int r1,
    const BinT* __restrict__ bins,
    const float* __restrict__ vals_t, const int32_t* __restrict__ leaf_id,
    int n, int nft, const uint8_t* table, int tsize, bool big,
    const Meta& m) {
  q.s[0] = q.s[1] = q.s[2] = q.s[3] = -1;
  if (r >= r1) return;
  const int4 lid = *reinterpret_cast<const int4*>(leaf_id + r);
  float x[4][kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(
        vals_t + static_cast<size_t>(c) * n + r);
    x[0][c] = v.x;
    x[1][c] = v.y;
    x[2][c] = v.z;
    x[3][c] = v.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) q.v[i] = to_acc<kIntMode, kC>(x[i]);
#pragma unroll
  for (int fi = 0; fi < kFeatBlock; ++fi) {
    if (fi < nft) {
      q.b[fi] = *reinterpret_cast<const Bins4<BinT>*>(
          bins + static_cast<size_t>(fi) * n + r);
    }
  }
  q.s[0] = slot_of(lid.x, table, tsize, big, m);
  q.s[1] = slot_of(lid.y, table, tsize, big, m);
  q.s[2] = slot_of(lid.z, table, tsize, big, m);
  q.s[3] = slot_of(lid.w, table, tsize, big, m);
}

// add one row's values to slot s's tile of pass feature fi (replica rep);
// the tile holds bins [lo, lo + B) (lo = 0 but in a bin window)
template <typename acc_t, int kC>
__device__ __forceinline__ void add_row(acc_t* tile, int tile_words, int L,
                                        int R, int rep, int B, int fi, int s,
                                        int b, const Row<acc_t, kC>& v,
                                        int lo = 0) {
  b -= lo;
  // b outside [0, B): no bin to add to (one unsigned compare)
  if (s < 0 || static_cast<unsigned>(b) >= static_cast<unsigned>(B)) return;
  acc_t* cell = tile + (fi * L + s) * tile_words + b * kC * R + rep;
#pragma unroll
  for (int c = 0; c < kC; ++c) atomicAdd(cell + c * R, v.x[c]);
}

template <typename BinT, bool kIntMode, int kVec, int kC>
__global__ void __launch_bounds__(kThreads, 1)
hist_kernel(const BinT* __restrict__ bins_t,
            const float* __restrict__ vals_t,
            const int32_t* __restrict__ leaf_id,
            const int32_t* __restrict__ small_ids, int n, int F, int K,
            int B, Plan p, void* __restrict__ scratch,
            float* __restrict__ out) {
  constexpr int C = kC;
  using acc_t = typename std::conditional<kIntMode, int32_t, float>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  Meta& meta = *reinterpret_cast<Meta*>(smem);
  uint8_t* table = smem + kMetaBytes;                           // [kTable]
  acc_t* tile = reinterpret_cast<acc_t*>(table + kTable);       // [T][W]
  acc_t* part = reinterpret_cast<acc_t*>(scratch);

  const int g = blockIdx.y;
  const int k0 = g * p.lanes;
  const int kg = min(p.lanes, K - k0);
  const int lane = threadIdx.x & 31;
  const int BC = p.bw * C;             // words of one (window's) tile row
  const int Fv = p.fv;                 // features x windows
  // this CTA's partials: [smax][fbw][lanes][bw*C]
  const size_t seg_words = static_cast<size_t>(p.fbw) * p.lanes * BC;
  const size_t cta_words = p.smax * seg_words;
  acc_t* my_part = part + (static_cast<size_t>(g) * p.ctas + blockIdx.x)
                          * cta_words;

  for (int i = threadIdx.x; i < kTable / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(table)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // compact slots: the first lane of each distinct non-negative id
    const int id = lane < kg ? small_ids[k0 + lane] : -1;
    int first_of = -1;                       // first lane with this id
    for (int j = 0; j < 32; ++j) {
      const int other = __shfl_sync(0xffffffffu, id, j);
      if (first_of < 0 && id >= 0 && other == id) first_of = j;
    }
    const bool first = id >= 0 && first_of == lane;
    const uint32_t live = __ballot_sync(0xffffffffu, first);
    const int slot = id >= 0 ? __popc(live & ((1u << first_of) - 1u)) : -1;
    const int L = __popc(live);
    const unsigned maxid = __reduce_max_sync(
        0xffffffffu, id >= 0 ? static_cast<unsigned>(id) : 0u);
    meta.lane_slot[lane] = slot;
    const uint32_t has = __ballot_sync(0xffffffffu, slot >= 0);
    const uint32_t below = (1u << lane) - 1u;
    if (lane < kg) {
      meta.lane_order[slot >= 0 ? __popc(has & below)
                      : __popc(has) + __popc(~has & below)] = lane;
    }
    if (first) {
      meta.slot_id[slot] = id;
      if (id < kTable) table[id] = static_cast<uint8_t>(slot + 1);
    }
    if (lane == 0) {
      meta.live = L;
      meta.nlive = __popc(has);
      meta.tsize = L > 0 ? min(static_cast<int>(maxid) + 1, kTable) : 0;
      meta.big = L > 0 && maxid >= static_cast<unsigned>(kTable);
      const int ft = L > 0 ? min(p.fbw, p.tiles / L) : 1;
      int r = L > 0 ? min(kMaxReplicas, p.tiles / (L * ft)) : 1;
      while (r & (r - 1)) r &= r - 1;          // a power of two
      meta.ftile = ft;
      meta.reps = r;
    }
  }
  __syncthreads();
  const int L = meta.live;
  const int R = meta.reps;
  const int Ft = meta.ftile;
  const int tsize = meta.tsize;
  const bool big = meta.big != 0;
  const int rep = lane & (R - 1);
  const int tile_words = R * p.W;      // one slot tile with its replicas

  // ---- phase 1: this CTA's share, into partial histograms ------------
  const long long nfb = (Fv + p.fbw - 1) / p.fbw;
  const long long total = nfb * n;
  long long pos = static_cast<long long>(blockIdx.x) * p.share;
  const long long end = min(total, pos + p.share);
  const int fb_first = static_cast<int>(pos / n);
  if (L > 0) {
    const int words = Ft * L * tile_words;
    for (int i = threadIdx.x; i < words; i += blockDim.x) tile[i] = acc_t(0);
  }
  while (L > 0 && pos < end) {
    const int fb = static_cast<int>(pos / n);
    const int r0 = static_cast<int>(pos - static_cast<long long>(fb) * n);
    const int r1 = static_cast<int>(min(static_cast<long long>(n),
                                        r0 + (end - pos)));
    const int f_lo = fb * p.fbw;
    const int nf = min(p.fbw, Fv - f_lo);
    acc_t* seg = my_part + (fb - fb_first) * seg_words;
    // a bin window (nw > 1, one feature a block): its feature, first bin
    // and width; else lo = 0 and the width is B
    const int wlo = p.nw > 1 ? (f_lo % p.nw) * p.bw : 0;
    const int wb = p.nw > 1 ? min(p.bw, B - wlo) : B;
    const int f_row = p.nw > 1 ? f_lo / p.nw : f_lo;
    for (int fp = 0; fp < nf; fp += Ft) {
      const int nft = min(Ft, nf - fp);
      const BinT* bins = bins_t + static_cast<size_t>(f_row + fp) * n;
      __syncthreads();                 // the tile is clear

      auto add = [=](int fi, int s, int b, const Row<acc_t, kC>& v) {
        if constexpr (sizeof(BinT) == 1) {
          add_row<acc_t, kC>(tile, tile_words, L, R, rep, B, fi, s, b, v);
        } else {
          add_row<acc_t, kC>(tile, tile_words, L, R, rep, wb, fi, s, b, v,
                             wlo);
        }
      };
      if constexpr (kVec == 4) {
        // n % 4 == 0 and share % 4 == 0: whole, aligned groups of 4 (one
        // group per thread in flight: two spill registers at 1024 threads)
        for (int r = r0 + 4 * threadIdx.x; r < r1; r += 4 * blockDim.x) {
          Quad<BinT, kIntMode, kC> q;
          load_quad(q, r, r1, bins, vals_t, leaf_id, n, nft, table, tsize,
                    big, meta);
#pragma unroll
          for (int fi = 0; fi < kFeatBlock; ++fi) {
            if (fi >= nft) break;
            add(fi, q.s[0], q.b[fi].x, q.v[0]);
            add(fi, q.s[1], q.b[fi].y, q.v[1]);
            add(fi, q.s[2], q.b[fi].z, q.v[2]);
            add(fi, q.s[3], q.b[fi].w, q.v[3]);
          }
        }
      } else {
        for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
          const int s = slot_of(leaf_id[r], table, tsize, big, meta);
          if (s < 0) continue;
          float x[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            x[c] = vals_t[static_cast<size_t>(c) * n + r];
          }
          const auto v = to_acc<kIntMode, kC>(x);
#pragma unroll
          for (int fi = 0; fi < kFeatBlock; ++fi) {
            if (fi >= nft) break;
            add(fi, s, bins[static_cast<size_t>(fi) * n + r], v);
          }
        }
      }
      __syncthreads();

      // the pass's tiles -> partials: sum the replicas (in an order
      // rotated by the cell, so a warp's reads fall in distinct banks)
      // and clear them for the next pass
      // (cell i = q * BC + rem, tile q = fi * L + s, stepped without
      // divisions)
      const int cells = nft * L * BC;
      int q = threadIdx.x / BC;
      int rem = threadIdx.x - q * BC;
      int fi = q / L;
      int s = q - fi * L;
      for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        acc_t* w = tile + q * tile_words + rem * R;
        acc_t v;
        if (R == 1) {
          v = w[0];
          w[0] = acc_t(0);
        } else {
          v = acc_t(0);
          for (int j = 0; j < R; ++j) {
            const int x = (j + i) & (R - 1);
            v += w[x];
            w[x] = acc_t(0);
          }
        }
        seg[(static_cast<size_t>(fp + fi) * p.lanes + s) * BC + rem] = v;
        rem += blockDim.x;
        while (rem >= BC) {
          rem -= BC;
          ++q;
          if (++s == L) {
            s = 0;
            ++fi;
          }
        }
      }
    }
    pos += r1 - r0;
  }

  // ---- phase 2: partials -> output rows (k, f), in CTA order ----------
  cg::this_grid().sync();
  // Rows (k, f) of lanes with a slot are dealt round-robin over the
  // group's CTAs, kRowBatch at a time: the (row, contributing CTA)
  // offsets go to shared memory (the tiles are free now), then every
  // thread sums its elements' partials with eight loads in flight. The
  // zero rows of inactive lanes follow.
  long long* off = reinterpret_cast<long long*>(tile);
  const int max_nc = min(p.ctas, static_cast<int>((n + p.share - 1)
                                                  / p.share) + 1);
  const int live_rows = meta.nlive * Fv;
  const int my_rows = live_rows > static_cast<int>(blockIdx.x)
      ? (live_rows - blockIdx.x + p.ctas - 1) / p.ctas : 0;
  for (int t0 = 0; t0 < my_rows; t0 += kRowBatch) {
    const int nt = min(kRowBatch, my_rows - t0);
    __syncthreads();                           // off is free
    for (int e = threadIdx.x; e < nt * max_nc; e += blockDim.x) {
      const int t = e / max_nc;
      const int ci = e - t * max_nc;
      const int row = blockIdx.x + (t0 + t) * p.ctas;
      const int kl = meta.lane_order[row / Fv];
      const int f = row % Fv;          // a (feature, window) pair
      const int fb = f / p.fbw;
      const int c = static_cast<int>(static_cast<long long>(fb) * n
                                     / p.share) + ci;
      const bool in = c < p.ctas
          && static_cast<long long>(c) * p.share
             < static_cast<long long>(fb + 1) * n;
      const int j = in ? fb - static_cast<int>(static_cast<long long>(c)
                                               * p.share / n) : 0;
      off[e] = in ? static_cast<long long>(
          (static_cast<size_t>(g) * p.ctas + c) * cta_words + j * seg_words
          + (static_cast<size_t>(f - fb * p.fbw) * p.lanes
             + meta.lane_slot[kl]) * BC) : -1;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nt * BC; e += blockDim.x) {
      const int t = e / BC;
      const int i = e - t * BC;
      const int row = blockIdx.x + (t0 + t) * p.ctas;
      const int fv = row % Fv;
      const int lo = (fv % p.nw) * p.bw;           // the window's first bin
      if (i >= (B - lo) * C) continue;             // past the last bin
      const long long* o_t = off + t * max_nc;
      acc_t v = acc_t(0);
      for (int c0 = 0; c0 < max_nc; c0 += 8) {
        acc_t x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const long long o = c0 + u < max_nc ? o_t[c0 + u] : -1;
          x[u] = o >= 0 ? __ldcg(part + o + i) : acc_t(0);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) v += x[u];
      }
      out[(static_cast<size_t>(k0 + meta.lane_order[row / Fv]) * F
           + fv / p.nw) * B * C + lo * C + i] = static_cast<float>(v);
    }
  }
  const int dead_rows = (kg - meta.nlive) * F;
  for (int row = blockIdx.x; row < dead_rows; row += p.ctas) {
    const int kl = meta.lane_order[meta.nlive + row / F];
    float* o = out + (static_cast<size_t>(k0 + kl) * F + row % F) * B * C;
    for (int i = threadIdx.x; i < B * C; i += blockDim.x) o[i] = 0.f;
  }
}

// Lanes of one launch: every lane group needs a CTA of its own and all
// CTAs of a cooperative launch are resident at once (one an SM), so at
// most num_sms() groups. Only wide bins with many lanes reach the limit
// (B = 65,536 holds one lane a group); their lanes then go in chunks, one
// launch each, in order on the stream, sharing the scratch.
int lanes_per_launch(int n, int F, int C, int K, int B, int vec) {
  return make_plan(n, F, C, K, B, vec).lanes * num_sms();
}

template <typename BinT, bool kIntMode, int kVec, int kC>
int launch_c(const BinT* bins_t, const float* vals_t,
             const int32_t* leaf_id, const int32_t* small_ids, int n, int F,
             int K, int B, void* scratch, float* out, cudaStream_t stream) {
  auto kernel = hist_kernel<BinT, kIntMode, kVec, kC>;
  const int chunk = lanes_per_launch(n, F, kC, K, B, kVec);
  for (int k0 = 0; k0 < K; k0 += chunk) {
    int kk = min(chunk, K - k0);
    Plan p = make_plan(n, F, kC, kk, B, kVec);
    static int smem_set = 0;           // per instance and process
    if (p.smem > smem_set) {
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           p.smem);
      smem_set = p.smem;
    }
    const int32_t* ids = small_ids + k0;
    float* o = out + static_cast<size_t>(k0) * F * B * kC;
    void* args[] = {&bins_t, &vals_t, &leaf_id, &ids, &n, &F, &kk, &B,
                    &p, &scratch, &o};
    dim3 grid(static_cast<unsigned>(p.ctas),
              static_cast<unsigned>(p.groups));
    cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                dim3(kThreads), args,
                                static_cast<size_t>(p.smem), stream);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

// the channel count is a template parameter so each row's values stay in
// registers
template <typename BinT, bool kIntMode, int kVec>
int launch_vec(const BinT* bins_t, const float* vals_t,
               const int32_t* leaf_id, const int32_t* small_ids, int n, int F,
               int C, int K, int B, void* scratch, float* out,
               cudaStream_t stream) {
  switch (C) {
#define LGBT_CASE(c)                                                     \
  case c:                                                                \
    return launch_c<BinT, kIntMode, kVec, c>(bins_t, vals_t, leaf_id,    \
                                             small_ids, n, F, K, B,      \
                                             scratch, out, stream);
    LGBT_CASE(1) LGBT_CASE(2) LGBT_CASE(3) LGBT_CASE(4)
    LGBT_CASE(5) LGBT_CASE(6) LGBT_CASE(7) LGBT_CASE(8)
#undef LGBT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the 4-row path needs whole groups of 4 and 16-byte aligned rows (bins:
// a 4-row group's bytes aligned)
bool vec_rows(const void* bins_t, int bin_bytes, const void* vals_t,
              const void* leaf_id, int n) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(vals_t) % 16 == 0
      && reinterpret_cast<uintptr_t>(leaf_id) % 16 == 0
      && reinterpret_cast<uintptr_t>(bins_t) % (4 * bin_bytes) == 0;
}

bool bad_shape(int n, int F, int C, int K, int B, int max_bins) {
  return n <= 0 || F <= 0 || K <= 0 || C < 1 || C > kMaxChannels || B < 1
      || B > max_bins;
}

template <typename BinT>
int launch(const void* bins_t, const void* vals_t, const void* leaf_id,
           const void* small_ids, int n, int F, int C, int K, int B,
           int int_mode, void* scratch, void* out, void* stream) {
  if (bad_shape(n, F, C, K, B, sizeof(BinT) == 1 ? 256 : 65536)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const BinT*>(bins_t);
  auto v = static_cast<const float*>(vals_t);
  auto l = static_cast<const int32_t*>(leaf_id);
  auto k = static_cast<const int32_t*>(small_ids);
  auto o = static_cast<float*>(out);
  const bool vec = vec_rows(bins_t, sizeof(BinT), vals_t, leaf_id, n);
  if (int_mode) {
    return vec ? launch_vec<BinT, true, 4>(b, v, l, k, n, F, C, K, B,
                                           scratch, o, s)
               : launch_vec<BinT, true, 1>(b, v, l, k, n, F, C, K, B,
                                           scratch, o, s);
  }
  return vec ? launch_vec<BinT, false, 4>(b, v, l, k, n, F, C, K, B, scratch,
                                          o, s)
             : launch_vec<BinT, false, 1>(b, v, l, k, n, F, C, K, B, scratch,
                                          o, s);
}

template <typename BinT>
long long scratch_for(const void* bins_t, const void* vals_t,
                      const void* leaf_id, int n, int F, int C, int K,
                      int B) {
  if (bad_shape(n, F, C, K, B, sizeof(BinT) == 1 ? 256 : 65536)) return 0;
  const int vec = vec_rows(bins_t, sizeof(BinT), vals_t, leaf_id, n) ? 4 : 1;
  const int kk = min(K, lanes_per_launch(n, F, C, K, B, vec));
  return static_cast<long long>(make_plan(n, F, C, kk, B, vec).scratch) * 4;
}

}  // namespace

// Bytes of scratch the launch below needs for these arguments (0 when the
// shape is refused). Plain C entry point (bound with ctypes).
extern "C" long long lgbt_multi_leaf_histogram_scratch(
    const void* bins_t, const void* vals_t, const void* leaf_id, int n,
    int F, int C, int K, int B) {
  return scratch_for<uint8_t>(bins_t, vals_t, leaf_id, n, F, C, K, B);
}

// Plain C entry point (bound with ctypes). bins_t is uint8 (B <= 256).
// Writes every element of `out` ([K, F, B, C] float32); `scratch` holds at
// least the bytes lgbt_multi_leaf_histogram_scratch gives, in any state.
// n, F and K are positive. Returns cudaGetLastError() after the launch.
extern "C" int lgbt_multi_leaf_histogram(
    const void* bins_t, const void* vals_t, const void* leaf_id,
    const void* small_ids, int n, int F, int C, int K, int B, int int_mode,
    void* scratch, void* out, void* stream) {
  return launch<uint8_t>(bins_t, vals_t, leaf_id, small_ids, n, F, C, K, B,
                         int_mode, scratch, out, stream);
}

// The same two entry points for uint16 bins_t (B <= 65,536).
extern "C" long long lgbt_multi_leaf_histogram_u16_scratch(
    const void* bins_t, const void* vals_t, const void* leaf_id, int n,
    int F, int C, int K, int B) {
  return scratch_for<uint16_t>(bins_t, vals_t, leaf_id, n, F, C, K, B);
}

extern "C" int lgbt_multi_leaf_histogram_u16(
    const void* bins_t, const void* vals_t, const void* leaf_id,
    const void* small_ids, int n, int F, int C, int K, int B, int int_mode,
    void* scratch, void* out, void* stream) {
  return launch<uint16_t>(bins_t, vals_t, leaf_id, small_ids, n, F, C, K, B,
                          int_mode, scratch, out, stream);
}
