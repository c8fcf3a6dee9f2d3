// Partition-move kernel for Hopper (sm_90a): kernel B′.
//
// Replaces the TPU move lightgbm_tpu/ops/partition.py:129 (move_cols_tpu),
// which runs the Pallas compaction kernel of lightgbm_tpu/ops/compact.py
// twice (not-moved columns to the front, moved columns to the back) and
// then rolls and blends the two buffers, together with the plan that feeds
// it (the moved mask and plan_split_move). Contract, with moved[r] =
// (leaf_new[r] != leaf_old[r]), cum its inclusive prefix sum and n_front =
// n - cum[n - 1]:
//
//   dest[r] = moved[r] ? n_front + cum[r] - 1 : r - cum[r]
//   out_bins[:, dest[r]] = bins_t[:, r]      [F, n] uint8 or uint16
//   out_vals[:, dest[r]] = vals_t[:, r]      [C, n] f32
//   out_leaf[dest[r]]    = leaf_new[r]       [n]    i32
//
// bit-exact, and it writes cum [n] i32 and n_front (i32) for the leaf
// tables (ops/partition.py::update_tables). Not-moved columns go stably to
// the front, moved ones stably to the back. The outputs are a second
// buffer, never the inputs (the grow loop ping-pongs two buffers).
//
// What bounds it on an H100: bytes -- both leaf-id arrays read (8 B a
// column), every column read once and written once ((F + 4 C + 4) B each
// way) and cum written (4 B): 0.057 ms at 2,002,944 columns, F = 28,
// C = 3.
//
// What held the first design back (PERF.md): it was the last of three
// steps (the compare, a plan of about nine torch launches with ~70 B a
// column of traffic, then a scatter of one column per thread, a byte load
// and a byte store per feature row, whose stores part-filled their
// sectors where moved and kept columns interleave).
//
// Design: one launch of the stable-partition core (stable_partition.cuh),
// in two phases. A moved column's position needs n_front, the count of ALL
// not-moved columns, which no tile knows until every tile is counted; so
// the single pass is the scan, and the move follows it:
// 1. Each tile compares the two leaf-id arrays, scans the moved flags,
//    finds its prefix by the decoupled look-back and writes its part of
//    cum (which the tables need anyway), then counts itself done.
// 2. When every tile is done (all tiles were taken by running CTAs, so the
//    wait ends), each tile reads its flags and ranks back from cum (4 B a
//    column, from L2 at this size) and moves its columns as two runs, the
//    front run at (its first column - moved before it) and the back run at
//    n_front + (moved before it), stage by stage through shared memory.
// Extra traffic over the bound: cum read once (4 B a column) and leaf_new
// read twice. Bin rows of 2 bytes (lgbt_partition_move_u16) take the
// core's uint16 instance: two rows a stage instead of four.
#include "stable_partition.cuh"

namespace {

using namespace sp;

template <int kBe>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
partition_kernel(Rows a, const int32_t* __restrict__ leaf_old, int n,
                 int32_t* cum, int32_t* n_front_out, unsigned char* scratch,
                 unsigned epoch) {
  extern __shared__ __align__(16) char smem[];
  __shared__ unsigned s_cnt[kStrips * kWarps + 1];
  __shared__ int s_tile;
  __shared__ unsigned s_excl;
  reset_next_counters(scratch, epoch);
  unsigned* ctr = counters(scratch, epoch);
  unsigned long long* status = status_words(scratch);
  const int32_t* leaf_new = reinterpret_cast<const int32_t*>(a.leaf);
  const int ntiles = static_cast<int>(num_tiles(n));

  // ---- phase 1: the moved flags' prefix sums ------------------------------
  for (;;) {
    const int t = claim_tile(&ctr[kClaimScan], &s_tile);
    if (t >= ntiles) break;
    const long long t0 = static_cast<long long>(t) * kTile;
    const int cols = tile_cols(n, t0);
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < kStrips; ++k) {
      const int c = k * kThreads + threadIdx.x;
      if (c < cols && leaf_new[t0 + c] != leaf_old[t0 + c]) bits |= 1u << k;
    }
    unsigned short le[kStrips];
    const unsigned moved = block_scan(bits, s_cnt, le);
    if (threadIdx.x < 32) {
      const unsigned excl = lookback(status, t, moved, epoch);
      if (threadIdx.x == 0) s_excl = excl;
    }
    __syncthreads();
    const unsigned excl = s_excl;
#pragma unroll
    for (int k = 0; k < kStrips; ++k) {
      const int c = k * kThreads + threadIdx.x;
      if (c < cols)
        cum[t0 + c] = static_cast<int32_t>(excl + le[k] + ((bits >> k) & 1));
    }
    if (t == ntiles - 1 && threadIdx.x == 0)
      *n_front_out = static_cast<int32_t>(n - (excl + moved));
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(&ctr[kDone], 1u);
    }
  }

  // ---- wait until every tile's cum is written -----------------------------
  if (threadIdx.x == 0) {
    while (ld_acquire(&ctr[kDone]) < static_cast<unsigned>(ntiles))
      __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
  const long long n_front = n - __ldcg(&cum[n - 1]);

  // ---- phase 2: the move ---------------------------------------------------
  for (;;) {
    const int t = claim_tile(&ctr[kClaimMove], &s_tile);
    if (t >= ntiles) break;
    const long long t0 = static_cast<long long>(t) * kTile;
    const int cols = tile_cols(n, t0);
    issue_stage<kBe>(a, 0, t0, cols, smem);  // overlaps the reads of cum
    const int base = t0 > 0 ? __ldcg(&cum[t0 - 1]) : 0;
    const int nb = __ldcg(&cum[t0 + cols - 1]) - base;   // moved in tile
    const int nf = cols - nb;
    unsigned short ld[kStrips];
#pragma unroll
    for (int k = 0; k < kStrips; ++k) {
      const int c = k * kThreads + threadIdx.x;
      ld[k] = kNone;
      if (c < cols) {
        const int before = t0 + c > 0 ? __ldcg(&cum[t0 + c - 1]) : 0;
        const int le = before - base;               // moved before c in tile
        ld[k] = static_cast<unsigned short>(
            __ldcg(&cum[t0 + c]) != before ? nf + le : c - le);
      }
    }
    move_tile<kBe>(a, t0, cols, ld, nf, nf, t0 - base, n_front + base, nb,
                   smem);
  }
}

// CTAs of a launch over n columns (see resident_grid), per instance.
template <int kBe>
int grid_for(int n) {
  static int cap[kMaxDevices];
  return resident_grid(reinterpret_cast<const void*>(partition_kernel<kBe>),
                       num_tiles(n), cap);
}

template <int kBe>
int launch(const void* bins_t, const void* vals_t, const void* leaf_old,
           const void* leaf_new, int n, int F, int C, void* out_bins,
           void* out_vals, void* out_leaf, void* cum, void* n_front,
           void* scratch, unsigned epoch, void* stream) {
  if (n <= 0 || F < 0 || C < 0 || epoch == 0 || epoch >= (1u << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Rows a{static_cast<const char*>(bins_t), static_cast<const char*>(vals_t),
         static_cast<const char*>(leaf_new), static_cast<char*>(out_bins),
         static_cast<char*>(out_vals), static_cast<char*>(out_leaf),
         F, C, 1, n, n};
  const int grid = grid_for<kBe>(n);
  if (grid < 0) return -grid;
  partition_kernel<kBe><<<grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int32_t*>(leaf_old), n,
      static_cast<int32_t*>(cum), static_cast<int32_t*>(n_front),
      static_cast<unsigned char*>(scratch), epoch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).
// Scratch bytes for n columns (lgbt_partition_move's `scratch`).
extern "C" long long lgbt_partition_scratch_bytes(int n) {
  return scratch_bytes(n);
}

// CTAs of a launch over n columns (the tiles, capped at what fits on the
// device at once); negative: a CUDA error.
extern "C" int lgbt_partition_grid(int n) {
  return grid_for<1>(n);
}

// bins_t [F, n] uint8, vals_t [C, n] f32, leaf_old / leaf_new [n] i32; the
// outputs out_bins / out_vals / out_leaf have the inputs' shapes and do not
// alias them; cum [n] i32 and n_front [1] i32 are written; scratch from
// lgbt_partition_scratch_bytes, zeroed when allocated; epoch > 0, one more
// than the last launch that used this scratch. Returns cudaGetLastError().
extern "C" int lgbt_partition_move(
    const void* bins_t, const void* vals_t, const void* leaf_old,
    const void* leaf_new, int n, int F, int C, void* out_bins,
    void* out_vals, void* out_leaf, void* cum, void* n_front, void* scratch,
    unsigned epoch, void* stream) {
  return launch<1>(bins_t, vals_t, leaf_old, leaf_new, n, F, C, out_bins,
                   out_vals, out_leaf, cum, n_front, scratch, epoch, stream);
}

// The same for uint16 bins_t and out_bins.
extern "C" int lgbt_partition_move_u16(
    const void* bins_t, const void* vals_t, const void* leaf_old,
    const void* leaf_new, int n, int F, int C, void* out_bins,
    void* out_vals, void* out_leaf, void* cum, void* n_front, void* scratch,
    unsigned epoch, void* stream) {
  return launch<2>(bins_t, vals_t, leaf_old, leaf_new, n, F, C, out_bins,
                   out_vals, out_leaf, cum, n_front, scratch, epoch, stream);
}
