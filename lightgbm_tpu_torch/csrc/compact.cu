// Row-compaction kernel for Hopper (sm_90a): kernel B.
//
// Replaces the Pallas TPU kernel lightgbm_tpu/ops/compact.py (compact_rows,
// :166, body _compact_kernel :90) together with the plan that feeds it
// (plan_compaction): a stable stream compaction of the kept columns of
// feature-major arrays. Contract, with pos[r] = the number of kept columns
// before column r:
//
//   out_bins[f, pos[r]] = bins_t[f, r]   [F, out_cols] uint8 or uint16
//   out_vals[c, pos[r]] = vals_t[c, r]   [C, out_cols] f32
//
// for every kept column r (keep[r] != 0) with pos[r] < out_cols; the other
// columns are dropped, and the tail [kept, out_cols) is zero. Bit-exact.
// The TPU layout's 128-aligned block positions (aligned * 128 + rem) change
// no position, so this is the same output.
//
// What bounds it on an H100: bytes -- the keep mask (1 B a column), the
// kept columns read once and the whole output written once ((F + 4 C) B a
// column), 0.0084 ms at the GOSS flagship's shape. The TPU kernel moved
// columns with one-hot permutation matmuls because the TPU has no fast
// computed store; on the card a store to a computed address is exact.
//
// What held the first design back (PERF.md): it was the last of four
// steps (the compare, a plan of ~14 torch launches, two zero-fills, then a
// scatter that read dest once per group of 8 channels and moved single
// bytes).
//
// Design: one launch of the stable-partition core (stable_partition.cuh).
// Each tile reads its keep mask, scans it, finds its output position by
// the decoupled look-back and moves its kept columns as one run at that
// position, stage by stage through shared memory, cut at out_cols. When no
// tile is left a CTA waits for the last tile's inclusive prefix (the kept
// count) and zeroes its share of the tail, so nothing zeroes the outputs
// beforehand. Bin rows of 2 bytes (lgbt_compact_by_mask_u16) take the
// core's uint16 instance: two rows a stage instead of four.
#include "stable_partition.cuh"

namespace {

using namespace sp;

template <int kBe>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
compact_kernel(Rows a, const uint8_t* __restrict__ keep, int n,
               int out_cols, unsigned char* scratch, unsigned epoch) {
  extern __shared__ __align__(16) char smem[];
  __shared__ unsigned s_cnt[kStrips * kWarps + 1];
  __shared__ int s_tile;
  __shared__ unsigned s_excl;
  reset_next_counters(scratch, epoch);
  unsigned* ctr = counters(scratch, epoch);
  unsigned long long* status = status_words(scratch);
  const int ntiles = static_cast<int>(num_tiles(n));
  for (;;) {
    const int t = claim_tile(&ctr[kClaimScan], &s_tile);
    if (t >= ntiles) break;
    const long long t0 = static_cast<long long>(t) * kTile;
    const int cols = tile_cols(n, t0);
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < kStrips; ++k) {
      const int c = k * kThreads + threadIdx.x;
      if (c < cols && keep[t0 + c]) bits |= 1u << k;
    }
    issue_stage<kBe>(a, 0, t0, cols, smem);  // overlaps the scan
    unsigned short ld[kStrips];
    const unsigned kept = block_scan(bits, s_cnt, ld);
    if (threadIdx.x < 32) {
      const unsigned excl = lookback(status, t, kept, epoch);
      if (threadIdx.x == 0) s_excl = excl;
    }
    __syncthreads();
    const long long f0 = s_excl;
#pragma unroll
    for (int k = 0; k < kStrips; ++k)
      if (!((bits >> k) & 1)) ld[k] = kNone;
    const long long room = out_cols - f0;      // cut at out_cols
    const int nfe = room <= 0 ? 0 : static_cast<int>(room < kept ? room
                                                                  : kept);
    move_tile<kBe>(a, t0, cols, ld, static_cast<int>(kept), nfe, f0, 0, 0,
                   smem);
  }
  // every tile is taken: the last one's inclusive prefix is the kept count
  if (threadIdx.x == 0)
    s_excl = ntiles > 0 ? static_cast<unsigned>(wait_status(
                              &status[ntiles - 1], epoch, kPrefix))
                        : 0u;
  __syncthreads();
  const long long k0 = s_excl < static_cast<unsigned>(out_cols)
                            ? s_excl : out_cols;
  const long long gt = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * kThreads;
  for (int r = 0; r < a.F + a.C; ++r) {
    const int es = r < a.F ? kBe : 4;
    char* lo = dst_row<kBe>(a, r) + k0 * es;
    char* hi = dst_row<kBe>(a, r) + static_cast<long long>(out_cols) * es;
    char* v0 = reinterpret_cast<char*>(
        (reinterpret_cast<uintptr_t>(lo) + 15) & ~uintptr_t(15));
    char* v1 = reinterpret_cast<char*>(reinterpret_cast<uintptr_t>(hi) &
                                       ~uintptr_t(15));
    if (v0 >= v1) {
      v0 = v1 = hi;
    }
    for (long long b = gt; b < v0 - lo; b += nt) lo[b] = 0;
    for (long long b = gt; b < (v1 - v0) / 16; b += nt)
      reinterpret_cast<uint4*>(v0)[b] = make_uint4(0, 0, 0, 0);
    for (long long b = gt; b < hi - v1; b += nt) v1[b] = 0;
  }
}

// CTAs of a launch over n columns (see resident_grid), per instance.
template <int kBe>
int grid_for(int n) {
  static int cap[kMaxDevices];
  return resident_grid(reinterpret_cast<const void*>(compact_kernel<kBe>),
                       num_tiles(n), cap);
}

template <int kBe>
int launch(const void* bins_t, const void* vals_t, const void* keep, int n,
           int F, int C, int out_cols, void* out_bins, void* out_vals,
           void* scratch, unsigned epoch, void* stream) {
  if (n < 0 || F < 0 || C < 0 || out_cols <= 0 || epoch == 0 ||
      epoch >= (1u << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Rows a{static_cast<const char*>(bins_t), static_cast<const char*>(vals_t),
         nullptr, static_cast<char*>(out_bins), static_cast<char*>(out_vals),
         nullptr, F, C, 0, n, out_cols};
  const int grid = grid_for<kBe>(n);
  if (grid < 0) return -grid;
  compact_kernel<kBe><<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint8_t*>(keep), n, out_cols,
      static_cast<unsigned char*>(scratch), epoch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).
// Scratch bytes for n columns (lgbt_compact_by_mask's `scratch`).
extern "C" long long lgbt_compact_scratch_bytes(int n) {
  return scratch_bytes(n);
}

// CTAs of a launch over n columns (the tiles, capped at what fits on the
// device at once); negative: a CUDA error.
extern "C" int lgbt_compact_grid(int n) {
  return grid_for<1>(n);
}

// bins_t [F, n] uint8, vals_t [C, n] f32, keep [n] uint8 (non-zero: kept);
// out_bins [F, out_cols] uint8 and out_vals [C, out_cols] f32, every
// element written; scratch from lgbt_compact_scratch_bytes, zeroed when
// allocated; epoch > 0, one more than the last launch that used this
// scratch. Returns cudaGetLastError().
extern "C" int lgbt_compact_by_mask(const void* bins_t, const void* vals_t,
                                    const void* keep, int n, int F, int C,
                                    int out_cols, void* out_bins,
                                    void* out_vals, void* scratch,
                                    unsigned epoch, void* stream) {
  return launch<1>(bins_t, vals_t, keep, n, F, C, out_cols, out_bins,
                   out_vals, scratch, epoch, stream);
}

// The same for uint16 bins_t and out_bins.
extern "C" int lgbt_compact_by_mask_u16(const void* bins_t,
                                        const void* vals_t, const void* keep,
                                        int n, int F, int C, int out_cols,
                                        void* out_bins, void* out_vals,
                                        void* scratch, unsigned epoch,
                                        void* stream) {
  return launch<2>(bins_t, vals_t, keep, n, F, C, out_cols, out_bins,
                   out_vals, scratch, epoch, stream);
}
