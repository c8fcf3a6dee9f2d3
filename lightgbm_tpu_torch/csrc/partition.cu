// Partition-move kernel for Hopper (sm_90a).
//
// Replaces the TPU move lightgbm_tpu/ops/partition.py (move_cols_tpu), which
// runs the Pallas compaction kernel of lightgbm_tpu/ops/compact.py twice
// (not-moved columns to the front, moved columns to the back) and then rolls
// and blends the two buffers. Contract: for each column r,
//
//   out_bins[:, dest[r]] = bins_t[:, r]      [F, n] uint8
//   out_vals[:, dest[r]] = vals_t[:, r]      [C, n] f32
//   out_leaf[dest[r]]    = leaf[r]           [n]    i32
//
// bit-exact, where dest is plan_split_move's permutation: not-moved rows go
// stably to the front, moved rows stably to the back. The outputs are a
// second buffer, never the inputs (the grow loop ping-pongs two buffers).
//
// What bounds it on an H100: bytes -- dest (4 B/column) plus every column
// read once and written once ((F + 4*C + 4) B each way); no arithmetic. The
// TPU needed two compaction passes because it has no fast computed store;
// on the card a store to a computed address is exact, so this is one pass.
//
// Design: one thread per column. A warp takes 32 consecutive columns,
// reads their destinations once, then loops over the feature rows and the
// channels: each load is 32 consecutive elements of one row (coalesced),
// and the stores are coalesced within the front run and within the back
// run, since consecutive not-moved (or moved) columns have consecutive
// destinations. A single-pass form that computes dest itself (decoupled
// look-back scan) would save the plan's passes over the mask.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
move_kernel(const uint8_t* __restrict__ bins_t,
            const float* __restrict__ vals_t,
            const int32_t* __restrict__ leaf,
            const int32_t* __restrict__ dest, int n, int F, int C,
            uint8_t* __restrict__ out_bins, float* __restrict__ out_vals,
            int32_t* __restrict__ out_leaf) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int d = dest[r];           // a permutation of 0..n-1 by construction
  out_leaf[d] = leaf[r];
  for (int c = 0; c < C; ++c) {
    const size_t row = static_cast<size_t>(c) * n;
    out_vals[row + d] = vals_t[row + r];
  }
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const size_t row = static_cast<size_t>(f) * n;
    out_bins[row + d] = bins_t[row + r];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): bins_t [F, n] uint8, vals_t
// [C, n] f32, leaf [n] i32, dest [n] i32 (a permutation of 0..n-1); the
// outputs have the inputs' shapes and do not alias them. Returns
// cudaGetLastError().
extern "C" int lgbt_partition_move(
    const void* bins_t, const void* vals_t, const void* leaf,
    const void* dest, int n, int F, int C, void* out_bins, void* out_vals,
    void* out_leaf, void* stream) {
  if (n <= 0) return 0;
  if (F < 0 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (n + kThreads - 1) / kThreads;
  move_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins_t), static_cast<const float*>(vals_t),
      static_cast<const int32_t*>(leaf), static_cast<const int32_t*>(dest),
      n, F, C, static_cast<uint8_t*>(out_bins),
      static_cast<float*>(out_vals), static_cast<int32_t*>(out_leaf));
  return static_cast<int>(cudaGetLastError());
}
