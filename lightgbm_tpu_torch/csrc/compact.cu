// Row-compaction kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lightgbm_tpu/ops/compact.py (compact_rows,
// body _compact_kernel): stable stream compaction of the kept columns of
// feature-major arrays. Row r of source block g = r / R is kept when
// dest[r] >= 0 and lands at stream position
//
//   pos = aligned[g] * 128 + rem[g] + dest[r]        (compact.py:265)
//
// (plan_compaction already made these exact prefix positions), so
//   out_bins[f, pos] = bins_t[f, r]   and   out_vals[c, pos] = vals_t[c, r].
// Positions at or past out_cols are dropped, like the XLA twin's
// mode="drop" scatter. The caller zeroes both outputs, so the tail past the
// last kept row is zero.
//
// What bounds it on an H100: bytes -- dest (4 B/row), the aligned/rem
// tables, every source column (F + 4*C B/row) read once, and the kept
// columns written once. The TPU kernel moved columns with one-hot
// permutation matmuls and a bf16x3 split because the TPU has no fast
// computed scatter; a GPU store to a computed address is already exact and
// cheap, so the kernel is a plain scatter.
//
// Design: one thread per source row and a group of channels
// (grid.y = channel groups of kChanPerThread). Kept rows in a warp have
// consecutive positions, so the stores coalesce where rows are dense;
// dropped rows cost only the dest read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChanPerThread = 8;

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ bins_t,
               const float* __restrict__ vals_t,
               const int32_t* __restrict__ dest,
               const int32_t* __restrict__ aligned,
               const int32_t* __restrict__ rem,
               int n, int F, int C, int R, int out_cols,
               uint8_t* __restrict__ out_bins, float* __restrict__ out_vals) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int d = dest[r];
  if (d < 0) return;
  const int g = r / R;
  const long long pos = static_cast<long long>(aligned[g]) * 128 + rem[g] + d;
  if (pos < 0 || pos >= out_cols) return;
  const int ch0 = blockIdx.y * kChanPerThread;
  const int ch1 = min(F + C, ch0 + kChanPerThread);
  for (int ch = ch0; ch < ch1; ++ch) {
    if (ch < F) {
      out_bins[static_cast<size_t>(ch) * out_cols + pos] =
          bins_t[static_cast<size_t>(ch) * n + r];
    } else {
      const int c = ch - F;
      out_vals[static_cast<size_t>(c) * out_cols + pos] =
          vals_t[static_cast<size_t>(c) * n + r];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): bins_t [F, n] uint8, vals_t
// [C, n] f32, dest [n] i32, aligned/rem [n / R] i32; out_bins [F, out_cols]
// uint8 and out_vals [C, out_cols] f32 zeroed by the caller. Returns
// cudaGetLastError().
extern "C" int lgbt_compact_rows(
    const void* bins_t, const void* vals_t, const void* dest,
    const void* aligned, const void* rem, int n, int F, int C, int R,
    int out_cols, void* out_bins, void* out_vals, void* stream) {
  if (n <= 0 || F + C <= 0) return 0;
  if (R <= 0 || out_cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned groups = (F + C + kChanPerThread - 1) / kChanPerThread;
  dim3 grid((n + kThreads - 1) / kThreads, groups);
  compact_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins_t), static_cast<const float*>(vals_t),
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(aligned),
      static_cast<const int32_t*>(rem), n, F, C, R, out_cols,
      static_cast<uint8_t*>(out_bins), static_cast<float*>(out_vals));
  return static_cast<int>(cudaGetLastError());
}
