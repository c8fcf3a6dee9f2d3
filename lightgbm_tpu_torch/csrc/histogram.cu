// Multi-leaf histogram kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lightgbm_tpu/ops/pallas_histogram.py
// (multi_leaf_histogram, body _hist_kernel). Same contract:
//
//   hist[k, f, b, c] = sum_r [bins_t[f, r] == b] * [leaf_id[r] == small_ids[k]]
//                            * vals_t[c, r]
//
// bins_t [F, n] uint8, vals_t [C, n] f32, leaf_id [n] i32, small_ids [K] i32
// (an id that matches no row -- e.g. -1 -- gives a zero histogram), output
// [K, F, B, C]. In f32 mode each added value is rounded to bf16 first and
// summed in f32 (the TPU kernel's bf16 operands, f32 accumulation); in int
// mode the values are integer levels summed exactly in int32 and the
// caller casts the int32 output to f32.
//
// What bounds it on an H100: bytes. One call reads bins (F*n B), vals
// (4*C*n B) and leaf_id (4*n B) once and writes K*F*B*C*4 B; there are no
// flops to speak of. The TPU kernel's one-hot matmul existed because the
// TPU has no scatter-add; here the scatter is the cheap part: the CUDA
// LightGBM design of per-CTA shared-memory histograms built with shared
// atomics, flushed to global memory with global atomics once per CTA.
//
// Design:
// - grid (F, row chunks, lane groups). A CTA owns one feature, one chunk
//   of rows and a group of up to 32 lanes; its [B][lanes][C] histogram
//   lives in dynamic shared memory (96 KiB at B=256, 32 lanes, C=3, so
//   two CTAs fit on an SM). About one CTA per SM: every extra row chunk
//   adds a flush of the whole tile.
// - Each thread takes 4 consecutive rows per step with 16-byte loads of
//   leaf ids and values and a 4-byte load of bins (when n % 4 == 0 and
//   the rows are aligned; a scalar loop otherwise). Scalar loads left the scan latency-bound at
//   3x the time on an H100.
// - A leaf -> lane-bitmask table in shared memory (ids 0..kTable-1) finds
//   a row's lanes with one load; rows whose leaf matches no lane add
//   nothing, so the work is O(n*F) shared atomics at most (a row matches
//   one lane unless small_ids repeats an id, which the bitmask handles).
//   Leaf ids outside the table fall back to a scan of the group's ids.
// - Consecutive CTAs (blockIdx.x = feature) read the same rows' vals and
//   leaf ids, so those re-reads mostly hit L2.
// - The flush skips zero cells: a chunk touches few (bin, lane) pairs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLanes = 32;     // lanes per CTA (one bit each)
constexpr int kMaxChannels = 8;
constexpr int kTable = 2048;      // leaf ids with a direct table entry

// one row's channel values, passed by value so they stay in registers
template <int kC>
struct Row {
  float x[kC];
};

template <bool kIntMode, int kVec, int kC>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ bins_t,
            const float* __restrict__ vals_t,
            const int32_t* __restrict__ leaf_id,
            const int32_t* __restrict__ small_ids,
            int n, int F, int K, int B, int rows_per_cta,
            int lanes_per_group, void* __restrict__ out) {
  constexpr int C = kC;
  using acc_t = typename std::conditional<kIntMode, int32_t, float>::type;
  const int f = blockIdx.x;
  const int r_begin = blockIdx.y * rows_per_cta;
  const int r_end = min(n, r_begin + rows_per_cta);
  const int k0 = blockIdx.z * lanes_per_group;
  const int kg = min(lanes_per_group, K - k0);

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);          // [kTable]
  int32_t* ids = reinterpret_cast<int32_t*>(table + kTable);     // [32]
  acc_t* hist = reinterpret_cast<acc_t*>(ids + kMaxLanes);       // [B][kg][C]
  const int cells = B * kg * C;

  for (int i = threadIdx.x; i < kTable; i += blockDim.x) table[i] = 0u;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = acc_t(0);
  __syncthreads();
  if (threadIdx.x < kg) {
    const int id = small_ids[k0 + threadIdx.x];
    ids[threadIdx.x] = id;
    if (id >= 0 && id < kTable) atomicOr(&table[id], 1u << threadIdx.x);
  }
  __syncthreads();

  const uint8_t* bins_f = bins_t + static_cast<size_t>(f) * n;

  // add one row's values to every lane its leaf belongs to
  auto add_row = [&](int lid, int b, Row<kC> row) {
    uint32_t mask;
    if (lid >= 0 && lid < kTable) {
      mask = table[lid];
    } else {
      mask = 0u;
      for (int k = 0; k < kg; ++k) mask |= (ids[k] == lid) ? (1u << k) : 0u;
    }
    if (mask == 0u || b >= B) return;   // b >= B: no bin to add to
    acc_t v[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if constexpr (kIntMode) {
        v[c] = __float2int_rn(row.x[c]);
      } else {
        v[c] = __bfloat162float(__float2bfloat16_rn(row.x[c]));
      }
    }
    acc_t* cell = hist + b * kg * kC;
    while (mask) {
      const int k = __ffs(mask) - 1;
      mask &= mask - 1u;
#pragma unroll
      for (int c = 0; c < kC; ++c) atomicAdd(&cell[k * kC + c], v[c]);
    }
  };
  if constexpr (kVec == 4) {
    // n % 4 == 0 and rows_per_cta % 4 == 0: whole, aligned groups of 4
    for (int r = r_begin + 4 * threadIdx.x; r < r_end; r += 4 * blockDim.x) {
      const int4 lid = *reinterpret_cast<const int4*>(leaf_id + r);
      const uchar4 b = *reinterpret_cast<const uchar4*>(bins_f + r);
      Row<kC> x0, x1, x2, x3;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 q = *reinterpret_cast<const float4*>(
            vals_t + static_cast<size_t>(c) * n + r);
        x0.x[c] = q.x;
        x1.x[c] = q.y;
        x2.x[c] = q.z;
        x3.x[c] = q.w;
      }
      add_row(lid.x, b.x, x0);
      add_row(lid.y, b.y, x1);
      add_row(lid.z, b.z, x2);
      add_row(lid.w, b.w, x3);
    }
  } else {
    for (int r = r_begin + threadIdx.x; r < r_end; r += blockDim.x) {
      Row<kC> x;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        x.x[c] = vals_t[static_cast<size_t>(c) * n + r];
      }
      add_row(leaf_id[r], bins_f[r], x);
    }
  }
  __syncthreads();

  acc_t* out_t = reinterpret_cast<acc_t*>(out);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const acc_t v = hist[i];
    if (v == acc_t(0)) continue;
    const int c = i % C;
    const int k = (i / C) % kg;
    const int b = i / (C * kg);
    const size_t o = ((static_cast<size_t>(k0 + k) * F + f) * B + b) * C + c;
    atomicAdd(&out_t[o], v);
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

template <bool kIntMode, int kVec, int kC>
int launch_c(const uint8_t* bins_t, const float* vals_t,
             const int32_t* leaf_id, const int32_t* small_ids, int n, int F,
             int K, int B, void* out, cudaStream_t stream) {
  constexpr int C = kC;
  const size_t acc = 4;
  // lanes per CTA: as many as fit ~100 KiB of histogram (two CTAs per SM)
  int lanes = static_cast<int>((100 * 1024) / (static_cast<size_t>(B) * C * acc));
  lanes = max(1, min(lanes, kMaxLanes));
  lanes = min(lanes, K);
  const int groups = (K + lanes - 1) / lanes;
  const size_t smem = kTable * sizeof(uint32_t) + kMaxLanes * sizeof(int32_t)
                      + static_cast<size_t>(B) * lanes * C * acc;
  cudaFuncSetAttribute(hist_kernel<kIntMode, kVec, kC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  // about one CTA per SM (measured best on an H100: more row chunks
  // cost more flushes than they hide latency); whole groups of rows
  const long long per_chunk = static_cast<long long>(F) * groups;
  long long chunks = (num_sms() + per_chunk - 1) / per_chunk;
  const long long max_chunks = (n + kVec * kThreads - 1) / (kVec * kThreads);
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  int rows_per_cta = static_cast<int>((n + chunks - 1) / chunks);
  rows_per_cta = (rows_per_cta + kVec - 1) / kVec * kVec;
  dim3 grid(F, static_cast<unsigned>(chunks), groups);
  hist_kernel<kIntMode, kVec, kC><<<grid, kThreads, smem, stream>>>(
      bins_t, vals_t, leaf_id, small_ids, n, F, K, B, rows_per_cta, lanes,
      out);
  return static_cast<int>(cudaGetLastError());
}

// the channel count is a template parameter so each row's values stay in
// registers
template <bool kIntMode, int kVec>
int launch_vec(const uint8_t* bins_t, const float* vals_t,
               const int32_t* leaf_id, const int32_t* small_ids, int n, int F,
               int C, int K, int B, void* out, cudaStream_t stream) {
  switch (C) {
#define LGBT_CASE(c)                                                    \
  case c:                                                               \
    return launch_c<kIntMode, kVec, c>(bins_t, vals_t, leaf_id,         \
                                       small_ids, n, F, K, B, out, stream);
    LGBT_CASE(1) LGBT_CASE(2) LGBT_CASE(3) LGBT_CASE(4)
    LGBT_CASE(5) LGBT_CASE(6) LGBT_CASE(7) LGBT_CASE(8)
#undef LGBT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kIntMode>
int launch(const uint8_t* bins_t, const float* vals_t, const int32_t* leaf_id,
           const int32_t* small_ids, int n, int F, int C, int K, int B,
           void* out, cudaStream_t stream) {
  // the 4-row path needs whole groups of 4 and 16-byte aligned rows
  const bool vec = n % 4 == 0
      && reinterpret_cast<uintptr_t>(vals_t) % 16 == 0
      && reinterpret_cast<uintptr_t>(leaf_id) % 16 == 0
      && reinterpret_cast<uintptr_t>(bins_t) % 4 == 0;
  return vec
      ? launch_vec<kIntMode, 4>(bins_t, vals_t, leaf_id, small_ids, n, F, C,
                                K, B, out, stream)
      : launch_vec<kIntMode, 1>(bins_t, vals_t, leaf_id, small_ids, n, F, C,
                                K, B, out, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). `out` is [K, F, B, C], zeroed by
// the caller: int32 when int_mode, else float32. Returns cudaGetLastError().
extern "C" int lgbt_multi_leaf_histogram(
    const void* bins_t, const void* vals_t, const void* leaf_id,
    const void* small_ids, int n, int F, int C, int K, int B, int int_mode,
    void* out, void* stream) {
  if (n <= 0 || F <= 0 || K <= 0) return 0;
  if (C < 1 || C > kMaxChannels || B < 1 || B > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint8_t*>(bins_t);
  auto v = static_cast<const float*>(vals_t);
  auto l = static_cast<const int32_t*>(leaf_id);
  auto k = static_cast<const int32_t*>(small_ids);
  return int_mode ? launch<true>(b, v, l, k, n, F, C, K, B, out, s)
                  : launch<false>(b, v, l, k, n, F, C, K, B, out, s);
}
