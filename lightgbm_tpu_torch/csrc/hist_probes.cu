// Two histogram probe kernels for Hopper (sm_90a): variants of the
// multi-leaf histogram (csrc/histogram.cu, "kernel A") that answer design
// questions for its next form. Both compute kernel A's f32-mode function
//
//   hist[k, f, b, c] = sum_r [bins_t[f, r] == b] * [leaf_id[r] == small_ids[k]]
//                            * bf16(vals_t[c, r])
//
// bins_t [F, n] uint8, vals_t [C, n] f32, leaf_id [n] i32, small_ids [K] i32
// (K <= 32; a row with a negative leaf id matches no lane, and a lane
// whose id matches no row -- e.g. -1 -- gets a zero histogram), output
// [K, F, B, C] f32 zeroed by the caller; sums in f32 (atomics, so the order
// varies from run to run).
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
//    accumulator fits beside them, flushing each tile with global atomics.
//    Kernel A instead gives each CTA one feature, so every CTA re-reads
//    the values and ids (through L2). Only lanes that some row of the chunk
//    matches are zeroed and flushed.
// 2. lgbt_hist_probe_nibble replaces the TPU probe
//    benchmarks/nibble_probe.py (hist_nibble), which splits a bin as
//    b = nb*u + v. Here each CTA owns one feature, one bin group u and one
//    row chunk, and keeps only an [nb][K][C] tile in shared memory -- B/nb
//    times smaller than kernel A's [B][K][C] tile, so many more CTAs fit on
//    an SM -- at the price of scanning each feature's bins once per group.
//    nb is a parameter (the TPU probe tried 16, 32 and 64).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 32;      // lanes (one bit each)
constexpr int kTable = 2048;       // leaf ids with a direct table entry
constexpr size_t kSmemLimit = 232448;   // dynamic shared memory per CTA

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

// ---- probe 2: bin groups of nb ------------------------------------------
constexpr int kNibThreads = 256;

template <int kC, int kVec>
__global__ void __launch_bounds__(kNibThreads)
probe_nibble_kernel(const uint8_t* __restrict__ bins_t,
                    const float* __restrict__ vals_t,
                    const int32_t* __restrict__ leaf_id,
                    const int32_t* __restrict__ small_ids, int n, int F,
                    int K, int B, int nb, int groups, int rows_per_cta,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);          // [kTable]
  int32_t* ids = reinterpret_cast<int32_t*>(table + kTable);     // [32]
  float* acc = reinterpret_cast<float*>(ids + kMaxLanes);        // [nb][K][C]

  const int f = blockIdx.x / groups;
  const int lo = (blockIdx.x % groups) * nb;
  const int hi = min(B, lo + nb);
  const int r_begin = blockIdx.y * rows_per_cta;
  const int r_end = min(n, r_begin + rows_per_cta);
  const int cells = nb * K * kC;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.f;
  load_lanes(table, ids, small_ids, K);
  __syncthreads();

  const uint8_t* bins_f = bins_t + static_cast<size_t>(f) * n;
  auto add_row = [&](int r, int b) {
    if (b < lo || b >= hi) return;           // another group's bin
    uint32_t m = lanes_of(leaf_id[r], table, ids, K);
    if (!m) return;
    float v[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      v[c] = bf16_round(vals_t[static_cast<size_t>(c) * n + r]);
    }
    float* cell = acc + (b - lo) * K * kC;
    for (; m; m &= m - 1u) {
      const int k = __ffs(m) - 1;
#pragma unroll
      for (int c = 0; c < kC; ++c) atomicAdd(&cell[k * kC + c], v[c]);
    }
  };
  if constexpr (kVec == 4) {
    // n % 4 == 0 and rows_per_cta % 4 == 0: whole, aligned groups of 4
    for (int r = r_begin + 4 * threadIdx.x; r < r_end; r += 4 * blockDim.x) {
      const uchar4 b = *reinterpret_cast<const uchar4*>(bins_f + r);
      add_row(r, b.x);
      add_row(r + 1, b.y);
      add_row(r + 2, b.z);
      add_row(r + 3, b.w);
    }
  } else {
    for (int r = r_begin + threadIdx.x; r < r_end; r += blockDim.x) {
      add_row(r, bins_f[r]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float x = acc[i];
    if (x == 0.f) continue;
    const int c = i % kC;
    const int k = (i / kC) % K;
    const int b = lo + i / (kC * K);
    atomicAdd(&out[((static_cast<size_t>(k) * F + f) * B + b) * kC + c], x);
  }
}

template <int kC, int kVec>
int launch_nibble(const uint8_t* bins_t, const float* vals_t,
                  const int32_t* leaf_id, const int32_t* small_ids, int n,
                  int F, int K, int B, int nb, float* out,
                  cudaStream_t stream) {
  const int groups = (B + nb - 1) / nb;
  const size_t smem = (kTable + kMaxLanes) * sizeof(uint32_t)
                      + static_cast<size_t>(nb) * K * kC * sizeof(float);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(probe_nibble_kernel<kC, kVec>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  // about eight resident CTAs per SM in all, no chunk under 1024 rows
  const long long per_chunk = static_cast<long long>(F) * groups;
  long long chunks = (8LL * num_sms() + per_chunk - 1) / per_chunk;
  const long long max_chunks = (n + 1023) / 1024;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  int rows_per_cta = static_cast<int>((n + chunks - 1) / chunks);
  rows_per_cta = (rows_per_cta + kVec - 1) / kVec * kVec;
  dim3 grid(static_cast<unsigned>(per_chunk), static_cast<unsigned>(chunks));
  probe_nibble_kernel<kC, kVec><<<grid, kNibThreads, smem, stream>>>(
      bins_t, vals_t, leaf_id, small_ids, n, F, K, B, nb, groups,
      rows_per_cta, out);
  return static_cast<int>(cudaGetLastError());
}

template <int kC>
int launch_nibble_c(const uint8_t* bins_t, const float* vals_t,
                    const int32_t* leaf_id, const int32_t* small_ids, int n,
                    int F, int K, int B, int nb, float* out,
                    cudaStream_t stream) {
  // the 4-row path needs whole groups of 4 and 4-byte aligned bin rows
  const bool vec = n % 4 == 0
      && reinterpret_cast<uintptr_t>(bins_t) % 4 == 0;
  return vec ? launch_nibble<kC, 4>(bins_t, vals_t, leaf_id, small_ids, n, F,
                                    K, B, nb, out, stream)
             : launch_nibble<kC, 1>(bins_t, vals_t, leaf_id, small_ids, n, F,
                                    K, B, nb, out, stream);
}

bool bad_shape(int C, int K, int B) {
  return C < 1 || C > 8 || K > kMaxLanes || B < 1 || B > 256;
}

}  // namespace

// Plain C entry points (bound with ctypes). `out` is [K, F, B, C] f32,
// zeroed by the caller. Return cudaGetLastError(), or cudaErrorInvalidValue
// for shapes the probes do not take (K > 32, C > 8, B > 256, a tile that
// does not fit in shared memory).
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
  if (n <= 0 || F <= 0 || K <= 0) return 0;
  if (bad_shape(C, K, B) || nb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto b = static_cast<const uint8_t*>(bins_t);
  auto v = static_cast<const float*>(vals_t);
  auto l = static_cast<const int32_t*>(leaf_id);
  auto k = static_cast<const int32_t*>(small_ids);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define LGBT_NIB(c) launch_nibble_c<c>(b, v, l, k, n, F, K, B, nb, o, s)
  LGBT_SWITCH_C(LGBT_NIB)
#undef LGBT_NIB
}
