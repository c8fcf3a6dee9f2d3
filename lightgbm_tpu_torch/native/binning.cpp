// Native binning hot paths (exact ports of io/binning.py's NumPy code).
//
// Reference analog: BinMapper::FindBin / GreedyFindBin and
// DenseBin::Push (src/io/bin.cpp, UNVERIFIED — empty mount, see
// SURVEY.md banner). Two costs dominate host-side dataset
// construction:
//   1. the greedy equal-mass bound search — a Python loop over ~100k
//      distinct sample values, twice per feature (neg/pos sides);
//   2. the value->bin apply — seven numpy passes over each column
//      (asarray, isnan, where, searchsorted, clip, where, astype).
// Both are bit-exact ports: the NumPy implementations stay as the plain
// versions, and tests/test_torch_native_binning.py pins native == NumPy
// on randomized inputs. A copy of lightgbm_tpu/native/binning.cpp: the
// torch package builds and loads its own (native/__init__.py).

#include <cmath>
#include <cstdint>

extern "C" {

// Exact port of _greedy_find_distinct_bounds (io/binning.py).
// Returns the number of bounds written to `out` (capacity max_bin+1);
// the last bound is +inf.
int64_t greedy_find_bounds(const double* dv, const int64_t* counts,
                           int64_t n_distinct, int64_t max_bin,
                           int64_t total_cnt, int64_t min_data_in_bin,
                           double* out) {
  const double kInf = INFINITY;
  int64_t n_out = 0;
  if (n_distinct == 0) {
    out[n_out++] = kInf;
    return n_out;
  }
  if (n_distinct <= max_bin) {
    int64_t cur_cnt = 0;
    for (int64_t i = 0; i + 1 < n_distinct; ++i) {
      cur_cnt += counts[i];
      if (cur_cnt >= min_data_in_bin) {
        out[n_out++] = (dv[i] + dv[i + 1]) / 2.0;
        cur_cnt = 0;
      }
    }
    out[n_out++] = kInf;
    return n_out;
  }
  if (min_data_in_bin > 0) {
    const int64_t cap = total_cnt / min_data_in_bin;
    const int64_t cap1 = cap > 1 ? cap : 1;
    if (cap1 < max_bin) max_bin = cap1;
  }
  double mean_size = static_cast<double>(total_cnt)
                     / static_cast<double>(max_bin);
  // is_big per value + aggregates (the Python computes these
  // vectorized; identical results)
  int64_t big_cnt_sum = 0, big_n = 0;
  for (int64_t i = 0; i < n_distinct; ++i) {
    if (static_cast<double>(counts[i]) >= mean_size) {
      big_cnt_sum += counts[i];
      ++big_n;
    }
  }
  double rest_cnt = static_cast<double>(total_cnt - big_cnt_sum);
  int64_t rest_bins = max_bin - big_n;
  mean_size = rest_bins > 0 ? rest_cnt / static_cast<double>(rest_bins)
                            : INFINITY;
  const double big_thresh = static_cast<double>(total_cnt)
                            / static_cast<double>(max_bin);
  auto is_big = [&](int64_t i) {
    return static_cast<double>(counts[i]) >= big_thresh;
  };
  int64_t cur_cnt = 0;
  int64_t n_upper = 0;
  for (int64_t i = 0; i + 1 < n_distinct; ++i) {
    const bool big_i = is_big(i);
    if (!big_i) rest_cnt -= static_cast<double>(counts[i]);
    cur_cnt += counts[i];
    const double cc = static_cast<double>(cur_cnt);
    const double half = mean_size * 0.5 > 1.0 ? mean_size * 0.5 : 1.0;
    if (big_i || cc >= mean_size || (is_big(i + 1) && cc >= half)) {
      out[n_out++] = (dv[i] + dv[i + 1]) / 2.0;
      ++n_upper;
      cur_cnt = 0;
      if (n_upper >= max_bin - 1) break;
      if (!big_i) {
        --rest_bins;
        if (rest_bins > 0) {
          mean_size = rest_cnt / static_cast<double>(rest_bins);
        }
      }
    }
  }
  out[n_out++] = kInf;
  return n_out;
}

// Exact port of BinMapper.values_to_bins's numerical branch: one pass,
// NaN-aware, strided in and out.
//   missing_type: 0 none / 1 zero / 2 nan (binning.py _MISSING codes)
//   out_kind: 0 uint8 / 1 uint16 / 2 int32
void bin_numeric_column(const void* values, int is_f32, int64_t n,
                        int64_t v_stride, const double* ub, int64_t nb,
                        int missing_type, int64_t default_bin,
                        int64_t num_bin, void* out, int out_kind,
                        int64_t out_stride) {
  const float* vf = static_cast<const float*>(values);
  const double* vd = static_cast<const double*>(values);
  uint8_t* o8 = static_cast<uint8_t*>(out);
  uint16_t* o16 = static_cast<uint16_t*>(out);
  int32_t* o32 = static_cast<int32_t*>(out);
  for (int64_t i = 0; i < n; ++i) {
    const double v = is_f32 ? static_cast<double>(vf[i * v_stride])
                            : vd[i * v_stride];
    int64_t b;
    if (std::isnan(v)) {
      // none/zero route NaN to the zero bin (== default_bin); the nan
      // type owns the last bin
      b = missing_type == 2 ? num_bin - 1 : default_bin;
    } else {
      // np.searchsorted(ub, v, side="left"): first idx with ub[i] >= v
      int64_t lo = 0, hi = nb;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (ub[mid] < v) lo = mid + 1; else hi = mid;
      }
      b = lo < nb - 1 ? lo : nb - 1;  // np.clip(vb, 0, nb-1)
    }
    const int64_t j = i * out_stride;
    if (out_kind == 0) o8[j] = static_cast<uint8_t>(b);
    else if (out_kind == 1) o16[j] = static_cast<uint16_t>(b);
    else o32[j] = static_cast<int32_t>(b);
  }
}

}  // extern "C"


// Bin every (numeric) column of a dense row-major matrix in ONE
// row-major pass — column-at-a-time binning of a [n, F] matrix strides
// F*itemsize bytes per element and cache-misses every read. When every
// column has <= kMaxTable bounds, the search runs BRANCHLESS over bound
// tables padded to a fixed width T (the smallest power of two, at least
// 256, that holds every column's bounds: 256 at max_bin 255, 1024 at
// 1023), interleaved across the row's columns so the L2 probe latencies
// overlap (log2 T fixed steps, conditional-move adds). Non-numeric output
// columns (is_num[c] == 0) are skipped and filled by the caller. Output is
// row-major [n_rows, n_cols].
//   ub_concat/ub_off: concatenated per-column upper bounds,
//     column c's bounds live in [ub_off[c], ub_off[c+1]).
#include <cstdlib>
#include <cstring>

namespace {

// the widest padded table of the branchless pass (more bounds take the
// scalar search)
constexpr int64_t kMaxTable = 4096;

// generic per-element fallback (any bound count)
inline int64_t SearchClip(const double* ub, int64_t nb, double v) {
  int64_t lo = 0, hi = nb;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ub[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < nb - 1 ? lo : nb - 1;
}

}  // namespace

extern "C" {

void bin_matrix(const void* X, int is_f32, int64_t n_rows,
                int64_t row_stride, const int64_t* col_idx,
                int64_t n_cols, const double* ub_concat,
                const int64_t* ub_off, const int* missing_type,
                const int64_t* default_bin, const int64_t* num_bin,
                const int* is_num, void* out, int out_kind) {
  const float* xf = static_cast<const float*>(X);
  const double* xd = static_cast<const double*>(X);
  uint8_t* o8 = static_cast<uint8_t*>(out);
  uint16_t* o16 = static_cast<uint16_t*>(out);
  int32_t* o32 = static_cast<int32_t*>(out);

  int64_t T = 256;                    // the padded table width
  for (int64_t c = 0; c < n_cols; ++c) {
    if (!is_num[c]) continue;
    while (T < ub_off[c + 1] - ub_off[c]) T *= 2;
  }
  const bool fast = n_cols <= 512 && T <= kMaxTable;
  if (fast) {
    // padded fixed-depth tables: tab[c] has T entries, real bounds
    // first, +inf padding after (padding never changes the clipped
    // searchsorted-left result because the real last bound IS +inf)
    double* tab = static_cast<double*>(
        std::malloc(static_cast<size_t>(n_cols) * T * sizeof(double)));
    int64_t nb_m1[512];
    for (int64_t c = 0; c < n_cols; ++c) {
      double* t = tab + c * T;
      const int64_t nb = is_num[c] ? ub_off[c + 1] - ub_off[c] : 1;
      for (int64_t i = 0; i < T; ++i) {
        t[i] = i < nb ? ub_concat[ub_off[c] + i] : INFINITY;
      }
      nb_m1[c] = nb - 1;
    }
    double v[512];
    int64_t pos[512];
    for (int64_t r = 0; r < n_rows; ++r) {
      const int64_t rbase = r * row_stride;
      const int64_t obase = r * n_cols;
      for (int64_t c = 0; c < n_cols; ++c) {
        const int64_t src = rbase + col_idx[c];
        v[c] = is_f32 ? static_cast<double>(xf[src]) : xd[src];
        pos[c] = 0;
      }
      // branchless searchsorted-left: pos = #bounds < v. NaN compares
      // false everywhere so pos stays 0 and is overwritten below.
      for (int64_t s = T / 2; s; s >>= 1) {
        for (int64_t c = 0; c < n_cols; ++c) {
          const double* t = tab + c * T;
          // mask arithmetic, NOT a ternary: gcc branches the ternary
          // and the 50% mispredicts serialize the probe chain
          pos[c] += s & -static_cast<int64_t>(
              t[pos[c] + s - 1] < v[c]);
        }
      }
      for (int64_t c = 0; c < n_cols; ++c) {
        if (!is_num[c]) continue;
        int64_t b = pos[c] < nb_m1[c] ? pos[c] : nb_m1[c];
        if (std::isnan(v[c])) {
          b = missing_type[c] == 2 ? num_bin[c] - 1 : default_bin[c];
        }
        if (out_kind == 0) o8[obase + c] = static_cast<uint8_t>(b);
        else if (out_kind == 1)
          o16[obase + c] = static_cast<uint16_t>(b);
        else o32[obase + c] = static_cast<int32_t>(b);
      }
    }
    std::free(tab);
    return;
  }
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t rbase = r * row_stride;
    const int64_t obase = r * n_cols;
    for (int64_t c = 0; c < n_cols; ++c) {
      if (!is_num[c]) continue;
      const int64_t src = rbase + col_idx[c];
      const double v = is_f32 ? static_cast<double>(xf[src]) : xd[src];
      const double* ub = ub_concat + ub_off[c];
      const int64_t nb = ub_off[c + 1] - ub_off[c];
      int64_t b;
      if (std::isnan(v)) {
        b = missing_type[c] == 2 ? num_bin[c] - 1 : default_bin[c];
      } else {
        b = SearchClip(ub, nb, v);
      }
      if (out_kind == 0) o8[obase + c] = static_cast<uint8_t>(b);
      else if (out_kind == 1) o16[obase + c] = static_cast<uint16_t>(b);
      else o32[obase + c] = static_cast<int32_t>(b);
    }
  }
}

}  // extern "C"
