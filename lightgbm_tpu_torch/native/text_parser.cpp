// Fast delimited-text parser for the dataset loader.
//
// Reference: the reference framework's C++ text readers
// (include/LightGBM/utils/text_reader.h + src/io/parser.cpp, UNVERIFIED —
// empty mount, see SURVEY.md banner) stream CSV/TSV/LibSVM with custom
// atof loops because libc strtod + Python-level splitting dominate load
// time at multi-GB scale. A copy of lightgbm_tpu/native/text_parser.cpp:
// a ctypes-loaded shared object with a plain C interface, compiled with
// g++ at first use by native/__init__.py.
//
// Exposed C ABI:
//   count_lines(path)                      -> data lines (non-empty)
//   count_fields(path, delim)              -> fields in first data line
//   parse_dense(path, delim, skip, out, max_rows, n_cols) -> rows parsed
//   parse_libsvm(path, skip, rows_out, cols_out, vals_out, labels_out,
//                max_nnz, max_rows)        -> nnz parsed (labels per row)
//
// Missing fields ("", "NA", "na", "nan", "?") parse as NaN. Lines whose
// first non-space char is '#' are skipped.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

bool read_file(const char* path, std::vector<char>& buf) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    buf.resize(static_cast<size_t>(size) + 1);
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
    std::fclose(f);
    buf[got] = '\0';
    buf.resize(got + 1);
    return true;
}

inline bool is_missing_token(const char* s, const char* end) {
    size_t len = static_cast<size_t>(end - s);
    if (len == 0) return true;
    if (len == 1 && *s == '?') return true;
    if ((len == 2) && (s[0] == 'N' || s[0] == 'n')
        && (s[1] == 'A' || s[1] == 'a')) return true;
    return false;
}

inline double parse_field(const char* s, const char* end) {
    while (s < end && (*s == ' ' || *s == '\r')) ++s;
    const char* e = end;
    while (e > s && (e[-1] == ' ' || e[-1] == '\r')) --e;
    if (is_missing_token(s, e)) return NAN;
    char* parse_end = nullptr;
    double v = std::strtod(s, &parse_end);
    if (parse_end == s) return NAN;
    return v;
}

inline bool skip_line(const char* p, const char* nl) {
    while (p < nl && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p >= nl || *p == '#';
}

}  // namespace

extern "C" {

long count_lines(const char* path) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    long n = 0;
    const char* p = buf.data();
    const char* end = p + buf.size() - 1;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!nl) nl = end;
        if (!skip_line(p, nl)) ++n;
        p = nl + 1;
    }
    return n;
}

int count_fields(const char* path, char delim) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    const char* p = buf.data();
    const char* end = p + buf.size() - 1;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!nl) nl = end;
        if (!skip_line(p, nl)) {
            int n = 1;
            for (const char* q = p; q < nl; ++q)
                if (*q == delim) ++n;
            return n;
        }
        p = nl + 1;
    }
    return 0;
}

long parse_dense(const char* path, char delim, int skip_rows,
                 double* out, long max_rows, int n_cols) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    const char* p = buf.data();
    const char* end = p + buf.size() - 1;
    long row = 0;
    int to_skip = skip_rows;
    while (p < end && row < max_rows) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!nl) nl = end;
        if (!skip_line(p, nl)) {
            if (to_skip > 0) {
                --to_skip;
            } else {
                double* dst = out + row * n_cols;
                const char* fs = p;
                int c = 0;
                for (const char* q = p; q <= nl && c < n_cols; ++q) {
                    if (q == nl || *q == delim) {
                        dst[c++] = parse_field(fs, q);
                        fs = q + 1;
                    }
                }
                for (; c < n_cols; ++c) dst[c] = NAN;
                ++row;
            }
        }
        p = nl + 1;
    }
    return row;
}

long parse_libsvm(const char* path, int skip_rows, int* rows_out,
                  int* cols_out, double* vals_out, double* labels_out,
                  long max_nnz, long max_rows) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    const char* p = buf.data();
    const char* end = p + buf.size() - 1;
    long nnz = 0;
    long row = 0;
    int to_skip = skip_rows;
    while (p < end && row < max_rows) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!nl) nl = end;
        if (!skip_line(p, nl)) {
            if (to_skip > 0) {
                --to_skip;
            } else {
                char* q = nullptr;
                labels_out[row] = std::strtod(p, &q);
                while (q < nl) {
                    while (q < nl && *q == ' ') ++q;
                    if (q >= nl) break;
                    char* colon = nullptr;
                    long idx = std::strtol(q, &colon, 10);
                    if (colon == q || *colon != ':') break;
                    char* vend = nullptr;
                    double v = std::strtod(colon + 1, &vend);
                    if (vend == colon + 1) break;
                    if (nnz >= max_nnz) return -2;
                    rows_out[nnz] = static_cast<int>(row);
                    cols_out[nnz] = static_cast<int>(idx);
                    vals_out[nnz] = v;
                    ++nnz;
                    q = vend;
                }
                ++row;
            }
        }
        p = nl + 1;
    }
    return nnz;
}

}  // extern "C"
