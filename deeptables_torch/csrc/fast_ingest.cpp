// Fast data ingest for deeptables_torch (host C++, no GPU code).
//
// The classic bottleneck of CTR training at scale is host-side text parsing
// (Criteo-style TSV: label \t 13 integer dense \t 26 hex categorical).  The
// reference delegates ingest to pandas/Dask (Python-side); this native
// module parses shards with one thread per chunk straight into the packed
// int32/float32 batch layout the device pipeline consumes
// (data/pipeline.py packing convention). A copy of the JAX package's
// native/fast_ingest.cpp, built by deeptables_torch/data/fast_ingest.py into
// build/deeptables_torch/<hash>/libfast_ingest.so.
//
// Exposed via a plain C ABI (loaded with ctypes — no pybind11 needed):
//   parse_criteo_tsv(buf, len, n_dense, n_cat, hash_buckets[], n_threads,
//                    labels*, dense*, cats*, capacity) -> rows parsed
//   parse_numeric_csv(buf, len, n_cols, skip_header, n_threads, out,
//                     capacity) -> rows parsed
//
// Build: $CXX (else g++) -O3 -shared -fPIC -std=c++17 -pthread
//        fast_ingest.cpp -o libfast_ingest.so

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// FNV-1a 64-bit hash for categorical tokens.
static inline uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= (uint64_t)(unsigned char)s[i];
    h *= 1099511628211ull;
  }
  return h;
}

static inline const char* find_eol(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p;
}

// Parse an integer field; empty/invalid -> fallback.
static inline long parse_long(const char* p, const char* q, long fallback) {
  if (p >= q) return fallback;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  long v = 0;
  bool any = false;
  while (p < q && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
    any = true;
  }
  if (!any) return fallback;
  return neg ? -v : v;
}

static inline double parse_double(const char* p, const char* q,
                                  double fallback) {
  if (p >= q) return fallback;
  char tmp[64];
  size_t n = (size_t)(q - p);
  if (n >= sizeof(tmp)) n = sizeof(tmp) - 1;
  std::memcpy(tmp, p, n);
  tmp[n] = 0;
  char* endp = nullptr;
  double v = std::strtod(tmp, &endp);
  if (endp == tmp) return fallback;
  return v;
}

struct LineIndex {
  std::vector<const char*> starts;
  std::vector<const char*> ends;
};

static LineIndex index_lines(const char* buf, size_t len, bool skip_header) {
  LineIndex idx;
  const char* end = buf + len;
  const char* p = buf;
  bool first = true;
  while (p < end) {
    const char* eol = find_eol(p, end);
    const char* line_end = eol;
    if (line_end > p && line_end[-1] == '\r') --line_end;
    if (line_end > p) {
      if (!(first && skip_header)) {
        idx.starts.push_back(p);
        idx.ends.push_back(line_end);
      }
      first = false;
    }
    p = eol + 1;
  }
  return idx;
}

}  // namespace

extern "C" {

// Criteo-style TSV: label \t I1..In_dense \t C1..Cn_cat (hex tokens).
// dense: log1p(max(v,0)) float32; cats: fnv1a(token) % hash_buckets[j].
// Missing fields -> 0.  Returns number of rows written (<= capacity).
int64_t parse_criteo_tsv(const char* buf, int64_t len, int32_t n_dense,
                         int32_t n_cat, const int64_t* hash_buckets,
                         int32_t n_threads, float* labels, float* dense,
                         int32_t* cats, int64_t capacity) {
  LineIndex idx = index_lines(buf, (size_t)len, /*skip_header=*/false);
  int64_t rows = (int64_t)idx.starts.size();
  if (rows > capacity) rows = capacity;
  if (n_threads < 1) n_threads = 1;

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const char* p = idx.starts[r];
      const char* line_end = idx.ends[r];
      int field = 0;
      const char* fs = p;
      int32_t total_fields = 1 + n_dense + n_cat;
      while (field < total_fields) {
        const char* fe = fs;
        while (fe < line_end && *fe != '\t') ++fe;
        if (field == 0) {
          labels[r] = (float)parse_long(fs, fe, 0);
        } else if (field <= n_dense) {
          double v = parse_double(fs, fe, 0.0);
          if (v < 0) v = 0.0;
          // log1p transform, the standard Criteo dense preprocessing
          dense[r * n_dense + (field - 1)] =
              (float)std::log1p(v);
        } else {
          int j = field - 1 - n_dense;
          int64_t bucket = hash_buckets[j];
          if (fe > fs) {
            cats[r * n_cat + j] =
                (int32_t)(fnv1a(fs, (size_t)(fe - fs)) % (uint64_t)bucket);
          } else {
            cats[r * n_cat + j] = 0;
          }
        }
        ++field;
        if (fe >= line_end) break;
        fs = fe + 1;
      }
      // zero-fill any missing trailing fields
      for (int f = field; f < total_fields; ++f) {
        if (f == 0) labels[r] = 0.f;
        else if (f <= n_dense) dense[r * n_dense + (f - 1)] = 0.f;
        else cats[r * n_cat + (f - 1 - n_dense)] = 0;
      }
    }
  };

  std::vector<std::thread> threads;
  int64_t per = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < rows ? lo + per : rows;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return rows;
}

// Generic numeric CSV (comma-separated) -> float32 row-major matrix.
int64_t parse_numeric_csv(const char* buf, int64_t len, int32_t n_cols,
                          int32_t skip_header, int32_t n_threads,
                          float* out, int64_t capacity) {
  LineIndex idx = index_lines(buf, (size_t)len, skip_header != 0);
  int64_t rows = (int64_t)idx.starts.size();
  if (rows > capacity) rows = capacity;
  if (n_threads < 1) n_threads = 1;

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const char* fs = idx.starts[r];
      const char* line_end = idx.ends[r];
      for (int c = 0; c < n_cols; ++c) {
        const char* fe = fs;
        while (fe < line_end && *fe != ',') ++fe;
        out[r * n_cols + c] = (float)parse_double(fs, fe, 0.0);
        if (fe >= line_end) {
          for (int c2 = c + 1; c2 < n_cols; ++c2)
            out[r * n_cols + c2] = 0.f;
          break;
        }
        fs = fe + 1;
      }
    }
  };

  std::vector<std::thread> threads;
  int64_t per = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < rows ? lo + per : rows;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return rows;
}

}  // extern "C"
