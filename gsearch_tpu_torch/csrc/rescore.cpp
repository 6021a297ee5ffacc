// Exact equal-slot counts of the graph index's host re-score.
//
// For each query q and each of its R candidate ids, the row
// sigs[clip(id, 0, n - 1)] is walked once against the query's row and the
// number of equal slots written to out[q * R + r] (int32).  Slots are
// compared as bit patterns of their width: 4-byte signatures (f32, i32,
// u32) as uint32, so NaN payloads and -0.0 equal only the same bits, and
// u16 signatures as uint16 (equal after zero-extension too).  This is the
// count of gsearch_tpu_torch/index/hnsw.py's numpy form, which gathers the
// rows into a [Q, R, S] copy, compares and sums; here each row is read
// once and nothing else is written.
//
// The Q x R pairs are split into contiguous ranges over `threads` threads
// (the calling thread takes the first).  Exposed via a C ABI for ctypes;
// built at first use by gsearch_tpu_torch/ops/host_rescore.py
// (g++ -O3 -shared -fPIC -pthread) into build/gsearch_tpu_torch/.

#include <cstddef>
#include <cstdint>
#include <system_error>
#include <thread>
#include <utility>
#include <vector>

namespace {

template <typename T>
int32_t count_equal(const T* a, const T* b, int64_t s) {
    int32_t c = 0;
    for (int64_t k = 0; k < s; ++k) c += a[k] == b[k];
    return c;
}

template <typename T>
void count_range(const T* sigs, int64_t n, int64_t s, int64_t row_stride,
                 const T* queries, const int64_t* ids, int64_t r,
                 int32_t* out, int64_t lo, int64_t hi) {
    for (int64_t p = lo; p < hi; ++p) {
        int64_t id = ids[p];
        id = id < 0 ? 0 : (id >= n ? n - 1 : id);
        out[p] = count_equal(sigs + id * row_stride, queries + (p / r) * s, s);
    }
}

template <typename T>
void count_all(const T* sigs, int64_t n, int64_t s, int64_t row_stride,
               const T* queries, const int64_t* ids, int64_t q, int64_t r,
               int32_t* out, int threads) {
    const int64_t pairs = q * r;
    if (threads < 1) threads = 1;
    if (threads > pairs) threads = (int)pairs;
    std::vector<std::thread> pool;
    // the calling thread takes the first range, and any whose thread
    // could not be started
    std::vector<std::pair<int64_t, int64_t>> here{{0, pairs / threads}};
    for (int t = 1; t < threads; ++t) {
        const int64_t lo = pairs * t / threads, hi = pairs * (t + 1) / threads;
        try {
            pool.emplace_back(count_range<T>, sigs, n, s, row_stride, queries, ids, r,
                              out, lo, hi);
        } catch (const std::system_error&) {
            here.emplace_back(lo, hi);
        }
    }
    for (const auto& [lo, hi] : here)
        count_range<T>(sigs, n, s, row_stride, queries, ids, r, out, lo, hi);
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// elem_bytes 4 (f32, i32, u32 as bit patterns) or 2 (u16); sigs has n rows
// row_stride elements apart, queries [q, s] and ids [q, r] are contiguous.
// Returns 0, or -1 for an element width it does not know.
int rescore_eq_counts(const void* sigs, int64_t n, int64_t s, int64_t row_stride,
                      int elem_bytes, const void* queries, const int64_t* ids,
                      int64_t q, int64_t r, int32_t* out, int threads) {
    if (q <= 0 || r <= 0) return 0;
    if (elem_bytes == 4) {
        count_all(static_cast<const uint32_t*>(sigs), n, s, row_stride,
                  static_cast<const uint32_t*>(queries), ids, q, r, out, threads);
    } else if (elem_bytes == 2) {
        count_all(static_cast<const uint16_t*>(sigs), n, s, row_stride,
                  static_cast<const uint16_t*>(queries), ids, q, r, out, threads);
    } else {
        return -1;
    }
    return 0;
}

}  // extern "C"
