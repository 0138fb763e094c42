// gnnio — native host runtime of legion_tpu_torch (counterpart of
// legion_tpu/runtime/gnnio.cpp; same four entries, same results).
//
// The host-side hot paths of the host-topology placement: the pinned-host
// feature reads of zero_copy_with_aggregated_cache (reference
// src/Kernels.cu:662-702) become a threaded row gather, and the host CSR
// sampling behind the topology cache's misses (the reference samples the
// zero-copy CSR from GPU threads, src/Kernels.cu:468-564) becomes a
// threaded CPU sampler whose draws are a pure function of (seed, row,
// slot), so any thread count gives the same neighbors.
//
// A plain C ABI bound with ctypes (legion_tpu_torch/runtime). Pure C, no
// Python API: ctypes releases the GIL around each call. The caller gives
// the most threads to use; each entry starts no more than it has chunks
// of work and runs a single chunk on the calling thread, so a small call
// (two a training step) pays for no thread it cannot feed.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// Run work() on up to nthreads threads, but on no more than there are
// chunks of `chunk` items among n; one chunk runs on the caller.
template <class Work>
static void run_threads(int nthreads, int64_t n, int64_t chunk, Work work) {
    int64_t chunks = (n + chunk - 1) / chunk;
    if (nthreads > chunks) nthreads = (int)chunks;
    if (nthreads <= 1) {
        work();
        return;
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
}

extern "C" {

// Parallel row gather: out[i, :] = table[ids[i], :], zeros for ids < 0.
void gather_rows_f32(float* out, const float* table, const int32_t* ids,
                     int64_t n, int64_t dim, int64_t num_rows, int nthreads) {
    std::atomic<int64_t> next(0);
    const int64_t chunk = 256;
    auto work = [&]() {
        for (;;) {
            int64_t s = next.fetch_add(chunk);
            if (s >= n) break;
            int64_t e = s + chunk < n ? s + chunk : n;
            for (int64_t i = s; i < e; i++) {
                int32_t id = ids[i];
                float* dst = out + i * dim;
                if (id < 0 || id >= num_rows) {
                    memset(dst, 0, dim * sizeof(float));
                } else {
                    memcpy(dst, table + (int64_t)id * dim, dim * sizeof(float));
                }
            }
        }
    };
    run_threads(nthreads, n, chunk, work);
}

// splitmix64 — cheap counter-based PRNG for reproducible host sampling.
static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

// Uniform-with-replacement neighbor sampling over a host CSR.
// Semantics identical to the device sampler (and the reference kernel,
// src/Kernels.cu:399-410): slot s of node v is valid iff s < deg(v);
// valid slots draw uniformly from v's full neighbor list. ids < 0 give
// all -1 rows.
void sample_neighbors_u32(int32_t* out, const int64_t* indptr,
                          const int32_t* indices, const int32_t* ids,
                          int64_t n, int32_t fanout, uint64_t seed,
                          int nthreads) {
    std::atomic<int64_t> next(0);
    const int64_t chunk = 128;
    auto work = [&]() {
        for (;;) {
            int64_t s = next.fetch_add(chunk);
            if (s >= n) break;
            int64_t e = s + chunk < n ? s + chunk : n;
            for (int64_t i = s; i < e; i++) {
                int32_t v = ids[i];
                int32_t* dst = out + i * fanout;
                if (v < 0) {
                    for (int32_t f = 0; f < fanout; f++) dst[f] = -1;
                    continue;
                }
                int64_t start = indptr[v];
                int64_t deg = indptr[v + 1] - start;
                for (int32_t f = 0; f < fanout; f++) {
                    if (f >= deg || deg <= 0) {
                        dst[f] = -1;
                    } else {
                        uint64_t r = splitmix64(seed ^ ((uint64_t)i << 20) ^ f);
                        dst[f] = indices[start + (int64_t)(r % (uint64_t)deg)];
                    }
                }
            }
        }
    };
    run_threads(nthreads, n, chunk, work);
}

// Histogram accumulate: hist[ids[i]] += 1 for 0 <= ids[i] < num_rows
// (hotness counting for the host presample). Threads add into the one
// shared histogram with relaxed atomic increments: a histogram per thread
// would cost num_rows * 8 bytes a thread and a serial pass over each,
// which at tens of millions of rows outweighs the counting itself.
void accumulate_hist_i64(int64_t* hist, const int32_t* ids, int64_t n,
                         int64_t num_rows, int nthreads) {
    std::atomic<int64_t> next(0);
    const int64_t chunk = 1 << 14;
    auto work = [&]() {
        for (;;) {
            int64_t s = next.fetch_add(chunk);
            if (s >= n) break;
            int64_t e = s + chunk < n ? s + chunk : n;
            for (int64_t i = s; i < e; i++) {
                int32_t v = ids[i];
                if (v >= 0 && v < num_rows)
                    __atomic_fetch_add(&hist[v], (int64_t)1, __ATOMIC_RELAXED);
            }
        }
    };
    run_threads(nthreads, n, chunk, work);
}

// COO -> CSR conversion (counting sort by dst), for the dataset packer.
// src/dst are int32 edge endpoints; indptr must hold num_nodes+1 int64
// zeros on entry; indices holds num_edges int32 on exit.
void coo_to_csr(const int32_t* src, const int32_t* dst, int64_t num_edges,
                int64_t num_nodes, int64_t* indptr, int32_t* indices) {
    for (int64_t i = 0; i < num_edges; i++) indptr[dst[i] + 1]++;
    for (int64_t v = 0; v < num_nodes; v++) indptr[v + 1] += indptr[v];
    std::vector<int64_t> cur(indptr, indptr + num_nodes);
    for (int64_t i = 0; i < num_edges; i++) {
        indices[cur[dst[i]]++] = src[i];
    }
}

}  // extern "C"
