// Batched row gather of the sharded feature store (data/sharded.py).
//
// A loader batch reads, per encoder, B image rows of an fc block and of an
// att block; per-row numpy slicing of memory maps runs in the interpreter
// and holds the GIL. gather_rows does one call per (shard, block): n
// positioned reads (pread) fanned over a small pool of threads, each
// straight into its slot of the caller's buffer. ctypes releases the GIL
// for the call, so the loader's other threads run meanwhile.
//
// The port's counterpart of recurrent_fusion_network_tpu/data/native/
// feature_io.cpp, with the same C entry point and ctypes signature:
//
//   int gather_rows(const char* path, const int64_t* offsets, int64_t n,
//                   int64_t row_bytes, char* out, int n_threads)
//
// reads row i (row_bytes bytes at byte offset offsets[i] of the file at
// path) into out + i * row_bytes; returns 0, or -errno of the first read or
// open that failed (-EIO where the file ends before a row does).

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <system_error>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

// All len bytes at offset off, through short reads and EINTR.
int pread_all(int fd, char* dst, int64_t len, int64_t off) {
    while (len > 0) {
        const ssize_t got = pread(fd, dst, static_cast<size_t>(len), off);
        if (got < 0) {
            if (errno == EINTR) continue;
            return -errno;
        }
        if (got == 0) return -EIO;  // past the end: the offsets are wrong
        dst += got;
        off += got;
        len -= got;
    }
    return 0;
}

constexpr int64_t kMinRowsPerThread = 16;

}  // namespace

extern "C" int gather_rows(const char* path, const int64_t* offsets, int64_t n,
                           int64_t row_bytes, char* out, int n_threads) {
    if (n <= 0) return 0;
    if (row_bytes <= 0 || path == nullptr || offsets == nullptr || out == nullptr)
        return -EINVAL;
    // O_CLOEXEC: a process the host forks meanwhile (a metric's subprocess)
    // inherits no shard descriptor
    const int fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return -errno;

    const int64_t most = (n + kMinRowsPerThread - 1) / kMinRowsPerThread;
    const int threads = static_cast<int>(
        n_threads < 1 ? 1 : (n_threads > most ? most : n_threads));
    std::atomic<int> status{0};
    auto read_rows = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            if (status.load(std::memory_order_relaxed) != 0) return;
            const int rc = pread_all(fd, out + i * row_bytes, row_bytes, offsets[i]);
            if (rc != 0) {
                int none = 0;
                status.compare_exchange_strong(none, rc);
                return;
            }
        }
    };

    const int64_t chunk = (n + threads - 1) / threads;
    std::vector<std::thread> pool;
    int64_t inline_from = n;  // rows [inline_from, n) are read on this thread
    for (int64_t lo = chunk; lo < n; lo += chunk) {
        // a thread that cannot start (std::system_error) must not unwind
        // through the C entry point: its rows and the rest are read here
        try {
            pool.emplace_back(read_rows, lo, std::min(lo + chunk, n));
        } catch (const std::system_error&) {
            inline_from = lo;
            break;
        }
    }
    read_rows(0, std::min(chunk, n));
    if (inline_from < n) read_rows(inline_from, n);
    for (auto& th : pool) th.join();
    close(fd);
    return status.load();
}
