// fastio: threaded scatter-read + chunk prefetch for movie files.
//
// The reference package parallelizes file IO with torch DataLoader worker
// *processes* (reference pmd_loader.py:151-168) — heavyweight, pickling
// every chunk across process boundaries, and flagged "experimental and best
// kept at 0" in its own docs. This native library replaces that with a
// thread pool doing positioned reads (pread) directly into the caller's
// buffer (zero-copy into numpy, or into the numpy view of a pinned staging
// buffer), plus an async one-chunk-ahead prefetcher so disk IO overlaps
// host->device transfer and device compute. A copy of the JAX package's
// cpp/fastio.cpp.
//
// Exposed C ABI (consumed via ctypes from localmd_tpu_torch.io.native):
//   fastio_open(path)                         -> handle (>=0) or -errno
//   fastio_close(handle)
//   fastio_read_scatter(handle, offsets[], sizes[], n, out, out_stride,
//                       n_threads)            -> 0 or -errno
//   fastio_prefetch_submit(handle, offsets[], sizes[], n, out, out_stride,
//                          n_threads)         -> ticket (>=0)
//   fastio_prefetch_wait(ticket)              -> 0 or -errno
//
// Build: localmd_tpu_torch/io/native.py runs g++ -O3 -shared -fPIC -pthread at
// first use, into localmd_tpu_torch/_build/ (keyed on a hash of this file).

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <future>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct FileHandle {
    int fd = -1;
};

std::mutex g_mutex;
std::map<int64_t, FileHandle> g_files;
int64_t g_next_handle = 1;

std::map<int64_t, std::future<int64_t>> g_tickets;
int64_t g_next_ticket = 1;

// Read `n` records described by (offsets[i], sizes[i]) into
// out + i * out_stride, fanned out over `n_threads` threads.
int64_t scatter_read(int fd, const int64_t* offsets, const int64_t* sizes,
                     int64_t n, uint8_t* out, int64_t out_stride,
                     int64_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = n;
    std::atomic<int64_t> next{0};
    std::atomic<int64_t> err{0};

    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n || err.load() != 0) return;
            int64_t remaining = sizes[i];
            int64_t off = offsets[i];
            uint8_t* dst = out + i * out_stride;
            while (remaining > 0) {
                ssize_t got = pread(fd, dst, remaining, off);
                if (got < 0) {
                    if (errno == EINTR) continue;
                    err.store(-errno);
                    return;
                }
                if (got == 0) {  // unexpected EOF
                    err.store(-EIO);
                    return;
                }
                remaining -= got;
                off += got;
                dst += got;
            }
        }
    };

    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
    return err.load();
}

int get_fd(int64_t handle) {
    std::lock_guard<std::mutex> lk(g_mutex);
    auto it = g_files.find(handle);
    return it == g_files.end() ? -1 : it->second.fd;
}

}  // namespace

extern "C" {

int64_t fastio_open(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -errno;
#ifdef POSIX_FADV_SEQUENTIAL
    posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
#endif
    std::lock_guard<std::mutex> lk(g_mutex);
    int64_t h = g_next_handle++;
    g_files[h] = FileHandle{fd};
    return h;
}

int64_t fastio_close(int64_t handle) {
    std::lock_guard<std::mutex> lk(g_mutex);
    auto it = g_files.find(handle);
    if (it == g_files.end()) return -EBADF;
    close(it->second.fd);
    g_files.erase(it);
    return 0;
}

int64_t fastio_read_scatter(int64_t handle, const int64_t* offsets,
                            const int64_t* sizes, int64_t n, uint8_t* out,
                            int64_t out_stride, int64_t n_threads) {
    int fd = get_fd(handle);
    if (fd < 0) return -EBADF;
    return scatter_read(fd, offsets, sizes, n, out, out_stride, n_threads);
}

// Submit an async scatter read; copies the offset/size arrays so the caller
// may free them immediately. The output buffer must stay alive until wait.
int64_t fastio_prefetch_submit(int64_t handle, const int64_t* offsets,
                               const int64_t* sizes, int64_t n, uint8_t* out,
                               int64_t out_stride, int64_t n_threads) {
    int fd = get_fd(handle);
    if (fd < 0) return -EBADF;
    auto offs = std::make_shared<std::vector<int64_t>>(offsets, offsets + n);
    auto szs = std::make_shared<std::vector<int64_t>>(sizes, sizes + n);
    auto fut = std::async(std::launch::async, [=]() {
        return scatter_read(fd, offs->data(), szs->data(), n, out, out_stride,
                            n_threads);
    });
    std::lock_guard<std::mutex> lk(g_mutex);
    int64_t ticket = g_next_ticket++;
    g_tickets[ticket] = std::move(fut);
    return ticket;
}

int64_t fastio_prefetch_wait(int64_t ticket) {
    std::future<int64_t> fut;
    {
        std::lock_guard<std::mutex> lk(g_mutex);
        auto it = g_tickets.find(ticket);
        if (it == g_tickets.end()) return -EINVAL;
        fut = std::move(it->second);
        g_tickets.erase(it);
    }
    return fut.get();
}

// TIFF-variant LZW decode (TIFF 6.0 §13): MSB-first bit packing, 9-bit
// initial code width, ClearCode=256, EOI=257, "early change" width bumps at
// table sizes 511/1023/2047. Returns bytes written to dst, or -EINVAL on a
// malformed stream / -ENOSPC if dst_cap is too small. Decoding a compressed
// TIFF strip in Python is ~100x slower; this keeps compressed movie reads
// IO-bound rather than decode-bound.
int64_t fastio_lzw_decode(const uint8_t* src, int64_t src_len, uint8_t* dst,
                          int64_t dst_cap) {
    constexpr int kClear = 256, kEoi = 257, kMaxCodes = 4096;
    // Each table entry is (prefix code, suffix byte); strings are emitted by
    // walking prefix links backwards through a small stack.
    static thread_local int16_t prefix_tab[kMaxCodes];
    static thread_local uint8_t suffix_tab[kMaxCodes];
    uint8_t stack[kMaxCodes];

    int width = 9;
    int next_code = 258;
    uint64_t bitbuf = 0;
    int bitcnt = 0;
    int64_t si = 0, di = 0;
    int prev = -1;
    uint8_t first_byte = 0;

    auto reset = [&]() {
        width = 9;
        next_code = 258;
        prev = -1;
    };

    for (;;) {
        while (bitcnt < width) {
            if (si >= src_len) return di;  // stream ends without EOI: accept
            bitbuf = (bitbuf << 8) | src[si++];
            bitcnt += 8;
        }
        int code = (int)((bitbuf >> (bitcnt - width)) & ((1u << width) - 1));
        bitcnt -= width;

        if (code == kEoi) return di;
        if (code == kClear) {
            reset();
            continue;
        }
        if (prev < 0) {
            // First code after a clear must be a literal.
            if (code >= 256) return -EINVAL;
            if (di >= dst_cap) return -ENOSPC;
            dst[di++] = (uint8_t)code;
            prev = code;
            first_byte = (uint8_t)code;
            continue;
        }

        int emit = code;
        int sp = 0;
        if (code >= next_code) {
            // KwKwK case: emit previous string + its first byte.
            if (code != next_code) return -EINVAL;
            stack[sp++] = first_byte;
            emit = prev;
        }
        while (emit >= 256) {
            if (sp >= kMaxCodes || emit >= next_code) return -EINVAL;
            stack[sp++] = suffix_tab[emit];
            emit = prefix_tab[emit];
        }
        first_byte = (uint8_t)emit;
        stack[sp++] = first_byte;
        if (di + sp > dst_cap) return -ENOSPC;
        while (sp > 0) dst[di++] = stack[--sp];

        if (next_code < kMaxCodes) {
            prefix_tab[next_code] = (int16_t)prev;
            suffix_tab[next_code] = first_byte;
            ++next_code;
            // TIFF early change: widen one code before the table fills.
            if (next_code == (1 << width) - 1 && width < 12) ++width;
        }
        prev = code;
    }
}

}  // extern "C"
