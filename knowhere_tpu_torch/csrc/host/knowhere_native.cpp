// knowhere_tpu_torch native runtime: host-side codecs and IO (a copy of the
// JAX package's native/knowhere_native.cpp, so the port builds its own).
//
// The reference's native runtime pieces that do not belong on the GPU:
//  - sparse posting-list compression (reference: src/index/sparse/codec/):
//    LEB128 varint for doc-id deltas and fixed-width bitpacking;
//  - aligned file reads (reference: thirdparty/DiskANN
//    linux_aligned_file_reader.cpp): pread-based gather of rows into a
//    caller buffer;
//  - popcount of packed binary signatures.
//
// Exposed with a plain C ABI and loaded with ctypes (knowhere_tpu_torch/
// native.py builds it with g++ at first use). All functions are thread-safe
// and allocation-free.

#include <cstdint>
#include <cstring>
#include <cstdio>

#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// varint (LEB128) encode/decode for u32 streams (delta-coded posting lists)
// ---------------------------------------------------------------------------

// Returns number of bytes written; out must hold >= 5*n bytes.
int64_t kn_varint_encode(const uint32_t* in, int64_t n, uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t v = in[i];
        while (v >= 0x80) {
            *p++ = static_cast<uint8_t>(v) | 0x80;
            v >>= 7;
        }
        *p++ = static_cast<uint8_t>(v);
    }
    return p - out;
}

// Returns number of bytes consumed, or -1 on truncated input.
int64_t kn_varint_decode(const uint8_t* in, int64_t n_bytes, uint32_t* out, int64_t n) {
    const uint8_t* p = in;
    const uint8_t* end = in + n_bytes;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t v = 0;
        int shift = 0;
        while (true) {
            if (p >= end) return -1;
            uint8_t b = *p++;
            v |= static_cast<uint32_t>(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
            if (shift > 28 + 7) return -1;
        }
        out[i] = v;
    }
    return p - in;
}

// delta encode/decode (posting doc ids are strictly increasing)
void kn_delta_encode(const uint32_t* in, int64_t n, uint32_t* out) {
    uint32_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = in[i] - prev;
        prev = in[i];
    }
}

void kn_delta_decode(const uint32_t* in, int64_t n, uint32_t* out) {
    uint32_t acc = 0;
    for (int64_t i = 0; i < n; ++i) {
        acc += in[i];
        out[i] = acc;
    }
}

// ---------------------------------------------------------------------------
// fixed-width bitpacking (simdcomp-style, scalar loop the compiler vectorizes)
// ---------------------------------------------------------------------------

// Pack n values of `bits` width each. Returns bytes written.
int64_t kn_bitpack_encode(const uint32_t* in, int64_t n, int bits, uint8_t* out) {
    if (bits <= 0 || bits > 32) return -1;
    std::memset(out, 0, (static_cast<int64_t>(n) * bits + 7) / 8);
    int64_t bitpos = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t v = in[i] & (bits == 32 ? 0xFFFFFFFFu : ((1u << bits) - 1));
        int64_t byte = bitpos >> 3;
        int off = static_cast<int>(bitpos & 7);
        uint64_t cur;
        std::memcpy(&cur, out + byte, sizeof(uint64_t));
        cur |= static_cast<uint64_t>(v) << off;
        std::memcpy(out + byte, &cur, sizeof(uint64_t));
        bitpos += bits;
    }
    return (static_cast<int64_t>(n) * bits + 7) / 8;
}

int64_t kn_bitpack_decode(const uint8_t* in, int64_t n, int bits, uint32_t* out) {
    if (bits <= 0 || bits > 32) return -1;
    const uint64_t mask = bits == 32 ? 0xFFFFFFFFull : ((1ull << bits) - 1);
    int64_t bitpos = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t byte = bitpos >> 3;
        int off = static_cast<int>(bitpos & 7);
        uint64_t cur;
        std::memcpy(&cur, in + byte, sizeof(uint64_t));
        out[i] = static_cast<uint32_t>((cur >> off) & mask);
        bitpos += bits;
    }
    return (static_cast<int64_t>(n) * bits + 7) / 8;
}

// max bit width needed for the values (0 -> 1)
int kn_max_bits(const uint32_t* in, int64_t n) {
    uint32_t m = 0;
    for (int64_t i = 0; i < n; ++i) m |= in[i];
    int bits = 0;
    while (m) { ++bits; m >>= 1; }
    return bits ? bits : 1;
}

// ---------------------------------------------------------------------------
// popcount
// ---------------------------------------------------------------------------

int64_t kn_popcount(const uint8_t* buf, int64_t n) {
    int64_t total = 0;
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t v;
        std::memcpy(&v, buf + i, 8);
        total += __builtin_popcountll(v);
    }
    for (; i < n; ++i) total += __builtin_popcount(buf[i]);
    return total;
}

// ---------------------------------------------------------------------------
// aligned gather reads (DiskANN-style row fetch feeding device rerank)
// ---------------------------------------------------------------------------

// Gather `n_rows` rows of `row_bytes` each from `path` at byte offsets
// base_offset + row_ids[i]*row_bytes into `out` (n_rows*row_bytes).
// Returns 0 on success, -1 on IO error.
int kn_gather_rows(const char* path, int64_t base_offset, int64_t row_bytes,
                   const int64_t* row_ids, int64_t n_rows, uint8_t* out) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return -1;
    int rc = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t off = base_offset + row_ids[i] * row_bytes;
        int64_t done = 0;
        while (done < row_bytes) {
            ssize_t r = ::pread(fd, out + i * row_bytes + done, row_bytes - done, off + done);
            if (r <= 0) { rc = -1; break; }
            done += r;
        }
        if (rc) break;
    }
    ::close(fd);
    return rc;
}

// Multi-threaded row gather (the reference's libaio cached_beam_search reader
// analog): N worker threads each pread a contiguous slice of the requested
// row list through their own fd. On page-cached files this is a parallel
// memcpy (memmap fancy-indexing is single-threaded, measured 2.3 GiB/s);
// on cold files the parallel preads overlap IO latency like io-depth>1 aio.
int kn_gather_rows_mt(const char* path, int64_t base_offset, int64_t row_bytes,
                      const int64_t* row_ids, int64_t n_rows, uint8_t* out,
                      int n_threads) {
    if (n_threads <= 1 || n_rows < 1024) {
        return kn_gather_rows(path, base_offset, row_bytes, row_ids, n_rows, out);
    }
    if (n_threads > 64) n_threads = 64;
    std::vector<int> rcs((size_t)n_threads, 0);
    std::vector<std::thread> workers;
    workers.reserve((size_t)n_threads);
    int64_t per = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t s0 = (int64_t)t * per;
        int64_t e0 = s0 + per < n_rows ? s0 + per : n_rows;
        if (s0 >= e0) break;
        workers.emplace_back([=, &rcs]() {
            int fd = ::open(path, O_RDONLY);
            if (fd < 0) { rcs[(size_t)t] = -1; return; }
            for (int64_t i = s0; i < e0; ++i) {
                int64_t off = base_offset + row_ids[i] * row_bytes;
                int64_t done = 0;
                while (done < row_bytes) {
                    ssize_t r = ::pread(fd, out + i * row_bytes + done,
                                        row_bytes - done, off + done);
                    if (r <= 0) { rcs[(size_t)t] = -1; break; }
                    done += r;
                }
                if (rcs[(size_t)t]) break;
            }
            ::close(fd);
        });
    }
    for (auto& w : workers) w.join();
    for (int rc : rcs) if (rc) return rc;
    return 0;
}

}  // extern "C"
