// Native block IO runtime: double-buffered producer thread + bounded ring.
//
// Equivalent of the reference's producer half (src/main.c:58-98):
// where the reference pairs one pthread with a depth-1 semaphore ping-pong
// buffer, this runtime keeps a reader thread filling a depth-N ring of
// page-aligned block buffers so host NVMe/pipe reads overlap both the
// Python dispatch and device compute.  Exposed as a tiny C ABI consumed via
// ctypes (no pybind11 in this environment); the Python BlockReader is the
// portable fallback.
//
// Tail semantics mirror runtime/stream.py:
//   * full blocks are produced verbatim;
//   * a final partial read either terminates the stream (tail_pad=0 — the
//     reference's drop-via-race behavior) or is overlaid on a copy of the
//     previous block (tail_pad=1 — the reference's buffer-reuse layout,
//     src/main.c:88 overwriting bufSize on the shared buffer).
//
// Build: g++ -O2 -shared -fPIC -pthread -o libblockio.so blockio.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <poll.h>
#include <unistd.h>

namespace {

struct Ring {
    size_t block_size = 0;
    int depth = 0;
    bool tail_pad = false;

    int fd = -1;
    bool own_fd = false;

    std::vector<uint8_t*> slots;    // depth page-aligned buffers
    std::vector<size_t> lens;       // filled length per slot
    int head = 0, tail = 0, count = 0;
    bool eof = false;
    int error = 0;                  // errno-style

    std::mutex mu;
    std::condition_variable not_full, not_empty;
    std::thread reader;
    std::atomic<bool> closing{false};

    uint8_t* prev = nullptr;        // last full block (tail_pad overlay)
};

// Fill `local` with up to bs bytes.  Uses poll() with a 100 ms tick so the
// closing flag is honored even when the source is an idle pipe/FIFO — a
// blocking fread here would make bio_close join() hang forever.  Returns
// bytes read; *err is set to -2 on a read error (mirroring the reference's
// ferror exit code, src/main.c:78-87), including errors after a partial
// read — those must NOT masquerade as a clean EOF.
size_t read_block(Ring* r, uint8_t* dst, size_t bs, int* err) {
    size_t got = 0;
    while (got < bs) {
        if (r->closing.load(std::memory_order_relaxed)) return got;
        struct pollfd pfd = {r->fd, POLLIN, 0};
        int pr = poll(&pfd, 1, 100);
        if (pr < 0) {
            if (errno == EINTR) continue;
            *err = -2;
            return got;
        }
        if (pr == 0) continue;  // tick: re-check closing
        ssize_t n = read(r->fd, dst + got, bs - got);
        if (n < 0) {
            if (errno == EINTR || errno == EAGAIN) continue;
            *err = -2;
            return got;
        }
        if (n == 0) return got;  // EOF
        got += static_cast<size_t>(n);
    }
    return got;
}

void reader_main(Ring* r) {
    size_t bs = r->block_size;
    std::vector<uint8_t> local(bs);
    for (;;) {
        if (r->closing.load(std::memory_order_relaxed)) break;
        int err = 0;
        size_t got = read_block(r, local.data(), bs, &err);
        if (err != 0 || got == 0) {
            std::lock_guard<std::mutex> lk(r->mu);
            r->error = err;
            r->eof = true;
            r->not_empty.notify_all();
            break;
        }
        bool partial = got < bs;
        if (partial && !r->tail_pad) {
            std::lock_guard<std::mutex> lk(r->mu);
            r->eof = true;              // drop partial tail
            r->not_empty.notify_all();
            break;
        }
        std::unique_lock<std::mutex> lk(r->mu);
        r->not_full.wait(lk, [r] {
            return r->count < r->depth || r->closing.load();
        });
        if (r->closing.load()) break;
        uint8_t* slot = r->slots[r->head];
        if (partial) {                   // overlay on previous block bytes
            memcpy(slot, r->prev, bs);
            memcpy(slot, local.data(), got);
        } else {
            memcpy(slot, local.data(), bs);
            memcpy(r->prev, local.data(), bs);
        }
        r->lens[r->head] = bs;
        r->head = (r->head + 1) % r->depth;
        r->count++;
        r->not_empty.notify_one();
        if (partial) {
            r->eof = true;
            r->not_empty.notify_all();
            break;
        }
    }
}

}  // namespace

extern "C" {

// offset: initial byte position.  Seekable inputs lseek; pipes/FIFOs
// (including stdin) consume and discard — resumable captures from a live
// stream, which the Python reader cannot offer (sys.stdin.buffer may
// over-read into its userspace buffer).
void* bio_open(const char* path, size_t block_size, int depth, int tail_pad,
               long offset) {
    if (block_size == 0 || depth < 1 || offset < 0) return nullptr;
    Ring* r = new (std::nothrow) Ring();
    if (!r) return nullptr;
    r->block_size = block_size;
    r->depth = depth;
    r->tail_pad = tail_pad != 0;
    if (strcmp(path, "-") == 0) {
        r->fd = 0;
    } else {
        r->fd = open(path, O_RDONLY);
        r->own_fd = true;
    }
    if (r->fd < 0) { delete r; return nullptr; }
    if (offset > 0 && lseek(r->fd, offset, SEEK_SET) < 0) {
        std::vector<uint8_t> scratch(1 << 20);
        long left = offset;
        while (left > 0) {
            size_t want = left < (long)scratch.size()
                              ? (size_t)left : scratch.size();
            ssize_t n = read(r->fd, scratch.data(), want);
            if (n < 0 && (errno == EINTR || errno == EAGAIN)) continue;
            if (n <= 0) break;  // EOF/error before the offset
            left -= n;
        }
        if (left > 0) {
            if (r->own_fd) close(r->fd);
            delete r;
            return nullptr;
        }
    }
    r->slots.assign(depth, nullptr);
    r->lens.assign(depth, 0);
    bool ok = true;
    for (int i = 0; i < depth && ok; i++) {
        void* p = nullptr;
        ok = posix_memalign(&p, 4096, block_size) == 0;
        r->slots[i] = ok ? static_cast<uint8_t*>(p) : nullptr;
    }
    r->prev = ok ? static_cast<uint8_t*>(calloc(1, block_size)) : nullptr;
    if (!r->prev) {
        for (auto* p : r->slots) free(p);
        if (r->own_fd) close(r->fd);
        delete r;
        return nullptr;
    }
    r->reader = std::thread(reader_main, r);
    return r;
}

// Copy the next block into out.  Returns block_size, 0 on clean EOF,
// negative on IO error (-2 mirrors the reference's ferror exit code).
long bio_next(void* h, uint8_t* out) {
    Ring* r = static_cast<Ring*>(h);
    std::unique_lock<std::mutex> lk(r->mu);
    r->not_empty.wait(lk, [r] { return r->count > 0 || r->eof; });
    if (r->count == 0) return r->error ? r->error : 0;  // error beats EOF
    uint8_t* slot = r->slots[r->tail];
    size_t len = r->lens[r->tail];
    memcpy(out, slot, len);
    r->tail = (r->tail + 1) % r->depth;
    r->count--;
    r->not_full.notify_one();
    return static_cast<long>(len);
}

void bio_close(void* h) {
    Ring* r = static_cast<Ring*>(h);
    r->closing.store(true);
    {
        std::lock_guard<std::mutex> lk(r->mu);
        r->not_full.notify_all();
        r->not_empty.notify_all();
    }
    if (r->reader.joinable()) r->reader.join();  // bounded: poll ticks 100 ms
    for (auto* p : r->slots) free(p);
    free(r->prev);
    if (r->own_fd) close(r->fd);
    delete r;
}

}  // extern "C"
