// Native prefetching image loader — the C++ data-loader role of the
// reference's ThreadedDataServer (src/dataserver/ThreadedDataServer.cpp:20-116):
// worker threads decode PNG frames ahead of the consumer into a bounded
// queue of grayscale uint8 buffers, so the pipeline never blocks on
// disk + decode.
//
// The decoder needs only zlib: it reads the same PNGs as the Python codec
// (eqvio_tpu/data/png.py) -- 8-bit, non-interlaced gray, gray+alpha, RGB and
// RGBA with any of the five row filters -- and gives the same pixels,
// colour converted with the same fixed-point ITU-R 601 weights.
//
// C API for ctypes (no pybind11 in this toolchain). Build: make -C native.

#if __has_include(<zlib.h>)
#include <zlib.h>
#else  // the runtime library without its headers: declare the one call used
extern "C" int uncompress(unsigned char* dest, unsigned long* dest_len,
                          const unsigned char* source, unsigned long source_len);
#endif

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
    int index = -1;
    int height = 0;
    int width = 0;
    std::vector<unsigned char> pixels;  // grayscale [h*w], 0..255
};

uint32_t be32(const unsigned char* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

bool read_file(const char* path, std::vector<unsigned char>& buf) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return false;
    std::fseek(fp, 0, SEEK_END);
    long size = std::ftell(fp);
    std::fseek(fp, 0, SEEK_SET);
    bool ok = size > 0;
    if (ok) {
        buf.resize(static_cast<size_t>(size));
        ok = std::fread(buf.data(), 1, buf.size(), fp) == buf.size();
    }
    std::fclose(fp);
    return ok;
}

int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

// Undo the per-row filters of `raw` (rows of 1 + stride bytes) into `px`.
bool unfilter(const unsigned char* raw, size_t height, size_t stride, size_t bpp,
              unsigned char* px) {
    std::vector<unsigned char> zeros(stride, 0);
    const unsigned char* prev = zeros.data();
    for (size_t y = 0; y < height; ++y) {
        const unsigned char* line = raw + y * (stride + 1);
        const unsigned char kind = *line++;
        unsigned char* cur = px + y * stride;
        switch (kind) {
            case 0:
                std::memcpy(cur, line, stride);
                break;
            case 1:  // Sub
                for (size_t i = 0; i < stride; ++i)
                    cur[i] = line[i] + (i >= bpp ? cur[i - bpp] : 0);
                break;
            case 2:  // Up
                for (size_t i = 0; i < stride; ++i) cur[i] = line[i] + prev[i];
                break;
            case 3:  // Average
                for (size_t i = 0; i < stride; ++i)
                    cur[i] = line[i] + (((i >= bpp ? cur[i - bpp] : 0) + prev[i]) >> 1);
                break;
            case 4:  // Paeth
                for (size_t i = 0; i < stride; ++i)
                    cur[i] = line[i] + paeth(i >= bpp ? cur[i - bpp] : 0, prev[i],
                                             i >= bpp ? prev[i - bpp] : 0);
                break;
            default:
                return false;
        }
        prev = cur;
    }
    return true;
}

bool decode_png_gray(const char* path, Frame& out) {
    static const unsigned char kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    std::vector<unsigned char> file;
    if (!read_file(path, file) || file.size() < 8 ||
        std::memcmp(file.data(), kSignature, 8) != 0)
        return false;
    uint32_t w = 0, h = 0;
    int depth = 0, ctype = -1, interlace = 0;
    std::vector<unsigned char> idat;
    for (size_t pos = 8; pos + 8 <= file.size();) {
        const uint32_t len = be32(&file[pos]);
        const unsigned char* kind = &file[pos + 4];
        const unsigned char* body = &file[pos + 8];
        if (len > file.size() - pos - 8) return false;  // truncated chunk
        if (std::memcmp(kind, "IHDR", 4) == 0) {
            if (len < 13) return false;
            w = be32(body);
            h = be32(body + 4);
            depth = body[8];
            ctype = body[9];
            interlace = body[12];
        } else if (std::memcmp(kind, "IDAT", 4) == 0) {
            idat.insert(idat.end(), body, body + len);
        } else if (std::memcmp(kind, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + static_cast<size_t>(len);
    }
    const int ch = ctype == 0 ? 1 : ctype == 2 ? 3 : ctype == 4 ? 2 : ctype == 6 ? 4 : 0;
    if (depth != 8 || ch == 0 || interlace != 0 || w == 0 || h == 0) return false;

    const size_t stride = static_cast<size_t>(w) * ch;
    std::vector<unsigned char> raw(static_cast<size_t>(h) * (stride + 1));
    unsigned long raw_len = raw.size();
    if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != 0 ||
        raw_len != raw.size())
        return false;
    std::vector<unsigned char> px(static_cast<size_t>(h) * stride);
    if (!unfilter(raw.data(), h, stride, ch, px.data())) return false;

    const size_t n = static_cast<size_t>(w) * h;
    out.height = static_cast<int>(h);
    out.width = static_cast<int>(w);
    out.pixels.resize(n);
    for (size_t i = 0; i < n; ++i) {
        const unsigned char* p = &px[i * ch];
        out.pixels[i] = ch <= 2 ? p[0]
                                : static_cast<unsigned char>(
                                      (p[0] * 19595u + p[1] * 38470u + p[2] * 7471u + 0x8000u) >> 16);
    }
    return true;
}

// Decode POOL with in-order delivery: N workers claim path indices from a
// shared cursor, decode concurrently, and insert into a reorder buffer the
// consumer drains strictly in order.  Outstanding frames are bounded by
// queue_cap so memory stays flat.  The workers overlap PNG decode with the
// Python thread's waits on the device (the GIL is released there).
struct Loader {
    std::vector<std::string> paths;
    size_t queue_cap;
    std::deque<std::unique_ptr<Frame>> ready;  // reorder buffer (sparse, by index)
    size_t next_claim = 0;   // next path index a worker will take
    size_t next_out = 0;     // next index the consumer needs
    std::mutex mutex;
    std::condition_variable cv_push;
    std::condition_variable cv_pop;
    std::vector<std::thread> workers;
    std::atomic<bool> stop{false};
    int active = 0;

    Loader(std::vector<std::string> p, size_t cap, int nworkers)
        : paths(std::move(p)), queue_cap(cap < 2 ? 2 : cap) {
        ready.resize(paths.size());
        if (nworkers < 1) nworkers = 1;
        active = nworkers;
        for (int k = 0; k < nworkers; ++k) {
            workers.emplace_back([this] { run(); });
        }
    }

    ~Loader() {
        stop = true;
        cv_push.notify_all();
        cv_pop.notify_all();
        for (auto& w : workers)
            if (w.joinable()) w.join();
    }

    void run() {
        for (;;) {
            size_t i;
            {
                std::unique_lock<std::mutex> lock(mutex);
                cv_push.wait(lock, [this] {
                    return stop || next_claim >= paths.size() ||
                           next_claim < next_out + queue_cap;
                });
                if (stop || next_claim >= paths.size()) break;
                i = next_claim++;
            }
            auto frame = std::make_unique<Frame>();
            frame->index = static_cast<int>(i);
            if (!decode_png_gray(paths[i].c_str(), *frame)) {
                frame->height = frame->width = 0;  // decode failure marker
            }
            std::lock_guard<std::mutex> lock(mutex);
            ready[i] = std::move(frame);
            cv_pop.notify_all();
        }
        std::lock_guard<std::mutex> lock(mutex);
        if (--active == 0) cv_pop.notify_all();
    }

    template <typename CopyFn>
    int next_impl(int capacity, int* h, int* w, CopyFn copy) {
        std::unique_lock<std::mutex> lock(mutex);
        // every claimed index is eventually produced (workers only exit after
        // inserting), so waiting on ready[next_out] cannot deadlock
        cv_pop.wait(lock, [this] {
            return stop || next_out >= paths.size() || ready[next_out] != nullptr;
        });
        if (next_out >= paths.size() || !ready[next_out]) return -1;
        Frame& f = *ready[next_out];
        *h = f.height;
        *w = f.width;
        if (f.height * f.width > capacity) return -2;
        copy(f);
        int idx = f.index;
        ready[next_out].reset();
        ++next_out;
        cv_push.notify_all();
        return idx;
    }

    // Returns index, fills out if capacity sufficient; -1 when exhausted,
    // -2 if the provided buffer is too small (frame stays queued).
    int next_u8(unsigned char* out, int capacity, int* h, int* w) {
        return next_impl(capacity, h, w, [&](Frame& f) {
            std::memcpy(out, f.pixels.data(), f.pixels.size());
        });
    }

    int next(float* out, int capacity, int* h, int* w) {
        return next_impl(capacity, h, w, [&](Frame& f) {
            const float inv = 1.0f / 255.0f;
            for (size_t i = 0; i < f.pixels.size(); ++i) out[i] = f.pixels[i] * inv;
        });
    }
};

}  // namespace

extern "C" {

void* il_create(const char** paths, int n, int queue_size) {
    std::vector<std::string> p(paths, paths + n);
    return new Loader(std::move(p), static_cast<size_t>(queue_size), 2);
}

void* il_create2(const char** paths, int n, int queue_size, int workers) {
    std::vector<std::string> p(paths, paths + n);
    return new Loader(std::move(p), static_cast<size_t>(queue_size), workers);
}

int il_next(void* handle, float* out, int capacity, int* h, int* w) {
    return static_cast<Loader*>(handle)->next(out, capacity, h, w);
}

int il_next_u8(void* handle, unsigned char* out, int capacity, int* h, int* w) {
    return static_cast<Loader*>(handle)->next_u8(out, capacity, h, w);
}

void il_destroy(void* handle) { delete static_cast<Loader*>(handle); }
}
