// qtts_runtime — the native host runtime of the PyTorch port of Qwen3-TTS
// (the port's own copy of the JAX package's csrc/qtts_runtime.cpp, the same
// functions and C ABI): zero-copy SafeTensors mapping, parallel page
// prefetch for cold checkpoint loads, bf16<->f32 conversion, and atomic
// 16-bit PCM WAV writes. Consumed via ctypes
// (qwen_tts_tpu_torch/io/native.py), which builds it with g++ at first use
// into build/host/; the port's pure-Python reader and writer stay the
// default.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// SafeTensors mapping
// ---------------------------------------------------------------------------

struct QttsMap {
    int fd = -1;
    uint8_t* data = nullptr;
    size_t size = 0;
    uint64_t header_len = 0;
};

// Open and mmap a .safetensors file. Returns an opaque handle (nullptr on
// error). The 8-byte little-endian header length is validated against the
// file size; JSON parsing of the header stays in Python (it is cold-path and
// Python's json is battle-tested) — the hot path here is mapping + prefetch.
QttsMap* qtts_open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 8) {
        ::close(fd);
        return nullptr;
    }
    void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    if (p == MAP_FAILED) {
        ::close(fd);
        return nullptr;
    }
    auto* m = new QttsMap();
    m->fd = fd;
    m->data = (uint8_t*)p;
    m->size = (size_t)st.st_size;
    uint64_t hlen;
    memcpy(&hlen, m->data, 8);
    if (hlen + 8 > m->size) {
        munmap(p, m->size);
        ::close(fd);
        delete m;
        return nullptr;
    }
    m->header_len = hlen;
    return m;
}

const uint8_t* qtts_data(QttsMap* m) { return m ? m->data : nullptr; }
uint64_t qtts_size(QttsMap* m) { return m ? (uint64_t)m->size : 0; }
uint64_t qtts_header_len(QttsMap* m) { return m ? m->header_len : 0; }

void qtts_close(QttsMap* m) {
    if (!m) return;
    if (m->data) munmap(m->data, m->size);
    if (m->fd >= 0) ::close(m->fd);
    delete m;
}

// Parallel page-touch prefetch: advise the kernel and fault pages in with N
// threads so a cold multi-GB checkpoint streams from disk at full bandwidth
// before the loader starts reading it (the reference relies on lazy
// faulting, which serializes I/O behind the copy loop).
void qtts_prefetch(QttsMap* m, int n_threads) {
    if (!m || !m->data) return;
#ifdef MADV_WILLNEED
    madvise(m->data, m->size, MADV_WILLNEED);
#endif
    if (n_threads < 1) n_threads = 1;
    size_t chunk = (m->size + n_threads - 1) / n_threads;
    std::vector<std::thread> threads;
    std::atomic<uint64_t> sink{0};
    for (int t = 0; t < n_threads; ++t) {
        size_t begin = t * chunk;
        size_t end = begin + chunk < m->size ? begin + chunk : m->size;
        if (begin >= end) break;
        threads.emplace_back([&, begin, end]() {
            uint64_t acc = 0;
            const size_t page = 4096;
            for (size_t i = begin; i < end; i += page) acc += m->data[i];
            sink += acc;
        });
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// bf16 <-> f32 (multithreaded)
// ---------------------------------------------------------------------------

void qtts_bf16_to_f32(const uint16_t* src, float* dst, uint64_t n,
                      int n_threads) {
    if (n_threads < 1) n_threads = 1;
    auto work = [&](uint64_t begin, uint64_t end) {
        for (uint64_t i = begin; i < end; ++i) {
            uint32_t bits = ((uint32_t)src[i]) << 16;
            memcpy(&dst[i], &bits, 4);
        }
    };
    if (n_threads == 1 || n < (1u << 20)) {
        work(0, n);
        return;
    }
    std::vector<std::thread> threads;
    uint64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        uint64_t begin = (uint64_t)t * chunk;
        uint64_t end = begin + chunk < n ? begin + chunk : n;
        if (begin >= end) break;
        threads.emplace_back(work, begin, end);
    }
    for (auto& th : threads) th.join();
}

// Round-to-nearest-even f32 -> bf16 (checkpoint writing / quantized export).
void qtts_f32_to_bf16(const float* src, uint16_t* dst, uint64_t n) {
    for (uint64_t i = 0; i < n; ++i) {
        uint32_t bits;
        memcpy(&bits, &src[i], 4);
        uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
        dst[i] = (uint16_t)((bits + rounding) >> 16);
    }
}

// ---------------------------------------------------------------------------
// WAV writer (atomic tmp+rename, 16-bit PCM mono)
// ---------------------------------------------------------------------------

static void put_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
static void put_u16(uint8_t* p, uint16_t v) { memcpy(p, &v, 2); }

int qtts_write_wav(const char* path, const float* samples, int64_t n_samples,
                   int sample_rate) {
    std::string tmp = std::string(path) + ".tmp";
    FILE* f = fopen(tmp.c_str(), "wb");
    if (!f) return -1;

    uint32_t data_bytes = (uint32_t)(n_samples * 2);
    uint8_t header[44];
    memcpy(header, "RIFF", 4);
    put_u32(header + 4, 36 + data_bytes);
    memcpy(header + 8, "WAVE", 4);
    memcpy(header + 12, "fmt ", 4);
    put_u32(header + 16, 16);
    put_u16(header + 20, 1);                     // PCM
    put_u16(header + 22, 1);                     // mono
    put_u32(header + 24, (uint32_t)sample_rate);
    put_u32(header + 28, (uint32_t)sample_rate * 2);
    put_u16(header + 32, 2);                     // block align
    put_u16(header + 34, 16);                    // bits per sample
    memcpy(header + 36, "data", 4);
    put_u32(header + 40, data_bytes);
    if (fwrite(header, 1, 44, f) != 44) {
        fclose(f);
        unlink(tmp.c_str());
        return -2;
    }

    const int64_t CHUNK = 1 << 16;
    std::vector<int16_t> buf(CHUNK);
    for (int64_t off = 0; off < n_samples; off += CHUNK) {
        int64_t n = n_samples - off < CHUNK ? n_samples - off : CHUNK;
        for (int64_t i = 0; i < n; ++i) {
            float x = samples[off + i];
            if (x > 1.0f) x = 1.0f;
            if (x < -1.0f) x = -1.0f;
            float scaled = x * 32767.0f;
            buf[i] = (int16_t)(scaled >= 0 ? scaled + 0.5f : scaled - 0.5f);
        }
        if (fwrite(buf.data(), 2, (size_t)n, f) != (size_t)n) {
            fclose(f);
            unlink(tmp.c_str());
            return -2;
        }
    }
    if (fflush(f) != 0 || fsync(fileno(f)) != 0) {
        fclose(f);
        unlink(tmp.c_str());
        return -3;
    }
    fclose(f);
    if (rename(tmp.c_str(), path) != 0) {
        unlink(tmp.c_str());
        return -4;
    }
    return 0;
}

}  // extern "C"
