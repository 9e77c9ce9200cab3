// ClipStore: memory-mapped contiguous EEG clip storage with a
// multithreaded batch gather.
//
// The framework's input hot path at pod scale is assembling random-index
// batches of fixed-size clips. HDF5 per-sample reads serialize on the GIL
// and on library locks; this store is one flat mmap'd float32 tensor
// [num_clips, channels, samples] plus an 64-byte header, and the batch
// gather is a C++ memcpy fan-out across threads — it runs at memory
// bandwidth and releases the GIL entirely (called via ctypes).
//
// File layout (little endian):
//   0x00  char[4]  magic "ECS1"
//   0x08  int64    num_clips
//   0x10  int64    channels
//   0x18  int64    samples (per clip per channel)
//   0x20  int64    dtype code (1 = float32)
//   0x28  padding to 64 bytes
//   0x40  float32 data, C-contiguous [num_clips, channels, samples]
//
// Build: g++ -O3 -shared -fPIC -pthread -o libclipstore.so clipstore.cpp

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Store {
    int fd = -1;
    void* map = nullptr;
    size_t map_bytes = 0;
    int64_t num_clips = 0;
    int64_t channels = 0;
    int64_t samples = 0;
    const float* data = nullptr;
};

constexpr int64_t kHeaderBytes = 64;
constexpr char kMagic[4] = {'E', 'C', 'S', '1'};

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or nullptr on failure.
void* ecs_open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < kHeaderBytes) {
        ::close(fd);
        return nullptr;
    }
    void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    if (map == MAP_FAILED) {
        ::close(fd);
        return nullptr;
    }
    const char* bytes = static_cast<const char*>(map);
    if (memcmp(bytes, kMagic, 4) != 0) {
        munmap(map, st.st_size);
        ::close(fd);
        return nullptr;
    }
    auto* s = new Store();
    s->fd = fd;
    s->map = map;
    s->map_bytes = st.st_size;
    memcpy(&s->num_clips, bytes + 0x08, 8);
    memcpy(&s->channels, bytes + 0x10, 8);
    memcpy(&s->samples, bytes + 0x18, 8);
    s->data = reinterpret_cast<const float*>(bytes + kHeaderBytes);
    const size_t want =
        kHeaderBytes +
        sizeof(float) * size_t(s->num_clips) * s->channels * s->samples;
    if (want > size_t(st.st_size)) {  // truncated file
        munmap(map, st.st_size);
        ::close(fd);
        delete s;
        return nullptr;
    }
    return s;
}

void ecs_info(void* handle, int64_t* num_clips, int64_t* channels,
              int64_t* samples) {
    auto* s = static_cast<Store*>(handle);
    *num_clips = s->num_clips;
    *channels = s->channels;
    *samples = s->samples;
}

// Gather `count` clips by index into `out` (count, channels, samples),
// fanned out over `num_threads` (0 -> hardware concurrency, capped at 8).
// Returns 0 on success, -1 on an out-of-range index.
int ecs_gather(void* handle, const int64_t* indices, int64_t count,
               float* out, int num_threads) {
    auto* s = static_cast<Store*>(handle);
    const size_t clip_elems = size_t(s->channels) * s->samples;
    for (int64_t i = 0; i < count; ++i) {
        if (indices[i] < 0 || indices[i] >= s->num_clips) return -1;
    }
    int workers = num_threads > 0 ? num_threads
                                  : int(std::thread::hardware_concurrency());
    if (workers < 1) workers = 1;
    if (workers > 8) workers = 8;
    if (int64_t(workers) > count) workers = int(count);

    auto copy_range = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            memcpy(out + size_t(i) * clip_elems,
                   s->data + size_t(indices[i]) * clip_elems,
                   clip_elems * sizeof(float));
        }
    };
    if (workers == 1) {
        copy_range(0, count);
        return 0;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (count + workers - 1) / workers;
    for (int w = 0; w < workers; ++w) {
        int64_t lo = w * chunk;
        int64_t hi = lo + chunk < count ? lo + chunk : count;
        if (lo >= hi) break;
        threads.emplace_back(copy_range, lo, hi);
    }
    for (auto& t : threads) t.join();
    return 0;
}

void ecs_close(void* handle) {
    auto* s = static_cast<Store*>(handle);
    if (s->map) munmap(s->map, s->map_bytes);
    if (s->fd >= 0) ::close(s->fd);
    delete s;
}

}  // extern "C"
