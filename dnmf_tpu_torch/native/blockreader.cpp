// Threaded prefetching block reader for host-streamed recordings.
//
// The port's streaming sources (dnmf_tpu_torch/data/streaming.py) feed
// frame blocks host -> device; at whole-brain scale a block is tens of MB,
// and a NumPy read + clamp + copy runs single-threaded on the host thread
// that also drives the card.  This reader moves that work into native
// threads and overlaps the NEXT block's disk read + clamp with the
// device's compute on the current one (double buffering).  It is this
// package's own copy of the JAX package's reader; the C ABI is the same.
//
// C ABI (ctypes-friendly), raw little-endian float32 [T, P] files:
//   br_open(path, num_frames, frame_floats, num_threads) -> handle
//   br_read(handle, start, stop, out)      synchronous threaded read
//   br_prefetch(handle, start, stop)       async read into a back buffer
//   br_wait(handle, out, capacity)         join prefetch, copy result
//   br_wait_range(handle, start, stop, out, capacity)
//   br_close(handle)
//
// Values are clamped to >= 0 during the copy (the NMF non-negativity
// clamp of the demixing reads).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#if defined(_WIN32)
#error "POSIX only"
#endif

#include <fcntl.h>
#include <unistd.h>

namespace {

struct BrHandle {
  int fd = -1;
  int64_t num_frames = 0;
  int64_t frame_floats = 0;
  int num_threads = 1;

  // Prefetch state (one in-flight request).
  std::thread worker;
  std::vector<float> back_buffer;
  int64_t pf_start = -1;
  int64_t pf_stop = -1;
  std::atomic<int> pf_status{0};  // 0 idle, 1 running/done-pending
  int pf_result = 0;

  ~BrHandle() {
    if (worker.joinable()) worker.join();
    if (fd >= 0) close(fd);
  }
};

// Read frames [start, stop) into out, clamping negatives, splitting the
// float range across threads.  Returns 0 on success.
int read_clamped(BrHandle* h, int64_t start, int64_t stop, float* out) {
  if (start < 0 || stop > h->num_frames || stop < start) return 1;
  const int64_t total = (stop - start) * h->frame_floats;
  if (total == 0) return 0;
  const int64_t base = start * h->frame_floats * (int64_t)sizeof(float);
  int nthreads = h->num_threads;
  if ((int64_t)nthreads > total) nthreads = 1;

  std::atomic<int> err{0};
  auto run = [&](int64_t lo, int64_t hi) {
    int64_t off = base + lo * (int64_t)sizeof(float);
    int64_t want = (hi - lo) * (int64_t)sizeof(float);
    char* dst = reinterpret_cast<char*>(out + lo);
    while (want > 0) {
      ssize_t got = pread(h->fd, dst, (size_t)want, (off_t)off);
      if (got <= 0) {
        err.store(2);
        return;
      }
      want -= got;
      off += got;
      dst += got;
    }
    float* p = out + lo;
    for (int64_t i = 0; i < hi - lo; ++i) {
      if (p[i] < 0.0f) p[i] = 0.0f;
    }
  };

  if (nthreads <= 1) {
    run(0, total);
  } else {
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    int64_t chunk = (total + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < total ? lo + chunk : total;
      if (lo >= hi) break;
      ts.emplace_back(run, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  return err.load();
}

}  // namespace

extern "C" {

BrHandle* br_open(const char* path, int64_t num_frames,
                  int64_t frame_floats, int num_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  auto* h = new BrHandle();
  h->fd = fd;
  h->num_frames = num_frames;
  h->frame_floats = frame_floats;
  h->num_threads = num_threads > 0 ? num_threads : 1;
  return h;
}

void br_close(BrHandle* h) { delete h; }

int br_read(BrHandle* h, int64_t start, int64_t stop, float* out) {
  if (!h) return 1;
  return read_clamped(h, start, stop, out);
}

int br_prefetch(BrHandle* h, int64_t start, int64_t stop) {
  if (!h || h->pf_status.load() != 0) return 1;
  if (start < 0 || stop > h->num_frames || stop < start) return 1;
  h->pf_start = start;
  h->pf_stop = stop;
  h->back_buffer.resize((size_t)((stop - start) * h->frame_floats));
  h->pf_status.store(1);
  h->worker = std::thread([h] {
    h->pf_result =
        read_clamped(h, h->pf_start, h->pf_stop, h->back_buffer.data());
  });
  return 0;
}

// Join the in-flight prefetch and copy it out.  Returns the number of
// floats written, or -1 on error / no prefetch / insufficient capacity.
int64_t br_wait(BrHandle* h, float* out, int64_t capacity_floats) {
  if (!h || h->pf_status.load() == 0) return -1;
  h->worker.join();
  h->pf_status.store(0);
  if (h->pf_result != 0) return -1;
  int64_t n = (h->pf_stop - h->pf_start) * h->frame_floats;
  if (n > capacity_floats) return -1;
  std::memcpy(out, h->back_buffer.data(), (size_t)n * sizeof(float));
  return n;
}

// Range-checked wait: additionally verifies that (start, stop) is the
// frame range the in-flight prefetch was issued for, so a caller cannot
// silently receive a different (same-size) block.  Returns -2 on range
// mismatch, otherwise as br_wait.
int64_t br_wait_range(BrHandle* h, int64_t start, int64_t stop, float* out,
                      int64_t capacity_floats) {
  if (!h || h->pf_status.load() == 0) return -1;
  if (start != h->pf_start || stop != h->pf_stop) return -2;
  return br_wait(h, out, capacity_floats);
}

}  // extern "C"
