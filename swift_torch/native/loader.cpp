// swift_torch native data-loader runtime (a copy of the JAX package's
// swift_tpu/native/loader.cpp, so that the port imports nothing of it).
//
// Reads samples from a packed dataset file (one mmap'ed float32 tensor of
// shape (N, H, W, C) after a 4 KiB header of magic and int64 dims, written by
// swift_torch/native/pack.py) and assembles standardized training batches
// with a C++ thread pool — the native equivalent of the reference's torch
// DataLoader worker processes (reference: src/swift/train.py:181-209),
// replacing per-sample h5py file opens with zero-copy mmap reads and fusing
// standardize + residual-target computation + collation off the GIL.
//
// C ABI (consumed via ctypes from swift_torch/native/__init__.py):
//   void* stl_open(const char* path, long* shape_out /*4*/);
//   void  stl_close(void* handle);
//   int   stl_batch(void* h, const long* idx, const long* tgt,
//                   const long* prev, long n,
//                   const float* x_mean, const float* x_std,
//                   const float* t_std, long n_vars, long n_chan,
//                   float* x_out, float* t_out, long n_threads);
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libswift_loader.so loader.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Pack {
  int fd = -1;
  const float* data = nullptr;  // (N, H, W, C)
  size_t bytes = 0;
  long n = 0, h = 0, w = 0, c = 0;
  size_t row() const { return (size_t)h * w * c; }
};

// header: first 4096 bytes contain "SWIFTPK1" + 4x int64 (n, h, w, c)
constexpr size_t kHeader = 4096;

void parallel_for(long n, long n_threads, const std::function<void(long)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (long i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<long> next(0);
  auto worker = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  std::vector<std::thread> pool;
  long t = std::min<long>(n_threads, n);
  pool.reserve(t);
  for (long i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void* stl_open(const char* path, long* shape_out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const char* base = static_cast<const char*>(map);
  if (std::memcmp(base, "SWIFTPK1", 8) != 0) {
    munmap(map, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* p = new Pack();
  p->fd = fd;
  p->bytes = st.st_size;
  const int64_t* dims = reinterpret_cast<const int64_t*>(base + 8);
  p->n = dims[0];
  p->h = dims[1];
  p->w = dims[2];
  p->c = dims[3];
  p->data = reinterpret_cast<const float*>(base + kHeader);
  if (shape_out) {
    shape_out[0] = p->n;
    shape_out[1] = p->h;
    shape_out[2] = p->w;
    shape_out[3] = p->c;
  }
  return p;
}

void stl_close(void* handle) {
  auto* p = static_cast<Pack*>(handle);
  if (!p) return;
  munmap(const_cast<void*>(static_cast<const void*>(
             reinterpret_cast<const char*>(p->data) - kHeader)),
         p->bytes);
  ::close(p->fd);
  delete p;
}

// Assemble a standardized residual-training batch:
//   x_out[i] = (pack[idx[i]] - x_mean) / x_std                (all channels)
//   t_out[i] = (pack[tgt[i]][:nv] - pack[prev[i]][:nv]) / t_std
// Shapes: x_out (n, H, W, C); t_out (n, H, W, n_vars).
int stl_batch(void* handle, const long* idx, const long* tgt, const long* prev,
              long n, const float* x_mean, const float* x_std,
              const float* t_std, long n_vars, long n_chan, float* x_out,
              float* t_out, long n_threads) {
  auto* p = static_cast<Pack*>(handle);
  if (!p || n_chan != p->c) return -1;
  const long hw = p->h * p->w;
  const size_t row = p->row();
  parallel_for(n, n_threads, [&](long i) {
    const float* xs = p->data + (size_t)idx[i] * row;
    const float* ts = p->data + (size_t)tgt[i] * row;
    const float* ps = p->data + (size_t)prev[i] * row;
    float* xo = x_out + (size_t)i * row;
    float* to = t_out + (size_t)i * hw * n_vars;
    for (long px = 0; px < hw; ++px) {
      const float* xr = xs + (size_t)px * p->c;
      float* xw = xo + (size_t)px * p->c;
      for (long ch = 0; ch < p->c; ++ch)
        xw[ch] = (xr[ch] - x_mean[ch]) / x_std[ch];
      const float* tr = ts + (size_t)px * p->c;
      const float* pr = ps + (size_t)px * p->c;
      float* tw = to + (size_t)px * n_vars;
      for (long ch = 0; ch < n_vars; ++ch)
        tw[ch] = (tr[ch] - pr[ch]) / t_std[ch];
    }
  });
  return 0;
}

}  // extern "C"
