// Host-side batch staging of the port's host-streamed pretraining loader
// (data/pipeline.py::PrefetchLoader), the port's own copy of the JAX
// package's native/staging.cpp.
//
// Augmentation runs on the device, so the host only assembles uint8
// batches from the in-memory image store, fast enough to keep the card
// fed:
//
//   * staging_gather_u8:        parallel row gather (one memcpy a row)
//   * staging_gather_normalize: gather + (x/255 - mean[c]) * inv_std[c],
//                               HWC layout with `channels` trailing
//
// Host C++, not a CUDA kernel: built with g++ -O3 -shared -fPIC -lpthread
// into subspace_reg_tpu_torch/_build/ at first use (utils/cuda_build.py)
// and bound with ctypes (data/native.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run worker() on n_threads threads (inline for one thread or < 4 rows).
template <typename F>
void run_workers(F worker, int64_t n_idx, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n_idx < 4) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// dst[i] = src[indices[i]], rows of `item_bytes` bytes.
void staging_gather_u8(const uint8_t* src, const int64_t* indices,
                       uint8_t* dst, int64_t n_idx, int64_t item_bytes,
                       int n_threads) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_idx) break;
      std::memcpy(dst + i * item_bytes, src + indices[i] * item_bytes,
                  static_cast<size_t>(item_bytes));
    }
  };
  run_workers(worker, n_idx, n_threads);
}

// dst[i] = (src[indices[i]] / 255 - mean[c]) * inv_std[c], c the trailing
// channel of the HWC row.
void staging_gather_normalize(const uint8_t* src, const int64_t* indices,
                              float* dst, int64_t n_idx, int64_t item_elems,
                              const float* mean, const float* inv_std,
                              int channels, int n_threads) {
  std::atomic<int64_t> next(0);
  const float k = 1.0f / 255.0f;
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_idx) break;
      const uint8_t* s = src + indices[i] * item_elems;
      float* d = dst + i * item_elems;
      for (int64_t e = 0; e < item_elems; ++e) {
        int c = static_cast<int>(e % channels);
        d[e] = (static_cast<float>(s[e]) * k - mean[c]) * inv_std[c];
      }
    }
  };
  run_workers(worker, n_idx, n_threads);
}

}  // extern "C"
