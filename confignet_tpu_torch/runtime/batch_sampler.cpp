// Native batch assembly for the host-side data path.
//
// The reference's training loop gathers random rows from a uint8 memmap with
// numpy fancy indexing on every step (reference:
// confignet_first_stage.py:438-450); at production batch sizes that copy is
// a measurable slice of host time.  This library does the gather (and the
// optional horizontal flip fused into it) with raw memcpy/row reversal
// across a small thread pool, exposed through a plain C ABI for ctypes.
//
// Built at first use by native.py (g++ -O3 -march=native -shared -fPIC ... -lpthread)
// into confignet_tpu_torch/_build/, and loaded through ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void gather_rows_range(const uint8_t* src, int64_t row_bytes,
                       const int64_t* indices, uint8_t* dst,
                       int64_t begin, int64_t end) {
  for (int64_t i = begin; i < end; ++i) {
    std::memcpy(dst + i * row_bytes, src + indices[i] * row_bytes, row_bytes);
  }
}

void gather_flip_range(const uint8_t* src, int64_t height, int64_t width,
                       int64_t channels, const int64_t* indices,
                       const uint8_t* flip_flags, uint8_t* dst,
                       int64_t begin, int64_t end) {
  const int64_t row_bytes = width * channels;
  const int64_t img_bytes = height * row_bytes;
  for (int64_t i = begin; i < end; ++i) {
    const uint8_t* img = src + indices[i] * img_bytes;
    uint8_t* out = dst + i * img_bytes;
    if (!flip_flags || !flip_flags[i]) {
      std::memcpy(out, img, img_bytes);
      continue;
    }
    // horizontal flip: reverse pixel order within each row
    for (int64_t y = 0; y < height; ++y) {
      const uint8_t* in_row = img + y * row_bytes;
      uint8_t* out_row = out + y * row_bytes;
      for (int64_t x = 0; x < width; ++x) {
        std::memcpy(out_row + x * channels,
                    in_row + (width - 1 - x) * channels, channels);
      }
    }
  }
}

template <typename Fn>
void parallel_for(int64_t n, int n_threads, Fn&& fn) {
  if (n_threads <= 1 || n < 2 * n_threads) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t begin = t * chunk;
    const int64_t end = begin + chunk < n ? begin + chunk : n;
    if (begin >= end) break;
    threads.emplace_back([&fn, begin, end] { fn(begin, end); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Gather `batch` rows of `row_bytes` each from `src` at `indices` into `dst`.
void gather_rows(const uint8_t* src, int64_t row_bytes, const int64_t* indices,
                 int64_t batch, uint8_t* dst, int n_threads) {
  parallel_for(batch, n_threads, [&](int64_t b, int64_t e) {
    gather_rows_range(src, row_bytes, indices, dst, b, e);
  });
}

// Gather `batch` HxWxC uint8 images at `indices`, horizontally flipping image
// i when flip_flags[i] != 0 (flip_flags may be null).
void gather_images_with_flip(const uint8_t* src, int64_t height, int64_t width,
                             int64_t channels, const int64_t* indices,
                             const uint8_t* flip_flags, int64_t batch,
                             uint8_t* dst, int n_threads) {
  parallel_for(batch, n_threads, [&](int64_t b, int64_t e) {
    gather_flip_range(src, height, width, channels, indices, flip_flags, dst, b, e);
  });
}

}  // extern "C"
