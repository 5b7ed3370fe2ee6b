// Native batch-assembly kernels for the input pipeline (the port's copy of
// vaw_tpu/runtime/batch_ops.cpp; the two sources are the same code).
//
// The reference keeps the GPU fed with 16 torch DataLoader workers doing
// per-item python transforms (reference: main.py:171-177,
// datasets/data_loader.py). The port assembles whole batches on the host;
// this library is the hot inner loop of that assembly: a single
// multithreaded pass that gathers rows by index, optionally mirrors them,
// and converts uint8 -> f32 in [-1, 1], replacing three numpy passes
// (fancy-index copy, where-flip, normalize) with one. It runs in its own
// C++ threads, outside Python's interpreter lock.
//
// Built with g++ at first use and bound with ctypes: see runtime/native.py.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void gather_rows(const uint8_t* images, const int64_t* idx,
                 const uint8_t* flips, float* out, int64_t start,
                 int64_t end, int64_t h, int64_t w, int64_t c) {
  const int64_t img_elems = h * w * c;
  for (int64_t b = start; b < end; ++b) {
    const uint8_t* src = images + idx[b] * img_elems;
    float* dst = out + b * img_elems;
    if (flips != nullptr && flips[b]) {
      // horizontal mirror: reverse the w axis
      for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = src + y * w * c;
        float* orow = dst + y * w * c;
        for (int64_t x = 0; x < w; ++x) {
          const uint8_t* px = row + (w - 1 - x) * c;
          float* opx = orow + x * c;
          for (int64_t ch = 0; ch < c; ++ch) {
            opx[ch] = static_cast<float>(px[ch]) / 127.5f - 1.0f;
          }
        }
      }
    } else {
      for (int64_t i = 0; i < img_elems; ++i) {
        dst[i] = static_cast<float>(src[i]) / 127.5f - 1.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// images: [N, h, w, c] uint8 contiguous; idx: [batch] int64; flips: [batch]
// uint8 (nullable); out: [batch, h, w, c] float32.
void vaw_gather_normalize(const uint8_t* images, const int64_t* idx,
                          const uint8_t* flips, float* out, int64_t batch,
                          int64_t h, int64_t w, int64_t c,
                          int64_t num_threads) {
  if (num_threads <= 1 || batch < 4) {
    gather_rows(images, idx, flips, out, 0, batch, h, w, c);
    return;
  }
  int64_t n_threads = std::min<int64_t>(num_threads, batch);
  std::vector<std::thread> threads;
  int64_t chunk = (batch + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t start = t * chunk;
    int64_t end = std::min(start + chunk, batch);
    if (start >= end) break;
    threads.emplace_back(gather_rows, images, idx, flips, out, start, end,
                         h, w, c);
  }
  for (auto& th : threads) th.join();
}

// In-place-style uint8 -> f32 [-1, 1] conversion (no gather/flip).
void vaw_normalize_u8(const uint8_t* src, float* dst, int64_t n,
                      int64_t num_threads) {
  auto work = [&](int64_t start, int64_t end) {
    for (int64_t i = start; i < end; ++i) {
      dst[i] = static_cast<float>(src[i]) / 127.5f - 1.0f;
    }
  };
  if (num_threads <= 1 || n < (1 << 16)) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    int64_t start = t * chunk;
    int64_t end = std::min(start + chunk, n);
    if (start >= end) break;
    threads.emplace_back(work, start, end);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
