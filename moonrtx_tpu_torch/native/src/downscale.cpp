// Native data-pipeline kernels for moonrtx_tpu_torch (host code, the same
// source as the JAX package's native/).
//
// block_mean_int16: multithreaded block-mean downscale of an int16 raster
// into float32 — the hot host-side preprocessing step. The reference spends
// ~1 minute in a numpy reshape-mean over the 7.9 GB LDEM source
// (reference data_loader.py:169-175, README note "~1 min"); this kernel
// streams the raster once with per-thread row bands.
//
// Build and binding: moonrtx_tpu_torch/native/bindings.py (g++ at first
// use, into build/native/; ctypes).

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// src: (src_h, src_w) int16 row-major; dst: (src_h/f, src_w/f) float32.
void block_mean_int16(const int16_t* src, int64_t src_h, int64_t src_w,
                      int64_t factor, float* dst, int64_t n_threads) {
  const int64_t dst_h = src_h / factor;
  const int64_t dst_w = src_w / factor;
  const float inv = 1.0f / static_cast<float>(factor * factor);
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  std::atomic<int64_t> next_row{0};
  auto worker = [&]() {
    for (;;) {
      const int64_t dy = next_row.fetch_add(1);
      if (dy >= dst_h) return;
      float* out_row = dst + dy * dst_w;
      for (int64_t dx = 0; dx < dst_w; ++dx) out_row[dx] = 0.0f;
      for (int64_t sy = dy * factor; sy < (dy + 1) * factor; ++sy) {
        const int16_t* in_row = src + sy * src_w;
        for (int64_t dx = 0; dx < dst_w; ++dx) {
          int32_t acc = 0;
          const int16_t* p = in_row + dx * factor;
          for (int64_t k = 0; k < factor; ++k) acc += p[k];
          out_row[dx] += static_cast<float>(acc);
        }
      }
      for (int64_t dx = 0; dx < dst_w; ++dx) out_row[dx] *= inv;
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int64_t i = 0; i < n_threads; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// float32 variant (procedural data, cached arrays).
void block_mean_f32(const float* src, int64_t src_h, int64_t src_w,
                    int64_t factor, float* dst, int64_t n_threads) {
  const int64_t dst_h = src_h / factor;
  const int64_t dst_w = src_w / factor;
  const float inv = 1.0f / static_cast<float>(factor * factor);
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  std::atomic<int64_t> next_row{0};
  auto worker = [&]() {
    for (;;) {
      const int64_t dy = next_row.fetch_add(1);
      if (dy >= dst_h) return;
      float* out_row = dst + dy * dst_w;
      for (int64_t dx = 0; dx < dst_w; ++dx) out_row[dx] = 0.0f;
      for (int64_t sy = dy * factor; sy < (dy + 1) * factor; ++sy) {
        const float* in_row = src + sy * src_w;
        for (int64_t dx = 0; dx < dst_w; ++dx) {
          float acc = 0.0f;
          const float* p = in_row + dx * factor;
          for (int64_t k = 0; k < factor; ++k) acc += p[k];
          out_row[dx] += acc;
        }
      }
      for (int64_t dx = 0; dx < dst_w; ++dx) out_row[dx] *= inv;
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int64_t i = 0; i < n_threads; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Bilinear resample of an equirectangular float32 map with longitude wrap:
// host-side utility for starmap resizing and cache preparation.
void resample_bilinear_f32(const float* src, int64_t src_h, int64_t src_w,
                           float* dst, int64_t dst_h, int64_t dst_w,
                           int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  std::atomic<int64_t> next_row{0};
  const double sy_scale = static_cast<double>(src_h) / dst_h;
  const double sx_scale = static_cast<double>(src_w) / dst_w;
  auto worker = [&]() {
    for (;;) {
      const int64_t dy = next_row.fetch_add(1);
      if (dy >= dst_h) return;
      const double fy = (dy + 0.5) * sy_scale - 0.5;
      int64_t y0 = static_cast<int64_t>(fy < 0 ? 0 : fy);
      if (y0 > src_h - 2) y0 = src_h - 2;
      const float wy = static_cast<float>(fy - y0 < 0 ? 0 : fy - y0);
      float* out_row = dst + dy * dst_w;
      const float* r0 = src + y0 * src_w;
      const float* r1 = src + (y0 + 1) * src_w;
      for (int64_t dx = 0; dx < dst_w; ++dx) {
        const double fx = (dx + 0.5) * sx_scale - 0.5;
        double fxw = fx < 0 ? fx + src_w : fx;
        int64_t x0 = static_cast<int64_t>(fxw);
        const float wx = static_cast<float>(fxw - x0);
        const int64_t x1 = (x0 + 1) % src_w;
        x0 %= src_w;
        const float top = r0[x0] * (1 - wx) + r0[x1] * wx;
        const float bot = r1[x0] * (1 - wx) + r1[x1] * wx;
        out_row[dx] = top * (1 - wy) + bot * wy;
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int64_t i = 0; i < n_threads; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
