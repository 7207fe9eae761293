// Host-side preprocessing core of edgecape_tpu_torch's episodic data
// loader; the port's copy of native/preprocess.cc, plus a warp that keeps
// uint8 for the eval path (normalization then happens on the device).
//
// Affine crop + bilinear resample (+ ImageNet normalize) and gaussian
// heatmap rendering as multithreaded C++ batch calls, bound to Python via
// ctypes (edgecape_tpu_torch/data/native.py). Bilinear sampling has
// cv2.warpAffine(INTER_LINEAR) semantics: dst(x,y) = bilinear(src, M_inv .
// (x,y,1)) with zero padding outside; the 2x3 inverse matrices are computed
// by the caller (ops/affine.py, ops/warp.py).
//
// Built at first use by data/native.py with the host C++ compiler
// (-O3 -shared -fPIC -pthread, no external dependencies).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct WarpJob {
  const uint8_t* src;   // [H, W, 3] RGB
  int src_h, src_w;
  const float* inv_mat; // [2, 3] dst->src
};

// Bilinear sample of all output pixels; `put(y, x, px)` stores the three
// channel values (0..255 floats) of one pixel.
template <typename Put>
inline void warp_one(const WarpJob& j, int out_h, int out_w, Put put) {
  const float m00 = j.inv_mat[0], m01 = j.inv_mat[1], m02 = j.inv_mat[2];
  const float m10 = j.inv_mat[3], m11 = j.inv_mat[4], m12 = j.inv_mat[5];
  const int H = j.src_h, W = j.src_w;
  for (int y = 0; y < out_h; ++y) {
    const float sy_base = m12 + m11 * static_cast<float>(y);
    const float sx_base = m02 + m01 * static_cast<float>(y);
    for (int x = 0; x < out_w; ++x) {
      const float sx = sx_base + m00 * static_cast<float>(x);
      const float sy = sy_base + m10 * static_cast<float>(x);
      const float fx0 = std::floor(sx);
      const float fy0 = std::floor(sy);
      const int x0 = static_cast<int>(fx0);
      const int y0 = static_cast<int>(fy0);
      const float ax = sx - fx0;
      const float ay = sy - fy0;
      float px[3] = {0.f, 0.f, 0.f};
      // gather 4 neighbors with zero padding outside
      for (int dy = 0; dy < 2; ++dy) {
        const int yy = y0 + dy;
        if (yy < 0 || yy >= H) continue;
        const float wy = dy ? ay : 1.f - ay;
        for (int dx = 0; dx < 2; ++dx) {
          const int xx = x0 + dx;
          if (xx < 0 || xx >= W) continue;
          const float w = wy * (dx ? ax : 1.f - ax);
          const uint8_t* p =
              j.src + (static_cast<size_t>(yy) * W + xx) * 3;
          px[0] += w * p[0];
          px[1] += w * p[1];
          px[2] += w * p[2];
        }
      }
      put(y, x, px);
    }
  }
}

void parallel_for(int n, int num_threads, const std::function<void(int)>& f) {
  if (n <= 0) return;
  num_threads = std::max(1, std::min(num_threads, n));
  if (num_threads == 1) {
    for (int i = 0; i < n; ++i) f(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> ts;
  ts.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    ts.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) f(i);
    });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Batch affine warp + ImageNet normalize.
//   srcs:      concatenated uint8 RGB images
//   offsets:   [n] byte offsets of each image into srcs
//   hs, ws:    [n] per-image heights/widths
//   inv_mats:  [n, 2, 3] float dst->src affines
//   out:       [n, out_h, out_w, 3] float32
void warp_normalize_batch(const uint8_t* srcs, const int64_t* offsets,
                          const int* hs, const int* ws,
                          const float* inv_mats, float* out, int n,
                          int out_h, int out_w, const float* mean,
                          const float* stddev, int num_threads) {
  float inv_std[3] = {1.f / stddev[0], 1.f / stddev[1], 1.f / stddev[2]};
  parallel_for(n, num_threads, [&](int i) {
    WarpJob j;
    j.src = srcs + offsets[i];
    j.src_h = hs[i];
    j.src_w = ws[i];
    j.inv_mat = inv_mats + static_cast<size_t>(i) * 6;
    float* dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
    warp_one(j, out_h, out_w, [&](int y, int x, const float* px) {
      float* o = dst + (static_cast<size_t>(y) * out_w + x) * 3;
      o[0] = (px[0] * (1.f / 255.f) - mean[0]) * inv_std[0];
      o[1] = (px[1] * (1.f / 255.f) - mean[1]) * inv_std[1];
      o[2] = (px[2] * (1.f / 255.f) - mean[2]) * inv_std[2];
    });
  });
}

// Batch affine warp to uint8 (round to nearest, as cv2.warpAffine stores
// its result); arguments as warp_normalize_batch, out [n, out_h, out_w, 3]
// uint8.
void warp_uint8_batch(const uint8_t* srcs, const int64_t* offsets,
                      const int* hs, const int* ws, const float* inv_mats,
                      uint8_t* out, int n, int out_h, int out_w,
                      int num_threads) {
  parallel_for(n, num_threads, [&](int i) {
    WarpJob j;
    j.src = srcs + offsets[i];
    j.src_h = hs[i];
    j.src_w = ws[i];
    j.inv_mat = inv_mats + static_cast<size_t>(i) * 6;
    uint8_t* dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
    warp_one(j, out_h, out_w, [&](int y, int x, const float* px) {
      uint8_t* o = dst + (static_cast<size_t>(y) * out_w + x) * 3;
      for (int c = 0; c < 3; ++c)
        o[c] = static_cast<uint8_t>(
            std::min(255.f, std::max(0.f, std::nearbyint(px[c]))));
    });
  });
}

// Batch MSRA gaussian heatmap rendering (snapped
// integer center, 6*sigma+1 truncation window, peak 1, weight zeroed when
// the window is fully out of bounds).
//   joints:  [n, k, 2] float coords in input pixels
//   visible: [n, k] float
//   target:  [n, k, hm_h, hm_w] float32 out
//   weight:  [n, k] float32 out
void msra_heatmaps_batch(const float* joints, const float* visible,
                         float* target, float* weight, int n, int k,
                         int hm_h, int hm_w, float img_h, float img_w,
                         float sigma, int num_threads) {
  const float stride_x = img_w / static_cast<float>(hm_w);
  const float stride_y = img_h / static_cast<float>(hm_h);
  const float tmp_f = sigma * 3.f;
  // gaussian anchor: ul + (2*ts+1)//2 (shifts off mu when 3*sigma is
  // fractional)
  const float x0 = std::floor((2.f * tmp_f + 1.f) / 2.f);
  const float inv_two_sigma2 = 1.f / (2.f * sigma * sigma);
  parallel_for(n, num_threads, [&](int i) {
    for (int j = 0; j < k; ++j) {
      const size_t base = (static_cast<size_t>(i) * k + j);
      float* tgt = target + base * hm_h * hm_w;
      std::memset(tgt, 0, sizeof(float) * hm_h * hm_w);
      const float vx = visible[base];
      // int(v + 0.5) truncation-toward-zero like python's int()
      const int mu_x = static_cast<int>(joints[base * 2 + 0] / stride_x
                                        + 0.5f);
      const int mu_y = static_cast<int>(joints[base * 2 + 1] / stride_y
                                        + 0.5f);
      // window bounds: int() truncation toward zero of mu -/+ ts
      const int ul_x = static_cast<int>(mu_x - tmp_f);
      const int ul_y = static_cast<int>(mu_y - tmp_f);
      const int br_x = static_cast<int>(mu_x + tmp_f + 1.f);
      const int br_y = static_cast<int>(mu_y + tmp_f + 1.f);
      const bool oob = (ul_x >= hm_w) || (ul_y >= hm_h) || (br_x < 0) ||
                       (br_y < 0);
      const float w = oob ? 0.f : vx;
      weight[base] = w;
      if (w <= 0.5f) continue;
      const float cx = static_cast<float>(ul_x) + x0;
      const float cy = static_cast<float>(ul_y) + x0;
      const int y_lo = std::max(0, ul_y);
      const int y_hi = std::min(hm_h, br_y) - 1;
      const int x_lo = std::max(0, ul_x);
      const int x_hi = std::min(hm_w, br_x) - 1;
      for (int y = y_lo; y <= y_hi; ++y) {
        const float dy = static_cast<float>(y) - cy;
        float* row = tgt + static_cast<size_t>(y) * hm_w;
        for (int x = x_lo; x <= x_hi; ++x) {
          const float dx = static_cast<float>(x) - cx;
          row[x] = std::exp(-(dx * dx + dy * dy) * inv_two_sigma2);
        }
      }
    }
  });
}

// Batch UDP gaussian heatmap rendering (unbiased data processing):
// continuous sub-pixel gaussian
// center with stride (img-1)/(hm-1); truncation window and the
// out-of-bounds check anchored at the snapped integer center, like MSRA.
void udp_heatmaps_batch(const float* joints, const float* visible,
                        float* target, float* weight, int n, int k,
                        int hm_h, int hm_w, float img_h, float img_w,
                        float sigma, int num_threads) {
  const float stride_x = (img_w - 1.f) / static_cast<float>(hm_w - 1);
  const float stride_y = (img_h - 1.f) / static_cast<float>(hm_h - 1);
  const float tmp_f = sigma * 3.f;
  const float x0 = std::floor((2.f * tmp_f + 1.f) / 2.f);
  const float inv_two_sigma2 = 1.f / (2.f * sigma * sigma);
  parallel_for(n, num_threads, [&](int i) {
    for (int j = 0; j < k; ++j) {
      const size_t base = (static_cast<size_t>(i) * k + j);
      float* tgt = target + base * hm_h * hm_w;
      std::memset(tgt, 0, sizeof(float) * hm_h * hm_w);
      const float vx = visible[base];
      const float ax = joints[base * 2 + 0] / stride_x;  // continuous
      const float ay = joints[base * 2 + 1] / stride_y;
      // trunc(c + 0.5) like python int(): snapped center for window/bounds
      const int mu_x = static_cast<int>(ax + 0.5f);
      const int mu_y = static_cast<int>(ay + 0.5f);
      const int ul_x = static_cast<int>(mu_x - tmp_f);
      const int ul_y = static_cast<int>(mu_y - tmp_f);
      const int br_x = static_cast<int>(mu_x + tmp_f + 1.f);
      const int br_y = static_cast<int>(mu_y + tmp_f + 1.f);
      const bool oob = (ul_x >= hm_w) || (ul_y >= hm_h) || (br_x < 0) ||
                       (br_y < 0);
      const float w = oob ? 0.f : vx;
      weight[base] = w;
      if (w <= 0.5f) continue;
      // anchor: ul + size//2 + (continuous - snapped)
      const float cx = static_cast<float>(ul_x) + x0 + (ax - mu_x);
      const float cy = static_cast<float>(ul_y) + x0 + (ay - mu_y);
      const int y_lo = std::max(0, ul_y);
      const int y_hi = std::min(hm_h, br_y) - 1;
      const int x_lo = std::max(0, ul_x);
      const int x_hi = std::min(hm_w, br_x) - 1;
      for (int y = y_lo; y <= y_hi; ++y) {
        const float dy = static_cast<float>(y) - cy;
        float* row = tgt + static_cast<size_t>(y) * hm_w;
        for (int x = x_lo; x <= x_hi; ++x) {
          const float dx = static_cast<float>(x) - cx;
          row[x] = std::exp(-(dx * dx + dy * dy) * inv_two_sigma2);
        }
      }
    }
  });
}

}  // extern "C"
