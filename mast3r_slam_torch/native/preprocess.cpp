// Native host-side image preprocessing for the frame-ingest pipeline of the
// PyTorch/CUDA port (the port's own copy of mast3r_slam_tpu/native/preprocess.cpp;
// the arithmetic is unchanged, so both give the same bytes).
//
// The per-frame decode -> resize -> normalize work runs on the host and must
// outpace the card; Python/PIL spends most of it in resampling, and on a host
// without PIL this path is the only one.
//
// Implements, over interleaved RGB u8 buffers:
//   * area-averaged downscale (box filter over the source footprint)
//   * bilinear upscale
//   * fused center-crop + [0,255] -> [-1,1] f32 normalize
// All loops OpenMP-parallel over rows. Exposed as a C ABI for ctypes; built by
// mast3r_slam_torch/ops/build.py into build/native/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Area-average resize u8 RGB HWC: src [sh, sw, 3] -> dst [dh, dw, 3].
void resize_area_u8(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                    int dw) {
  const double sy = static_cast<double>(sh) / dh;
  const double sx = static_cast<double>(sw) / dw;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    const double y0f = y * sy, y1f = (y + 1) * sy;
    const int y0 = static_cast<int>(y0f);
    const int y1 = std::min(sh, static_cast<int>(std::ceil(y1f)));
    for (int x = 0; x < dw; ++x) {
      const double x0f = x * sx, x1f = (x + 1) * sx;
      const int x0 = static_cast<int>(x0f);
      const int x1 = std::min(sw, static_cast<int>(std::ceil(x1f)));
      double acc[3] = {0, 0, 0};
      double wsum = 0;
      for (int yy = y0; yy < y1; ++yy) {
        const double wy =
            std::min<double>(yy + 1, y1f) - std::max<double>(yy, y0f);
        const uint8_t* row = src + (static_cast<size_t>(yy) * sw + x0) * 3;
        for (int xx = x0; xx < x1; ++xx, row += 3) {
          const double wx =
              std::min<double>(xx + 1, x1f) - std::max<double>(xx, x0f);
          const double wgt = wx * wy;
          acc[0] += wgt * row[0];
          acc[1] += wgt * row[1];
          acc[2] += wgt * row[2];
          wsum += wgt;
        }
      }
      uint8_t* out = dst + (static_cast<size_t>(y) * dw + x) * 3;
      const double inv = wsum > 0 ? 1.0 / wsum : 0.0;
      out[0] = static_cast<uint8_t>(std::lround(acc[0] * inv));
      out[1] = static_cast<uint8_t>(std::lround(acc[1] * inv));
      out[2] = static_cast<uint8_t>(std::lround(acc[2] * inv));
    }
  }
}

// Bilinear resize u8 RGB HWC (upscaling path).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                        int dh, int dw) {
  const double sy = static_cast<double>(sh) / dh;
  const double sx = static_cast<double>(sw) / dw;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    const double fy = (y + 0.5) * sy - 0.5;
    const int y0 = std::max(0, static_cast<int>(std::floor(fy)));
    const int y1 = std::min(sh - 1, y0 + 1);
    const double wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      const double fx = (x + 0.5) * sx - 0.5;
      const int x0 = std::max(0, static_cast<int>(std::floor(fx)));
      const int x1 = std::min(sw - 1, x0 + 1);
      const double wx = fx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * sw + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * sw + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * 3;
      uint8_t* out = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const double v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                         wy * ((1 - wx) * p10[c] + wx * p11[c]);
        out[c] = static_cast<uint8_t>(std::lround(v));
      }
    }
  }
}

// Fused center-crop + normalize to [-1, 1] float32.
// src [sh, sw, 3] u8; crop window (cy0, cx0, ch, cw); dst [ch, cw, 3] f32.
void crop_normalize_f32(const uint8_t* src, int sh, int sw, int cy0, int cx0,
                        int ch, int cw, float* dst) {
  const float scale = 2.0f / 255.0f;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < ch; ++y) {
    const uint8_t* row = src + (static_cast<size_t>(cy0 + y) * sw + cx0) * 3;
    float* out = dst + static_cast<size_t>(y) * cw * 3;
    for (int i = 0; i < cw * 3; ++i) {
      out[i] = row[i] * scale - 1.0f;
    }
  }
}

}  // extern "C"
