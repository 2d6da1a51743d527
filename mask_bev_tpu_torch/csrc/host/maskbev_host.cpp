// Host core of the PyTorch port's input pipeline.
//
// The port's own copy of the JAX package's native host core: GT-mask
// morphology (datasets/semantic_kitti/rasterizer.py), rotated-box footprint
// fill (datasets/kitti/kitti_rasterizer.py) and in-box point counts, as a
// plain C ABI bound by ctypes in mask_bev_tpu_torch/native.py. Each entry
// point has a numpy twin with the same semantics, which the tests hold it
// against: ops/morphology.py::close_then_open,
// datasets/kitti/kitti_rasterizer.py::fill_rotated_boxes_img and
// ::points_in_boxes_count.
//
// Built at first call by native.py (g++ -O3 -fPIC -shared -std=c++17).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Binary morphology with a k x k rectangular structuring element.
// Border semantics match cv2 defaults: dilation treats outside as 0,
// erosion treats outside as 1. Separable two-pass (rows then cols) sliding
// max/min — O(1) amortized per pixel via the two-stack monotonic deque
// trick degenerates for binary data to simple running counts, which is
// faster still: a window contains a 1 iff the count of 1s > 0.
// ---------------------------------------------------------------------------

static void dilate_1d_rows(const uint8_t* src, uint8_t* dst, int h, int w,
                           int k) {
  int r = k / 2;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + (size_t)y * w;
    uint8_t* out = dst + (size_t)y * w;
    int count = 0;
    // prime window [0, r)
    for (int x = 0; x < r && x < w; ++x) count += row[x];
    for (int x = 0; x < w; ++x) {
      int hi = x + r;
      if (hi < w) count += row[hi];
      int lo = x - r - 1;
      if (lo >= 0) count -= row[lo];
      out[x] = count > 0;
    }
  }
}

static void dilate_1d_cols(const uint8_t* src, uint8_t* dst, int h, int w,
                           int k) {
  int r = k / 2;
  std::vector<int> count(w, 0);
  for (int y = 0; y < r && y < h; ++y) {
    const uint8_t* row = src + (size_t)y * w;
    for (int x = 0; x < w; ++x) count[x] += row[x];
  }
  for (int y = 0; y < h; ++y) {
    int hi = y + r;
    if (hi < h) {
      const uint8_t* row = src + (size_t)hi * w;
      for (int x = 0; x < w; ++x) count[x] += row[x];
    }
    int lo = y - r - 1;
    if (lo >= 0) {
      const uint8_t* row = src + (size_t)lo * w;
      for (int x = 0; x < w; ++x) count[x] -= row[x];
    }
    uint8_t* out = dst + (size_t)y * w;
    for (int x = 0; x < w; ++x) out[x] = count[x] > 0;
  }
}

// erosion(border=1) == ~dilation(~mask, border=0)
static void invert(uint8_t* m, size_t n) {
  for (size_t i = 0; i < n; ++i) m[i] = !m[i];
}

static void dilate(const uint8_t* src, uint8_t* dst, uint8_t* tmp, int h,
                   int w, int k) {
  dilate_1d_rows(src, tmp, h, w, k);
  dilate_1d_cols(tmp, dst, h, w, k);
}

static void erode(const uint8_t* src, uint8_t* dst, uint8_t* tmp, int h,
                  int w, int k) {
  size_t n = (size_t)h * w;
  std::vector<uint8_t> inv(src, src + n);
  invert(inv.data(), n);
  dilate(inv.data(), dst, tmp, h, w, k);
  invert(dst, n);
}

// MORPH_CLOSE then MORPH_OPEN, in place on `mask` (h x w, 0/1 bytes).
void close_then_open(uint8_t* mask, int h, int w, int k) {
  size_t n = (size_t)h * w;
  std::vector<uint8_t> a(n), tmp(n);
  dilate(mask, a.data(), tmp.data(), h, w, k);   // close: dilate
  erode(a.data(), mask, tmp.data(), h, w, k);    //        erode
  erode(mask, a.data(), tmp.data(), h, w, k);    // open:  erode
  dilate(a.data(), mask, tmp.data(), h, w, k);   //        dilate
}

// ---------------------------------------------------------------------------
// Rasterize N rotated boxes into an int32 instance-id image (H x W),
// sequential overwrite, id = box index + 1 where keep[i] != 0.
// Cell-center inside-test (matches the numpy fill in kitti_rasterizer.py).
// ---------------------------------------------------------------------------
void fill_rotated_boxes_img(int32_t* img, int h, int w, const float* centers,
                            const float* dims, const float* yaws,
                            const uint8_t* keep, int n, float x0, float y0,
                            float voxel) {
  for (int i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    float cx = centers[2 * i], cy = centers[2 * i + 1];
    float hl = dims[2 * i] * 0.5f, hw = dims[2 * i + 1] * 0.5f;
    float c = std::cos(yaws[i]), s = std::sin(yaws[i]);
    // bounding box of the rotated rect in grid coords
    float ext_x = std::fabs(hl * c) + std::fabs(hw * s);
    float ext_y = std::fabs(hl * s) + std::fabs(hw * c);
    int xlo = std::max(0, (int)std::floor((cx - ext_x - x0) / voxel) - 1);
    int xhi = std::min(w - 1, (int)std::ceil((cx + ext_x - x0) / voxel) + 1);
    int ylo = std::max(0, (int)std::floor((cy - ext_y - y0) / voxel) - 1);
    int yhi = std::min(h - 1, (int)std::ceil((cy + ext_y - y0) / voxel) + 1);
    for (int yy = ylo; yy <= yhi; ++yy) {
      float py = (yy + 0.5f) * voxel + y0 - cy;
      for (int xx = xlo; xx <= xhi; ++xx) {
        float px = (xx + 0.5f) * voxel + x0 - cx;
        float lx = px * c + py * s;
        float ly = -px * s + py * c;
        if (std::fabs(lx) <= hl && std::fabs(ly) <= hw)
          img[(size_t)yy * w + xx] = i + 1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Count points inside each 3D box (footprint + [z0, z0+h] slab).
// points: (P, stride) with x,y,z in the first 3 columns.
// ---------------------------------------------------------------------------
void points_in_boxes_count(const float* points, int p, int stride,
                           const float* centers3, const float* dims3,
                           const float* yaws, int n, int32_t* out_counts) {
  std::memset(out_counts, 0, sizeof(int32_t) * n);
  std::vector<float> cs(n), ss(n);
  for (int i = 0; i < n; ++i) {
    cs[i] = std::cos(yaws[i]);
    ss[i] = std::sin(yaws[i]);
  }
  for (int j = 0; j < p; ++j) {
    float x = points[(size_t)j * stride];
    float y = points[(size_t)j * stride + 1];
    float z = points[(size_t)j * stride + 2];
    for (int i = 0; i < n; ++i) {
      float dx = x - centers3[3 * i];
      float dy = y - centers3[3 * i + 1];
      float lx = dx * cs[i] + dy * ss[i];
      if (std::fabs(lx) > dims3[3 * i] * 0.5f) continue;
      float ly = -dx * ss[i] + dy * cs[i];
      if (std::fabs(ly) > dims3[3 * i + 1] * 0.5f) continue;
      float z0 = centers3[3 * i + 2];
      if (z < z0 || z > z0 + dims3[3 * i + 2]) continue;
      ++out_counts[i];
    }
  }
}

}  // extern "C"
