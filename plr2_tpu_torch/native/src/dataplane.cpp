// plr2_tpu_torch native host data plane.
//
// The host side of the port's real-data path, loaded with ctypes by
// plr2_tpu_torch/native/__init__.py: fused mask->bbox->choose sampling,
// depth backprojection, ASCII PLY vertex parsing, and the PNG row filters
// that the port's own PNG reader (plr2_tpu_torch/data/codecs.py) undoes
// after zlib's inflate. Its threaded and process prefetchers call it
// from worker threads (ctypes releases the GIL around each call).
//
// Semantics mirror plr2_tpu_torch/data (bbox.py border-list snapping,
// preprocess.py choose sampling: uniform subset in ascending flat order
// when the mask has more than num_points pixels, cyclic wrap-pad when
// fewer, zeros when empty). The functions before plr2_png_unfilter are
// those of the JAX package's data plane, unchanged, so the two agree bit
// for bit.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <vector>

namespace {

const int kBorderList[] = {-1, 40, 80, 120, 160, 200, 240, 280, 320,
                           360, 400, 440, 480, 520, 560, 600, 640, 680};
const int kBorderLen = sizeof(kBorderList) / sizeof(int);

int snap_len(int len) {
  for (int i = 0; i + 1 < kBorderLen; ++i) {
    if (kBorderList[i] < len && len <= kBorderList[i + 1]) {
      return kBorderList[i + 1];
    }
  }
  return kBorderList[kBorderLen - 1];
}

// Tight bbox of the set pixels; returns false when the mask is empty.
bool tight_bbox(const uint8_t* mask, int img_h, int img_w, int* rmin_out,
                int* rmax_out, int* cmin_out, int* cmax_out) {
  int rmin = img_h, rmax = -1, cmin = img_w, cmax = -1;
  const int w8 = img_w / 8;
  for (int r = 0; r < img_h; ++r) {
    const uint8_t* row = mask + static_cast<size_t>(r) * img_w;
    // 8-byte strides: skip all-zero spans without per-byte branches
    int c_lo = -1, c_hi = -1;
    for (int b = 0; b < w8; ++b) {
      uint64_t v;
      std::memcpy(&v, row + b * 8, 8);
      if (v) {
        int c = b * 8;
        if (c_lo < 0) {
          while (!row[c]) ++c;
          c_lo = c;
        }
        c = b * 8 + 7;
        while (!row[c]) --c;
        c_hi = c;
      }
    }
    for (int c = w8 * 8; c < img_w; ++c) {
      if (row[c]) {
        if (c_lo < 0) c_lo = c;
        c_hi = c;
      }
    }
    if (c_lo >= 0) {
      if (r < rmin) rmin = r;
      rmax = r;
      if (c_lo < cmin) cmin = c_lo;
      if (c_hi > cmax) cmax = c_hi;
    }
  }
  if (rmax < 0) return false;
  *rmin_out = rmin; *rmax_out = rmax; *cmin_out = cmin; *cmax_out = cmax;
  return true;
}

// Choose sampling over the masked pixels inside [r0,r1)x[c0,c1): uniform
// subset in ascending crop-flat order when count > num_points, cyclic
// wrap-pad when fewer, zeros when empty. Returns the count.
int choose_in_window(const uint8_t* mask, int img_w, int r0, int r1, int c0,
                     int c1, int num_points, uint64_t seed,
                     int32_t* choose_out) {
  const int cw = c1 - c0;
  std::vector<int32_t> nz;
  nz.reserve(4096);
  for (int r = r0; r < r1; ++r) {
    const uint8_t* row = mask + static_cast<size_t>(r) * img_w;
    const int32_t base = (r - r0) * cw - c0;
    int c = c0;
    for (; c + 8 <= c1; c += 8) {
      uint64_t v;
      std::memcpy(&v, row + c, 8);
      if (!v) continue;
      for (int k = 0; k < 8; ++k) {
        if (row[c + k]) nz.push_back(base + c + k);
      }
    }
    for (; c < c1; ++c) {
      if (row[c]) nz.push_back(base + c);
    }
  }
  const int count = static_cast<int>(nz.size());
  if (count == 0) {
    std::memset(choose_out, 0, sizeof(int32_t) * num_points);
    return 0;
  }
  if (count > num_points) {
    // uniform subset without replacement, ascending order (partial
    // Fisher-Yates over the ordered list, then sort the head)
    std::mt19937_64 rng(seed);
    for (int i = 0; i < num_points; ++i) {
      std::uniform_int_distribution<int> d(i, count - 1);
      std::swap(nz[i], nz[d(rng)]);
    }
    std::sort(nz.begin(), nz.begin() + num_points);
    std::memcpy(choose_out, nz.data(), sizeof(int32_t) * num_points);
  } else {
    for (int i = 0; i < num_points; ++i) choose_out[i] = nz[i % count];
  }
  return count;
}

}  // namespace

extern "C" {

// Snap a tight bbox to the border-list window (reference get_bbox tail).
void plr2_snap_bbox(int rmin, int rmax, int cmin, int cmax, int img_h,
                    int img_w, int* out /*rmin rmax cmin cmax*/) {
  int r_b = snap_len(rmax - rmin);
  int c_b = snap_len(cmax - cmin);
  int cr = (rmin + rmax) / 2;
  int cc = (cmin + cmax) / 2;
  rmin = cr - r_b / 2;
  rmax = cr + r_b / 2;
  cmin = cc - c_b / 2;
  cmax = cc + c_b / 2;
  if (rmin < 0) { rmax -= rmin; rmin = 0; }
  if (cmin < 0) { cmax -= cmin; cmin = 0; }
  if (rmax > img_h) { rmin -= rmax - img_h; rmax = img_h; }
  if (cmax > img_w) { cmin -= cmax - img_w; cmax = img_w; }
  out[0] = rmin; out[1] = rmax; out[2] = cmin; out[3] = cmax;
}

// Fused mask -> snapped bbox -> choose sampling.
// mask: (img_h*img_w) uint8; bbox_out: 4 ints; choose_out: num_points
// flat indices INTO THE CROP. Returns the masked-pixel count inside the
// crop (0 => all-zero choose, the reference's empty-sample signal).
int plr2_mask_bbox_choose(const uint8_t* mask, int img_h, int img_w,
                          int num_points, uint64_t seed, int* bbox_out,
                          int32_t* choose_out) {
  int rmin, rmax, cmin, cmax;
  if (!tight_bbox(mask, img_h, img_w, &rmin, &rmax, &cmin, &cmax)) {
    bbox_out[0] = 0; bbox_out[1] = std::min(40, img_h);
    bbox_out[2] = 0; bbox_out[3] = std::min(40, img_w);
    std::memset(choose_out, 0, sizeof(int32_t) * num_points);
    return 0;
  }
  plr2_snap_bbox(rmin, rmax + 1, cmin, cmax + 1, img_h, img_w, bbox_out);
  return choose_in_window(mask, img_w, bbox_out[0], bbox_out[1], bbox_out[2],
                          bbox_out[3], num_points, seed, choose_out);
}

// Snapped bbox of a mask alone (upstream bboxes come from the label mask,
// choose sampling from label & depth-valid — plr2_choose_in_bbox below).
// Returns 0 for an empty mask (bbox_out set to the empty-mask window).
int plr2_mask_bbox(const uint8_t* mask, int img_h, int img_w, int* bbox_out) {
  int rmin, rmax, cmin, cmax;
  if (!tight_bbox(mask, img_h, img_w, &rmin, &rmax, &cmin, &cmax)) {
    bbox_out[0] = 0; bbox_out[1] = std::min(40, img_h);
    bbox_out[2] = 0; bbox_out[3] = std::min(40, img_w);
    return 0;
  }
  plr2_snap_bbox(rmin, rmax + 1, cmin, cmax + 1, img_h, img_w, bbox_out);
  return 1;
}

// Choose sampling inside an externally supplied bbox window.
int plr2_choose_in_bbox(const uint8_t* mask, int img_h, int img_w, int r0,
                        int r1, int c0, int c1, int num_points, uint64_t seed,
                        int32_t* choose_out) {
  (void)img_h;
  return choose_in_window(mask, img_w, r0, r1, c0, c1, num_points, seed,
                          choose_out);
}

// Backproject chosen crop pixels to a 3D cloud (reference dataset math).
void plr2_backproject(const float* depth_crop, const int32_t* choose, int n,
                      int crop_w, int row0, int col0, float cx, float cy,
                      float fx, float fy, float cam_scale, float* cloud_out) {
  for (int i = 0; i < n; ++i) {
    const int32_t idx = choose[i];
    const float z = depth_crop[idx] / cam_scale;
    const float u = static_cast<float>(idx % crop_w + col0);
    const float v = static_cast<float>(idx / crop_w + row0);
    cloud_out[i * 3 + 0] = (u - cx) * z / fx;
    cloud_out[i * 3 + 1] = (v - cy) * z / fy;
    cloud_out[i * 3 + 2] = z;
  }
}

// Minimal ASCII PLY vertex reader (reference ply_vtx contract).
// Returns vertex count written (<= max_pts), or -1 on error.
int plr2_parse_ply(const char* path, float* out, int max_pts) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[512];
  int n = 0;
  bool in_header = true;
  if (!std::fgets(line, sizeof line, f) || std::strncmp(line, "ply", 3)) {
    std::fclose(f);
    return -1;
  }
  while (in_header && std::fgets(line, sizeof line, f)) {
    if (!std::strncmp(line, "element vertex", 14)) {
      n = std::atoi(line + 14);
    } else if (!std::strncmp(line, "end_header", 10)) {
      in_header = false;
    }
  }
  if (in_header || n <= 0) { std::fclose(f); return -1; }
  n = std::min(n, max_pts);
  for (int i = 0; i < n; ++i) {
    float x, y, z;
    if (!std::fgets(line, sizeof line, f) ||
        std::sscanf(line, "%f %f %f", &x, &y, &z) != 3) {
      std::fclose(f);
      return -1;
    }
    out[i * 3 + 0] = x; out[i * 3 + 1] = y; out[i * 3 + 2] = z;
  }
  std::fclose(f);
  return n;
}

// Undo the PNG row filters (None, Sub, Up, Average, Paeth; PNG spec 9.2)
// in place. `data` holds `height` rows of 1 + `stride` bytes: the filter
// type, then the filtered row; `bpp` is the bytes a complete pixel (1-8;
// 1 for bit depths below 8). Each row is rebuilt from the row above it,
// already rebuilt, and Average and Paeth also from the byte `bpp` to its
// left in the same row. Returns 0, or the 1-based row whose filter type is
// not 0-4.
int plr2_png_unfilter(uint8_t* data, int height, int stride, int bpp) {
  const size_t row_len = static_cast<size_t>(stride) + 1;
  for (int r = 0; r < height; ++r) {
    uint8_t* row = data + r * row_len + 1;
    const uint8_t* up = r > 0 ? data + (r - 1) * row_len + 1 : nullptr;
    const uint8_t type = row[-1];
    switch (type) {
      case 0:
        break;
      case 1:
        for (int i = bpp; i < stride; ++i) row[i] += row[i - bpp];
        break;
      case 2:
        if (up) for (int i = 0; i < stride; ++i) row[i] += up[i];
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int left = i >= bpp ? row[i - bpp] : 0;
          const int above = up ? up[i] : 0;
          row[i] += static_cast<uint8_t>((left + above) >> 1);
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] += static_cast<uint8_t>(pred);
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

}  // extern "C"
