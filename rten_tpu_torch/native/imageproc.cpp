// Native imageproc hot loops of the port (rten_tpu_torch/imageproc.py):
// the postprocessing loops where pure Python crawls on real image sizes,
// Moore-neighbor contour tracing and greedy NMS.
//
// Semantics exactly mirror the Python core of rten_tpu_torch/imageproc.py:
// the tests assert native == python on random masks and boxes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int NEI[8][2] = {
    {-1, 0}, {-1, 1}, {0, 1}, {1, 1}, {1, 0}, {1, -1}, {0, -1}, {-1, -1},
};

}  // namespace

extern "C" {

// mask: [h*w] u8 (nonzero = foreground).
// out_points: [max_pts*2] i32 (y, x pairs, contours concatenated)
// out_sizes:  [max_contours] i32 point counts per contour
// Returns number of contours, or -1 if buffers are too small.
int32_t rten_find_contours(const uint8_t* mask, int32_t h, int32_t w,
                           int32_t* out_points, int32_t max_pts,
                           int32_t* out_sizes, int32_t max_contours) {
  std::vector<uint8_t> grid(static_cast<size_t>(h) * w);
  for (int64_t i = 0; i < static_cast<int64_t>(h) * w; i++)
    grid[i] = mask[i] ? 1 : 0;
  std::vector<uint8_t> visited(static_cast<size_t>(h) * w, 0);
  auto at = [&](int y, int x) -> uint8_t {
    if (y < 0 || y >= h || x < 0 || x >= w) return 0;
    return grid[static_cast<size_t>(y) * w + x];
  };
  auto vis = [&](int y, int x) -> uint8_t& {
    return visited[static_cast<size_t>(y) * w + x];
  };

  int32_t n_contours = 0;
  int64_t pt_cursor = 0;
  std::vector<int32_t> stack;

  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      if (!at(y, x) || vis(y, x)) continue;
      if (x > 0 && at(y, x - 1)) {
        if (vis(y, x - 1)) vis(y, x) = 1;  // interior of a known run
        continue;
      }
      if (n_contours >= max_contours) return -1;
      // Moore boundary tracing from (y, x), entering from the west.
      int sy = y, sx = x;
      int cy = y, cx = x;
      int prev_dir = 6;
      int32_t count = 0;
      auto push = [&](int py, int px) -> bool {
        if (pt_cursor + 2 > max_pts * 2) return false;
        out_points[pt_cursor++] = py;
        out_points[pt_cursor++] = px;
        count++;
        return true;
      };
      if (!push(sy, sx)) return -1;
      vis(sy, sx) = 1;
      bool open = true;
      while (open) {
        bool found = false;
        for (int k = 0; k < 8; k++) {
          int d = (prev_dir + 1 + k) % 8;
          int ny = cy + NEI[d][0], nx = cx + NEI[d][1];
          if (at(ny, nx)) {
            if (ny == sy && nx == sx && count > 1) {
              found = true;
              open = false;
              break;
            }
            if (!push(ny, nx)) return -1;
            vis(ny, nx) = 1;
            cy = ny;
            cx = nx;
            prev_dir = (d + 4) % 8;
            found = true;
            break;
          }
        }
        if (!found) break;
      }
      out_sizes[n_contours++] = count;
      // Flood-mark the component so interior pixels don't re-trigger.
      stack.clear();
      stack.push_back(y);
      stack.push_back(x);
      while (!stack.empty()) {
        int px = stack.back(); stack.pop_back();
        int py = stack.back(); stack.pop_back();
        for (auto& nb : NEI) {
          int ny = py + nb[0], nx = px + nb[1];
          if (ny >= 0 && ny < h && nx >= 0 && nx < w && at(ny, nx) &&
              !vis(ny, nx)) {
            vis(ny, nx) = 1;
            stack.push_back(ny);
            stack.push_back(nx);
          }
        }
      }
    }
  }
  return n_contours;
}

// Greedy NMS over [n, 4] (top, left, bottom, right) boxes.
// Returns number of kept indices written to out_idx (score-sorted).
int32_t rten_nms(const float* boxes, const float* scores, int32_t n,
                 float iou_threshold, float score_threshold,
                 int32_t max_detections, int32_t* out_idx) {
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; i++) order[i] = i;
  // stable sort by -score (matches np.argsort(-scores) tie behavior).
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return scores[a] > scores[b];
  });
  int32_t kept = 0;
  auto area = [&](const float* b) {
    float hh = b[2] - b[0], ww = b[3] - b[1];
    return (hh > 0 ? hh : 0.f) * (ww > 0 ? ww : 0.f);
  };
  for (int32_t oi = 0; oi < n && kept < max_detections; oi++) {
    int32_t i = order[oi];
    if (scores[i] <= score_threshold) continue;
    const float* bi = boxes + 4 * i;
    bool ok = true;
    for (int32_t kj = 0; kj < kept; kj++) {
      const float* bj = boxes + 4 * out_idx[kj];
      float t = bi[0] > bj[0] ? bi[0] : bj[0];
      float l = bi[1] > bj[1] ? bi[1] : bj[1];
      float bo = bi[2] < bj[2] ? bi[2] : bj[2];
      float r = bi[3] < bj[3] ? bi[3] : bj[3];
      float inter = 0.f;
      // Python Rect.iou: intersects() uses strict <, then area clamps.
      if (bi[1] < bj[3] && bj[1] < bi[3] && bi[0] < bj[2] && bj[0] < bi[2]) {
        float ih = bo - t, iw = r - l;
        inter = (ih > 0 ? ih : 0.f) * (iw > 0 ? iw : 0.f);
      }
      float uni = area(bi) + area(bj) - inter;
      float iou = uni > 0.f ? inter / uni : 0.f;
      if (iou > iou_threshold) {
        ok = false;
        break;
      }
    }
    if (ok) out_idx[kept++] = i;
  }
  return kept;
}

}  // extern "C"
