// Native polygon-IoU + rotated NMS kernels (host-side).
//
// TPU-native framework analog of the reference's C++/SWIG polyiou library
// and CUDA rotated-NMS extension (SURVEY.md §2 "polyiou (devkit)", "rotated
// NMS"): the on-device hot paths are Pallas/XLA, but the OFFLINE host paths
// — DOTA cross-tile merge and Task-1 evaluation — match the reference's
// C++ implementation strategy. Exposed via a plain C ABI for ctypes (no
// pybind11 in this environment).
//
// Algorithm: Sutherland–Hodgman convex clipping in double precision, the
// same formulation as the tests' numpy oracle (deliberately different from
// the device kernels' candidate-point formulation — they cross-check).
//
// Build: g++ -O3 -march=native -shared -fPIC polyiou.cpp -o libpolyiou.so

#include <cmath>
#include <cstring>
#include <algorithm>

namespace {

struct Pt { double x, y; };

constexpr int MAX_V = 16;

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

inline double poly_area(const Pt* p, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    int j = (i + 1) % n;
    s += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return std::fabs(s) * 0.5;
}

// Clip convex polygon subject[ns] against the half-plane left of (a -> b).
inline int clip_edge(const Pt* subject, int ns, Pt a, Pt b, Pt* out) {
  int no = 0;
  for (int i = 0; i < ns; ++i) {
    const Pt& p = subject[i];
    const Pt& q = subject[(i + 1) % ns];
    double dp = cross(a, b, p);
    double dq = cross(a, b, q);
    if (dp >= -1e-12) out[no++] = p;
    if ((dp >= -1e-12) != (dq >= -1e-12)) {
      double t = dp / (dp - dq);
      out[no++] = {p.x + t * (q.x - p.x), p.y + t * (q.y - p.y)};
    }
  }
  return no;
}

// Ensure CCW winding.
inline void make_ccw(Pt* p, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    int j = (i + 1) % n;
    s += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  if (s < 0) std::reverse(p, p + n);
}

inline double convex_inter_area(const Pt* p1, int n1, Pt* p2, int n2) {
  Pt buf_a[MAX_V], buf_b[MAX_V];
  int n = n2;
  std::memcpy(buf_a, p2, sizeof(Pt) * n2);
  Pt* cur = buf_a;
  Pt* nxt = buf_b;
  for (int e = 0; e < n1 && n > 0; ++e) {
    n = clip_edge(cur, n, p1[e], p1[(e + 1) % n1], nxt);
    std::swap(cur, nxt);
  }
  return (n >= 3) ? poly_area(cur, n) : 0.0;
}

inline void rbox_corners(const float* b, Pt* out) {
  double cx = b[0], cy = b[1], w = b[2], h = b[3], th = b[4];
  double c = std::cos(th), s = std::sin(th);
  const double sx[4] = {-0.5, 0.5, 0.5, -0.5};
  const double sy[4] = {-0.5, -0.5, 0.5, 0.5};
  for (int k = 0; k < 4; ++k) {
    double dx = sx[k] * w, dy = sy[k] * h;
    out[k] = {cx + dx * c - dy * s, cy + dx * s + dy * c};
  }
}

inline double rbox_iou_pair(const float* b1, const float* b2) {
  double a1 = (double)b1[2] * b1[3];
  double a2 = (double)b2[2] * b2[3];
  if (a1 <= 0.0 || a2 <= 0.0) return 0.0;
  Pt c1[4], c2[4];
  rbox_corners(b1, c1);
  rbox_corners(b2, c2);
  double inter = convex_inter_area(c1, 4, c2, 4);
  inter = std::min(inter, std::min(a1, a2));
  return inter / (a1 + a2 - inter + 1e-12);
}

}  // namespace

extern "C" {

// Exact IoU of two convex quads given as 8 doubles each (x1 y1 ... x4 y4).
// The reference devkit's iou_poly() contract.
double iou_poly(const double* p, const double* q) {
  Pt c1[4], c2[4];
  for (int k = 0; k < 4; ++k) {
    c1[k] = {p[2 * k], p[2 * k + 1]};
    c2[k] = {q[2 * k], q[2 * k + 1]};
  }
  make_ccw(c1, 4);
  make_ccw(c2, 4);
  double a1 = poly_area(c1, 4), a2 = poly_area(c2, 4);
  if (a1 <= 0.0 || a2 <= 0.0) return 0.0;
  double inter = convex_inter_area(c1, 4, c2, 4);
  inter = std::min(inter, std::min(a1, a2));
  return inter / (a1 + a2 - inter + 1e-12);
}

// Pairwise IoU matrix of n rotated boxes (cx, cy, w, h, theta) x 5 floats.
void rbox_iou_matrix(const float* boxes, int n, float* out) {
  for (int i = 0; i < n; ++i) {
    out[i * n + i] = boxes[i * 5 + 2] > 0 && boxes[i * 5 + 3] > 0 ? 1.f : 0.f;
    for (int j = i + 1; j < n; ++j) {
      float v = (float)rbox_iou_pair(boxes + i * 5, boxes + j * 5);
      out[i * n + j] = v;
      out[j * n + i] = v;
    }
  }
}

// Pairwise quad IoU matrix: a (n x 8 doubles), b (m x 8 doubles).
void quad_iou_matrix(const double* a, int n, const double* b, int m,
                     float* out) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j)
      out[i * m + j] = (float)iou_poly(a + i * 8, b + j * 8);
}

// Greedy rotated NMS. dets: n x 6 floats (cx, cy, w, h, theta, score),
// PRE-SORTED by descending score. Writes kept indices; returns count.
int rotated_nms(const float* dets, int n, float iou_thr, int* keep) {
  int n_keep = 0;
  bool* dead = new bool[n]();
  for (int i = 0; i < n; ++i) {
    if (dead[i]) continue;
    keep[n_keep++] = i;
    for (int j = i + 1; j < n; ++j) {
      if (dead[j]) continue;
      if (rbox_iou_pair(dets + i * 6, dets + j * 6) > iou_thr) dead[j] = true;
    }
  }
  delete[] dead;
  return n_keep;
}

}  // extern "C"
