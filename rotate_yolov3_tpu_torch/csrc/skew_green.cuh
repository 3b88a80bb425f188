// Exact rotated-rectangle intersection, its IoU and the divide-free
// greedy-NMS kill predicate. Device code shared by kernel B (skew_kill.cu),
// kernel C (nms_greedy.cu) and kernel E (skew_iou_matrix.cu), so all three
// decide every pair with the same arithmetic, and share the pair-tile pass
// (PairTile, at the end). Three pair algos, each written in the operation
// order of its plain version in the port (which follows the reference):
//   kGreen       Green's-theorem slab clipping,
//                rotate_yolov3_tpu/ops/skew_iou_green.py::inter_area_green;
//   kGreen2      the same in B's rotated frame, inter_area_green_bframe;
//   kCandidates  24 candidate vertices, the first 8 valid compacted into
//                slots, ranked by a diamond angle, masked shoelace:
//                rotate_yolov3_tpu/ops/skew_iou_pallas.py::_candidates and
//                _area_from_candidates (sums in candidate order).
//
// Every source that includes this header is built with -fmad=false and
// without --use_fast_math, and uses cosf/sinf, sqrtf and IEEE division:
// contracting a*b+c into an FMA changes the parallel-edge products the Green
// code relies on and mints spurious parallel-edge candidates (the TPU kernel
// was bitten by exactly this), the candidates' inclusive 1e-6 tolerances
// must be computed as written, and the Green code relies on IEEE 1/0 = +-inf
// for edges parallel to a slab (green2's reciprocals are +-inf for every
// axis-aligned pair). min/max below propagate NaN as jnp.minimum /
// torch.minimum do (fminf/fmaxf return the other operand): a NaN anywhere
// in a clip window must make hi > lo false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace skew_green {

constexpr float kSigRel = 1e-5f;
constexpr float kEps = 1e-8f;
constexpr float kTol = 1e-6f;
constexpr float kOnePlusTol = (float)(1.0 + 1e-6);

// pair algos, in the order of ALGOS in ops/skew_iou_cuda.py
enum : int { kGreen = 0, kGreen2 = 1, kCandidates = 2 };

// The near-pair test's per-box constants (see may_overlap below).
constexpr float kRadRel = 1.0001f;       // circumradius x (1 + 1e-4)
constexpr float kRadCoord = 1e-5f;       // + 1e-5 (|cx| + |cy|)
constexpr float kRadAbs = 1e-5f;         // + 1e-5 px
constexpr float kMinSide = 1e-3f;        // sides below: always the geometry
constexpr float kMaxCoord = 1e18f;       // |cx|, |cy|, sides above: the same

// One box as the pair code reads it: the fields, cos/sin of the angle, the
// class, and the near-pair radius rad (may_overlap).
struct Box {
  float cx, cy, w, h, ux, uy;
  int cls;
  float rad;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Corner offsets relative to the rect center, signs (-1,-1), (1,-1), (1,1),
// (-1,1): offset_k = sx*(w/2)*u + sy*(h/2)*v with u = (ux, uy), v = (-uy, ux).
__device__ __forceinline__ void corner_offsets(float w, float h, float ux,
                                               float uy, float xs[4],
                                               float ys[4]) {
  const float hw = w * 0.5f, hh = h * 0.5f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float sx = (k == 1 || k == 2) ? 1.0f : -1.0f;
    const float sy = (k >= 2) ? 1.0f : -1.0f;
    xs[k] = (sx * hw) * ux - (sy * hh) * uy;
    ys[k] = (sx * hw) * uy + (sy * hh) * ux;
  }
}

// A box with the quantities of the pair code that depend on it alone:
// half-dims, corner offsets, edges 0 and 1 of the offsets and the area.
// make_rec computes them once per box with the operations the pair code
// would apply per pair, so every value it reads is bit-identical; the pair
// code reads a Box or a BoxRec through the overloads below.
struct BoxRec : Box {
  float hw, hh;
  float ox[4], oy[4];
  float ex[2], ey[2];
  float area;
};

__device__ __forceinline__ BoxRec make_rec(const Box& x) {
  BoxRec r;
  static_cast<Box&>(r) = x;
  r.hw = x.w * 0.5f;
  r.hh = x.h * 0.5f;
  corner_offsets(x.w, x.h, x.ux, x.uy, r.ox, r.oy);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    r.ex[k] = r.ox[k + 1] - r.ox[k];
    r.ey[k] = r.oy[k + 1] - r.oy[k];
  }
  r.area = x.w * x.h;
  return r;
}

__device__ __forceinline__ float half_w(const Box& p) { return p.w * 0.5f; }
__device__ __forceinline__ float half_w(const BoxRec& p) { return p.hw; }
__device__ __forceinline__ float half_h(const Box& p) { return p.h * 0.5f; }
__device__ __forceinline__ float half_h(const BoxRec& p) { return p.hh; }
__device__ __forceinline__ float box_area(const Box& p) { return p.w * p.h; }
__device__ __forceinline__ float box_area(const BoxRec& p) { return p.area; }

__device__ __forceinline__ void offsets(const Box& p, float xs[4],
                                        float ys[4]) {
  corner_offsets(p.w, p.h, p.ux, p.uy, xs, ys);
}
__device__ __forceinline__ void offsets(const BoxRec& p, float xs[4],
                                        float ys[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xs[k] = p.ox[k];
    ys[k] = p.oy[k];
  }
}

// Edge k (0 or 1) of the corner offsets xs, ys of p: corner k+1 - corner k.
__device__ __forceinline__ void edge(const Box&, const float xs[4],
                                     const float ys[4], int k, float* ex,
                                     float* ey) {
  *ex = xs[k + 1] - xs[k];
  *ey = ys[k + 1] - ys[k];
}
__device__ __forceinline__ void edge(const BoxRec& p, const float*,
                                     const float*, int k, float* ex,
                                     float* ey) {
  *ex = p.ex[k];
  *ey = p.ey[k];
}

// Signed distances (positive inside) of point p, relative to the rect
// center, to the rect's 4 half-planes.
__device__ __forceinline__ void rect_dists(float px, float py, float ux,
                                           float uy, float hw, float hh,
                                           float d[4]) {
  const float s = px * ux + py * uy;
  const float t = -px * uy + py * ux;
  d[0] = hw - s;
  d[1] = hw + s;
  d[2] = hh - t;
  d[3] = hh + t;
}

// Green's line integral of edge p0 -> p1 clipped to the 4 half-planes
// (two slabs); d are the start point's distances, (rs, rt) the per-axis
// crossing reciprocals.
__device__ __forceinline__ float edge_contrib(float p0x, float p0y, float p1x,
                                              float p1y, const float d[4],
                                              float rs, float rt) {
  const float tc0 = d[0] * rs;
  const float tc1 = -(d[1] * rs);
  const float tc2 = d[2] * rt;
  const float tc3 = -(d[3] * rt);
  const float lo =
      nan_max(nan_max(nan_min(tc0, tc1), nan_min(tc2, tc3)), 0.0f);
  const float hi =
      nan_min(nan_min(nan_max(tc0, tc1), nan_max(tc2, tc3)), 1.0f);
  const float c = 0.5f * (hi - lo) * (p0x * p1y - p0y * p1x);
  return hi > lo ? c : 0.0f;
}

template <class T>
__device__ inline float inter_area_green(const T& a, const T& b) {
  const float uax = a.ux, uay = a.uy, ubx = b.ux, uby = b.uy;
  const float ahw = half_w(a), ahh = half_h(a);
  const float bhw = half_w(b), bhh = half_h(b);
  float arx[4], ary[4], brx[4], bry[4];
  offsets(a, arx, ary);
  offsets(b, brx, bry);
  const float ox = a.cx - b.cx, oy = a.cy - b.cy;

  const float sig =
      kSigRel * (0.5f * (a.w + a.h + b.w + b.h) + fabsf(ox) + fabsf(oy));
  const float bhw_r = bhw + sig, bhh_r = bhh + sig;  // B expanded (relaxed)
  const float ahw_s = ahw - sig, ahh_s = ahh - sig;  // A shrunk (strict)

  float pax[4], pay[4], da[4][4], db[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // A corners rel. B center, distances inside expanded B
    pax[k] = arx[k] + ox;
    pay[k] = ary[k] + oy;
    rect_dists(pax[k], pay[k], ubx, uby, bhw_r, bhh_r, da[k]);
    // B corners rel. A center, distances inside shrunk A
    rect_dists(brx[k] - ox, bry[k] - oy, uax, uay, ahw_s, ahh_s, db[k]);
  }

  // clip reciprocals, shared by opposite edges (e2 = -e0, e3 = -e1 exactly)
  float ra[4][2], rb[4][2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float eax, eay, ebx, eby;
    edge(a, arx, ary, k, &eax, &eay);
    ra[k][0] = 1.0f / (eax * ubx + eay * uby);
    ra[k][1] = 1.0f / (-eax * uby + eay * ubx);
    ra[k + 2][0] = -ra[k][0];
    ra[k + 2][1] = -ra[k][1];
    edge(b, brx, bry, k, &ebx, &eby);
    rb[k][0] = 1.0f / (ebx * uax + eby * uay);
    rb[k][1] = 1.0f / (-ebx * uay + eby * uax);
    rb[k + 2][0] = -rb[k][0];
    rb[k + 2][1] = -rb[k][1];
  }

  float area = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = (k + 1) & 3;
    // A's edge k rel. B center, clipped to expanded B
    area = area + edge_contrib(pax[k], pay[k], pax[n], pay[n], da[k],
                               ra[k][0], ra[k][1]);
    // B's edge k rel. B center, clipped to shrunk A
    area = area + edge_contrib(brx[k], bry[k], brx[n], bry[n], db[k],
                               rb[k][0], rb[k][1]);
  }
  return nan_max(area, 0.0f);
}

// Green's line integral of one of B's edges in B's frame, clipped to the
// shrunk A: edge_contrib with its cross product p0 x p1 precomputed.
__device__ __forceinline__ float edge_contrib_cross(float cross,
                                                    const float d[4],
                                                    float rs, float rt) {
  const float tc0 = d[0] * rs;
  const float tc1 = -(d[1] * rs);
  const float tc2 = d[2] * rt;
  const float tc3 = -(d[3] * rt);
  const float lo =
      nan_max(nan_max(nan_min(tc0, tc1), nan_min(tc2, tc3)), 0.0f);
  const float hi =
      nan_min(nan_min(nan_max(tc0, tc1), nan_max(tc2, tc3)), 1.0f);
  const float c = 0.5f * (hi - lo) * cross;
  return hi > lo ? c : 0.0f;
}

// inter_area_green in B's rotated frame: B's slabs are axis-aligned, its
// corners (+-bhw, +-bhh), every clip reciprocal 1/(2m) of a half-dim x
// cos/sin product, and each of B's edges has the cross product 2*bhw*bhh.
template <class T>
__device__ inline float inter_area_green_bframe(const T& a, const T& b) {
  const float uax = a.ux, uay = a.uy, ubx = b.ux, uby = b.uy;
  const float ca = uax * ubx + uay * uby;  // cos(theta_a - theta_b)
  const float sa = uay * ubx - uax * uby;  // sin(theta_a - theta_b)
  const float ox = a.cx - b.cx, oy = a.cy - b.cy;
  const float os = ox * ubx + oy * uby;    // A center in B frame
  const float ot = -ox * uby + oy * ubx;

  const float ahw = half_w(a), ahh = half_h(a);
  const float bhw = half_w(b), bhh = half_h(b);
  const float sig =
      kSigRel * (0.5f * (a.w + a.h + b.w + b.h) + fabsf(ox) + fabsf(oy));
  const float bhw_r = bhw + sig, bhh_r = bhh + sig;  // B expanded (relaxed)
  const float ahw_s = ahw - sig, ahh_s = ahh - sig;  // A shrunk (strict)

  const float m1 = ahw * ca, m2 = ahh * sa;
  const float m3 = ahw * sa, m4 = ahh * ca;
  const float p = m1 - m2, q = m1 + m2;
  const float r = m3 + m4, w = m3 - m4;
  const float s_[4] = {os - p, os + q, os + p, os - q};
  const float t_[4] = {ot - r, ot + w, ot + r, ot - w};
  // A edge directions: e0 = (2m1, 2m3), e1 = (-2m2, 2m4), e2/e3 negated
  float ra[4][2];
  ra[0][0] = 0.5f / m1;
  ra[0][1] = 0.5f / m3;
  ra[1][0] = -0.5f / m2;
  ra[1][1] = 0.5f / m4;
  ra[2][0] = -ra[0][0];
  ra[2][1] = -ra[0][1];
  ra[3][0] = -ra[1][0];
  ra[3][1] = -ra[1][1];

  const float n1 = bhw * ca, n2 = bhh * sa;
  const float n3 = bhw * sa, n4 = bhh * ca;
  // B corners projected on A's axes, A-centered
  const float cu = os * ca + ot * sa;
  const float cv = -os * sa + ot * ca;
  const float pu = n1 - n2, qu = n1 + n2;
  const float rv = n4 - n3, wv = n4 + n3;
  const float u_[4] = {-qu - cu, pu - cu, qu - cu, -pu - cu};
  const float v_[4] = {-rv - cv, -wv - cv, rv - cv, wv - cv};
  // B edge directions on A's axes: e0 -> (2n1, -2n3), e1 -> (2n2, 2n4)
  float rb[4][2];
  rb[0][0] = 0.5f / n1;
  rb[0][1] = -0.5f / n3;
  rb[1][0] = 0.5f / n2;
  rb[1][1] = 0.5f / n4;
  rb[2][0] = -rb[0][0];
  rb[2][1] = -rb[0][1];
  rb[3][0] = -rb[1][0];
  rb[3][1] = -rb[1][1];
  const float bcross = 2.0f * bhw * bhh;

  float area = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = (k + 1) & 3;
    const float da[4] = {bhw_r - s_[k], bhw_r + s_[k], bhh_r - t_[k],
                         bhh_r + t_[k]};
    area = area + edge_contrib(s_[k], t_[k], s_[n], t_[n], da, ra[k][0],
                               ra[k][1]);
    const float db[4] = {ahw_s - u_[k], ahw_s + u_[k], ahh_s - v_[k],
                         ahh_s + v_[k]};
    area = area + edge_contrib_cross(bcross, db, rb[k][0], rb[k][1]);
  }
  return nan_max(area, 0.0f);
}

// ---- kCandidates --------------------------------------------------------

// Absolute corners, CCW from (-w/2, -h/2), as _corners computes them.
__device__ __forceinline__ void corners(const Box& p, float xs[4],
                                        float ys[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float sx = (k == 1 || k == 2) ? 1.0f : -1.0f;
    const float sy = (k >= 2) ? 1.0f : -1.0f;
    const float dx = sx * p.w * 0.5f;
    const float dy = sy * p.h * 0.5f;
    xs[k] = p.cx + dx * p.ux - dy * p.uy;
    ys[k] = p.cy + dx * p.uy + dy * p.ux;
  }
}

// The running state of the candidate list: the count and coordinate sums of
// the valid candidates so far, and the first 8 of them (the reference's
// prefix-count compaction; unrolled, so the slots stay in registers).
struct Slots {
  float n, sum_x, sum_y;
  float x[8], y[8];
};

__device__ __forceinline__ void add_candidate(Slots& st, float px, float py,
                                              bool v) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (v && st.n == (float)s) {
      st.x[s] = px;
      st.y[s] = py;
    }
  }
  const float vf = v ? 1.0f : 0.0f;
  st.n = st.n + vf;
  st.sum_x = st.sum_x + px * vf;
  st.sum_y = st.sum_y + py * vf;
}

// Is (qx, qy) inside the CCW quad (cx, cy), with the inclusive tolerance
// scaled by each edge's length?
__device__ __forceinline__ bool inside(float qx, float qy, const float cx[4],
                                       const float cy[4]) {
  bool res = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float ex = cx[(j + 1) & 3] - cx[j];
    const float ey = cy[(j + 1) & 3] - cy[j];
    const float crs = ex * (qy - cy[j]) - ey * (qx - cx[j]);
    const float tol = kTol * sqrtf(ex * ex + ey * ey + kEps);
    res = res & (crs >= -tol);
  }
  return res;
}

// Branch-free monotonic surrogate of atan2(y, x), range [0, 4).
__device__ __forceinline__ float diamond_angle(float y, float x) {
  const float denom = fabsf(x) + fabsf(y);
  const bool ok = denom > kEps;
  const float t = y / (ok ? denom : 1.0f);
  const float pos_y = x >= 0.0f ? t : 2.0f - t;
  const float neg_y = x < 0.0f ? 2.0f - t : 4.0f + t;
  const float ang = y >= 0.0f ? pos_y : neg_y;
  return ok ? ang : 0.0f;
}

__device__ inline float inter_area_candidates(const Box& a, const Box& b) {
  float ax[4], ay[4], bx[4], by[4];
  corners(a, ax, ay);
  corners(b, bx, by);
  Slots st;
  st.n = st.sum_x = st.sum_y = 0.0f;
#pragma unroll
  for (int s = 0; s < 8; ++s) st.x[s] = st.y[s] = 0.0f;

  // 16 edge-pair intersections, A's edge major
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p1x = ax[i], p1y = ay[i];
    const float d1x = ax[(i + 1) & 3] - p1x;
    const float d1y = ay[(i + 1) & 3] - p1y;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float q1x = bx[j], q1y = by[j];
      const float d2x = bx[(j + 1) & 3] - q1x;
      const float d2y = by[(j + 1) & 3] - q1y;
      const float denom = d1x * d2y - d1y * d2x;
      // relative parallelism test (see the note at the top)
      const float scale =
          (fabsf(d1x) + fabsf(d1y)) * (fabsf(d2x) + fabsf(d2y));
      const bool ok = fabsf(denom) > 1e-5f * scale + kEps;
      const float sd = ok ? denom : 1.0f;
      const float rx = q1x - p1x, ry = q1y - p1y;
      const float t = (rx * d2y - ry * d2x) / sd;
      const float u = (rx * d1y - ry * d1x) / sd;
      const bool v = ok & (t >= -kTol) & (t <= kOnePlusTol) &
                     (u >= -kTol) & (u <= kOnePlusTol);
      add_candidate(st, v ? p1x + t * d1x : 0.0f, v ? p1y + t * d1y : 0.0f,
                    v);
    }
  }
  // A's corners inside B, then B's corners inside A
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool v = inside(ax[i], ay[i], bx, by);
    add_candidate(st, v ? ax[i] + 0.0f * bx[0] : 0.0f,
                  v ? ay[i] + 0.0f * by[0] : 0.0f, v);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool v = inside(bx[j], by[j], ax, ay);
    add_candidate(st, v ? bx[j] + 0.0f * ax[0] : 0.0f,
                  v ? by[j] + 0.0f * ay[0] : 0.0f, v);
  }

  // slots centered on the centroid of all valid candidates
  const float inv_n = 1.0f / fmaxf(st.n, 1.0f);
  const float cx = st.sum_x * inv_n, cy = st.sum_y * inv_n;
  const float n_eff = fminf(st.n, 8.0f);
  float crx[8], cry[8], key[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const bool filled = (float)s < st.n;
    crx[s] = filled ? 0.0f + (st.x[s] - cx) : 0.0f;
    cry[s] = filled ? 0.0f + (st.y[s] - cy) : 0.0f;
    key[s] = (((float)s < n_eff) ? diamond_angle(cry[s], crx[s]) : 1e4f) +
             (float)(s * 1e-6);
  }
  // rank sort: rank[s] = #{t : key[t] < key[s]}; sorted[r] = the slots of
  // rank r, summed in slot order
  int rank[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    int r = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t != s) r += key[t] < key[s] ? 1 : 0;
    }
    rank[s] = r;
  }
  float srx[8], sry[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float sx = 0.0f, sy = 0.0f;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const bool hit = rank[s] == r;
      sx = sx + (hit ? crx[s] : 0.0f);
      sy = sy + (hit ? cry[s] : 0.0f);
    }
    srx[r] = sx;
    sry[r] = sy;
  }
  // masked shoelace over the first n_eff ranked slots, wrapping to slot 0
  float area2 = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const bool wrap = ((float)r + 1.0f) >= n_eff;
    const float nx = wrap ? srx[0] : srx[(r + 1) & 7];
    const float ny = wrap ? sry[0] : sry[(r + 1) & 7];
    const float crs = srx[r] * ny - sry[r] * nx;
    area2 = area2 + (((float)r < n_eff) ? crs : 0.0f);
  }
  const float area = 0.5f * fabsf(area2);
  return st.n >= 3.0f ? area : 0.0f;
}

// ---- the pair algos' common interface ----------------------------------

// T is Box, or BoxRec with the per-box quantities computed once (kernels B
// and C).
template <int kAlgo, class T>
__device__ __forceinline__ float inter_area(const T& a, const T& b) {
  if constexpr (kAlgo == kGreen2) {
    return inter_area_green_bframe(a, b);
  } else if constexpr (kAlgo == kCandidates) {
    return inter_area_candidates(a, b);
  } else {
    return inter_area_green(a, b);
  }
}

// IoU = inter / (A + B - inter + 1e-8), inter clamped to min(A, B).
template <int kAlgo, class T>
__device__ __forceinline__ float iou(const T& a, const T& b) {
  const float area_a = box_area(a);
  const float area_b = box_area(b);
  const float inter =
      nan_min(inter_area<kAlgo>(a, b), nan_min(area_a, area_b));
  return inter / (area_a + area_b - inter + kEps);
}

// ---- the near-pair test ---------------------------------------------------
//
// may_overlap(a, b) is false only for a pair whose kill is false whatever
// the pair algo computes, given thr >= 0 (the caller checks thr). Each box
// carries rad, and the pair is skipped iff R = rad_a + rad_b < 0 or
// dx^2 + dy^2 > R^2 (both false for a NaN R or d2):
//   * rad = -inf: a zero-area box (w * h == 0, every field finite). R is
//     -inf unless the other box has rad = +inf (then NaN: kept). Its pair
//     never kills: inter = min(I, min(0, B)) is 0, B (when B < 0) or NaN, so
//     inter * (1 + thr) > thr * (0 + B) is false for thr >= 0 (0 > thr*B
//     with B >= 0; B*(1+thr) > thr*B with B < 0, monotone rounding; NaN).
//     This covers the padding rows and the rows the decode zeroed.
//   * rad = +inf: a box with a NaN or inf field, a side below kMinSide or a
//     coordinate or side above kMaxCoord. Its pairs always take the
//     geometry (R is +inf or NaN).
//   * otherwise rad = r * 1.0001 + 1e-5 (|cx| + |cy|) + 1e-5, with r =
//     sqrt(hw^2 + hh^2) the circumradius.
// Two boxes of finite rad are skipped iff d2 > R^2, and their exact
// intersection is then 0 in every algo:
//   * green / green2 clip A's edges to B grown by sig and B's edges to A
//     shrunk by sig, sig = 1e-5 (0.5 (wa + ha + wb + hb) + |ox| + |oy|) <=
//     sqrt2 1e-5 (R0 + d) with R0 = ra + rb (w + h <= sqrt2 * 2r, |ox| +
//     |oy| <= sqrt2 d). Grown B lies within rb + sqrt2 sig of its centre,
//     and shrunk A within A, so the clipped windows are empty unless d <=
//     R0 + 2e-5 (R0 + d). Skipping needs d > 1.0001 R0, so R0 < d / 1.0001
//     and R0 + 2e-5 (R0 + d) < d (1 - 6e-5): a gap of 6e-5 d, hundreds of
//     f32 ulps of every offset the frame code forms (all of order d).
//   * candidates accept a point within 1e-6 of an edge's parameter range
//     (at most 2e-6 r of the edge) and a corner within tol / |e| =
//     1e-6 sqrt(|e|^2 + 1e-8) / |e| <= 1.005e-6 px of a side of length
//     |e| >= kMinSide; fewer than 3 accepted candidates give area 0. The
//     corners are formed in absolute coordinates, off by a few ulps of
//     |cx| + |cy|, which the 1e-5 (|cx| + |cy|) term covers; the 1e-5 px
//     covers the absolute tolerance. Sides below kMinSide would let tol/|e|
//     grow without bound (1e-10 / |e|), hence rad = +inf there.
//   * d2 and R^2 are each off by a few ulps (relative 1e-6 at most), far
//     inside the 1e-4 r slack; kMaxCoord keeps both finite.
// For thr < 0 or NaN a pair with inter 0 can kill (0 > thr * (A + B)), so
// the caller applies the test only when thr >= 0.
__device__ __forceinline__ float near_radius(float cx, float cy, float w,
                                             float h, float theta) {
  const bool finite = isfinite(cx) && isfinite(cy) && isfinite(w) &&
                      isfinite(h) && isfinite(theta);
  if (finite && w * h == 0.0f) return -__int_as_float(0x7f800000);  // -inf
  const bool plain = finite && w >= kMinSide && h >= kMinSide &&
                     w <= kMaxCoord && h <= kMaxCoord &&
                     fabsf(cx) <= kMaxCoord && fabsf(cy) <= kMaxCoord;
  if (!plain) return __int_as_float(0x7f800000);   // +inf
  const float hw = w * 0.5f, hh = h * 0.5f;
  const float r = sqrtf(hw * hw + hh * hh);
  return r * kRadRel + kRadCoord * (fabsf(cx) + fabsf(cy)) + kRadAbs;
}

__device__ __forceinline__ bool may_overlap(const Box& a, const Box& b) {
  const float dx = a.cx - b.cx, dy = a.cy - b.cy;
  const float d2 = dx * dx + dy * dy;
  const float r = a.rad + b.rad;
  return !(r < 0.0f || d2 > r * r);
}

// The near-pair test of kernel E, which writes values, not a predicate:
// iou_may_overlap(a, b) is false only for a pair whose IoU every pair algo
// computes as exactly +0. The pair is skipped iff d2 > R^2, R = rad_a +
// rad_b, with no R < 0 clause:
//   * both rad finite (each > 0): the pairs may_overlap skips, and no others.
//     Their windows are all empty (the derivation above), so every edge term
//     of green / green2 is +0 and the area nan_max(+0, 0) = +0; candidates
//     accept fewer than 3 points and return +0. Both areas are >= 1e-6 > 0
//     (sides >= kMinSide), so inter = nan_min(+0, min(A, B)) = +0 and IoU =
//     +0 / (A + B - 0 + 1e-8) = +0, the value the kernel's zeroed tile holds;
//   * one rad = -inf (a zero-area box): R = -inf, R^2 = +inf, and d2 > +inf
//     is false (d2 = +inf or NaN included): the pair takes the geometry. Its
//     value is not fixed without it: inter = nan_min(I, min(0, B)) is +0, -0,
//     B < 0 or NaN, where the algo's I may itself be NaN (1/0 edges);
//   * rad = +inf on either side: R = +inf or NaN, never skipped, as in
//     may_overlap.
__device__ __forceinline__ bool iou_may_overlap(const Box& a, const Box& b) {
  const float dx = a.cx - b.cx, dy = a.cy - b.cy;
  const float d2 = dx * dx + dy * dy;
  const float r = a.rad + b.rad;
  return !(d2 > r * r);
}

// Box idx of one image's (K, 5) boxes with its cos/sin and near-pair
// radius; rows past k are zero-area padding.
__device__ __forceinline__ void load_box(const float* boxes, const int* cls,
                                         int idx, int k, Box* out) {
  if (idx < k) {
    const float* p = boxes + (int64_t)idx * 5;
    out->cx = p[0];
    out->cy = p[1];
    out->w = p[2];
    out->h = p[3];
    out->ux = cosf(p[4]);
    out->uy = sinf(p[4]);
    out->cls = cls ? cls[idx] : 0;
    out->rad = near_radius(p[0], p[1], p[2], p[3], p[4]);
  } else {
    *out = Box{0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0,
               -__int_as_float(0x7f800000)};
  }
}

// Does pair (i, j) need the geometry? j > i, the same class and, for
// thr >= 0, may_overlap. Every other pair has kill = 0.
__device__ __forceinline__ bool live_pair(const Box& a, const Box& b, int i,
                                          int j, float thr) {
  if (j <= i || a.cls != b.cls) return false;
  return !(thr >= 0.0f) || may_overlap(a, b);
}

// inter * (1 + thr) > thr * (A + B), with inter clamped to min(A, B).
template <int kAlgo, class T>
__device__ __forceinline__ bool kill_predicate(const T& a, const T& b,
                                               float thr,
                                               float one_plus_thr) {
  const float area_a = box_area(a);
  const float area_b = box_area(b);
  const float inter =
      nan_min(inter_area<kAlgo>(a, b), nan_min(area_a, area_b));
  return inter * one_plus_thr > thr * (area_a + area_b);
}

// ---- pair tiles: the pair pass of kernels B (skew_kill.cu), C and E -----
//
// A block of kTileThreads threads owns a tile of kRows rows x kTileCols
// columns of one image's pairs. Its box records (BoxRec, the per-box
// quantities of the pair code) are formed once into shared memory
// (tile_load); step 1 (tile_collect_if) tests every pair with the kernel's
// predicate (~15 operations) and appends the survivors to a pair list in
// shared memory; step 2 (tile_drain_pairs) runs the geometry over that list
// densely, so no lane idles on a culled pair. Kernels B and C test j > i,
// class and may_overlap (tile_collect) and report each pair that kills
// (tile_drain), so their kill bits are equal; kernel E tests the range, the
// triangle and iou_may_overlap and stores each pair's IoU. The records of a
// box do not depend on the tile, so every kernel and every tile height
// computes a pair from the same values with the same operations.

constexpr int kTileCols = 64;
constexpr int kTileThreads = 256;
constexpr int kTileRowsPerPass = kTileThreads / kTileCols;   // 4 rows a pass
// fewer live 64-row tiles than these many per SM take 16- or 32-row tiles
constexpr int64_t kShortPerSm = 1, kHalfPerSm = 4;

// A tile's box records field by field, so that lanes reading different
// boxes hit different shared-memory banks.
template <int N>
struct TileBoxes {
  float cx[N], cy[N], w[N], h[N], ux[N], uy[N];
  int cls[N];
  float rad[N];
  float hw[N], hh[N], ox[4][N], oy[4][N], ex[2][N], ey[2][N], area[N];

  __device__ __forceinline__ void put(int t, const BoxRec& x) {
    cx[t] = x.cx;
    cy[t] = x.cy;
    w[t] = x.w;
    h[t] = x.h;
    ux[t] = x.ux;
    uy[t] = x.uy;
    cls[t] = x.cls;
    rad[t] = x.rad;
    hw[t] = x.hw;
    hh[t] = x.hh;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ox[c][t] = x.ox[c];
      oy[c][t] = x.oy[c];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ex[e][t] = x.ex[e];
      ey[e][t] = x.ey[e];
    }
    area[t] = x.area;
  }
  // the fields the near-pair test reads
  __device__ __forceinline__ Box get_box(int t) const {
    return Box{cx[t], cy[t], w[t], h[t], ux[t], uy[t], cls[t], rad[t]};
  }
  __device__ __forceinline__ BoxRec get(int t) const {
    BoxRec r;
    static_cast<Box&>(r) = get_box(t);
    r.hw = hw[t];
    r.hh = hh[t];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      r.ox[c] = ox[c][t];
      r.oy[c] = oy[c][t];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      r.ex[e] = ex[e][t];
      r.ey[e] = ey[e][t];
    }
    r.area = area[t];
    return r;
  }
};

template <int kRows>
struct PairTile {
  TileBoxes<kRows> rows;
  TileBoxes<kTileCols> cols;
  uint16_t pairs[kRows * kTileCols];   // (r << 6) | c
  int n_pairs;
};

// The records of rows row0.. of the (n, 5) boxes rows_b and of columns
// col0.. of the (m, 5) boxes cols_b (threads tid < kTileCols + kRows; rows
// past n or m are zero-area padding), and an empty pair list. The caller
// synchronises before step 1.
template <int kRows>
__device__ __forceinline__ void tile_load(PairTile<kRows>& t,
                                          const float* rows_b,
                                          const int* rows_cls, int n,
                                          const float* cols_b,
                                          const int* cols_cls, int m,
                                          int row0, int col0, int tid) {
  if (tid < kTileCols + kRows) {
    Box x;
    if (tid < kTileCols) {
      load_box(cols_b, cols_cls, col0 + tid, m, &x);
      t.cols.put(tid, make_rec(x));
    } else {
      load_box(rows_b, rows_cls, row0 + tid - kTileCols, n, &x);
      t.rows.put(tid - kTileCols, make_rec(x));
    }
  }
  if (tid == 0) t.n_pairs = 0;
}

// Kernels B and C: rows and columns of one image's (k, 5) boxes.
template <int kRows>
__device__ __forceinline__ void tile_load(PairTile<kRows>& t,
                                          const float* boxes_b,
                                          const int* cls_b, int k, int row0,
                                          int col0, int tid) {
  tile_load(t, boxes_b, cls_b, k, boxes_b, cls_b, k, row0, col0, tid);
}

// Step 1: each warp tests 32 neighbouring columns of one row per pass with
// live(rows, r, col, i, j) (the tile's row records, the row's index in the
// tile, the column's box, and the pair's row and column in the image) and
// appends the live pairs (ballot, popc prefix, one shared atomic per warp).
template <int kRows, class Live>
__device__ __forceinline__ void tile_collect_if(PairTile<kRows>& t, int row0,
                                                int col0, int tid,
                                                Live live_fn) {
  static_assert(kRows % kTileRowsPerPass == 0, "a pass covers 4 rows");
  const int lane = tid & 31;
  const int c = (tid / 32 % 2) * 32 + lane;   // this thread's column
  const int j = col0 + c;
  const Box col = t.cols.get_box(c);
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int r = tid / kTileCols; r < kRows; r += kTileRowsPerPass) {
    const int i = row0 + r;
    const bool live = live_fn(t.rows, r, col, i, j);
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (m == 0u) continue;                     // warp-uniform
    int base = 0;
    if (lane == 0) base = atomicAdd(&t.n_pairs, __popc(m));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (live) {
      t.pairs[base + __popc(m & lanes_below)] = (uint16_t)((r << 6) | c);
    }
  }
}

// Step 1 of kernels B and C: j > i, in range, the same class and, for
// thr >= 0, may_overlap.
template <int kRows>
__device__ __forceinline__ void tile_collect(PairTile<kRows>& t, int k,
                                             int row0, int col0, float thr,
                                             int tid) {
  tile_collect_if(t, row0, col0, tid,
                  [&](const TileBoxes<kRows>& rows, int r, const Box& col,
                      int i, int j) {
                    return i < k && j < k &&
                           live_pair(rows.get_box(r), col, i, j, thr);
                  });
}

// Step 2: the listed pairs, densely; pair(a, b, r, c) with the records of
// row r and column c for each.
template <int kRows, class F>
__device__ __forceinline__ void tile_drain_pairs(const PairTile<kRows>& t,
                                                 int tid, F pair) {
  const int n = t.n_pairs;
  for (int e = tid; e < n; e += kTileThreads) {
    const int p = t.pairs[e];
    const int pr = p >> 6, pc = p & (kTileCols - 1);
    pair(t.rows.get(pr), t.cols.get(pc), pr, pc);
  }
}

// Step 2 of kernels B and C: kill(r, c) for each pair that kills.
template <int kAlgo, int kRows, class F>
__device__ __forceinline__ void tile_drain(const PairTile<kRows>& t,
                                           float thr, float one_plus_thr,
                                           int tid, F kill) {
  tile_drain_pairs(t, tid,
                   [&](const BoxRec& a, const BoxRec& b, int r, int c) {
                     if (kill_predicate<kAlgo>(a, b, thr, one_plus_thr)) {
                       kill(r, c);
                     }
                   });
}

// Tile height from the live 64-row tiles per SM (tile_rows: n64 = b T (T +
// 1) / 2 for b images of k boxes, T = ceil(k / 64) column tiles; the SM
// count read from the current device): short_rows (16 for kernels B and C)
// below one per SM, 32 below four, else 64. More, smaller blocks spread a
// dense image (every pair near) over the card; larger tiles read fewer box
// records per pair, which sparse images need.
inline cudaError_t tile_rows_for(int64_t n64, int* rows,
                                 int short_rows = 16) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  *rows = n64 < kShortPerSm * sms ? short_rows
          : n64 < kHalfPerSm * sms ? 32 : 64;
  return cudaSuccess;
}

inline cudaError_t tile_rows(int64_t b, int k, int* rows) {
  const int64_t nt = (k + kTileCols - 1) / kTileCols;
  return tile_rows_for(b * nt * (nt + 1) / 2, rows);
}

}  // namespace skew_green
