// Exact rotated-rectangle intersection by Green's-theorem slab clipping, and
// the divide-free greedy-NMS kill predicate built on it. Device code shared
// by kernel B (skew_kill.cu) and kernel C (nms_greedy.cu), so both decide
// every pair with the same arithmetic.
//
// The intersection is rotate_yolov3_tpu/ops/skew_iou_green.py::
// inter_area_green written in the same operation order: the sigma shifts,
// the reciprocals shared by opposite edges, the clamp to min(A, B) and the
// divide-free predicate.
//
// Every source that includes this header is built with -fmad=false and
// without --use_fast_math, and uses cosf/sinf: contracting a*b+c into an
// FMA changes the parallel-edge products the Green code relies on (the TPU
// kernel was bitten by exactly this), and the code relies on IEEE 1/0 =
// +-inf for edges parallel to a slab. min/max below propagate NaN as
// jnp.minimum/torch.minimum do (fminf/fmaxf return the other operand): a
// NaN anywhere in a clip window must make hi > lo false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace skew_green {

constexpr float kSigRel = 1e-5f;

struct Box {
  float cx, cy, w, h, ux, uy;
  int cls;
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

__device__ inline float inter_area_green(const Box& a, const Box& b) {
  const float uax = a.ux, uay = a.uy, ubx = b.ux, uby = b.uy;
  const float ahw = a.w * 0.5f, ahh = a.h * 0.5f;
  const float bhw = b.w * 0.5f, bhh = b.h * 0.5f;
  float arx[4], ary[4], brx[4], bry[4];
  corner_offsets(a.w, a.h, uax, uay, arx, ary);
  corner_offsets(b.w, b.h, ubx, uby, brx, bry);
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
    const float eax = arx[k + 1] - arx[k], eay = ary[k + 1] - ary[k];
    ra[k][0] = 1.0f / (eax * ubx + eay * uby);
    ra[k][1] = 1.0f / (-eax * uby + eay * ubx);
    ra[k + 2][0] = -ra[k][0];
    ra[k + 2][1] = -ra[k][1];
    const float ebx = brx[k + 1] - brx[k], eby = bry[k + 1] - bry[k];
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

// Box idx of one image's (K, 5) boxes with its cos/sin; rows past k are
// zero-area padding.
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
  } else {
    *out = Box{0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0};
  }
}

// kill = j > i && cls_i == cls_j && inter * (1 + thr) > thr * (A + B), with
// inter clamped to min(A, B): row i (a, higher score) suppresses row j (b).
__device__ __forceinline__ bool kills(const Box& a, const Box& b, int i,
                                      int j, float thr, float one_plus_thr) {
  if (j <= i || a.cls != b.cls) return false;
  const float area_a = a.w * a.h;
  const float area_b = b.w * b.h;
  const float inter =
      nan_min(inter_area_green(a, b), nan_min(area_a, area_b));
  return inter * one_plus_thr > thr * (area_a + area_b);
}

}  // namespace skew_green
