// Greedy-NMS kill mask of score-sorted rotated boxes, batched over images:
// (B, K, 5) f32 boxes (cx, cy, w, h, theta) + optional (B, K) int32 class ids
// -> (B, K, K) int8, where
//
//   kill[b, i, j] = j > i  &&  cls_i == cls_j  &&  inter * (1 + thr) > thr * (A + B)
//
// with inter the exact rotated-rectangle intersection area clamped to
// min(A, B) (the divide-free form of IoU > thr).
//
// Replaces the TPU kernel rotate_yolov3_tpu/ops/skew_iou_pallas.py::
// skew_kill_matrix_pallas (body _kill_tile_kernel, algo "green"). The
// intersection is the Green's-theorem slab clipping of
// rotate_yolov3_tpu/ops/skew_iou_green.py::inter_area_green, written here in
// the same operation order: the sigma shifts, the reciprocals shared by
// opposite edges, the clamp to min(A, B) and the divide-free predicate.
//
// What bounds it on Hopper: arithmetic. Each live pair costs a few hundred
// flops and eight divides; there are about K^2 / 2 live pairs per image and
// only 5 floats of input per box. Design:
//   * one launch for the whole batch: grid (column tiles, row tiles, B), one
//     thread per pair (i, j), 32 columns x 8 rows per block, so a warp stores
//     32 neighbouring int8 entries of one row;
//   * the block's 8 row boxes and 32 column boxes, with their cos/sin, are
//     loaded once into shared memory, so each pair reads no device memory;
//   * a tile whose largest column is <= its smallest row lies at or below the
//     diagonal and only writes zeros (as the TPU kernel does), and pairs with
//     j <= i or different classes skip the geometry.
//
// Built with -fmad=false and without --use_fast_math, and with cosf/sinf:
// contracting a*b+c into an FMA changes the parallel-edge products the Green
// code relies on (the TPU kernel was bitten by exactly this), and the code
// relies on IEEE 1/0 = +-inf for edges parallel to a slab. min/max below
// propagate NaN as jnp.minimum/torch.minimum do (fminf/fmaxf return the
// other operand): a NaN anywhere in a clip window must make hi > lo false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 32;
constexpr int kTileRows = 8;
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

__device__ float inter_area_green(const Box& a, const Box& b) {
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

__global__ void skew_kill_kernel(const float* __restrict__ boxes,
                                 const int* __restrict__ cls,
                                 int8_t* __restrict__ out, int k, float thr,
                                 float one_plus_thr) {
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;
  const int i = row0 + threadIdx.y;
  const int j = col0 + threadIdx.x;
  int8_t* out_b = out + (int64_t)b * k * k;

  // strict upper triangle: the tile is dead unless its max column exceeds
  // its min row (block-uniform branch)
  if (col0 + kTileCols - 1 <= row0) {
    if (i < k && j < k) out_b[(int64_t)i * k + j] = 0;
    return;
  }

  __shared__ Box rows[kTileRows];
  __shared__ Box cols[kTileCols];
  const float* boxes_b = boxes + (int64_t)b * k * 5;
  const int* cls_b = cls ? cls + (int64_t)b * k : nullptr;
  const int tid = threadIdx.y * kTileCols + threadIdx.x;
  if (tid < kTileCols) {
    load_box(boxes_b, cls_b, col0 + tid, k, &cols[tid]);
  } else if (tid < kTileCols + kTileRows) {
    load_box(boxes_b, cls_b, row0 + tid - kTileCols, k,
             &rows[tid - kTileCols]);
  }
  __syncthreads();
  if (i >= k || j >= k) return;

  int8_t kill = 0;
  const Box& a = rows[threadIdx.y];
  const Box& bb = cols[threadIdx.x];
  if (j > i && a.cls == bb.cls) {
    const float area_a = a.w * a.h;
    const float area_b = bb.w * bb.h;
    const float inter =
        nan_min(inter_area_green(a, bb), nan_min(area_a, area_b));
    kill = inter * one_plus_thr > thr * (area_a + area_b) ? 1 : 0;
  }
  out_b[(int64_t)i * k + j] = kill;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). cls may be null
// (class-agnostic suppression).
extern "C" int skew_kill_launch(const void* boxes, const void* cls, void* out,
                                int b, int k, float thr, float one_plus_thr,
                                void* stream) {
  if (b == 0 || k == 0) return 0;
  const dim3 block(kTileCols, kTileRows);
  const dim3 grid((unsigned)((k + kTileCols - 1) / kTileCols),
                  (unsigned)((k + kTileRows - 1) / kTileRows), (unsigned)b);
  skew_kill_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)boxes, (const int*)cls, (int8_t*)out, k, thr,
      one_plus_thr);
  return (int)cudaGetLastError();
}
