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
// skew_kill_matrix_pallas (body _kill_tile_kernel) with its three pair algos
// ("green", "green2", "candidates"), one template instance each, chosen at
// launch. The pair predicate and the intersections live in skew_green.cuh,
// shared with kernels C (nms_greedy.cu) and E (skew_iou_matrix.cu); see the
// note there on -fmad=false, cosf/sinf and NaN-propagating min/max.
//
// What bounds it on Hopper: arithmetic. Each live pair costs a few hundred
// flops and eight divides ("green"; "candidates" about three times that);
// there are about K^2 / 2 live pairs per image and only 5 floats of input
// per box. Design:
//   * one launch for the whole batch: grid (column tiles, row tiles, B), one
//     thread per pair (i, j), 32 columns x 8 rows per block, so a warp stores
//     32 neighbouring int8 entries of one row;
//   * the block's 8 row boxes and 32 column boxes, with their cos/sin, are
//     loaded once into shared memory, so each pair reads no device memory;
//   * a tile whose largest column is <= its smallest row lies at or below the
//     diagonal and only writes zeros (as the TPU kernel does), and pairs with
//     j <= i or different classes skip the geometry.

#include "skew_green.cuh"

namespace {

using skew_green::Box;

constexpr int kTileCols = 32;
constexpr int kTileRows = 8;

template <int kAlgo>
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
    skew_green::load_box(boxes_b, cls_b, col0 + tid, k, &cols[tid]);
  } else if (tid < kTileCols + kTileRows) {
    skew_green::load_box(boxes_b, cls_b, row0 + tid - kTileCols, k,
                         &rows[tid - kTileCols]);
  }
  __syncthreads();
  if (i >= k || j >= k) return;

  out_b[(int64_t)i * k + j] =
      skew_green::kills<kAlgo>(rows[threadIdx.y], cols[threadIdx.x], i, j, thr,
                        one_plus_thr)
          ? 1
          : 0;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). cls may be null
// (class-agnostic suppression); algo is skew_green::kGreen, kGreen2 or
// kCandidates.
extern "C" int skew_kill_launch(const void* boxes, const void* cls, void* out,
                                int b, int k, float thr, float one_plus_thr,
                                int algo, void* stream) {
  if (b == 0 || k == 0) return 0;
  const dim3 block(kTileCols, kTileRows);
  const dim3 grid((unsigned)((k + kTileCols - 1) / kTileCols),
                  (unsigned)((k + kTileRows - 1) / kTileRows), (unsigned)b);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* bx = (const float*)boxes;
  const int* cl = (const int*)cls;
  int8_t* o = (int8_t*)out;
  switch (algo) {
    case skew_green::kGreen:
      skew_kill_kernel<skew_green::kGreen>
          <<<grid, block, 0, s>>>(bx, cl, o, k, thr, one_plus_thr);
      break;
    case skew_green::kGreen2:
      skew_kill_kernel<skew_green::kGreen2>
          <<<grid, block, 0, s>>>(bx, cl, o, k, thr, one_plus_thr);
      break;
    case skew_green::kCandidates:
      skew_kill_kernel<skew_green::kCandidates>
          <<<grid, block, 0, s>>>(bx, cl, o, k, thr, one_plus_thr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
