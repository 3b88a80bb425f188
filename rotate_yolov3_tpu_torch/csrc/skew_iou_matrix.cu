// Exact pairwise skew-IoU matrix of rotated boxes: (N, 5) f32 boxes a and
// (M, 5) f32 boxes b (cx, cy, w, h, theta) -> (N, M) f32
//
//   iou[i, j] = inter / (A + B - inter + 1e-8),  inter clamped to min(A, B)
//
// by one of the three pair algos ("green", "green2", "candidates"; one
// template instance each, chosen at launch). With triangle set, every entry
// with j <= i is 0: greedy NMS reads only j > i, and the reference leaves
// that region unspecified (it zero-fills whole tiles at or below the
// diagonal).
//
// Replaces the TPU kernel rotate_yolov3_tpu/ops/skew_iou_pallas.py::
// skew_iou_matrix_pallas (body _iou_tile_kernel), the iou_matrix_fn drop-in
// of non_max_suppression. The pair code lives in skew_green.cuh, shared with
// kernels B and C; see the note there on -fmad=false, cosf/sinf, IEEE
// division and NaN-propagating min/max.
//
// What bounds it on Hopper: arithmetic ("green": a few hundred flops and
// eight divides per pair; "candidates" about three times that) and, for
// small pairs counts, the 4 bytes written per pair (1 MiB at 512 x 512).
// Design, as kernel B: one thread per pair, 32 columns x 8 rows per block
// so a warp writes 128 contiguous bytes of one row; the block's 8 a-boxes
// and 32 b-boxes with their cos/sin are loaded once into shared memory;
// with triangle, a tile entirely at or below the diagonal only writes
// zeros.

#include "skew_green.cuh"

namespace {

using skew_green::Box;

constexpr int kTileCols = 32;
constexpr int kTileRows = 8;

template <int kAlgo>
__global__ void skew_iou_matrix_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float* __restrict__ out, int n, int m,
                                       int triangle) {
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;
  const int i = row0 + threadIdx.y;
  const int j = col0 + threadIdx.x;

  if (triangle && col0 + kTileCols - 1 <= row0) {  // block-uniform
    if (i < n && j < m) out[(int64_t)i * m + j] = 0.0f;
    return;
  }

  __shared__ Box rows[kTileRows];
  __shared__ Box cols[kTileCols];
  const int tid = threadIdx.y * kTileCols + threadIdx.x;
  if (tid < kTileCols) {
    skew_green::load_box(b, nullptr, col0 + tid, m, &cols[tid]);
  } else if (tid < kTileCols + kTileRows) {
    skew_green::load_box(a, nullptr, row0 + tid - kTileCols, n,
                         &rows[tid - kTileCols]);
  }
  __syncthreads();
  if (i >= n || j >= m) return;

  out[(int64_t)i * m + j] =
      (triangle && j <= i)
          ? 0.0f
          : skew_green::iou<kAlgo>(rows[threadIdx.y], cols[threadIdx.x]);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). algo is
// skew_green::kGreen, kGreen2 or kCandidates.
extern "C" int skew_iou_matrix_launch(const void* a, const void* b, void* out,
                                      int n, int m, int triangle, int algo,
                                      void* stream) {
  if (n == 0 || m == 0) return 0;
  if ((n + kTileRows - 1) / kTileRows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kTileCols, kTileRows);
  const dim3 grid((unsigned)((m + kTileCols - 1) / kTileCols),
                  (unsigned)((n + kTileRows - 1) / kTileRows));
  const cudaStream_t s = (cudaStream_t)stream;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  float* o = (float*)out;
  switch (algo) {
    case skew_green::kGreen:
      skew_iou_matrix_kernel<skew_green::kGreen>
          <<<grid, block, 0, s>>>(pa, pb, o, n, m, triangle);
      break;
    case skew_green::kGreen2:
      skew_iou_matrix_kernel<skew_green::kGreen2>
          <<<grid, block, 0, s>>>(pa, pb, o, n, m, triangle);
      break;
    case skew_green::kCandidates:
      skew_iou_matrix_kernel<skew_green::kCandidates>
          <<<grid, block, 0, s>>>(pa, pb, o, n, m, triangle);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
