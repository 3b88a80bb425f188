// Exact pairwise skew-IoU matrices of rotated boxes, batched over images:
// (B, N, 5) f32 boxes a and (B, M, 5) f32 boxes b (cx, cy, w, h, theta) ->
// (B, N, M) f32
//
//   iou[b, i, j] = inter / (A + B - inter + 1e-8),  inter clamped to min(A, B)
//
// by one of the three pair algos ("green", "green2", "candidates"; one
// template instance each, chosen at launch). With triangle set, every entry
// with j <= i is 0: greedy NMS reads only j > i, and the reference leaves
// that region unspecified (it zero-fills whole tiles at or below the
// diagonal).
//
// Replaces the TPU kernel rotate_yolov3_tpu/ops/skew_iou_pallas.py::
// skew_iou_matrix_pallas (body _iou_tile_kernel), the iou_matrix_fn drop-in
// of non_max_suppression. The reference calls it once per image under
// jax.vmap, which makes one pallas_call with a batch axis; here the batch is
// the grid's z axis, so a hooked NMS call is one launch, not B. The pair
// code and the pair-tile pass live in skew_green.cuh, shared with kernels B
// and C; see the note there on -fmad=false, cosf/sinf, IEEE division and
// NaN-propagating min/max.
//
// What bounds it on Hopper: the geometry of the pairs that can intersect
// (a few hundred fp32 operations and eight IEEE divides a pair for "green",
// about five times as many for "candidates"), or the 4 bytes written per
// pair (134 MB at B = 128, 512 x 512). Design, the pair-tile pass of
// kernels B and C:
//   * one launch for the batch, grid (column tiles, row tiles, images); a
//     block of 256 threads owns 64 columns and 8, 32 or 64 rows (the height
//     from the live 64-row tiles per SM, skew_green::tile_rows_for with 8
//     rows below one per SM: more, smaller blocks where there are few
//     tiles). Fixed heights in turns on an H100 (tools/de_ab.py
//     --variants, PERF.md): one 512 x 512 triangle (36 live tiles) 8 rows
//     0.0081 ms, 16 rows 0.0114, 32 0.0163, 64 0.0291 ("green"); 128
//     images of the serving boxes (4,608 live tiles) 64 rows 0.3605, 32
//     0.3739, 16 0.4162, 8 0.5101;
//   * the block's box records (fields, cos/sin, near-pair radius, half-dims,
//     corner offsets, two edges, area: skew_green::BoxRec) are formed once
//     into shared memory, not once per pair;
//   * step 1 lists the pairs that need the geometry: in range, j > i with
//     triangle, and iou_may_overlap. A pair it skips has IoU exactly +0
//     (the derivation beside iou_may_overlap in skew_green.cuh), the value
//     of the f32 tile in shared memory, which starts at zero; pairs with a
//     zero-area box always take the geometry, since their value may be NaN
//     or negative;
//   * step 2 drains the list densely, so no lane idles on a skipped pair or
//     waits on a costlier neighbour, and writes each IoU into the tile;
//   * step 3 writes the tile with one 16-byte store per four columns (rows
//     of 256 bytes, coalesced; scalar stores where M % 4 != 0 or at the
//     ragged edge). With triangle, a tile whose largest column is <= its
//     smallest row reads no boxes and writes its zeros the same way.
// The triangle and the full matrix decide each pair from the same records
// with the same operations, so they agree bit for bit above the diagonal.

#include "skew_green.cuh"

namespace {

using skew_green::Box;
using skew_green::BoxRec;
using skew_green::kTileCols;
using skew_green::kTileThreads;
using skew_green::PairTile;
using skew_green::TileBoxes;

constexpr int kChunks = kTileCols / 4;    // 16-byte chunks per tile row

// The tile (or zeros, src null) to rows row0.. and columns col0.. of one
// image's (n, m) matrix.
template <int kRows>
__device__ __forceinline__ void store_tile(float* out_b, int n, int m,
                                           int row0, int col0, int tid,
                                           const float* src) {
  for (int e = tid; e < kRows * kChunks; e += kTileThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 4;
    const int i = row0 + r, j = col0 + c;
    if (i >= n || j >= m) continue;
    float* dst = out_b + (int64_t)i * m + j;
    if ((m & 3) == 0 && j + 4 <= m) {
      *reinterpret_cast<float4*>(dst) =
          src ? *reinterpret_cast<const float4*>(src + r * kTileCols + c)
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      for (int t = 0; t < 4 && j + t < m; ++t) {
        dst[t] = src ? src[r * kTileCols + c + t] : 0.0f;
      }
    }
  }
}

template <int kAlgo, int kRows>
__global__ void __launch_bounds__(kTileThreads)
    skew_iou_matrix_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           float* __restrict__ out, int n, int m,
                           int triangle) {
  const int img = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kTileCols;
  const int tid = threadIdx.x;
  float* out_b = out + (int64_t)img * n * m;

  // at or below the diagonal: zeros only (block-uniform branch)
  if (triangle && col0 + kTileCols - 1 <= row0) {
    store_tile<kRows>(out_b, n, m, row0, col0, tid, nullptr);
    return;
  }

  __shared__ PairTile<kRows> t;
  __shared__ __align__(16) float tile[kRows * kTileCols];

  skew_green::tile_load(t, a + (int64_t)img * n * 5, nullptr, n,
                        b + (int64_t)img * m * 5, nullptr, m, row0, col0,
                        tid);
  for (int e = tid; e < kRows * kTileCols / 4; e += kTileThreads) {
    reinterpret_cast<float4*>(tile)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  // step 1: the pairs that need the geometry
  skew_green::tile_collect_if(
      t, row0, col0, tid,
      [&](const TileBoxes<kRows>& rows, int r, const Box& col, int i, int j) {
        return i < n && j < m && (!triangle || j > i) &&
               skew_green::iou_may_overlap(rows.get_box(r), col);
      });
  __syncthreads();

  // step 2: their IoU, densely
  skew_green::tile_drain_pairs(
      t, tid, [&](const BoxRec& x, const BoxRec& y, int r, int c) {
        tile[r * kTileCols + c] = skew_green::iou<kAlgo>(x, y);
      });
  __syncthreads();

  // step 3: the tile to device memory
  store_tile<kRows>(out_b, n, m, row0, col0, tid, tile);
}

template <int kAlgo, int kRows>
cudaError_t launch(const float* pa, const float* pb, float* o, int nb, int n,
                   int m, int triangle, cudaStream_t s) {
  const dim3 grid((unsigned)((m + kTileCols - 1) / kTileCols),
                  (unsigned)((n + kRows - 1) / kRows), (unsigned)nb);
  skew_iou_matrix_kernel<kAlgo, kRows>
      <<<grid, kTileThreads, 0, s>>>(pa, pb, o, n, m, triangle);
  return cudaGetLastError();
}

template <int kAlgo>
cudaError_t launch_rows(const float* pa, const float* pb, float* o, int nb,
                        int n, int m, int triangle, int rows,
                        cudaStream_t s) {
  if (rows == 8) return launch<kAlgo, 8>(pa, pb, o, nb, n, m, triangle, s);
  if (rows == 32) return launch<kAlgo, 32>(pa, pb, o, nb, n, m, triangle, s);
  return launch<kAlgo, 64>(pa, pb, o, nb, n, m, triangle, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). a is (nb, n, 5), b
// (nb, m, 5), out (nb, n, m); algo is skew_green::kGreen, kGreen2 or
// kCandidates.
extern "C" int skew_iou_matrix_launch(const void* a, const void* b, void* out,
                                      int nb, int n, int m, int triangle,
                                      int algo, void* stream) {
  if (nb == 0 || n == 0 || m == 0) return 0;
  if ((n + 7) / 8 > 65535 || nb > 65535) return (int)cudaErrorInvalidValue;
  // the 64-row tiles that compute pairs: with triangle, those with a column
  // above their first row
  const int64_t tr = (n + kTileCols - 1) / kTileCols;
  const int64_t tc = (m + kTileCols - 1) / kTileCols;
  int64_t live = 0;
  for (int64_t r = 0; r < tr; ++r) {
    live += !triangle ? tc : tc > r ? tc - r : 0;
  }
  int rows = 0;
  cudaError_t err = skew_green::tile_rows_for(nb * live, &rows, 8);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  float* o = (float*)out;
  switch (algo) {
    case skew_green::kGreen:
      err = launch_rows<skew_green::kGreen>(pa, pb, o, nb, n, m, triangle,
                                            rows, s);
      break;
    case skew_green::kGreen2:
      err = launch_rows<skew_green::kGreen2>(pa, pb, o, nb, n, m, triangle,
                                             rows, s);
      break;
    case skew_green::kCandidates:
      err = launch_rows<skew_green::kCandidates>(pa, pb, o, nb, n, m,
                                                 triangle, rows, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
