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
// launch. The pair predicate, the intersections and the near-pair test live
// in skew_green.cuh, shared with kernels C (nms_greedy.cu) and E
// (skew_iou_matrix.cu).
//
// What bounds it on Hopper: the geometry of the pairs that can intersect,
// or the int8 output. A pair executes about 440 fp32 instructions with eight
// IEEE divides ("green", counted in the SASS; "candidates" about five times
// as many), but on detection boxes only a small share of the pairs j > i
// lie close enough to intersect: two boxes whose circumcircles (plus a
// margin) are apart have an intersection of exactly 0 and, for thr >= 0,
// cannot kill (may_overlap in skew_green.cuh, with the derivation of the
// margin). So the bound is max(near pairs x instructions per pair / fp32
// instruction rate, B K^2 bytes of output / memory rate); on uniform or
// clustered boxes at K = 512 both are tens of microseconds at B = 128. Culling per thread would not help: a warp
// holds 32 pairs, and most warps hold at least one near pair, so an early
// exit leaves the warp paying the full geometry. The design compacts the
// near pairs instead:
//   * one launch for the whole batch; a block of 256 threads owns a tile of
//     64 rows x 64 columns of one image (16 pairs per thread), and its 128
//     box records are computed once into shared memory: the fields,
//     cos/sin, class and near-pair radius, and the quantities of the pair
//     code that depend on one box alone (half-dims, corner offsets, two
//     edges, area; skew_green::BoxRec), so step 2 reads them instead of
//     forming them per pair. Small batches take shorter tiles, chosen by
//     the live 64-row tiles per SM (n64 = B * T (T + 1) / 2 for T = K / 64
//     column tiles, the SM count read from the device): 16 rows x 64
//     columns below one per SM (on an H100 B = 8 at K = 128), 32 rows
//     below four (B = 8 at K = 512, B = 128 at K = 128). More, smaller
//     blocks spread a dense image (every pair near) over the card; larger
//     tiles read fewer box records per pair, which sparse images need.
//     On the H100 the shape-only rule cannot see the density, so it costs
//     up to 1.33x against the best height on a sparse case and 1.09x on a
//     dense one at those shapes (PERF.md, tools/kill_ab.py);
//   * step 1: each warp tests 32 neighbouring pairs of one row at a time
//     (j > i, class, may_overlap: ~15 operations) and appends the survivors
//     to a pair list in shared memory (ballot, popc prefix, one shared
//     atomic per warp); the block also zeroes its int8 tile in shared
//     memory;
//   * step 2: all 256 threads drain the list densely through the geometry
//     and set the tile's bytes, so no lane idles on a culled pair;
//     (the records, steps 1 and 2 and the tile rule are skew_green.cuh's
//     pair-tile pass, which kernel C runs too);
//   * step 3: the 64 x 64 tile leaves as one 16-byte store per thread
//     (rows of 64 bytes, coalesced), byte stores where K is not a multiple
//     of 16 or the tile overhangs K;
//   * a tile whose largest column is <= its smallest row lies at or below
//     the diagonal: it reads no boxes and writes its zeros as 16-byte stores.
// Every source that includes skew_green.cuh is built with -fmad=false:
// exactness relies on one rounding per operation (the note at the top of
// skew_green.cuh), so the kernel gains by doing fewer operations, not by
// contracting them.

#include "skew_green.cuh"

namespace {

using skew_green::kTileCols;
using skew_green::kTileThreads;
using skew_green::PairTile;

constexpr int kChunks = kTileCols / 16;    // 16-byte chunks per tile row

// Thread tid's 16-byte chunk of a tile of kRows rows: row tid / 4, bytes
// 16 (tid % 4).. Vector store where the chunk is whole and aligned (k % 16
// == 0), else byte stores of the columns below k.
template <int kRows>
__device__ __forceinline__ void store_chunk(int8_t* out_b, int k, int row0,
                                            int col0, int tid,
                                            const int8_t* src) {
  if (tid >= kRows * kChunks) return;
  const int r = tid / kChunks;
  const int c = (tid % kChunks) * 16;
  const int i = row0 + r, j = col0 + c;
  if (i >= k || j >= k) return;
  int8_t* dst = out_b + (int64_t)i * k + j;
  if ((k & 15) == 0 && j + 16 <= k) {
    *reinterpret_cast<int4*>(dst) =
        src ? *reinterpret_cast<const int4*>(src + r * kTileCols + c)
            : make_int4(0, 0, 0, 0);
  } else {
    for (int t = 0; t < 16 && j + t < k; ++t) {
      dst[t] = src ? src[r * kTileCols + c + t] : (int8_t)0;
    }
  }
}

template <int kAlgo, int kRows>
__global__ void __launch_bounds__(kTileThreads)
    skew_kill_kernel(const float* __restrict__ boxes,
                     const int* __restrict__ cls, int8_t* __restrict__ out,
                     int k, float thr, float one_plus_thr) {
  static_assert(kRows * kChunks <= kTileThreads,
                "one 16-byte chunk per thread");
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kTileCols;
  const int tid = threadIdx.x;
  int8_t* out_b = out + (int64_t)b * k * k;

  // at or below the diagonal: zeros only (block-uniform branch)
  if (col0 + kTileCols - 1 <= row0) {
    store_chunk<kRows>(out_b, k, row0, col0, tid, nullptr);
    return;
  }

  __shared__ PairTile<kRows> t;
  __shared__ __align__(16) int8_t tile[kRows * kTileCols];

  skew_green::tile_load(t, boxes + (int64_t)b * k * 5,
                        cls ? cls + (int64_t)b * k : nullptr, k, row0, col0,
                        tid);
  if (tid < kRows * kTileCols / 16) {
    reinterpret_cast<int4*>(tile)[tid] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  // step 1: the live pairs into the list
  skew_green::tile_collect(t, k, row0, col0, thr, tid);
  __syncthreads();

  // step 2: the near pairs, densely
  skew_green::tile_drain<kAlgo>(t, thr, one_plus_thr, tid,
                                [&](int r, int c) {
                                  tile[r * kTileCols + c] = 1;
                                });
  __syncthreads();

  // step 3: the tile to device memory
  store_chunk<kRows>(out_b, k, row0, col0, tid, tile);
}

template <int kAlgo, int kRows>
cudaError_t launch(const float* bx, const int* cl, int8_t* o, int b, int k,
                   float thr, float one_plus_thr, cudaStream_t s) {
  const dim3 grid((unsigned)((k + kTileCols - 1) / kTileCols),
                  (unsigned)((k + kRows - 1) / kRows), (unsigned)b);
  skew_kill_kernel<kAlgo, kRows>
      <<<grid, kTileThreads, 0, s>>>(bx, cl, o, k, thr, one_plus_thr);
  return cudaGetLastError();
}

template <int kAlgo>
cudaError_t launch_rows(const float* bx, const int* cl, int8_t* o, int b,
                        int k, float thr, float one_plus_thr, int rows,
                        cudaStream_t s) {
  if (rows == 16) {
    return launch<kAlgo, 16>(bx, cl, o, b, k, thr, one_plus_thr, s);
  }
  if (rows == 32) {
    return launch<kAlgo, 32>(bx, cl, o, b, k, thr, one_plus_thr, s);
  }
  return launch<kAlgo, 64>(bx, cl, o, b, k, thr, one_plus_thr, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). cls may be null
// (class-agnostic suppression); algo is skew_green::kGreen, kGreen2 or
// kCandidates.
extern "C" int skew_kill_launch(const void* boxes, const void* cls, void* out,
                                int b, int k, float thr, float one_plus_thr,
                                int algo, void* stream) {
  if (b == 0 || k == 0) return 0;
  const int64_t nt = (k + kTileCols - 1) / kTileCols;
  if (nt * 4 > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  int rows = 0;
  cudaError_t err = skew_green::tile_rows(b, k, &rows);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* bx = (const float*)boxes;
  const int* cl = (const int*)cls;
  int8_t* o = (int8_t*)out;
  switch (algo) {
    case skew_green::kGreen:
      err = launch_rows<skew_green::kGreen>(bx, cl, o, b, k, thr,
                                            one_plus_thr, rows, s);
      break;
    case skew_green::kGreen2:
      err = launch_rows<skew_green::kGreen2>(bx, cl, o, b, k, thr,
                                             one_plus_thr, rows, s);
      break;
    case skew_green::kCandidates:
      err = launch_rows<skew_green::kCandidates>(bx, cl, o, b, k, thr,
                                                 one_plus_thr, rows, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
