// Fused greedy rotated NMS, batched over images: (B, K, 5) f32 score-sorted
// boxes (cx, cy, w, h, theta) + optional (B, K) int32 class ids + (B, K)
// bool valid -> (B, K) bool keep, in one launch. The keep mask equals the
// kill mask of kernel B (skew_kill.cu) followed by the greedy fixpoint
// (ops/rotated_nms.py::greedy_suppress_fixpoint_kill): the pair predicate is
// the same device code (skew_green.cuh, built with the same flags), and the
// sequential greedy walk below is the fixpoint's unique solution (see
// rotate_yolov3_tpu/ops/rotated_nms.py::greedy_suppress_fixpoint).
//
// Replaces the TPU kernel rotate_yolov3_tpu/ops/nms_pallas.py::
// nms_greedy_pallas (body _nms_kernel), with its two pair algos ("green",
// "green2"; one template instance each). That kernel carries a (K, K) VMEM
// scratch across sequential grid steps and runs the fixpoint as MXU matvecs
// on the last step. CUDA blocks run in no order, so here:
//   * one launch per call, grid (tile pairs, B): each block evaluates a tile
//     of 32 rows x 32 columns (one thread per pair, four rows per warp) and
//     packs each row's 32 kill bits into one uint32 with a warp ballot. The
//     bits go to a (B, K, ceil(K/32)) uint32 scratch: 128 KiB per image at
//     K = 1024, which stays in L2. Tiles at or below the diagonal compute
//     nothing: the walk never reads their words;
//   * every block then counts itself done on a per-image counter (after a
//     __threadfence), and the block that finishes LAST for image b runs the
//     greedy pass for b (the TPU's "last grid step");
//   * the greedy pass is one warp: lane w holds the removed-bits word w
//     (K/32 <= 32 words). For i = 0..K-1 in order, row i is kept iff
//     valid_i and not removed_i, and a kept row ORs its words into removed.
//     Row words arrive 32 rows at a time into registers, the next 32 loaded
//     while the current 32 are walked, so the walk waits on L2 only once;
//   * the launch function zeroes the counters on the stream before the
//     kernel, so a scratch buffer can be reused across calls.
//
// What bounds it on Hopper: the pair geometry (a few hundred flops and
// eight divides per live pair, ~K^2/2 live pairs per image) for large B;
// at B = 1 the sequential walk (K dependent steps of a warp shuffle) on one
// SM. Bit-packing keeps the mask 8x smaller than kernel B's int8 mask.

#include "skew_green.cuh"

namespace {

using skew_green::Box;

constexpr int kTile = 32;        // rows and columns of a tile; bits per word
constexpr int kWarps = 8;        // warps per block, kTile / kWarps rows each
constexpr int kMaxK = 1024;      // kMaxK / 32 words fit one warp's lanes
constexpr unsigned kFull = 0xffffffffu;

// Words c.. of row-chunk c (rows 32c..32c+31) for this lane; words left of
// the chunk's diagonal word belong to tiles that were never computed.
__device__ __forceinline__ void load_chunk(const uint32_t* mask_b, int c,
                                           int k, int nw, int lane,
                                           uint32_t words[kTile]) {
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    const int i = c * kTile + r;
    words[r] = (lane >= c && lane < nw && i < k)
                   ? __ldcg(mask_b + (int64_t)i * nw + lane)
                   : 0u;
  }
}

template <int kAlgo>
__global__ void __launch_bounds__(kTile * kWarps)
    nms_greedy_kernel(const float* __restrict__ boxes,
                      const int* __restrict__ cls,
                      const uint8_t* __restrict__ valid,
                      uint32_t* __restrict__ mask,
                      unsigned* __restrict__ done,
                      uint8_t* __restrict__ keep, int k, float thr,
                      float one_plus_thr) {
  const int b = blockIdx.y;
  const int nw = (k + kTile - 1) / kTile;
  const int row0 = (blockIdx.x / nw) * kTile;
  const int tc = blockIdx.x % nw;
  const int col0 = tc * kTile;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  uint32_t* mask_b = mask + (int64_t)b * k * nw;

  __shared__ Box rows[kTile];
  __shared__ Box cols[kTile];
  __shared__ bool last;

  // strict upper triangle: the tile is live iff its max column exceeds its
  // min row (block-uniform branch)
  if (col0 + kTile - 1 > row0) {
    const float* boxes_b = boxes + (int64_t)b * k * 5;
    const int* cls_b = cls ? cls + (int64_t)b * k : nullptr;
    const int tid = warp * kTile + lane;
    if (tid < kTile) {
      skew_green::load_box(boxes_b, cls_b, col0 + tid, k, &cols[tid]);
    } else if (tid < 2 * kTile) {
      skew_green::load_box(boxes_b, cls_b, row0 + tid - kTile, k,
                           &rows[tid - kTile]);
    }
    __syncthreads();
    const int j = col0 + lane;
    for (int r = warp; r < kTile; r += kWarps) {
      const int i = row0 + r;
      const bool kill = i < k && j < k &&
                        skew_green::kills<kAlgo>(rows[r], cols[lane], i, j,
                                                 thr, one_plus_thr);
      const uint32_t word = __ballot_sync(kFull, kill);
      if (lane == 0 && i < k) mask_b[(int64_t)i * nw + tc] = word;
    }
    __threadfence();
  }
  __syncthreads();
  if (warp == 0 && lane == 0) {
    last = atomicAdd(done + b, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || warp != 0) return;
  __threadfence();

  // greedy pass over image b, one warp
  const uint8_t* valid_b = valid + (int64_t)b * k;
  uint32_t valid_w = 0;
  for (int w = 0; w < nw; ++w) {
    const int idx = w * kTile + lane;
    const uint32_t word = __ballot_sync(kFull, idx < k && valid_b[idx]);
    if (lane == w) valid_w = word;
  }
  uint8_t* keep_b = keep + (int64_t)b * k;
  uint32_t removed = 0;
  uint32_t cur[kTile], nxt[kTile];
  load_chunk(mask_b, 0, k, nw, lane, cur);
  for (int c = 0; c < nw; ++c) {
    load_chunk(mask_b, c + 1, k, nw, lane, nxt);
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const uint32_t alive_w = __shfl_sync(kFull, valid_w & ~removed, c);
      const bool alive = (alive_w >> r) & 1u;
      if (alive) removed |= cur[r];
      const int i = c * kTile + r;
      if (lane == 0 && i < k) keep_b[i] = alive ? 1 : 0;
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r) cur[r] = nxt[r];
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). cls may be null
// (class-agnostic suppression). mask holds b * k * ceil(k / 32) uint32
// words, done b counters; both are scratch the kernel overwrites. algo is
// skew_green::kGreen or kGreen2.
extern "C" int nms_greedy_launch(const void* boxes, const void* cls,
                                 const void* valid, void* mask, void* done,
                                 void* keep, int b, int k, float thr,
                                 float one_plus_thr, int algo,
                                 void* stream) {
  if (b == 0 || k == 0) return 0;
  if (k > kMaxK || b > 65535 ||
      (algo != skew_green::kGreen && algo != skew_green::kGreen2)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned) * b, s);
  if (err != cudaSuccess) return (int)err;
  const int nw = (k + kTile - 1) / kTile;
  const dim3 block(kTile, kWarps);
  const dim3 grid((unsigned)(nw * nw), (unsigned)b);
  const float* bx = (const float*)boxes;
  const int* cl = (const int*)cls;
  const uint8_t* va = (const uint8_t*)valid;
  if (algo == skew_green::kGreen2) {
    nms_greedy_kernel<skew_green::kGreen2><<<grid, block, 0, s>>>(
        bx, cl, va, (uint32_t*)mask, (unsigned*)done, (uint8_t*)keep, k, thr,
        one_plus_thr);
  } else {
    nms_greedy_kernel<skew_green::kGreen><<<grid, block, 0, s>>>(
        bx, cl, va, (uint32_t*)mask, (unsigned*)done, (uint8_t*)keep, k, thr,
        one_plus_thr);
  }
  return (int)cudaGetLastError();
}
