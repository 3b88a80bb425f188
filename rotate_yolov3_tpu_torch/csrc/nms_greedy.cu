// Fused greedy rotated NMS, batched over images: (B, K, 5) f32 score-sorted
// boxes (cx, cy, w, h, theta) + optional (B, K) int32 class ids + (B, K)
// bool valid -> (B, K) bool keep, in one launch. The keep mask equals the
// kill mask of kernel B (skew_kill.cu) followed by the greedy fixpoint
// (ops/rotated_nms.py::greedy_suppress_fixpoint_kill): both kernels decide
// each pair with skew_green.cuh's pair-tile pass (built with the same
// flags), and the sequential greedy walk below is the fixpoint's unique
// solution (see rotate_yolov3_tpu/ops/rotated_nms.py::
// greedy_suppress_fixpoint).
//
// Replaces the TPU kernel rotate_yolov3_tpu/ops/nms_pallas.py::
// nms_greedy_pallas (body _nms_kernel), with its two pair algos ("green",
// "green2"; one template instance each). That kernel carries a (K, K) VMEM
// scratch across sequential grid steps and runs the fixpoint as MXU matvecs
// on the last step. CUDA blocks run in no order, so here one launch holds
// two passes: a pair pass over the whole batch, then, in the block that
// finishes last for an image, that image's greedy walk.
//
// What bounds it on Hopper: at large B the geometry of the near pairs (the
// pair pass is kernel B's); at B = 1 (the DOTA merge, K = 1024) neither
// bytes (26 KB) nor operations (a thousand near pairs at 15 classes) but
// latency: the launch, one wave of tiles, the handoff and a walk that is
// sequential by nature. The design keeps each of those short:
//   * pair pass: blocks only for the live tiles (those with a column above
//     the diagonal; kernel B's tiles of 16, 32 or 64 rows x 64 columns,
//     skew_green::tile_rows), grid (live tiles, B). Each block runs the
//     shared pass (box records once per box, near pairs compacted into a
//     list, the list drained densely) and ORs the kills into a shared
//     2-word-per-row bit tile. It stores the words into a (B, K, ldm)
//     uint32 scratch (ldm = ceil(K / 32) rounded up to 4 words, so rows
//     are 16-byte aligned) and sets a row's summary bit in a (B, nw) word
//     array when the row kills past its own chunk's word (chunk c: rows
//     32c..32c+31, diagonal word c);
//   * handoff: every block counts itself done on a per-image counter after
//     a __threadfence, and the last one walks. The counters and summary
//     words live in a buffer the wrapper keeps per device and stream; the
//     walking block returns both to zero, so no memset runs before a call;
//   * staging: the walking block copies, with cp.async.cg (16 bytes, L2
//     only: other blocks' words are not in this SM's L1), the words past
//     the diagonal of every row with a summary bit into shared memory (a
//     triangle, chunk by chunk: 68 KiB at K = 1024, opted in above 48 KiB),
//     the diagonal words of all rows beside them, and the valid bits;
//   * walk, one warp, chunk by chunk (nw <= 32 steps instead of K): lane w
//     holds the removed bits of chunk w. For chunk c the warp takes
//     alive = valid & ~removed, then resolves the chunk in order among its
//     rows whose diagonal word is not zero (__ffs over a ballot; a row
//     that kills nothing inside its chunk costs nothing), writes the 32
//     keep bytes, and each lane ORs into its removed word the staged words
//     of the kept rows with a summary bit, four rows per step. Rows that
//     kill nothing cost nothing.
// Every source that includes skew_green.cuh is built with -fmad=false (the
// note at the top of the header).

#include "skew_green.cuh"

namespace {

using skew_green::kTileCols;
using skew_green::kTileThreads;
using skew_green::PairTile;

constexpr int kWord = 32;             // kill bits per word; rows per chunk
constexpr int kMaxK = 1024;           // kMaxK / 32 words fit one warp's lanes
constexpr int kMaxWords = kMaxK / kWord;
constexpr int kWarps = kTileThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Row stride of the mask scratch, in words: 16-byte aligned rows.
__host__ __device__ __forceinline__ int mask_ld(int nw) {
  return (nw + 3) & ~3;
}

// 16-byte groups chunk c stages per row: those holding its words past the
// diagonal word c, groups (c + 1) / 4 .. ldm / 4 - 1.
__host__ __device__ __forceinline__ int staged_groups(int c, int nw) {
  return mask_ld(nw) / 4 - (c + 1) / 4;
}

// Bytes of the staged triangle of an image of nw chunks.
int staged_bytes(int nw) {
  int groups = 0;
  for (int c = 0; c < nw; ++c) groups += staged_groups(c, nw);
  return groups * kWord * 16;
}

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// What the walking block keeps in shared memory besides the triangle.
struct WalkState {
  uint32_t diag[kMaxWords][kWord];   // diag[c][r]: word c of row 32c + r
  uint32_t summ[kMaxWords];          // rows killing past their chunk's word
  uint32_t valid[kMaxWords];
  int base[kMaxWords];               // chunk c's offset in the triangle
};

template <int kAlgo, int kRows>
__global__ void __launch_bounds__(kTileThreads)
    nms_greedy_kernel(const float* __restrict__ boxes,
                      const int* __restrict__ cls,
                      const uint8_t* __restrict__ valid,
                      uint32_t* __restrict__ mask,
                      unsigned* __restrict__ done,
                      uint32_t* __restrict__ summary,
                      uint8_t* __restrict__ keep, int k, float thr,
                      float one_plus_thr) {
  const int b = blockIdx.y;
  const int nw = (k + kWord - 1) / kWord;
  const int ldm = mask_ld(nw);
  const int tiles_c = (k + kTileCols - 1) / kTileCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  uint32_t* mask_b = mask + (int64_t)b * k * ldm;
  uint32_t* summary_b = summary + (int64_t)b * nw;

  // live tile blockIdx.x of the image: row tiles in order, each from its
  // first column tile above the diagonal (64 c + 63 > 16 q always holds for
  // c = row0 / 64, never for c = row0 / 64 - 1)
  int t = blockIdx.x, rt = 0;
  for (;; ++rt) {
    const int n = tiles_c - rt * kRows / kTileCols;
    if (t < n) break;
    t -= n;
  }
  const int row0 = rt * kRows;
  const int col0 = (row0 / kTileCols + t) * kTileCols;

  __shared__ union {
    PairTile<kRows> tile;
    WalkState walk;
  } sm;
  __shared__ uint32_t bits[kRows][2];
  __shared__ bool last;
  extern __shared__ __align__(16) uint32_t staged[];

  // the pair pass
  skew_green::tile_load(sm.tile, boxes + (int64_t)b * k * 5,
                        cls ? cls + (int64_t)b * k : nullptr, k, row0, col0,
                        tid);
  if (tid < 2 * kRows) bits[tid / 2][tid % 2] = 0u;
  __syncthreads();
  skew_green::tile_collect(sm.tile, k, row0, col0, thr, tid);
  __syncthreads();
  skew_green::tile_drain<kAlgo>(sm.tile, thr, one_plus_thr, tid,
                                [&](int r, int c) {
                                  atomicOr(&bits[r][c / kWord],
                                           1u << (c % kWord));
                                });
  __syncthreads();
  // thread r stores row r's two words; rows that kill past their own
  // chunk's word set their summary bits, one atomic per warp
  if (warp * kWord < kRows) {                  // warp-uniform
    const int r = warp * kWord + lane;
    const int i = row0 + r;
    bool beyond = false;
    if (r < kRows && i < k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = col0 / kWord + h;
        if (w < nw) {
          const uint32_t word = bits[r][h];
          mask_b[(int64_t)i * ldm + w] = word;
          beyond = beyond || (word != 0u && w > i / kWord);
        }
      }
    }
    const unsigned m = __ballot_sync(kFull, beyond);
    const int first = row0 + warp * kWord;
    if (lane == 0 && m != 0u) {
      atomicOr(summary_b + first / kWord, m << (first % kWord));
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + b, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the walk of image b: state, with the counter and summaries back to 0
  WalkState& ws = sm.walk;
  if (tid < nw) {
    ws.summ[tid] = atomicExch(summary_b + tid, 0u);
    int base = 0;
    for (int c = 0; c < tid; ++c) base += staged_groups(c, nw) * kWord * 4;
    ws.base[tid] = base;
  }
  if (tid == 0) done[b] = 0u;
  for (int w = warp; w < nw; w += kWarps) {
    const int i = w * kWord + lane;
    const unsigned v =
        __ballot_sync(kFull, i < k && valid[(int64_t)b * k + i] != 0);
    if (lane == 0) ws.valid[w] = v;
  }
  for (int i = tid; i < nw * kWord; i += kTileThreads) {
    ws.diag[i / kWord][i % kWord] =
        i < k ? __ldcg(mask_b + (int64_t)i * ldm + i / kWord) : 0u;
  }
  __syncthreads();
  // the words past the diagonal of every row with a summary bit: item e
  // of chunk c is row e / ng, group e % ng (at most 8 groups of 32 rows)
  for (int c = 0; c + 1 < nw; ++c) {
    const int g0 = (c + 1) / 4, ng = staged_groups(c, nw);
    const int r = tid / ng, g = tid - r * ng;
    if (r < kWord && (ws.summ[c] >> r & 1u)) {
      copy16_async(staged + ws.base[c] + (r * ng + g) * 4,
                   mask_b + (int64_t)(c * kWord + r) * ldm + (g0 + g) * 4);
    }
  }
  wait_async();
  __syncthreads();
  if (warp != 0) return;

  uint8_t* keep_b = keep + (int64_t)b * k;
  const uint32_t valid_w = lane < nw ? ws.valid[lane] : 0u;
  uint32_t removed = 0u;   // lane w: rows of chunk w removed so far
  for (int c = 0; c < nw; ++c) {
    uint32_t alive = __shfl_sync(kFull, valid_w & ~removed, c);
    const uint32_t d = ws.diag[c][lane];
    // rows that kill inside the chunk, in order (warp-uniform loop)
    uint32_t m = alive & __ballot_sync(kFull, d != 0u);
    while (m != 0u) {
      const int r = __ffs(m) - 1;
      alive &= ~__shfl_sync(kFull, d, r);
      m &= (m - 1u) & alive;
    }
    const int i = c * kWord + lane;
    if (i < k) keep_b[i] = (uint8_t)(alive >> lane & 1u);
    // kept rows that kill past the chunk: their staged words, four rows a
    // step (a repeated row ORs the same word again)
    m = alive & ws.summ[c];
    if (m != 0u && lane > c && lane < nw) {
      const int ng = staged_groups(c, nw);
      const uint32_t* col =
          staged + ws.base[c] + lane - ((c + 1) / 4) * 4;
      const int stride = ng * 4;
      while (m != 0u) {
        const int r0 = __ffs(m) - 1;
        m &= m - 1u;
        const int r1 = m ? __ffs(m) - 1 : r0;
        m &= m - 1u;
        const int r2 = m ? __ffs(m) - 1 : r0;
        m &= m - 1u;
        const int r3 = m ? __ffs(m) - 1 : r0;
        m &= m - 1u;
        removed |= col[r0 * stride] | col[r1 * stride] | col[r2 * stride] |
                   col[r3 * stride];
      }
    }
  }
}

template <int kAlgo, int kRows>
cudaError_t launch(const float* bx, const int* cl, const uint8_t* va,
                   uint32_t* mask, unsigned* done, uint32_t* summary,
                   uint8_t* keep, int b, int k, float thr,
                   float one_plus_thr, cudaStream_t s) {
  const int tiles_c = (k + kTileCols - 1) / kTileCols;
  int live = 0;
  for (int rt = 0; rt * kRows < k; ++rt) {
    live += tiles_c - rt * kRows / kTileCols;
  }
  const int smem = staged_bytes((k + kWord - 1) / kWord);
  auto* kernel = nms_greedy_kernel<kAlgo, kRows>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((unsigned)live, (unsigned)b), kTileThreads, smem, s>>>(
      bx, cl, va, mask, done, summary, keep, k, thr, one_plus_thr);
  return cudaGetLastError();
}

template <int kAlgo>
cudaError_t launch_rows(int rows, const float* bx, const int* cl,
                        const uint8_t* va, uint32_t* mask, unsigned* done,
                        uint32_t* summary, uint8_t* keep, int b, int k,
                        float thr, float one_plus_thr, cudaStream_t s) {
  if (rows == 16) {
    return launch<kAlgo, 16>(bx, cl, va, mask, done, summary, keep, b, k,
                             thr, one_plus_thr, s);
  }
  if (rows == 32) {
    return launch<kAlgo, 32>(bx, cl, va, mask, done, summary, keep, b, k,
                             thr, one_plus_thr, s);
  }
  return launch<kAlgo, 64>(bx, cl, va, mask, done, summary, keep, b, k, thr,
                           one_plus_thr, s);
}

}  // namespace

// Words per mask row (the scratch holds b * k * nms_greedy_mask_ld(k)
// uint32) and state words per image (b * nms_greedy_state_words(k)).
extern "C" int nms_greedy_mask_ld(int k) {
  return mask_ld((k + kWord - 1) / kWord);
}
extern "C" int nms_greedy_state_words(int k) {
  return 1 + (k + kWord - 1) / kWord;
}

// Returns the cudaError_t of the launch (0 on success). cls may be null
// (class-agnostic suppression). mask is scratch the kernel overwrites
// (16-byte aligned); state holds b counters then b * ceil(k / 32) summary
// words, all zero on entry, and the kernel leaves them zero. algo is
// skew_green::kGreen or kGreen2.
extern "C" int nms_greedy_launch(const void* boxes, const void* cls,
                                 const void* valid, void* mask, void* state,
                                 void* keep, int b, int k, float thr,
                                 float one_plus_thr, int algo,
                                 void* stream) {
  if (b == 0 || k == 0) return 0;
  if (k > kMaxK || b > 65535 ||
      (algo != skew_green::kGreen && algo != skew_green::kGreen2)) {
    return (int)cudaErrorInvalidValue;
  }
  int rows = 0;
  cudaError_t err = skew_green::tile_rows(b, k, &rows);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* bx = (const float*)boxes;
  const int* cl = (const int*)cls;
  const uint8_t* va = (const uint8_t*)valid;
  uint32_t* mk = (uint32_t*)mask;
  unsigned* done = (unsigned*)state;
  uint32_t* summary = (uint32_t*)state + b;
  uint8_t* kp = (uint8_t*)keep;
  if (algo == skew_green::kGreen2) {
    err = launch_rows<skew_green::kGreen2>(rows, bx, cl, va, mk, done,
                                           summary, kp, b, k, thr,
                                           one_plus_thr, s);
  } else {
    err = launch_rows<skew_green::kGreen>(rows, bx, cl, va, mk, done,
                                          summary, kp, b, k, thr,
                                          one_plus_thr, s);
  }
  return (int)err;
}
