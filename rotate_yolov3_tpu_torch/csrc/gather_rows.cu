// Batched row gather over head maps read in place: up to four (B, N_h, C)
// tables (the heads' cell rows, in order) + (B, K) int32 row indices into
// their virtual concatenation along the cell axis -> (B, K, C).
//
// Replaces the TPU kernel rotate_yolov3_tpu/ops/gather_rows.py::gather_rows_pallas
// (body _gather_kernel). On the serving path it pulls the K top-scoring cell
// rows (C = na*no = 126 lanes on the HRSC cfg, 378 on DOTA) out of the head
// maps (N = 7581 cells at 608 px) before the decode. The reference gathers
// from the concatenated (B, N, C) table; this kernel takes each head's base
// pointer and cumulative cell offset by value (as kernel D's Heads does), so
// that table, twice the size of all heads' bytes in traffic, is never built.
//
// What bounds it on Hopper: bytes, each of the B K rows read once and written
// once (33.3 MB at B = 128, K = 512, bf16, C = 126: 9.9 us at 3.35 TB/s).
// Design:
//   * one warp per output row, kRows = 8 rows per warp in flight, 4 warps
//     a block (on the H100 6-12% faster than 2, 4 or 16 rows a warp at the
//     serving shape, within 3% of the best elsewhere: tools/ac_ab.py,
//     PERF.md). Lane j < kRows loads row j's index once, clamps it to
//     [0, N) and finds its head with compile-time indices into the
//     by-value struct (a runtime index would copy the struct to local
//     memory); the rows' source addresses are broadcast with __shfl_sync,
//     so no thread divides per element;
//   * each row is copied in the widest word its byte count and every base
//     pointer allow (chosen at launch): 4 bytes for bf16 with even C (252-
//     byte rows at C = 126, 756 at C = 378), 8 bytes for f32 with even C
//     (504 and 1512), 16 where rows are multiples of 16 bytes, 2 bytes for
//     odd C in bf16;
//   * a warp issues the loads of all its rows (kUnroll words a lane each)
//     before any store, so kRows x kUnroll loads are in flight per lane.
// Rows are not 16-byte aligned (252 % 16 = 12, 756 % 16 = 4), so the TMA
// bulk copy (cp.async.bulk: 16-byte aligned addresses, sizes a multiple of
// 16) does not apply.
//
// Words are copied as raw bits, so the output equals torch.cat + torch.gather
// bit for bit. Indices are clamped to [0, N-1], the XLA GatherScatterMode.CLIP
// contract of the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeads = 4;
constexpr int kWarps = 4;
constexpr int kRows = 8;          // rows in flight per warp
constexpr int kUnroll = 2;        // words per lane and row per pass
constexpr unsigned kFull = 0xffffffffu;

struct Heads {
  const char* ptr[kMaxHeads];
  int first[kMaxHeads + 1];   // cumulative cell offsets: head h holds cells
                              // first[h] .. first[h + 1] - 1; past the last
                              // head every entry is the total
};

template <typename W>
__global__ void __launch_bounds__(32 * kWarps)
    gather_rows_kernel(const Heads heads, const int32_t* __restrict__ idx,
                       W* __restrict__ out, int rows, int k, int row_words) {
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + threadIdx.x / 32) * kRows;
  if (row0 >= rows) return;                    // warp-uniform

  // lane j < kRows: row row0 + j's source
  unsigned long long src_l = 0;
  if (lane < kRows && row0 + lane < rows) {
    const int r = row0 + lane;
    const int n = heads.first[kMaxHeads];
    int g = idx[r];
    g = g < 0 ? 0 : (g >= n ? n - 1 : g);
    // the head holding cell g, by compile-time indices only
    const char* base = heads.ptr[0];
    int lo = 0, hi = heads.first[1];
#pragma unroll
    for (int h = 1; h < kMaxHeads; ++h) {
      if (g >= heads.first[h]) {
        base = heads.ptr[h];
        lo = heads.first[h];
        hi = heads.first[h + 1];
      }
    }
    const int64_t row = (int64_t)(r / k) * (hi - lo) + (g - lo);
    src_l = (unsigned long long)(reinterpret_cast<const W*>(base) +
                                 row * row_words);
  }
  const W* src[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    src[j] = reinterpret_cast<const W*>(__shfl_sync(kFull, src_l, j));
  }

  for (int w0 = 0; w0 < row_words; w0 += 32 * kUnroll) {
    W v[kRows][kUnroll];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int w = w0 + u * 32 + lane;
        if (src[j] != nullptr && w < row_words) v[j][u] = __ldg(src[j] + w);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      W* dst = out + (int64_t)(row0 + j) * row_words;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int w = w0 + u * 32 + lane;
        if (src[j] != nullptr && w < row_words) dst[w] = v[j][u];
      }
    }
  }
}

template <typename W>
cudaError_t launch(const Heads& heads, const void* idx, void* out, int rows,
                   int k, int row_bytes, cudaStream_t s) {
  const int per_block = kWarps * kRows;
  const dim3 grid((unsigned)((rows + per_block - 1) / per_block));
  gather_rows_kernel<W><<<grid, 32 * kWarps, 0, s>>>(
      heads, (const int32_t*)idx, (W*)out, rows, k,
      row_bytes / (int)sizeof(W));
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). h0..h3 are the
// (B, head_cells[h], C) tables (unused ones null); head_cells holds n_heads
// entries in host memory; elem_bytes is 2 or 4.
extern "C" int gather_rows_launch(const void* h0, const void* h1,
                                  const void* h2, const void* h3,
                                  int n_heads, const int* head_cells,
                                  const void* idx, void* out, int b, int k,
                                  int c, int elem_bytes, void* stream) {
  if (b == 0 || k == 0 || c == 0) return 0;
  if (n_heads < 1 || n_heads > kMaxHeads ||
      (elem_bytes != 2 && elem_bytes != 4) || (int64_t)b * k > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  Heads heads = {};
  const void* ptrs[kMaxHeads] = {h0, h1, h2, h3};
  uintptr_t align = (uintptr_t)out;
  heads.first[0] = 0;
  for (int h = 0; h < n_heads; ++h) {
    if (head_cells[h] < 0) return (int)cudaErrorInvalidValue;
    heads.ptr[h] = (const char*)ptrs[h];
    heads.first[h + 1] = heads.first[h] + head_cells[h];
    align |= (uintptr_t)ptrs[h];
  }
  for (int h = n_heads + 1; h <= kMaxHeads; ++h) {
    heads.first[h] = heads.first[n_heads];
  }
  if (heads.first[n_heads] <= 0) return (int)cudaErrorInvalidValue;
  // the widest word dividing the row's bytes and every base address
  const int row_bytes = c * elem_bytes;
  align |= (uintptr_t)row_bytes;
  const int rows = b * k;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (align % 16 == 0) {
    err = launch<uint4>(heads, idx, out, rows, k, row_bytes, s);
  } else if (align % 8 == 0) {
    err = launch<uint2>(heads, idx, out, rows, k, row_bytes, s);
  } else if (align % 4 == 0) {
    err = launch<uint32_t>(heads, idx, out, rows, k, row_bytes, s);
  } else {
    err = launch<uint16_t>(heads, idx, out, rows, k, row_bytes, s);
  }
  return (int)err;
}
