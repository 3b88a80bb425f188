// Batched row gather: (B, N, C) cells + (B, K) int32 row indices -> (B, K, C).
//
// Replaces the TPU kernel rotate_yolov3_tpu/ops/gather_rows.py::gather_rows_pallas
// (body _gather_kernel). On the serving path it pulls the K top-scoring cell
// rows (C = na*no = 126 lanes on the HRSC cfg, 378 on DOTA) out of the
// concatenated head maps (N = 7581 cells at 608 px) before the decode.
//
// What bounds it on Hopper: bytes. At K = 512 it moves about 129 KB per image
// in bf16 (read + write), a few microseconds of HBM time for a whole batch,
// so the kernel stays simple: one thread copies one element of (B, K, C).
// Threads of a warp take neighbouring columns of one row, so reads and writes
// are coalesced along C. The TPU kernel's aligned sublane blocks and one-hot
// row extraction existed only for the TPU's vector layout and are dropped.
//
// The element is copied as raw bits of its byte width (2 for bf16/fp16,
// 4 for f32), so the output equals torch.gather bit for bit. Indices are
// clamped to [0, N-1], the XLA GatherScatterMode.CLIP contract of the
// reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ cells,
                                   const int32_t* __restrict__ idx,
                                   T* __restrict__ out, int n, int k, int c) {
  const int b = blockIdx.y;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)k * c) return;
  const int r = (int)(e / c);
  const int col = (int)(e - (int64_t)r * c);
  int i = idx[(int64_t)b * k + r];
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  out[(int64_t)b * k * c + e] = cells[((int64_t)b * n + i) * c + col];
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int gather_rows_launch(const void* cells, const void* idx,
                                  void* out, int b, int n, int k, int c,
                                  int elem_bytes, void* stream) {
  if (b == 0 || k == 0 || c == 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t per_image = (int64_t)k * c;
  const dim3 grid((unsigned)((per_image + kThreads - 1) / kThreads),
                  (unsigned)b);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2) {
    gather_rows_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        (const uint16_t*)cells, (const int32_t*)idx, (uint16_t*)out, n, k, c);
  } else if (elem_bytes == 4) {
    gather_rows_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)cells, (const int32_t*)idx, (uint32_t*)out, n, k, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
