// Top-K candidate indices -> decoded rotated boxes, batched over images, in
// one launch: per-head raw maps (B, H_h, W_h, C) in f32 or bf16, C =
// na * (6 + nc), field-major (f * na + a) or anchor-major (a * no + f)
// lanes; (B, K) int32 global candidate indices (heads in order, each
// H*W*na cell-major / anchor-minor); (B, K) bool valid -> (B, K, 8) f32
//
//   (cx, cy, w, h, theta, cls_id, 0, 0)
//
//   cx = (sigmoid(tx) + gx) * stride     w = anchor_w * exp(clip(tw, +-c))
//   cy = (sigmoid(ty) + gy) * stride     h = anchor_h * exp(clip(th, +-c))
//   theta = anchor_angle + angle_range * tanh(t_theta)
//
// with the box fields zeroed (multiplied by 0) where not valid, and cls_id
// the first maximum of the raw class logits (0 when nc = 1), kept on
// invalid rows. Indices are clamped to [0, N * na), the row gather's clip
// mode.
//
// Replaces the TPU kernel rotate_yolov3_tpu/ops/decode_pallas.py::
// decode_rows_pallas (body _decode_kernel). That kernel gathers the K cell
// rows as a one-hot matmul on the MXU against the concatenated (N, C) cell
// table held in VMEM; on this card a direct indexed load reads the same
// values, and it reads them from the head maps in place, so the (B, N, C)
// concatenation is never built. Per-head cell counts, widths, strides and
// anchor tables ride in a small struct passed by value.
//
// What bounds it on Hopper: latency of scattered loads. Each row reads 6+nc
// values of one cell (lanes na apart when field-major), about 0.1% of the
// head maps at K = 512. Design: one warp per (b, k) row, lane f loading
// field f (looping by 32 past 32 fields), so a row's loads are issued
// together; the class argmax is a warp reduction that keeps the lowest
// class index among equal maxima (the reference's strict > from class 1
// on); lane 0 decodes and writes the 32-byte row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeads = 4;
constexpr int kMaxNa = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Heads {
  const void* ptr[kMaxHeads];
  int cells[kMaxHeads];   // H * W
  int width[kMaxHeads];   // W
  float stride[kMaxHeads];
  float aw[kMaxHeads][kMaxNa];
  float ah[kMaxHeads][kMaxNa];
  float aa[kMaxHeads][kMaxNa];
  int n;
};

template <bool kBf16>
__device__ __forceinline__ float load(const void* base, int64_t i) {
  if constexpr (kBf16) {
    const uint16_t u = ((const uint16_t*)base)[i];
    return __uint_as_float((uint32_t)u << 16);
  } else {
    return ((const float*)base)[i];
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kBf16>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    decode_rows_kernel(const Heads heads, const int* __restrict__ idx,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ out, int rows, int k, int c,
                       int na, int nc, int field_major, int n_idx,
                       float angle_range, float wh_clamp) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  const int lane = threadIdx.x;
  if (row >= rows) return;  // warp-uniform
  const int bi = row / k;

  const int g = min(max(idx[row], 0), n_idx - 1);
  const int cell = g / na;
  const int a = g - cell * na;
  int h = 0, local = cell;
  for (int hh = 0; hh < heads.n; ++hh) {
    if (local < heads.cells[hh] || hh == heads.n - 1) {
      h = hh;
      break;
    }
    local -= heads.cells[hh];
  }
  const int64_t base = ((int64_t)bi * heads.cells[h] + local) * c;

  // lane f holds field f; class lanes keep their first maximum
  const int no = 6 + nc;
  float field = 0.0f, best_v = -INFINITY;
  int best_c = nc;
  for (int f = lane; f < no; f += 32) {
    const int ln = field_major ? f * na + a : a * no + f;
    const float x = load<kBf16>(heads.ptr[h], base + ln);
    if (f < 5) field = x;
    if (f >= 6 && x > best_v) {
      best_v = x;
      best_c = f - 6;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best_v, off);
    const int oc = __shfl_xor_sync(kFull, best_c, off);
    if (ov > best_v || (ov == best_v && oc < best_c)) {
      best_v = ov;
      best_c = oc;
    }
  }
  const float tx = __shfl_sync(kFull, field, 0);
  const float ty = __shfl_sync(kFull, field, 1);
  const float tw = __shfl_sync(kFull, field, 2);
  const float th = __shfl_sync(kFull, field, 3);
  const float tt = __shfl_sync(kFull, field, 4);
  if (lane != 0) return;

  const float gx = (float)(local % heads.width[h]);
  const float gy = (float)(local / heads.width[h]);
  const float stride = heads.stride[h];
  const float vf = valid[row] ? 1.0f : 0.0f;
  const float bx = (sigmoid(tx) + gx) * stride;
  const float by = (sigmoid(ty) + gy) * stride;
  const float bw =
      heads.aw[h][a] * expf(fminf(fmaxf(tw, -wh_clamp), wh_clamp));
  const float bh =
      heads.ah[h][a] * expf(fminf(fmaxf(th, -wh_clamp), wh_clamp));
  const float bt = heads.aa[h][a] + angle_range * tanhf(tt);
  float4* o = (float4*)(out + (int64_t)row * 8);
  o[0] = make_float4(bx * vf, by * vf, bw * vf, bh * vf);
  o[1] = make_float4(bt * vf, nc > 1 ? (float)best_c : 0.0f, 0.0f, 0.0f);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). h0..h3 are the head
// maps (unused ones null); head_cells, head_width, head_stride hold n_heads
// entries and anchors n_heads * 3 * na (per head: na widths, na heights, na
// angles), all in host memory.
extern "C" int decode_rows_launch(
    const void* h0, const void* h1, const void* h2, const void* h3,
    int n_heads, const int* head_cells, const int* head_width,
    const float* head_stride, const float* anchors, const void* idx,
    const void* valid, void* out, int b, int k, int c, int na, int nc,
    int field_major, int bf16, float angle_range, float wh_clamp,
    void* stream) {
  if (b == 0 || k == 0) return 0;
  if (n_heads < 1 || n_heads > kMaxHeads || na < 1 || na > kMaxNa ||
      c != na * (6 + nc)) {
    return (int)cudaErrorInvalidValue;
  }
  Heads heads = {};
  const void* ptrs[kMaxHeads] = {h0, h1, h2, h3};
  int n_cells = 0;
  for (int h = 0; h < n_heads; ++h) {
    heads.ptr[h] = ptrs[h];
    heads.cells[h] = head_cells[h];
    heads.width[h] = head_width[h];
    heads.stride[h] = head_stride[h];
    for (int a = 0; a < na; ++a) {
      heads.aw[h][a] = anchors[(h * 3 + 0) * na + a];
      heads.ah[h][a] = anchors[(h * 3 + 1) * na + a];
      heads.aa[h][a] = anchors[(h * 3 + 2) * na + a];
    }
    n_cells += head_cells[h];
  }
  heads.n = n_heads;
  const int rows = b * k;
  const dim3 block(32, kWarpsPerBlock);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    decode_rows_kernel<true><<<grid, block, 0, s>>>(
        heads, (const int*)idx, (const uint8_t*)valid, (float*)out, rows, k,
        c, na, nc, field_major, n_cells * na, angle_range, wh_clamp);
  } else {
    decode_rows_kernel<false><<<grid, block, 0, s>>>(
        heads, (const int*)idx, (const uint8_t*)valid, (float*)out, rows, k,
        c, na, nc, field_major, n_cells * na, angle_range, wh_clamp);
  }
  return (int)cudaGetLastError();
}
