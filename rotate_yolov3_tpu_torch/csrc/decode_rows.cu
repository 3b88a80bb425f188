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
// with the box fields multiplied by 0 where not valid (a NaN or inf field
// stays NaN there, as in the reference), and cls_id kept on invalid rows (0
// when nc = 1). Indices are clamped to [0, N * na), the row gather's clip
// mode.
//
// The class id is the reference's sequential rule (rotate_yolov3_tpu/ops/
// decode_pallas.py, cls_body): start at class 0 with its logit, move to
// class c only where logit c > the best so far. So a NaN never wins, a NaN
// in class 0 pins the id to 0, and an all -inf row gives 0. Each thread runs
// that loop over its own row in registers, so it is the rule itself, not a
// reduction that would have to reproduce it. The clip propagates NaN, as
// jnp.clip does (fminf/fmaxf would turn a NaN into the bound); +-inf clip to
// +-c.
//
// Replaces the TPU kernel rotate_yolov3_tpu/ops/decode_pallas.py::
// decode_rows_pallas (body _decode_kernel). That kernel gathers the K cell
// rows as a one-hot matmul on the MXU against the concatenated (N, C) cell
// table held in VMEM; on this card a direct indexed load reads the same
// values, and it reads them from the head maps in place, so the (B, N, C)
// concatenation is never built. Per-head cell counts, widths, strides and
// anchor tables ride in a struct passed by value (__grid_constant__, so the
// anchor table can be read with a runtime index without a local copy).
//
// What bounds it on Hopper: the latency of one dependent chain of scattered
// loads (index -> fields), not bandwidth. A row reads 5 + nc values of one
// cell (5 for nc = 1: the objectness lane is not needed, and one class needs
// no argmax), na lanes apart when field-major, so each sits in its own
// 32-byte sector: at B = 128, K = 512 that is ~10.5 MB of sectors for ~0.1%
// of the head maps. Design: one thread per (b, k) row. It loads its index,
// selects its head with compile-time indices (no stack frame), issues all of
// its field and class loads (the first kClsChunk classes; later chunks,
// nc > 16, follow in turn) before it uses any, runs the argmax and the
// decode in registers and writes its row as two float4, so a warp writes 1
// KB of rows contiguously. 65,536 rows are 2,048 warps: one wave of the
// card, one latency chain. The anchor table is staged in shared memory once
// per block while the index loads are in flight.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeads = 4;
constexpr int kMaxNa = 32;
constexpr int kThreads = 256;        // rows of a block, one per thread
constexpr int kRowsPerThread = 1;    // rows a thread loads before it decodes
constexpr int kClsChunk = 16;        // class logits loaded together

struct Heads {
  const void* ptr[kMaxHeads];
  int cells[kMaxHeads];   // H * W
  int width[kMaxHeads];   // W
  float stride[kMaxHeads];
  // per head h: na widths, na heights, na angles at (h * 3 + q) * na
  float anchors[kMaxHeads * 3 * kMaxNa];
  int n;
};

template <bool kBf16>
__device__ __forceinline__ float load(const void* base, int64_t i) {
  if constexpr (kBf16) {
    const unsigned short u = __ldg((const unsigned short*)base + i);
    return __uint_as_float((uint32_t)u << 16);
  } else {
    return __ldg((const float*)base + i);
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// clip(x, -c, c) that keeps a NaN, as jnp.clip and torch.clamp do
__device__ __forceinline__ float clip_nan(float x, float c) {
  const float lo = (x > -c || x != x) ? x : -c;
  return (lo < c || lo != lo) ? lo : c;
}

// One row's loads in flight: its head, cell and anchor, and its raw values.
struct Row {
  const void* src;   // the row's head map
  int64_t lane0;     // element of field 0 of the row's anchor
  int step;          // elements between fields
  int h, local, a;
  float t[5];                 // tx, ty, tw, th, t_theta
  float cls[kClsChunk];       // class logits 0.. (nc > 1)
};

template <bool kBf16>
__device__ __forceinline__ void fetch(const Heads& heads, int g, int bi,
                                      int c, int na, int nc,
                                      int field_major, Row& r) {
  const int cell = g / na;
  r.a = g - cell * na;
  // the head of the cell, selected with compile-time indices only
  int h = 0, local = cell;
#pragma unroll
  for (int hh = 0; hh + 1 < kMaxHeads; ++hh) {
    if (h == hh && hh + 1 < heads.n && local >= heads.cells[hh]) {
      local -= heads.cells[hh];
      h = hh + 1;
    }
  }
  const void* src = heads.ptr[0];
  int cells = heads.cells[0];
#pragma unroll
  for (int hh = 1; hh < kMaxHeads; ++hh) {
    if (h == hh) {
      src = heads.ptr[hh];
      cells = heads.cells[hh];
    }
  }
  r.src = src;
  r.h = h;
  r.local = local;
  const int no = 6 + nc;
  r.step = field_major ? na : 1;
  r.lane0 = ((int64_t)bi * cells + local) * c + (field_major ? r.a : r.a * no);
#pragma unroll
  for (int f = 0; f < 5; ++f) {
    r.t[f] = load<kBf16>(src, r.lane0 + (int64_t)f * r.step);
  }
#pragma unroll
  for (int k = 0; k < kClsChunk; ++k) {
    r.cls[k] = (nc > 1 && k < nc)
                   ? load<kBf16>(src, r.lane0 + (int64_t)(6 + k) * r.step)
                   : 0.0f;
  }
}

// The reference's class rule: class 0 first, then strict > in class order.
template <bool kBf16>
__device__ __forceinline__ int class_id(Row& r, int nc) {
  if (nc <= 1) return 0;
  float best = r.cls[0];
  int id = 0;
#pragma unroll
  for (int k = 1; k < kClsChunk; ++k) {
    if (k < nc && r.cls[k] > best) {
      best = r.cls[k];
      id = k;
    }
  }
  for (int c0 = kClsChunk; c0 < nc; c0 += kClsChunk) {
#pragma unroll
    for (int k = 0; k < kClsChunk; ++k) {
      r.cls[k] = c0 + k < nc ? load<kBf16>(r.src, r.lane0 + (int64_t)(
                                                      6 + c0 + k) * r.step)
                             : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kClsChunk; ++k) {
      if (c0 + k < nc && r.cls[k] > best) {
        best = r.cls[k];
        id = c0 + k;
      }
    }
  }
  return id;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    decode_rows_kernel(const __grid_constant__ Heads heads,
                       const int* __restrict__ idx,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ out, int rows, int k, int c,
                       int na, int nc, int field_major, int n_idx,
                       float angle_range, float wh_clamp) {
  __shared__ float anc[kMaxHeads * 3 * kMaxNa];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * (kThreads * kRowsPerThread) + tid;

  // the index and valid loads first: they need no table
  int g[kRowsPerThread];
  bool ok[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int row = first + q * kThreads;
    g[q] = row < rows ? min(max(__ldg(idx + row), 0), n_idx - 1) : 0;
    ok[q] = row < rows && __ldg(valid + row) != 0;
  }
  for (int e = tid; e < heads.n * 3 * na; e += kThreads) {
    anc[e] = heads.anchors[e];
  }
  __syncthreads();

  Row r[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int row = first + q * kThreads;
    if (row < rows) {
      fetch<kBf16>(heads, g[q], row / k, c, na, nc, field_major, r[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int row = first + q * kThreads;
    if (row >= rows) continue;
    Row& x = r[q];
    const int id = class_id<kBf16>(x, nc);
    int width = heads.width[0];
    float stride = heads.stride[0];
#pragma unroll
    for (int hh = 1; hh < kMaxHeads; ++hh) {
      if (x.h == hh) {
        width = heads.width[hh];
        stride = heads.stride[hh];
      }
    }
    const float gx = (float)(x.local % width);
    const float gy = (float)(x.local / width);
    const float* at = anc + x.h * 3 * na + x.a;
    const float vf = ok[q] ? 1.0f : 0.0f;
    const float bx = (sigmoid(x.t[0]) + gx) * stride;
    const float by = (sigmoid(x.t[1]) + gy) * stride;
    const float bw = at[0] * expf(clip_nan(x.t[2], wh_clamp));
    const float bh = at[na] * expf(clip_nan(x.t[3], wh_clamp));
    const float bt = at[2 * na] + angle_range * tanhf(x.t[4]);
    float4* o = (float4*)(out + (int64_t)row * 8);
    o[0] = make_float4(bx * vf, by * vf, bw * vf, bh * vf);
    o[1] = make_float4(bt * vf, (float)id, 0.0f, 0.0f);
  }
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
    n_cells += head_cells[h];
  }
  for (int e = 0; e < n_heads * 3 * na; ++e) heads.anchors[e] = anchors[e];
  heads.n = n_heads;
  const int rows = b * k;
  constexpr int kPerBlock = kThreads * kRowsPerThread;
  const dim3 grid((unsigned)((rows + kPerBlock - 1) / kPerBlock));
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    decode_rows_kernel<true><<<grid, kThreads, 0, s>>>(
        heads, (const int*)idx, (const uint8_t*)valid, (float*)out, rows, k,
        c, na, nc, field_major, n_cells * na, angle_range, wh_clamp);
  } else {
    decode_rows_kernel<false><<<grid, kThreads, 0, s>>>(
        heads, (const int*)idx, (const uint8_t*)valid, (float*)out, rows, k,
        c, na, nc, field_major, n_cells * na, angle_range, wh_clamp);
  }
  return (int)cudaGetLastError();
}
