// The epilogue of one convolution of the fused backbone, in place on the
// convolution's output: bias, activation and, where the next layer is a
// [shortcut], the residual add, in one pass over NHWC (channels_last) memory.
//
//   t   = round(y + bias[c])
//   a   = round(t > 0 ? t : t * slope)        leaky (linear: a = t; relu:
//                                              a = t if NaN, else max(t, 0))
//   out = round(a + residual)                 only with a residual
//
// round is to the tensor's type (bf16 or f32); the arithmetic is f32. These
// are the roundings of the eager ops the kernel replaces: PyTorch's cuDNN
// convolution leaves the bias to output.add_(bias) (f32 opmath, one
// rounding), F.leaky_relu computes x > 0 ? x : x * float(slope) and rounds,
// the walk's x + cache[frm] rounds once more. So the output equals the eager
// sequence bit for bit, NaN and +-inf included. Built with -fmad=false
// (_build.py): a contracted a * slope + residual would round once where the
// eager ops round twice.
//
// Not a TPU kernel's port: the JAX package leaves these ops to XLA, which
// fuses them into the convolution (apply_fused,
// rotate_yolov3_tpu/models/darknet.py:439-442). Eager PyTorch runs each as
// its own pass over the conv output (the bias add through a generic strided
// kernel: the bias broadcast defeats the vectorised path); this kernel is
// the one pass left.
//
// What bounds it on Hopper: bytes. The output is read once and written once,
// the residual read once (bias: C values). At B = 128, 608^2, bf16 on the
// HRSC cfg: ~50 GB over the 75 convolutions of a call, ~15 ms at 3.35 TB/s.
// Design:
//   * a grid-stride loop over vectors of VEC elements along the flat NHWC
//     memory: 16 bytes a thread (8 bf16 or 4 f32) wherever C and the base
//     addresses allow it (every convolution but the 126-channel heads),
//     else 4 or 2 bytes (C = 126: 2 bf16 or 2 f32) or one element;
//   * since VEC divides C, a vector never straddles two pixels: its first
//     channel ch = (v * VEC) % C is computed once per thread and advanced by
//     the grid's stride modulo C (step_c) at each iteration, with no
//     division in the loop;
//   * each block reads the bias once into shared memory as f32;
//   * 8 blocks of 256 threads per SM, so 2048 resident threads each keep a
//     16-byte load (two with a residual) in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;

enum Act { kLinear = 0, kLeaky = 1, kRelu = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int ACT, bool RES>
__device__ __forceinline__ T finish(T y, float b, float slope, T r) {
  T t = from_f<T>(to_f(y) + b);
  if (ACT == kLeaky) {
    const float u = to_f(t);
    t = from_f<T>(u > 0.f ? u : u * slope);
  } else if (ACT == kRelu) {
    // clamp_min's order: NaN passes as it is
    const float u = to_f(t);
    if (!isnan(u)) t = from_f<T>(fmaxf(u, 0.f));
  }
  if (RES) t = from_f<T>(to_f(t) + to_f(r));
  return t;
}

template <typename T, int VEC, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(T* __restrict__ y, const T* __restrict__ bias,
                         const T* __restrict__ res, int64_t n_vec, int c,
                         int step_c, float slope) {
  extern __shared__ float sbias[];
  for (int i = threadIdx.x; i < c; i += kThreads) sbias[i] = to_f(bias[i]);
  __syncthreads();

  using P = Pack<T, VEC>;
  P* yv = reinterpret_cast<P*>(y);
  const P* rv = reinterpret_cast<const P*>(res);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int ch = (int)((v * VEC) % c);
  for (; v < n_vec; v += stride) {
    P a = yv[v];
    const P r = RES ? rv[v] : a;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      a.v[j] = finish<T, ACT, RES>(a.v[j], sbias[ch + j], slope, r.v[j]);
    }
    yv[v] = a;
    ch += step_c;
    if (ch >= c) ch -= c;
  }
}

int sm_count() {
  static int counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < kMaxDevices && counts[dev] > 0) return counts[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess) {
    return 0;
  }
  if (dev < kMaxDevices) counts[dev] = n;
  return n;
}

template <typename T, int VEC, int ACT, bool RES>
cudaError_t launch_one(void* y, const void* bias, const void* res, int64_t n,
                       int c, float slope, cudaStream_t s) {
  const int64_t n_vec = n / VEC;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int64_t resident = (int64_t)sms * kBlocksPerSm;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  const int step_c = (int)((blocks * kThreads * VEC) % c);
  conv_epilogue_kernel<T, VEC, ACT, RES>
      <<<(unsigned)blocks, kThreads, c * sizeof(float), s>>>(
          (T*)y, (const T*)bias, (const T*)res, n_vec, c, step_c, slope);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_vec(void* y, const void* bias, const void* res, int64_t n,
                       int c, int act, float slope, cudaStream_t s) {
  const bool r = res != nullptr;
  switch (act) {
    case kLinear:
      return r ? launch_one<T, VEC, kLinear, true>(y, bias, res, n, c, slope,
                                                   s)
               : launch_one<T, VEC, kLinear, false>(y, bias, res, n, c, slope,
                                                    s);
    case kLeaky:
      return r ? launch_one<T, VEC, kLeaky, true>(y, bias, res, n, c, slope, s)
               : launch_one<T, VEC, kLeaky, false>(y, bias, res, n, c, slope,
                                                   s);
    case kRelu:
      return r ? launch_one<T, VEC, kRelu, true>(y, bias, res, n, c, slope, s)
               : launch_one<T, VEC, kRelu, false>(y, bias, res, n, c, slope,
                                                  s);
    default:
      return cudaErrorInvalidValue;
  }
}

// the widest vector, up to 16 bytes, that divides C and both base addresses
template <typename T, int VEC>
cudaError_t launch_widest(void* y, const void* bias, const void* res,
                          int64_t n, int c, int act, float slope,
                          cudaStream_t s) {
  if constexpr (VEC > 1) {
    const uintptr_t align = (uintptr_t)y | (uintptr_t)res;
    if (c % VEC != 0 || align % (sizeof(T) * VEC) != 0) {
      return launch_widest<T, VEC / 2>(y, bias, res, n, c, act, slope, s);
    }
  }
  return launch_vec<T, VEC>(y, bias, res, n, c, act, slope, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). y: n elements of a
// channels_last conv output, c channels innermost, finished in place; bias:
// c elements; res: n elements in y's layout, or null; elem_bytes 2 (bf16) or
// 4 (f32); act 0 linear, 1 leaky (slope), 2 relu.
extern "C" int conv_epilogue_launch(void* y, const void* bias,
                                    const void* res, long long n, int c,
                                    int elem_bytes, int act, float slope,
                                    void* stream) {
  if (n == 0) return 0;
  if (n < 0 || c <= 0 || n % c != 0 || act < 0 || act > 2 ||
      (size_t)c * sizeof(float) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2) {
    return (int)launch_widest<__nv_bfloat16, 8>(y, bias, res, n, c, act,
                                                slope, s);
  }
  if (elem_bytes == 4) {
    return (int)launch_widest<float, 4>(y, bias, res, n, c, act, slope, s);
  }
  return (int)cudaErrorInvalidValue;
}
