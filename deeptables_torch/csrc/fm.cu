// FM second-order pooling, forward and backward, for NVIDIA Hopper (sm_90a).
//
//   forward:  out[b] = 0.5 * sum_d [ (sum_f x[b,f,d])^2 - sum_f x[b,f,d]^2 ]
//   backward: dx[b,f,d] = g[b] * (sum_f' x[b,f',d] - x[b,f,d])
//
// Replaces deeptables_tpu/ops/kernels/fm.py::fm_pallas: the forward
// (_fm_fwd_kernel) and the backward of its custom VJP (_fm_bwd,
// _fm_bwd_kernel). x is (B, F, D), contiguous, float32 or bfloat16; out and
// g are (B, 1) and dx is (B, F, D), all in x's type.
//
// Forward:
// What bounds it: memory. Each element of x is read once and takes three
// flops, so the kernel cannot beat B*F*D*sizeof(T) bytes over the card's
// memory rate. The design reads each x[b] exactly once and keeps everything
// else out of device memory: a group of GROUP threads (a power of two, at
// most one warp) owns one example; thread t of the group owns d = t,
// t + GROUP, ... and walks the F fields, accumulating sum_f x and
// sum_f x^2 in float32 registers. At a fixed f the group reads GROUP
// neighbouring elements, so every load is coalesced (at D=16, half a warp
// per example, two examples per warp). The group then reduces its partials
// over d with warp shuffles and one thread writes the result, rounded once
// to T. A block of 256 threads covers 256/GROUP examples; the last block
// masks examples past B, so any B >= 1 works (the TPU kernel halved its
// tile down to 1 instead).
//
// Backward: also bound by memory, at one read of x and one write of dx
// (2 * B*F*D*sizeof(T) bytes; 2 operations per element). The same thread
// layout: the group's thread t owns d = t, t + GROUP, ...; for each of its
// d it walks the F fields once to form s = sum_f x in a float32 register,
// then again to write dx = g * (s - x), rounded once to T. The second walk
// reads the example's F*D elements again, which the first walk has just
// brought into L1, so device memory sees x once. No shuffles: the groups
// share nothing. Like the TPU kernel, it keeps s out of device memory
// (the autograd Function saves x, not s).
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int GROUP>
__global__ void __launch_bounds__(kThreads)
    fm_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t B,
                  int F, int D) {
  const int lane = threadIdx.x % GROUP;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * (kThreads / GROUP) + threadIdx.x / GROUP;
  float partial = 0.f;
  if (b < B) {
    const T* xb = x + b * static_cast<int64_t>(F) * D;
    for (int d = lane; d < D; d += GROUP) {
      float s = 0.f, q = 0.f;
#pragma unroll 8
      for (int f = 0; f < F; ++f) {
        const float v = load_f32(xb + static_cast<int64_t>(f) * D + d);
        s += v;
        q = fmaf(v, v, q);
      }
      partial += s * s - q;
    }
  }
  // Every lane of the warp reaches the shuffles, those past B included.
#pragma unroll
  for (int offset = GROUP / 2; offset > 0; offset >>= 1)
    partial += __shfl_xor_sync(0xffffffffu, partial, offset, GROUP);
  if (b < B && lane == 0) store(out + b, 0.5f * partial);
}

template <typename T, int GROUP>
__global__ void __launch_bounds__(kThreads)
    fm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  T* __restrict__ dx, int64_t B, int F, int D) {
  const int lane = threadIdx.x % GROUP;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * (kThreads / GROUP) + threadIdx.x / GROUP;
  if (b >= B) return;
  const int64_t base = b * static_cast<int64_t>(F) * D;
  const T* xb = x + base;
  T* dxb = dx + base;
  const float gb = load_f32(g + b);
  for (int d = lane; d < D; d += GROUP) {
    float s = 0.f;
#pragma unroll 8
    for (int f = 0; f < F; ++f) s += load_f32(xb + static_cast<int64_t>(f) * D + d);
#pragma unroll 8
    for (int f = 0; f < F; ++f) {
      const int64_t i = static_cast<int64_t>(f) * D + d;
      store(dxb + i, gb * (s - load_f32(xb + i)));
    }
  }
}

int group_for(int D) {
  int group = 1;
  while (group < D && group < 32) group <<= 1;
  return group;
}

// Launches KERNEL<T, group> over ceil(B / (kThreads / group)) blocks.
#define DT_FM_DISPATCH(KERNEL, ...)                                          \
  do {                                                                       \
    if (B < 1 || F < 0 || D < 0) return cudaErrorInvalidValue;               \
    const int group = group_for(D);                                          \
    const int64_t per_block = kThreads / group;                              \
    const int64_t blocks = (B + per_block - 1) / per_block;                  \
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;                   \
    const dim3 grid(static_cast<unsigned>(blocks));                          \
    switch (group) {                                                         \
      case 1: KERNEL<T, 1><<<grid, kThreads, 0, stream>>>(__VA_ARGS__); break;   \
      case 2: KERNEL<T, 2><<<grid, kThreads, 0, stream>>>(__VA_ARGS__); break;   \
      case 4: KERNEL<T, 4><<<grid, kThreads, 0, stream>>>(__VA_ARGS__); break;   \
      case 8: KERNEL<T, 8><<<grid, kThreads, 0, stream>>>(__VA_ARGS__); break;   \
      case 16: KERNEL<T, 16><<<grid, kThreads, 0, stream>>>(__VA_ARGS__); break; \
      default: KERNEL<T, 32><<<grid, kThreads, 0, stream>>>(__VA_ARGS__); break; \
    }                                                                        \
    return cudaGetLastError();                                               \
  } while (0)

template <typename T>
cudaError_t launch(const T* x, T* out, int64_t B, int F, int D,
                   cudaStream_t stream) {
  DT_FM_DISPATCH(fm_fwd_kernel, x, out, B, F, D);
}

template <typename T>
cudaError_t launch_bwd(const T* x, const T* g, T* dx, int64_t B, int F, int D,
                       cudaStream_t stream) {
  DT_FM_DISPATCH(fm_bwd_kernel, x, g, dx, B, F, D);
}

}  // namespace

extern "C" {

int dt_fm_fwd_f32(const void* x, void* out, int64_t B, int F, int D,
                  void* stream) {
  return static_cast<int>(launch(static_cast<const float*>(x),
                                 static_cast<float*>(out), B, F, D,
                                 static_cast<cudaStream_t>(stream)));
}

int dt_fm_fwd_bf16(const void* x, void* out, int64_t B, int F, int D,
                   void* stream) {
  return static_cast<int>(launch(static_cast<const __nv_bfloat16*>(x),
                                 static_cast<__nv_bfloat16*>(out), B, F, D,
                                 static_cast<cudaStream_t>(stream)));
}

int dt_fm_bwd_f32(const void* x, const void* g, void* dx, int64_t B, int F,
                  int D, void* stream) {
  return static_cast<int>(launch_bwd(static_cast<const float*>(x),
                                     static_cast<const float*>(g),
                                     static_cast<float*>(dx), B, F, D,
                                     static_cast<cudaStream_t>(stream)));
}

int dt_fm_bwd_bf16(const void* x, const void* g, void* dx, int64_t B, int F,
                   int D, void* stream) {
  return static_cast<int>(launch_bwd(static_cast<const __nv_bfloat16*>(x),
                                     static_cast<const __nv_bfloat16*>(g),
                                     static_cast<__nv_bfloat16*>(dx), B, F, D,
                                     static_cast<cudaStream_t>(stream)));
}

const char* dt_fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
