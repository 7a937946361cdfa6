// FM second-order pooling, forward, for NVIDIA Hopper (sm_90a).
//
//   out[b] = 0.5 * sum_d [ (sum_f x[b,f,d])^2 - sum_f x[b,f,d]^2 ]
//
// Replaces deeptables_tpu/ops/kernels/fm.py::fm_pallas (forward,
// _fm_fwd_kernel). x is (B, F, D), contiguous, float32 or bfloat16; out is
// (B, 1) in x's type.
//
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

template <typename T>
cudaError_t launch(const T* x, T* out, int64_t B, int F, int D,
                   cudaStream_t stream) {
  if (B < 1 || F < 0 || D < 0) return cudaErrorInvalidValue;
  int group = 1;
  while (group < D && group < 32) group <<= 1;
  const int64_t per_block = kThreads / group;
  const int64_t blocks = (B + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (group) {
    case 1: fm_fwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(x, out, B, F, D); break;
    case 2: fm_fwd_kernel<T, 2><<<grid, kThreads, 0, stream>>>(x, out, B, F, D); break;
    case 4: fm_fwd_kernel<T, 4><<<grid, kThreads, 0, stream>>>(x, out, B, F, D); break;
    case 8: fm_fwd_kernel<T, 8><<<grid, kThreads, 0, stream>>>(x, out, B, F, D); break;
    case 16: fm_fwd_kernel<T, 16><<<grid, kThreads, 0, stream>>>(x, out, B, F, D); break;
    default: fm_fwd_kernel<T, 32><<<grid, kThreads, 0, stream>>>(x, out, B, F, D); break;
  }
  return cudaGetLastError();
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

const char* dt_fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
