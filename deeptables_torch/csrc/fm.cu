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
// memory rate. Two designs, each with entry points of its own; the
// wrapper picks one by shape and alignment before the launch (fm_design):
//
// vec16 (a row of x is CHUNKS = D*sizeof(T)/16 16-byte chunks, CHUNKS a
//   power of two up to 32, x 16-byte aligned; the main path's D=16 is 2
//   chunks in bfloat16, 4 in float32): every byte of x moves in 16-byte
//   loads through the non-coherent path. A group of CHUNKS * SLICES
//   threads owns one example: thread (slice, chunk) reads that chunk of
//   the fields slice, slice + SLICES, ..., four loads in flight at a time,
//   and keeps sum_f x for each of its 8 (bfloat16) or 4 (float32) d and
//   one sum_f,d x^2 in float32 registers. SLICES is the largest power of
//   two with SLICES * CHUNKS <= 32 and SLICES <= ceil(F / 3), so a thread
//   reads three or four fields: at F=26, D=16 an example takes 16
//   (bfloat16) or 32 (float32) threads, and B=4096 puts 64 K or 128 K
//   threads, all of x, in flight at once. The slices' sum_f x are added
//   by shuffles before they are squared; each chunk then forms
//   sum_d [(sum_f x)^2] - sum_f,d x^2, the chunks are added by shuffles,
//   and one thread writes the result, rounded once to T. Consecutive
//   threads read consecutive chunks, so a warp's loads are coalesced. The
//   grid holds at most the blocks the card runs at once, and a block walks
//   on to further examples past them (B=12288 in float32 is 1.5 such
//   grids), so no second wave of blocks waits for the first.
// scalar (any other shape, or x not 16-byte aligned): a group of GROUP
//   threads (a power of two, at most one warp) owns one example; thread t
//   of the group owns d = t, t + GROUP, ... and walks the F fields,
//   accumulating sum_f x and sum_f x^2 in float32 registers. At a fixed f
//   the group reads GROUP neighbouring elements, so every load is
//   coalesced. The group then reduces its partials over d with warp
//   shuffles and one thread writes the result, rounded once to T.
// In both, a block covers several examples and masks those past B, so any
// B >= 1 works (the TPU kernel halved its tile down to 1 instead).
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

constexpr int kVecThreads = 256;
// 16-byte loads a thread of vec16 keeps in flight
constexpr int kVecLoads = 4;

// Adds the 16 / sizeof(T) values of a 16-byte chunk into s, and their
// squares into q.
__device__ __forceinline__ void accumulate(const uint4& u, float (&s)[4],
                                           float& q) {
  const float v[4] = {__uint_as_float(u.x), __uint_as_float(u.y),
                      __uint_as_float(u.z), __uint_as_float(u.w)};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s[e] += v[e];
    q = fmaf(v[e], v[e], q);
  }
}
__device__ __forceinline__ void accumulate(const uint4& u, float (&s)[8],
                                           float& q) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    s[2 * e] += v.x;
    q = fmaf(v.x, v.x, q);
    s[2 * e + 1] += v.y;
    q = fmaf(v.y, v.y, q);
  }
}

template <typename T, int CHUNKS, int SLICES>
__global__ void __launch_bounds__(kVecThreads)
    fm_fwd_vec16_kernel(const T* __restrict__ x, T* __restrict__ out,
                        int64_t B, int F) {
  constexpr int kGroup = CHUNKS * SLICES;
  constexpr int kElems = 16 / sizeof(T);
  static_assert(kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
                "an example's threads are a power of two within a warp");
  constexpr int kPerBlock = kVecThreads / kGroup;
  const int lane = threadIdx.x % kGroup;
  const int chunk = lane % CHUNKS;
  const int slice = lane / CHUNKS;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kPerBlock;
  // the grid holds at most the blocks the card runs at once; a block walks
  // its examples while its first one lies below B (every lane of a warp
  // takes the same turns, for the shuffles)
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * kPerBlock;
       first < B; first += stride) {
    const int64_t b = first + threadIdx.x / kGroup;
    float s[kElems] = {};
    float q = 0.f;
    if (b < B) {
      const uint4* xb =
          reinterpret_cast<const uint4*>(x) + b * F * CHUNKS + chunk;
      for (int f0 = slice; f0 < F; f0 += kVecLoads * SLICES) {
        uint4 u[kVecLoads];
#pragma unroll
        for (int k = 0; k < kVecLoads; ++k) {
          const int f = f0 + k * SLICES;
          u[k] = f < F ? __ldg(xb + static_cast<int64_t>(f) * CHUNKS)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < kVecLoads; ++k) accumulate(u[k], s, q);
      }
    }
    // The slices' sums over f, before squaring:
#pragma unroll
    for (int offset = CHUNKS; offset < kGroup; offset <<= 1) {
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        s[e] += __shfl_xor_sync(0xffffffffu, s[e], offset);
      q += __shfl_xor_sync(0xffffffffu, q, offset);
    }
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < kElems; ++e) sq = fmaf(s[e], s[e], sq);
    float partial = sq - q;
#pragma unroll
    for (int offset = 1; offset < CHUNKS; offset <<= 1)
      partial += __shfl_xor_sync(0xffffffffu, partial, offset);
    if (b < B && lane == 0) store(out + b, 0.5f * partial);
  }
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

// vec16's chunks a row of x, or 0 where vec16 does not take x (its entry
// points then refuse the launch).
template <typename T>
int vec16_chunks(const T* x, int D) {
  const int row = D * static_cast<int>(sizeof(T));
  const int chunks = row / 16;
  if (row % 16 != 0 || chunks < 1 || chunks > 32 ||
      (chunks & (chunks - 1)) != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return 0;
  return chunks;
}

// vec16's slices an example: the largest power of two with
// chunks * slices <= 32 and slices <= ceil(F / 3).
int vec16_slices(int chunks, int F) {
  const int want = F > 3 ? (F + 2) / 3 : 1;
  int slices = 1;
  while (slices * 2 <= want && chunks * slices * 2 <= 32) slices *= 2;
  return slices;
}

// Launches fm_fwd_vec16_kernel<T, CHUNKS, slices>, slices >= SLICES, over
// at most the blocks the card holds at once.
template <typename T, int CHUNKS, int SLICES>
cudaError_t launch_vec16_at(const T* x, T* out, int64_t B, int F, int slices,
                            cudaStream_t stream) {
  if constexpr (CHUNKS * SLICES < 32) {
    if (slices > SLICES)
      return launch_vec16_at<T, CHUNKS, SLICES * 2>(x, out, B, F, slices,
                                                    stream);
  }
  static int resident[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fm_fwd_vec16_kernel<T, CHUNKS, SLICES>, kVecThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    resident[device] = per_sm > 0 ? per_sm * sms : sms;
  }
  constexpr int64_t per_block = kVecThreads / (CHUNKS * SLICES);
  int64_t blocks = (B + per_block - 1) / per_block;
  if (blocks > resident[device]) blocks = resident[device];
  fm_fwd_vec16_kernel<T, CHUNKS, SLICES>
      <<<static_cast<unsigned>(blocks), kVecThreads, 0, stream>>>(x, out, B, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* x, T* out, int64_t B, int F, int D,
                   cudaStream_t stream) {
  DT_FM_DISPATCH(fm_fwd_kernel, x, out, B, F, D);
}

template <typename T>
cudaError_t launch_vec16(const T* x, T* out, int64_t B, int F, int D,
                         cudaStream_t stream) {
  const int chunks = vec16_chunks(x, D);
  if (B < 1 || F < 0 || chunks == 0) return cudaErrorInvalidValue;
  const int slices = vec16_slices(chunks, F);
  switch (chunks) {
    case 1: return launch_vec16_at<T, 1, 1>(x, out, B, F, slices, stream);
    case 2: return launch_vec16_at<T, 2, 1>(x, out, B, F, slices, stream);
    case 4: return launch_vec16_at<T, 4, 1>(x, out, B, F, slices, stream);
    case 8: return launch_vec16_at<T, 8, 1>(x, out, B, F, slices, stream);
    case 16: return launch_vec16_at<T, 16, 1>(x, out, B, F, slices, stream);
    default: return launch_vec16_at<T, 32, 1>(x, out, B, F, slices, stream);
  }
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

int dt_fm_fwd_vec16_f32(const void* x, void* out, int64_t B, int F, int D,
                        void* stream) {
  return static_cast<int>(launch_vec16(static_cast<const float*>(x),
                                       static_cast<float*>(out), B, F, D,
                                       static_cast<cudaStream_t>(stream)));
}

int dt_fm_fwd_vec16_bf16(const void* x, void* out, int64_t B, int F, int D,
                         void* stream) {
  return static_cast<int>(launch_vec16(static_cast<const __nv_bfloat16*>(x),
                                       static_cast<__nv_bfloat16*>(out), B, F,
                                       D, static_cast<cudaStream_t>(stream)));
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
