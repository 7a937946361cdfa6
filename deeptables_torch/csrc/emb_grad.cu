// Embedding-table gradient of a fused multi-column lookup, for NVIDIA Hopper
// (sm_90a).
//
//   dtable = 0;  dtable[ids[n], :] += g[n, :]   for n in [0, N)
//
// Replaces deeptables_tpu/ops/kernels/emb_grad.py::emb_grad_matmul
// (_grad_kernel): the backward of the gather that reads one width group of
// the fused embedding table. ids is (N,) int32, the group's flat ids
// (B * n_cols) with the column offsets already added; g is (N, D) float32;
// dtable is the dense float32 (V, D) gradient of the logical table
// (V = sum of the group's vocabularies), which the optimizer updates whole.
//
// The TPU kernel built a one-hot tile in VMEM and contracted it on the
// MXU, over lane-packed, TILE_P-aligned table regions: a way around the
// TPU's slow scatter, and nothing Hopper needs. Here the scheme is the
// plain one, chosen for being right and simple first: atomics.
//
// 1. A fill kernel zeroes dtable with 16-byte stores.
// 2. A scatter kernel adds g into dtable with atomicAdd, which compiles to a
//    fire-and-forget reduction in L2 since its result is unused. Two
//    designs, which the wrapper picks by shape and alignment
//    (ops/kernels/emb_grad.py emb_grad_design):
//    - v4: one thread a 16-byte piece of a row of g, one float4 load and
//      one 16-byte reduction (Hopper's atomicAdd on a float4, whose result
//      is unused). It needs D % 4 == 0 and g 16-byte aligned; its entry
//      point refuses anything else.
//    - scalar: one thread an element (n, d) of g, one 4-byte reduction.
//      It takes any D and any alignment.
//    The threads of a warp read neighbouring pieces of g (coalesced).
//
// On an H100 a 16-byte reduction costs L2 about what four 4-byte ones do:
// L2 adds float32 operands at its own rate (~3.4 M in 0.014-0.018 ms), so
// v4 gains most where the rows it adds into are spread (uniform ids) and
// little under Zipf-distributed ids, where a few hot rows set the pace
// (PERF.md, the K1 finding).
//
// What bounds it: memory. The function must read ids and g once and write
// dtable once: (4 N + 4 N D + 4 V D) bytes, and the fill is most of that at
// the criteo shapes (20.8 MB of 35 MB at B=8192). The touched rows are
// read and written again by the reductions, in L2 where they fit.
//
// Order: float atomics add in a different order on every run, so the
// result is deterministic only up to rounding; tests allow for it. A sort
// of the ids followed by a segment sum would be the deterministic scheme.
//
// Skew: under a Zipf law most of a column's rows hit a few ids, and their
// reductions serialize on those addresses in L2. Combining a block's or a
// warp's equal ids first was measured slower on the main path's ids, whose
// neighbours are different columns (PERF.md); grouping the whole
// batch's ids by row is later work.
//
// Bad ids: an id outside [0, V) is skipped so memory stays safe; the
// caller checks every id on the host before it reaches the device
// (pipeline.check_categorical_ids), so none arrives here.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    zero_kernel(float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n4 = n / 4;
  if (i < n4) {
    reinterpret_cast<float4*>(out)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else if (i < n4 + (n - 4 * n4)) {
    out[4 * n4 + (i - n4)] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int32_t* __restrict__ ids, const float* __restrict__ g,
                   float* __restrict__ out, int64_t total, int D, int64_t V) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t n = i / D;
  const int64_t d = i - n * D;
  const int64_t row = __ldg(ids + n);
  if (row < 0 || row >= V) return;
  atomicAdd(out + row * D + d, __ldg(g + i));
}

__global__ void __launch_bounds__(kThreads)
    scatter_v4_kernel(const int32_t* __restrict__ ids,
                      const float4* __restrict__ g, float4* __restrict__ out,
                      int64_t pieces, int d4, int64_t V) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= pieces) return;
  const int64_t n = i / d4;
  const int64_t row = __ldg(ids + n);
  if (row < 0 || row >= V) return;
  atomicAdd(out + row * d4 + (i - n * d4), __ldg(g + i));
}

cudaError_t launch(const int32_t* ids, const float* g, float* out, int64_t N,
                   int D, int64_t V, bool v4, cudaStream_t stream) {
  if (N < 0 || D < 1 || V < 1) return cudaErrorInvalidValue;
  if (v4 && (D % 4 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
             reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return cudaErrorInvalidValue;
  // out is 16-byte aligned (a fresh allocation); the fill's tail of
  // n % 4 floats takes the threads after the float4 ones
  const int64_t n = V * D;
  const int64_t fill_threads = n / 4 + n % 4;
  const int64_t fill_blocks = (fill_threads + kThreads - 1) / kThreads;
  // the scatter's threads: a 16-byte piece (v4) or an element each
  const int64_t total = v4 ? N * (D / 4) : N * D;
  const int64_t scatter_blocks = (total + kThreads - 1) / kThreads;
  if (fill_blocks > 0x7fffffff || scatter_blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  zero_kernel<<<static_cast<unsigned>(fill_blocks), kThreads, 0, stream>>>(out, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || total == 0) return err;
  if (v4)
    scatter_v4_kernel<<<static_cast<unsigned>(scatter_blocks), kThreads, 0,
                        stream>>>(ids, reinterpret_cast<const float4*>(g),
                                  reinterpret_cast<float4*>(out), total, D / 4,
                                  V);
  else
    scatter_kernel<<<static_cast<unsigned>(scatter_blocks), kThreads, 0,
                     stream>>>(ids, g, out, total, D, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the scalar design
int dt_emb_grad_f32(const void* ids, const void* g, void* out, int64_t N,
                    int D, int64_t V, void* stream) {
  return static_cast<int>(launch(static_cast<const int32_t*>(ids),
                                 static_cast<const float*>(g),
                                 static_cast<float*>(out), N, D, V, false,
                                 static_cast<cudaStream_t>(stream)));
}

// the v4 design: refuses (cudaErrorInvalidValue) D % 4 != 0 and a g or out
// that is not 16-byte aligned
int dt_emb_grad_v4_f32(const void* ids, const void* g, void* out, int64_t N,
                       int D, int64_t V, void* stream) {
  return static_cast<int>(launch(static_cast<const int32_t*>(ids),
                                 static_cast<const float*>(g),
                                 static_cast<float*>(out), N, D, V, true,
                                 static_cast<cudaStream_t>(stream)));
}

const char* dt_emb_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
