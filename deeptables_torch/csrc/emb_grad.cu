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
// TPU's slow scatter, and nothing Hopper needs. What it does give is a
// fixed order: its grid adds the batch chunks into each output tile one
// after another, so the same inputs give the same bits on every run. This
// kernel keeps that property. It adds no two values with atomics; every
// sum is taken in an order fixed by the inputs alone.
//
// The wrapper (ops/kernels/emb_grad.py) sorts the ids stably first, so
// that each row's entries lie together in batch order: `sorted` holds the
// sorted ids and `perm` the position in the batch of each (torch.sort,
// stable). The sort is index preparation, as the TPU kernel's scalar-
// prefetched column steps were; the fill, the segment sums and the writes
// are the three kernels here:
//
// 1. zero_kernel fills dtable with 16-byte stores.
// 2. segment_kernel cuts the sorted entries into chunks of `chunk`
//    consecutive entries and gives each chunk to a group of `width`
//    threads, a T-wide piece of a row each (T = float4 or float). The group
//    walks its chunk in order and sums each run of equal ids, from 0, in
//    batch order, loading kUnroll rows of g at a time. A run that is a
//    whole segment (all entries of its row) is written to its dtable row.
//    A run that a chunk boundary cuts is a piece of a longer segment and
//    goes to the chunk's two slots in `partial`: slot 0 for a run that
//    goes on from the chunk before, else slot 1 for one that goes on into
//    the chunk after.
// 3. merge_kernel: the chunk in which a cut segment starts adds its slot 1
//    and the slot 0 of each following chunk of the segment, in chunk
//    order, and writes the row.
//
// So a row's value is ((p_0 + p_1) + ...) + p_k over the pieces of its
// segment, each piece summed from 0 in batch order; a segment that lies in
// one chunk is summed exactly as the CPU's index_add_ sums it. The plain
// twin emb_grad_sorted_reference repeats this order and gives the same
// bits on the CPU.
//
// Skew: under a Zipf law a column's top row takes ~24% of its B ids
// (~2,000 entries at B = 8192). A segment of L entries costs one group
// `chunk` sequential rows and the merge L / chunk pieces, each kUnroll at
// a time, so no segment is summed in a single chain of its length.
//
// Variants, which the wrapper picks by shape and alignment
// (emb_grad_design): T = float4 (v4: D % 4 == 0 and g, dtable, partial
// 16-byte aligned, 16-byte loads and stores; its entry point refuses
// anything else) and T = float (scalar: any D and alignment).
//
// What bounds it: memory. The function must read ids and g once and write
// dtable once: (4 N + 4 N D + 4 V D) bytes, and the fill is most of that at
// the criteo shapes (20.8 MB of 35 MB at B=8192). The sort reads and writes
// the ids and their positions a few times more, and the segment kernel
// reads `perm` (8 bytes an entry) besides.
//
// Bad ids: an id outside [0, V) is skipped so memory stays safe (they sort
// to the ends and their runs are neither written nor merged); the caller
// checks every id on the host before it reaches the device
// (pipeline.check_categorical_ids), so none arrives here.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // rows (or pieces) a thread has in flight

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

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

// a run's sum: to its row, or to a slot of its chunk when a chunk boundary
// cuts it
template <typename T>
__device__ __forceinline__ void flush(int32_t row, T acc, bool from_before,
                                      bool into_after, int64_t c, int lane,
                                      int width, int64_t V,
                                      T* __restrict__ out,
                                      T* __restrict__ partial) {
  if (row < 0 || row >= V) return;
  if (from_before)
    partial[(2 * c) * width + lane] = acc;
  else if (into_after)
    partial[(2 * c + 1) * width + lane] = acc;
  else
    out[static_cast<int64_t>(row) * width + lane] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_kernel(const int32_t* __restrict__ sorted,
                   const int64_t* __restrict__ perm, const T* __restrict__ g,
                   T* __restrict__ out, T* __restrict__ partial, int64_t N,
                   int width, int64_t V, int chunk, int64_t n_chunks) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t c = t / width;
  if (c >= n_chunks) return;
  const int lane = static_cast<int>(t - c * width);
  const int64_t begin = c * chunk;
  const int64_t end = begin + chunk < N ? begin + chunk : N;
  // whether the chunk's first run goes on from the chunk before, and its
  // last run into the chunk after
  const bool from_before =
      begin > 0 && __ldg(sorted + begin - 1) == __ldg(sorted + begin);
  const bool into_after =
      end < N && __ldg(sorted + end) == __ldg(sorted + end - 1);
  int32_t row = __ldg(sorted + begin);
  bool first = true;
  T acc = zero<T>();
  for (int64_t base = begin; base < end; base += kUnroll) {
    int32_t id[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (base + k < end) {
        id[k] = __ldg(sorted + base + k);
        const int64_t n = __ldg(reinterpret_cast<const long long*>(perm) +
                                base + k);
        v[k] = __ldg(g + n * width + lane);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (base + k < end) {
        if (id[k] != row) {
          flush(row, acc, first && from_before, false, c, lane, width, V,
                out, partial);
          row = id[k];
          acc = zero<T>();
          first = false;
        }
        acc = add(acc, v[k]);
      }
    }
  }
  flush(row, acc, first && from_before, into_after, c, lane, width, V, out,
        partial);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const int32_t* __restrict__ sorted,
                 const T* __restrict__ partial, T* __restrict__ out, int64_t N,
                 int width, int64_t V, int chunk, int64_t n_chunks) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t c = t / width;
  if (c >= n_chunks) return;
  const int lane = static_cast<int>(t - c * width);
  const int64_t begin = c * chunk;
  const int64_t end = begin + chunk;
  if (end >= N) return;
  // the segment must go on into the next chunk and start in this one (the
  // ids are sorted, so an equal id before the chunk means the whole chunk
  // is the middle of a segment that started earlier)
  const int32_t row = __ldg(sorted + end - 1);
  if (__ldg(sorted + end) != row || row < 0 || row >= V) return;
  if (begin > 0 && __ldg(sorted + begin - 1) == row) return;
  T acc = partial[(2 * c + 1) * width + lane];
  bool done = false;
  for (int64_t k = c + 1; k < n_chunks && !done; k += kUnroll) {
    int32_t head[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (k + j < n_chunks) {
        head[j] = __ldg(sorted + (k + j) * chunk);
        v[j] = partial[(2 * (k + j)) * width + lane];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (!done) {
        if (k + j < n_chunks && head[j] == row)
          acc = add(acc, v[j]);
        else
          done = true;
      }
    }
  }
  out[static_cast<int64_t>(row) * width + lane] = acc;
}

template <typename T>
cudaError_t launch(const int32_t* sorted, const int64_t* perm, const float* g,
                   float* out, float* partial, int64_t N, int D, int64_t V,
                   int chunk, cudaStream_t stream) {
  constexpr int kFloats = sizeof(T) / sizeof(float);
  if (N < 0 || D < 1 || V < 1 || chunk < 1) return cudaErrorInvalidValue;
  if (kFloats > 1 && (D % kFloats != 0 ||
                      reinterpret_cast<uintptr_t>(g) % sizeof(T) != 0 ||
                      reinterpret_cast<uintptr_t>(out) % sizeof(T) != 0 ||
                      reinterpret_cast<uintptr_t>(partial) % sizeof(T) != 0))
    return cudaErrorInvalidValue;
  // out is 16-byte aligned (a fresh allocation); the fill's tail of
  // n % 4 floats takes the threads after the float4 ones
  const int64_t n = V * D;
  const int64_t fill_threads = n / 4 + n % 4;
  const int64_t fill_blocks = (fill_threads + kThreads - 1) / kThreads;
  const int width = D / kFloats;
  const int64_t n_chunks = (N + chunk - 1) / chunk;
  const int64_t blocks = (n_chunks * width + kThreads - 1) / kThreads;
  if (fill_blocks > 0x7fffffff || blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  zero_kernel<<<static_cast<unsigned>(fill_blocks), kThreads, 0, stream>>>(out,
                                                                         n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || N == 0) return err;
  const T* gt = reinterpret_cast<const T*>(g);
  T* outt = reinterpret_cast<T*>(out);
  T* partialt = reinterpret_cast<T*>(partial);
  segment_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      sorted, perm, gt, outt, partialt, N, width, V, chunk, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      sorted, partialt, outt, N, width, V, chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sorted: (N,) int32 ids in ascending order; perm: (N,) int64, the position
// in g of each; g: (N, D) float32; out: (V, D) float32; partial: scratch of
// 2 * ceil(N / chunk) * D float32.

// the scalar design
int dt_emb_grad_f32(const void* sorted, const void* perm, const void* g,
                    void* out, void* partial, int64_t N, int D, int64_t V,
                    int chunk, void* stream) {
  return static_cast<int>(launch<float>(
      static_cast<const int32_t*>(sorted), static_cast<const int64_t*>(perm),
      static_cast<const float*>(g), static_cast<float*>(out),
      static_cast<float*>(partial), N, D, V, chunk,
      static_cast<cudaStream_t>(stream)));
}

// the v4 design: refuses (cudaErrorInvalidValue) D % 4 != 0 and a g, out or
// partial that is not 16-byte aligned
int dt_emb_grad_v4_f32(const void* sorted, const void* perm, const void* g,
                       void* out, void* partial, int64_t N, int D, int64_t V,
                       int chunk, void* stream) {
  return static_cast<int>(launch<float4>(
      static_cast<const int32_t*>(sorted), static_cast<const int64_t*>(perm),
      static_cast<const float*>(g), static_cast<float*>(out),
      static_cast<float*>(partial), N, D, V, chunk,
      static_cast<cudaStream_t>(stream)));
}

const char* dt_emb_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
