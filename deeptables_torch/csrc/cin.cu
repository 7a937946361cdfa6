// CIN field-pair contraction, forward (K4) and backward (K3), for NVIDIA
// Hopper (sm_90a).
//
//   forward:  z[b,l,d]  = sum_{f,g} w[l,f,g] * x0[b,f,d] * h[b,g,d]
//   backward: dpair[f,g,n] = sum_l w[l,f,g] * dz[l,n]      (never stored)
//             dx0[f,n] = sum_g dpair[f,g,n] * h[g,n]
//             dh[g,n]  = sum_f dpair[f,g,n] * x0[f,n]
//             dW[l,f,g] = sum_n dz[l,n] * x0[f,n] * h[g,n]
//
// with n = (b, d) a column, N = B*D columns. x0 is (B, F, D), h (B, G, D),
// w (L, F, G), z and dz (B, L, D), all contiguous. x0, h, w and dz share one
// type T (float32 or bfloat16); z and dW are float32, dx0 and dh are T.
// The batch-minor operands of the JAX package, (F, D*B), are the same
// layout with B = 1 and D = D*B, so one kernel serves both towers.
//
// Replaces deeptables_tpu/ops/kernels/cin_bwd.py: the forward _fwd_kernel
// (cin_fwd_pallas) and the backward _bwd_kernel and its F-chunked tile
// variant _bwd_kernel_chunked (cin_bwd_pallas). The TPU kernels took
// batch-minor operands and padded G to a multiple of 8 for the TPU's tiles;
// these read the (B, F, D) layout directly and mask every ragged edge, so
// they take any F, G, L and B.
//
// What bounds them: operations. At the xDeepFM shapes (F=26, G=26 or 64,
// L=128, D=16, B=8192) the contraction is 2*L*F*G*N operations (56 GFLOP
// at layer 2) on about 90 MB of operands, far above the card's balance
// point. The pair x0 (x) h is F*G*N values (436 MB in bfloat16 at layer 2):
// writing it to device memory and reading it back, as a plain einsum does,
// would make the kernels memory-bound. So the pair (forward, dW) and dpair
// (dx0, dh) live only in shared memory and registers.
//
// Arithmetic: every product and sum is float32 on the CUDA cores, and each
// output is rounded once. For bfloat16 inputs the pair product is exact in
// float32 (two 8-bit significands), so the kernels round nothing before the
// output; they use no tensor cores, so this first version runs at the CUDA
// cores' float32 rate, a small share of the bfloat16 tensor-core bound.
//
// K4 (cin_fwd_kernel): a GEMM Z(L, N) = W(L, F*G) @ P(F*G, N). Each block of
// 256 threads owns a 128 x 128 tile of Z, each thread an 8 x 8 register
// tile (rows l = ty + 16i, columns n = tx + 16j). The block walks K = F*G
// in chunks of 8: it stages the W chunk in shared memory and builds the P
// chunk there from x0 and h (two loads and one product per element; the
// block's x0 and h columns stay in L1), then each thread does 64 FMAs per k.
//
// K3 is up to four launches, one kernel call:
// 1. cin_bwd_dx_kernel: a block owns TN = 128 columns and TG (32 or 64) of
//    the g's, and walks f = 0..F-1. For each f it forms its dpair tile
//    (TG x TN) = W[:, f, g-tile]^T @ dz[:, n-tile] in registers, over L in
//    chunks of 16 staged in shared memory. dh accumulates over f in
//    registers and is written once at the end; dx0[f, n] sums the tile over
//    g, in registers and then across the 16 threads that hold one column
//    (warp shuffles). With one g-tile (G <= 64) the block writes dx0;
//    otherwise it writes a float32 partial per g-tile and
// 2. cin_sum_kernel sums them in a fixed order and rounds to T.
// 3. cin_bwd_dw_kernel: dW(L, F*G) = dz(L, N) @ P(F*G, N)^T, the pair built
//    in shared memory as in K4. The reduction over N, which the TPU carried
//    across its sequential grid, is split: a block owns a 128 x 128 tile of
//    dW and one of `splits` column ranges, and writes a float32 partial.
// 4. cin_sum_kernel sums the partials in a fixed order into dW. No atomics:
//    the result does not depend on the order blocks run in.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, allocates nothing (the caller passes the
// scratch buffers) and returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// K4 and the dW pass: 128 x 128 output tiles, 8 x 8 per thread
constexpr int kTile = 128;
constexpr int kFwdChunk = 8;    // K4: k = (f, g) per shared-memory chunk
constexpr int kDwChunk = 16;    // dW pass: columns n per chunk
// dx0/dh pass
constexpr int kDxCols = 128;    // columns per block
constexpr int kDxChunk = 16;    // l per shared-memory chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Offset of column n of a (B, R, D) tensor's row 0: b*R*D + d.
__device__ __forceinline__ int64_t column(int64_t n, int R, int D) {
  return (n / D) * static_cast<int64_t>(R) * D + n % D;
}

// ---------------------------------------------------------------- K4
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cin_fwd_kernel(const T* __restrict__ x0, const T* __restrict__ h,
                   const T* __restrict__ w, float* __restrict__ z, int64_t N,
                   int F, int G, int L, int D) {
  __shared__ float ws[kFwdChunk][kTile + 1];  // W chunk, [k][l]
  __shared__ float ps[kFwdChunk][kTile];      // pair chunk, [k][n]
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int l0 = blockIdx.y * kTile;
  const int K = F * G;

  // the column this thread builds pair entries for: fixed over the chunks
  const int pn = t % kTile;
  const int64_t pcol = n0 + pn;
  const bool pvalid = pcol < N;
  const int64_t x0col = pvalid ? column(pcol, F, D) : 0;
  const int64_t hcol = pvalid ? column(pcol, G, D) : 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFwdChunk) {
    // W chunk: 128 x 8 values, 4 a thread, k fastest
#pragma unroll
    for (int r = 0; r < (kTile * kFwdChunk) / kThreads; ++r) {
      const int e = t + r * kThreads;
      const int kk = e % kFwdChunk, ll = e / kFwdChunk;
      const int k = k0 + kk, l = l0 + ll;
      ws[kk][ll] = (k < K && l < L)
                       ? to_f32(w[static_cast<int64_t>(l) * K + k])
                       : 0.f;
    }
    // pair chunk: 8 x 128 values, 4 a thread, n fastest
#pragma unroll
    for (int r = 0; r < (kTile * kFwdChunk) / kThreads; ++r) {
      const int kk = t / kTile + r * (kThreads / kTile);
      const int k = k0 + kk;
      float p = 0.f;
      if (pvalid && k < K) {
        const int f = k / G, g = k % G;
        p = to_f32(x0[x0col + static_cast<int64_t>(f) * D]) *
            to_f32(h[hcol + static_cast<int64_t>(g) * D]);
      }
      ps[kk][pn] = p;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFwdChunk; ++kk) {
      float a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ws[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = ps[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const int64_t zcol = column(n, L, D);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int l = l0 + ty + 16 * i;
      if (l < L) z[zcol + static_cast<int64_t>(l) * D] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- K3: dx0, dh
// Thread t holds g = g0 + (t % 16) + 16i (i < TG/16) and columns
// n = n0 + (t / 16) + 16j (j < 8): the 16 threads of one column are the 16
// lanes of a half warp, so the sum over g is a shuffle within it.
template <typename T, int TG>
__global__ void __launch_bounds__(kThreads)
    cin_bwd_dx_kernel(const T* __restrict__ x0, const T* __restrict__ h,
                      const T* __restrict__ w, const T* __restrict__ dz,
                      T* __restrict__ dx0, float* __restrict__ dx0_part,
                      T* __restrict__ dh, int64_t N, int F, int G, int L,
                      int D) {
  constexpr int GI = TG / 16;
  __shared__ float wt[kDxChunk][TG];        // W[l, f, g-tile], [l][g]
  __shared__ float dzs[kDxChunk][kDxCols];  // dz chunk, [l][n]
  const int t = threadIdx.x;
  const int gy = t % 16, nx = t / 16;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kDxCols;
  const int g0 = blockIdx.y * TG;
  const int K = F * G;

  // this thread's columns and its h values, fixed over f
  int64_t x0col[8];
  float hv[GI][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t n = n0 + nx + 16 * j;
    const bool valid = n < N;
    x0col[j] = valid ? column(n, F, D) : -1;
    const int64_t hcol = valid ? column(n, G, D) : 0;
#pragma unroll
    for (int i = 0; i < GI; ++i) {
      const int g = g0 + gy + 16 * i;
      hv[i][j] = (valid && g < G)
                     ? to_f32(h[hcol + static_cast<int64_t>(g) * D])
                     : 0.f;
    }
  }
  // the dz column this thread stages: fixed over the chunks
  const int sn = t % kDxCols;
  const int64_t scol_n = n0 + sn;
  const int64_t dzcol = scol_n < N ? column(scol_n, L, D) : -1;

  float dhacc[GI][8];
#pragma unroll
  for (int i = 0; i < GI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dhacc[i][j] = 0.f;

  for (int f = 0; f < F; ++f) {
    float acc[GI][8];
#pragma unroll
    for (int i = 0; i < GI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int l0 = 0; l0 < L; l0 += kDxChunk) {
#pragma unroll
      for (int r = 0; r < (kDxChunk * TG + kThreads - 1) / kThreads; ++r) {
        const int e = t + r * kThreads;
        if (e < kDxChunk * TG) {
          const int gg = e % TG, ll = e / TG;
          const int g = g0 + gg, l = l0 + ll;
          wt[ll][gg] = (g < G && l < L)
                           ? to_f32(w[static_cast<int64_t>(l) * K +
                                      static_cast<int64_t>(f) * G + g])
                           : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < (kDxChunk * kDxCols) / kThreads; ++r) {
        const int ll = t / kDxCols + r * (kThreads / kDxCols);
        const int l = l0 + ll;
        dzs[ll][sn] = (dzcol >= 0 && l < L)
                          ? to_f32(dz[dzcol + static_cast<int64_t>(l) * D])
                          : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int ll = 0; ll < kDxChunk; ++ll) {
        float a[GI], bv[8];
#pragma unroll
        for (int i = 0; i < GI; ++i) a[i] = wt[ll][gy + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = dzs[ll][nx + 16 * j];
#pragma unroll
        for (int i = 0; i < GI; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // acc = dpair[f, g, n]: fold it into dh and this f's dx0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xv = x0col[j] >= 0
                           ? to_f32(x0[x0col[j] + static_cast<int64_t>(f) * D])
                           : 0.f;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < GI; ++i) {
        dhacc[i][j] = fmaf(acc[i][j], xv, dhacc[i][j]);
        s = fmaf(acc[i][j], hv[i][j], s);
      }
      // every lane reaches the shuffles, those past N included
#pragma unroll
      for (int offset = 8; offset > 0; offset >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, offset, 16);
      if (gy == 0 && x0col[j] >= 0) {
        const int64_t at = x0col[j] + static_cast<int64_t>(f) * D;
        if (dx0_part != nullptr)
          dx0_part[blockIdx.y * N * static_cast<int64_t>(F) + at] = s;
        else
          store(dx0 + at, s);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t n = n0 + nx + 16 * j;
    if (n >= N) continue;
    const int64_t hcol = column(n, G, D);
#pragma unroll
    for (int i = 0; i < GI; ++i) {
      const int g = g0 + gy + 16 * i;
      if (g < G) store(dh + hcol + static_cast<int64_t>(g) * D, dhacc[i][j]);
    }
  }
}

// ---------------------------------------------------------------- K3: dW
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cin_bwd_dw_kernel(const T* __restrict__ x0, const T* __restrict__ h,
                      const T* __restrict__ dz, float* __restrict__ dw_part,
                      int64_t N, int64_t cols_per_split, int F, int G, int L,
                      int D) {
  __shared__ float dzs[kDwChunk][kTile + 1];  // dz chunk, [n][l]
  __shared__ float ps[kDwChunk][kTile + 1];   // pair chunk, [n][k]
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int K = F * G;
  const int k0 = blockIdx.x * kTile;
  const int l0 = blockIdx.y * kTile;
  const int64_t begin = static_cast<int64_t>(blockIdx.z) * cols_per_split;
  const int64_t end = begin + cols_per_split < N ? begin + cols_per_split : N;

  // staging: this thread's column in a chunk, and its rows (l or k)
  const int sn = t % kDwChunk;
  const int srow = t / kDwChunk;  // + 16r
  int pf[kTile / 16], pg[kTile / 16];
#pragma unroll
  for (int r = 0; r < kTile / 16; ++r) {
    const int k = k0 + srow + 16 * r;
    pf[r] = k < K ? k / G : -1;
    pg[r] = k < K ? k % G : 0;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int64_t c0 = begin; c0 < end; c0 += kDwChunk) {
    const int64_t n = c0 + sn;
    const bool valid = n < end;
    const int64_t dzcol = valid ? column(n, L, D) : 0;
    const int64_t x0col = valid ? column(n, F, D) : 0;
    const int64_t hcol = valid ? column(n, G, D) : 0;
#pragma unroll
    for (int r = 0; r < kTile / 16; ++r) {
      const int l = l0 + srow + 16 * r;
      dzs[sn][srow + 16 * r] =
          (valid && l < L) ? to_f32(dz[dzcol + static_cast<int64_t>(l) * D])
                           : 0.f;
      ps[sn][srow + 16 * r] =
          (valid && pf[r] >= 0)
              ? to_f32(x0[x0col + static_cast<int64_t>(pf[r]) * D]) *
                    to_f32(h[hcol + static_cast<int64_t>(pg[r]) * D])
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < kDwChunk; ++nn) {
      float a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = dzs[nn][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = ps[nn][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = dw_part + blockIdx.z * static_cast<int64_t>(L) * K;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = l0 + ty + 16 * i;
    if (l >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < K) out[static_cast<int64_t>(l) * K + k] = acc[i][j];
    }
  }
}

// out[e] = sum_s part[s * size + e], s in order, rounded once to OUT
template <typename OUT>
__global__ void __launch_bounds__(kThreads)
    cin_sum_kernel(const float* __restrict__ part, OUT* __restrict__ out,
                   int64_t size, int parts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < size; e += stride) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += part[p * size + e];
    store(out + e, s);
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool bad_shape(int64_t N, int F, int G, int L, int D) {
  return N < 1 || F < 1 || G < 1 || L < 1 || D < 1 ||
         static_cast<int64_t>(F) * G > 0x7fffffff ||
         ceil_div(N, kTile) > 0x7fffffff || ceil_div(L, kTile) > 65535;
}

template <typename OUT>
cudaError_t launch_sum(const float* part, OUT* out, int64_t size, int parts,
                       cudaStream_t stream) {
  const int64_t blocks = ceil_div(size, kThreads);
  const unsigned grid = static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
  cin_sum_kernel<OUT><<<grid, kThreads, 0, stream>>>(part, out, size, parts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const T* x0, const T* h, const T* w, float* z,
                       int64_t B, int F, int G, int L, int D,
                       cudaStream_t stream) {
  const int64_t N = B * D;
  if (B < 1 || bad_shape(N, F, G, L, D)) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(ceil_div(N, kTile)),
                  static_cast<unsigned>(ceil_div(L, kTile)));
  cin_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(x0, h, w, z, N, F, G, L, D);
  return cudaGetLastError();
}

// dx0_part: (ceil(G / tg) * B*F*D) float32 when G > 64, else unused.
// dw_part: (splits * L*F*G) float32.
template <typename T>
cudaError_t launch_bwd(const T* x0, const T* h, const T* w, const T* dz,
                       T* dx0, T* dh, float* dw, float* dx0_part,
                       float* dw_part, int64_t B, int F, int G, int L, int D,
                       int splits, cudaStream_t stream) {
  const int64_t N = B * D;
  if (B < 1 || splits < 1 || bad_shape(N, F, G, L, D))
    return cudaErrorInvalidValue;
  const int tg = G <= 32 ? 32 : 64;
  const int gtiles = static_cast<int>(ceil_div(G, tg));
  if (gtiles > 1 && dx0_part == nullptr) return cudaErrorInvalidValue;
  const dim3 dx_grid(static_cast<unsigned>(ceil_div(N, kDxCols)),
                     static_cast<unsigned>(gtiles));
  float* part = gtiles > 1 ? dx0_part : nullptr;
  if (tg == 32)
    cin_bwd_dx_kernel<T, 32><<<dx_grid, kThreads, 0, stream>>>(
        x0, h, w, dz, dx0, part, dh, N, F, G, L, D);
  else
    cin_bwd_dx_kernel<T, 64><<<dx_grid, kThreads, 0, stream>>>(
        x0, h, w, dz, dx0, part, dh, N, F, G, L, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (gtiles > 1) {
    err = launch_sum<T>(dx0_part, dx0, N * F, gtiles, stream);
    if (err != cudaSuccess) return err;
  }

  const int64_t K = static_cast<int64_t>(F) * G;
  const int64_t cols = ceil_div(ceil_div(N, splits), kDwChunk) * kDwChunk;
  const dim3 dw_grid(static_cast<unsigned>(ceil_div(K, kTile)),
                     static_cast<unsigned>(ceil_div(L, kTile)),
                     static_cast<unsigned>(splits));
  cin_bwd_dw_kernel<T><<<dw_grid, kThreads, 0, stream>>>(
      x0, h, dz, dw_part, N, cols, F, G, L, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum<float>(dw_part, dw, L * K, splits, stream);
}

}  // namespace

extern "C" {

int dt_cin_fwd_f32(const void* x0, const void* h, const void* w, void* z,
                   int64_t B, int F, int G, int L, int D, void* stream) {
  return static_cast<int>(launch_fwd(
      static_cast<const float*>(x0), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<float*>(z), B, F, G, L, D,
      static_cast<cudaStream_t>(stream)));
}

int dt_cin_fwd_bf16(const void* x0, const void* h, const void* w, void* z,
                    int64_t B, int F, int G, int L, int D, void* stream) {
  return static_cast<int>(launch_fwd(
      static_cast<const __nv_bfloat16*>(x0),
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(z), B, F, G,
      L, D, static_cast<cudaStream_t>(stream)));
}

int dt_cin_bwd_f32(const void* x0, const void* h, const void* w,
                   const void* dz, void* dx0, void* dh, void* dw,
                   void* dx0_part, void* dw_part, int64_t B, int F, int G,
                   int L, int D, int splits, void* stream) {
  return static_cast<int>(launch_bwd(
      static_cast<const float*>(x0), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(dz),
      static_cast<float*>(dx0), static_cast<float*>(dh),
      static_cast<float*>(dw), static_cast<float*>(dx0_part),
      static_cast<float*>(dw_part), B, F, G, L, D, splits,
      static_cast<cudaStream_t>(stream)));
}

int dt_cin_bwd_bf16(const void* x0, const void* h, const void* w,
                    const void* dz, void* dx0, void* dh, void* dw,
                    void* dx0_part, void* dw_part, int64_t B, int F, int G,
                    int L, int D, int splits, void* stream) {
  return static_cast<int>(launch_bwd(
      static_cast<const __nv_bfloat16*>(x0),
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(dz),
      static_cast<__nv_bfloat16*>(dx0), static_cast<__nv_bfloat16*>(dh),
      static_cast<float*>(dw), static_cast<float*>(dx0_part),
      static_cast<float*>(dw_part), B, F, G, L, D, splits,
      static_cast<cudaStream_t>(stream)));
}

const char* dt_cin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
