// Field attention (AutoInt's interacting layer), forward and backward, and the
// fused attention block, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces deeptables_tpu/ops/kernels/field_attention.py:
//   K5-fwd  field_attention / _fwd_kernel     o = softmax_g(q k^T * scale) v
//   K5-bwd  _fa_bwd / _bwd_kernel             dq, dk, dv (softmax recomputed)
//   K6-fwd  attention_block / _ab_fwd_kernel  relu(w_aug^T [x;1]) -> q, k, v, r;
//                                             out = relu(attention + r)
//   K6-bwd  _ab_bwd / _ab_bwd_kernel          dpre = 1[pre > 0] * [dq;dk;dv;dr]
//
// Layouts. The TPU kernels took (H, F, dh, B) operands, the batch on the lane
// axis. Here every operand is the projection's own (B, F, U) layout, U = H*dh,
// contiguous: head h of field f of example b is columns h*dh .. h*dh + dh - 1
// of row (b, f), as the JAX package's split takes it. No transposes.
// w_aug is (U + 1, 4U) = [[Wq | Wk | Wv | Wr]; [bq | bk | bv | br]], already in
// x's type; dpre is (B, F, 4U) in x's type.
//
// What bounds them: memory. Per example and head the attention is an F x F
// product with a depth of dh (F = 22, dh = 8 on the AutoInt configuration):
// about 4*F*F*dh float operations for 2*F*U*itemsize bytes moved, ~11
// operations a byte in bfloat16, far under the card's ~20 (float32 CUDA cores)
// or ~295 (tensor cores). The least time is the bytes: q, k, v read once and o
// written once (K5-fwd); q, k, v, do read and dq, dk, dv written (K5-bwd); x
// read and out written (K6-fwd); x, do read and dpre written (K6-bwd).
//
// Design. One warp owns one example b; a block holds up to 8 warps. The warp
// copies the example's rows into shared memory as float32 (coalesced: the
// example's F*U values are contiguous), then works per head h with lane =
// query field f (looping for F > 32): its score row over g goes to a row of an
// F x F shared buffer, the max-subtracted softmax is taken in float32, and the
// context is summed in float32 registers (up to 64 values at a time).
// Outputs are staged back into shared memory and written coalesced, rounded
// once to the output type. The scores, the weights and (in K6) the four
// projections never reach device memory. Rows of the shared buffers are padded to an odd
// stride, so a warp reading a column (lane = row) hits 32 distinct banks.
//
// The backward sums over the query field f for dv and dk cross lanes. They are
// done without atomics, so results are deterministic: pass A (lane = f) writes
// the weights w and ds = w * (dw - sum_g w*dw) * scale to shared memory, pass B
// (lane = g) reads them by column and sums dv[g] and dk[g] over f, pass C
// (lane = f) sums dq[f] over g. Each output lands in shared memory where its
// input is no longer read (dv over v; dq over q after pass B), dk in a scratch
// buffer.
//
// K6 adds the projection of x by w_aug, which the block stages once in shared
// memory for all its warps; q, k, v and r stay float32 (not rounded), as in
// the TPU kernel. Its backward recomputes them, then masks exactly as the JAX
// VJP: dctx = dr = 1[ctx + r > 0] * do, dpre = 1[pre > 0] * [dq; dk; dv; dr]
// (strict: the derivative of relu at 0 is 0; pre > 0 exactly where post > 0).
// The two products of the K6 gradient (dW = [x;1] dpre^T, dx = w_aug dpre) run
// outside the kernel, as they ran in XLA outside the TPU kernel.
//
// Every shape: any B, any F, any dh, any U.
// - Heads wider than the register width DHM (64) are worked on in slices of
//   64: the score and score-gradient dot products sum over the slices,
//   reading q and do from the buffers, and each context or gradient slice is
//   summed in registers and written before the next.
// - One warp's buffers (K5), or K6's w_aug beside one warp's, that do not fit
//   in a block's 227 KB of shared memory live in a scratch buffer in device
//   memory that the wrapper allocates (dt_fa_scratch_floats floats): a fixed
//   grid of 4-warp blocks walks the examples, each warp reusing its slice of
//   the scratch. K6 reads a float32 copy of w_aug from device memory where
//   w_aug alone does not fit in shared memory (dt_ab_w_in_smem). Slow and
//   right; every shape that fits runs as before.
// Every kernel walks its examples in a grid-stride loop (one pass where the
// buffers are in shared memory, whose grid covers B).
//
// Plain C interface for ctypes: each entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (or the error of the
// shared-memory attribute call, made once per kernel).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
// Two blocks an SM when the buffers allow it.
constexpr int kTargetSmemBytes = 113 * 1024;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, a block's limit on Hopper
// Buffers in device memory: blocks of 4 warps, two a SM's worth of blocks,
// at most 256 MB of scratch.
constexpr int kScratchWarps = 4;
constexpr int kScratchBlocks = 2 * 132;
constexpr int64_t kMaxScratchFloats = int64_t(64) << 20;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// An odd row stride: a column read (lane = row) meets 32 distinct banks.
__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }

// The warp copies `rows` x `cols` contiguous values of src into dst (row
// stride ld), as float32.
template <typename S>
__device__ __forceinline__ void load_rows(float* dst, int ld, const S* src,
                                          int rows, int cols, int lane) {
  const int n = rows * cols;
  for (int i = lane; i < n; i += 32) {
    const int r = i / cols;
    dst[r * ld + i - r * cols] = to_f32(src[i]);
  }
}

template <typename S>
__device__ __forceinline__ void store_rows(S* dst, const float* src, int ld,
                                           int rows, int cols, int lane) {
  const int n = rows * cols;
  for (int i = lane; i < n; i += 32) {
    const int r = i / cols;
    store(dst + i, src[r * ld + i - r * cols]);
  }
}

// Where a kernel keeps its buffers, a template argument so that the
// compiler knows the address space of every access (shared-memory loads,
// not generic ones, on the main path).
enum Mode {
  kShared = 0,        // the warps' buffers (and K6's w_aug) in shared memory
  kScratch = 1,       // the warps' buffers in the scratch, w_aug shared
  kScratchWGlobal = 2 // ... and K6 reads the float32 copy of w_aug
};

// The warp's buffers: in shared memory after `base`, or its slice of the
// scratch.
template <int MODE>
__device__ __forceinline__ float* warp_buffers(float* base, float* scratch,
                                               int per_warp) {
  const int warp = threadIdx.x / 32;
  if constexpr (MODE == kShared)
    return base + static_cast<size_t>(warp) * per_warp;
  return scratch + (static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                    warp) * per_warp;
}

template <int DHM>
__device__ __forceinline__ void load_head(float* r, const float* src, int n) {
#pragma unroll
  for (int d = 0; d < DHM; ++d) r[d] = d < n ? src[d] : 0.f;
}

// The width of the head slice at c: DHM, or what is left of dh.
template <int DHM>
__device__ __forceinline__ int slice(int dh, int c) {
  return dh - c < DHM ? dh - c : DHM;
}

// Row f of the softmax: wrow[g] = softmax_g(scale * q_f . k_g), q_f a row of
// dh values and k rows (stride ld), both in the buffers. wrow holds the
// weights e / z, as the TPU kernel forms them.
template <int DHM>
__device__ __forceinline__ void softmax_row(float* wrow, const float* q,
                                            const float* k, int ld, int F,
                                            int dh, float scale) {
  float m = neg_inf();
  for (int c = 0; c < dh; c += DHM) {
    const int n = slice<DHM>(dh, c);
    const bool last = c + DHM >= dh;
    float qr[DHM];
    load_head<DHM>(qr, q + c, n);
    for (int g = 0; g < F; ++g) {
      const float* kr = k + g * ld + c;
      float s = c == 0 ? 0.f : wrow[g];
#pragma unroll
      for (int d = 0; d < DHM; ++d)
        if (d < n) s = fmaf(qr[d], kr[d], s);
      if (last) {
        s *= scale;
        m = fmaxf(m, s);
      }
      wrow[g] = s;
    }
  }
  float z = 0.f;
  for (int g = 0; g < F; ++g) {
    const float e = expf(wrow[g] - m);
    wrow[g] = e;
    z += e;
  }
  for (int g = 0; g < F; ++g) wrow[g] = wrow[g] / z;
}

// acc[d] = sum_g w[g] * v[g*ld + d], d < n
template <int DHM>
__device__ __forceinline__ void weighted_sum(float* acc, const float* w,
                                             int wstride, const float* v,
                                             int ld, int rows, int n) {
#pragma unroll
  for (int d = 0; d < DHM; ++d) acc[d] = 0.f;
  for (int g = 0; g < rows; ++g) {
    const float wg = w[g * wstride];
    const float* vr = v + g * ld;
#pragma unroll
    for (int d = 0; d < DHM; ++d)
      if (d < n) acc[d] = fmaf(wg, vr[d], acc[d]);
  }
}

// ds row: drow[g] = w[g] * (dw[g] - sum_g' w[g'] dw[g']) * scale, with
// dw[g] = dc . v_g, dc a row of dh values in the buffers
template <int DHM>
__device__ __forceinline__ void softmax_grad_row(float* drow, const float* wrow,
                                                 const float* dc,
                                                 const float* v, int ld, int F,
                                                 int dh, float scale) {
  float t = 0.f;
  for (int c = 0; c < dh; c += DHM) {
    const int n = slice<DHM>(dh, c);
    const bool last = c + DHM >= dh;
    float dr[DHM];
    load_head<DHM>(dr, dc + c, n);
    for (int g = 0; g < F; ++g) {
      const float* vr = v + g * ld + c;
      float dw = c == 0 ? 0.f : drow[g];
#pragma unroll
      for (int d = 0; d < DHM; ++d)
        if (d < n) dw = fmaf(dr[d], vr[d], dw);
      drow[g] = dw;
      if (last) t = fmaf(wrow[g], dw, t);
    }
  }
  for (int g = 0; g < F; ++g) drow[g] = wrow[g] * (drow[g] - t) * scale;
}

// ---------------------------------------------------------------- K5 forward

__host__ __device__ __forceinline__ int fa_fwd_floats(int F, int U) {
  return 3 * F * odd(U) + F * odd(F);
}

template <typename T, typename TO, int DHM, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, TO* __restrict__ out, int64_t B,
                  int F, int H, int dh, float scale, float* scratch) {
  extern __shared__ float smem[];
  const int U = H * dh, UP = odd(U), FP = odd(F);
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  float* qs = warp_buffers<MODE>(smem, scratch, fa_fwd_floats(F, U));
  float* ks = qs + F * UP;
  float* vs = ks + F * UP;
  float* ws = vs + F * UP;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * warps + threadIdx.x / 32;
       b < B; b += static_cast<int64_t>(gridDim.x) * warps) {
    const int64_t base = b * F * U;
    load_rows(qs, UP, q + base, F, U, lane);
    load_rows(ks, UP, k + base, F, U, lane);
    load_rows(vs, UP, v + base, F, U, lane);
    __syncwarp();
    for (int h = 0; h < H; ++h) {
      const int c0 = h * dh;
      for (int f = lane; f < F; f += 32) {
        float* wrow = ws + f * FP;
        float* qrow = qs + f * UP + c0;
        softmax_row<DHM>(wrow, qrow, ks + c0, UP, F, dh, scale);
        // only this lane reads q's row f: the context takes its place
        for (int c = 0; c < dh; c += DHM) {
          const int n = slice<DHM>(dh, c);
          float acc[DHM];
          weighted_sum<DHM>(acc, wrow, 1, vs + c0 + c, UP, F, n);
#pragma unroll
          for (int d = 0; d < DHM; ++d)
            if (d < n) qrow[c + d] = acc[d];
        }
      }
    }
    __syncwarp();
    store_rows(out + base, qs, UP, F, U, lane);
    __syncwarp();
  }
}

// --------------------------------------------------------------- K5 backward

__host__ __device__ __forceinline__ int fa_bwd_floats(int F, int U) {
  return 5 * F * odd(U) + 2 * F * odd(F);
}

template <typename T, typename TO, int DHM, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32)
    fa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const TO* __restrict__ dout,
                  T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                  int64_t B, int F, int H, int dh, float scale,
                  float* scratch) {
  extern __shared__ float smem[];
  const int U = H * dh, UP = odd(U), FP = odd(F);
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  float* qs = warp_buffers<MODE>(smem, scratch, fa_bwd_floats(F, U));
  float* ks = qs + F * UP;
  float* vs = ks + F * UP;
  float* dos = vs + F * UP;
  float* dks = dos + F * UP;  // dk, all heads
  float* ws = dks + F * UP;
  float* dss = ws + F * FP;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * warps + threadIdx.x / 32;
       b < B; b += static_cast<int64_t>(gridDim.x) * warps) {
    const int64_t base = b * F * U;
    load_rows(qs, UP, q + base, F, U, lane);
    load_rows(ks, UP, k + base, F, U, lane);
    load_rows(vs, UP, v + base, F, U, lane);
    load_rows(dos, UP, dout + base, F, U, lane);
    __syncwarp();
    for (int h = 0; h < H; ++h) {
      const int c0 = h * dh;
      // pass A, lane = f: the weights and ds rows
      for (int f = lane; f < F; f += 32) {
        softmax_row<DHM>(ws + f * FP, qs + f * UP + c0, ks + c0, UP, F, dh,
                         scale);
        softmax_grad_row<DHM>(dss + f * FP, ws + f * FP, dos + f * UP + c0,
                              vs + c0, UP, F, dh, scale);
      }
      __syncwarp();
      // pass B, lane = g: dv[g] = sum_f w[f,g] do[f], dk[g] = sum_f ds[f,g]
      // q[f]
      for (int g = lane; g < F; g += 32) {
        for (int c = 0; c < dh; c += DHM) {
          const int n = slice<DHM>(dh, c);
          float dvr[DHM], dkr[DHM];
          weighted_sum<DHM>(dvr, ws + g, FP, dos + c0 + c, UP, F, n);
          weighted_sum<DHM>(dkr, dss + g, FP, qs + c0 + c, UP, F, n);
#pragma unroll
          for (int d = 0; d < DHM; ++d) {
            if (d < n) {
              vs[g * UP + c0 + c + d] = dvr[d];  // v of head h is read no more
              dks[g * UP + c0 + c + d] = dkr[d];
            }
          }
        }
      }
      __syncwarp();
      // pass C, lane = f: dq[f] = sum_g ds[f,g] k[g]
      for (int f = lane; f < F; f += 32) {
        for (int c = 0; c < dh; c += DHM) {
          const int n = slice<DHM>(dh, c);
          float dqr[DHM];
          weighted_sum<DHM>(dqr, dss + f * FP, 1, ks + c0 + c, UP, F, n);
#pragma unroll
          for (int d = 0; d < DHM; ++d)
            if (d < n) qs[f * UP + c0 + c + d] = dqr[d];  // q of head h: done
        }
      }
      __syncwarp();
    }
    store_rows(dq + base, qs, UP, F, U, lane);
    store_rows(dk + base, dks, UP, F, U, lane);
    store_rows(dv + base, vs, UP, F, U, lane);
    __syncwarp();
  }
}

// ---------------------------------------------------------------- K6 forward

__host__ __device__ __forceinline__ int ab_shared_floats(int U) {
  return (U + 1) * 4 * U;
}
__host__ __device__ __forceinline__ int ab_fwd_floats(int F, int U) {
  return F * odd(U) + F * odd(4 * U) + F * odd(F);
}
__host__ __device__ __forceinline__ int ab_bwd_floats(int F, int U) {
  return 2 * F * odd(U) + F * odd(4 * U) + 2 * F * odd(F);
}

// The block stages w_aug (U + 1, 4U) as float32 in shared memory, unless
// it reads w_f32, a float32 copy in device memory (kScratchWGlobal).
template <int MODE, typename T>
__device__ __forceinline__ void stage_w_aug(float* smem, const T* w_aug,
                                            int U) {
  if constexpr (MODE != kScratchWGlobal) {
    const int n = ab_shared_floats(U);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      smem[i] = to_f32(w_aug[i]);
    __syncthreads();
  }
}

// post[f, j] = relu(sum_u x[f,u] w[u,j] + w[U,j]) for the warp's F rows.
__device__ __forceinline__ void project(float* ps, int PP, const float* xs,
                                        int UP, const float* wsm, int F, int U,
                                        int lane) {
  const int U4 = 4 * U;
  for (int f = lane; f < F; f += 32) {
    const float* xr = xs + f * UP;
    for (int j = 0; j < U4; ++j) {
      float s = 0.f;
      for (int u = 0; u < U; ++u) s = fmaf(xr[u], wsm[u * U4 + j], s);
      s += wsm[U * U4 + j];
      ps[f * PP + j] = fmaxf(s, 0.f);
    }
  }
}

template <typename T, int DHM, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ab_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_aug,
                  T* __restrict__ out, int64_t B, int F, int H, int dh,
                  float scale, float* scratch, const float* w_f32) {
  extern __shared__ float smem[];
  const int U = H * dh, UP = odd(U), PP = odd(4 * U), FP = odd(F);
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  stage_w_aug<MODE>(smem, w_aug, U);
  const float* wsm = MODE == kScratchWGlobal ? w_f32 : smem;
  float* xs = warp_buffers<MODE>(smem + ab_shared_floats(U), scratch,
                                 ab_fwd_floats(F, U));
  float* ps = xs + F * UP;
  float* ws = ps + F * PP;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * warps + threadIdx.x / 32;
       b < B; b += static_cast<int64_t>(gridDim.x) * warps) {
    const int64_t base = b * F * U;
    load_rows(xs, UP, x + base, F, U, lane);
    __syncwarp();
    project(ps, PP, xs, UP, wsm, F, U, lane);
    __syncwarp();
    for (int h = 0; h < H; ++h) {
      const int c0 = h * dh;
      for (int f = lane; f < F; f += 32) {
        float* wrow = ws + f * FP;
        const float* pr = ps + f * PP;
        softmax_row<DHM>(wrow, pr + c0, ps + U + c0, PP, F, dh, scale);
        // x's row f was read by this lane only, in the projection
        for (int c = 0; c < dh; c += DHM) {
          const int n = slice<DHM>(dh, c);
          float acc[DHM];
          weighted_sum<DHM>(acc, wrow, 1, ps + 2 * U + c0 + c, PP, F, n);
#pragma unroll
          for (int d = 0; d < DHM; ++d)
            if (d < n)
              xs[f * UP + c0 + c + d] =
                  fmaxf(acc[d] + pr[3 * U + c0 + c + d], 0.f);
        }
      }
    }
    __syncwarp();
    store_rows(out + base, xs, UP, F, U, lane);
    __syncwarp();
  }
}

// --------------------------------------------------------------- K6 backward

template <typename T, int DHM, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ab_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w_aug,
                  const T* __restrict__ dout, T* __restrict__ dpre, int64_t B,
                  int F, int H, int dh, float scale, float* scratch,
                  const float* w_f32) {
  extern __shared__ float smem[];
  const int U = H * dh, UP = odd(U), PP = odd(4 * U), FP = odd(F);
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  stage_w_aug<MODE>(smem, w_aug, U);
  const float* wsm = MODE == kScratchWGlobal ? w_f32 : smem;
  float* xs = warp_buffers<MODE>(smem + ab_shared_floats(U), scratch,
                                 ab_bwd_floats(F, U));
  float* dks = xs + F * UP;  // dk of the current head
  float* ps = dks + F * UP;  // post, turned into dpre in place
  float* ws = ps + F * PP;
  float* dss = ws + F * FP;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * warps + threadIdx.x / 32;
       b < B; b += static_cast<int64_t>(gridDim.x) * warps) {
    const int64_t base = b * F * U;
    load_rows(xs, UP, x + base, F, U, lane);
    __syncwarp();
    project(ps, PP, xs, UP, wsm, F, U, lane);
    __syncwarp();
    load_rows(xs, UP, dout + base, F, U, lane);  // x is read no more
    __syncwarp();
    for (int h = 0; h < H; ++h) {
      const int c0 = h * dh;
      float* qc = ps + c0;
      float* kc = ps + U + c0;
      float* vc = ps + 2 * U + c0;
      float* rc = ps + 3 * U + c0;
      // pass A, lane = f: weights, context, the masks, dr and the ds row
      for (int f = lane; f < F; f += 32) {
        float* wrow = ws + f * FP;
        softmax_row<DHM>(wrow, qc + f * PP, kc, PP, F, dh, scale);
        for (int c = 0; c < dh; c += DHM) {
          const int n = slice<DHM>(dh, c);
          float ctx[DHM];
          weighted_sum<DHM>(ctx, wrow, 1, vc + c, PP, F, n);
#pragma unroll
          for (int d = 0; d < DHM; ++d) {
            if (d < n) {
              const float r = rc[f * PP + c + d];
              const float g = xs[f * UP + c0 + c + d];
              const float dc = ctx[d] + r > 0.f ? g : 0.f;
              xs[f * UP + c0 + c + d] = dc;          // dctx, read by pass B
              rc[f * PP + c + d] = r > 0.f ? dc : 0.f;  // dpre of r
            }
          }
        }
        softmax_grad_row<DHM>(dss + f * FP, wrow, xs + f * UP + c0, vc, PP, F,
                              dh, scale);
      }
      __syncwarp();
      // pass B, lane = g: dv[g] = sum_f w[f,g] dctx[f], dk[g] = sum_f ds[f,g]
      // q[f]
      for (int g = lane; g < F; g += 32) {
        for (int c = 0; c < dh; c += DHM) {
          const int n = slice<DHM>(dh, c);
          float dvr[DHM], dkr[DHM];
          weighted_sum<DHM>(dvr, ws + g, FP, xs + c0 + c, UP, F, n);
          weighted_sum<DHM>(dkr, dss + g, FP, qc + c, PP, F, n);
#pragma unroll
          for (int d = 0; d < DHM; ++d) {
            if (d < n) {
              const float vv = vc[g * PP + c + d];  // v is read no more
              vc[g * PP + c + d] = vv > 0.f ? dvr[d] : 0.f;
              dks[g * UP + c0 + c + d] = dkr[d];
            }
          }
        }
      }
      __syncwarp();
      // pass C, lane = f: dq[f] = sum_g ds[f,g] k[g]
      for (int f = lane; f < F; f += 32) {
        for (int c = 0; c < dh; c += DHM) {
          const int n = slice<DHM>(dh, c);
          float dqr[DHM];
          weighted_sum<DHM>(dqr, dss + f * FP, 1, kc + c, PP, F, n);
#pragma unroll
          for (int d = 0; d < DHM; ++d) {
            if (d < n) {
              const float qq = qc[f * PP + c + d];
              qc[f * PP + c + d] = qq > 0.f ? dqr[d] : 0.f;
            }
          }
        }
      }
      __syncwarp();
      // k is read no more: its dpre takes its place
      for (int g = lane; g < F; g += 32) {
        for (int d = 0; d < dh; ++d) {
          const float kk = kc[g * PP + d];
          kc[g * PP + d] = kk > 0.f ? dks[g * UP + c0 + d] : 0.f;
        }
      }
      __syncwarp();
    }
    store_rows(dpre + base * 4, ps, PP, F, 4 * U, lane);
    __syncwarp();
  }
}

// ------------------------------------------------------------------ launches

enum Kind { kFaFwd = 0, kFaBwd = 1, kAbFwd = 2, kAbBwd = 3 };

// Floats of one warp's buffers, and of the block's (K6's w_aug).
int64_t per_warp_floats(int kind, int F, int U) {
  switch (kind) {
    case kFaFwd: return fa_fwd_floats(F, U);
    case kFaBwd: return fa_bwd_floats(F, U);
    case kAbFwd: return ab_fwd_floats(F, U);
    default: return ab_bwd_floats(F, U);
  }
}
int64_t shared_floats(int kind, int U) {
  return kind == kAbFwd || kind == kAbBwd ? ab_shared_floats(U) : 0;
}

bool w_in_smem(int U) { return 4ll * ab_shared_floats(U) <= kMaxSmemBytes; }

struct Plan {
  dim3 grid, block;
  size_t smem;
  int64_t scratch_floats;  // 0: the warps' buffers are in shared memory
};

// Warps a block, blocks and shared memory for B examples; buffers in device
// memory where one warp's do not fit beside the block's.
Plan plan_for(int kind, int64_t B, int F, int U) {
  const int64_t pw = per_warp_floats(kind, F, U);
  const int64_t sh = shared_floats(kind, U);
  Plan p;
  if (4 * (sh + pw) <= kMaxSmemBytes) {
    int64_t w = (kTargetSmemBytes - 4 * sh) / (4 * pw);
    w = w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
    int64_t blocks = (B + w - 1) / w;
    if (blocks > 0x7fffffff) blocks = 0x7fffffff;
    p.grid = dim3(static_cast<unsigned>(blocks));
    p.block = dim3(32 * static_cast<unsigned>(w));
    p.smem = 4 * (sh + w * pw);
    p.scratch_floats = 0;
    return p;
  }
  int64_t blocks = (B + kScratchWarps - 1) / kScratchWarps;
  if (blocks > kScratchBlocks) blocks = kScratchBlocks;
  const int64_t most = kMaxScratchFloats / (kScratchWarps * pw);
  if (blocks > most) blocks = most < 1 ? 1 : most;
  p.grid = dim3(static_cast<unsigned>(blocks));
  p.block = dim3(32 * kScratchWarps);
  p.smem = sh > 0 && w_in_smem(U) ? 4 * sh : 0;
  p.scratch_floats = blocks * kScratchWarps * pw;
  return p;
}

bool valid(int64_t B, int F, int H, int dh) {
  return B >= 1 && F >= 1 && H >= 1 && dh >= 1 &&
         static_cast<int64_t>(F) * odd(4 * H * dh) < 0x7fffffff &&
         static_cast<int64_t>(H * dh + 1) * 4 * H * dh < 0x7fffffff;
}

// Where a launch keeps its buffers: in shared memory where they fit.
int mode_for(int kind, int64_t B, int F, int U) {
  if (plan_for(kind, B, F, U).scratch_floats == 0) return kShared;
  return shared_floats(kind, U) > 0 && !w_in_smem(U) ? kScratchWGlobal
                                                       : kScratch;
}

// The plan of a launch, checked against the scratch and w_aug copy given;
// the kernel's shared-memory limit raised to the block's maximum the first
// time (`attr`, one for each kernel).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, cudaError_t* attr, int kind, int64_t B,
                    int F, int U, const float* scratch, const float* w_f32,
                    Plan* plan) {
  *plan = plan_for(kind, B, F, U);
  if (plan->scratch_floats > 0 && scratch == nullptr)
    return cudaErrorInvalidValue;
  if (shared_floats(kind, U) > 0 && !w_in_smem(U) && w_f32 == nullptr)
    return cudaErrorInvalidValue;
  if (*attr == cudaErrorNotReady)
    *attr = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmemBytes);
  return *attr;
}

// Calls BODY with MODE and DHM: on the shared-memory path the register width
// for dh; with the buffers in the scratch 64 (slices of 64, any dh: one
// instantiation for those rare shapes).
#define DT_FA_DISPATCH(KIND, BODY)                                        \
  do {                                                                    \
    if (!valid(B, F, H, dh)) return cudaErrorInvalidValue;                \
    const int mode = mode_for(KIND, B, F, H * dh);                        \
    if (mode != kShared) {                                                \
      constexpr int DHM = 64;                                             \
      if (mode == kScratch) {                                             \
        constexpr int MODE = kScratch;                                    \
        BODY;                                                             \
      } else {                                                            \
        constexpr int MODE = (KIND == kAbFwd || KIND == kAbBwd)           \
                                 ? kScratchWGlobal                        \
                                 : kScratch;                              \
        BODY;                                                             \
      }                                                                   \
    }                                                                     \
    constexpr int MODE = kShared;                                         \
    if (dh <= 8) {                                                        \
      constexpr int DHM = 8;                                              \
      BODY;                                                               \
    } else if (dh <= 16) {                                                \
      constexpr int DHM = 16;                                             \
      BODY;                                                               \
    } else if (dh <= 32) {                                                \
      constexpr int DHM = 32;                                             \
      BODY;                                                               \
    } else {                                                              \
      constexpr int DHM = 64;                                             \
      BODY;                                                               \
    }                                                                     \
  } while (0)

template <typename T, typename TO, int DHM, int MODE>
cudaError_t fa_fwd_launch(const T* q, const T* k, const T* v, TO* out,
                          int64_t B, int F, int H, int dh, float scale,
                          float* scratch, cudaStream_t stream) {
  static cudaError_t attr = cudaErrorNotReady;
  auto kernel = fa_fwd_kernel<T, TO, DHM, MODE>;
  Plan p;
  const cudaError_t err =
      prepare(kernel, &attr, kFaFwd, B, F, H * dh, scratch, nullptr, &p);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.block, p.smem, stream>>>(q, k, v, out, B, F, H, dh, scale,
                                              scratch);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t fa_fwd(const void* q, const void* k, const void* v, void* out,
                   int64_t B, int F, int H, int dh, float scale, void* scratch,
                   void* stream) {
  DT_FA_DISPATCH(kFaFwd, return (fa_fwd_launch<T, TO, DHM, MODE>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<TO*>(out), B, F, H, dh, scale,
      static_cast<float*>(scratch), static_cast<cudaStream_t>(stream))));
}

template <typename T, typename TO, int DHM, int MODE>
cudaError_t fa_bwd_launch(const T* q, const T* k, const T* v, const TO* dout,
                          T* dq, T* dk, T* dv, int64_t B, int F, int H, int dh,
                          float scale, float* scratch, cudaStream_t stream) {
  static cudaError_t attr = cudaErrorNotReady;
  auto kernel = fa_bwd_kernel<T, TO, DHM, MODE>;
  Plan p;
  const cudaError_t err =
      prepare(kernel, &attr, kFaBwd, B, F, H * dh, scratch, nullptr, &p);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.block, p.smem, stream>>>(q, k, v, dout, dq, dk, dv, B, F,
                                              H, dh, scale, scratch);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t fa_bwd(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv, int64_t B,
                   int F, int H, int dh, float scale, void* scratch,
                   void* stream) {
  DT_FA_DISPATCH(kFaBwd, return (fa_bwd_launch<T, TO, DHM, MODE>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TO*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), B, F, H,
      dh, scale, static_cast<float*>(scratch),
      static_cast<cudaStream_t>(stream))));
}

template <typename T, int DHM, int MODE>
cudaError_t ab_fwd_launch(const T* x, const T* w_aug, T* out, int64_t B, int F,
                          int H, int dh, float scale, float* scratch,
                          const float* w_f32, cudaStream_t stream) {
  static cudaError_t attr = cudaErrorNotReady;
  auto kernel = ab_fwd_kernel<T, DHM, MODE>;
  Plan p;
  const cudaError_t err =
      prepare(kernel, &attr, kAbFwd, B, F, H * dh, scratch, w_f32, &p);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.block, p.smem, stream>>>(x, w_aug, out, B, F, H, dh,
                                              scale, scratch, w_f32);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ab_fwd(const void* x, const void* w_aug, void* out, int64_t B,
                   int F, int H, int dh, float scale, void* scratch,
                   const void* w_f32, void* stream) {
  DT_FA_DISPATCH(kAbFwd, return (ab_fwd_launch<T, DHM, MODE>(
      static_cast<const T*>(x), static_cast<const T*>(w_aug),
      static_cast<T*>(out), B, F, H, dh, scale, static_cast<float*>(scratch),
      static_cast<const float*>(w_f32), static_cast<cudaStream_t>(stream))));
}

template <typename T, int DHM, int MODE>
cudaError_t ab_bwd_launch(const T* x, const T* w_aug, const T* dout, T* dpre,
                          int64_t B, int F, int H, int dh, float scale,
                          float* scratch, const float* w_f32,
                          cudaStream_t stream) {
  static cudaError_t attr = cudaErrorNotReady;
  auto kernel = ab_bwd_kernel<T, DHM, MODE>;
  Plan p;
  const cudaError_t err =
      prepare(kernel, &attr, kAbBwd, B, F, H * dh, scratch, w_f32, &p);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.block, p.smem, stream>>>(x, w_aug, dout, dpre, B, F, H,
                                              dh, scale, scratch, w_f32);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ab_bwd(const void* x, const void* w_aug, const void* dout,
                   void* dpre, int64_t B, int F, int H, int dh, float scale,
                   void* scratch, const void* w_f32, void* stream) {
  DT_FA_DISPATCH(kAbBwd, return (ab_bwd_launch<T, DHM, MODE>(
      static_cast<const T*>(x), static_cast<const T*>(w_aug),
      static_cast<const T*>(dout), static_cast<T*>(dpre), B, F, H, dh, scale,
      static_cast<float*>(scratch), static_cast<const float*>(w_f32),
      static_cast<cudaStream_t>(stream))));
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// Floats of device-memory scratch a launch of `kind` (0 K5-fwd, 1 K5-bwd,
// 2 K6-fwd, 3 K6-bwd) needs: 0 where its buffers fit in shared memory.
int64_t dt_fa_scratch_floats(int kind, int64_t B, int F, int H, int dh) {
  if (!valid(B, F, H, dh) || kind < kFaFwd || kind > kAbBwd) return -1;
  return plan_for(kind, B, F, H * dh).scratch_floats;
}

// 1 where K6 stages w_aug in shared memory, 0 where it reads the float32
// copy w_f32 from device memory.
int dt_ab_w_in_smem(int H, int dh) { return w_in_smem(H * dh) ? 1 : 0; }

// K5 forward: q, k, v (B, F, H*dh) in the first type, out in the second.
int dt_fa_fwd_f32_f32(const void* q, const void* k, const void* v, void* out,
                      int64_t B, int F, int H, int dh, float scale,
                      void* scratch, void* stream) {
  return static_cast<int>(fa_fwd<float, float>(q, k, v, out, B, F, H, dh,
                                               scale, scratch, stream));
}
int dt_fa_fwd_bf16_bf16(const void* q, const void* k, const void* v,
                        void* out, int64_t B, int F, int H, int dh,
                        float scale, void* scratch, void* stream) {
  return static_cast<int>(fa_fwd<bf16, bf16>(q, k, v, out, B, F, H, dh, scale,
                                             scratch, stream));
}
int dt_fa_fwd_bf16_f32(const void* q, const void* k, const void* v, void* out,
                       int64_t B, int F, int H, int dh, float scale,
                       void* scratch, void* stream) {
  return static_cast<int>(fa_fwd<bf16, float>(q, k, v, out, B, F, H, dh, scale,
                                              scratch, stream));
}

// K5 backward: do in the output's type; dq, dk, dv in q's.
int dt_fa_bwd_f32_f32(const void* q, const void* k, const void* v,
                      const void* dout, void* dq, void* dk, void* dv,
                      int64_t B, int F, int H, int dh, float scale,
                      void* scratch, void* stream) {
  return static_cast<int>(fa_bwd<float, float>(q, k, v, dout, dq, dk, dv, B, F,
                                               H, dh, scale, scratch, stream));
}
int dt_fa_bwd_bf16_bf16(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv,
                        int64_t B, int F, int H, int dh, float scale,
                        void* scratch, void* stream) {
  return static_cast<int>(fa_bwd<bf16, bf16>(q, k, v, dout, dq, dk, dv, B, F,
                                             H, dh, scale, scratch, stream));
}
int dt_fa_bwd_bf16_f32(const void* q, const void* k, const void* v,
                       const void* dout, void* dq, void* dk, void* dv,
                       int64_t B, int F, int H, int dh, float scale,
                       void* scratch, void* stream) {
  return static_cast<int>(fa_bwd<bf16, float>(q, k, v, dout, dq, dk, dv, B, F,
                                              H, dh, scale, scratch, stream));
}

// K6 forward and backward: x, w_aug, out, do and dpre all in one type;
// w_f32 the float32 copy of w_aug where dt_ab_w_in_smem is 0.
int dt_ab_fwd_f32(const void* x, const void* w_aug, void* out, int64_t B,
                  int F, int H, int dh, float scale, void* scratch,
                  const void* w_f32, void* stream) {
  return static_cast<int>(ab_fwd<float>(x, w_aug, out, B, F, H, dh, scale,
                                        scratch, w_f32, stream));
}
int dt_ab_fwd_bf16(const void* x, const void* w_aug, void* out, int64_t B,
                   int F, int H, int dh, float scale, void* scratch,
                   const void* w_f32, void* stream) {
  return static_cast<int>(ab_fwd<bf16>(x, w_aug, out, B, F, H, dh, scale,
                                       scratch, w_f32, stream));
}
int dt_ab_bwd_f32(const void* x, const void* w_aug, const void* dout,
                  void* dpre, int64_t B, int F, int H, int dh, float scale,
                  void* scratch, const void* w_f32, void* stream) {
  return static_cast<int>(ab_bwd<float>(x, w_aug, dout, dpre, B, F, H, dh,
                                        scale, scratch, w_f32, stream));
}
int dt_ab_bwd_bf16(const void* x, const void* w_aug, const void* dout,
                   void* dpre, int64_t B, int F, int H, int dh, float scale,
                   void* scratch, const void* w_f32, void* stream) {
  return static_cast<int>(ab_bwd<bf16>(x, w_aug, dout, dpre, B, F, H, dh,
                                       scale, scratch, w_f32, stream));
}

const char* dt_fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
