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
// What bounds them. Per example and head the attention is an F x F product
// with a depth of dh (F = 22, dh = 8 on the AutoInt configuration): about
// 4*F*F*dh float operations for 2*F*U*itemsize bytes moved, ~11 operations
// a byte in bfloat16, under the card's ~20 (float32 CUDA cores) or ~295
// (tensor cores). The least time is the bytes: q, k, v read once and o
// written once (K5-fwd); q, k, v, do read and dq, dk, dv written (K5-bwd);
// x read and out written (K6-fwd); x, do read and dpre written (K6-bwd).
// What holds the kernels back is the work inside the SM, not the bytes: the
// first, one-warp design (below) took 141 us for K6-fwd and 61 us for
// K5-fwd at bf16 B=8192 on an H100, for 11.5 MB that the card moves in 3.4
// and 6.9 us: 10 of 32 lanes idle at F=22, scalar row copies with an
// integer division an element, and three passes through an F x F row
// buffer even in the forward.
//
// The tile design, K5's and K6's (the main path: tiles that fit in shared
// memory; ops/kernels/field_attention.py's fa_design and ab_design name it):
// - A persistent grid walks tiles of E examples (E*F*U contiguous elements
//   of each operand); thread r owns the (example, head, field) row r of the
//   tile, so E*H*F rows fill the block to within a warp. E is the most
//   that fill the block's threads and leave two blocks an SM (113 KB).
// - The next tile's inputs (K5: q, k, v and, backward, do; K6: x and, backward,
//   do) come into a second stage by 16-byte cp.async while the current one
//   is computed; outputs are staged and written with 16-byte stores (K5
//   stages them over the inputs its tile has read). A span is placed at its
//   address mod 16, so any tile offset and a partial last tile work: the
//   ragged ends are copied element by element.
// - K6 projects: w_aug staged once a block, the projection on mma.sync
//   (bfloat16 x and w_aug as m16n8k16 with float32 accumulators, exact
//   products and float32 sums as the TPU kernel's dot_general; float32 as
//   3xTF32 on m16n8k8, lo*hi + hi*lo + hi*hi, the float32 product to
//   ~2^-22, where plain TF32 would miss the 1e-5 tolerance; FMAs on the CUDA
//   cores were timed and lost), bias and relu(pre) in float32 into the
//   q/k/v/r tile. K5 widens its staged q, k and v into that tile, a thread
//   its own head rows.
// - The attention is one function body for both (attend_fwd,
//   attend_bwd_rows, attend_bwd_cols), K6's residual, relu and masks behind
//   a compile-time switch; float32 on the CUDA cores, as in the TPU kernel.
//   A thread keeps its q row and its context (or gradient) sums in
//   registers and reads k and v rows as float4 broadcasts (the lanes of one
//   (e, h) read the same row), two fields a step. The forward takes the
//   scores' max, then one pass of exp, sum and weighted sum, scaled by 1/z
//   (K5 keeps the scores in a row of an odd stride between the two passes;
//   K6 computes them twice and keeps no F x F buffer). The backward keeps w
//   and ds (rows of an odd stride) for its sums over the query field, which
//   a thread per key field takes in a fixed order: no atomics, the same bits
//   on every run; it takes sum_g w dw as dctx . ctx, so dw, ds and dq share
//   one pass over g.
// - A thread's head rows of the staged spans (K5's q, k, v; do; the
//   outputs) are read and written 16 bytes at a time where they are
//   aligned: the lanes of a warp work on rows U apart, and element accesses
//   at that stride meet the same banks (8 to 16 ways at U = 16).
// - What bounds it now (read from the times on an H100 in PERF.md and the
//   count of accesses; the card has no profiler of the SM's pipes): shared
//   memory's delivery to registers, 128 bytes a cycle an SM, against which
//   every float4 broadcast of a k or v row counts whole, and the latency of
//   the dependent chains of those loads and FMAs at 14-30 warps an SM (K6's
//   registers, ~120 a thread; the backward's shared memory, ~20 KB an
//   example: q/k/v, w and ds). Two rows a thread (half the loads) and a row
//   split over two threads were both slower for K6.
//
// Past the tile (the one-warp design, K5 and K6): one warp owns one example
// b; a block holds up to 8 warps. The warp copies the example's rows into
// shared memory as float32 (coalesced: the example's F*U values are
// contiguous), then works per head h with lane = query field f (looping for
// F > 32): its score row over g goes to a row of an F x F shared buffer, the
// max-subtracted softmax is taken in float32, and the context is summed in
// float32 registers (up to 64 values at a time). Outputs are staged back
// into shared memory and written coalesced, rounded once to the output
// type. The scores, the weights and (in K6) the four projections never
// reach device memory. Rows of the shared buffers are padded to an odd
// stride, so a warp reading a column (lane = row) hits 32 distinct banks.
//
// The one-warp backward sums over the query field f for dv and dk cross
// lanes. They are done without atomics, so results are deterministic: pass
// A (lane = f) writes the weights w and ds = w * (dw - sum_g w*dw) * scale
// to shared memory, pass B (lane = g) reads them by column and sums dv[g]
// and dk[g] over f, pass C (lane = f) sums dq[f] over g. Each output lands
// in shared memory where its input is no longer read (dv over v; dq over q
// after pass B), dk in a scratch buffer.
//
// K6's backward recomputes q, k, v and r (float32, not rounded, as in the
// TPU kernel), then masks exactly as the JAX VJP: dctx = dr = 1[ctx + r > 0]
// * do, dpre = 1[pre > 0] * [dq; dk; dv; dr] (strict: the derivative of
// relu at 0 is 0; pre > 0 exactly where post > 0). The two products of the
// K6 gradient (dW = [x;1] dpre^T, dx = w_aug dpre) run outside the kernel,
// as they ran in XLA outside the TPU kernel.
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
//   right.
// Every one-warp kernel walks its examples in a grid-stride loop (one pass
// where the buffers are in shared memory, whose grid covers B).
//
// Plain C interface for ctypes: each entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (or the error of the
// shared-memory attribute call, made once per kernel).

#include <cstdint>
#include <type_traits>

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

// ------------------------------------------------------ K6, the tile design
//
// A block walks tiles of E examples (a persistent grid); a tile is one
// contiguous span of E*F*U elements of x (and of do), E*F*U of out or
// E*F*4U of dpre. Shared memory, from the dynamic base:
//   w     w_aug as the projection reads it, and where each of the 4U
//         projection columns goes in post; staged once a block
//   in    two stages of the input span(s), filled by cp.async (16 bytes)
//         while the other stage is worked on
//   post  q, k, v, r in float32, [4][H][E*F][DHP] (a head's row padded
//         with zeros to DHP floats, so rows are read as float4)
//   wgt   (backward) the weights w[e][h][f][g], then ds, rows of odd(F)
//   out   the output span, staged for 16-byte stores
// A span is placed at its global address mod 16, so its 16-byte chunks land
// on 16-byte chunks of shared memory whatever the offset of the tile: the
// ragged head and tail of a span are copied element by element.
//
// Thread r of the block owns row (e, h, f) = (r / HF, r / F mod H, r mod F)
// of the attention: lanes of one (e, h) read the same k and v rows
// (broadcasts), and E*H*F rows fill the block to within a warp. Its loops
// over the other field take tile_chunk fields a step, their rows loaded
// together ahead of the arithmetic.

// The projection: bfloat16 on mma.sync m16n8k16, float32 as 3xTF32 on
// m16n8k8.
template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

__host__ __device__ constexpr int tile_dhp(int dh) {
  return dh <= 8 ? 8 : dh <= 16 ? 16 : dh <= 32 ? 32 : 64;
}
__host__ __device__ constexpr int tile_max_threads(int dhp) {
  return dhp <= 16 ? 512 : 256;
}
// fields a step of the loops over the other field, their rows loaded
// together ahead of the arithmetic
__host__ __device__ constexpr int tile_chunk(int dhp) {
  return dhp <= 8 ? 2 : 1;
}
__host__ __device__ __forceinline__ int64_t round_up(int64_t a, int64_t b) {
  return (a + b - 1) / b * b;
}

// Byte sizes and offsets of a tile launch. ops/kernels/field_attention.py
// (ab_tile_smem, fa_tile_smem) computes the same total.
struct Tile {
  int RT, FP, NP, KS;
  int64_t span_in, cols_off, in_off, post_off, wgt_off, wgt, out_off, total;
  int64_t stage = 0;  // K5: one stage of the input spans (q, k, v, do)
};

__host__ __device__ __forceinline__ Tile tile_of(bool bwd, int itemsize,
                                                 int E, int F, int H,
                                                 int dh) {
  Tile t;
  const int U = H * dh;
  t.RT = E * F;
  t.FP = odd(F);
  t.NP = static_cast<int>(round_up(4 * U, 8));
  const int k = itemsize == 2 ? 16 : 8;  // an mma's depth
  t.KS = (U + k - 1) / k;
  const int64_t w = int64_t(t.KS) * t.NP * 32 + int64_t(t.NP) * 4;
  const int ins = bwd ? 2 : 1;  // x, and do
  t.span_in = round_up(int64_t(t.RT) * U * itemsize + 16, 16);
  t.cols_off = w;
  t.in_off = round_up(w + int64_t(t.NP) * 4, 16);
  t.post_off = t.in_off + 2 * ins * t.span_in;
  t.wgt = bwd ? int64_t(H) * t.RT * t.FP * 4 : 0;
  t.wgt_off = t.post_off + int64_t(4) * H * t.RT * tile_dhp(dh) * 4;
  t.out_off = round_up(t.wgt_off + 2 * t.wgt, 16);
  t.total = t.out_off +
            round_up(int64_t(t.RT) * (bwd ? 4 : 1) * U * itemsize + 16, 16);
  return t;
}

// K5's tile: no w_aug; a stage holds the q, k and v spans (itemsize) and,
// backward, do's (out_itemsize); post holds q, k, v and, backward, dctx.
// The outputs are staged in the stage their tile's inputs came from, which
// the attention no longer reads: o over q, k and v; dq, dk, dv over q, k, v.
__host__ __device__ __forceinline__ Tile fa_tile_of(bool bwd, int itemsize,
                                                    int out_itemsize, int E,
                                                    int F, int H, int dh) {
  Tile t;
  const int U = H * dh;
  t.RT = E * F;
  t.FP = odd(F);
  t.NP = t.KS = 0;
  t.span_in = round_up(int64_t(t.RT) * U * itemsize + 16, 16);
  t.stage = 3 * t.span_in +
            (bwd ? round_up(int64_t(t.RT) * U * out_itemsize + 16, 16) : 0);
  t.cols_off = t.in_off = 0;
  t.post_off = 2 * t.stage;
  t.wgt = int64_t(H) * t.RT * t.FP * 4;
  t.wgt_off =
      t.post_off + int64_t(bwd ? 4 : 3) * H * t.RT * tile_dhp(dh) * 4;
  t.out_off = t.total = t.wgt_off + (bwd ? 2 : 1) * t.wgt;
  return t;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Where a span of global memory starting at g is placed after base.
template <typename T>
__device__ __forceinline__ T* placed(char* base, const T* g) {
  return reinterpret_cast<T*>(base + (reinterpret_cast<uintptr_t>(g) & 15));
}

// Number of leading elements of a span before its first 16-byte boundary.
template <typename T>
__device__ __forceinline__ int span_head(const T* g, int n) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  const int head = ((16 - mis) & 15) / static_cast<int>(sizeof(T));
  return head < n ? head : n;
}

// The block starts copying n elements of src into shared memory at base
// (placed): 16-byte chunks by cp.async, the ragged ends directly.
template <typename T>
__device__ __forceinline__ void load_span(char* base, const T* src, int n) {
  T* dst = placed(base, src);
  const int head = span_head(src, n);
  const int chunks = (n - head) * static_cast<int>(sizeof(T)) / 16;
  const int tail = head + chunks * (16 / static_cast<int>(sizeof(T)));
  const char* s = reinterpret_cast<const char*>(src + head);
  char* d = reinterpret_cast<char*>(dst + head);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async16(d + 16 * i, s + 16 * i);
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int i = tail + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// The block writes n staged elements (placed for dst) to dst: 16-byte
// stores, the ragged ends element by element.
template <typename T>
__device__ __forceinline__ void store_span(T* dst, const T* src, int n) {
  const int head = span_head(dst, n);
  const int chunks = (n - head) * static_cast<int>(sizeof(T)) / 16;
  const int tail = head + chunks * (16 / static_cast<int>(sizeof(T)));
  const int4* s = reinterpret_cast<const int4*>(src + head);
  int4* d = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) d[i] = s[i];
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int i = tail + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// w_aug staged for the projection: B fragments in lane order, one 8-byte
// pair a lane for each (k-step, 8-column tile), zeros past U and 4U, then
// the bias row in float32 (NP floats). Then, for each of the NP columns n,
// its offset in post: column n is q, k, v or r (n / U) of head
// (n mod U) / dh, at d = n mod dh.
template <typename T>
__device__ __forceinline__ void stage_w_tile(char* wsm, const T* w_aug,
                                             int U, int H, int dh,
                                             const Tile& t) {
  const int U4 = 4 * U, NT8 = t.NP / 8, frags = t.KS * NT8 * 32;
  for (int i = threadIdx.x; i < frags; i += blockDim.x) {
    const int lane = i & 31, nt = (i >> 5) % NT8, ks = (i >> 5) / NT8;
    const int n = nt * 8 + lane / 4;
    if constexpr (kBf16<T>) {
      const int k0 = ks * 16 + 2 * (lane & 3);
      auto b = [&](int k) -> uint32_t {
        return k < U && n < U4 ? bf16_bits(w_aug[k * U4 + n]) : 0u;
      };
      reinterpret_cast<uint2*>(wsm)[i] =
          make_uint2(b(k0) | b(k0 + 1) << 16, b(k0 + 8) | b(k0 + 9) << 16);
    } else {
      const int k0 = ks * 8 + (lane & 3);
      auto b = [&](int k) -> float {
        return k < U && n < U4 ? w_aug[k * U4 + n] : 0.f;
      };
      reinterpret_cast<float2*>(wsm)[i] = make_float2(b(k0), b(k0 + 4));
    }
  }
  float* bias = reinterpret_cast<float*>(wsm + int64_t(frags) * 8);
  for (int n = threadIdx.x; n < t.NP; n += blockDim.x)
    bias[n] = n < U4 ? to_f32(w_aug[U * U4 + n]) : 0.f;
  int* cols = reinterpret_cast<int*>(wsm + t.cols_off);
  for (int n = threadIdx.x; n < t.NP; n += blockDim.x) {
    const int which = n / U, c = n - which * U, h = c / dh;
    cols[n] = (which * H + h) * t.RT * tile_dhp(dh) + c - h * dh;
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + lo, both TF32 (hi rounded to nearest, ties away, as the card's
// cvt.rna does); hi*hi + hi*lo + lo*hi is x*y to ~2^-22.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The projection on mma.sync: warp w takes 16-row tiles w, w + warps, ...
// of the (rows, K) x tile (zeros past rows and U) against every 8-column
// tile of w_aug, float32 accumulators, bias and relu in the epilogue.
template <typename T, int DHP>
__device__ __forceinline__ void project_tile(float* post, const T* xs,
                                             const char* wsm, int rows,
                                             int U, const Tile& t) {
  constexpr int KSM = kBf16<T> ? 4 : 8;  // k-steps of U <= 64
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3, U4 = 4 * U, NT8 = t.NP / 8;
  const float* bias =
      reinterpret_cast<const float*>(wsm + int64_t(t.KS) * NT8 * 32 * 8);
  const int* cols = reinterpret_cast<const int*>(wsm + t.cols_off);
  for (int mt = warp; mt * 16 < rows; mt += blockDim.x >> 5) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    uint32_t a[KSM][4];  // bfloat16 pairs, or float32 bits
#pragma unroll
    for (int ks = 0; ks < KSM; ++ks) {
      if (ks >= t.KS) break;
      if constexpr (kBf16<T>) {
        auto x = [&](int r, int k) -> uint32_t {
          return r < rows && k < U ? bf16_bits(xs[r * U + k]) : 0u;
        };
        const int k = ks * 16 + 2 * q4;
        a[ks][0] = x(r0, k) | x(r0, k + 1) << 16;
        a[ks][1] = x(r1, k) | x(r1, k + 1) << 16;
        a[ks][2] = x(r0, k + 8) | x(r0, k + 9) << 16;
        a[ks][3] = x(r1, k + 8) | x(r1, k + 9) << 16;
      } else {
        auto x = [&](int r, int k) -> float {
          return r < rows && k < U ? xs[r * U + k] : 0.f;
        };
        const int k = ks * 8 + q4;
        a[ks][0] = __float_as_uint(x(r0, k));
        a[ks][1] = __float_as_uint(x(r1, k));
        a[ks][2] = __float_as_uint(x(r0, k + 4));
        a[ks][3] = __float_as_uint(x(r1, k + 4));
      }
    }
    for (int nt = 0; nt < NT8; ++nt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KSM; ++ks) {
        if (ks >= t.KS) break;
        const int i = (ks * NT8 + nt) * 32 + lane;
        if constexpr (kBf16<T>) {
          mma_bf16(c, a[ks], reinterpret_cast<const uint2*>(wsm)[i]);
        } else {
          const float2 b = reinterpret_cast<const float2*>(wsm)[i];
          uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_tf32(__uint_as_float(a[ks][j]), ah[j], al[j]);
          split_tf32(b.x, bh0, bl0);
          split_tf32(b.y, bh1, bl1);
          mma_tf32(c, al, bh0, bh1);  // the small terms first
          mma_tf32(c, ah, bl0, bl1);
          mma_tf32(c, ah, bh0, bh1);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = nt * 8 + 2 * q4 + j;
        if (n >= U4) continue;
        float* col = post + cols[n];
        if (r0 < rows) col[r0 * DHP] = fmaxf(c[j] + bias[n], 0.f);
        if (r1 < rows) col[r1 * DHP] = fmaxf(c[2 + j] + bias[n], 0.f);
      }
    }
  }
}

template <int DHP>
__device__ __forceinline__ void load_vec(float (&r)[DHP], const float* p) {
#pragma unroll
  for (int d = 0; d < DHP; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + d);
    r[d] = v.x;
    r[d + 1] = v.y;
    r[d + 2] = v.z;
    r[d + 3] = v.w;
  }
}

// q . k, summed in the order of d
template <int DHP>
__device__ __forceinline__ float dot_regs(const float (&q)[DHP],
                                          const float (&k)[DHP]) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DHP; ++d) s = fmaf(q[d], k[d], s);
  return s;
}

// acc += a * v
template <int DHP>
__device__ __forceinline__ void axpy_regs(float (&acc)[DHP], float a,
                                          const float (&v)[DHP]) {
#pragma unroll
  for (int d = 0; d < DHP; ++d) acc[d] = fmaf(a, v[d], acc[d]);
}

// A head row of a staged span: dh values of T at p, read as float32 (zeros
// past dh) or written from float32 (rounded once). 16-byte accesses where
// the row starts on a 16-byte boundary and dh fills whole 16-byte chunks,
// else one element at a time: the lanes of a warp work on rows U apart,
// and element accesses at that stride meet the same banks.
__device__ __forceinline__ void unpack16(float* r, int4 x, float) {
  r[0] = __int_as_float(x.x);
  r[1] = __int_as_float(x.y);
  r[2] = __int_as_float(x.z);
  r[3] = __int_as_float(x.w);
}
__device__ __forceinline__ void unpack16(float* r, int4 x, __nv_bfloat16) {
  const uint32_t w[4] = {static_cast<uint32_t>(x.x), static_cast<uint32_t>(x.y),
                         static_cast<uint32_t>(x.z), static_cast<uint32_t>(x.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bfloat16 is a float32's top half
    r[2 * i] = __uint_as_float(w[i] << 16);
    r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ int4 pack16(const float* r, float) {
  return make_int4(__float_as_int(r[0]), __float_as_int(r[1]),
                   __float_as_int(r[2]), __float_as_int(r[3]));
}
__device__ __forceinline__ int4 pack16(const float* r, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = bf16_bits(__float2bfloat16_rn(r[2 * i])) |
           bf16_bits(__float2bfloat16_rn(r[2 * i + 1])) << 16;
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                   static_cast<int>(w[2]), static_cast<int>(w[3]));
}
template <typename T>
__device__ __forceinline__ bool chunked(const T* p, int dh) {
  return dh % (16 / static_cast<int>(sizeof(T))) == 0 &&
         (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int DHP, typename T>
__device__ __forceinline__ void load_row(float (&r)[DHP], const T* p,
                                         int dh) {
  constexpr int V = 16 / sizeof(T);
  if (chunked(p, dh)) {
#pragma unroll
    for (int c = 0; c < DHP; c += V) {
      if (c < dh) {
        unpack16(r + c, *reinterpret_cast<const int4*>(p + c), T());
      } else {
#pragma unroll
        for (int d = c; d < c + V; ++d) r[d] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < DHP; ++d) r[d] = d < dh ? to_f32(p[d]) : 0.f;
  }
}

template <int DHP, typename T>
__device__ __forceinline__ void store_row(T* p, const float (&r)[DHP],
                                          int dh) {
  constexpr int V = 16 / sizeof(T);
  if (chunked(p, dh)) {
#pragma unroll
    for (int c = 0; c < DHP; c += V)
      if (c < dh) *reinterpret_cast<int4*>(p + c) = pack16(r + c, T());
  } else {
#pragma unroll
    for (int d = 0; d < DHP; ++d)
      if (d < dh) store(p + d, r[d]);
  }
}

// The thread's row of the tile: example e, head h, field f.
struct Row {
  int e, h, f, row;  // row = e*F + f, the (example, field) row of the tile
};
__device__ __forceinline__ Row row_of(int F, int H) {
  Row w;
  const int r = threadIdx.x, HF = H * F;
  w.e = r / HF;
  const int hf = r - w.e * HF;
  w.h = hf / F;
  w.f = hf - w.h * F;
  w.row = w.e * F + w.f;
  return w;
}

// post's row (which, h, row)
template <int DHP>
__device__ __forceinline__ float* post_row(float* post, int which, int h,
                                           int row, int H, const Tile& t) {
  return post + (int64_t(which * H + h) * t.RT + row) * DHP;
}

// The attention of both tile designs. BLOCK is K6's switch: the residual r,
// the relu on the output, the 1[ctx + r > 0] mask on dctx (K5: dctx = do)
// and the q, k, v > 0 masks on the gradients belong to the block only.
//
// Forward, thread (e, h, f): two passes over g: the scores' max, then
// e_g = exp(s_g - m), z = sum e_g and sum e_g v_g, which 1/z turns into the
// context; out = relu(ctx + r) (K5: ctx) in the output's type T. K6 keeps
// no F x F buffer and computes each score twice; K5 keeps the scores in
// its row of wgt (odd stride) between the passes, so the second reads v
// alone (the same bits: the same score). A step past F repeats field F - 1
// and counts for nothing.
template <typename T, int DHP, bool BLOCK>
__device__ __forceinline__ void attend_fwd(float* post, float* wgt, T* os,
                                           int ex, int F, int H, int dh,
                                           int U, float scale,
                                           const Tile& t) {
  constexpr int G = tile_chunk(DHP);
  if (static_cast<int>(threadIdx.x) >= ex * H * F) return;
  const Row w = row_of(F, H);
  const float* kb = post_row<DHP>(post, 1, w.h, w.e * F, H, t);
  const float* vb = post_row<DHP>(post, 2, w.h, w.e * F, H, t);
  float* srow = wgt + (int64_t(w.e * H + w.h) * F + w.f) * t.FP;
  float q[DHP];
  load_vec(q, post_row<DHP>(post, 0, w.h, w.row, H, t));
  float m = neg_inf();
  for (int g0 = 0; g0 < F; g0 += G) {
    float k[G][DHP], s[G];
#pragma unroll
    for (int u = 0; u < G; ++u)
      load_vec(k[u], kb + min(g0 + u, F - 1) * DHP);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      s[u] = dot_regs(q, k[u]) * scale;
      m = fmaxf(m, s[u]);
    }
    if constexpr (!BLOCK) {
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (g0 + u < F) srow[g0 + u] = s[u];
    }
  }
  float z = 0.f, acc[DHP] = {};
  for (int g0 = 0; g0 < F; g0 += G) {
    float v[G][DHP], p[G];
    if constexpr (BLOCK) {
      float k[G][DHP];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        load_vec(k[u], kb + min(g0 + u, F - 1) * DHP);
        load_vec(v[u], vb + min(g0 + u, F - 1) * DHP);
      }
#pragma unroll
      for (int u = 0; u < G; ++u)
        p[u] = g0 + u < F ? expf(dot_regs(q, k[u]) * scale - m) : 0.f;
    } else {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        load_vec(v[u], vb + min(g0 + u, F - 1) * DHP);
        p[u] = g0 + u < F ? expf(srow[g0 + u] - m) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      z += p[u];
      axpy_regs(acc, p[u], v[u]);
    }
  }
  const float rz = 1.f / z;
  const float* rr = post_row<DHP>(post, 3, w.h, w.row, H, t);
#pragma unroll
  for (int d = 0; d < DHP; ++d)
    acc[d] = BLOCK ? fmaxf(acc[d] * rz + rr[d], 0.f) : acc[d] * rz;
  store_row(os + w.row * U + w.h * dh, acc, dh);
}

// The backward's staged gradients: row (e, f) of dq at os + row * ld, its
// dk and dv dk_off and dv_off further on (K6: the 4U-wide dpre rows, dr at
// 3U; K5: three spans).
//
// Backward pass A, thread (e, h, f): the weights w (kept for pass B), the
// context as in the forward, dctx = dr = 1[ctx + r > 0] do (K5: dctx = do;
// dctx replaces r in post), ds = w (dw - t) scale with dw = dctx . v_g and
// t = sum_g w dw = dctx . ctx (ds kept for pass B), dq = sum_g ds k_g; dr
// and dq masked by r > 0 and q > 0 into the staged dpre (K5: dq unmasked).
// do is in TD, the gradients in T. Each step computes G fields, then
// stores them.
template <typename TD, typename T, int DHP, bool BLOCK>
__device__ __forceinline__ void attend_bwd_rows(float* post, float* wgt,
                                                float* dsb, const TD* dos,
                                                T* os, int ld, int ex, int F,
                                                int H, int dh, int U,
                                                float scale, const Tile& t) {
  constexpr int G = tile_chunk(DHP);
  if (static_cast<int>(threadIdx.x) >= ex * H * F) return;
  const Row w = row_of(F, H);
  const float* kb = post_row<DHP>(post, 1, w.h, w.e * F, H, t);
  const float* vb = post_row<DHP>(post, 2, w.h, w.e * F, H, t);
  const int64_t wr = (int64_t(w.e * H + w.h) * F + w.f) * t.FP;
  float* wrow = wgt + wr;
  float* dsrow = dsb + wr;
  float m = neg_inf();
  {  // the scores, in w's row for now
    float q[DHP];
    load_vec(q, post_row<DHP>(post, 0, w.h, w.row, H, t));
    for (int g0 = 0; g0 < F; g0 += G) {
      float k[G][DHP], s[G];
#pragma unroll
      for (int u = 0; u < G; ++u)
        load_vec(k[u], kb + min(g0 + u, F - 1) * DHP);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        s[u] = dot_regs(q, k[u]) * scale;
        m = fmaxf(m, s[u]);
      }
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (g0 + u < F) wrow[g0 + u] = s[u];
    }
  }
  // e_g = exp(s_g - m) in w's row, z, and the context sum e_g v_g
  float z = 0.f, dc[DHP] = {};
  for (int g0 = 0; g0 < F; g0 += G) {
    float v[G][DHP], p[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      load_vec(v[u], vb + min(g0 + u, F - 1) * DHP);
      p[u] = g0 + u < F ? expf(wrow[g0 + u] - m) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      z += p[u];
      axpy_regs(dc, p[u], v[u]);
      if (g0 + u < F) wrow[g0 + u] = p[u];
    }
  }
  const float rz = 1.f / z;
  float* rr = post_row<DHP>(post, 3, w.h, w.row, H, t);
  T* o = os + int64_t(w.row) * ld + w.h * dh;
  float dov[DHP];  // do, then (K6) dr
  load_row(dov, dos + w.row * U + w.h * dh, dh);
  // t = sum_g w_g dw_g = dctx . ctx: one dot product, not a pass over g
  float tsum = 0.f;
#pragma unroll
  for (int d = 0; d < DHP; ++d) {
    const float ctx = dc[d] * rz;
    if constexpr (BLOCK) {
      const float r = rr[d];
      dc[d] = ctx + r > 0.f ? dov[d] : 0.f;
      dov[d] = r > 0.f ? dc[d] : 0.f;
    } else {
      dc[d] = dov[d];
    }
    tsum = fmaf(dc[d], ctx, tsum);
  }
  if constexpr (BLOCK) store_row(o + 3 * U, dov, dh);
#pragma unroll
  for (int d = 0; d < DHP; d += 4)
    *reinterpret_cast<float4*>(rr + d) =
        make_float4(dc[d], dc[d + 1], dc[d + 2], dc[d + 3]);
  // w_g = e_g * (1/z) in w's row, dw_g = dctx . v_g,
  // ds_g = w_g (dw_g - t) scale in ds's row, dq = sum_g ds_g k_g
  float dq[DHP] = {};
  for (int g0 = 0; g0 < F; g0 += G) {
    float k[G][DHP], v[G][DHP], p[G], ds[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int g = min(g0 + u, F - 1);
      load_vec(v[u], vb + g * DHP);
      load_vec(k[u], kb + g * DHP);
      p[u] = g0 + u < F ? wrow[g0 + u] * rz : 0.f;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      ds[u] = p[u] * (dot_regs(dc, v[u]) - tsum) * scale;
      axpy_regs(dq, ds[u], k[u]);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (g0 + u < F) {
        wrow[g0 + u] = p[u];
        dsrow[g0 + u] = ds[u];
      }
    }
  }
  const float* qr = post_row<DHP>(post, 0, w.h, w.row, H, t);
#pragma unroll
  for (int d = 0; d < DHP; ++d)
    if (BLOCK && !(qr[d] > 0.f)) dq[d] = 0.f;
  store_row(o, dq, dh);
}

// Backward pass B, thread (e, h, g): dv = sum_f w[f, g] dctx_f and
// dk = sum_f ds[f, g] q_f in the order of f, masked by v > 0 and k > 0
// (K5: unmasked) into the staged gradients. The sums over f read columns of
// w and ds: no atomics, and the same order on every run.
template <typename T, int DHP, bool BLOCK>
__device__ __forceinline__ void attend_bwd_cols(
    float* post, const float* wgt, const float* dsb, T* os, int ld,
    int dk_off, int dv_off, int ex, int F, int H, int dh, const Tile& t) {
  constexpr int G = tile_chunk(DHP);
  if (static_cast<int>(threadIdx.x) >= ex * H * F) return;
  const Row w = row_of(F, H);  // w.f is g here
  const float* wcol = wgt + int64_t(w.e * H + w.h) * F * t.FP + w.f;
  const float* dscol = dsb + (wcol - wgt);
  const float* qb = post_row<DHP>(post, 0, w.h, w.e * F, H, t);
  const float* cb = post_row<DHP>(post, 3, w.h, w.e * F, H, t);  // dctx
  float dv[DHP] = {}, dk[DHP] = {};
  for (int f0 = 0; f0 < F; f0 += G) {
    float c[G][DHP], q[G][DHP], a[G], b[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int f = min(f0 + u, F - 1);
      load_vec(c[u], cb + f * DHP);
      load_vec(q[u], qb + f * DHP);
      a[u] = f0 + u < F ? wcol[f * t.FP] : 0.f;
      b[u] = f0 + u < F ? dscol[f * t.FP] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      axpy_regs(dv, a[u], c[u]);
      axpy_regs(dk, b[u], q[u]);
    }
  }
  const float* kr = post_row<DHP>(post, 1, w.h, w.row, H, t);
  const float* vr = post_row<DHP>(post, 2, w.h, w.row, H, t);
  T* o = os + int64_t(w.row) * ld + w.h * dh;
#pragma unroll
  for (int d = 0; d < DHP; ++d) {
    if (BLOCK && !(kr[d] > 0.f)) dk[d] = 0.f;
    if (BLOCK && !(vr[d] > 0.f)) dv[d] = 0.f;
  }
  store_row(o + dk_off, dk, dh);
  store_row(o + dv_off, dv, dh);
}

// Stages w_aug and zeroes post (its head padding is read as zeros).
template <typename T>
__device__ __forceinline__ void tile_prologue(char* smem, const T* w_aug,
                                              int U, int H, int dh,
                                              const Tile& t) {
  stage_w_tile<T>(smem, w_aug, U, H, dh, t);
  float4* post = reinterpret_cast<float4*>(smem + t.post_off);
  const int64_t n = (t.wgt_off - t.post_off) / 16;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x)
    post[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename T, int DHP>
__global__ void __launch_bounds__(tile_max_threads(DHP))
    ab_fwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ w_aug,
                       const T* __restrict__ /*dout*/, T* __restrict__ out,
                       int64_t B, int F, int H, int dh, float scale, int E) {
  extern __shared__ __align__(16) char tile_smem[];
  char* smem = tile_smem;
  const int U = H * dh;
  const Tile t = tile_of(false, sizeof(T), E, F, H, dh);
  float* post = reinterpret_cast<float*>(smem + t.post_off);
  tile_prologue<T>(smem, w_aug, U, H, dh, t);
  const int64_t tiles = (B + E - 1) / E, span = int64_t(E) * F * U;
  auto examples = [&](int64_t tile) {
    return static_cast<int>(B - tile * E < E ? B - tile * E : E);
  };
  int64_t tile = blockIdx.x;
  if (tile < tiles)
    load_span(smem + t.in_off, x + tile * span, examples(tile) * F * U);
  cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    if (next < tiles)
      load_span(smem + t.in_off + ((it + 1) & 1) * t.span_in,
                x + next * span, examples(next) * F * U);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int ex = examples(tile);
    const T* xs =
        placed(smem + t.in_off + (it & 1) * t.span_in, x + tile * span);
    project_tile<T, DHP>(post, xs, smem, ex * F, U, t);
    __syncthreads();
    T* os = placed(smem + t.out_off, out + tile * span);
    attend_fwd<T, DHP, true>(post, nullptr, os, ex, F, H, dh, U, scale, t);
    __syncthreads();
    store_span(out + tile * span, os, ex * F * U);
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(tile_max_threads(DHP))
    ab_bwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ w_aug,
                       const T* __restrict__ dout, T* __restrict__ dpre,
                       int64_t B, int F, int H, int dh, float scale, int E) {
  extern __shared__ __align__(16) char tile_smem[];
  char* smem = tile_smem;
  const int U = H * dh;
  const Tile t = tile_of(true, sizeof(T), E, F, H, dh);
  float* post = reinterpret_cast<float*>(smem + t.post_off);
  float* wgt = reinterpret_cast<float*>(smem + t.wgt_off);
  float* dsb = reinterpret_cast<float*>(smem + t.wgt_off + t.wgt);
  tile_prologue<T>(smem, w_aug, U, H, dh, t);
  const int64_t tiles = (B + E - 1) / E, span = int64_t(E) * F * U;
  auto examples = [&](int64_t tile) {
    return static_cast<int>(B - tile * E < E ? B - tile * E : E);
  };
  auto stage = [&](int s) { return smem + t.in_off + s * 2 * t.span_in; };
  auto load = [&](int s, int64_t tile) {
    const int n = examples(tile) * F * U;
    load_span(stage(s), x + tile * span, n);
    load_span(stage(s) + t.span_in, dout + tile * span, n);
  };
  int64_t tile = blockIdx.x;
  if (tile < tiles) load(0, tile);
  cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    if (next < tiles) load((it + 1) & 1, next);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int ex = examples(tile);
    const T* xs = placed(stage(it & 1), x + tile * span);
    const T* dos = placed(stage(it & 1) + t.span_in, dout + tile * span);
    project_tile<T, DHP>(post, xs, smem, ex * F, U, t);
    __syncthreads();
    T* os = placed(smem + t.out_off, dpre + 4 * tile * span);
    attend_bwd_rows<T, T, DHP, true>(post, wgt, dsb, dos, os, 4 * U, ex, F,
                                     H, dh, U, scale, t);
    __syncthreads();
    attend_bwd_cols<T, DHP, true>(post, wgt, dsb, os, 4 * U, U, 2 * U, ex, F,
                                  H, dh, t);
    __syncthreads();
    store_span(dpre + 4 * tile * span, os, 4 * ex * F * U);
  }
}

// ------------------------------------------------------ K5, the tile design
//
// K6's tile kernels without the projection: the staged q, k and v spans
// are widened by thread (e, h, f) into its float32 rows of post (padded
// with zeros to DHP), and the attention is K6's with BLOCK off. Shared
// memory (fa_tile_of): two stages of the input spans, then post (q, k, v
// and, backward, dctx), then the backward's w and ds.

// Thread (e, h, f) copies its head rows of the staged q, k and v into post.
template <typename T, int DHP>
__device__ __forceinline__ void fill_tile(float* post, const T* qs,
                                          const T* ks, const T* vs, int ex,
                                          int F, int H, int dh, int U,
                                          const Tile& t) {
  if (static_cast<int>(threadIdx.x) >= ex * H * F) return;
  const Row w = row_of(F, H);
  const int64_t off = int64_t(w.row) * U + w.h * dh;
  const T* src[3] = {qs + off, ks + off, vs + off};
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    float r[DHP];
    load_row(r, src[which], dh);
    float* p = post_row<DHP>(post, which, w.h, w.row, H, t);
#pragma unroll
    for (int d = 0; d < DHP; d += 4)
      *reinterpret_cast<float4*>(p + d) =
          make_float4(r[d], r[d + 1], r[d + 2], r[d + 3]);
  }
}

template <typename T, typename TO, int DHP>
__global__ void __launch_bounds__(tile_max_threads(DHP))
    fa_fwd_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, TO* __restrict__ out,
                       int64_t B, int F, int H, int dh, float scale, int E) {
  extern __shared__ __align__(16) char tile_smem[];
  char* smem = tile_smem;
  const int U = H * dh;
  const Tile t = fa_tile_of(false, sizeof(T), sizeof(TO), E, F, H, dh);
  float* post = reinterpret_cast<float*>(smem + t.post_off);
  float* wgt = reinterpret_cast<float*>(smem + t.wgt_off);
  const int64_t tiles = (B + E - 1) / E, span = int64_t(E) * F * U;
  auto examples = [&](int64_t tile) {
    return static_cast<int>(B - tile * E < E ? B - tile * E : E);
  };
  auto stage = [&](int s) { return smem + s * t.stage; };
  auto load = [&](int s, int64_t tile) {
    const int n = examples(tile) * F * U;
    load_span(stage(s), q + tile * span, n);
    load_span(stage(s) + t.span_in, k + tile * span, n);
    load_span(stage(s) + 2 * t.span_in, v + tile * span, n);
  };
  int64_t tile = blockIdx.x;
  if (tile < tiles) load(0, tile);
  cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    if (next < tiles) load((it + 1) & 1, next);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int ex = examples(tile);
    char* s = stage(it & 1);
    fill_tile<T, DHP>(post, placed(s, q + tile * span),
                      placed(s + t.span_in, k + tile * span),
                      placed(s + 2 * t.span_in, v + tile * span), ex, F, H,
                      dh, U, t);
    __syncthreads();
    TO* os = placed(s, out + tile * span);  // over q, k and v
    attend_fwd<TO, DHP, false>(post, wgt, os, ex, F, H, dh, U, scale, t);
    __syncthreads();
    store_span(out + tile * span, os, ex * F * U);
    __syncthreads();  // the next iteration loads this stage again
  }
}

template <typename T, typename TO, int DHP>
__global__ void __launch_bounds__(tile_max_threads(DHP))
    fa_bwd_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const TO* __restrict__ dout,
                       T* __restrict__ dq, T* __restrict__ dk,
                       T* __restrict__ dv, int64_t B, int F, int H, int dh,
                       float scale, int E) {
  extern __shared__ __align__(16) char tile_smem[];
  char* smem = tile_smem;
  const int U = H * dh;
  const Tile t = fa_tile_of(true, sizeof(T), sizeof(TO), E, F, H, dh);
  float* post = reinterpret_cast<float*>(smem + t.post_off);
  float* wgt = reinterpret_cast<float*>(smem + t.wgt_off);
  float* dsb = reinterpret_cast<float*>(smem + t.wgt_off + t.wgt);
  const int64_t tiles = (B + E - 1) / E, span = int64_t(E) * F * U;
  auto examples = [&](int64_t tile) {
    return static_cast<int>(B - tile * E < E ? B - tile * E : E);
  };
  auto stage = [&](int s) { return smem + s * t.stage; };
  auto load = [&](int s, int64_t tile) {
    const int n = examples(tile) * F * U;
    load_span(stage(s), q + tile * span, n);
    load_span(stage(s) + t.span_in, k + tile * span, n);
    load_span(stage(s) + 2 * t.span_in, v + tile * span, n);
    load_span(stage(s) + 3 * t.span_in, dout + tile * span, n);
  };
  int64_t tile = blockIdx.x;
  if (tile < tiles) load(0, tile);
  cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    if (next < tiles) load((it + 1) & 1, next);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int ex = examples(tile), n = ex * F * U;
    char* s = stage(it & 1);
    fill_tile<T, DHP>(post, placed(s, q + tile * span),
                      placed(s + t.span_in, k + tile * span),
                      placed(s + 2 * t.span_in, v + tile * span), ex, F, H,
                      dh, U, t);
    __syncthreads();
    const TO* dos = placed(s + 3 * t.span_in, dout + tile * span);
    // dq, dk and dv over q, k and v
    T* dqs = placed(s, dq + tile * span);
    T* dks = placed(s + t.span_in, dk + tile * span);
    T* dvs = placed(s + 2 * t.span_in, dv + tile * span);
    attend_bwd_rows<TO, T, DHP, false>(post, wgt, dsb, dos, dqs, U, ex, F, H,
                                       dh, U, scale, t);
    __syncthreads();
    attend_bwd_cols<T, DHP, false>(post, wgt, dsb, dqs, U,
                                   static_cast<int>(dks - dqs),
                                   static_cast<int>(dvs - dqs), ex, F, H, dh,
                                   t);
    __syncthreads();
    store_span(dq + tile * span, dqs, n);
    store_span(dk + tile * span, dks, n);
    store_span(dv + tile * span, dvs, n);
    __syncthreads();  // the next iteration loads this stage again
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

// A tile launch of E examples a tile (the wrapper's choice, from the
// shape) and E*H*F threads: checked against the block's limits, and a
// persistent grid of as many blocks as fit on the card's SMs, no more than
// the tiles. The kernel's shared-memory limit is raised to the block's
// maximum the first time (`attr`, one for each kernel).
template <typename Kernel>
cudaError_t tile_grid(Kernel kernel, cudaError_t* attr, int64_t B, int E,
                      int F, int H, int dhp, const Tile& t, unsigned* grid,
                      unsigned* threads) {
  const int64_t n = round_up(int64_t(E) * H * F, 32);
  if (E < 1 || n > tile_max_threads(dhp) || t.total > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  if (*attr == cudaErrorNotReady)
    *attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (*attr != cudaSuccess) return *attr;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, static_cast<int>(n), t.total);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (B + E - 1) / E;
  const int64_t most = int64_t(per_sm > 0 ? per_sm : 1) * sms;
  *grid = static_cast<unsigned>(tiles < most ? tiles : most);
  *threads = static_cast<unsigned>(n);
  return cudaSuccess;
}

// K6's tile design.
template <typename T, int DHP, bool BWD>
cudaError_t ab_tile_launch(const T* x, const T* w_aug, const T* dout, T* y,
                           int64_t B, int F, int H, int dh, float scale,
                           int E, cudaStream_t stream) {
  static cudaError_t attr = cudaErrorNotReady;
  auto kernel = BWD ? &ab_bwd_tile_kernel<T, DHP>
                    : &ab_fwd_tile_kernel<T, DHP>;
  const Tile t = tile_of(BWD, sizeof(T), E, F, H, dh);
  unsigned grid = 0, threads = 0;
  const cudaError_t err =
      tile_grid(kernel, &attr, B, E, F, H, DHP, t, &grid, &threads);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, t.total, stream>>>(x, w_aug, dout, y, B, F, H, dh,
                                             scale, E);
  return cudaGetLastError();
}

// K5's tile design: out (forward), or dq, dk and dv (backward, do given).
template <typename T, typename TO, int DHP, bool BWD>
cudaError_t fa_tile_launch(const T* q, const T* k, const T* v, const TO* dout,
                           void* o0, T* o1, T* o2, int64_t B, int F, int H,
                           int dh, float scale, int E, cudaStream_t stream) {
  static cudaError_t attr = cudaErrorNotReady;
  const Tile t = fa_tile_of(BWD, sizeof(T), sizeof(TO), E, F, H, dh);
  unsigned grid = 0, threads = 0;
  cudaError_t err;
  if constexpr (BWD) {
    auto kernel = &fa_bwd_tile_kernel<T, TO, DHP>;
    err = tile_grid(kernel, &attr, B, E, F, H, DHP, t, &grid, &threads);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, t.total, stream>>>(q, k, v, dout,
                                               static_cast<T*>(o0), o1, o2, B,
                                               F, H, dh, scale, E);
  } else {
    auto kernel = &fa_fwd_tile_kernel<T, TO, DHP>;
    err = tile_grid(kernel, &attr, B, E, F, H, DHP, t, &grid, &threads);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, t.total, stream>>>(q, k, v, static_cast<TO*>(o0),
                                               B, F, H, dh, scale, E);
  }
  return cudaGetLastError();
}

template <typename T, bool BWD>
cudaError_t ab_tile(const void* x, const void* w_aug, const void* dout,
                    void* y, int64_t B, int F, int H, int dh, float scale,
                    int E, void* stream) {
  if (!valid(B, F, H, dh) || H * dh > 64) return cudaErrorInvalidValue;
#define DT_AB_TILE(DHP)                                                    \
  return ab_tile_launch<T, DHP, BWD>(                                      \
      static_cast<const T*>(x), static_cast<const T*>(w_aug),              \
      static_cast<const T*>(dout), static_cast<T*>(y), B, F, H, dh, scale, \
      E, static_cast<cudaStream_t>(stream))
  switch (tile_dhp(dh)) {
    case 8: DT_AB_TILE(8);
    case 16: DT_AB_TILE(16);
    case 32: DT_AB_TILE(32);
    default: DT_AB_TILE(64);
  }
#undef DT_AB_TILE
}

template <typename T, typename TO, bool BWD>
cudaError_t fa_tile(const void* q, const void* k, const void* v,
                    const void* dout, void* o0, void* o1, void* o2, int64_t B,
                    int F, int H, int dh, float scale, int E, void* stream) {
  if (!valid(B, F, H, dh) || dh > 64) return cudaErrorInvalidValue;
#define DT_FA_TILE(DHP)                                                      \
  return fa_tile_launch<T, TO, DHP, BWD>(                                    \
      static_cast<const T*>(q), static_cast<const T*>(k),                    \
      static_cast<const T*>(v), static_cast<const TO*>(dout), o0,            \
      static_cast<T*>(o1), static_cast<T*>(o2), B, F, H, dh, scale, E,       \
      static_cast<cudaStream_t>(stream))
  switch (tile_dhp(dh)) {
    case 8: DT_FA_TILE(8);
    case 16: DT_FA_TILE(16);
    case 32: DT_FA_TILE(32);
    default: DT_FA_TILE(64);
  }
#undef DT_FA_TILE
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

// K5, the tile design: E examples a tile; the types as dt_fa_fwd_* and
// dt_fa_bwd_* take them.
#define DT_FA_TILE_ENTRIES(SUFFIX, T, TO)                                     \
  int dt_fa_tile_fwd_##SUFFIX(const void* q, const void* k, const void* v,    \
                              void* out, int64_t B, int F, int H, int dh,     \
                              float scale, int E, void* stream) {             \
    return static_cast<int>(fa_tile<T, TO, false>(                            \
        q, k, v, nullptr, out, nullptr, nullptr, B, F, H, dh, scale, E,       \
        stream));                                                             \
  }                                                                           \
  int dt_fa_tile_bwd_##SUFFIX(const void* q, const void* k, const void* v,    \
                              const void* dout, void* dq, void* dk, void* dv, \
                              int64_t B, int F, int H, int dh, float scale,   \
                              int E, void* stream) {                          \
    return static_cast<int>(fa_tile<T, TO, true>(                             \
        q, k, v, dout, dq, dk, dv, B, F, H, dh, scale, E, stream));           \
  }
DT_FA_TILE_ENTRIES(f32_f32, float, float)
DT_FA_TILE_ENTRIES(bf16_bf16, bf16, bf16)
DT_FA_TILE_ENTRIES(bf16_f32, bf16, float)
#undef DT_FA_TILE_ENTRIES

// Bytes of shared memory a K5 tile launch takes.
int64_t dt_fa_tile_smem(int bwd, int itemsize, int out_itemsize, int E, int F,
                        int H, int dh) {
  return fa_tile_of(bwd != 0, itemsize, out_itemsize, E, F, H, dh).total;
}

// K6, the tile design: E examples a tile.
int dt_ab_tile_fwd_f32(const void* x, const void* w_aug, void* out,
                       int64_t B, int F, int H, int dh, float scale, int E,
                       void* stream) {
  return static_cast<int>(ab_tile<float, false>(
      x, w_aug, nullptr, out, B, F, H, dh, scale, E, stream));
}
int dt_ab_tile_fwd_bf16(const void* x, const void* w_aug, void* out,
                        int64_t B, int F, int H, int dh, float scale, int E,
                        void* stream) {
  return static_cast<int>(ab_tile<bf16, false>(
      x, w_aug, nullptr, out, B, F, H, dh, scale, E, stream));
}
int dt_ab_tile_bwd_f32(const void* x, const void* w_aug, const void* dout,
                       void* dpre, int64_t B, int F, int H, int dh,
                       float scale, int E, void* stream) {
  return static_cast<int>(ab_tile<float, true>(
      x, w_aug, dout, dpre, B, F, H, dh, scale, E, stream));
}
int dt_ab_tile_bwd_bf16(const void* x, const void* w_aug, const void* dout,
                        void* dpre, int64_t B, int F, int H, int dh,
                        float scale, int E, void* stream) {
  return static_cast<int>(ab_tile<bf16, true>(
      x, w_aug, dout, dpre, B, F, H, dh, scale, E, stream));
}

// Bytes of shared memory a tile launch takes.
int64_t dt_ab_tile_smem(int bwd, int itemsize, int E, int F, int H,
                        int dh) {
  return tile_of(bwd != 0, itemsize, E, F, H, dh).total;
}

const char* dt_fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
