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
// Arithmetic: every product is float32 and every sum is float32, and each
// output is rounded once. For bfloat16 inputs the pair product is exact in
// float32 (two 8-bit significands). On the tensor cores the sums round in
// wgmma's float32 accumulator, which aligns a k step's products to the
// largest and drops the bits below it: not IEEE float32 summation, so the
// tensor-core designs differ from the plain version (and the CUDA-core
// kernels, which sum in IEEE float32 FMAs, do not) by up to about half of
// the tests' 1e-5 * sum|terms| limit at F*G ~ 1e4 (float32, measured on
// an H100), the larger the longer the sum.
//
// K4 takes 56.05 GFLOP at layer 2, B = 8192 (2*L*F*G*N): 0.0567 ms at the
// card's 989 TFLOP/s bfloat16 rate, which only the tensor cores reach.
//
// The tensor-core kernels are one template a pass (cin_fwd_wgmma_kernel<T>,
// cin_bwd_dx_wgmma_kernel<T, GT>, cin_bwd_dw_wgmma_kernel<T>) and one
// launcher a direction; wg::Split<T> holds what differs between the types:
// the planes of each operand, blocks an SM, ring stages, tile strides.
// float32's K3 has a second dx0/dh pass, cin_bwd_dx_rs_wgmma_kernel<GT>, for
// the shapes whose dz planes do not fit a block (below).
//
// K4, bfloat16 (cin_fwd_wgmma_kernel<__nv_bfloat16>): the GEMM
// Z^T (N, L) = P^T (N, K) . W^T (K, L), K = F*G, on wgmma m64n128k16
// (bfloat16 in, float32 accumulators). A block owns 128 columns n (one m64
// tile for each of its two warpgroups) and 128 l (L past 128: more
// blocks along y).
// - A, the pair, is built in registers: each thread reads its x0[f, n] and
//   h[g, n] from the block's x0 and h tiles in shared memory (bfloat16 as
//   stored, loaded once before the k loop, any D and the batch-minor
//   B = 1 alike), forms p = x0 * h in float32 (exact) and splits it into
//   hi = bf16(p) and lo = bf16(p - hi). p has 16 significant bits, hi the
//   top 8, and p - hi fits in the 8 of lo, so hi + lo == p exactly (unless
//   lo falls below float32's normal range, ~1e-38, far under any
//   activation). Two wgmmas, one with hi and one with lo against the same
//   W tile, then give the float32 sum of float32-exact products: the
//   function of the float32 kernel and of cin_fwd_reference, at twice the
//   tensor work (a 0.113 ms floor at layer 2). (f, g) of each k advances by
//   16 each step: no division in the loop.
// - B, W, is streamed by TMA: the wrapper pads W to (L, K_pad), K_pad a
//   multiple of 64 (TMA wants 16-byte row strides; K = 676 at layer 1 is
//   not), zeros past K. A ring of 4 stages of 64 k x 128 l (16 KB, 128-byte
//   swizzle, rows past L read as zeros) is refilled without a producer
//   warp: the last of the 8 warps to release a stage (a shared counter)
//   issues the TMA load of its next chunk; full mbarriers say when a stage
//   has landed. A ninth, producer warp would leave ptxas 96 registers a
//   thread at two blocks an SM (5 warps on some SM sub-partitions), too few
//   for the 64 accumulators: it spilled and serialised the wgmmas.
// - Two fragment sets: the next step's A is built while this step's two
//   wgmmas run (wait_group 1). The first wgmma writes the accumulators
//   (scale-d 0): zeroing them with moves also serialised the wgmmas.
// - Epilogue: the accumulators go through shared memory (the ring, free
//   after the k loop) and out as runs of D consecutive z values.
// - 256 threads, 117 registers, two blocks an SM. Every block re-reads W
//   from L2 (0.44 GB at layer 2); the x0/h tile load is not overlapped
//   within a block (the SM's other block runs meanwhile).
// - Shared memory: 68.6 KB + (F + G) * 272 bytes; F + G > 602 does not fit
//   and takes the CUDA-core kernel (the wrapper's fwd_design).
//
// float32 on the tensor cores: an exact three-plane bfloat16 split. Each
// float32 operand v is split as v1 = bf16(v), v2 = bf16(v - v1), v3 =
// bf16(v - v1 - v2), every plane rounded to nearest and every residual exact
// in float32: three planes of 8 significant bits hold float32's 24, so
// v1 + v2 + v3 == v (below bfloat16's normal range, ~1e-38, the low planes
// lose bits; v1 is rounded from v clamped to bfloat16's largest finite value,
// so no plane overflows). A product a.b is the sum over the plane pairs
// (i, j) with i + j <= 4: six wgmmas a k step into one float32 accumulator.
// The three pairs left out are at most ~2 * 2^-24 of |a.b|, the size of
// float32's own rounding of the product. So the float32 kernels take the
// float32 products of the plain version, as the JAX _fwd_kernel and
// _bwd_kernel do in float32 (not TF32), and sum them in the tensor cores'
// float32 accumulator (see Arithmetic above). One pass of
// the split costs 6 bfloat16 wgmmas where the bfloat16 kernels need 2: the
// float32 floor is 3x the bfloat16 one (K4 0.170 ms at layer 2).
// (3xTF32 would run at the same rate, 3 passes at 495 TFLOP/s, but TF32
// wgmma takes only K-major shared-memory operands: K3's layouts would need
// new transposes.)
//
// K4, float32 (fwd_design 'wgmma_f32', cin_fwd_wgmma_kernel<float>): the
// bfloat16 kernel's GEMM and tiles. The pair p = x0 * h is formed in
// float32 from float32 x0 and h tiles in shared memory (132 floats a row)
// and split in registers into three A fragments; W comes split by the
// wrapper into three planes, (3, L_pad, K_pad) bfloat16 (L_pad a multiple
// of 128, zeros past L and K), each stage of the ring holding one 64 k x
// 128 l tile of every plane (48 KB, three TMA loads on one barrier). Two
// stages (96 KB) and the float32 tiles ((F + G) * 528 bytes) leave one
// block an SM: 256 threads and up to 255 registers, fragments for the next
// step built while this step's six wgmmas run. F + G <= 252 fits.
//
// K3 takes 112.8 GFLOP at layer 2, B = 8192 (4*L*F*G*N for dpair and dW,
// plus 5*F*G*N for the pair, dx0 and dh): 0.1140 ms at 989 TFLOP/s, so
// operations bound it, and in bfloat16 only the tensor cores come near.
//
// K3, bfloat16 (bwd_design 'wgmma'): two passes on wgmma and two
// fixed-order sums, four launches a call.
// 1. cin_bwd_dx_wgmma_kernel<__nv_bfloat16, GT>: for each f, the GEMM
//    dpair^T (N, G) = dz^T (N, L) . W[:, f, :] (L, G) in bfloat16 (dz and
//    W already are: no split), folded in registers. A block owns 128
//    columns n (an m64 tile a warpgroup) and one G tile: m64n64k16 (G > 32;
//    G past 64 in more tiles along y) or m64n32k16 (G <= 32, padded with
//    zero W columns). Its dz columns sit in shared memory for every f, [n][l]
//    K-major in 64-wide 128-byte-swizzled panels (L padded to 64 with
//    zeros): 256 * L_pad bytes, gathered once, eight columns a 16-byte load
//    where D is a multiple of 8 (any D and the batch-minor B = 1
//    otherwise). W comes as (F, G_pad, L_pad), l contiguous (the wrapper's
//    dpair_w, 0.4 MB at layer 2), one f's 64 l x G tile per TMA load
//    through a 4-stage ring refilled by the last warp to release a stage
//    (each as soon as its wgmmas are done: one f may span more panels than
//    the ring holds).
//    After each f's wgmmas the thread's accumulators (rows n, two-column
//    groups of g) fold into dx0[f, n] = sum_g acc * h (a sum over its
//    columns, then two shuffles within its quad, in a fixed order) and
//    dh[g, n] += acc * x0[f, n] (registers across f: the same thread holds
//    the same (n, g) for every f); h stays in registers as bfloat16 pairs,
//    x0 in a shared tile. With more than one G tile each writes a float32
//    dx0 partial and
// 2. cin_sum_kernel sums them in order and rounds once.
// 3. cin_bwd_dw_wgmma_kernel<__nv_bfloat16>: dW^T (K, L) = P (K, N) .
//    dz^T (N, L) on m64n128k16, K = F*G: K4's GEMM with the roles turned. A block owns
//    128 pair rows k, 128 l and a range of columns; A, the pair, is built
//    in registers from x0 and h rows in shared memory and split exactly
//    into hi and lo bfloat16 halves, as in K4, so dW stays the float32 sum
//    of float32-exact products (the pair is not rounded to bfloat16, as
//    the JAX kernel rounds it). B, dz^T, is a [l][64 n] tile in the
//    128-byte swizzle. Each 64-column chunk's dz, x0 and h rows are
//    gathered into one of two buffers (cp.async, 16 bytes a copy, where D
//    is a multiple of 8 and the operands 16-byte aligned; loaded one by one
//    otherwise) while the chunk before runs; a barrier ends each chunk.
//    The reduction over N is cut into ranges (wgmma_bwd_plan in
//    ops/kernels/cin.py: one wave of two blocks an SM, 20 ranges at layer
//    2), each block writes a float32 partial and
// 4. cin_sum_kernel sums the partials in a fixed order into dW. No atomics:
//    dW does not depend on the order blocks run in.
// Both passes run 256 threads (two warpgroups), two blocks an SM: 128
// registers for the n64 dx0/dh pass, which spills 16 bytes (ptxas), 105
// for n32, 116 for dW, neither spilling. The fold after each f runs with no
// wgmma in flight in its warpgroup (the SM's other block fills in), and
// each dW chunk ends in a barrier. Shared memory: dx0/dh 256 * L_pad +
// 272 * F + the ring (16 or 32 KB) + 1 KB; dW two buffers of 16 KB +
// 144 * (G + x0 rows + 1). Shapes past a block's
// 227 KB (L past 704 at F = 26, G past 686 at F = 3) take the CUDA-core
// kernels (bwd_design).
//
// K3, float32 (bwd_design 'wgmma_f32'): the bfloat16 kernels' two passes
// and sums on the three-plane split, one block an SM.
// 1. cin_bwd_dx_wgmma_kernel<float, GT>: dpair^T = dz^T . W[:, f, :], dz
//    split into three planes as it is gathered into the swizzled panels (768 *
//    L_pad bytes) and W in three planes from the wrapper ((3, F, G_pad,
//    L_pad) bfloat16, each stage one f's tile of every plane), six
//    shared-memory wgmmas a 16-wide l step; the fold into dx0 and dh is the
//    bfloat16 kernel's, with float32 h in registers and x0[f, n] read from
//    global memory before each f's wgmmas (no x0 tile: shared memory goes
//    to the planes). The ring has 4, 3 or 2 stages, the most that fit
//    (wg::dx_stages): L <= 192 fits, L <= 256 for G <= 32.
// 2. cin_sum_kernel sums the dx0 partials of more than one G tile.
// 3. cin_bwd_dw_wgmma_kernel<float>: dW^T = P . dz^T, the pair built in
//    registers from float32 x0 and h rows (cp.async, 72 floats a row) and
//    split into three A fragments; dz split into three [l][64 n] planes
//    (48 KB a chunk) as it is stored: the next chunk's dz is loaded into
//    registers before this chunk's wgmmas and split into the other buffer
//    after them. The N ranges fill whole waves of one block an SM
//    (wgmma_bwd_plan). G <= 228 fits. Where D is not a multiple of 8 (or
//    an operand not 16-byte aligned: xDeepFM's D = 10) x0 and h go in by
//    4-byte cp.async, which no thread waits on before the wgmmas, and dz
//    by scalar loads into the registers that already carry it; each
//    thread's columns are found by one division a chunk (Columns), not
//    one an element. A block loads only the h rows its 128 pair rows read
//    (128 of G = 200: the pass reads its operands from L2 again for every
//    tile of pair rows, and at 200 maps that traffic bounds it).
// 4. cin_sum_kernel sums the dW partials in a fixed order: no atomics, the
//    same bits on every call.
//
// K3, float32 past the dz planes (bwd_design 'wgmma_f32_rs'): at
// xDeepFM's 200 maps (F, G, L) = (26, 200, 200) the dz planes above take
// 3 * 128 * 256 * 2 = 196,608 bytes and, with the ring at two stages,
// 246,816 in all: past a block's 232,448. This pass keeps dz once, in
// float32, and splits it in registers:
// 1. cin_bwd_dx_rs_wgmma_kernel<GT>: the same GEMM, G tiles, ring, W
//    planes and fold as cin_bwd_dx_wgmma_kernel<float, GT>, but A, dz^T,
//    comes from registers: each 16-wide l step every thread loads its
//    m64 x k16 fragment (rows n, four 8-byte loads) from a float32 [n][l]
//    tile, splits it with split<3> into three bfloat16 A fragments and
//    issues the six plane-pair wgmmas (split_wgmma_rs, m64nGTk16 with A
//    from registers) against the stage's three W planes: the same planes
//    and products as the shared-memory design, summed in the same
//    accumulator. The next step's fragments are built while a step's six
//    wgmmas run; the first step's are kept for every f. A thread gathers
//    one column of dz (one division) and stores it in 16-byte words.
//    The tile's rows are L padded to 16 (not 64: 13 steps an f at L = 200,
//    not 16) plus 8 floats, so that the four rows that a half warp's
//    8-byte loads touch start 8 banks apart. Shared memory (wg::dx_rs_smem_bytes):
//    1024 + stages * 3 * GT * 128 + 128 * (L_16 + 8) * 4 + 16 * stages,
//    the ring at 4, 3 or 2 stages, the most that fit; 209,984 bytes at
//    (G, L) = (200, 200) with 4 stages. Its limit, at two stages: L <= 336
//    for G > 32, L <= 384 for G <= 32; past it (or past the dW pass's
//    G <= 228) the CUDA-core kernels run. One block an SM, 187 registers
//    (n64) or 126 (n32), no spills.
// 2-4. cin_sum_kernel for dx0, the float32 dW pass and its sum, as above,
//    but with ranges of at most 2048 columns (wgmma_bwd_plan): wgmma's
//    accumulator drops the bits below each step's largest term, so its
//    error grows with the columns one block sums. At (26, 200, 200),
//    B = 8192, D = 10, three ranges put dW 0.45 of the tests' 1e-5 *
//    sum|terms| from the plain version and xDeepFM's second-layer dW
//    gradient 1.7e-4 of its norm from the float32 reference; 40 ranges
//    0.054 and 4.4e-5, and the pass ran faster (6.3 ms against 6.7: 25
//    waves, not 2; H100).
// bwd_design takes this pass only where the shared-memory planes do not
// fit: every shape that fits them keeps that pass, its ranges and its
// bits.
//
// K4 and K3 on the CUDA cores (design 'simt': shapes past the tensor-core
// kernels' shared memory, float32 and bfloat16), up to four launches:
// K4 (cin_fwd_kernel): Z(L, N) = W(L, F*G) @ P(F*G, N): each block of
// 256 threads owns a 128 x 128 tile of Z, each thread an 8 x 8 register
// tile (rows l = ty + 16i, columns n = tx + 16j). The block walks K = F*G
// in chunks of 8: it stages the W chunk in shared memory and builds the P
// chunk there from x0 and h (two loads and one product per element; the
// block's x0 and h columns stay in L1), then each thread does 64 FMAs per k.
// K3:
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
//    in shared memory as in the CUDA-core K4. The reduction over N,
//    which the TPU carried across its sequential grid, is split: a block owns a 128 x 128 tile of
//    dW and one of `splits` column ranges, and writes a float32 partial.
// 4. cin_sum_kernel sums the partials in a fixed order into dW. No atomics:
//    the result does not depend on the order blocks run in.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, allocates nothing (the caller passes the
// scratch buffers) and returns cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap and its enums only: no driver library link
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

// ------------------------------------------------------ K4 and K3, wgmma
// K4's GEMM Z^T (N, L) = P^T (N, K) . W^T (K, L), K = F*G, and K3's two
// passes on the tensor cores (wgmma): one template for both types over the
// split of the header, Split<T> saying what differs. See the header for the
// design; the constants below fix the tiles.
namespace wg {

constexpr int kCols = 128;   // columns n a K4 block owns: two m64 tiles
constexpr int kLTile = 128;  // l a block owns: wgmma's n128
constexpr int kChunk = 64;   // k per W stage: one 128-byte swizzle row
constexpr int kStageBytes = kChunk * kLTile * 2;  // a W plane's chunk: 16 KB
constexpr int kBlockThreads = 256;                // two warpgroups
constexpr int kWarps = kBlockThreads / 32;
constexpr int kStageLd = kCols + 4;  // z staging row stride (float)
constexpr int kStagingBytes = kLTile * kStageLd * 4;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, a block's limit on Hopper
// K3's dx0/dh pass: a block owns kDpCols columns n and one G tile (n32/n64)
constexpr int kDpCols = 128;  // two m64 tiles, one a warpgroup
constexpr int kLChunk = 64;   // l per dz panel and per W stage: 128 bytes
constexpr int kDxPanelBytes = kDpCols * kLChunk * 2;  // a dz plane's: 16 KB
// K3's dW pass: a block owns kDwRows pair rows k, kLTile l, a column range
constexpr int kDwRows = 128;        // two m64 tiles, one a warpgroup
constexpr int kDwCols = 64;         // columns n per chunk: one 128-byte row
constexpr int kDwLd = kDwCols + 8;  // x0/h chunk row stride (elements)
constexpr int kDwDzBytes = kLTile * kDwCols * 2;  // a dz plane's chunk: 16 KB

// What each type's kernels take: the bfloat16 planes of the pair (built in
// registers) and of w and dz, blocks an SM, K4's ring stages, the x0/h tile
// row stride in elements (4 banks apart), the fewest stages of the dx0/dh
// pass's ring, whether that pass keeps x0 in a shared tile (else it reads
// x0 from global memory), and a pair of T values in one register or two.
template <typename T>
struct Split;
template <>
struct Split<__nv_bfloat16> {
  static constexpr int kPair = 2;  // hi and lo of the exact pair
  static constexpr int kOp = 1;    // w and dz as stored
  static constexpr int kBlocks = 2;
  static constexpr int kFwdStages = 4;
  static constexpr int kTileLd = kCols + 8;
  static constexpr int kMinDxStages = 4;
  static constexpr bool kX0Tile = true;
  using Pair = __nv_bfloat162;
};
template <>
struct Split<float> {
  static constexpr int kPair = 3;
  static constexpr int kOp = 3;
  static constexpr int kBlocks = 1;
  static constexpr int kFwdStages = 2;
  static constexpr int kTileLd = kCols + 4;
  static constexpr int kMinDxStages = 2;
  static constexpr bool kX0Tile = false;
  using Pair = float2;
};

// K4: the W ring, reused after the k loop to stage z
template <typename T>
__host__ __device__ constexpr int fwd_region_bytes() {
  return ((Split<T>::kFwdStages * Split<T>::kOp * kStageBytes > kStagingBytes
               ? Split<T>::kFwdStages * Split<T>::kOp * kStageBytes
               : kStagingBytes) +
          1023) / 1024 * 1024;
}
// `rows` rows of an x0/h tile
template <typename T>
__host__ __device__ __forceinline__ int tile_bytes(int rows) {
  return (rows * Split<T>::kTileLd * static_cast<int>(sizeof(T)) + 7) / 8 *
         8;
}
// 1024 bytes of slack to align the ring for the 128-byte swizzle
template <typename T>
__host__ __device__ __forceinline__ int smem_bytes(int F, int G) {
  return 1024 + fwd_region_bytes<T>() + tile_bytes<T>(F + G) +
         2 * Split<T>::kFwdStages * 8;
}

__host__ __device__ __forceinline__ int bwd_g_tile(int G) {
  return G <= 32 ? 32 : 64;
}
// K3's dx0/dh pass: dz's planes, a ring of `stages` stages of one f's 64 l x
// G tile of every W plane and, where the type keeps one, the x0 tile
template <typename T>
__host__ __device__ __forceinline__ int64_t dx_smem_bytes(int F, int G,
                                                          int l_pad,
                                                          int stages) {
  return 1024 + Split<T>::kOp * static_cast<int64_t>(kDpCols) * l_pad * 2 +
         static_cast<int64_t>(stages) * Split<T>::kOp * bwd_g_tile(G) *
             kLChunk * 2 +
         (Split<T>::kX0Tile ? tile_bytes<T>(F) : 0) + 2 * stages * 8;
}
// the most ring stages, 4 down to the type's fewest, that fit a block; 0 if
// none does
template <typename T>
__host__ __device__ __forceinline__ int dx_stages(int F, int G, int l_pad) {
  for (int stages = 4; stages >= Split<T>::kMinDxStages; --stages)
    if (dx_smem_bytes<T>(F, G, l_pad, stages) <= kMaxSmemBytes) return stages;
  return 0;
}
// x0 rows a dW block reads: the f of 128 consecutive pair rows k = f*G + g
__host__ __device__ __forceinline__ int dw_x0_rows(int F, int G) {
  const int rows = 127 / G + 2;
  return rows < F ? rows : F;
}
// one chunk's buffer: dz's planes, the x0 rows and a zero row, the h rows
template <typename T>
__host__ __device__ __forceinline__ int64_t dw_buffer_bytes(int F, int G) {
  return (Split<T>::kOp * kDwDzBytes +
          (static_cast<int64_t>(dw_x0_rows(F, G)) + 1 + G) * kDwLd *
              static_cast<int64_t>(sizeof(T)) +
          1023) / 1024 * 1024;
}
template <typename T>
__host__ __device__ __forceinline__ int64_t dw_smem_bytes(int F, int G) {
  return 1024 + 2 * dw_buffer_bytes<T>(F, G);
}
// K3's float32 dx0/dh pass with dz kept once in float32 (bwd_design
// 'wgmma_f32_rs'): the dz tile's row stride in floats, L padded to the
// 16-wide l step and 8 more, so that the rows start 8 banks apart (the
// four rows of a half warp's 8-byte fragment loads hit 32 banks)
constexpr int kDzSkew = 8;
__host__ __device__ __forceinline__ int dx_rs_ld(int L) {
  return (L + 15) / 16 * 16 + kDzSkew;
}
// the ring of `stages` stages of one f's 64 l x G tile of the three W
// planes, the float32 dz tile of 128 columns, the ring's barriers
__host__ __device__ __forceinline__ int64_t dx_rs_smem_bytes(int G, int L,
                                                             int stages) {
  return 1024 +
         static_cast<int64_t>(stages) * Split<float>::kOp * bwd_g_tile(G) *
             kLChunk * 2 +
         static_cast<int64_t>(kDpCols) * dx_rs_ld(L) * 4 + 2 * stages * 8;
}
// the most ring stages, 4 down to 2, that fit a block; 0 if none does
__host__ __device__ __forceinline__ int dx_rs_stages(int G, int L) {
  for (int stages = 4; stages >= 2; --stages)
    if (dx_rs_smem_bytes(G, L, stages) <= kMaxSmemBytes) return stages;
  return 0;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float2 pack2(float a, float b) {
  return make_float2(a, b);
}
__device__ __forceinline__ __nv_bfloat162 pack2(__nv_bfloat16 a,
                                                __nv_bfloat16 b) {
  return __halves2bfloat162(a, b);
}
__device__ __forceinline__ float2 unpack2(float2 v) { return v; }
__device__ __forceinline__ float2 unpack2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// Shared-memory descriptor of a K-major operand in the 128-byte swizzle
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (64 x 128 f32, the warpgroup's accumulator fragment) = a (64 x 16
// bf16, registers) . B (16 x 128 bf16 at desc, K-major), + d unless
// `accumulate` is 0
__device__ __forceinline__ void wgmma_m64n128k16(float* d, const uint32_t* a,
                                                 uint64_t desc,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// returns once at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving uses of an accumulator across the waits
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// 4 bytes, through L1: a float32 element where the 16-byte copy does not
// apply
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d (64 x 64 f32) = A (64 x 16 bf16 at desc_a, K-major) . B (16 x 64
// bf16 at desc_b, K-major), + d unless `accumulate` is 0
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 32 f32) = A (64 x 16 bf16 at desc_a, K-major) . B (16 x 32
// bf16 at desc_b, K-major), + d unless `accumulate` is 0
__device__ __forceinline__ void wgmma_m64n32k16_ss(float* d, uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  static_assert(N == 32 || N == 64, "n32 or n64");
  if constexpr (N == 64)
    wgmma_m64n64k16_ss(d, desc_a, desc_b, accumulate);
  else
    wgmma_m64n32k16_ss(d, desc_a, desc_b, accumulate);
}

// d (64 x 64 f32) = a (64 x 16 bf16, registers) . B (16 x 64 bf16 at desc,
// K-major), + d unless `accumulate` is 0
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                  uint64_t desc,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// d (64 x 32 f32) = a (64 x 16 bf16, registers) . B (16 x 32 bf16 at desc,
// K-major), + d unless `accumulate` is 0
__device__ __forceinline__ void wgmma_m64n32k16_rs(float* d, const uint32_t* a,
                                                  uint64_t desc,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc, int accumulate) {
  static_assert(N == 32 || N == 64, "n32 or n64");
  if constexpr (N == 64)
    wgmma_m64n64k16_rs(d, a, desc, accumulate);
  else
    wgmma_m64n32k16_rs(d, a, desc, accumulate);
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two float32 values p, q as P bfloat16 pairs a[0 .. P-1][reg] (.x: p),
// each plane rounded to nearest from the exact float32 residual the planes
// before it leave: the split of the header, whose planes sum to (p, q)
// exactly (P = 3 for any float32; P = 2 for a product of two bfloat16
// values, 16 significant bits; P = 1 for a bfloat16 value). For float32
// (P = 3) plane 0 is rounded from the values clamped to bfloat16's largest
// finite value, so that it never rounds to infinity.
template <int P>
__device__ __forceinline__ void split(float p, float q, uint32_t (*a)[4],
                                      int reg) {
  const float m = __uint_as_float(0x7F7F0000u);
  __nv_bfloat162 b =
      P == 3 ? __floats2bfloat162_rn(fminf(fmaxf(p, -m), m),
                                     fminf(fmaxf(q, -m), m))
             : __floats2bfloat162_rn(p, q);
  a[0][reg] = bf162_bits(b);
#pragma unroll
  for (int i = 1; i < P; ++i) {
    const float2 f = __bfloat1622float2(b);
    p -= f.x;
    q -= f.y;
    b = __floats2bfloat162_rn(p, q);
    a[i][reg] = bf162_bits(b);
  }
}

// d (64 x 128) += the split product of A's PA planes (registers, a[plane])
// and B's PB planes (descriptors b[plane]): the plane pairs (i, j) with
// i + j < max(PA, PB), largest first (bfloat16: the pair's hi and lo
// against W or dz as stored; float32: the six pairs of the header); the
// first writes d unless `accumulate`.
template <int PA, int PB>
__device__ __forceinline__ void split_wgmma(float* d, const uint32_t (*a)[4],
                                            const uint64_t* b,
                                            int accumulate) {
  static_assert(PB == 1 || PA == PB, "the splits of the header");
  wgmma_m64n128k16(d, a[0], b[0], accumulate);
  if constexpr (PB > 1) wgmma_m64n128k16(d, a[0], b[1], 1);
  if constexpr (PA > 1) wgmma_m64n128k16(d, a[1], b[0], 1);
  if constexpr (PB > 2) wgmma_m64n128k16(d, a[0], b[2], 1);
  if constexpr (PA > 2) wgmma_m64n128k16(d, a[2], b[0], 1);
  if constexpr (PA > 2 && PB > 2) wgmma_m64n128k16(d, a[1], b[1], 1);
}

// The same with A from shared memory too, both operands in P planes, n = N
template <int N, int P>
__device__ __forceinline__ void split_wgmma_ss(float* d, const uint64_t* a,
                                               const uint64_t* b,
                                               int accumulate) {
  wgmma_ss<N>(d, a[0], b[0], accumulate);
  if constexpr (P > 1) {
    wgmma_ss<N>(d, a[0], b[1], 1);
    wgmma_ss<N>(d, a[1], b[0], 1);
  }
  if constexpr (P > 2) {
    wgmma_ss<N>(d, a[0], b[2], 1);
    wgmma_ss<N>(d, a[2], b[0], 1);
    wgmma_ss<N>(d, a[1], b[1], 1);
  }
}

// The same with A's three planes from registers (a[plane]), n = N: the six
// plane pairs of the header in split_wgmma_ss's order
template <int N>
__device__ __forceinline__ void split_wgmma_rs(float* d,
                                               const uint32_t (*a)[4],
                                               const uint64_t* b,
                                               int accumulate) {
  wgmma_rs<N>(d, a[0], b[0], accumulate);
  wgmma_rs<N>(d, a[0], b[1], 1);
  wgmma_rs<N>(d, a[1], b[0], 1);
  wgmma_rs<N>(d, a[0], b[2], 1);
  wgmma_rs<N>(d, a[2], b[0], 1);
  wgmma_rs<N>(d, a[1], b[1], 1);
}

// This thread's A fragments of one 16-wide k step in the pair's planes
// ([plane][register], the mma.m16n8k16 A layout in each warp's 16 rows:
// rows r0 and r0 + 8, k columns c0 + {0, 1, 8, 9}, (f, g) = (kf, kg)[j]),
// from the x0 and h tiles: p = x0 * h in float32 (exact for bfloat16),
// split. The pair is zero past K (f >= F). Advances (kf, kg) by 16.
template <typename T>
__device__ __forceinline__ void pair_fragment(uint32_t (*a)[4], const T* xs,
                                              const T* hs, int* kf, int* kg,
                                              int F, int G, int r0) {
  constexpr int ld = Split<T>::kTileLd;
  float p[2][4];  // [row][j]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool valid = kf[j] < F;
    const T* xr = xs + (valid ? kf[j] : 0) * ld;
    const T* hr = hs + kg[j] * ld;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int nl = r0 + 8 * r;
      p[r][j] = valid ? to_f32(xr[nl]) * to_f32(hr[nl]) : 0.f;
    }
    kg[j] += 16;
    while (kg[j] >= G) {
      kg[j] -= G;
      ++kf[j];
    }
  }
  constexpr int P = Split<T>::kPair;
  split<P>(p[0][0], p[0][1], a, 0);
  split<P>(p[1][0], p[1][1], a, 1);
  split<P>(p[0][2], p[0][3], a, 2);
  split<P>(p[1][2], p[1][3], a, 3);
}

// This thread's A fragments of one 16-wide k step of the dW pass, in the
// pair's planes: rows are pair rows (its two, at x0 row offset xoff[r] and
// h row offset hoff[r] of the chunk tiles, c0 included), k is the column
// n = col + {0, 1, 8, 9}.
template <typename T>
__device__ __forceinline__ void dw_pair_fragment(uint32_t (*a)[4],
                                                 const T* xt, const T* ht,
                                                 const int* xoff,
                                                 const int* hoff, int col) {
  using Pair = typename Split<T>::Pair;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 x =
          unpack2(*reinterpret_cast<const Pair*>(xt + xoff[r] + col + 8 * j));
      const float2 y =
          unpack2(*reinterpret_cast<const Pair*>(ht + hoff[r] + col + 8 * j));
      split<Split<T>::kPair>(x.x * y.x, x.y * y.y, a, r + 2 * j);
    }
}

// Eight consecutive values from 16-byte-aligned memory, as float32.
__device__ __forceinline__ void load8(float* v, const float* src) {
  const float4 lo = reinterpret_cast<const float4*>(src)[0];
  const float4 hi = reinterpret_cast<const float4*>(src)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}
__device__ __forceinline__ void load8(float* v, const __nv_bfloat16* src) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bfloat16 is a float32's top 16 bits
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}

// The eight columns n .. n+7 of row `row` of a (B, R, D) tensor as float32,
// zeros at columns >= end or where the row is out of range; 16-byte loads
// where `vec` (D a multiple of 8, 16-byte aligned: the eight are one run).
template <typename T>
__device__ __forceinline__ void fetch8(float* v, const T* a, int R, int row,
                                       bool row_ok, int64_t n, int64_t end,
                                       int D, bool vec) {
  if (!row_ok || n >= end) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
  } else if (vec) {
    load8(v, a + column(n, R, D) + static_cast<int64_t>(row) * D);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t c = n + i;
      v[i] = c < end
                 ? to_f32(a[column(c, R, D) + static_cast<int64_t>(row) * D])
                 : 0.f;
    }
  }
}

// Columns n .. n + C - 1 of a (B, R, D) tensor, walked from one division:
// each one's batch row b (-1 at columns >= end) and d. A thread whose
// columns stay fixed over many rows (the dW pass's gathers where D is not
// a multiple of 8) finds them once a chunk, not once an element.
template <int C>
struct Columns {
  int64_t b[C];
  int d[C];
  __device__ __forceinline__ Columns(int64_t n, int64_t end, int D) {
    int64_t bb = n / D;
    int dd = static_cast<int>(n - bb * D);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      b[i] = n + i < end ? bb : -1;
      d[i] = dd;
      if (++dd == D) {
        dd = 0;
        ++bb;
      }
    }
  }
  // column i of row `row` of a, as float32; zero past end or where the row
  // is out of range
  template <typename T>
  __device__ __forceinline__ float get(const T* a, int R, int row,
                                       bool row_ok, int i, int D) const {
    return row_ok && b[i] >= 0 ? to_f32(a[at(R, row, i, D)]) : 0.f;
  }
  // the offset of column i of row `row`
  __device__ __forceinline__ int64_t at(int R, int row, int i, int D) const {
    return (b[i] * R + row) * static_cast<int64_t>(D) + d[i];
  }
};

// The 16 bytes of columns n, n+1, .. of row `row` into shared memory:
// cp.async where `vec`, else loaded one by one; zeros past `end` or where
// the row is out of range.
template <typename T>
__device__ __forceinline__ void load_columns(void* dst, const T* a, int R,
                                             int row, bool row_ok, int64_t n,
                                             int64_t end, int D, bool vec) {
  if (!row_ok || n >= end) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if (vec) {
    cp_async16(dst, a + column(n, R, D) + static_cast<int64_t>(row) * D);
  } else {
    T* out = reinterpret_cast<T*>(dst);
#pragma unroll
    for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) {
      const int64_t c = n + i;
      out[i] = c < end ? a[column(c, R, D) + static_cast<int64_t>(row) * D]
                       : from_f32<T>(0.f);
    }
  }
}

}  // namespace wg

// K4 on the tensor cores: Z^T = P^T . W^T on wgmma over the type's split.
// W comes as (planes, l_pad, k_pad) bfloat16 (the TMA map's rows: plane p,
// l at p * l_pad + l).
template <typename T>
__global__ void __launch_bounds__(wg::kBlockThreads, wg::Split<T>::kBlocks)
    cin_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                         const T* __restrict__ x0, const T* __restrict__ h,
                         float* __restrict__ z, int64_t N, int F, int G,
                         int L, int D, int l_pad, int chunks) {
  using namespace wg;
  using S = Split<T>;
  constexpr int kStages = S::kFwdStages;
  constexpr int kStage = S::kOp * kStageBytes;  // a chunk of every W plane
  constexpr int kRegion = fwd_region_bytes<T>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* xs = reinterpret_cast<T*>(smem + kRegion);
  T* hs = xs + F * S::kTileLd;
  // full[s]: stage s holds its chunk; released[s]: warps done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRegion +
                                               tile_bytes<T>(F + G));
  int* released = reinterpret_cast<int*>(full + kStages);
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int l0 = blockIdx.y * kLTile;

  // chunk c into stage s: one TMA load a W plane, one barrier
  auto load_stage = [&](int c, int s) {
    mbar_expect_tx(full + s, kStage);
#pragma unroll
    for (int p = 0; p < S::kOp; ++p)
      tma_load_2d(smem + s * kStage + p * kStageBytes, &w_map, full + s,
                  c * kChunk, p * l_pad + l0);
  };
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < kStages && c < chunks; ++c) load_stage(c, c);
  }

  // the block's x0 and h columns, [row][column], as stored
  {
    const int nl = t % kCols;
    const int64_t n = n0 + nl;
    const bool valid = n < N;
    const T zero = from_f32<T>(0.f);
    const T* xc = x0 + (valid ? column(n, F, D) : 0);
    const T* hc = h + (valid ? column(n, G, D) : 0);
    for (int f = t / kCols; f < F; f += kBlockThreads / kCols)
      xs[f * S::kTileLd + nl] = valid ? xc[static_cast<int64_t>(f) * D] : zero;
    for (int g = t / kCols; g < G; g += kBlockThreads / kCols)
      hs[g * S::kTileLd + nl] = valid ? hc[static_cast<int64_t>(g) * D] : zero;
  }
  __syncthreads();

  // This thread's place in the A fragment (see pair_fragment); (kf, kg) =
  // (f, g) of its four k of the first step.
  const int r0 = 16 * warp + lane / 4;  // warpgroup w: rows 64w .. 64w + 63
  const int c0 = 2 * (lane % 4);
  int kf[4], kg[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = c0 + (j & 1) + 8 * (j >> 1);
    kf[j] = k / G;
    kg[j] = k % G;
  }

  // the first wgmma writes the accumulators (no instruction but a wgmma
  // defines them: ptxas would serialise the wgmmas otherwise)
  float acc[64];

  // Two fragment sets: the next step's is built while the wgmmas of this
  // one run.
  uint32_t frag[2][S::kPair][4];  // [set][plane][register]
  pair_fragment<T>(frag[0], xs, hs, kf, kg, F, G, r0);
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kStages;
    mbar_wait(full + s, (c / kStages) & 1);
    uint64_t desc[S::kOp];
#pragma unroll
    for (int p = 0; p < S::kOp; ++p)
      desc[p] = smem_desc(smem + s * kStage + p * kStageBytes);
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const int cur = kk & 1;
      // +2 in the descriptors' address fields: 16 bf16 = 32 bytes along k
      uint64_t b[S::kOp];
#pragma unroll
      for (int p = 0; p < S::kOp; ++p) b[p] = desc[p] + 2 * kk;
      wgmma_fence();
      split_wgmma<S::kPair, S::kOp>(acc, frag[cur], b, c > 0 || kk > 0);
      wgmma_commit();
      // the step before is done: its fragment set is free and, at the
      // first step of a chunk, so is the previous chunk's stage; the last
      // warp to release a stage loads its next chunk
      wgmma_wait<1>();
      if (kk == 0 && c > 0) {
        __syncwarp();
        const int ps = (c - 1) % kStages;
        if (lane == 0) {
          __threadfence_block();
          if (atomicAdd(released + ps, 1) == kWarps - 1) {
            released[ps] = 0;
            if (c - 1 + kStages < chunks) load_stage(c - 1 + kStages, ps);
          }
        }
      }
      pair_fragment<T>(frag[cur ^ 1], xs, hs, kf, kg, F, G, r0);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(acc[i]);

  // epilogue: stage z^T through shared memory (the ring is free once both
  // warpgroups are past the k loop), then write runs of D columns
  __syncthreads();
  float* zs = reinterpret_cast<float*>(smem);
  // acc[4j + e]: row r0 + 8 (e / 2), column l = 8j + c0 + e % 2
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      zs[(8 * j + c0 + (e & 1)) * kStageLd + r0 + 8 * (e >> 1)] =
          acc[4 * j + e];
  __syncthreads();
  const int nl = t % kCols;
  const int64_t n = n0 + nl;
  if (n < N) {
    float* zc = z + (n / D) * L * D + n % D;
    for (int ll = t / kCols; ll < kLTile && l0 + ll < L;
         ll += kBlockThreads / kCols)
      zc[static_cast<int64_t>(l0 + ll) * D] = zs[ll * kStageLd + nl];
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

// ---------------------------------------------------------------- K3, wgmma
// dx0/dh on the tensor cores: for each f, dpair^T (n, g) = dz^T (n, l) .
// W[:, f, g-tile] (l, g) on wgmma m64nGTk16 (GT = 32 or 64), A (dz) and B
// (W) from shared memory in the type's planes, folded into dx0 and dh in
// registers. W comes as (planes, F, g_pad, l_pad) bfloat16 (the map's rows:
// plane p, f, g at (p * F + f) * g_pad + g). See the header for the design.
template <typename T, int GT>
__global__ void __launch_bounds__(wg::kBlockThreads, wg::Split<T>::kBlocks)
    cin_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                            const T* __restrict__ x0, const T* __restrict__ h,
                            const T* __restrict__ dz, T* __restrict__ dx0,
                            float* __restrict__ dx0_part, T* __restrict__ dh,
                            int64_t N, int F, int G, int L, int D, int g_pad,
                            int l_pad, int stages, bool vec) {
  using namespace wg;
  using S = Split<T>;
  constexpr int kAcc = GT / 2;  // a thread's share of the 64 x GT tile
  constexpr int kPlane = GT * kLChunk * 2;  // a W plane's tile
  constexpr int kStage = S::kOp * kPlane;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // dz^T in its planes, each panels of 128 n x 64 l, K-major, 128-byte
  // swizzle; the ring; the x0 tile where the type keeps one
  const int64_t dz_plane = static_cast<int64_t>(kDpCols) * l_pad * 2;
  unsigned char* dzs = smem;
  unsigned char* ring = smem + S::kOp * dz_plane;
  T* xs = reinterpret_cast<T*>(ring + stages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(xs) +
      (S::kX0Tile ? tile_bytes<T>(F) : 0));
  int* released = reinterpret_cast<int*>(full + stages);
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kDpCols;
  const int g0 = blockIdx.y * GT;
  const int panels = l_pad / kLChunk;
  const int chunks = F * panels;  // chunk c: f = c / panels, l panel c % panels

  // chunk c into stage s: one TMA load a W plane, one barrier
  auto load_stage = [&](int c, int s) {
    mbar_expect_tx(full + s, kStage);
#pragma unroll
    for (int p = 0; p < S::kOp; ++p)
      tma_load_2d(ring + s * kStage + p * kPlane, &w_map, full + s,
                  (c % panels) * kLChunk, (p * F + c / panels) * g_pad + g0);
  };
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < stages && c < chunks; ++c) load_stage(c, c);
  }

  // the block's dz columns, [n][l] in the planes' swizzled panels: each item
  // is eight columns of one l, split and scattered into eight rows; zeros
  // past N and L
  for (int e = t; e < (kDpCols / 8) * l_pad; e += kBlockThreads) {
    const int l = e % l_pad, grp = e / l_pad;
    float v[8];
    fetch8(v, dz, L, l, l < L, n0 + 8 * grp, N, D, vec);
    unsigned char* panel = dzs + (l / kLChunk) * kDxPanelBytes;
    const int lc = l % kLChunk;
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      uint32_t a[S::kOp][4];
      split<S::kOp>(v[i], v[i + 1], a, 0);
#pragma unroll
      for (int p = 0; p < S::kOp; ++p)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int nl = 8 * grp + i + e2;  // nl % 8 == i + e2: the swizzle row
          *reinterpret_cast<unsigned short*>(
              panel + p * dz_plane + nl * 128 + (((lc / 8) ^ (i + e2)) * 16) +
              (lc % 8) * 2) = static_cast<unsigned short>(a[p][0] >> (16 * e2));
        }
    }
  }
  // This thread's accumulator elements (the wgmma D layout): rows
  // n = n0 + r0 + 8r, columns g = g0 + 8j + c0 + {0, 1}; acc[4j + 2r + e].
  // x0's offsets of its rows (-1 past N) and h there.
  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const T zero = from_f32<T>(0.f);
  int64_t xcol[2];
  typename S::Pair hv[GT / 8][2];  // [j][r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t n = n0 + r0 + 8 * r;
    const bool valid = n < N;
    xcol[r] = valid ? column(n, F, D) : -1;
    const T* hc = h + (valid ? column(n, G, D) : 0);
#pragma unroll
    for (int j = 0; j < GT / 8; ++j) {
      const int g = g0 + 8 * j + c0;
      hv[j][r] =
          pack2(valid && g < G ? hc[static_cast<int64_t>(g) * D] : zero,
                valid && g + 1 < G ? hc[static_cast<int64_t>(g + 1) * D]
                                   : zero);
    }
  }
  if constexpr (S::kX0Tile) {  // the block's x0 columns, [f][n], as K4's
    const int nl = t % kDpCols;
    const int64_t n = n0 + nl;
    const bool valid = n < N;
    const T* xc = x0 + (valid ? column(n, F, D) : 0);
    for (int f = t / kDpCols; f < F; f += kBlockThreads / kDpCols)
      xs[f * S::kTileLd + nl] = valid ? xc[static_cast<int64_t>(f) * D] : zero;
  }
  fence_proxy_async();  // the dz planes are read by wgmma (the async proxy)
  __syncthreads();

  float dhacc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dhacc[i] = 0.f;
  float acc[kAcc];
  // warpgroup w reads rows 64w .. 64w + 63 of every panel
  unsigned char* a_base = dzs + (warp / 4) * 64 * 128;

  // a warp is done with chunk c's stage: the last of the 8 warps to say so
  // loads the chunk `stages` ahead into it
  auto release = [&](int c) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const int s = c % stages;
      if (atomicAdd(released + s, 1) == kWarps - 1) {
        released[s] = 0;
        if (c + stages < chunks) load_stage(c + stages, s);
      }
    }
  };

  for (int f = 0; f < F; ++f) {
    // x0[f, n] of this thread's rows: without a tile, loaded from global
    // memory while the wgmmas run
    float xv[2];
    if constexpr (!S::kX0Tile) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        xv[r] = xcol[r] >= 0
                    ? to_f32(x0[xcol[r] + static_cast<int64_t>(f) * D])
                    : 0.f;
    }
    for (int p = 0; p < panels; ++p) {
      const int c = f * panels + p;
      const int s = c % stages;
      mbar_wait(full + s, (c / stages) & 1);
      uint64_t a_desc[S::kOp], b_desc[S::kOp];
#pragma unroll
      for (int q = 0; q < S::kOp; ++q) {
        a_desc[q] = smem_desc(a_base + q * dz_plane + p * kDxPanelBytes);
        b_desc[q] = smem_desc(ring + s * kStage + q * kPlane);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kLChunk / 16; ++kk) {
        // +2 in the address fields: 16 bf16 = 32 bytes along l
        uint64_t a[S::kOp], b[S::kOp];
#pragma unroll
        for (int q = 0; q < S::kOp; ++q) {
          a[q] = a_desc[q] + 2 * kk;
          b[q] = b_desc[q] + 2 * kk;
        }
        split_wgmma_ss<GT, S::kOp>(acc, a, b, p > 0 || kk > 0);
      }
      wgmma_commit();
      // the panel before is done: its stage is free at once (waiting for
      // the end of f would stall a ring shorter than one f's panels)
      if (p > 0) {
        wgmma_wait<1>();
        release(c - 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
    release(f * panels + panels - 1);
    if constexpr (S::kX0Tile) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        xv[r] = to_f32(xs[f * S::kTileLd + r0 + 8 * r]);
    }

    // acc = dpair[f, g, n]: dh += acc * x0[f, n]; dx0[f, n] = sum_g acc * h
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < GT / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 hf = unpack2(hv[j][r]);
        const int i = 4 * j + 2 * r;
        sum[r] = fmaf(acc[i], hf.x, sum[r]);
        sum[r] = fmaf(acc[i + 1], hf.y, sum[r]);
        dhacc[i] = fmaf(acc[i], xv[r], dhacc[i]);
        dhacc[i + 1] = fmaf(acc[i + 1], xv[r], dhacc[i + 1]);
      }
    // the quad of lanes that hold one row's columns, in a fixed order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (xcol[r] < 0) continue;
        const int64_t at = xcol[r] + static_cast<int64_t>(f) * D;
        if (dx0_part != nullptr)
          dx0_part[blockIdx.y * N * static_cast<int64_t>(F) + at] = sum[r];
        else
          store(dx0 + at, sum[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t n = n0 + r0 + 8 * r;
    if (n >= N) continue;
    T* hc = dh + column(n, G, D);
#pragma unroll
    for (int j = 0; j < GT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int g = g0 + 8 * j + c0 + e;
        if (g < G)
          store(hc + static_cast<int64_t>(g) * D, dhacc[4 * j + 2 * r + e]);
      }
  }
}

// K3's float32 dx0/dh pass with dz kept once in float32 (bwd_design
// 'wgmma_f32_rs'): cin_bwd_dx_wgmma_kernel<float, GT>'s GEMM, ring and fold,
// with A, dz^T, split into its three planes in registers at every 16-wide l
// step from a float32 [n][l] tile (rows of dx_rs_ld(L) floats) and fed to
// wgmma from registers. W as the other float32 pass takes it. See the
// header.
template <int GT>
__global__ void __launch_bounds__(wg::kBlockThreads, 1)
    cin_bwd_dx_rs_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                               const float* __restrict__ x0,
                               const float* __restrict__ h,
                               const float* __restrict__ dz,
                               float* __restrict__ dx0,
                               float* __restrict__ dx0_part,
                               float* __restrict__ dh, int64_t N, int F, int G,
                               int L, int D, int g_pad, int l_pad,
                               int stages) {
  using namespace wg;
  constexpr int kP = Split<float>::kOp;
  constexpr int kAcc = GT / 2;  // a thread's share of the 64 x GT tile
  constexpr int kPlane = GT * kLChunk * 2;  // a W plane's tile
  constexpr int kStage = kP * kPlane;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int ld = dx_rs_ld(L);
  float* dzs = reinterpret_cast<float*>(ring + stages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(dzs + kDpCols * ld);
  int* released = reinterpret_cast<int*>(full + stages);
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kDpCols;
  const int g0 = blockIdx.y * GT;
  const int panels = l_pad / kLChunk;
  const int chunks = F * panels;  // chunk c: f = c / panels, l panel c % panels
  const int steps = (L + 15) / 16;  // 16-wide l steps of each f

  // chunk c into stage s: one TMA load a W plane, one barrier
  auto load_stage = [&](int c, int s) {
    mbar_expect_tx(full + s, kStage);
#pragma unroll
    for (int p = 0; p < kP; ++p)
      tma_load_2d(ring + s * kStage + p * kPlane, &w_map, full + s,
                  (c % panels) * kLChunk, (p * F + c / panels) * g_pad + g0);
  };
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < stages && c < chunks; ++c) load_stage(c, c);
  }

  // the block's dz columns, [n][l] as float32: a thread owns one column and
  // every other run of 8 l, stored as two 16-byte words; zeros past N and L
  {
    const int nl = t % kDpCols;
    const int64_t n = n0 + nl;
    const float* dc = dz + (n < N ? column(n, L, D) : 0);
    float* row = dzs + nl * ld;
#pragma unroll 2
    for (int l = 8 * (t / kDpCols); l < 16 * steps; l += 16) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = n < N && l + i < L ? dc[static_cast<int64_t>(l + i) * D] : 0.f;
      reinterpret_cast<float4*>(row + l)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(row + l)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  // This thread's accumulator elements (the wgmma D layout): rows
  // n = n0 + r0 + 8r, columns g = g0 + 8j + c0 + {0, 1}; acc[4j + 2r + e].
  // x0's offsets of its rows (-1 past N) and h there.
  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  int64_t xcol[2];
  float2 hv[GT / 8][2];  // [j][r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t n = n0 + r0 + 8 * r;
    const bool valid = n < N;
    xcol[r] = valid ? column(n, F, D) : -1;
    const float* hc = h + (valid ? column(n, G, D) : 0);
#pragma unroll
    for (int j = 0; j < GT / 8; ++j) {
      const int g = g0 + 8 * j + c0;
      hv[j][r] = make_float2(
          valid && g < G ? hc[static_cast<int64_t>(g) * D] : 0.f,
          valid && g + 1 < G ? hc[static_cast<int64_t>(g + 1) * D] : 0.f);
    }
  }
  __syncthreads();

  // This thread's A fragments of l step s in dz's three planes (the layout
  // of pair_fragment: rows r0 and r0 + 8, l = 16s + c0 + {0, 1, 8, 9})
  const float* a_row = dzs + r0 * ld + c0;
  auto fragment = [&](uint32_t (*a)[4], int s) {
    const float* p = a_row + 16 * s;
    const float2 v0 = *reinterpret_cast<const float2*>(p);
    const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ld);
    const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
    split<kP>(v0.x, v0.y, a, 0);
    split<kP>(v1.x, v1.y, a, 1);
    split<kP>(v2.x, v2.y, a, 2);
    split<kP>(v3.x, v3.y, a, 3);
  };

  float dhacc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dhacc[i] = 0.f;
  float acc[kAcc];
  // the first step's fragments, the same for every f, are kept; two sets
  // take the other steps in turn, the next one's built while this step's
  // six wgmmas run
  uint32_t first[kP][4];
  uint32_t frag[2][kP][4];  // [set][plane][register]
  fragment(first, 0);

  // a warp is done with chunk c's stage: the last of the 8 warps to say so
  // loads the chunk `stages` ahead into it
  auto release = [&](int c) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const int s = c % stages;
      if (atomicAdd(released + s, 1) == kWarps - 1) {
        released[s] = 0;
        if (c + stages < chunks) load_stage(c + stages, s);
      }
    }
  };

  for (int f = 0; f < F; ++f) {
    // x0[f, n] of this thread's rows, loaded while the wgmmas run
    float xv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      xv[r] = xcol[r] >= 0 ? x0[xcol[r] + static_cast<int64_t>(f) * D] : 0.f;
    for (int p = 0; p < panels; ++p) {
      const int c = f * panels + p;
      const int s = c % stages;
      mbar_wait(full + s, (c / stages) & 1);
      uint64_t b_desc[kP];
#pragma unroll
      for (int q = 0; q < kP; ++q)
        b_desc[q] = smem_desc(ring + s * kStage + q * kPlane);
      // a panel's 4 steps (fewer in the last: L padded to 16, not 64), so
      // step 4p + kk > 0 takes fragment set kk % 2
#pragma unroll
      for (int kk = 0; kk < kLChunk / 16; ++kk) {
        const int step = 4 * p + kk;
        if (step < steps) {
          // +2 in the address fields: 16 bf16 = 32 bytes along l
          uint64_t b[kP];
#pragma unroll
          for (int q = 0; q < kP; ++q) b[q] = b_desc[q] + 2 * kk;
          wgmma_fence();
          if (step == 0)
            split_wgmma_rs<GT>(acc, first, b, 0);
          else
            split_wgmma_rs<GT>(acc, frag[kk & 1], b, 1);
          wgmma_commit();
          // the step before is done: its fragment set is free and, at a
          // panel's first step, so is the panel before's stage
          wgmma_wait<1>();
          if (kk == 0 && p > 0) release(c - 1);
          if (step + 1 < steps) fragment(frag[(kk & 1) ^ 1], step + 1);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
    release(f * panels + panels - 1);

    // acc = dpair[f, g, n]: dh += acc * x0[f, n]; dx0[f, n] = sum_g acc * h
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < GT / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r;
        sum[r] = fmaf(acc[i], hv[j][r].x, sum[r]);
        sum[r] = fmaf(acc[i + 1], hv[j][r].y, sum[r]);
        dhacc[i] = fmaf(acc[i], xv[r], dhacc[i]);
        dhacc[i + 1] = fmaf(acc[i + 1], xv[r], dhacc[i + 1]);
      }
    // the quad of lanes that hold one row's columns, in a fixed order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (xcol[r] < 0) continue;
        const int64_t at = xcol[r] + static_cast<int64_t>(f) * D;
        if (dx0_part != nullptr)
          dx0_part[blockIdx.y * N * static_cast<int64_t>(F) + at] = sum[r];
        else
          dx0[at] = sum[r];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t n = n0 + r0 + 8 * r;
    if (n >= N) continue;
    float* hc = dh + column(n, G, D);
#pragma unroll
    for (int j = 0; j < GT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int g = g0 + 8 * j + c0 + e;
        if (g < G)
          hc[static_cast<int64_t>(g) * D] = dhacc[4 * j + 2 * r + e];
      }
  }
}

// dW on the tensor cores: dW^T (k, l) = P (k, n) . dz^T (n, l) over one
// column range, wgmma m64n128k16, A (the pair) built in registers and split
// into its planes, B (dz) from shared memory in its planes. Writes a
// float32 partial; see the header.
template <typename T>
__global__ void __launch_bounds__(wg::kBlockThreads, wg::Split<T>::kBlocks)
    cin_bwd_dw_wgmma_kernel(const T* __restrict__ x0, const T* __restrict__ h,
                            const T* __restrict__ dz,
                            float* __restrict__ dw_part, int64_t N,
                            int64_t cols_per_split, int F, int G, int L, int D,
                            bool vec) {
  using namespace wg;
  using S = Split<T>;
  constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements a copy
  // a thread's share of one chunk's dz where it is split in registers:
  // kDwItems items of eight columns
  constexpr int kDwItems = kLTile * (kDwCols / 8) / kBlockThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int64_t buf_bytes = dw_buffer_bytes<T>(F, G);
  const int xr = dw_x0_rows(F, G);
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int K = F * G;
  const int k0 = blockIdx.x * kDwRows;
  const int l0 = blockIdx.y * kLTile;
  const int64_t begin = static_cast<int64_t>(blockIdx.z) * cols_per_split;
  const int64_t end = begin + cols_per_split < N ? begin + cols_per_split : N;
  float* out = dw_part + blockIdx.z * static_cast<int64_t>(L) * K;

  if (begin >= end) {  // a range past N: its partial is zero
    for (int e = t; e < kLTile * kDwRows; e += kBlockThreads) {
      const int l = l0 + e / kDwRows, k = k0 + e % kDwRows;
      if (l < L && k < K) out[static_cast<int64_t>(l) * K + k] = 0.f;
    }
    return;
  }
  const int f_lo = k0 / G;
  const int chunks = static_cast<int>((end - begin + kDwCols - 1) / kDwCols);

  // a buffer: dz^T [l][n] in its planes (128-byte swizzle), x0 rows
  // f_lo .. f_lo + xr - 1 and a zero row, h rows 0 .. G - 1, [row][n]
  auto dz_tile = [&](int b) { return smem + b * buf_bytes; };
  auto x_tile = [&](int b) {
    return reinterpret_cast<T*>(smem + b * buf_bytes + S::kOp * kDwDzBytes);
  };
  auto h_tile = [&](int b) { return x_tile(b) + (xr + 1) * kDwLd; };
  for (int b = 0; b < 2; ++b)
    for (int e = t; e < kDwLd; e += kBlockThreads)
      x_tile(b)[xr * kDwLd + e] = from_f32<T>(0.f);

  // the h rows the tile's pair rows k0 .. k0 + 127 read: g = k % G for nh
  // consecutive g from g_lo (all G where the tile spans G rows or more);
  // the others are not loaded
  const int g_lo = k0 % G;
  const int k_n = K - k0 < kDwRows ? K - k0 : kDwRows;
  const int nh = k_n < G ? k_n : G;
  auto h_row = [&](int r) { return g_lo + r < G ? g_lo + r : g_lo + r - G; };

  // chunk c's x0 and h rows into buffer b by cp.async, and its dz where dz
  // takes one plane (as stored)
  auto load = [&](int c, int b) {
    const int64_t cb = begin + static_cast<int64_t>(c) * kDwCols;
    if constexpr (S::kOp == 1) {
      unsigned char* dzt = dz_tile(b);
      for (int e = t; e < kLTile * (kDwCols / 8); e += kBlockThreads) {
        const int grp = e % 8, l = e / 8;
        load_columns(dzt + l * 128 + ((grp ^ (l % 8)) * 16), dz, L, l0 + l,
                     l0 + l < L, cb + 8 * grp, end, D, vec);
      }
    }
    T* xt = x_tile(b);
    T* ht = h_tile(b);
    if (S::kOp == 1 || vec) {
      for (int e = t; e < (xr + nh) * (kDwCols / kE); e += kBlockThreads) {
        const int grp = e % (kDwCols / kE), row = e / (kDwCols / kE);
        if (row < xr) {
          load_columns(xt + row * kDwLd + kE * grp, x0, F, f_lo + row,
                       f_lo + row < F, cb + kE * grp, end, D, vec);
        } else {
          const int g = h_row(row - xr);
          load_columns(ht + g * kDwLd + kE * grp, h, G, g, true,
                       cb + kE * grp, end, D, vec);
        }
      }
    } else {
      // float32 where D is not a multiple of 8: 4-byte copies, each
      // thread's kE columns found once (its group is the same in every
      // row: 256 is a multiple of the groups a row)
      const int grp = t % (kDwCols / kE);
      const Columns<kE> cols(cb + kE * grp, end, D);
      for (int row = t / (kDwCols / kE); row < xr + nh;
           row += kBlockThreads / (kDwCols / kE)) {
        const bool x = row < xr;
        const bool ok = !x || f_lo + row < F;
        const T* src = x ? x0 : h;
        const int R = x ? F : G, r = x ? f_lo + row : h_row(row - xr);
        T* dst = (x ? xt + row * kDwLd : ht + r * kDwLd) + kE * grp;
#pragma unroll
        for (int i = 0; i < kE; ++i) {
          if (ok && cols.b[i] >= 0)
            cp_async4(dst + i, src + cols.at(R, r, i, D));
          else
            dst[i] = from_f32<T>(0.f);
        }
      }
    }
  };
  // dz in more than one plane: item i of this thread is l = e / 8, columns
  // 8 (e % 8) .. + 7 of chunk c, loaded into registers, then split into
  // buffer b's planes
  auto fetch_dz = [&](int c, float (*v)[8]) {
    const int64_t cb = begin + static_cast<int64_t>(c) * kDwCols;
    // its 8 columns are the same in every item: found once
    const Columns<8> cols(cb + 8 * (t % 8), end, D);
#pragma unroll
    for (int i = 0; i < kDwItems; ++i) {
      const int e = t + i * kBlockThreads;
      const int grp = e % 8, l = e / 8;
      if (vec) {
        fetch8(v[i], dz, L, l0 + l, l0 + l < L, cb + 8 * grp, end, D, true);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[i][j] = cols.get(dz, L, l0 + l, l0 + l < L, j, D);
      }
    }
  };
  auto store_dz = [&](float (*v)[8], int b) {
    unsigned char* dzt = dz_tile(b);
#pragma unroll
    for (int i = 0; i < kDwItems; ++i) {
      const int e = t + i * kBlockThreads;
      const int grp = e % 8, l = e / 8;
      uint32_t a[S::kOp][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split<S::kOp>(v[i][2 * q], v[i][2 * q + 1], a, q);
#pragma unroll
      for (int p = 0; p < S::kOp; ++p)
        *reinterpret_cast<uint4*>(dzt + p * kDwDzBytes + l * 128 +
                                  ((grp ^ (l % 8)) * 16)) =
            make_uint4(a[p][0], a[p][1], a[p][2], a[p][3]);
    }
  };

  // this thread's two pair rows (the A fragment layout, as in K4) and their
  // x0 and h rows in the chunk tiles; rows past K read the zero row (times
  // h row g_lo, which is loaded)
  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  int xoff[2], hoff[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = k0 + r0 + 8 * r;
    const bool valid = k < K;
    xoff[r] = (valid ? k / G - f_lo : xr) * kDwLd + c0;
    hoff[r] = (valid ? k % G : g_lo) * kDwLd + c0;
  }

  float v[kDwItems][8];
  load(0, 0);
  cp_async_commit();
  if constexpr (S::kOp > 1) {
    fetch_dz(0, v);
    store_dz(v, 0);
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  float acc[64];  // defined by the first wgmma (scale-d 0), as in K4
  uint32_t frag[2][S::kPair][4];  // [set][plane][register]
  for (int c = 0; c < chunks; ++c) {
    const int cur = c & 1;
    const bool next = c + 1 < chunks;
    // the next chunk streams in while this one's wgmmas run (dz in more
    // than one plane into registers, split into its buffer after the
    // wgmmas are issued); its buffer's last readers finished before the
    // barrier that ended the chunk before
    if (next) {
      load(c + 1, cur ^ 1);
      if constexpr (S::kOp > 1) fetch_dz(c + 1, v);
    }
    cp_async_commit();
    uint64_t desc[S::kOp];
#pragma unroll
    for (int p = 0; p < S::kOp; ++p)
      desc[p] = smem_desc(dz_tile(cur) + p * kDwDzBytes);
    const T* xt = x_tile(cur);
    const T* ht = h_tile(cur);
#pragma unroll
    for (int kk = 0; kk < kDwCols / 16; ++kk) {
      const int set = kk & 1;
      dw_pair_fragment<T>(frag[set], xt, ht, xoff, hoff, 16 * kk);
      uint64_t b[S::kOp];
#pragma unroll
      for (int p = 0; p < S::kOp; ++p) b[p] = desc[p] + 2 * kk;
      wgmma_fence();
      split_wgmma<S::kPair, S::kOp>(acc, frag[set], b, c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the step before is done: its fragment set is free
    }
    if constexpr (S::kOp > 1) {
      if (next) store_dz(v, cur ^ 1);
    }
    wgmma_wait<0>();
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(acc[i]);

  // acc[4j + e]: pair row k0 + r0 + 8 (e / 2), l = l0 + 8j + c0 + e % 2
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + r0 + 8 * (e >> 1);
      const int l = l0 + 8 * j + c0 + (e & 1);
      if (k < K && l < L) out[static_cast<int64_t>(l) * K + k] = acc[4 * j + e];
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

// cuTensorMapEncodeTiled, from the driver through the runtime: the library
// needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// K4 on the tensor cores. w_planes: (planes, l_pad, k_pad) bfloat16, the
// type's planes of w (the wrapper's padded_w): k_pad a multiple of 64 and
// >= F*G (TMA wants row strides in multiples of 16 bytes), zeros past F*G;
// l_pad >= L, a multiple of 128 where w takes more than one plane (each
// 128-row tile of one plane), zeros past L.
template <typename T>
cudaError_t launch_fwd_wgmma(const T* x0, const T* h,
                             const __nv_bfloat16* w_planes, float* z,
                             int64_t B, int F, int G, int L, int D, int l_pad,
                             int k_pad, cudaStream_t stream) {
  constexpr int planes = wg::Split<T>::kOp;
  const int64_t N = B * D;
  if (B < 1 || bad_shape(N, F, G, L, D) || k_pad % wg::kChunk != 0 ||
      k_pad < F * G || l_pad < L ||
      (planes > 1 && l_pad % wg::kLTile != 0) ||
      planes * static_cast<int64_t>(l_pad) > 0x7fffffff ||
      wg::smem_bytes<T>(F, G) > wg::kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_pad),
                              static_cast<cuuint64_t>(planes) * l_pad};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_pad) * 2};
  const cuuint32_t box[2] = {wg::kChunk, wg::kLTile};
  const cuuint32_t steps[2] = {1, 1};
  // rows past the last plane's read as zeros
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<__nv_bfloat16*>(w_planes), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // once: the limit a launch may ask for, not what it allocates
  static const cudaError_t attr = cudaFuncSetAttribute(
      cin_fwd_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::kMaxSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>(ceil_div(N, wg::kCols)),
                  static_cast<unsigned>(ceil_div(L, wg::kLTile)));
  cin_fwd_wgmma_kernel<T><<<grid, wg::kBlockThreads, wg::smem_bytes<T>(F, G),
                            stream>>>(map, x0, h, z, N, F, G, L, D, l_pad,
                                      k_pad / wg::kChunk);
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


bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// K3 on the tensor cores. w_t: (planes, F, g_pad, l_pad) bfloat16, the
// type's planes of w in the wrapper's dpair_w layout (w_t[p, f, g, l] =
// plane p of w[l, f, g]), zeros past G and L; g_pad a multiple of the G
// tile (32 for G <= 32, else 64), l_pad of 64. dx0_part: (g_pad / tile *
// B*F*D) float32 when G > 64, else unused. dw_part: (splits * L*F*G)
// float32; the dW reduction over N is cut into ranges of cols_per_split
// columns (a multiple of 64). `rs`: float32's dx0/dh pass with dz kept
// once in float32 (bwd_design 'wgmma_f32_rs').
template <typename T>
cudaError_t launch_bwd_wgmma(const T* x0, const T* h,
                             const __nv_bfloat16* w_t, const T* dz, T* dx0,
                             T* dh, float* dw, float* dx0_part,
                             float* dw_part, int64_t B, int F, int G, int L,
                             int D, int g_pad, int l_pad, int splits,
                             int64_t cols_per_split, bool rs,
                             cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int planes = wg::Split<T>::kOp;
  const int64_t N = B * D;
  const int gt = wg::bwd_g_tile(G);
  const int stages = !rs ? wg::dx_stages<T>(F, G, l_pad)
                     : f32 ? wg::dx_rs_stages(G, L)
                           : 0;
  if (B < 1 || bad_shape(N, F, G, L, D) || l_pad % wg::kLChunk != 0 ||
      l_pad < L || g_pad % gt != 0 || g_pad < G || g_pad - G >= gt ||
      planes * static_cast<int64_t>(F) * g_pad > 0x7fffffff || splits < 1 ||
      splits > 65535 || cols_per_split < 1 ||
      cols_per_split % wg::kDwCols != 0 || cols_per_split * splits < N ||
      stages == 0 || wg::dw_smem_bytes<T>(F, G) > wg::kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const int gtiles = g_pad / gt;
  if (gtiles > 1 && dx0_part == nullptr) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(l_pad),
                              static_cast<cuuint64_t>(planes) * F * g_pad};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(l_pad) * 2};
  const cuuint32_t box[2] = {wg::kLChunk, static_cast<cuuint32_t>(gt)};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<__nv_bfloat16*>(w_t), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // once per kernel: the limit a launch may ask for
  static const cudaError_t attr_dx32 = cudaFuncSetAttribute(
      cin_bwd_dx_wgmma_kernel<T, 32>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kMaxSmemBytes);
  static const cudaError_t attr_dx64 = cudaFuncSetAttribute(
      cin_bwd_dx_wgmma_kernel<T, 64>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kMaxSmemBytes);
  static const cudaError_t attr_dw = cudaFuncSetAttribute(
      cin_bwd_dw_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::kMaxSmemBytes);
  if (attr_dx32 != cudaSuccess) return attr_dx32;
  if (attr_dx64 != cudaSuccess) return attr_dx64;
  if (attr_dw != cudaSuccess) return attr_dw;

  const dim3 dx_grid(static_cast<unsigned>(ceil_div(N, wg::kDpCols)),
                     static_cast<unsigned>(gtiles));
  const int dx_smem =
      static_cast<int>(rs ? wg::dx_rs_smem_bytes(G, L, stages)
                          : wg::dx_smem_bytes<T>(F, G, l_pad, stages));
  const bool dz_vec = D % 8 == 0 && aligned16(dz);
  float* part = gtiles > 1 ? dx0_part : nullptr;
  if (rs) {
    if constexpr (f32) {  // bfloat16 has no such pass: stages == 0 above
      static const cudaError_t attr_rs32 = cudaFuncSetAttribute(
          cin_bwd_dx_rs_wgmma_kernel<32>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kMaxSmemBytes);
      static const cudaError_t attr_rs64 = cudaFuncSetAttribute(
          cin_bwd_dx_rs_wgmma_kernel<64>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kMaxSmemBytes);
      if (attr_rs32 != cudaSuccess) return attr_rs32;
      if (attr_rs64 != cudaSuccess) return attr_rs64;
      if (gt == 32)
        cin_bwd_dx_rs_wgmma_kernel<32><<<dx_grid, wg::kBlockThreads, dx_smem,
                                         stream>>>(
            map, x0, h, dz, dx0, part, dh, N, F, G, L, D, g_pad, l_pad,
            stages);
      else
        cin_bwd_dx_rs_wgmma_kernel<64><<<dx_grid, wg::kBlockThreads, dx_smem,
                                         stream>>>(
            map, x0, h, dz, dx0, part, dh, N, F, G, L, D, g_pad, l_pad,
            stages);
    }
  } else if (gt == 32)
    cin_bwd_dx_wgmma_kernel<T, 32><<<dx_grid, wg::kBlockThreads, dx_smem,
                                     stream>>>(
        map, x0, h, dz, dx0, part, dh, N, F, G, L, D, g_pad, l_pad, stages,
        dz_vec);
  else
    cin_bwd_dx_wgmma_kernel<T, 64><<<dx_grid, wg::kBlockThreads, dx_smem,
                                     stream>>>(
        map, x0, h, dz, dx0, part, dh, N, F, G, L, D, g_pad, l_pad, stages,
        dz_vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (gtiles > 1) {
    err = launch_sum<T>(dx0_part, dx0, N * F, gtiles, stream);
    if (err != cudaSuccess) return err;
  }

  const int64_t K = static_cast<int64_t>(F) * G;
  const dim3 dw_grid(static_cast<unsigned>(ceil_div(K, wg::kDwRows)),
                     static_cast<unsigned>(ceil_div(L, wg::kLTile)),
                     static_cast<unsigned>(splits));
  cin_bwd_dw_wgmma_kernel<T><<<dw_grid, wg::kBlockThreads,
                               static_cast<int>(wg::dw_smem_bytes<T>(F, G)),
                               stream>>>(
      x0, h, dz, dw_part, N, cols_per_split, F, G, L, D,
      D % 8 == 0 && aligned16(x0) && aligned16(h) && aligned16(dz));
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

// K4 on the tensor cores: w_pad (L, k_pad), bfloat16 w's one plane, as
// launch_fwd_wgmma takes it.
int dt_cin_fwd_bf16_wgmma(const void* x0, const void* h, const void* w_pad,
                          void* z, int64_t B, int F, int G, int L, int D,
                          int k_pad, void* stream) {
  return static_cast<int>(launch_fwd_wgmma(
      static_cast<const __nv_bfloat16*>(x0),
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w_pad), static_cast<float*>(z), B, F,
      G, L, D, L, k_pad, static_cast<cudaStream_t>(stream)));
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

// K3 on the tensor cores: w_t (F, g_pad, l_pad), dx0_part and dw_part as
// launch_bwd_wgmma takes them.
int dt_cin_bwd_bf16_wgmma(const void* x0, const void* h, const void* w_t,
                          const void* dz, void* dx0, void* dh, void* dw,
                          void* dx0_part, void* dw_part, int64_t B, int F,
                          int G, int L, int D, int g_pad, int l_pad,
                          int splits, int64_t cols_per_split, void* stream) {
  return static_cast<int>(launch_bwd_wgmma(
      static_cast<const __nv_bfloat16*>(x0),
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w_t),
      static_cast<const __nv_bfloat16*>(dz),
      static_cast<__nv_bfloat16*>(dx0), static_cast<__nv_bfloat16*>(dh),
      static_cast<float*>(dw), static_cast<float*>(dx0_part),
      static_cast<float*>(dw_part), B, F, G, L, D, g_pad, l_pad, splits,
      cols_per_split, false, static_cast<cudaStream_t>(stream)));
}

// K4 in float32 on the tensor cores: w_planes (3, l_pad, k_pad) as
// launch_fwd_wgmma takes it.
int dt_cin_fwd_f32_wgmma(const void* x0, const void* h, const void* w_planes,
                         void* z, int64_t B, int F, int G, int L, int D,
                         int l_pad, int k_pad, void* stream) {
  return static_cast<int>(launch_fwd_wgmma(
      static_cast<const float*>(x0), static_cast<const float*>(h),
      static_cast<const __nv_bfloat16*>(w_planes), static_cast<float*>(z), B,
      F, G, L, D, l_pad, k_pad, static_cast<cudaStream_t>(stream)));
}

// K3 in float32 on the tensor cores: w_t (3, F, g_pad, l_pad), dx0_part
// and dw_part as launch_bwd_wgmma takes them; the dx0/dh pass with dz in
// three bfloat16 planes (dt_cin_bwd_f32_wgmma) or kept once in float32
// (dt_cin_bwd_f32_rs_wgmma).
int dt_cin_bwd_f32_wgmma(const void* x0, const void* h, const void* w_t,
                         const void* dz, void* dx0, void* dh, void* dw,
                         void* dx0_part, void* dw_part, int64_t B, int F,
                         int G, int L, int D, int g_pad, int l_pad,
                         int splits, int64_t cols_per_split, void* stream) {
  return static_cast<int>(launch_bwd_wgmma(
      static_cast<const float*>(x0), static_cast<const float*>(h),
      static_cast<const __nv_bfloat16*>(w_t), static_cast<const float*>(dz),
      static_cast<float*>(dx0), static_cast<float*>(dh),
      static_cast<float*>(dw), static_cast<float*>(dx0_part),
      static_cast<float*>(dw_part), B, F, G, L, D, g_pad, l_pad, splits,
      cols_per_split, false, static_cast<cudaStream_t>(stream)));
}

int dt_cin_bwd_f32_rs_wgmma(const void* x0, const void* h, const void* w_t,
                            const void* dz, void* dx0, void* dh, void* dw,
                            void* dx0_part, void* dw_part, int64_t B, int F,
                            int G, int L, int D, int g_pad, int l_pad,
                            int splits, int64_t cols_per_split,
                            void* stream) {
  return static_cast<int>(launch_bwd_wgmma(
      static_cast<const float*>(x0), static_cast<const float*>(h),
      static_cast<const __nv_bfloat16*>(w_t), static_cast<const float*>(dz),
      static_cast<float*>(dx0), static_cast<float*>(dh),
      static_cast<float*>(dw), static_cast<float*>(dx0_part),
      static_cast<float*>(dw_part), B, F, G, L, D, g_pad, l_pad, splits,
      cols_per_split, true, static_cast<cudaStream_t>(stream)));
}

const char* dt_cin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
