// Fused train-step kernels for Hopper (sm_90a): the attention prologue and
// the AdamW epilogue.
//
// Replaces the two Pallas TPU kernels of accelerate_tpu/ops/fused.py:
//   qkv_prologue_kernel (+ qkv_prologue_rstd_kernel), qkv_prologue_wmma_kernel
//                        <- _prologue_call's inner kernel (:214): RMSNorm
//                           (fp32) -> x.[Wq|Wk|Wv] (fp32 accumulation) + bias
//                           -> rope by rotate-half on the q and k columns
//   adamw_kernel         <- _adamw_leaf_kernel's inner kernel (:426): AdamW
//                           in optax's operation order plus the non-finite
//                           hold, over every leaf in one launch
//
// Prologue layout: x (rows, E) and the outputs q (rows, H*D), k and v
// (rows, Hkv*D) in the compute type T; the weights in PyTorch's (out, in)
// layout, one pointer each (no concatenated copy); biases in T or null;
// norm multiplier (E,) (the scale, or 1 + scale under the Gemma offset,
// formed by the caller in the scale's dtype) and the duplicated cos/sin
// tables (rows, D) in fp32. The function, with the reference's rounding
// points: xn = T((x * rstd) * mult) with rstd = 1/sqrt(mean(x^2) + eps) in
// fp32; proj = T(xn . W) summed in fp32, plus the bias in T; on q and k,
// rope = proj*cos + rot*sin with each product and the sum rounded on its
// own (no fma), stored in T. A column tile is a whole number of heads that
// never straddles the q/k/v boundaries (the reference's _col_block), so
// rope's partner column j +- D/2 is in the CTA.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at the main
// shape (4096 rows, E 4096, 6144 columns): 2*4096*4096*6144 = 206 GFLOP ->
// 0.21 ms, set by operations (about 138 MB move: 0.04 ms). Only wgmma
// reaches the tensor cores' rate.
//
// Two designs, chosen before the launch by one rule (pro_wgmma_design; its
// export prologue_design and ops/fused.py prologue_kernel_design state the
// same rule):
//
// wgmma (bf16/fp16, head_dim 64 or 128, E a multiple of 64):
// qkv_prologue_rstd_kernel writes rstd for every row once (fp32, one warp a
// row), then qkv_prologue_kernel is a GEMM of 128 rows x N columns a CTA, N
// the widest tile of whole heads <= 256 (256 at llama3_8b's widths), two
// warpgroups of 64 rows. Raw x tiles (128 x 64) and W tiles (N x 64: the
// (out, in) weight is already the K-major B operand) arrive by TMA into a
// four-stage ring of 128-byte-swizzled panels, with the k-step's 64 values
// of mult by a bulk copy, completed on mbarriers; each warp hands a stage
// back on an "empty" mbarrier and thread 0 refills it.
// The norm is applied on the A operand: each thread reads its k16 fragment
// of the raw x tile with ldmatrix, forms T((x * rstd[r]) * mult[k]) in
// registers and issues wgmma with A from registers and B by descriptor, so
// xn never reaches memory; the fragments of k-step i + 1 are formed while
// k-step i's products run. The epilogue works on the fp32 accumulator
// registers: round to T, bias in T, and rope with the partner column from
// the same thread's registers (column n and n +- D/2 sit in one thread when
// D/2 is a multiple of 8: register index +- D/4), then 4-byte stores of T.
// What it leaves for later: a producer warp and setmaxnreg, clusters with
// TMA multicast of the W tile (each W slice is read once per row tile from
// L2), a persistent grid, stores staged through shared memory.
//
// wmma (fp32, and 16-bit shapes the wgmma design does not take):
// qkv_prologue_wmma_kernel, the first port's design. Grid (row tiles,
// column tiles) of `col_block` columns (<= 512). Each CTA first computes
// its rows' rstd, then walks E: each x chunk is normalised, scaled and
// rounded to T on its way into shared memory, and each warp keeps its share
// of the fp32 accumulator in wmma fragments across the whole K loop. The
// accumulator is then staged through shared memory, where the epilogue has
// every column of a head. fp32 inputs take a scalar fp32 path with smaller
// tiles (for exact comparisons, no TF32).
//
// Epilogue: one launch over every leaf of the tree, driven by a device
// table of pointers and sizes (g, p, mu, nu fp32, updated in place) and a
// (1, 8) fp32 scalar row [reserved, bc1, bc2, -lr, finite, 0, 0, 0]. Each
// CTA takes one chunk of one leaf (a binary search over the chunk starts).
// Every product, quotient, root and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn): no fma contraction, so the result is
// bit for bit PyTorch's elementwise chain (optimizer.AdamW) and optax's.
// A step that is not finite writes nothing, which holds p, mu and nu bit
// for bit. Bound: bytes, 28 B per parameter (read g, p, mu, nu; write p,
// mu, nu): 1.923e9 parameters -> 16.1 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int NTHREADS = 512;  // prologue: 16 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_COL_BLOCK = 512;

template <typename T>
struct PTile {  // bf16 / fp16: 64 rows, K chunks of 64
  static constexpr int BR = 64;
  static constexpr int BK = 64;
};
template <>
struct PTile<float> {  // the scalar fp32 path
  static constexpr int BR = 32;
  static constexpr int BK = 32;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __host__ __device__ constexpr int ld_t(int cols) {
  return cols + 16 / (int)sizeof(T);
}
__host__ __device__ constexpr int ld_f(int cols) { return cols + 4; }
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// ------------------------------------------------------------------------
// prologue, wmma design
// ------------------------------------------------------------------------
struct ProParams {
  const void* x;
  const float* mult;
  float* rstd;  // (rows,) fp32, written by the wgmma design's pre-pass
  const void* w[3];     // wq, wk, wv: (width, E)
  const void* bias[3];  // or null
  const float* cosd;
  const float* sind;
  void* out[3];  // q, k, v: (rows, width)
  int start[3];  // first column of each part in the concatenated width
  int width[3];  // H*D, Hkv*D, Hkv*D
  int rows, E, D, col_block;  // col_block: the column tile of either design
  float eps;
};

// Shared memory: the row statistics, then one region that holds the K-loop
// staging tiles (x chunk, weight chunk) and, after the loop, the fp32
// accumulator tile.
template <typename T>
__host__ __device__ size_t pro_smem(int c, float** rstd, T** xs, T** ws, float** acc,
                                    unsigned char* base) {
  constexpr int BR = PTile<T>::BR, BK = PTile<T>::BK;
  size_t off = 0;
  if (rstd) *rstd = reinterpret_cast<float*>(base + off);
  off += align128(BR * sizeof(float));
  const size_t region = off;
  size_t stage = align128((size_t)BR * ld_t<T>(BK) * sizeof(T));
  if (xs) *xs = reinterpret_cast<T*>(base + region);
  if (ws) *ws = reinterpret_cast<T*>(base + region + stage);
  stage += align128((size_t)c * ld_t<T>(BK) * sizeof(T));
  const size_t acc_bytes = align128((size_t)BR * ld_f(c) * sizeof(float));
  if (acc) *acc = reinterpret_cast<float*>(base + region);
  return region + (stage > acc_bytes ? stage : acc_bytes);
}

template <typename T>
__device__ __forceinline__ float proj_at(const float* acc, int LA, const T* bias, int r, int n,
                                         int lc0) {
  T y = from_f<T>(acc[r * LA + n]);  // the projection rounded to T
  if (bias) y = from_f<T>(to_f(y) + to_f(bias[lc0 + n]));  // bias added in T
  return to_f(y);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) qkv_prologue_wmma_kernel(ProParams p) {
  constexpr int BR = PTile<T>::BR, BK = PTile<T>::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = p.col_block;
  float *rstd, *accs;
  T *xs, *ws;
  pro_smem<T>(c, &rstd, &xs, &ws, &accs, smem);
  const int LX = ld_t<T>(BK), LA = ld_f(c);
  const int E = p.E;
  const int row0 = blockIdx.x * BR, nrows = min(BR, p.rows - row0);
  const int col0 = blockIdx.y * c;
  const int part = col0 < p.start[1] ? 0 : (col0 < p.start[2] ? 1 : 2);
  const int lc0 = col0 - p.start[part];  // first column of the tile within its part
  const T* X = static_cast<const T*>(p.x) + (size_t)row0 * E;
  const T* W = static_cast<const T*>(p.w[part]) + (size_t)lc0 * E;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // 1/sqrt(mean(x^2) + eps) of each row, fp32
  for (int r = warp; r < BR; r += NWARPS) {
    float ss = 0.f;
    if (r < nrows)
      for (int e = lane; e < E; e += 32) {
        const float v = to_f(X[(size_t)r * E + e]);
        ss = fmaf(v, v, ss);
      }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) rstd[r] = r < nrows ? 1.f / sqrtf(ss / (float)E + p.eps) : 0.f;
  }
  __syncthreads();

  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  if constexpr (std::is_same<T, float>::value) {
    // scalar fp32: each thread owns up to BR * MAX_COL_BLOCK / NTHREADS outputs
    constexpr int PER = BR * MAX_COL_BLOCK / NTHREADS;
    float accr[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) accr[j] = 0.f;
    const int outs = BR * c;
    for (int k0 = 0; k0 < E; k0 += BK) {
      for (int i = threadIdx.x; i < BR * BK; i += NTHREADS) {
        const int r = i / BK, kk = i % BK, e = k0 + kk;
        const float v = r < nrows ? X[(size_t)r * E + e] : 0.f;
        xs[r * LX + kk] = (v * rstd[r]) * p.mult[e];
      }
      for (int i = threadIdx.x; i < c * BK; i += NTHREADS) {
        const int n = i / BK, kk = i % BK;
        ws[n * LX + kk] = W[(size_t)n * E + k0 + kk];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = threadIdx.x + j * NTHREADS;
        if (i < outs) {
          const int r = i / c, n = i % c;
          float a = accr[j];
          for (int kk = 0; kk < BK; ++kk) a = fmaf(xs[r * LX + kk], ws[n * LX + kk], a);
          accr[j] = a;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      if (i < outs) accs[(i / c) * LA + i % c] = accr[j];
    }
  } else {
    // 16 warps as 4 row groups of 16 rows x 4 column groups of c/4 columns;
    // each warp keeps c/64 (at most 8) accumulator fragments in registers
    static_assert(BR == 64, "4 row groups of 16");
    const int wm = warp % 4, wn = warp / 4, nt = c / 64;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_COL_BLOCK / 64];
#pragma unroll
    for (int t = 0; t < MAX_COL_BLOCK / 64; ++t) wmma::fill_fragment(acc[t], 0.f);
    for (int k0 = 0; k0 < E; k0 += BK) {
      // x chunk, normalised on its way in: (x * rstd) * mult, rounded to T
      for (int i = threadIdx.x; i < BR * (BK / V); i += NTHREADS) {
        const int r = i / (BK / V), kk = (i % (BK / V)) * V;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (r < nrows) raw = *reinterpret_cast<const uint4*>(X + (size_t)r * E + k0 + kk);
        const T* v = reinterpret_cast<const T*>(&raw);
        alignas(16) T o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = from_f<T>((to_f(v[j]) * rstd[r]) * p.mult[k0 + kk + j]);
        *reinterpret_cast<uint4*>(xs + r * LX + kk) = *reinterpret_cast<const uint4*>(o);
      }
      for (int i = threadIdx.x; i < c * (BK / V); i += NTHREADS) {
        const int n = i / (BK / V), kk = (i % (BK / V)) * V;
        *reinterpret_cast<uint4*>(ws + n * LX + kk) =
            *reinterpret_cast<const uint4*>(W + (size_t)n * E + k0 + kk);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + (wm * 16) * LX + kk, LX);
#pragma unroll
        for (int t = 0; t < MAX_COL_BLOCK / 64; ++t) {
          if (t < nt) {
            // b(k, n) = W[n][k]: the (out, in) weight read column-major
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
            wmma::load_matrix_sync(b, ws + (wn * nt * 16 + t * 16) * LX + kk, LX);
            wmma::mma_sync(acc[t], a, b, acc[t]);
          }
        }
      }
      __syncthreads();
    }
    // the staging buffers are free now: the accumulator takes their place
#pragma unroll
    for (int t = 0; t < MAX_COL_BLOCK / 64; ++t)
      if (t < nt)
        wmma::store_matrix_sync(accs + (wm * 16) * LA + wn * nt * 16 + t * 16, acc[t], LA,
                                wmma::mem_row_major);
  }
  __syncthreads();

  // epilogue: round, bias, rope (q and k parts), store
  const T* bias = static_cast<const T*>(p.bias[part]);
  T* out = static_cast<T*>(p.out[part]);
  const int width = p.width[part], D = p.D, half = D / 2;
  const bool roped = part < 2;
  for (int i = threadIdx.x; i < nrows * c; i += NTHREADS) {
    const int r = i / c, n = i % c;
    const float x = proj_at<T>(accs, LA, bias, r, n, lc0);
    float o = x;
    if (roped) {
      const int j = n % D;
      const float partner = proj_at<T>(accs, LA, bias, r, j < half ? n + half : n - half, lc0);
      const float rot = j < half ? -partner : partner;
      const size_t t = (size_t)(row0 + r) * D + j;
      o = __fadd_rn(__fmul_rn(x, p.cosd[t]), __fmul_rn(rot, p.sind[t]));
    }
    out[(size_t)(row0 + r) * width + lc0 + n] = from_f<T>(o);
  }
}

template <typename T>
cudaError_t launch_prologue_wmma(const ProParams& p, cudaStream_t stream) {
  constexpr int BR = PTile<T>::BR;
  const size_t bytes = pro_smem<T>(p.col_block, nullptr, nullptr, nullptr, nullptr, nullptr);
  const void* fn = reinterpret_cast<const void*>(&qkv_prologue_wmma_kernel<T>);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int total = p.start[2] + p.width[2];
  dim3 grid((p.rows + BR - 1) / BR, total / p.col_block);
  void* args[] = {const_cast<ProParams*>(&p)};
  err = cudaLaunchKernel(fn, grid, dim3(NTHREADS), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// prologue, wgmma design
// ------------------------------------------------------------------------
constexpr int RSTD_THREADS = 256;  // the pre-pass: one warp a row
constexpr int PRO_THREADS = 256;   // two warpgroups of 64 rows
constexpr int PRO_BR = 128;        // rows of a CTA's tile
constexpr int PRO_BK = 64;         // K of a ring stage: one 128-byte panel
constexpr int PRO_STAGES = 4;
constexpr int PRO_MAX_N = 256;  // columns of a CTA's tile, at most

// byte offsets from a 1024-aligned base: stage s holds the x tile (128 rows
// x 64) at s * STAGE and the W tile (N rows x 64) after it; then each
// stage's 64 values of the norm multiplier; then the full and the empty
// mbarrier of each stage
template <int N>
struct ProTiles {
  static constexpr int X = PRO_BR * PRO_BK * 2;
  static constexpr int STAGE = X + N * PRO_BK * 2;
  static constexpr int MULT = PRO_STAGES * STAGE;
  static constexpr int FULL = MULT + PRO_STAGES * PRO_BK * 4;
  static constexpr int EMPTY = FULL + 8 * PRO_STAGES;
  static constexpr int BYTES = EMPTY + 8 * PRO_STAGES;
};
// the width of one wgmma: the whole tile where one instruction takes it
template <int N>
__host__ __device__ constexpr int pro_wn() {
  return N == 192 ? 64 : N;
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (hk::kBf16<T>)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  else
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// 1/sqrt(mean(x^2) + eps) of every row, fp32, from one read of x
template <typename T>
__global__ void __launch_bounds__(RSTD_THREADS)
    qkv_prologue_rstd_kernel(const T* x, float* rstd, int rows, int E, float eps) {
  const int row = blockIdx.x * (RSTD_THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  constexpr int V = 16 / sizeof(T);
  const T* X = x + (size_t)row * E;
  float ss = 0.f;
  for (int e = lane * V; e < E; e += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(X + e);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f(v[j]);
      ss = fmaf(f, f, ss);
    }
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) rstd[row] = 1.f / sqrtf(ss / (float)E + eps);
}

// One CTA: 128 rows x N columns (whole heads of one of q, k, v), two
// warpgroups of 64 rows, the K loop over a ring of PRO_STAGES stages.
template <typename T, int N, int D>
__global__ void __launch_bounds__(PRO_THREADS, 1)
    qkv_prologue_kernel(ProParams p, const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw0,
                        const __grid_constant__ CUtensorMap tw1,
                        const __grid_constant__ CUtensorMap tw2) {
  using L = ProTiles<N>;
  constexpr int S = PRO_STAGES, KK = PRO_BK / 16, WN = pro_wn<N>(), NC = N / WN;
  static_assert(N % D == 0 && (D / 2) % 8 == 0, "whole heads; rope's partner 8-aligned");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (hk::smem_u32(smem_raw) + 1023) & ~1023u;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * PRO_BR, col0 = blockIdx.y * N;
  const int part = col0 < p.start[1] ? 0 : (col0 < p.start[2] ? 1 : 2);
  const int lc0 = col0 - p.start[part];  // first column of the tile within its part
  const CUtensorMap* tw = part == 0 ? &tw0 : (part == 1 ? &tw1 : &tw2);
  const int nk = p.E / PRO_BK;

  // The ring: k-step i (its x and W tiles and its 64 values of mult) lands
  // in stage i % S, its fill completing phase i / S of the stage's full
  // barrier (one arrival: thread 0's expect_tx, then the copies' bytes). Each of the 8 warps arrives once on the stage's empty
  // barrier when its products of k-step i have retired; thread 0 waits for
  // all 8, then refills the stage with k-step i + S. Rows past the end of x
  // land as zeros.
  const uint32_t full = base + L::FULL, empty = base + L::EMPTY;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int s = 0; s < S; ++s) {
      hk::mbar_init(full + 8 * s, 1);
      hk::mbar_init(empty + 8 * s, PRO_THREADS / 32);
    }
    hk::mbar_fence_init();
  }
  __syncthreads();
  auto load = [&](int i) {
    const int s = i % S;
    const uint32_t dst = base + s * L::STAGE;
    hk::mbar_expect_tx(full + 8 * s, L::STAGE + PRO_BK * 4);
    hk::tma_load_2d(dst, &tx, i * PRO_BK, row0, full + 8 * s);
    hk::tma_load_2d(dst + L::X, tw, i * PRO_BK, lc0, full + 8 * s);
    hk::bulk_load(base + L::MULT + s * PRO_BK * 4, p.mult + i * PRO_BK, PRO_BK * 4, full + 8 * s);
  };
  if (leader)
    for (int i = 0; i < S && i < nk; ++i) load(i);

  // this thread's accumulator rows are r and r + 8 of the tile
  const int r = wg * 64 + warp * 16 + lane / 4;
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    rs[h] = row < p.rows ? p.rstd[row] : 0.f;
  }
  // ldmatrix: lane l gives the address of row l % 8 of matrix l / 8 (matrices
  // 1 and 3 are rows 8-15, 2 and 3 columns 8-15 of the k16 step), so register
  // q of the result is the A fragment's register q (hopper.cuh's layout):
  // row r + 8 (q % 2), columns 16 kk + 2 (l % 4) + 8 (q / 2) and the next
  const int lrow = wg * 64 + warp * 16 + lane % 8 + 8 * ((lane / 8) % 2), lcol = 8 * (lane / 16);
  const float* mult = reinterpret_cast<const float*>(smem_raw + (base - hk::smem_u32(smem_raw)) +
                                                     L::MULT) + 2 * (lane % 4);
  hk::Acc<WN> acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c].zero();

  // the A fragments of k-step i: raw x read from its stage, normalised and
  // rounded to T in registers
  auto load_a = [&](int i, uint32_t(&a)[KK][4]) {
    const int s = i % S;
    hk::mbar_wait(full + 8 * s, (i / S) & 1);
    const uint32_t xt = base + s * L::STAGE;
    const float* m = mult + s * PRO_BK;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t raw[4];
      hk::ldmatrix_x4(xt + hk::swizzled<PRO_BR>(lrow, 16 * kk + lcol), raw);
      const float2 mq[2] = {*reinterpret_cast<const float2*>(m + 16 * kk),
                            *reinterpret_cast<const float2*>(m + 16 * kk + 8)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = unpack2<T>(raw[q]);
        a[kk][q] = hk::pack2<T>((v.x * rs[q % 2]) * mq[q / 2].x, (v.y * rs[q % 2]) * mq[q / 2].y);
      }
    }
  };
  // acc += xn . W^T of k-step i: A from registers, B (the W tile, K-major)
  // by descriptor
  auto issue = [&](int i, const uint32_t(&a)[KK][4]) {
    const uint32_t wt = base + (i % S) * L::STAGE + L::X;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c].fence();
    hk::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        hk::wgmma_rs<T, 0, WN>(acc[c], a[kk], hk::desc_kmajor<N>(wt, c * WN, kk), 1);
    hk::wgmma_commit();
  };
  // k-step i's stage back to the ring, refilled with k-step i + S
  auto release = [&](int i) {
    const int s = i % S;
    __syncwarp();
    if (lane == 0) hk::mbar_arrive(empty + 8 * s);
    if (leader && i + S < nk) {
      hk::mbar_wait(empty + 8 * s, (i / S) & 1);
      load(i + S);
    }
  };
  // k-step i's products go to the tensor cores; while they run, k-step i - 1
  // (whose fragments are `next`) retires and k-step i + 1's fragments are
  // formed into `next`
  auto step = [&](int i, const uint32_t(&a)[KK][4], uint32_t(&next)[KK][4]) {
    issue(i, a);
    hk::wgmma_wait<1>();  // k-step i - 1 retired: its fragments and its stage are free
    if (i > 0) release(i - 1);
    if (i + 1 < nk) load_a(i + 1, next);
  };
  uint32_t a0[KK][4], a1[KK][4];
  load_a(0, a0);
  for (int i = 0; i < nk; i += 2) {
    step(i, a0, a1);
    if (i + 1 < nk) step(i + 1, a1, a0);
  }
  hk::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c].fence();

  // epilogue on the registers. Column 8 j + 2 (l % 4) + e of row r + 8 h is
  // register 4 j + 2 h + e of the tile's accumulator (chunk (8 j) / WN).
  auto at = [&](int j, int h, int e) -> float& {
    return acc[(8 * j) / WN].d[4 * (j % (WN / 8)) + 2 * h + e];
  };
  const T* bias = static_cast<const T*>(p.bias[part]);
  const int cq = 2 * (lane % 4);
  // the projection rounded to T, plus the bias in T, lifted back to fp32
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = bias ? to_f(bias[lc0 + 8 * j + cq + e]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T y = from_f<T>(at(j, h, e));
        at(j, h, e) = bias ? to_f(from_f<T>(to_f(y) + b)) : to_f(y);
      }
    }
  // rope on q and k: column jd < D/2 of a head pairs with jd + D/2, which is
  // D/16 groups of 8 further in the same thread: x1 cos - x2 sin and
  // x2 cos + x1 sin, each product and the sum rounded on its own
  if (part < 2) {
#pragma unroll
    for (int jg = 0; jg < D / 16; ++jg)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = min(row0 + r + 8 * h, p.rows - 1);  // rows past the end are not stored
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const size_t t1 = (size_t)row * D + 8 * jg + cq + e, t2 = t1 + D / 2;
          const float c1 = p.cosd[t1], s1 = p.sind[t1], c2 = p.cosd[t2], s2 = p.sind[t2];
#pragma unroll
          for (int m = 0; m < N / D; ++m) {
            const int j1 = m * (D / 8) + jg, j2 = j1 + D / 16;
            const float x1 = at(j1, h, e), x2 = at(j2, h, e);
            at(j1, h, e) = __fadd_rn(__fmul_rn(x1, c1), __fmul_rn(-x2, s1));
            at(j2, h, e) = __fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2));
          }
        }
      }
  }
  T* out = static_cast<T*>(p.out[part]);
  const int width = p.width[part];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    if (row >= p.rows) continue;  // a partial row tile stores its rows only
    T* o = out + (size_t)row * width + lc0 + cq;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) = hk::pack2<T>(at(j, h, 0), at(j, h, 1));
  }
}

// The rule that picks the design, before the launch: bf16/fp16 (dtype codes
// 1, 2) at head_dim 64 or 128 (rope's partner D/2 columns away is then in
// the thread's own registers) with E a multiple of 64. prologue_kernel_design
// in ops/fused.py states the same rule; chip_smoke.py checks through
// prologue_design below that the two agree.
bool pro_wgmma_design(int dtype, int H, int Hkv, int D, int E) {
  return (dtype == 1 || dtype == 2) && (D == 64 || D == 128) && H > 0 && Hkv > 0 && E > 0 &&
         E % PRO_BK == 0;
}

int pro_gcd(int a, int b) { return b == 0 ? a : pro_gcd(b, a % b); }

// the wgmma design's column tile: the widest whole number of heads <= 256
// that divides both the q span and the k/v span
int pro_wgmma_tile(int H, int Hkv, int D) {
  const int g = pro_gcd(H, Hkv);
  int best = 0;
  for (int m = 1; m <= g; ++m)
    if (g % m == 0 && m * D <= PRO_MAX_N) best = m * D;
  return best;
}

// the pre-pass, then the GEMM; the tensor maps are built on every call and
// passed by value (__grid_constant__); 1024 bytes of slack align the base
template <typename T, int N, int D>
cudaError_t launch_prologue_wgmma(const ProParams& p, cudaStream_t stream) {
  CUtensorMap tx, tw[3];
  cudaError_t err = hk::tmap_2d(&tx, p.x, p.rows, p.E, PRO_BR);
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = hk::tmap_2d(&tw[i], p.w[i], p.width[i], p.E, N);
  if (err != cudaSuccess) return err;
  constexpr int per = RSTD_THREADS / 32;
  qkv_prologue_rstd_kernel<T><<<(p.rows + per - 1) / per, RSTD_THREADS, 0, stream>>>(
      static_cast<const T*>(p.x), p.rstd, p.rows, p.E, p.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(&qkv_prologue_kernel<T, N, D>);
  const int bytes = ProTiles<N>::BYTES + 1024;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.rows + PRO_BR - 1) / PRO_BR, (p.start[2] + p.width[2]) / N);
  ProParams args_p = p;
  void* args[] = {&args_p, &tx, &tw[0], &tw[1], &tw[2]};
  err = cudaLaunchKernel(fn, grid, dim3(PRO_THREADS), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_prologue_wgmma_t(const ProParams& p, cudaStream_t stream) {
  if (p.D == 128) {
    if (p.col_block == 256) return launch_prologue_wgmma<T, 256, 128>(p, stream);
    return launch_prologue_wgmma<T, 128, 128>(p, stream);
  }
  switch (p.col_block) {
    case 256: return launch_prologue_wgmma<T, 256, 64>(p, stream);
    case 192: return launch_prologue_wgmma<T, 192, 64>(p, stream);
    case 128: return launch_prologue_wgmma<T, 128, 64>(p, stream);
    default: return launch_prologue_wgmma<T, 64, 64>(p, stream);
  }
}

// ------------------------------------------------------------------------
// AdamW epilogue
// ------------------------------------------------------------------------
constexpr int EPI_THREADS = 256;
constexpr long long CHUNK = 16384;  // elements of one leaf per CTA

struct AdamConst {
  float b1, b2, omb1, omb2;  // b1, b2, (1 - b1), (1 - b2): doubles rounded once to fp32
  float eps, eps_root, wd;
};

struct Moments {
  float p, mu, nu;
};

__device__ __forceinline__ Moments adamw_one(const AdamConst& c, float bc1, float bc2,
                                             float step, float g, float p, float mu,
                                             float nu) {
  // scale_by_adam: the moments, then the bias-corrected update
  const float mu2 = __fadd_rn(__fmul_rn(c.omb1, g), __fmul_rn(c.b1, mu));
  const float nu2 = __fadd_rn(__fmul_rn(c.omb2, __fmul_rn(g, g)), __fmul_rn(c.b2, nu));
  const float mhat = __fdiv_rn(mu2, bc1);
  const float nhat = __fdiv_rn(nu2, bc2);
  float u = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(__fadd_rn(nhat, c.eps_root)), c.eps));
  // add_decayed_weights, scale_by_learning_rate (-lr * u), apply_updates
  u = __fadd_rn(u, __fmul_rn(c.wd, p));
  u = __fmul_rn(step, u);
  return {__fadd_rn(p, u), mu2, nu2};
}

// table (int64): g[L], p[L], mu[L], nu[L], n[L], chunk_start[L + 1]
__global__ void __launch_bounds__(EPI_THREADS)
    adamw_kernel(const long long* table, int L, const float* row, AdamConst c) {
  if (row[4] == 0.f) return;  // not finite: p, mu and nu stay as they are
  const long long chunk = blockIdx.x;
  const long long* starts = table + 5 * L;
  __shared__ int leaf_s;
  if (threadIdx.x == 0) {  // the last leaf whose first chunk is <= this one
    int lo = 0, hi = L - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (starts[mid] <= chunk) lo = mid; else hi = mid - 1;
    }
    leaf_s = lo;
  }
  __syncthreads();
  const int leaf = leaf_s;
  const float* g = reinterpret_cast<const float*>(table[leaf]);
  float* p = reinterpret_cast<float*>(table[L + leaf]);
  float* mu = reinterpret_cast<float*>(table[2 * L + leaf]);
  float* nu = reinterpret_cast<float*>(table[3 * L + leaf]);
  const long long n = table[4 * L + leaf];
  const long long base = (chunk - starts[leaf]) * CHUNK;
  const long long end = min(base + CHUNK, n);
  const float bc1 = row[1], bc2 = row[2], step = row[3];
  const bool aligned = ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(nu)) &
                        15) == 0;
  long long vec_end = base;
  if (aligned) {  // CHUNK is a multiple of 4, so base keeps the 16-byte alignment
    vec_end = base + ((end - base) & ~3LL);
    for (long long i = base + 4 * threadIdx.x; i < vec_end; i += 4 * EPI_THREADS) {
      const float4 gv = *reinterpret_cast<const float4*>(g + i);
      float4 pv = *reinterpret_cast<float4*>(p + i);
      float4 mv = *reinterpret_cast<float4*>(mu + i);
      float4 nv = *reinterpret_cast<float4*>(nu + i);
      const Moments a = adamw_one(c, bc1, bc2, step, gv.x, pv.x, mv.x, nv.x);
      const Moments b = adamw_one(c, bc1, bc2, step, gv.y, pv.y, mv.y, nv.y);
      const Moments d = adamw_one(c, bc1, bc2, step, gv.z, pv.z, mv.z, nv.z);
      const Moments e = adamw_one(c, bc1, bc2, step, gv.w, pv.w, mv.w, nv.w);
      *reinterpret_cast<float4*>(p + i) = make_float4(a.p, b.p, d.p, e.p);
      *reinterpret_cast<float4*>(mu + i) = make_float4(a.mu, b.mu, d.mu, e.mu);
      *reinterpret_cast<float4*>(nu + i) = make_float4(a.nu, b.nu, d.nu, e.nu);
    }
  }
  for (long long i = vec_end + threadIdx.x; i < end; i += EPI_THREADS) {
    const Moments a = adamw_one(c, bc1, bc2, step, g[i], p[i], mu[i], nu[i]);
    p[i] = a.p;
    mu[i] = a.mu;
    nu[i] = a.nu;
  }
}

}  // namespace

// The C interface bound from Python with ctypes. Each returns the
// cudaError_t of its launch (0 = success); none synchronises.

// dtype codes: 0 float32, 1 bfloat16, 2 float16. rstd: (rows,) fp32 scratch
// for the wgmma design's pre-pass (the wmma design does not read it);
// col_block: the wmma design's column tile (the wgmma design takes its own).
extern "C" int fused_qkv_prologue(const void* x, const float* mult, const void* wq,
                                  const void* wk, const void* wv, const void* bq,
                                  const void* bk, const void* bv, const float* cosd,
                                  const float* sind, void* q, void* k, void* v, float* rstd,
                                  int rows, int E, int H, int Hkv, int D, int col_block,
                                  float eps, int dtype, void* stream) {
  ProParams p = {};
  p.x = x;
  p.mult = mult;
  p.rstd = rstd;
  p.w[0] = wq;
  p.w[1] = wk;
  p.w[2] = wv;
  p.bias[0] = bq;
  p.bias[1] = bk;
  p.bias[2] = bv;
  p.cosd = cosd;
  p.sind = sind;
  p.out[0] = q;
  p.out[1] = k;
  p.out[2] = v;
  p.width[0] = H * D;
  p.width[1] = p.width[2] = Hkv * D;
  p.start[0] = 0;
  p.start[1] = H * D;
  p.start[2] = (H + Hkv) * D;
  p.rows = rows;
  p.E = E;
  p.D = D;
  p.eps = eps;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pro_wgmma_design(dtype, H, Hkv, D, E)) {
    p.col_block = pro_wgmma_tile(H, Hkv, D);
    // TMA and the bulk copy of mult read 16-byte-aligned addresses
    if (rstd == nullptr || reinterpret_cast<uintptr_t>(mult) % 16 ||
        reinterpret_cast<uintptr_t>(x) % 16)
      return (int)cudaErrorInvalidValue;
    return (int)(dtype == 1 ? launch_prologue_wgmma_t<__nv_bfloat16>(p, s)
                            : launch_prologue_wgmma_t<__half>(p, s));
  }
  p.col_block = col_block;
  if (col_block <= 0 || col_block > MAX_COL_BLOCK || col_block % 64 || col_block % D ||
      p.width[0] % col_block || p.width[1] % col_block || E % 64 || D % 2)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_prologue_wmma<float>(p, s);
    case 1: return (int)launch_prologue_wmma<__nv_bfloat16>(p, s);
    case 2: return (int)launch_prologue_wmma<__half>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 1 when a prologue launch takes the wgmma design for this dtype code,
// head counts, head_dim and hidden size, 0 when it takes the wmma design
extern "C" int prologue_design(int dtype, int H, int Hkv, int D, int E) {
  return pro_wgmma_design(dtype, H, Hkv, D, E) ? 1 : 0;
}

extern "C" int adamw_epilogue(const long long* table, int n_leaves, long long n_chunks,
                              const float* row, float b1, float b2, float omb1, float omb2,
                              float eps, float eps_root, float wd, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  AdamConst c = {b1, b2, omb1, omb2, eps, eps_root, wd};
  adamw_kernel<<<(unsigned)n_chunks, EPI_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_leaves, row, c);
  return (int)cudaGetLastError();
}

extern "C" long long adamw_chunk_elements() { return CHUNK; }

extern "C" const char* fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
