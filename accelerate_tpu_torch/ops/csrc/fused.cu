// Fused train-step kernels for Hopper (sm_90a): the attention prologue and
// the AdamW epilogue.
//
// Replaces the two Pallas TPU kernels of accelerate_tpu/ops/fused.py:
//   qkv_prologue_kernel  <- _prologue_call's inner kernel (:214): RMSNorm
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
// tables (rows, D) in fp32. Grid
// (row tiles, column tiles); a column tile is `col_block` columns, a whole
// number of heads that never straddles the q/k/v boundaries (the
// reference's _col_block), so rope's partner column j +- D/2 is in the
// CTA. Each CTA first computes its rows' 1/sqrt(mean(x^2) + eps), then
// walks E: each x chunk is normalised, scaled and rounded to T on its way
// into shared memory, and each warp keeps its share of the fp32
// accumulator in wmma fragments (registers) across the whole K loop. The
// accumulator is then staged through shared memory (reusing the staging
// buffers), where the epilogue has every column of a head: round to T, add
// the bias in T, lift to fp32, rope = x*cos + rot*sin with each product
// and the sum rounded on its own (no fma), store in T. fp32 inputs take a
// scalar fp32 path with smaller tiles (for exact comparisons, no TF32).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at the main
// shape (4096 rows, E 4096, 6144 columns): 2*4096*4096*6144 = 206 GFLOP ->
// 0.21 ms, set by operations (about 138 MB move: 0.04 ms). This first
// design leaves on the table what the flash kernels do: synchronous
// loads, no cp.async/TMA pipeline, wmma rather than wgmma.
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
// prologue
// ------------------------------------------------------------------------
struct ProParams {
  const void* x;
  const float* mult;
  const void* w[3];     // wq, wk, wv: (width, E)
  const void* bias[3];  // or null
  const float* cosd;
  const float* sind;
  void* out[3];  // q, k, v: (rows, width)
  int start[3];  // first column of each part in the concatenated width
  int width[3];  // H*D, Hkv*D, Hkv*D
  int rows, E, D, col_block;
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
__global__ void __launch_bounds__(NTHREADS) qkv_prologue_kernel(ProParams p) {
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
cudaError_t launch_prologue(const ProParams& p, cudaStream_t stream) {
  constexpr int BR = PTile<T>::BR;
  const size_t bytes = pro_smem<T>(p.col_block, nullptr, nullptr, nullptr, nullptr, nullptr);
  const void* fn = reinterpret_cast<const void*>(&qkv_prologue_kernel<T>);
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

// dtype codes: 0 float32, 1 bfloat16, 2 float16
extern "C" int fused_qkv_prologue(const void* x, const float* mult, const void* wq,
                                  const void* wk, const void* wv, const void* bq,
                                  const void* bk, const void* bv, const float* cosd,
                                  const float* sind, void* q, void* k, void* v, int rows, int E,
                                  int H, int Hkv, int D, int col_block, float eps,
                                  int dtype, void* stream) {
  ProParams p = {};
  p.x = x;
  p.mult = mult;
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
  p.col_block = col_block;
  p.eps = eps;
  if (col_block <= 0 || col_block > MAX_COL_BLOCK || col_block % 64 || col_block % D ||
      p.width[0] % col_block || p.width[1] % col_block || E % 64 || D % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_prologue<float>(p, s);
    case 1: return (int)launch_prologue<__nv_bfloat16>(p, s);
    case 2: return (int)launch_prologue<__half>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
