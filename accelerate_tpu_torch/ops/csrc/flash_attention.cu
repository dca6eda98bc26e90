// Flash attention for Hopper (sm_90a): forward, dq backward, dk/dv backward,
// and the single-pass backward.
//
// Replaces the four Pallas TPU kernels of accelerate_tpu/ops/flash_attention.py:
//   flash_fwd_kernel       <- _fwd_kernel        (online-softmax forward, O and lse)
//   flash_bwd_dq_kernel    <- _bwd_dq_kernel     (dq = sum_k ds . k)
//   flash_bwd_dkv_kernel   <- _bwd_dkv_kernel    (dk = sum_q ds^T . q, dv = sum_q p^T . do)
//   flash_bwd_fused_kernel <- _bwd_fused_kernel  (dq, dk and dv from one pass)
//
// Layout: q/o/do/dq are (B, S, H, D) and k/v/dk/dv are (B, Skv, Hkv, D), all
// contiguous; lse and delta are (B, H, S) float32. Query head h reads kv head
// h / (H / Hkv) (GQA). The causal diagonal is end-aligned (offset = Skv - S);
// the optional window keeps col > row + offset - window; optional per-batch
// kv lengths mask cols >= len. Scores, running max/sum and accumulators are
// fp32; p is rounded to v's type before p.v, ds to k's type before ds.k and
// ds^T.q, the rounding points of the reference. A row that sees no column
// gets O = 0 and lse = NEG_INF, and the backward kernels zero p where
// lse <= NEG_INF / 2, so such rows get zero gradients.
//
// Design (first port, FA2-shaped and simple): one CTA of 16 warps per
// (q tile, head, batch) for the forward and dq, per (kv tile, kv head, batch)
// for dk/dv. Tiles are staged in shared memory, products run on the tensor
// cores through nvcuda::wmma (bf16/fp16 in, fp32 out) and the fp32 tiles
// (scores, accumulators) live in shared memory, so the per-row softmax
// rescale is plain shared-memory arithmetic. The dk/dv CTA owns its kv tile
// and loops over the G query heads of its group and every visible q tile,
// so no atomics are needed. Tiles wholly above the diagonal, below the
// window band or in the padded kv tail are skipped; the element mask is
// applied only to tiles that straddle an edge. float32 inputs take a scalar
// fp32 path (no TF32) with smaller tiles; it exists for exact comparisons.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), causal,
// at B=2 S=2048 H=32 Hkv=8 D=128 (half the S x S products are visible):
//   forward: 2 products, 4*B*H*S*S*D/2 FLOP = 68.7 GFLOP -> 69 us (operations)
//   dq:      3 products, 103 GFLOP -> 104 us (operations)
//   dk/dv:   4 products, 137 GFLOP -> 139 us (operations)
//   fused:   5 products, 172 GFLOP -> 174 us (operations; dq + dk/dv: 243 us)
// Each moves under 100 MB, so bytes bound none of them (< 30 us). What this
// design leaves on the table: wmma fragments round-trip through shared
// memory, loads are synchronous (no cp.async/TMA pipeline) and the shared
// tiles hold one or two CTAs per SM at D=128; wgmma, TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr float NEG_INF = -1e30f;  // the reference's sentinel (not -inf: no inf - inf)
// 16 warps: the tiles' work spreads over more warps than the 4 of a
// classic FA2 CTA, which hides shared-memory latency (PERF.md has the
// times of both on an H100).
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;

template <typename T>
struct Tile {  // bf16 / fp16: 64 x 64 tiles
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
};
template <>
struct Tile<float> {  // fp32 tiles are twice as wide per element
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Leading dimensions of the shared tiles: 16 bytes of padding per row keeps
// wmma's alignment rules (ldm a multiple of 16 bytes, fragments 32-byte
// aligned) and staggers rows across banks.
template <typename T> __host__ __device__ constexpr int ld_t(int cols) {
  return cols + 16 / (int)sizeof(T);
}
__host__ __device__ constexpr int ld_f(int cols) { return cols + 4; }
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Bump allocator over dynamic shared memory; the host runs the same carve
// with a null base to size the launch.
struct Carve {
  unsigned char* base;
  size_t off = 0;
  __host__ __device__ explicit Carve(unsigned char* b) : base(b) {}
  template <typename U> __host__ __device__ U* take(size_t n) {
    U* p = reinterpret_cast<U*>(base + off);
    off += align128(n * sizeof(U));
    return p;
  }
};

// rows [row0, row0 + nrows) of one head of a (batch, seq, heads, D) tensor
// into shared memory, 16 bytes per thread per step; rows past seqlen are 0.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, int row_stride, int row0,
                          int nrows, int seqlen, int D) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = D / V;
  for (int i = threadIdx.x; i < nrows * vpr; i += NTHREADS) {
    const int r = i / vpr, c = (i % vpr) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seqlen)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <typename T>
__device__ void store_tile(T* dst, int row_stride, const float* src, int ld, int row0,
                           int nrows, int D) {
  for (int i = threadIdx.x; i < nrows * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    dst[(size_t)(row0 + r) * row_stride + d] = from_f<T>(src[r * ld + d]);
  }
}

__device__ void zero_f(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) p[i] = 0.f;
}

// C (M x N, fp32, shared) = or += A (M x K) . B (K x N), all warps.
// A_COL: a(m, k) = A[k * lda + m] (A stored K x M), else A[m * lda + k].
// B_COL: b(k, n) = B[n * ldb + k] (B stored N x K), else B[k * ldb + n].
// M, N, K are multiples of 16. bf16/fp16 run on the tensor cores with fp32
// accumulation; fp32 runs scalar fp32 FMAs.
template <typename T, bool A_COL, bool B_COL, bool ACC>
__device__ void mm(const T* A, int lda, const T* B, int ldb, float* C, int ldc, int M,
                   int N, int K) {
  if constexpr (std::is_same<T, float>::value) {
    for (int i = threadIdx.x; i < M * N; i += NTHREADS) {
      const int m = i / N, n = i % N;
      float acc = ACC ? C[m * ldc + n] : 0.f;
      for (int k = 0; k < K; ++k) {
        const float a = A_COL ? A[k * lda + m] : A[m * lda + k];
        const float b = B_COL ? B[n * ldb + k] : B[k * ldb + n];
        acc = fmaf(a, b, acc);
      }
      C[m * ldc + n] = acc;
    }
  } else {
    using LA = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
    const int tn = N / 16, tiles = (M / 16) * tn;
    for (int t = warp; t < tiles; t += NWARPS) {
      const int m0 = (t / tn) * 16, n0 = (t % tn) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (ACC)
        wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
        wmma::load_matrix_sync(a, A_COL ? A + k0 * lda + m0 : A + m0 * lda + k0, lda);
        wmma::load_matrix_sync(b, B_COL ? B + n0 * ldb + k0 : B + k0 * ldb + n0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
    }
  }
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const int* lengths;  // (B,) int32 or null
  void* o;             // forward: o; dq: dq; dkv: dk
  void* o2;            // dkv: dv
  float* lse;          // forward only
  float* dq_acc;       // fused backward: zeroed (B, S, H, D) fp32 dq
  int B, S, Skv, H, Hkv, D;
  float scale;
  int causal;
  int window;  // <= 0: none
};

// Valid kv columns of batch row b: [0, kv_valid).
__device__ __forceinline__ int kv_valid_of(const Params& p, int b) {
  const int len = p.lengths ? p.lengths[b] : p.Skv;
  return max(0, min(len, p.Skv));
}

__device__ __forceinline__ bool keep(const Params& p, int row, int col, int kv_valid,
                                     int offset) {
  bool k = col < kv_valid;
  if (p.causal) k = k && col <= row + offset;
  if (p.window > 0) k = k && col > row + offset - p.window;
  return k;
}

// Whether kv tile [k0, k0 + BK) needs the element mask for q rows
// [q0, qmax]: it straddles the kv end, the diagonal or the band's lower edge.
__device__ __forceinline__ bool straddles(const Params& p, int k0, int BK, int q0, int qmax,
                                          int kv_valid, int offset) {
  bool m = k0 + BK > kv_valid;
  if (p.causal) m = m || (k0 + BK - 1 > q0 + offset);
  if (p.window > 0) m = m || (k0 <= qmax + offset - p.window);
  return m;
}

// Columns visible to q rows [q0, qmax]: [c_lo, c_hi).
__device__ __forceinline__ void visible_cols(const Params& p, int q0, int qmax, int kv_valid,
                                             int offset, int* c_lo, int* c_hi) {
  int hi = kv_valid;
  if (p.causal) hi = min(hi, qmax + offset + 1);
  int lo = 0;
  if (p.window > 0) lo = max(0, q0 + offset - p.window + 1);
  *c_lo = lo;
  *c_hi = hi;
}

// ------------------------------------------------------------------------
// forward
// ------------------------------------------------------------------------
template <typename T>
struct FwdSmem {
  T *q, *k, *v, *p;
  float *s, *o, *m, *l;
  __host__ __device__ static size_t carve(unsigned char* base, int D, FwdSmem* out) {
    constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
    Carve c(base);
    FwdSmem s;
    s.q = c.take<T>(BQ * ld_t<T>(D));
    s.k = c.take<T>(BK * ld_t<T>(D));
    s.v = c.take<T>(BK * ld_t<T>(D));
    s.p = c.take<T>(BQ * ld_t<T>(BK));
    s.s = c.take<float>(BQ * ld_f(BK));
    s.o = c.take<float>(BQ * ld_f(D));
    s.m = c.take<float>(BQ);
    s.l = c.take<float>(BQ);
    if (out) *out = s;
    return c.off;
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Params p) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  FwdSmem<T> sm;
  FwdSmem<T>::carve(smem, p.D, &sm);
  const int D = p.D, LT = ld_t<T>(D), LP = ld_t<T>(BK), LS = ld_f(BK), LO = ld_f(D);
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = iq * BQ, qrows = min(BQ, p.S - q0), qmax = q0 + qrows - 1;
  const int offset = p.Skv - p.S;
  const int qstride = p.H * D, kstride = p.Hkv * D;
  const T* Q = static_cast<const T*>(p.q) + ((size_t)b * p.S * p.H + h) * D;
  const T* K = static_cast<const T*>(p.k) + ((size_t)b * p.Skv * p.Hkv + hk) * D;
  const T* Vp = static_cast<const T*>(p.v) + ((size_t)b * p.Skv * p.Hkv + hk) * D;
  const int kv_valid = kv_valid_of(p, b);
  int c_lo, c_hi;
  visible_cols(p, q0, qmax, kv_valid, offset, &c_lo, &c_hi);
  const int t_begin = c_lo / BK, t_end = c_hi > c_lo ? (c_hi + BK - 1) / BK : t_begin;

  load_tile(sm.q, LT, Q, qstride, q0, BQ, p.S, D);
  zero_f(sm.o, BQ * LO);
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    sm.m[r] = NEG_INF;
    sm.l[r] = 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  static_assert(BQ % NWARPS == 0, "softmax rows split evenly over the warps");
  constexpr int ROWS_PER_WARP = BQ / NWARPS;
  for (int it = t_begin; it < t_end; ++it) {
    const int k0 = it * BK;
    load_tile(sm.k, LT, K, kstride, k0, BK, p.Skv, D);
    load_tile(sm.v, LT, Vp, kstride, k0, BK, p.Skv, D);
    __syncthreads();
    mm<T, false, true, false>(sm.q, LT, sm.k, LT, sm.s, LS, BQ, BK, D);  // s = q k^T
    __syncthreads();
    const bool masked = straddles(p, k0, BK, q0, qmax, kv_valid, offset);
    for (int r = warp * ROWS_PER_WARP; r < (warp + 1) * ROWS_PER_WARP; ++r) {
      const int row = q0 + r;
      float vals[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        float s = sm.s[r * LS + c] * p.scale;
        if (masked && !keep(p, row, k0 + c, kv_valid, offset)) s = NEG_INF;
        vals[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        // a row with no visible column yet keeps p = 0, never exp(0) = 1
        const float pj = m_new <= NEG_INF * 0.5f ? 0.f : expf(vals[j] - m_new);
        sum += pj;
        sm.p[r * LP + lane + 32 * j] = from_f<T>(pj);
      }
      sum = warp_sum(sum);
      const float corr = expf(m_prev - m_new);
      for (int d = lane; d < D; d += 32) sm.o[r * LO + d] *= corr;
      __syncwarp();
      if (lane == 0) {
        sm.l[r] = sm.l[r] * corr + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();
    mm<T, false, false, true>(sm.p, LP, sm.v, LT, sm.o, LO, BQ, D, BK);  // o += p v
    __syncthreads();
  }
  __syncthreads();
  T* O = static_cast<T*>(p.o) + ((size_t)b * p.S * p.H + h) * D;
  for (int i = threadIdx.x; i < qrows * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const float l = sm.l[r];
    O[(size_t)(q0 + r) * qstride + d] = from_f<T>(sm.o[r * LO + d] / (l == 0.f ? 1.f : l));
  }
  float* lse = p.lse + ((size_t)b * p.H + h) * p.S;
  for (int r = threadIdx.x; r < qrows; r += NTHREADS) {
    const float l = sm.l[r];
    lse[q0 + r] = sm.m[r] + logf(l == 0.f ? 1.f : l);
  }
}

// ------------------------------------------------------------------------
// backward: shared element pass
// ------------------------------------------------------------------------
// From s = q k^T (raw) and dp = do v^T in shared memory, write p (rounded to
// T, when P is given) and ds = p (dp - delta) scale (rounded to T).
template <typename T, int BQ, int BK>
__device__ void bwd_elements(const Params& p, const float* S, const float* dP, int LS,
                             const float* lse, const float* delta, T* P, T* dS, int LP,
                             int q0, int k0, bool masked, int kv_valid, int offset) {
  for (int i = threadIdx.x; i < BQ * BK; i += NTHREADS) {
    const int r = i / BK, c = i % BK;
    float s = S[r * LS + c] * p.scale;
    if (masked && !keep(p, q0 + r, k0 + c, kv_valid, offset)) s = NEG_INF;
    const float l = lse[r];
    const float pv = l <= NEG_INF * 0.5f ? 0.f : expf(s - l);
    const float ds = pv * (dP[r * LS + c] - delta[r]) * p.scale;
    if (P) P[r * LP + c] = from_f<T>(pv);
    dS[r * LP + c] = from_f<T>(ds);
  }
}

__device__ void load_rowstats(float* lse_s, float* delta_s, const Params& p, int b, int h,
                              int q0, int BQ) {
  const float* L = p.lse_in + ((size_t)b * p.H + h) * p.S;
  const float* Dl = p.delta + ((size_t)b * p.H + h) * p.S;
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const bool in = q0 + r < p.S;
    lse_s[r] = in ? L[q0 + r] : NEG_INF;  // rows past S contribute nothing
    delta_s[r] = in ? Dl[q0 + r] : 0.f;
  }
}

// ------------------------------------------------------------------------
// dq
// ------------------------------------------------------------------------
template <typename T>
struct DqSmem {
  T *q, *dout, *k, *v, *ds;
  float *s, *dp, *dq, *lse, *delta;
  __host__ __device__ static size_t carve(unsigned char* base, int D, DqSmem* out) {
    constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
    Carve c(base);
    DqSmem s;
    s.q = c.take<T>(BQ * ld_t<T>(D));
    s.dout = c.take<T>(BQ * ld_t<T>(D));
    s.k = c.take<T>(BK * ld_t<T>(D));
    s.v = c.take<T>(BK * ld_t<T>(D));
    s.ds = c.take<T>(BQ * ld_t<T>(BK));
    s.s = c.take<float>(BQ * ld_f(BK));
    s.dp = c.take<float>(BQ * ld_f(BK));
    s.dq = c.take<float>(BQ * ld_f(D));
    s.lse = c.take<float>(BQ);
    s.delta = c.take<float>(BQ);
    if (out) *out = s;
    return c.off;
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(Params p) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  DqSmem<T> sm;
  DqSmem<T>::carve(smem, p.D, &sm);
  const int D = p.D, LT = ld_t<T>(D), LP = ld_t<T>(BK), LS = ld_f(BK), LO = ld_f(D);
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = iq * BQ, qrows = min(BQ, p.S - q0), qmax = q0 + qrows - 1;
  const int offset = p.Skv - p.S;
  const int qstride = p.H * D, kstride = p.Hkv * D;
  const size_t qbase = ((size_t)b * p.S * p.H + h) * D;
  const size_t kbase = ((size_t)b * p.Skv * p.Hkv + hk) * D;
  const int kv_valid = kv_valid_of(p, b);
  int c_lo, c_hi;
  visible_cols(p, q0, qmax, kv_valid, offset, &c_lo, &c_hi);
  const int t_begin = c_lo / BK, t_end = c_hi > c_lo ? (c_hi + BK - 1) / BK : t_begin;

  load_tile(sm.q, LT, static_cast<const T*>(p.q) + qbase, qstride, q0, BQ, p.S, D);
  load_tile(sm.dout, LT, static_cast<const T*>(p.dout) + qbase, qstride, q0, BQ, p.S, D);
  load_rowstats(sm.lse, sm.delta, p, b, h, q0, BQ);
  zero_f(sm.dq, BQ * LO);
  for (int it = t_begin; it < t_end; ++it) {
    const int k0 = it * BK;
    load_tile(sm.k, LT, static_cast<const T*>(p.k) + kbase, kstride, k0, BK, p.Skv, D);
    load_tile(sm.v, LT, static_cast<const T*>(p.v) + kbase, kstride, k0, BK, p.Skv, D);
    __syncthreads();
    mm<T, false, true, false>(sm.q, LT, sm.k, LT, sm.s, LS, BQ, BK, D);     // s = q k^T
    mm<T, false, true, false>(sm.dout, LT, sm.v, LT, sm.dp, LS, BQ, BK, D);  // dp = do v^T
    __syncthreads();
    bwd_elements<T, BQ, BK>(p, sm.s, sm.dp, LS, sm.lse, sm.delta, nullptr, sm.ds, LP, q0, k0,
                            straddles(p, k0, BK, q0, qmax, kv_valid, offset), kv_valid,
                            offset);
    __syncthreads();
    mm<T, false, false, true>(sm.ds, LP, sm.k, LT, sm.dq, LO, BQ, D, BK);  // dq += ds k
    __syncthreads();
  }
  __syncthreads();
  store_tile(static_cast<T*>(p.o) + qbase, qstride, sm.dq, LO, q0, qrows, D);
}

// ------------------------------------------------------------------------
// dk / dv
// ------------------------------------------------------------------------
template <typename T>
struct DkvSmem {
  T *k, *v, *q, *dout, *p, *ds;
  float *s, *dp, *dk, *dv, *lse, *delta;
  __host__ __device__ static size_t carve(unsigned char* base, int D, DkvSmem* out) {
    constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
    Carve c(base);
    DkvSmem s;
    s.k = c.take<T>(BK * ld_t<T>(D));
    s.v = c.take<T>(BK * ld_t<T>(D));
    s.q = c.take<T>(BQ * ld_t<T>(D));
    s.dout = c.take<T>(BQ * ld_t<T>(D));
    s.p = c.take<T>(BQ * ld_t<T>(BK));
    s.ds = c.take<T>(BQ * ld_t<T>(BK));
    s.s = c.take<float>(BQ * ld_f(BK));
    s.dp = c.take<float>(BQ * ld_f(BK));
    s.dk = c.take<float>(BK * ld_f(D));
    s.dv = c.take<float>(BK * ld_f(D));
    s.lse = c.take<float>(BQ);
    s.delta = c.take<float>(BQ);
    if (out) *out = s;
    return c.off;
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(Params p) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  DkvSmem<T> sm;
  DkvSmem<T>::carve(smem, p.D, &sm);
  const int D = p.D, LT = ld_t<T>(D), LP = ld_t<T>(BK), LS = ld_f(BK), LO = ld_f(D);
  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int k0 = ik * BK, krows = min(BK, p.Skv - k0);
  const int offset = p.Skv - p.S;
  const int qstride = p.H * D, kstride = p.Hkv * D;
  const size_t kbase = ((size_t)b * p.Skv * p.Hkv + hk) * D;
  const int kv_valid = kv_valid_of(p, b);
  // q rows that see any column of this tile: [r_lo, r_hi)
  int r_lo = 0, r_hi = 0;
  if (k0 < kv_valid) {
    const int kmax = min(k0 + BK, kv_valid) - 1;
    r_lo = p.causal ? max(0, k0 - offset) : 0;
    r_hi = p.S;
    if (p.window > 0) r_hi = min(r_hi, max(0, kmax - offset + p.window));
  }
  const int t_begin = r_lo / BQ, t_end = r_hi > r_lo ? (r_hi + BQ - 1) / BQ : t_begin;

  load_tile(sm.k, LT, static_cast<const T*>(p.k) + kbase, kstride, k0, BK, p.Skv, D);
  load_tile(sm.v, LT, static_cast<const T*>(p.v) + kbase, kstride, k0, BK, p.Skv, D);
  zero_f(sm.dk, BK * LO);
  zero_f(sm.dv, BK * LO);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qbase = ((size_t)b * p.S * p.H + h) * D;
    for (int it = t_begin; it < t_end; ++it) {
      const int q0 = it * BQ, qmax = min(q0 + BQ, p.S) - 1;
      load_tile(sm.q, LT, static_cast<const T*>(p.q) + qbase, qstride, q0, BQ, p.S, D);
      load_tile(sm.dout, LT, static_cast<const T*>(p.dout) + qbase, qstride, q0, BQ, p.S, D);
      load_rowstats(sm.lse, sm.delta, p, b, h, q0, BQ);
      __syncthreads();
      mm<T, false, true, false>(sm.q, LT, sm.k, LT, sm.s, LS, BQ, BK, D);     // s = q k^T
      mm<T, false, true, false>(sm.dout, LT, sm.v, LT, sm.dp, LS, BQ, BK, D);  // dp = do v^T
      __syncthreads();
      bwd_elements<T, BQ, BK>(p, sm.s, sm.dp, LS, sm.lse, sm.delta, sm.p, sm.ds, LP, q0, k0,
                              straddles(p, k0, BK, q0, qmax, kv_valid, offset), kv_valid,
                              offset);
      __syncthreads();
      mm<T, true, false, true>(sm.p, LP, sm.dout, LT, sm.dv, LO, BK, D, BQ);  // dv += p^T do
      mm<T, true, false, true>(sm.ds, LP, sm.q, LT, sm.dk, LO, BK, D, BQ);    // dk += ds^T q
      __syncthreads();
    }
  }
  __syncthreads();
  store_tile(static_cast<T*>(p.o) + kbase, kstride, sm.dk, LO, k0, krows, D);
  store_tile(static_cast<T*>(p.o2) + kbase, kstride, sm.dv, LO, k0, krows, D);
}

// ------------------------------------------------------------------------
// single-pass backward: dq, dk and dv
// ------------------------------------------------------------------------
// The dk/dv kernel's CTA (one kv tile of one kv head, sweeping the G query
// heads of its group and every visible q tile) also forms each pair's dq
// contribution ds . k and adds it to a zeroed fp32 (B, S, H, D) buffer with
// vector atomics. Per pair: 5 products (s, dp, dv, dk, dq) against 7 for
// the dq + dk/dv pair of kernels, and q, k, v, do are read once. The
// reference keeps per-head dk/dv partials and sums the group outside the
// kernel because a TPU output block may only be revisited in consecutive
// grid steps (accelerate_tpu/ops/flash_attention.py:393-417); a CTA here
// owns its dk/dv tile, so no partials are needed. dq's sum over kv tiles
// runs in whatever order the atomics land: not bitwise reproducible.
template <typename T>
struct FusedSmem {
  T *k, *v, *q, *dout, *p, *ds;
  float *s, *dp, *dk, *dv, *dq, *lse, *delta;
  __host__ __device__ static size_t carve(unsigned char* base, int D, FusedSmem* out) {
    constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
    Carve c(base);
    FusedSmem s;
    s.k = c.take<T>(BK * ld_t<T>(D));
    s.v = c.take<T>(BK * ld_t<T>(D));
    s.q = c.take<T>(BQ * ld_t<T>(D));
    s.dout = c.take<T>(BQ * ld_t<T>(D));
    s.p = c.take<T>(BQ * ld_t<T>(BK));
    s.ds = c.take<T>(BQ * ld_t<T>(BK));
    s.s = c.take<float>(BQ * ld_f(BK));
    s.dp = c.take<float>(BQ * ld_f(BK));
    s.dk = c.take<float>(BK * ld_f(D));
    s.dv = c.take<float>(BK * ld_f(D));
    s.dq = c.take<float>(BQ * ld_f(D));
    s.lse = c.take<float>(BQ);
    s.delta = c.take<float>(BQ);
    if (out) *out = s;
    return c.off;
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_fused_kernel(Params p) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  FusedSmem<T> sm;
  FusedSmem<T>::carve(smem, p.D, &sm);
  const int D = p.D, LT = ld_t<T>(D), LP = ld_t<T>(BK), LS = ld_f(BK), LO = ld_f(D);
  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int k0 = ik * BK, krows = min(BK, p.Skv - k0);
  const int offset = p.Skv - p.S;
  const int qstride = p.H * D, kstride = p.Hkv * D;
  const size_t kbase = ((size_t)b * p.Skv * p.Hkv + hk) * D;
  const int kv_valid = kv_valid_of(p, b);
  // q rows that see any column of this tile: [r_lo, r_hi)
  int r_lo = 0, r_hi = 0;
  if (k0 < kv_valid) {
    const int kmax = min(k0 + BK, kv_valid) - 1;
    r_lo = p.causal ? max(0, k0 - offset) : 0;
    r_hi = p.S;
    if (p.window > 0) r_hi = min(r_hi, max(0, kmax - offset + p.window));
  }
  const int t_begin = r_lo / BQ, t_end = r_hi > r_lo ? (r_hi + BQ - 1) / BQ : t_begin;

  load_tile(sm.k, LT, static_cast<const T*>(p.k) + kbase, kstride, k0, BK, p.Skv, D);
  load_tile(sm.v, LT, static_cast<const T*>(p.v) + kbase, kstride, k0, BK, p.Skv, D);
  zero_f(sm.dk, BK * LO);
  zero_f(sm.dv, BK * LO);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qbase = ((size_t)b * p.S * p.H + h) * D;
    for (int it = t_begin; it < t_end; ++it) {
      const int q0 = it * BQ, qrows = min(BQ, p.S - q0), qmax = q0 + qrows - 1;
      load_tile(sm.q, LT, static_cast<const T*>(p.q) + qbase, qstride, q0, BQ, p.S, D);
      load_tile(sm.dout, LT, static_cast<const T*>(p.dout) + qbase, qstride, q0, BQ, p.S, D);
      load_rowstats(sm.lse, sm.delta, p, b, h, q0, BQ);
      __syncthreads();
      mm<T, false, true, false>(sm.q, LT, sm.k, LT, sm.s, LS, BQ, BK, D);     // s = q k^T
      mm<T, false, true, false>(sm.dout, LT, sm.v, LT, sm.dp, LS, BQ, BK, D);  // dp = do v^T
      __syncthreads();
      bwd_elements<T, BQ, BK>(p, sm.s, sm.dp, LS, sm.lse, sm.delta, sm.p, sm.ds, LP, q0, k0,
                              straddles(p, k0, BK, q0, qmax, kv_valid, offset), kv_valid,
                              offset);
      __syncthreads();
      mm<T, true, false, true>(sm.p, LP, sm.dout, LT, sm.dv, LO, BK, D, BQ);   // dv += p^T do
      mm<T, true, false, true>(sm.ds, LP, sm.q, LT, sm.dk, LO, BK, D, BQ);     // dk += ds^T q
      mm<T, false, false, false>(sm.ds, LP, sm.k, LT, sm.dq, LO, BQ, D, BK);   // dq_pair = ds k
      __syncthreads();
      float* DQ = p.dq_acc + qbase;
      const int v4 = D / 4;
      for (int i = threadIdx.x; i < qrows * v4; i += NTHREADS) {
        const int r = i / v4, d = (i % v4) * 4;
        const float* src = sm.dq + r * LO + d;
        atomicAdd(reinterpret_cast<float4*>(DQ + (size_t)(q0 + r) * qstride + d),
                  make_float4(src[0], src[1], src[2], src[3]));
      }
    }
  }
  __syncthreads();
  store_tile(static_cast<T*>(p.o) + kbase, kstride, sm.dk, LO, k0, krows, D);
  store_tile(static_cast<T*>(p.o2) + kbase, kstride, sm.dv, LO, k0, krows, D);
}

// ------------------------------------------------------------------------
// launchers
// ------------------------------------------------------------------------
enum Kind { FWD = 0, DQ = 1, DKV = 2, FUSED = 3 };

template <typename T>
cudaError_t launch(Kind kind, const Params& p, cudaStream_t stream) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  size_t bytes;
  const void* fn;
  dim3 grid;
  if (kind == FWD) {
    bytes = FwdSmem<T>::carve(nullptr, p.D, nullptr);
    fn = reinterpret_cast<const void*>(&flash_fwd_kernel<T>);
    grid = dim3((p.S + BQ - 1) / BQ, p.H, p.B);
  } else if (kind == DQ) {
    bytes = DqSmem<T>::carve(nullptr, p.D, nullptr);
    fn = reinterpret_cast<const void*>(&flash_bwd_dq_kernel<T>);
    grid = dim3((p.S + BQ - 1) / BQ, p.H, p.B);
  } else if (kind == DKV) {
    bytes = DkvSmem<T>::carve(nullptr, p.D, nullptr);
    fn = reinterpret_cast<const void*>(&flash_bwd_dkv_kernel<T>);
    grid = dim3((p.Skv + BK - 1) / BK, p.Hkv, p.B);
  } else {
    bytes = FusedSmem<T>::carve(nullptr, p.D, nullptr);
    fn = reinterpret_cast<const void*>(&flash_bwd_fused_kernel<T>);
    grid = dim3((p.Skv + BK - 1) / BK, p.Hkv, p.B);
  }
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<Params*>(&p)};
  err = cudaLaunchKernel(fn, grid, dim3(NTHREADS), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16
cudaError_t dispatch(Kind kind, int dtype, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(kind, p, s);
    case 1: return launch<__nv_bfloat16>(kind, p, s);
    case 2: return launch<__half>(kind, p, s);
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(int B, int S, int Skv, int H, int Hkv, int D, float scale, int causal,
                   int window, const int* lengths) {
  Params p = {};
  p.B = B;
  p.S = S;
  p.Skv = Skv;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.lengths = lengths;
  return p;
}

}  // namespace

// The C interface bound from Python with ctypes. Each returns the
// cudaError_t of its launch (0 = success); none synchronises.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* lengths,
                         void* o, float* lse, int B, int S, int Skv, int H, int Hkv, int D,
                         float scale, int causal, int window, int dtype, void* stream) {
  Params p = make_params(B, S, Skv, H, Hkv, D, scale, causal, window, lengths);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  return (int)dispatch(FWD, dtype, p, stream);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* lengths, void* dq,
                            int B, int S, int Skv, int H, int Hkv, int D, float scale,
                            int causal, int window, int dtype, void* stream) {
  Params p = make_params(B, S, Skv, H, Hkv, D, scale, causal, window, lengths);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.o = dq;
  return (int)dispatch(DQ, dtype, p, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const int* lengths,
                             void* dk, void* dv, int B, int S, int Skv, int H, int Hkv, int D,
                             float scale, int causal, int window, int dtype, void* stream) {
  Params p = make_params(B, S, Skv, H, Hkv, D, scale, causal, window, lengths);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.o = dk;
  p.o2 = dv;
  return (int)dispatch(DKV, dtype, p, stream);
}

extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, const int* lengths,
                               float* dq_acc, void* dk, void* dv, int B, int S, int Skv, int H,
                               int Hkv, int D, float scale, int causal, int window, int dtype,
                               void* stream) {
  Params p = make_params(B, S, Skv, H, Hkv, D, scale, causal, window, lengths);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.dq_acc = dq_acc;
  p.o = dk;
  p.o2 = dv;
  return (int)dispatch(FUSED, dtype, p, stream);
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
