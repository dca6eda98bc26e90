// Flash attention for Hopper (sm_90a): forward, dq backward, dk/dv backward,
// and the single-pass backward.
//
// Replaces the four Pallas TPU kernels of accelerate_tpu/ops/flash_attention.py:
//   flash_fwd_kernel, flash_fwd_wmma_kernel              <- _fwd_kernel (:150)
//       online-softmax forward, O and lse
//   flash_bwd_dq_kernel, flash_bwd_dq_wmma_kernel        <- _bwd_dq_kernel (:269)
//       dq = sum_k ds . k
//   flash_bwd_dkv_kernel, flash_bwd_dkv_wmma_kernel      <- _bwd_dkv_kernel (:325)
//       dk = sum_q ds^T . q, dv = sum_q p^T . do
//   flash_bwd_fused_kernel, flash_bwd_fused_wmma_kernel  <- _bwd_fused_kernel (:422)
//       dq, dk and dv from one pass
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
// Bounds on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), causal,
// at B=2 S=2048 H=32 Hkv=8 D=128 (half the S x S products are visible):
//   forward: 2 products, 4*B*H*S*S*D/2 FLOP = 68.7 GFLOP -> 69 us (operations)
//   dq:      3 products, 103 GFLOP -> 104 us (operations)
//   dk/dv:   4 products, 137 GFLOP -> 139 us (operations)
//   fused:   5 products, 172 GFLOP -> 174 us (operations; dq + dk/dv: 243 us)
// Each moves under 100 MB, so bytes bound none of them (< 30 us): the
// tensor cores' rate is the limit, and only wgmma reaches it.
//
// Two designs, chosen before the launch from the dtype and head_dim alone,
// the same rule for all four kernels (ops/flash_attention.py
// kernel_design() states it too):
//
// wgmma (bf16/fp16, head_dim 64 or 128): flash_fwd_kernel,
// flash_bwd_dq_kernel, flash_bwd_dkv_kernel and flash_bwd_fused_kernel,
// built from hopper.cuh. 256 threads, two warpgroups, one CTA per SM.
// Products are wgmma with fp32 accumulators in registers; the softmax (scale,
// mask on straddling tiles, row max by quad shuffles, exp2, the running sum
// and the rescale of O) and the backward's p and ds run on those registers,
// and p or ds, rounded to 16 bits in registers, is the A operand of the next
// product. Streamed tiles arrive by TMA into two-stage rings: the launcher
// builds a 4-D tensor map {D, heads, seq, batch} per tensor on every call (a
// box is 64 columns, the 128 bytes a 128-byte swizzle takes, so a
// head_dim-128 tile is two boxes; rows past seq are zero-filled inside their
// own batch row) and passes it by value; thread 0 asks for a tile, which
// lands in the swizzle wgmma reads and completes on its stage's mbarrier, so
// the copy of the next tile is in flight while this one is multiplied and no
// thread spends instructions on it.
//   - The q-major CTAs (forward, dq) hold 128 q rows (64 a warpgroup) and
//     stream kv tiles; blockIdx.x runs from the last q tile down, so the
//     longest causal rows start first. The forward streams 128-row K and V
//     tiles. dq streams 64-row K and V tiles (its S, dP and dQ accumulators
//     take 32 + 32 + D / 2 registers a thread): S = Q K^T and dP = dO V^T
//     from shared memory, P and dS formed in registers with lse and delta
//     along the rows, dQ += dS K with K MN-major, left in flight under the
//     next tile's S and dP; dQ stays in registers over the whole sweep and
//     is written once, with no atomics.
//   - The kv-major CTAs (dk/dv and the single pass, one templated body) own
//     a 128-row kv tile of one kv head (64 rows a warpgroup) with dK and dV
//     in registers for the whole sweep over the G query heads of its group
//     and every visible 64-row q tile; they work transposed (kv rows are the
//     accumulator rows): S^T = K Q^T and dP^T = V dO^T from shared memory,
//     P^T and dS^T formed in registers with lse and delta broadcast along
//     the columns, dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//     register A operands (dO and Q MN-major). The single pass also writes
//     dS^T once to shared memory as a 16-bit tile; dQ_pair = dS K is one more
//     wgmma (each warpgroup half of head_dim), added to the fp32 dq buffer by
//     16-byte vector reductions from registers. dk/dv is the same body with
//     that part compiled out, so its dk and dv are the single pass's bit for
//     bit.
// What this design leaves for later: warp specialisation (a producer warp
// and setmaxnreg), pingpong scheduling of the two warpgroups so one's
// softmax overlaps the other's products, a persistent grid, and a TMA
// reduce-add for the single pass's dq.
//
// wmma (float32 and other head dims): flash_fwd_wmma_kernel,
// flash_bwd_dq_wmma_kernel, flash_bwd_dkv_wmma_kernel and
// flash_bwd_fused_wmma_kernel, the first port's FA2-shaped design: one CTA
// of 16 warps per (q tile, head, batch) for the forward and dq, per (kv
// tile, kv head, batch) for dk/dv and the single pass. Tiles are staged in
// shared memory by synchronous loads, products run through nvcuda::wmma
// (bf16/fp16 in, fp32 out) and the fp32 tiles (scores, accumulators) live
// in shared memory. float32 inputs take a scalar fp32 path (no TF32) with
// smaller tiles; it exists for exact comparisons.
//
// Both designs skip tiles wholly above the diagonal, below the window band
// or in the padded kv tail, and apply the element mask only to tiles that
// straddle an edge.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// The softmax chain's max propagates NaN, as jnp.maximum and jnp.max do
// (fmaxf drops it): a row whose every score is NaN must come out NaN, not
// read as fully masked. One instruction, as fmaxf is, and the same result on
// two numbers; compares and selects in its place made B1 two thirds slower on
// an H100 (tools/flash_variants.py's select_nan_max).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
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
__global__ void __launch_bounds__(NTHREADS) flash_fwd_wmma_kernel(Params p) {
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
        mx = max_nan(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = sm.m[r];
      const float m_new = max_nan(m_prev, mx);  // a NaN once in m stays
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
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_wmma_kernel(Params p) {
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
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_wmma_kernel(Params p) {
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
__global__ void __launch_bounds__(NTHREADS) flash_bwd_fused_wmma_kernel(Params p) {
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
// the wgmma design (bf16 / fp16, head_dim 64 or 128)
// ------------------------------------------------------------------------
constexpr int WG_THREADS = 256;  // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;

// the shared tiles of the forward, byte offsets from a 1024-aligned base
template <int D>
struct FwdTiles {
  static constexpr int BQ = 128, BK = 128;
  static constexpr int Q = 0;
  static constexpr int KV = BK * D * 2;  // one K or V stage
  static constexpr int K = BQ * D * 2;   // stage s at K + s * KV
  static constexpr int V = K + 2 * KV;
  static constexpr int BAR = V + 2 * KV;  // mbarriers: Q, K stages 0 and 1, V stages 0 and 1
  static constexpr int BYTES = BAR + 5 * 8;
};

// Fragment coordinates of accumulator register i (see hopper.cuh): the row
// half (0: row, 1: row + 8) and the column within the tile.
__device__ __forceinline__ int frag_half(int i) { return (i / 2) % 2; }
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return max_nan(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_kernel(Params p, const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv) {
  using L = FwdTiles<D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (hk::smem_u32(smem_raw) + 1023) & ~1023u;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int nq = gridDim.x, iq = nq - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hkv = h / (p.H / p.Hkv);
  const int q0 = iq * BQ, qrows = min(BQ, p.S - q0), qmax = q0 + qrows - 1;
  const int offset = p.Skv - p.S;
  const int qstride = p.H * D;
  const int kv_valid = kv_valid_of(p, b);
  int c_lo, c_hi;
  visible_cols(p, q0, qmax, kv_valid, offset, &c_lo, &c_hi);
  const int t_begin = c_lo / BK, t_end = c_hi > c_lo ? (c_hi + BK - 1) / BK : t_begin;
  const int ntiles = t_end - t_begin;

  // Q once, and K and V through separate two-stage rings, by TMA: thread 0
  // asks for a tile and the copy completes on its stage's mbarrier. The
  // k-th fill of a stage is phase k of its barrier, so tile n is waited for
  // with parity (n / 2) & 1. One __syncthreads a tile hands stages back:
  // after the one at the top of tile n, K's stage of tile n (its S was
  // waited for in tile n - 1) and V's stage of tile n - 1 (its P V
  // likewise) are free, and K of tile n + 2 and V of tile n + 1 are asked
  // for; each has a tile's products and softmax to land. Rows past the end
  // are zeros. A CTA with no tile asks for nothing.
  const uint32_t bar_q = base + L::BAR, bar_k = bar_q + 8, bar_v = bar_q + 24;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int i = 0; i < 5; ++i) hk::mbar_init(bar_q + 8 * i, 1);
    hk::mbar_fence_init();
  }
  __syncthreads();
  auto load_k = [&](int n) {
    if (leader && n < ntiles) {
      hk::mbar_expect_tx(bar_k + 8 * (n & 1), BK * D * 2);
      hk::tma_tile<BK, D>(base + L::K + (n & 1) * L::KV, &tk, hkv, (t_begin + n) * BK, b,
                          bar_k + 8 * (n & 1));
    }
  };
  auto load_v = [&](int n) {
    if (leader && n < ntiles) {
      hk::mbar_expect_tx(bar_v + 8 * (n & 1), BK * D * 2);
      hk::tma_tile<BK, D>(base + L::V + (n & 1) * L::KV, &tv, hkv, (t_begin + n) * BK, b,
                          bar_v + 8 * (n & 1));
    }
  };
  auto wait_k = [&](int n) { hk::mbar_wait(bar_k + 8 * (n & 1), (n >> 1) & 1); };
  auto wait_v = [&](int n) { hk::mbar_wait(bar_v + 8 * (n & 1), (n >> 1) & 1); };
  if (leader && ntiles > 0) {
    hk::mbar_expect_tx(bar_q, BQ * D * 2);
    hk::tma_tile<BQ, D>(base + L::Q, &tq, h, q0, b, bar_q);
  }
  load_k(0);
  load_v(0);
  load_k(1);

  // this thread's two rows: q0 + row0 and q0 + row0 + 8
  const int row0 = wg * 64 + warp * 16 + lane / 4;
  hk::Acc<BK> s;
  hk::Acc<D> o;
  o.zero();
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pa[BK / 16][4];  // p of the tile whose P V is next, rounded to T
  // S = Q K^T of tile n into s, this warpgroup's 64 rows (not waited for)
  auto issue_s = [&](int n) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hk::wgmma_ss<T, 0, 0>(s, hk::desc_kmajor<BQ>(base + L::Q, wg * 64, kk),
                            hk::desc_kmajor<BK>(base + L::K + (n & 1) * L::KV, 0, kk), kk > 0);
  };
  // the online softmax of tile n on the registers: s becomes p, m and l
  // move on, corr is the factor for what O holds so far
  auto softmax = [&](int n) {
    const int k0 = (t_begin + n) * BK;
    const bool masked = straddles(p, k0, BK, q0, qmax, kv_valid, offset);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s.d[i] * p.scale;
      if (masked && !keep(p, q0 + row0 + 8 * frag_half(i), k0 + frag_col(i, lane), kv_valid,
                          offset))
        x = NEG_INF;
      s.d[i] = x;
      mx[frag_half(i)] = max_nan(mx[frag_half(i)], x);
    }
    float ml[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = max_nan(m[hh], quad_max(mx[hh]));  // a NaN once in m stays
      corr[hh] = exp2f((m[hh] - m_new) * LOG2E);
      // a row with no visible column yet keeps p = 0, never exp(0) = 1
      ml[hh] = m_new <= NEG_INF * 0.5f ? 0.f : m_new * LOG2E;
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float pv = exp2f(fmaf(s.d[i], LOG2E, -ml[frag_half(i)]));
      sum[frag_half(i)] += pv;
      s.d[i] = pv;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + sum[hh];
  };

  if (ntiles > 0) {  // tile 0's scores and softmax
    hk::mbar_wait(bar_q, 0);
    wait_k(0);
    s.fence();
    hk::wgmma_fence();
    issue_s(0);
    hk::wgmma_commit();
    hk::wgmma_wait<0>();
    s.fence();
    softmax(0);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hk::pack_a<T>(s, kk, pa[kk]);  // tile 0's p
  }
  // O += P V of tile n: p in registers is the A operand, V MN-major
  auto issue_pv = [&](int n) {
    const int stage = n & 1;  // the ring stage that holds tile n
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hk::wgmma_rs<T, 1>(o, pa[kk], hk::desc_mnmajor<BK>(base + L::V + stage * L::KV, 0, kk), 1);
  };
  // Per tile n but the last: S of tile n + 1 and P V of tile n go to the
  // tensor cores together, and the softmax of tile n + 1 runs while P V
  // does.
  for (int n = 0; n + 1 < ntiles; ++n) {
    __syncthreads();  // every thread is done with K's stage of tile n, V's of n - 1
    load_k(n + 2);
    load_v(n + 1);
    wait_k(n + 1);
    wait_v(n);
    s.fence();
    o.fence();
    hk::wgmma_fence();
    issue_s(n + 1);
    hk::wgmma_commit();
    issue_pv(n);
    hk::wgmma_commit();
    hk::wgmma_wait<1>();  // S of tile n + 1 is done; P V may still run
    s.fence();
    softmax(n + 1);
    hk::wgmma_wait<0>();
    o.fence();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o.d[i] *= corr[frag_half(i)];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hk::pack_a<T>(s, kk, pa[kk]);
  }
  if (ntiles > 0) {  // the last tile's P V
    wait_v(ntiles - 1);
    o.fence();
    hk::wgmma_fence();
    issue_pv(ntiles - 1);
    hk::wgmma_commit();
    hk::wgmma_wait<0>();
    o.fence();
  }

  uint16_t* O = static_cast<uint16_t*>(p.o) + ((size_t)b * p.S * p.H + h) * D;
  float* lse = p.lse + ((size_t)b * p.H + h) * p.S;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = quad_sum(l[hh]);
    lt = lt == 0.f ? 1.f : lt;
    const float inv = 1.f / lt;
    const int row = q0 + row0 + 8 * hh;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(O + (size_t)row * qstride + 8 * j + 2 * (lane % 4)) =
          hk::pack2<T>(o.d[4 * j + 2 * hh] * inv, o.d[4 * j + 2 * hh + 1] * inv);
    if (lane % 4 == 0) lse[row] = m[hh] + logf(lt);
  }
}

// the shared tiles of the dq backward, byte offsets from a 1024-aligned
// base: Q and dO once, K and V of a kv tile in each ring stage
template <int D>
struct DqTiles {
  static constexpr int BQ = 128, BK = 64;
  static constexpr int STAGES = 2;
  static constexpr int Q = 0;
  static constexpr int DO = BQ * D * 2;
  static constexpr int KV = BK * D * 2;  // one K or V tile
  static constexpr int STAGE = 2 * KV;   // K, then V
  static constexpr int K = 2 * BQ * D * 2;  // stage s at K + s * STAGE
  static constexpr int BAR = K + STAGES * STAGE;  // mbarriers: Q and dO, then one a stage
  static constexpr int BYTES = BAR + (1 + STAGES) * 8;
};

template <typename T, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dq_kernel(Params p, const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo) {
  using L = DqTiles<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (hk::smem_u32(smem_raw) + 1023) & ~1023u;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int nq = gridDim.x, iq = nq - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hkv = h / (p.H / p.Hkv);
  const int q0 = iq * BQ, qrows = min(BQ, p.S - q0), qmax = q0 + qrows - 1;
  const int offset = p.Skv - p.S;
  const int qstride = p.H * D;
  const int kv_valid = kv_valid_of(p, b);
  int c_lo, c_hi;
  visible_cols(p, q0, qmax, kv_valid, offset, &c_lo, &c_hi);
  const int t_begin = c_lo / BK, t_end = c_hi > c_lo ? (c_hi + BK - 1) / BK : t_begin;
  const int nkv = t_end - t_begin;  // the kv tiles this q tile sees

  // Q and dO once, then K and V of kv tile n into ring stage n % STAGES, by
  // TMA, each completing on its mbarrier (a stage's k-th fill is phase k:
  // tile n waits with parity (n / STAGES) & 1). Tile n's stage is read by
  // S and dP of tile n and by its dS K, which retires in tile n + 1; so the
  // barrier after that retirement hands the stage of tile n - 1 back, and
  // tile n - 1 + STAGES is asked for. Rows past the end are zeros. A CTA
  // with no tile asks for nothing.
  const uint32_t bar_qdo = base + L::BAR, bar_ring = bar_qdo + 8;  // stage s at bar_ring + 8 s
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int i = 0; i < 1 + STAGES; ++i) hk::mbar_init(bar_qdo + 8 * i, 1);
    hk::mbar_fence_init();
  }
  __syncthreads();
  auto load_kv = [&](int n) {
    if (leader && n < nkv) {
      const uint32_t bar = bar_ring + 8 * (n % STAGES), at = base + L::K + (n % STAGES) * L::STAGE;
      hk::mbar_expect_tx(bar, 2 * BK * D * 2);
      hk::tma_tile<BK, D>(at, &tk, hkv, (t_begin + n) * BK, b, bar);
      hk::tma_tile<BK, D>(at + L::KV, &tv, hkv, (t_begin + n) * BK, b, bar);
    }
  };
  if (leader && nkv > 0) {
    hk::mbar_expect_tx(bar_qdo, 2 * BQ * D * 2);
    hk::tma_tile<BQ, D>(base + L::Q, &tq, h, q0, b, bar_qdo);
    hk::tma_tile<BQ, D>(base + L::DO, &tdo, h, q0, b, bar_qdo);
  }
  for (int n = 0; n < STAGES; ++n) load_kv(n);

  // this thread's two rows, q0 + row0 and q0 + row0 + 8: their lse (times
  // log2 e) and delta, once; rows past S get lse = NEG_INF, so p = 0 there
  const int row0 = wg * 64 + warp * 16 + lane / 4;
  float lse2[2], dl[2];
  bool no_col[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + row0 + 8 * hh;
    const size_t at = ((size_t)b * p.H + h) * p.S + row;
    const float lv = row < p.S ? p.lse_in[at] : NEG_INF;
    no_col[hh] = lv <= NEG_INF * 0.5f;
    lse2[hh] = lv * LOG2E;
    dl[hh] = row < p.S ? p.delta[at] : 0.f;
  }
  hk::Acc<BK> s, dp;
  hk::Acc<D> dq;
  dq.zero();
  uint32_t da[BK / 16][4];  // dS of the tile whose dS K is in flight, rounded to T
  if (nkv > 0) hk::mbar_wait(bar_qdo, 0);
  for (int n = 0; n < nkv; ++n) {
    const uint32_t kt = base + L::K + (n % STAGES) * L::STAGE, vt = kt + L::KV;
    hk::mbar_wait(bar_ring + 8 * (n % STAGES), (n / STAGES) & 1);
    // S = Q K^T and dP = dO V^T, this warpgroup's 64 rows
    s.fence();
    dp.fence();
    hk::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hk::wgmma_ss<T, 0, 0>(s, hk::desc_kmajor<BQ>(base + L::Q, wg * 64, kk),
                            hk::desc_kmajor<BK>(kt, 0, kk), kk > 0);
    hk::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hk::wgmma_ss<T, 0, 0>(dp, hk::desc_kmajor<BQ>(base + L::DO, wg * 64, kk),
                            hk::desc_kmajor<BK>(vt, 0, kk), kk > 0);
    hk::wgmma_commit();
    hk::wgmma_wait<1>();  // S is done, and tile n - 1's dS K, issued before it
    s.fence();
    __syncthreads();  // no warpgroup reads tile n - 1's stage any more
    if (n > 0) load_kv(n - 1 + STAGES);

    // P = exp(S scale - lse), lse along the rows
    const int k0 = (t_begin + n) * BK;
    const bool masked = straddles(p, k0, BK, q0, qmax, kv_valid, offset);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s.d[i] * p.scale;
      if (masked && !keep(p, q0 + row0 + 8 * frag_half(i), k0 + frag_col(i, lane), kv_valid,
                          offset))
        x = NEG_INF;
      s.d[i] = no_col[frag_half(i)] ? 0.f : exp2f(fmaf(x, LOG2E, -lse2[frag_half(i)]));
    }
    hk::wgmma_wait<0>();
    dp.fence();
    // dS = P (dP - delta) scale, rounded to K's type: the A operand of dS K
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) dp.d[i] = s.d[i] * (dp.d[i] - dl[frag_half(i)]) * p.scale;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hk::pack_a<T>(dp, kk, da[kk]);
    // dQ += dS K, K MN-major; it runs on under tile n + 1's S and dP
    dq.fence();
    hk::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hk::wgmma_rs<T, 1>(dq, da[kk], hk::desc_mnmajor<BK>(kt, 0, kk), 1);  // dQ += dS K
    hk::wgmma_commit();
  }
  hk::wgmma_wait<0>();
  dq.fence();

  uint16_t* dQ = static_cast<uint16_t*>(p.o) + ((size_t)b * p.S * p.H + h) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + row0 + 8 * hh;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dQ + (size_t)row * qstride + 8 * j + 2 * (lane % 4)) =
          hk::pack2<T>(dq.d[4 * j + 2 * hh], dq.d[4 * j + 2 * hh + 1]);
  }
}

// the shared tiles of the kv-major backward (dk/dv; the single pass with
// kDq), byte offsets from a 1024-aligned base
template <int D, bool kDq>
struct BwdTiles {
  static constexpr int BQ = 64, BK = 128;
  static constexpr int K = 0;
  static constexpr int V = BK * D * 2;
  static constexpr int QS = BQ * D * 2;  // one Q or dO stage
  static constexpr int Q = 2 * BK * D * 2;  // stage s at Q + s * QS
  static constexpr int DO = Q + 2 * QS;
  static constexpr int DS = DO + 2 * QS;  // the single pass's dS^T, BK x BQ, 16-bit
  static constexpr int LSE = DS + (kDq ? BK * BQ * 2 : 0);  // stage s at LSE + s * BQ * 4
  static constexpr int DELTA = LSE + 2 * BQ * 4;
  static constexpr int BAR = DELTA + 2 * BQ * 4;  // mbarriers: K and V, Q/dO stages 0 and 1
  static constexpr int BYTES = BAR + 3 * 8;
};

// The body of flash_bwd_dkv_kernel (kDq false) and flash_bwd_fused_kernel
// (kDq true): dk/dv's products and their order are the same in both, so the
// two kernels' dk and dv agree bit for bit.
template <typename T, int D, bool kDq>
__device__ __forceinline__ void bwd_kv_tile(const Params& p, const CUtensorMap& tq,
                                            const CUtensorMap& tk, const CUtensorMap& tv,
                                            const CUtensorMap& tdo) {
  using L = BwdTiles<D, kDq>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (hk::smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - hk::smem_u32(smem_raw));
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int ik = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;  // kv tile 0, the longest, first
  const int G = p.H / p.Hkv;
  const int k0 = ik * BK;
  const int offset = p.Skv - p.S;
  const int kstride = p.Hkv * D;
  const size_t kbase = ((size_t)b * p.Skv * p.Hkv + hkv) * D;
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
  const int nt = t_end - t_begin, total = G * nt;  // (query head, q tile) pairs, head-major

  // K and V once, then Q and dO of pair n into ring stage n & 1, by TMA:
  // thread 0 asks for the tiles and they complete on an mbarrier (K and V's,
  // or the stage's, whose k-th fill is phase k: pair n waits with parity
  // (n / 2) & 1). lse and delta of pair n come by 4-byte cp.async from
  // threads 0-127: a tensor map's row stride must be a multiple of 16
  // bytes, and S * 4 is not for every S. Rows past S are zeros (lse and
  // delta too): their p multiplies zero dO and their dS is p (0 - 0) scale
  // = 0, so they add nothing, and the single pass does not store their dq.
  // A CTA with no pair asks for nothing.
  const uint32_t bar_kv = base + L::BAR, bar_qd = bar_kv + 8;  // stage s at bar_qd + 8 s
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int i = 0; i < 3; ++i) hk::mbar_init(bar_kv + 8 * i, 1);
    hk::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int n) {
    const int h = hkv * G + n / nt, q0 = (t_begin + n % nt) * BQ, stage = n & 1;
    if (leader) {
      const uint32_t bar = bar_qd + 8 * stage;
      hk::mbar_expect_tx(bar, 2 * BQ * D * 2);
      hk::tma_tile<BQ, D>(base + L::Q + stage * L::QS, &tq, h, q0, b, bar);
      hk::tma_tile<BQ, D>(base + L::DO + stage * L::QS, &tdo, h, q0, b, bar);
    }
    const int r = threadIdx.x % BQ;
    const bool valid = q0 + r < p.S;
    const size_t at = ((size_t)b * p.H + h) * p.S + (valid ? q0 + r : 0);
    if (threadIdx.x < BQ)
      hk::cp_async4(base + L::LSE + stage * BQ * 4 + r * 4, p.lse_in + at, valid);
    else if (threadIdx.x < 2 * BQ)
      hk::cp_async4(base + L::DELTA + stage * BQ * 4 + r * 4, p.delta + at, valid);
  };
  if (total > 0) {
    if (leader) {
      hk::mbar_expect_tx(bar_kv, 2 * BK * D * 2);
      hk::tma_tile<BK, D>(base + L::K, &tk, hkv, k0, b, bar_kv);
      hk::tma_tile<BK, D>(base + L::V, &tv, hkv, k0, b, bar_kv);
    }
    issue(0);
  }
  hk::cp_async_commit();

  // this thread's two kv rows of the tile: krow0 and krow0 + 8
  const int krow0 = wg * 64 + warp * 16 + lane / 4;
  hk::Acc<D> dk, dv;
  dk.zero();
  dv.zero();
  for (int n = 0; n < total; ++n) {
    if (n + 1 < total) {  // pair n + 1 into the other stage, in flight while n is used
      issue(n + 1);
      hk::cp_async_commit();
      hk::cp_async_wait<1>();
    } else {
      hk::cp_async_wait<0>();
    }
    __syncthreads();  // lse and delta of pair n are there for every thread
    if (n == 0) hk::mbar_wait(bar_kv, 0);
    hk::mbar_wait(bar_qd + 8 * (n & 1), (n >> 1) & 1);
    const int q0 = (t_begin + n % nt) * BQ, stage = n & 1;
    const int qmax = min(q0 + BQ, p.S) - 1;
    const uint32_t qt = base + L::Q + stage * L::QS, dot = base + L::DO + stage * L::QS;
    const float* lse_s = reinterpret_cast<const float*>(sbase + L::LSE + stage * BQ * 4);
    const float* delta_s = reinterpret_cast<const float*>(sbase + L::DELTA + stage * BQ * 4);

    // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 64 kv rows
    hk::Acc<BQ> st, dpt;
    st.fence();
    dpt.fence();
    hk::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hk::wgmma_ss<T, 0, 0>(st, hk::desc_kmajor<BK>(base + L::K, wg * 64, kk),
                            hk::desc_kmajor<BQ>(qt, 0, kk), kk > 0);
    hk::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hk::wgmma_ss<T, 0, 0>(dpt, hk::desc_kmajor<BK>(base + L::V, wg * 64, kk),
                            hk::desc_kmajor<BQ>(dot, 0, kk), kk > 0);
    hk::wgmma_commit();
    hk::wgmma_wait<1>();  // S^T is done; dP^T may still run
    st.fence();

    // P^T = exp(S^T scale - lse), lse along the columns (q rows)
    const bool masked = straddles(p, k0, BK, q0, qmax, kv_valid, offset);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = frag_col(i, lane);
      float x = st.d[i] * p.scale;
      if (masked && !keep(p, q0 + c, k0 + krow0 + 8 * frag_half(i), kv_valid, offset))
        x = NEG_INF;
      const float lv = lse_s[c];
      st.d[i] = lv <= NEG_INF * 0.5f ? 0.f : exp2f(fmaf(x, LOG2E, -lv * LOG2E));
    }
    hk::wgmma_wait<0>();
    dpt.fence();
    // dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const float dl = delta_s[frag_col(i, lane)];
      dpt.d[i] = st.d[i] * (dpt.d[i] - dl) * p.scale;
    }

    // dV += P^T dO and dK += dS^T Q: P^T (rounded to dO's type) and dS^T
    // (rounded to K's) are the register A operands; dO and Q MN-major
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hk::pack_a<T>(st, kk, pa[kk]);
      hk::pack_a<T>(dpt, kk, sa[kk]);
    }
    dk.fence();
    dv.fence();
    hk::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hk::wgmma_rs<T, 1>(dv, pa[kk], hk::desc_mnmajor<BQ>(dot, 0, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hk::wgmma_rs<T, 1>(dk, sa[kk], hk::desc_mnmajor<BQ>(qt, 0, kk), 1);
    hk::wgmma_commit();

    if constexpr (kDq) {
      // dS^T to shared memory once, as a 16-bit tile of BK kv rows x BQ q rows
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = krow0 + 8 * (i % 2), c = 16 * kk + 8 * (i / 2) + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(sbase + L::DS + hk::swizzled<BK>(r, c)) = sa[kk][i];
        }
      hk::fence_proxy_async();
      __syncthreads();

      // dq_pair = dS K over the whole kv tile, this warpgroup's half of
      // head_dim: dS (q x kv) and K (kv x d) both MN-major from shared memory
      hk::Acc<D / 2> dq;
      dq.fence();
      hk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hk::wgmma_ss<T, 1, 1>(dq, hk::desc_mnmajor<BK>(base + L::DS, 0, kk),
                              hk::desc_mnmajor<BK>(base + L::K, wg * (D / 2), kk), kk > 0);
      hk::wgmma_commit();
      hk::wgmma_wait<0>();  // dV and dK are done too
      dq.fence();
      dk.fence();
      dv.fence();

      // add dq_pair to the fp32 buffer, 4 consecutive floats a reduction:
      // lanes 2i and 2i + 1 swap halves so that the even lane holds 4 columns
      // of row r and the odd lane 4 columns of row r + 8
      const int h = hkv * G + n / nt, qstride = p.H * D;
      float* DQ = p.dq_acc + ((size_t)b * p.S * p.H + h) * D + wg * (D / 2);
      const bool odd = lane & 1;
      const int qrow = q0 + warp * 16 + lane / 4 + (odd ? 8 : 0);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float s0 = odd ? dq.d[4 * j] : dq.d[4 * j + 2];
        const float s1 = odd ? dq.d[4 * j + 1] : dq.d[4 * j + 3];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float4 v = odd ? make_float4(r0, r1, dq.d[4 * j + 2], dq.d[4 * j + 3])
                             : make_float4(dq.d[4 * j], dq.d[4 * j + 1], r0, r1);
        const int col = 8 * j + 2 * (lane % 4) - (odd ? 2 : 0);
        if (qrow < p.S)
          atomicAdd(reinterpret_cast<float4*>(DQ + (size_t)qrow * qstride + col), v);
      }
    } else {
      hk::wgmma_wait<0>();  // dV and dK are done
      dk.fence();
      dv.fence();
    }
    __syncthreads();  // stage n (and the single pass's dS^T tile) is free again
  }

  uint16_t* dK = static_cast<uint16_t*>(p.o) + kbase;
  uint16_t* dV = static_cast<uint16_t*>(p.o2) + kbase;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k0 + krow0 + 8 * hh;
    if (row >= p.Skv) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (size_t)row * kstride + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(dK + at) =
          hk::pack2<T>(dk.d[4 * j + 2 * hh], dk.d[4 * j + 2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dV + at) =
          hk::pack2<T>(dv.d[4 * j + 2 * hh], dv.d[4 * j + 2 * hh + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dkv_kernel(Params p, const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo) {
  bwd_kv_tile<T, D, false>(p, tq, tk, tv, tdo);
}

template <typename T, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_fused_kernel(Params p, const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo) {
  bwd_kv_tile<T, D, true>(p, tq, tk, tv, tdo);
}

// ------------------------------------------------------------------------
// launchers
// ------------------------------------------------------------------------
enum Kind { FWD = 0, DQ = 1, DKV = 2, FUSED = 3 };

// args points at the kernel's parameters, in order
cudaError_t launch_args(const void* fn, dim3 grid, int threads, size_t bytes, void** args,
                        cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(fn, grid, dim3(threads), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_fn(const void* fn, dim3 grid, int threads, size_t bytes, const Params& p,
                      cudaStream_t stream) {
  void* args[] = {const_cast<Params*>(&p)};
  return launch_args(fn, grid, threads, bytes, args, stream);
}

// Whether a launch takes the wgmma design: bf16/fp16 (dtype codes 1, 2) at
// head_dim 64 or 128, for every kind. kernel_design() in
// ops/flash_attention.py states the same rule; chip_smoke.py checks through
// flash_design below that the two agree.
bool wgmma_design(int dtype, int D) {
  return (dtype == 1 || dtype == 2) && (D == 64 || D == 128);
}

// the wgmma design: the tensor maps (boxes of each kernel's q and kv tile
// rows) are built on every call and passed by value (__grid_constant__);
// 1024 bytes of slack align the tiles' base
template <typename T, int D>
cudaError_t launch_wgmma(Kind kind, const Params& p, cudaStream_t stream) {
  int q_rows, kv_rows, bytes;
  const void* fn;
  if (kind == FWD) {
    q_rows = FwdTiles<D>::BQ, kv_rows = FwdTiles<D>::BK, bytes = FwdTiles<D>::BYTES;
    fn = reinterpret_cast<const void*>(&flash_fwd_kernel<T, D>);
  } else if (kind == DQ) {
    q_rows = DqTiles<D>::BQ, kv_rows = DqTiles<D>::BK, bytes = DqTiles<D>::BYTES;
    fn = reinterpret_cast<const void*>(&flash_bwd_dq_kernel<T, D>);
  } else if (kind == DKV) {
    q_rows = BwdTiles<D, false>::BQ, kv_rows = BwdTiles<D, false>::BK;
    bytes = BwdTiles<D, false>::BYTES;
    fn = reinterpret_cast<const void*>(&flash_bwd_dkv_kernel<T, D>);
  } else {
    q_rows = BwdTiles<D, true>::BQ, kv_rows = BwdTiles<D, true>::BK;
    bytes = BwdTiles<D, true>::BYTES;
    fn = reinterpret_cast<const void*>(&flash_bwd_fused_kernel<T, D>);
  }
  // q-major CTAs (forward, dq): one a q tile of a query head; kv-major
  // (dk/dv, single pass): one a kv tile of a kv head
  const dim3 grid = kind == FWD || kind == DQ
                        ? dim3((p.S + q_rows - 1) / q_rows, p.H, p.B)
                        : dim3((p.Skv + kv_rows - 1) / kv_rows, p.Hkv, p.B);
  Params args_p = p;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = hk::tmap_bshd(&tq, p.q, p.B, p.S, p.H, D, q_rows)) != cudaSuccess ||
      (err = hk::tmap_bshd(&tk, p.k, p.B, p.Skv, p.Hkv, D, kv_rows)) != cudaSuccess ||
      (err = hk::tmap_bshd(&tv, p.v, p.B, p.Skv, p.Hkv, D, kv_rows)) != cudaSuccess)
    return err;
  if (kind == FWD) {
    void* args[] = {&args_p, &tq, &tk, &tv};
    return launch_args(fn, grid, WG_THREADS, bytes + 1024, args, stream);
  }
  if ((err = hk::tmap_bshd(&tdo, p.dout, p.B, p.S, p.H, D, q_rows)) != cudaSuccess) return err;
  void* args[] = {&args_p, &tq, &tk, &tv, &tdo};
  return launch_args(fn, grid, WG_THREADS, bytes + 1024, args, stream);
}

template <typename T>
cudaError_t launch_wgmma_d(Kind kind, const Params& p, cudaStream_t stream) {
  return p.D == 128 ? launch_wgmma<T, 128>(kind, p, stream) : launch_wgmma<T, 64>(kind, p, stream);
}

// the wmma design
template <typename T>
cudaError_t launch(Kind kind, const Params& p, cudaStream_t stream) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  if (kind == FWD)
    return launch_fn(reinterpret_cast<const void*>(&flash_fwd_wmma_kernel<T>),
                     dim3((p.S + BQ - 1) / BQ, p.H, p.B), NTHREADS,
                     FwdSmem<T>::carve(nullptr, p.D, nullptr), p, stream);
  if (kind == DQ)
    return launch_fn(reinterpret_cast<const void*>(&flash_bwd_dq_wmma_kernel<T>),
                     dim3((p.S + BQ - 1) / BQ, p.H, p.B), NTHREADS,
                     DqSmem<T>::carve(nullptr, p.D, nullptr), p, stream);
  if (kind == DKV)
    return launch_fn(reinterpret_cast<const void*>(&flash_bwd_dkv_wmma_kernel<T>),
                     dim3((p.Skv + BK - 1) / BK, p.Hkv, p.B), NTHREADS,
                     DkvSmem<T>::carve(nullptr, p.D, nullptr), p, stream);
  return launch_fn(reinterpret_cast<const void*>(&flash_bwd_fused_wmma_kernel<T>),
                   dim3((p.Skv + BK - 1) / BK, p.Hkv, p.B), NTHREADS,
                   FusedSmem<T>::carve(nullptr, p.D, nullptr), p, stream);
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16
cudaError_t dispatch(Kind kind, int dtype, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma_design(dtype, p.D))
    return dtype == 1 ? launch_wgmma_d<__nv_bfloat16>(kind, p, s)
                      : launch_wgmma_d<__half>(kind, p, s);
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

// 1 when a launch of this kind (0 flash_fwd, 1 flash_bwd_dq, 2
// flash_bwd_dkv, 3 flash_bwd_fused) takes the wgmma design for this dtype
// code and head_dim, 0 when it takes the wmma design, -1 for no such kind
extern "C" int flash_design(int kind, int dtype, int D) {
  if (kind < FWD || kind > FUSED) return -1;
  return wgmma_design(dtype, D) ? 1 : 0;
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
