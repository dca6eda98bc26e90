// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// TMA copies into 128-byte-swizzled shared tiles (4-D and 2-D tensor maps on
// the host, the copy and its mbarriers on the device), 4-byte cp.async,
// ldmatrix, the shared-memory matrix descriptor that wgmma reads those tiles
// through, and the wgmma instructions themselves (A from shared memory or
// from registers, fp32 accumulators in registers).
//
// Tile layout. A tile of R rows by C 16-bit columns (C a multiple of 64) is
// stored as C / 64 panels of R rows x 128 bytes, panel after panel; the
// 16-byte chunk c of row r of a panel sits at r * 128 + ((c ^ (r % 8)) * 16).
// That is the 128-byte swizzle that wgmma's SW128 layout reads (and that a
// TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes): the XOR acts on address
// bits [4, 7) with bits [7, 10), so each panel starts at a multiple of
// 1024 bytes. One panel row holds 64 elements, so
//   - as a K-major operand (the reduction dimension along the row) an 8-row
//     group is 1024 bytes (SBO = 64 units of 16 bytes) and a k16 step moves
//     the start address by 32 bytes inside the row;
//   - as an MN-major operand (the reduction dimension down the rows) a k16
//     step moves the start by 16 rows (2048 bytes), an 8-row group is again
//     1024 bytes (SBO) and the next 64 columns are the next panel (LBO = the
//     panel's size).
//
// Accumulator fragment of m64nN, per thread of the 128-thread warpgroup
// (warp w, lane l): register 4j + 2h + e holds row 16w + l/4 + 8h, column
// 8j + 2(l%4) + e. For 16-bit inputs the k16 A fragment from registers has
// the same shape, so an accumulator rounded to 16 bits is the A operand of
// the next product without a trip through shared memory (pack_a).

#pragma once

#include <cuda.h>  // the tensor map's types only: the build links the runtime alone
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hk {

// ---------------------------------------------------------------------- //
// host: tensor maps for TMA
// ---------------------------------------------------------------------- //
// cuTensorMapEncodeTiled lives in libcuda, not in the runtime; it is reached
// through the runtime's entry-point query, so the library links only the
// runtime.
using TmapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline cudaError_t tmap_encoder(TmapEncode* out) {
  static TmapEncode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<TmapEncode>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// 16-bit elements, boxes 64 columns wide (128 bytes, the widest a 128-byte
// swizzle takes); dims and box innermost first, strides in bytes of dims 1..
inline cudaError_t tmap_16bit(CUtensorMap* map, const void* ptr, int rank,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box) {
  TmapEncode encode;
  const cudaError_t err = tmap_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT16, rank, const_cast<void*>(ptr),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous (batch, seq, heads, D) tensor of 16-bit elements as a 4-D
// tensor map {D, heads, seq, batch} whose box is 64 columns of `rows` rows
// of one head of one batch row. A box that runs past seq is zero-filled
// inside its own batch row.
inline cudaError_t tmap_bshd(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
                             int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)seq * heads * D * 2};  // bytes, dims 1-3
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return tmap_16bit(map, ptr, 4, dims, strides, box);
}

// A contiguous (rows, cols) matrix of 16-bit elements as a 2-D tensor map
// {cols, rows} whose box is 64 columns x box_rows rows (box_rows <= 256).
// Rows past the end land as zeros.
inline cudaError_t tmap_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
                           int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return tmap_16bit(map, ptr, 2, dims, strides, box);
}

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;  // else __half

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------- //
// small asynchronous copies (cp.async): per thread, tracked in groups
// ---------------------------------------------------------------------- //
// 4 bytes, zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's generic-proxy shared-memory writes (plain stores)
// visible to the async proxy that wgmma reads through. Issue it before the
// barrier that hands the tile to the other threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of element (r, c) of a swizzled tile of R rows
template <int R>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c / 64) * (R * 128) + r * 128 + ((((c % 64) / 8) ^ (r % 8)) << 4) + (c % 8) * 2;
}

// Four 8x8 matrices of 16-bit elements from shared memory, one row address
// a thread (lane l gives row l % 8 of matrix l / 8); register i of lane l
// holds row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---------------------------------------------------------------------- //
// mbarriers and TMA: one thread asks for a whole tile; the copy engine
// writes it in the 128-byte swizzle and reports its bytes to an mbarrier
// ---------------------------------------------------------------------- //
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// make the initialised barriers visible to the copy engine and the other
// threads (a __syncthreads follows)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive once and expect `bytes` more of copies before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// arrive once (a consumer handing a stage back)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase with this parity has completed (the barrier's phase
// differs from `parity`). A copy that never lands would hang the card: after
// about 10 s on the SM clock the kernel traps, and the launch reports an
// error instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) t0 = now;
    if (now - t0 > 20000000000LL) __trap();
  }
}
// the 4-D box at (c0, c1, c2, c3) of a tensor map into shared memory at dst
// (1024-byte aligned under the 128-byte swizzle), completing on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// `bytes` (a multiple of 16) from 16-byte-aligned global memory into shared
// memory at dst (16-byte aligned) by the copy engine, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// the 2-D box at (c0, c1) of a tensor map, as tma_load_4d
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// R rows from row row0 of head `head`, batch `batch` of a (batch, seq,
// heads, D) tensor map whose box is 64 columns x R rows: D / 64 boxes into
// the panels of a swizzled tile at dst. Rows past the sequence's end land
// as zeros. Issued by one thread; the tile's R * D * 2 bytes complete on bar.
template <int R, int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const void* map, int head, int row0,
                                         int batch, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < D; c += 64)
    tma_load_4d(dst + (c / 64) * (R * 128), map, c, head, row0, batch, bar);
}

// ---------------------------------------------------------------------- //
// wgmma
// ---------------------------------------------------------------------- //
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 (SW128) in bits
// [62, 64). Base offset 0: every panel starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}
// K-major operand (rows x k, k along the row), the k16 step kk, rows of a
// tile of R rows, starting at row row0 (a multiple of 8)
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int row0, int kk) {
  return desc_sw128(tile + (kk / 4) * (R * 128) + row0 * 128 + (kk % 4) * 32, 16, 1024);
}
// MN-major operand (k down the rows, MN along the row) of a tile of R rows:
// the k16 step kk, starting at column col0 (a multiple of 8 within a panel)
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int col0, int kk) {
  return desc_sw128(tile + (col0 / 64) * (R * 128) + (col0 % 64) * 2 + kk * 16 * 128, R * 128,
                    1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the fp32 accumulator of one m64nN product: N / 2 registers a thread
template <int N>
struct Acc {
  float d[N / 2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  }
  // keep the compiler from moving reads or writes of the registers across
  // an asynchronous wgmma that owns them; placed before wgmma_fence and
  // after the wgmma_wait that retires the product, never while it runs
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  uint32_t r;
  if constexpr (kBf16<T>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(a, b);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}
// the k16 A fragment of columns [16 kk, 16 kk + 16) of an accumulator,
// rounded to T
template <typename T, int N>
__device__ __forceinline__ void pack_a(const Acc<N>& acc, int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack2<T>(acc.d[8 * kk + 2 * i], acc.d[8 * kk + 2 * i + 1]);
}

#define HK_ACC8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define HK_ACC_64 \
  HK_ACC8(0), HK_ACC8(8), HK_ACC8(16), HK_ACC8(24), HK_ACC8(32), HK_ACC8(40), HK_ACC8(48), HK_ACC8(56)
#define HK_ACC_32 HK_ACC8(0), HK_ACC8(8), HK_ACC8(16), HK_ACC8(24)
#define HK_ACC_16 HK_ACC8(0), HK_ACC8(8)

#define HK_ACC_128                                                                 \
  HK_ACC_64, HK_ACC8(64), HK_ACC8(72), HK_ACC8(80), HK_ACC8(88), HK_ACC8(96), \
      HK_ACC8(104), HK_ACC8(112), HK_ACC8(120)
#define HK_REGS_128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127}"
#define HK_REGS_64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HK_REGS_32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HK_REGS_16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// A and B from shared memory; TA / TB = 1: that operand is MN-major
#define HK_SS_BODY(N, TY, REGS, ACC, IA, IB, IS, ITA, ITB)                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                               \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " REGS ", %" IA \
               ", %" IB ", p, 1, 1, %" ITA ", %" ITB ";\n}\n"                                 \
               : ACC                                                                          \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
// A from registers (the k16 fragment), B from shared memory
#define HK_RS_BODY(N, TY, REGS, ACC, IA, IB, IS, ITB)                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " REGS ", {%" IA \
               "}, %" IB ", p, 1, 1, %" ITB ";\n}\n"                                           \
               : ACC                                                                           \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB))

// acc (+)= A . B, both from shared memory; scale_d = 0 overwrites acc
template <typename T, int TA, int TB, int N>
__device__ __forceinline__ void wgmma_ss(Acc<N>& acc, uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 128 || N == 64 || N == 32, "m64n128, m64n64 or m64n32");
  float* d = acc.d;
  if constexpr (N == 128) {
    if constexpr (kBf16<T>)
      HK_SS_BODY("128", "bf16", HK_REGS_64, HK_ACC_64, "64", "65", "66", "67", "68");
    else
      HK_SS_BODY("128", "f16", HK_REGS_64, HK_ACC_64, "64", "65", "66", "67", "68");
  } else if constexpr (N == 64) {
    if constexpr (kBf16<T>)
      HK_SS_BODY("64", "bf16", HK_REGS_32, HK_ACC_32, "32", "33", "34", "35", "36");
    else
      HK_SS_BODY("64", "f16", HK_REGS_32, HK_ACC_32, "32", "33", "34", "35", "36");
  } else {
    if constexpr (kBf16<T>)
      HK_SS_BODY("32", "bf16", HK_REGS_16, HK_ACC_16, "16", "17", "18", "19", "20");
    else
      HK_SS_BODY("32", "f16", HK_REGS_16, HK_ACC_16, "16", "17", "18", "19", "20");
  }
}

// acc (+)= A . B, A the k16 fragment in registers, B from shared memory
template <typename T, int TB, int N>
__device__ __forceinline__ void wgmma_rs(Acc<N>& acc, const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 256 || N == 128 || N == 64, "m64n256, m64n128 or m64n64");
  float* d = acc.d;
  if constexpr (N == 256) {
    if constexpr (kBf16<T>)
      HK_RS_BODY("256", "bf16", HK_REGS_128, HK_ACC_128, "128, %129, %130, %131", "132", "133",
                 "134");
    else
      HK_RS_BODY("256", "f16", HK_REGS_128, HK_ACC_128, "128, %129, %130, %131", "132", "133",
                 "134");
  } else if constexpr (N == 128) {
    if constexpr (kBf16<T>)
      HK_RS_BODY("128", "bf16", HK_REGS_64, HK_ACC_64, "64, %65, %66, %67", "68", "69", "70");
    else
      HK_RS_BODY("128", "f16", HK_REGS_64, HK_ACC_64, "64, %65, %66, %67", "68", "69", "70");
  } else {
    if constexpr (kBf16<T>)
      HK_RS_BODY("64", "bf16", HK_REGS_32, HK_ACC_32, "32, %33, %34, %35", "36", "37", "38");
    else
      HK_RS_BODY("64", "f16", HK_REGS_32, HK_ACC_32, "32, %33, %34, %35", "36", "37", "38");
  }
}

}  // namespace hk
