// Hopper (sm_90a) building blocks of the warp-specialised kernels: mbarriers,
// TMA tile loads and the tensor maps they read, wgmma with its shared-memory
// descriptors and fences, register rebalancing between warpgroups, named
// barriers and the generic-to-async proxy fence (PTX ISA 8.x; the layouts
// are those of cuda_guide's TMA and wgmma sections).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the driver at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fa {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A wait longer
// than about a second (2^31 cycles) can only be a fault in the pipeline's
// bookkeeping: it traps, which the caller sees as a launch error, instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) start = now;
    if (now - start > (1ll << 31)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// The box of a 4-D tensor map at element coordinates (c0 innermost) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// warpgroups
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// Thread block clusters: the block's rank, a barrier over every thread of
// the cluster (shared-memory writes before it are seen by reads after it,
// in any block of the cluster), and reads of another block's shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in block `rank`'s shared memory of what `p` points to in this
// block's.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a shared-memory operand stored in 128-byte swizzled rows
// (the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start address,
// leading and stride byte offsets, swizzle mode 1 (128 B).  K-major: `sbo`
// steps 8 rows, `lbo` is unused.  MN-major: `sbo` steps 8 rows along K and
// `lbo` steps one 64-element (128-byte) column block along MN.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in place between two asm statements: keeps the compiler
// from moving reads or writes of accumulators across the asynchronous wgmma
// (its asm names them, the wait does not), and from computing operands
// (P fragments, descriptors) or rescaling accumulators between wgmma.fence
// and the commit, which makes ptxas serialise every wgmma of the kernel.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]));
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j]));
}
template <int N>
__device__ __forceinline__ void fence_regs(uint64_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+l"(d[i]));
}

#define FA_D8(d, i)                                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define FA_D16(d) FA_D8(d, 0), FA_D8(d, 8)
#define FA_D32(d) FA_D16(d), FA_D8(d, 16), FA_D8(d, 24)
#define FA_D64(d) FA_D32(d), FA_D8(d, 32), FA_D8(d, 40), FA_D8(d, 48), FA_D8(d, 56)
#define FA_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define FA_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define FA_R32                                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_R64                                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B with A and B in shared memory, B K-major, A K-major (TA "0")
// or M-major (TA "1", the transposed layout); d is added to when
// `accumulate` is non-zero, else overwritten.
#define FA_WGMMA_SS(SHAPE, TY, REGS, A, B, S, TA, DOPS)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" S ", 0;\nwgmma.mma_async.sync.aligned." SHAPE ".f32." \
               TY "." TY " " REGS ", %" A ", %" B ", p, 1, 1, " TA ", 0;\n}\n"                            \
               : DOPS                                                                                     \
               : "l"(da), "l"(db), "r"(accumulate))

// d += A B with A in registers (four 32-bit registers of two T values per
// k16 step, the accumulator's fragment layout) and B in shared memory,
// MN-major (transposed).
#define FA_WGMMA_RS(SHAPE, TY, REGS, A, B, S, DOPS)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" S ", 0;\nwgmma.mma_async.sync.aligned." SHAPE ".f32." \
               TY "." TY " " REGS ", " A ", %" B ", p, 1, 1, 1;\n}\n"                                       \
               : DOPS                                                                                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// An m64 x N x k16 product, SS form; T is __nv_bfloat16 or __half, N 16,
// 32, 64 or 128 (d holds N / 2 floats a thread).  kTransA: A is stored
// M-major (its 64 rows contiguous in 128-byte lines, one line a k value),
// as a K or dO tile read as its transpose.
#define FA_WGMMA_SS_N(TA)                                                                                  \
  if constexpr (N == 16) {                                                                                \
    if constexpr (kBf16) FA_WGMMA_SS("m64n16k16", "bf16", FA_R8, "8", "9", "10", TA, FA_D8(d, 0));        \
    else FA_WGMMA_SS("m64n16k16", "f16", FA_R8, "8", "9", "10", TA, FA_D8(d, 0));                        \
  } else if constexpr (N == 32) {                                                                         \
    if constexpr (kBf16) FA_WGMMA_SS("m64n32k16", "bf16", FA_R16, "16", "17", "18", TA, FA_D16(d));       \
    else FA_WGMMA_SS("m64n32k16", "f16", FA_R16, "16", "17", "18", TA, FA_D16(d));                       \
  } else if constexpr (N == 64) {                                                                         \
    if constexpr (kBf16) FA_WGMMA_SS("m64n64k16", "bf16", FA_R32, "32", "33", "34", TA, FA_D32(d));       \
    else FA_WGMMA_SS("m64n64k16", "f16", FA_R32, "32", "33", "34", TA, FA_D32(d));                       \
  } else {                                                                                                \
    if constexpr (kBf16) FA_WGMMA_SS("m64n128k16", "bf16", FA_R64, "64", "65", "66", TA, FA_D64(d));      \
    else FA_WGMMA_SS("m64n128k16", "f16", FA_R64, "64", "65", "66", TA, FA_D64(d));                      \
  }

template <typename T, int N, bool kTransA = false>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_ss is instantiated for N 16, 32, 64 and 128");
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (kTransA) {
    FA_WGMMA_SS_N("1")
  } else {
    FA_WGMMA_SS_N("0")
  }
}

// An m64 x N x k16 product, RS form, accumulating into d.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs is instantiated for N 64 and 128");
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 64) {
    if constexpr (kBf16) FA_WGMMA_RS("m64n64k16", "bf16", FA_R32, "{%32, %33, %34, %35}", "36", "37", FA_D32(d));
    else FA_WGMMA_RS("m64n64k16", "f16", FA_R32, "{%32, %33, %34, %35}", "36", "37", FA_D32(d));
  } else {
    if constexpr (kBf16) FA_WGMMA_RS("m64n128k16", "bf16", FA_R64, "{%64, %65, %66, %67}", "68", "69", FA_D64(d));
    else FA_WGMMA_RS("m64n128k16", "f16", FA_R64, "{%64, %65, %66, %67}", "68", "69", FA_D64(d));
  }
}

#undef FA_WGMMA_RS
#undef FA_WGMMA_SS_N
#undef FA_WGMMA_SS
#undef FA_R64
#undef FA_R32
#undef FA_R16
#undef FA_R8
#undef FA_D64
#undef FA_D32
#undef FA_D16
#undef FA_D8

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, so that the library needs no
// -lcuda; null when the driver does not have it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// A map of the 4-D tensor [batch, heads, rows, dim] (dim contiguous; the
// other strides in elements) whose box is [box_rows, box_cols] of one
// (batch, head).  Coordinates past `rows` or `dim` read as zero, never as
// the next head's rows.  TMA wants a 16-byte aligned base and strides that
// are multiples of 16 bytes; the stride of an extent-1 dimension is never
// used, and is replaced by one that meets the rule.
inline bool make_map_4d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base, int dim,
                        int rows, int heads, int batch, long long s_row, long long s_head, long long s_batch,
                        int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t extent[4] = {(cuuint64_t)dim, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)batch};
  const long long given[3] = {s_row, s_head, s_batch};
  const long long any = (((long long)dim * elem_bytes + 15) / 16) * 16;
  cuuint64_t stride[3];
  for (int i = 0; i < 3; ++i) stride[i] = extent[i + 1] > 1 ? (cuuint64_t)(given[i] * elem_bytes) : (cuuint64_t)any;
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), extent, stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace fa
