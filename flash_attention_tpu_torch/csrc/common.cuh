// Helpers shared by the port's kernels (flash_fwd*.cu, flash_bwd.cu,
// decode.cu): conversions to and from float, bf16/fp16 packing, exp2 and
// the attention mask of the JAX package (_mask_for_block and _seg_mask in
// flash_attention_tpu/kernels/flash_attention.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace fa {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Element types of the kernels: float, bf16, fp16, and the 1-byte payloads
// of a quantized KV cache (int8, fp8 e4m3).  Every value of a payload type
// is exact in float, bf16 and fp16.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// float -> T, rounded to nearest even.
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

// exp2 on the special-function unit, subnormal results flushed to zero
// (P values below 2^-126, which no sum of them can see).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to T and read back as float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T> struct Pack;
template <> struct Pack<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};
template <> struct Pack<__half> {
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// The attention mask shared by every kernel: query `row` (of lq) may see
// key `col` (of lk).  Causal masks align the queries to the end of the
// keys; `window` > 0 keeps the last `window` positions (self included);
// segment ids, when given, must match.
struct Mask {
  int lq, lk, causal, window;
  __device__ __forceinline__ bool visible(int row, int col) const {
    if (row >= lq || col >= lk) return false;
    if (!causal) return true;
    const int pos = row + (lk - lq);
    return col <= pos && (window <= 0 || col >= pos - (window - 1));
  }
  // True when every (row, col) of the tile [r0, r0 + nr) x [c0, c0 + nc)
  // passes visible(), so the tile needs no element mask.
  __device__ __forceinline__ bool tile_visible(int r0, int nr, int c0, int nc) const {
    if (r0 + nr > lq || c0 + nc > lk) return false;
    if (!causal) return true;
    const int offset = lk - lq;
    if (c0 + nc - 1 > r0 + offset) return false;
    return window <= 0 || c0 >= r0 + nr - 1 + offset - (window - 1);
  }
  // KV tiles [first, end) of width bc that the query rows [r0, r1) reach.
  __device__ __forceinline__ int kv_end(int r1) const {
    if (!causal) return lk;
    const int end = r1 + (lk - lq);
    return end < lk ? end : lk;
  }
  __device__ __forceinline__ int kv_first(int r0) const {
    if (!causal || window <= 0) return 0;
    const int first = r0 + (lk - lq) - (window - 1);
    return first > 0 ? first : 0;
  }
  // Query rows [q_first, q_end) that reach the keys [c0, c1).
  __device__ __forceinline__ int q_first(int c0) const {
    if (!causal) return 0;
    const int first = c0 - (lk - lq);
    return first > 0 ? first : 0;
  }
  __device__ __forceinline__ int q_end(int c1) const {
    if (!causal || window <= 0) return lq;
    const int end = c1 - 1 - (lk - lq) + (window - 1) + 1;
    return end < lq ? end : lq;
  }
};

}  // namespace fa
