// K4: flash attention over a quantized KV cache (fa_flash_fwd_kv_quant).
// Replaces flash_attention_tpu/quant/kv.py::_fwd_quant_kernel.  It is K1's
// kernel instantiated with a 1-byte K/V payload, int8 or fp8 e4m3, and one
// fp32 scale per token: each K/V tile is dequantized into shared memory in
// q's dtype, then the forward runs as K1's does, without lse.  bf16 / fp16
// q: flash_fwd.cuh (where the design notes are); fp32 q: the 3xTF32
// kernels of flash_fwd_fp32.cu (64, 128) and flash_fwd_fp32_wide.cuh (256,
// 512, 1024).  Bound: at D = 64 the payload halves
// K1's K/V bytes, so K4 is as compute-bound as K1.

#include "flash_fwd.cuh"

// dtype: q's, 0 = float32, 1 = bfloat16, 2 = float16.  kv_dtype: 1 = int8,
// 2 = float8_e4m3fn.  head_dim: 64, 128, 256, 512 or 1024.  strides
// (elements): q, k, v, o as (batch, head, row), then the scales' (batch,
// head); the last dims of every tensor, the scales' included, are
// contiguous.  q_ids / kv_ids as
// for fa_flash_fwd.  Returns a cudaError_t (0 on success).
extern "C" int fa_flash_fwd_kv_quant(const void* q, const void* k, const void* k_scale, const void* v,
                                     const void* v_scale, void* o, const void* q_ids, const void* kv_ids,
                                     int dtype, int kv_dtype, int batch, int hq, int hkv, int lq, int lk,
                                     int head_dim, const long long* strides, float scale_log2, int causal,
                                     int window, void* stream) {
  fa::FwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.o = o;
  p.q_ids = static_cast<const int*>(q_ids);
  p.kv_ids = static_cast<const int*>(kv_ids);
  if (k_scale == nullptr || v_scale == nullptr ||
      !fa::fill_fwd_params(p, batch, hq, hkv, lq, lk, strides, scale_log2, causal, window))
    return (int)cudaErrorInvalidValue;
  p.s_sb = strides[12];
  p.s_sh = strides[13];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 1) return (int)fa::launch_fwd_for<int8_t>(dtype, head_dim, p, s);
  if (kv_dtype == 2) return (int)fa::launch_fwd_for<__nv_fp8_e4m3>(dtype, head_dim, p, s);
  return (int)cudaErrorInvalidValue;
}
