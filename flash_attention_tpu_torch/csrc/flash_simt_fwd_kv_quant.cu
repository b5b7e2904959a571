// K4 in the SIMT family (fa_flash_fwd_kv_quant_simt): the forward of
// flash_d256.cuh, where the design notes are, over an int8 or fp8 K/V
// payload for fp32 q at padded head dims 256, 512 and 1024 (bf16 and fp16 q
// take fa_flash_fwd_kv_quant's wgmma kernels there).

#include "flash_d256.cuh"
#include "flash_fwd.cuh"

// Arguments as for fa_flash_fwd_kv_quant (flash_fwd_kv_quant.cu); fp32 q
// (dtype 0) at head_dim 256, 512 or 1024.  Returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for bf16 / fp16 q).
extern "C" int fa_flash_fwd_kv_quant_simt(const void* q, const void* k, const void* k_scale, const void* v,
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
  if (kv_dtype == 1) return (int)fa::simt::launch_fwd_for<int8_t>(dtype, head_dim, p, s);
  if (kv_dtype == 2) return (int)fa::simt::launch_fwd_for<__nv_fp8_e4m3>(dtype, head_dim, p, s);
  return (int)cudaErrorInvalidValue;
}
