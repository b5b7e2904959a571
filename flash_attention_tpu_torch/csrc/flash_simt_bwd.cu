// K2 and K3 in the SIMT family (fa_flash_bwd_dkv_simt, fa_flash_bwd_dq_simt):
// the backward of flash_d256.cuh, where the design notes are, for fp32 at
// padded head dims 256, 512 and 1024 (bf16 and fp16 take fa_flash_bwd_dkv's
// and fa_flash_bwd_dq's wgmma kernels at every head dim).  They read the
// pre-pass's di (flash_bwd.cu) and the forward's lse, not its qs.

#include "flash_bwd.cuh"
#include "flash_d256.cuh"

namespace {

int run_simt(int which, const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* di, const void* q_ids, const void* kv_ids, void* dq, void* dk, void* dv, int dtype,
             int batch, int hq, int hkv, int lq, int lk, int head_dim, const long long* strides, float scale,
             float scale_log2, int causal, int window, void* stream) {
  fa::BwdParams p;
  if (!fa::fill_bwd_params(p, q, k, v, dout, lse, di, nullptr, q_ids, kv_ids, dq, dk, dv, batch, hq, hkv, lq, lk,
                           strides, scale, scale_log2, causal, window))
    return (int)cudaErrorInvalidValue;
  return (int)fa::simt::launch_bwd_for(which, dtype, head_dim, p, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Arguments as for fa_flash_bwd_dkv / fa_flash_bwd_dq (flash_bwd.cu; qs is
// not read); dtype 0 (fp32) at head_dim 256, 512 or 1024.  Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for bf16 / fp16).
extern "C" int fa_flash_bwd_dkv_simt(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* di, const void* qs, const void* q_ids,
                                     const void* kv_ids, void* dk, void* dv, int dtype, int batch, int hq,
                                     int hkv, int lq, int lk, int head_dim, const long long* strides, float scale,
                                     float scale_log2, int causal, int window, void* stream) {
  (void)qs;
  return run_simt(0, q, k, v, dout, lse, di, q_ids, kv_ids, nullptr, dk, dv, dtype, batch, hq, hkv, lq, lk,
                  head_dim, strides, scale, scale_log2, causal, window, stream);
}

extern "C" int fa_flash_bwd_dq_simt(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* di, const void* qs, const void* q_ids,
                                    const void* kv_ids, void* dq, int dtype, int batch, int hq, int hkv, int lq,
                                    int lk, int head_dim, const long long* strides, float scale, float scale_log2,
                                    int causal, int window, void* stream) {
  (void)qs;
  return run_simt(1, q, k, v, dout, lse, di, q_ids, kv_ids, dq, nullptr, nullptr, dtype, batch, hq, hkv, lq, lk,
                  head_dim, strides, scale, scale_log2, causal, window, stream);
}
