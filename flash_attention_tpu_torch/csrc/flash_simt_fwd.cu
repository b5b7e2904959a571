// K1 in the SIMT family (fa_flash_fwd_simt): the forward of flash_d256.cuh,
// where the design notes are, for fp32 at padded head dims 256, 512 and 1024
// (bf16 and fp16 take fa_flash_fwd's wgmma kernels there).

#include "flash_d256.cuh"
#include "flash_fwd.cuh"

// Arguments as for fa_flash_fwd (flash_fwd.cu); dtype 0 (fp32) at head_dim
// 256, 512 or 1024.  The SIMT family has one tile, so block_q must be 0.
// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for bf16 /
// fp16 or a block_q other than 0).
extern "C" int fa_flash_fwd_simt(const void* q, const void* k, const void* v, void* o, void* lse,
                                 const void* q_ids, const void* kv_ids,
                                 int dtype, int batch, int hq, int hkv, int lq, int lk, int head_dim,
                                 long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                                 long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                                 long long v_sl, long long o_sb, long long o_sh, long long o_sl,
                                 float scale_log2, int causal, int window, int block_q, void* stream) {
  fa::FwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_ids = static_cast<const int*>(q_ids);
  p.kv_ids = static_cast<const int*>(kv_ids);
  const long long strides[12] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl};
  if (block_q != 0 || !fa::fill_fwd_params(p, batch, hq, hkv, lq, lk, strides, scale_log2, causal, window))
    return (int)cudaErrorInvalidValue;
  return (int)fa::simt::launch_fwd_for<void>(dtype, head_dim, p, static_cast<cudaStream_t>(stream));
}
