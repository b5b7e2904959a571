// K1: the flash-attention forward (fa_flash_fwd).  The bf16 / fp16 kernels
// and their design notes are in flash_fwd.cuh, which K4
// (flash_fwd_kv_quant.cu) shares; fp32 is the 3xTF32 tensor-core kernels of
// flash_fwd_fp32.cu (head dims 64, 128) and flash_fwd_fp32_wide.cuh (256,
// 512, 1024), each with its own notes.

#include "flash_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  head_dim: 64, 128, 256,
// 512 or 1024 for every dtype.  Strides are in elements; the last dim is
// contiguous.  lse may be null; q_ids / kv_ids are both null or both contiguous int32 [batch, lq]
// and [batch, lk].  window <= 0 means no window (it applies only when
// causal).  block_q: the tile's query rows for bf16 / fp16, one of
// kernels/block_sizes.py::K1_TILES at the head dim (192, 128 or 64 at 64;
// 128 or 64 at 128; 64 at 256), or 0 for the default (the first of them);
// fp32 (128 query rows a block) and head dims 512 and 1024 have one tile
// and take 0.  Returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for a dtype, head dim or block_q this kernel does
// not instantiate.
extern "C" int fa_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
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
  if (!fa::fill_fwd_params(p, batch, hq, hkv, lq, lk, strides, scale_log2, causal, window))
    return (int)cudaErrorInvalidValue;
  return (int)fa::launch_fwd_for<void>(dtype, head_dim, p, static_cast<cudaStream_t>(stream), block_q);
}
