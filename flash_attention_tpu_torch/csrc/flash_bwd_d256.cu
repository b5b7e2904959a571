// K2 (dK/dV) and K3 (dQ) at head dim 256 for bf16 and fp16: flash_bwd.cuh's
// warp-specialised kernels with one consumer warpgroup of 64 pinned rows
// (KV rows for K2, q rows for K3) against streamed tiles of 32 q rows
// (DkvCfg<256>) or 64 KV rows (DqCfg<256>), in a source of their own so
// that they compile beside flash_bwd.cu.  fa_flash_bwd_dkv and
// fa_flash_bwd_dq (flash_bwd.cu) launch them; the design notes are at the
// top of flash_bwd.cu.

#include "flash_bwd.cuh"

namespace fa {

cudaError_t launch_dkv_ws_d256(int dtype, const BwdParams& p, cudaStream_t stream) {
  if (dtype == 1) return launch_dkv_ws<__nv_bfloat16, 256>(p, stream);
  if (dtype == 2) return launch_dkv_ws<__half, 256>(p, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_dq_ws_d256(int dtype, const BwdParams& p, cudaStream_t stream) {
  if (dtype == 1) return launch_dq_ws<__nv_bfloat16, 256>(p, stream);
  if (dtype == 2) return launch_dq_ws<__half, 256>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fa
