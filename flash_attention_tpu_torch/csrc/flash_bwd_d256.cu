// K2 (dK/dV) at head dim 256 for bf16 and fp16: flash_bwd.cuh's
// warp-specialised kernel with one consumer warpgroup of 64 pinned KV rows
// and 32-row q tiles (DkvCfg<256>), in a source of its own so that it
// compiles beside flash_bwd.cu.  fa_flash_bwd_dkv (flash_bwd.cu) launches
// it; the design notes are at the top of flash_bwd.cu.

#include "flash_bwd.cuh"

namespace fa {

cudaError_t launch_dkv_ws_d256(int dtype, const BwdParams& p, cudaStream_t stream) {
  if (dtype == 1) return launch_dkv_ws<__nv_bfloat16, 256>(p, stream);
  if (dtype == 2) return launch_dkv_ws<__half, 256>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fa
