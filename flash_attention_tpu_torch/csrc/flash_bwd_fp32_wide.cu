// K2 (dK/dV) and K3 (dQ) for fp32 at padded head dims 256 and 512:
// flash_bwd_fp32_wide.cuh's 3xTF32 kernels (the design notes are there), in
// a source of their own so that they compile beside the rest;
// fa_flash_bwd_dkv and fa_flash_bwd_dq (flash_bwd.cu) launch them.

#include "flash_bwd_fp32_wide.cuh"

namespace fa {

cudaError_t launch_bwd_fp32_wide(int which, int head_dim, const BwdParams& p, cudaStream_t s) {
  if (head_dim == 256) return bwd32::launch<256>(which, p, s);
  if (head_dim == 512) return bwd32::launch<512>(which, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace fa
