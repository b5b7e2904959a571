// K2 (dK/dV) and K3 (dQ) for fp32 at padded head dim 1024:
// flash_bwd_fp32_wide.cuh's 3xTF32 kernels (the design notes are there), in
// a source of their own so that they compile beside flash_bwd_fp32_wide.cu
// (D = 256, 512); fa_flash_bwd_dkv and fa_flash_bwd_dq (flash_bwd.cu)
// launch them.

#include "flash_bwd_fp32_wide.cuh"

namespace fa {

cudaError_t launch_bwd_fp32_wide_d1024(int which, const BwdParams& p, cudaStream_t s) {
  return bwd32::launch<1024>(which, p, s);
}

}  // namespace fa
