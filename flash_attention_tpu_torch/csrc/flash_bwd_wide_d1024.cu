// K2 (dK/dV) and K3 (dQ) at padded head dim 1024 for bf16 and fp16:
// flash_bwd_wide.cuh's kernels (the design notes are there) at D = 1024, in
// a source of their own so that they compile beside flash_bwd_wide.cu
// (D = 512); fa_flash_bwd_dkv and fa_flash_bwd_dq (flash_bwd.cu) launch
// them.

#include "flash_bwd_wide.cuh"

namespace fa {

cudaError_t launch_bwd_wide_d1024(int which, int dtype, const BwdParams& p, cudaStream_t s) {
  return wide::launch_bwd_for<1024>(which, dtype, p, s);
}

}  // namespace fa
