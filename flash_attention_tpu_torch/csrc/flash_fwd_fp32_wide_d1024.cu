// K1 and K4 for fp32 at padded head dim 1024: flash_fwd_fp32_wide.cuh's
// 3xTF32 kernel (the design notes are there), in a source of its own so that
// it compiles beside flash_fwd_fp32_wide.cu (D = 256, 512); flash_fwd.cuh's
// launch_fwd_for calls it.

#include "flash_fwd_fp32_wide.cuh"

namespace fa {

cudaError_t launch_fwd_fp32_wide_d1024(int kv_dtype, const FwdParams& p, cudaStream_t s) {
  return wide32::launch_for<1024>(kv_dtype, p, s);
}

}  // namespace fa
