// K1 and K4 for fp32 at padded head dims 256 and 512: flash_fwd_fp32_wide.cuh's
// 3xTF32 kernel (the design notes are there), in a source of its own so that
// it compiles beside the rest; flash_fwd.cuh's launch_fwd_for calls it.

#include "flash_fwd_fp32_wide.cuh"

namespace fa {

cudaError_t launch_fwd_fp32_wide(int kv_dtype, int head_dim, const FwdParams& p, cudaStream_t s) {
  if (head_dim == 256) return wide32::launch_for<256>(kv_dtype, p, s);
  if (head_dim == 512) return wide32::launch_for<512>(kv_dtype, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace fa
