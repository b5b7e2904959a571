// K1 and K4 at padded head dim 512 for bf16 and fp16: flash_fwd_wide.cuh's
// kernel (the design notes are there) at D = 512, in a source of its own so
// that it compiles beside the rest; flash_fwd.cuh's launch_fwd_for calls it.

#include "flash_fwd_wide.cuh"

namespace fa {

cudaError_t launch_fwd_wide_d512(int dtype, int kv_dtype, const FwdParams& p, cudaStream_t s) {
  return wide::launch_for<512>(dtype, kv_dtype, p, s);
}

}  // namespace fa
