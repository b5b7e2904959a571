// K1 and K4 at padded head dim 1024 for bf16 and fp16: flash_fwd_wide.cuh's
// kernel (the design notes are there) at D = 1024, two blocks of 512 output
// columns a query tile, in a source of its own so that it compiles beside
// flash_fwd_wide.cu (D = 512); flash_fwd.cuh's launch_fwd_for calls it.

#include "flash_fwd_wide.cuh"

namespace fa {

cudaError_t launch_fwd_wide_d1024(int dtype, int kv_dtype, const FwdParams& p, cudaStream_t s) {
  return wide::launch_for<1024>(dtype, kv_dtype, p, s);
}

}  // namespace fa
