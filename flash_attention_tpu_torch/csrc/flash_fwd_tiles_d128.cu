// K1 at head dim 128 with a tile of 64 query rows (one consumer warpgroup;
// the default, 128 rows, is flash_fwd.cu's), for bf16 and fp16:
// flash_fwd.cuh's warp-specialised kernel, in a source of its own so that
// it compiles beside the others.  fa_flash_fwd reaches it through
// launch_fwd_for when its block_q asks for it; the autotuner
// (kernels/autotune.py) sweeps it.  The design notes are at the top of
// flash_fwd.cuh.

#include "flash_fwd.cuh"

namespace fa {

cudaError_t launch_k1_tile_d128(int dtype, int block_q, const FwdParams& p, cudaStream_t s) {
  if (dtype == 1 && block_q == 64) return launch_ws<__nv_bfloat16, __nv_bfloat16, 128, 1>(p, s);
  if (dtype == 2 && block_q == 64) return launch_ws<__half, __half, 128, 1>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace fa
