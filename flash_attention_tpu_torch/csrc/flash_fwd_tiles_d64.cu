// K1 at head dim 64 with tiles of 128 and 64 query rows (two and one
// consumer warpgroups; the default, 192 rows, is flash_fwd.cu's), for
// bf16 and fp16: flash_fwd.cuh's warp-specialised kernel, in a source of
// its own so that it compiles beside the others.  fa_flash_fwd reaches it
// through launch_fwd_for when its block_q asks for one of these tiles; the
// autotuner (kernels/autotune.py) sweeps them.  The design notes are at
// the top of flash_fwd.cuh.

#include "flash_fwd.cuh"

namespace fa {

cudaError_t launch_k1_tile_d64(int dtype, int block_q, const FwdParams& p, cudaStream_t s) {
  if (dtype == 1 && block_q == 128) return launch_ws<__nv_bfloat16, __nv_bfloat16, 64, 2>(p, s);
  if (dtype == 1 && block_q == 64) return launch_ws<__nv_bfloat16, __nv_bfloat16, 64, 1>(p, s);
  if (dtype == 2 && block_q == 128) return launch_ws<__half, __half, 64, 2>(p, s);
  if (dtype == 2 && block_q == 64) return launch_ws<__half, __half, 64, 1>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace fa
