// K1 and K4 at head dim 256 for bf16 and fp16: flash_fwd.cuh's
// warp-specialised kernel at D = 256 (WsCfg<T, KV, 256>), in a source of its
// own so that it compiles beside flash_fwd.cu and flash_fwd_kv_quant.cu,
// whose dispatcher (launch_fwd_for) calls it.  The design notes are at the
// top of flash_fwd.cuh.

#include "flash_fwd.cuh"

namespace fa {

cudaError_t launch_ws_d256(int dtype, int kv_dtype, const FwdParams& p, cudaStream_t s) {
  if (dtype == 1 && kv_dtype == 0) return launch_ws<__nv_bfloat16, __nv_bfloat16, 256>(p, s);
  if (dtype == 2 && kv_dtype == 0) return launch_ws<__half, __half, 256>(p, s);
  if (dtype == 1 && kv_dtype == 1) return launch_ws<__nv_bfloat16, int8_t, 256>(p, s);
  if (dtype == 2 && kv_dtype == 1) return launch_ws<__half, int8_t, 256>(p, s);
  if (dtype == 1 && kv_dtype == 2) return launch_ws<__nv_bfloat16, __nv_fp8_e4m3, 256>(p, s);
  if (dtype == 2 && kv_dtype == 2) return launch_ws<__half, __nv_fp8_e4m3, 256>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace fa
