// K5 / K6 (decode.cuh) for bf16 q at the padded head dim 512: every payload,
// group tile and entry point.  One source per (q dtype, head dim), so that
// the build's nvcc processes stay short.

#include "decode.cuh"

namespace fa {
namespace decode {

template cudaError_t launch_width<__nv_bfloat16, 512>(const DecodeParams&, int, bool, dim3, cudaStream_t);

}  // namespace decode
}  // namespace fa
