// K5 (paged) at the padded head dim 512 (decode_wide.cuh) for bf16 q: every
// payload and pass size.  One source per (q dtype, head dim, entry point),
// so that the build's nvcc processes stay short.

#include "decode_wide.cuh"

namespace fa {
namespace decode {

template cudaError_t wide_launch_width<__nv_bfloat16, 512, true>(const WideParams&, int, int, dim3, cudaStream_t, int*);

}  // namespace decode
}  // namespace fa
