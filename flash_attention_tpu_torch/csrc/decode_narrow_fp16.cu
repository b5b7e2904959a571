// K5 / K6 at head dims 8, 16 and 32 for GQA groups of up to 8
// (decode_narrow.cuh) for fp16 q: every payload, q-row capacity and entry
// point.  One source per q dtype, so that the build's nvcc processes stay
// short.

#include "decode_narrow.cuh"

namespace fa {
namespace decode {

template cudaError_t narrow_launch_dtype<__half>(const GroupParams&, int, bool, int, dim3, cudaStream_t, int*);

}  // namespace decode
}  // namespace fa
