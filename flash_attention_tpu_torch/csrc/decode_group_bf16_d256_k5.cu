// K5 (paged) over a GQA group above 8 (decode_group.cuh) for bf16 q at head
// dim 256: every payload and row-tile grouping.  One source per (q dtype,
// head dim, entry point), so that the build's nvcc processes stay short.

#include "decode_group.cuh"

namespace fa {
namespace decode {

#define FA_GROUP_INSTANTIATE(T, KV, D, P) \
  template cudaError_t group_launch_rows<T, KV, D, P>(const GroupParams&, int, dim3, cudaStream_t, int*);
FA_GROUP_ROWS(FA_GROUP_INSTANTIATE, __nv_bfloat16, 256, true)
#undef FA_GROUP_INSTANTIATE

}  // namespace decode
}  // namespace fa
