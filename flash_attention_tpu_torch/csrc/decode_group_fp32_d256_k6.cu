// K6 (slot-major) over a GQA group above 8 for fp32 q at head dim 256
// (decode_group_fp32.cuh): every payload and row-tile grouping.  One
// source per (head dim, entry point), so that the build's nvcc processes stay short.

#include "decode_group_fp32.cuh"

namespace fa {
namespace decode {

#define FA_GROUP32_INSTANTIATE(KV, D, P) \
  template cudaError_t group32_launch_rows<KV, D, P>(const GroupParams&, int, dim3, cudaStream_t, int*);
FA_GROUP32_ROWS(FA_GROUP32_INSTANTIATE, 256, false)
#undef FA_GROUP32_INSTANTIATE

}  // namespace decode
}  // namespace fa
