// What the two cluster decode kernels share: the whole-group kernel
// (decode_group.cuh) and the wide kernel (decode_wide.cuh) both run a
// (sequence, KV head, pass) as one thread-block cluster whose blocks walk
// interleaved chunks of the capacity, and both end in the same merge of the
// blocks' softmax states over distributed shared memory.  This header holds
// the cluster's limits, ldmatrix, the merge, the whole-group kernels' state
// layout and token-group merge, and the launch.
#pragma once

#include "decode.cuh"
#include "sm90.cuh"

namespace fa {
namespace decode {

constexpr int kClusterMax = 8;          // blocks of a cluster: any of 1-8 (portable sizes)
constexpr int kClusterMaxPages = 1024;  // page ids a block stages (K5; the host keeps to it)

// The parameters of the cluster kernels that take a whole GQA group a
// block: the whole-group kernels (decode_group.cuh, decode_group_fp32.cuh)
// and the narrow kernel (decode_narrow.cuh, one pass of the group's 1-8
// rows).
struct GroupParams {
  const void* q;         // [batch, hq, d], last dim contiguous
  const void* k;         // payload: paged [hkv, pages, page_size, d] or slot-major [hkv, slots, max_len, d]
  const void* v;
  const float* ks;       // scales [hkv, pages or slots, rows]; null unless quantized
  const float* vs;
  const int* lengths;    // [batch]
  const int* table;      // [batch, pages_per_seq] (K5) or null (K6)
  void* o;               // [batch, hq, d], rows 8-byte aligned (q's 16-byte aligned)
  long long q_sb, q_sh, o_sb, o_sh;
  long long k_sh, k_sp, k_sr, v_sh, v_sp, v_sr, s_sh, s_sp;
  // q heads a KV head, passes of the group, q heads a pass (a multiple of 16
  // in the whole-group kernels)
  int group, passes, pass_rows;
  int page_size, pages_per_seq, len_add;
  int chunk, walks;      // tokens of a chunk; chunks a block walks
  int head_dim;          // d, at most the instantiated D (8, 16 or 32 at D32; 48-256, a multiple of 16, at D64-D256)
  float q_scale, score_scale;
};

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Four 8x8 16-bit matrices from shared memory: lanes 8i .. 8i + 7 give the
// row addresses of matrix i; .trans transposes each.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  }
}

// The end of a cluster kernel.  Each block of the cluster (C blocks, this
// one `rank`) holds its state for the pass's G rows in its own shared
// memory: acc [row][D] fp32 at `state`, m and l [row] at `state_m` and
// `state_l`.  After a cluster barrier each block weighs the rows once,
// e^(m_r - M) for each block r (a row takes C lanes, rounded up to a power of
// two, reduced by shuffles; a block without tokens, m = -inf, adds nothing),
// into `weights` [row][kClusterMax] and the rows' l into `sums` [row]; then
// it merges its slice of the rows x the first d columns, 4 columns a
// thread, reading its peers' states over distributed shared memory in rank
// order, and writes out[g * o_sh + c] in T with the l == 0 guard.  The
// second cluster barrier keeps every block until its peers have read it.
// Every thread of the block calls it.
template <typename T, int kThreads, int D>
__device__ __forceinline__ void cluster_merge(const float* state, const float* state_m, const float* state_l,
                                              float* weights, float* sums, int G, int d, int C, int rank, int tid,
                                              T* out, long long o_sh) {
  static_assert(kThreads % 32 == 0, "whole warps: the shuffles need them");
  sm90::cluster_sync();
  int lanes = 1;  // lanes a row: a power of two, so that a row's lanes sit in one warp
  while (lanes < C) lanes *= 2;
  for (int i = tid; i < ((G * lanes + 31) / 32) * 32; i += kThreads) {
    const int g = i / lanes, r = i % lanes;
    const bool ok = g < G && r < C;
    const float m = ok ? ld_cluster_f32(sm90::cluster_addr(state_m + g, r)) : -CUDART_INF_F;
    const float l = ok ? ld_cluster_f32(sm90::cluster_addr(state_l + g, r)) : 0.f;
    float mx = m;
    for (int off = 1; off < lanes; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float w = m == -CUDART_INF_F ? 0.f : expf(m - mx);
    float lw = l * w;
    for (int off = 1; off < lanes; off *= 2) lw += __shfl_xor_sync(kFull, lw, off);
    if (ok) {
      weights[g * kClusterMax + r] = w;
      if (r == 0) sums[g] = lw == 0.f ? 1.f : lw;
    }
  }
  __syncthreads();
  // The loop walks D's columns, so that it divides by a constant whatever
  // d, and skips those past d.
  constexpr int kD4 = D / 4;
  for (int e = rank * kThreads + tid; e < G * kD4; e += C * kThreads) {
    const int g = e / kD4, c4 = e % kD4;
    if (c4 * 4 >= d) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < C; ++r) {
      const float w = weights[g * kClusterMax + r];
      const float4 x = ld_cluster_f4(sm90::cluster_addr(state + g * D + c4 * 4, r));
      acc.x += x.x * w;
      acc.y += x.y * w;
      acc.z += x.z * w;
      acc.w += x.w * w;
    }
    const float l = sums[g];
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(out + g * o_sh + c4 * 4) = make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
    } else {
      uint2 o;
      o.x = Pack<T>::two(acc.x / l, acc.y / l);
      o.y = Pack<T>::two(acc.z / l, acc.w / l);
      *reinterpret_cast<uint2*>(out + g * o_sh + c4 * 4) = o;
    }
  }
  sm90::cluster_sync();  // no block leaves while a peer reads its state
}

// The states that end the whole-group kernels, laid over the ring once the
// stream is done, for kRows q heads of D columns: the block's state (acc
// [row][D] fp32 at 0, m and l [row]), which the cluster's peers read,
// cluster_merge's weights [row][kClusterMax] and sums [row]; and where a row
// tile's P V runs as kTG > 1 token groups, each with its own online softmax
// (decode_group.cuh at D32, decode_group_fp32.cuh), each group's state
// [kTG][row][D] with its m and l [kTG][row].
template <int kRows, int D, int kTG>
struct MergeLayout {
  static constexpr int kStateM = kRows * D * 4;
  static constexpr int kStateL = kStateM + kRows * 4;
  static constexpr int kWeights = kStateL + kRows * 4;
  static constexpr int kSums = kWeights + kRows * kClusterMax * 4;
  static constexpr int kGroups = kSums + kRows * 4;
  static constexpr int kGroupM = kGroups + (kTG > 1 ? kTG * kRows * D * 4 : 0);
  static constexpr int kGroupL = kGroupM + (kTG > 1 ? kTG * kRows * 4 : 0);
  static constexpr int kEnd = kGroupL + (kTG > 1 ? kTG * kRows * 4 : 0);

  // Token group tg's acc, m and l: its own, or the block's when a row tile
  // has one group.
  __device__ static float* group_acc(unsigned char* smem, int tg) {
    return reinterpret_cast<float*>(smem + (kTG > 1 ? kGroups + tg * kRows * D * 4 : 0));
  }
  __device__ static float* group_m(unsigned char* smem, int tg) {
    return reinterpret_cast<float*>(smem + (kTG > 1 ? kGroupM + tg * kRows * 4 : kStateM));
  }
  __device__ static float* group_l(unsigned char* smem, int tg) {
    return reinterpret_cast<float*>(smem + (kTG > 1 ? kGroupL + tg * kRows * 4 : kStateL));
  }

  // The token groups' states merged in group order into the block's state
  // for its first G rows: M = max m, weights e^(m_g - M) (0 for a group
  // without tokens), acc and l summed with them.  Nothing at kTG 1, whose
  // one group wrote the block's state.  Every thread of the block calls it
  // once its group's state is written.
  template <int kThreads>
  __device__ static void merge_groups(unsigned char* smem, int G, int tid) {
    if constexpr (kTG > 1) {
      __syncthreads();
      const float* gacc = reinterpret_cast<const float*>(smem + kGroups);
      const float* gm = reinterpret_cast<const float*>(smem + kGroupM);
      const float* gl = reinterpret_cast<const float*>(smem + kGroupL);
      float* state = reinterpret_cast<float*>(smem);
      float* state_m = reinterpret_cast<float*>(smem + kStateM);
      float* state_l = reinterpret_cast<float*>(smem + kStateL);
      for (int e = tid; e < G * (D / 4); e += kThreads) {
        const int row = e / (D / 4), c4 = e % (D / 4);
        float M = -CUDART_INF_F;
#pragma unroll
        for (int g = 0; g < kTG; ++g) M = fmaxf(M, gm[g * kRows + row]);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        float l = 0.f;
#pragma unroll
        for (int g = 0; g < kTG; ++g) {
          const float m = gm[g * kRows + row];
          const float w = m == -CUDART_INF_F ? 0.f : expf(m - M);
          const float4 x = *reinterpret_cast<const float4*>(gacc + (g * kRows + row) * D + c4 * 4);
          acc.x += x.x * w;
          acc.y += x.y * w;
          acc.z += x.z * w;
          acc.w += x.w * w;
          l += gl[g * kRows + row] * w;
        }
        *reinterpret_cast<float4*>(state + row * D + c4 * 4) = acc;
        if (c4 == 0) {
          state_m[row] = M;
          state_l[row] = l;
        }
      }
    }
  }
};

// Launches kKernel in clusters of `cluster` blocks of kThreads threads and
// kBytes of dynamic shared memory, or with `resident` non-null only writes
// there how many such clusters the card holds at once (the host's split
// keeps a step's clusters within that: a cluster left for a second wave
// doubles the step's time).
template <typename Params, void (*kKernel)(Params), int kThreads, int kBytes>
cudaError_t cluster_launch(const Params& p, int cluster, dim3 grid, cudaStream_t s, int* resident) {
  // once per device: the opt-in shared memory, and all of an SM's shared
  // memory as such (so that two blocks of about 100 KB share an SM)
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !done[dev]) {
    e = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kKernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    if (dev < 64) done[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident != nullptr) return cudaOccupancyMaxActiveClusters(resident, kKernel, &cfg);
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kKernel, p);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace decode
}  // namespace fa
