// FlashAttention-2 forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (flash_attention_tpu_torch/kernels/_build.py).
//
// Replaces: flash_attention_tpu/kernels/flash_attention.py::_fwd_kernel
// (launched there by _fwd through pl.pallas_call).  It computes the same
// function, not a block-by-block copy: online softmax in the exp2 domain,
// q scaled by sm_scale*log2(e) and rounded back to its dtype before QK^T,
// m / l / the accumulator in fp32, one final division with the l == 0
// guard, causal masking with queries aligned to the end of KV, GQA by
// reading KV head hq / group (KV is never copied), and an optional lse
// output (fp32, natural log).
//
// What bounds it on this card: at the serving path's prefill shapes
// (GPT-2, D = 64, L <= 1024) attention is compute-bound in principle
// (~L/2 FLOPs per byte of Q/K/V read with causal skipping), so the limit is
// the rate at which the tensor cores are fed.  This first version feeds
// them with warp-level mma.sync (m16n8k16, bf16/fp16 in, fp32 out) from
// tiles staged in shared memory by plain 16-byte loads, with no overlap of
// loads and math: it reaches a fraction of the card's 989 TFLOP/s.  The
// wgmma/TMA pipeline that the rate needs is later work.  What the design
// does about the bound it can see:
//   * one thread block per (batch * q head, 64-row q tile), so a GPT-2
//     prefill at b1 L1024 already launches 12 x 16 = 192 blocks for 132 SMs;
//   * the KV loop stops at the last tile the causal rule admits, so masked
//     tiles are never loaded (this replaces the TPU's scalar-prefetched cell
//     tables), and only tiles that cross the diagonal or the ragged KV end
//     pay for the element mask;
//   * ragged Lq / Lkv are masked in the kernel: no host-side padding copy;
//   * inputs are read through their strides, so q/k/v sliced out of the
//     fused QKV projection are never copied.
// fp32 inputs take a SIMT path (one thread per query row, fp32 FMA), since
// the tensor cores' TF32 would miss the fp32 tolerance of 1e-5.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError() so that the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [batch, hq, lq] contiguous, or null
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int hq, group, lq, lk;
  float scale_log2;  // sm_scale * log2(e)
  int causal;
};

constexpr float kLn2 = 0.6931471805599453f;

// Last KV column (exclusive) that any row of the q tile [r0, r1) may see.
__device__ __forceinline__ int kv_end_for_tile(const FwdParams& p, int r1) {
  if (!p.causal) return p.lk;
  int end = r1 - 1 + (p.lk - p.lq) + 1;
  return end < p.lk ? end : p.lk;
}

// ---------------------------------------------------------------------------
// 16-bit path: mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <typename T> struct Pack;
template <> struct Pack<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint32_t halves(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    __nv_bfloat162 h;
    h.x = lo;
    h.y = hi;
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};
template <> struct Pack<__half> {
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint32_t halves(__half lo, __half hi) {
    __half2 h;
    h.x = lo;
    h.y = hi;
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half from_f(float x) { return __float2half_rn(x); }
};

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy a [ROWS, D] tile (rows from `row0`, `nrows` of them valid) from global
// memory with row stride `ld` into shared memory with row stride D + PAD.
// Rows past the end are zero-filled.  16-byte vector loads: the wrapper
// guarantees 16-byte alignment of the base and of every row.
template <typename T, int ROWS, int D, int LDS, int NTHREADS>
__device__ __forceinline__ void load_tile(T* __restrict__ s, const T* __restrict__ g,
                                          long long ld, int row0, int nrows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunksPerRow = D / kVec;
  for (int c = threadIdx.x; c < ROWS * kChunksPerRow; c += NTHREADS) {
    int r = c / kChunksPerRow;
    int col = (c % kChunksPerRow) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * ld + col);
    }
    *reinterpret_cast<uint4*>(s + r * LDS + col) = val;
  }
}

template <typename T, int D>
struct MmaCfg {
  static constexpr int kBr = 64;   // 4 warps x 16 rows
  static constexpr int kBc = 64;
  static constexpr int kThreads = 128;
  static constexpr int kLds = D + 8;  // padded row: spreads rows over banks
  static constexpr int kSmemBytes = (kBr + 2 * kBc) * kLds * sizeof(T);
};

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_fwd_mma_kernel(const FwdParams p) {
  using C = MmaCfg<T, D>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kLds = C::kLds;
  constexpr int kNB = kBc / 8;   // score n-blocks per warp
  constexpr int kKS = D / 16;    // k-steps over the head dim
  constexpr int kND = D / 8;     // output n-blocks

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBr * kLds;
  T* sV = sK + kBc * kLds;

  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int r0 = tile * kBr;
  const int r1 = min(r0 + kBr, p.lq);

  const T* gq = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* gk = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* gv = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* go = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row group
  const int t = lane % 4;  // column pair

  // Q tile: scale by sm_scale*log2(e) and round back to T, as the TPU
  // kernel does before its QK^T.
  load_tile<T, kBr, D, kLds, C::kThreads>(sQ, gq, p.q_sl, r0, p.lq);
  __syncthreads();
  for (int i = threadIdx.x; i < kBr * D; i += C::kThreads) {
    T* e = sQ + (i / D) * kLds + (i % D);
    *e = Pack<T>::from_f(Pack<T>::to_f(*e) * p.scale_log2);
  }
  __syncthreads();

  // Q fragments stay in registers for the whole KV loop.
  uint32_t qf[kKS][4];
  {
    const T* base = sQ + (warp * 16 + g) * kLds + 2 * t;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(base + ks * 16);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds + ks * 16);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(base + ks * 16 + 8);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds + ks * 16 + 8);
    }
  }

  float acc[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  const int offset = p.lk - p.lq;
  const int row_a = r0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8
  const int kv_end = kv_end_for_tile(p, r1);
  const int n_tiles = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int c0 = jt * kBc;
    __syncthreads();  // previous tile fully consumed
    load_tile<T, kBc, D, kLds, C::kThreads>(sK, gk, p.k_sl, c0, p.lk);
    load_tile<T, kBc, D, kLds, C::kThreads>(sV, gv, p.v_sl, c0, p.lk);
    __syncthreads();

    // S = Qs K^T for this warp's 16 rows: [16, kBc] as kNB 16x8 blocks.
    float s[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      const T* kb = sK + (nb * 8 + g) * kLds + 2 * t;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb + ks * 16);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + ks * 16 + 8);
        mma16816<T>(s[nb], qf[ks], b0, b1);
      }
    }

    // Element mask only where the tile crosses the diagonal or the KV end.
    const bool need_mask =
        (c0 + kBc > p.lk) || (p.causal && c0 + kBc - 1 > r0 + offset);
    if (need_mask) {
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int row = row_a + (e >= 2 ? 8 : 0);
          int col = c0 + nb * 8 + 2 * t + (e & 1);
          bool ok = col < p.lk && (!p.causal || col <= row + offset);
          if (!ok) s[nb][e] = -CUDART_INF_F;
        }
    }

    // Online softmax for rows g (e = 0, 1) and g + 8 (e = 2, 3); the four
    // threads of a quad hold one row between them.
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      float m_new = fmaxf(m[r], mx[r]);
      base[r] = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked so far
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      s[nb][0] = exp2f(s[nb][0] - base[0]);
      s[nb][1] = exp2f(s[nb][1] - base[0]);
      s[nb][2] = exp2f(s[nb][2] - base[1]);
      s[nb][3] = exp2f(s[nb][3] - base[1]);
      l[0] += s[nb][0] + s[nb][1];  // per-thread partial; quad-summed at the end
      l[1] += s[nb][2] + s[nb][3];
    }

    // acc += P V, P rounded to T: two adjacent score blocks form one A
    // fragment of the k = 16 product.
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = Pack<T>::two(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = Pack<T>::two(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = Pack<T>::two(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = Pack<T>::two(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const T* vb = sV + (kk * 16 + 2 * t) * kLds + g;
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        const T* v0 = vb + nd * 8;
        uint32_t b0 = Pack<T>::halves(v0[0], v0[kLds]);
        uint32_t b1 = Pack<T>::halves(v0[8 * kLds], v0[9 * kLds]);
        mma16816<T>(acc[nd], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= p.lq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    T* orow = go + (long long)row * p.o_sl + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          Pack<T>::two(acc[nd][2 * r] * inv, acc[nd][2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(long long)bh * p.lq + row] = (m[r] + log2f(l_safe)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 path: SIMT, one thread per query row
// ---------------------------------------------------------------------------

template <int D>
struct SimtCfg {
  static constexpr int kBr = 64;
  static constexpr int kBc = 32;
  static constexpr int kThreads = kBr;
  static constexpr int kLdq = D + 1;  // odd stride: row-per-thread reads hit distinct banks
  static constexpr int kSmemBytes = (kBr * kLdq + 2 * kBc * D) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(64)
flash_fwd_simt_kernel(const FwdParams p) {
  using C = SimtCfg<D>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kLdq = C::kLdq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBr * kLdq;
  float* sV = sK + kBc * D;

  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int r0 = tile * kBr;
  const int r1 = min(r0 + kBr, p.lq);

  const float* gq = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* gk = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* gv = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* go = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = threadIdx.x; i < kBr * D; i += C::kThreads) {
    int r = i / D, c = i % D;
    sQ[r * kLdq + c] = r0 + r < p.lq ? gq[(long long)(r0 + r) * p.q_sl + c] * p.scale_log2 : 0.f;
  }

  const int row = r0 + threadIdx.x;
  const int offset = p.lk - p.lq;
  const int kv_end = kv_end_for_tile(p, r1);
  const int n_tiles = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;
  const float* q = sQ + threadIdx.x * kLdq;

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int c0 = jt * kBc;
    __syncthreads();
    load_tile<float, kBc, D, D, C::kThreads>(sK, gk, p.k_sl, c0, p.lk);
    load_tile<float, kBc, D, D, C::kThreads>(sV, gv, p.v_sl, c0, p.lk);
    __syncthreads();

    float s[kBc];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBc; ++j) {
      const int col = c0 + j;
      const bool ok = col < p.lk && (!p.causal || col <= row + offset);
      float dot = 0.f;
      if (ok) {
        const float* kr = sK + j * D;
#pragma unroll 16
        for (int c = 0; c < D; ++c) dot = fmaf(q[c], kr[c], dot);
      }
      s[j] = ok ? dot : -CUDART_INF_F;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = exp2f(m - base);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kBc; ++j) {
      const float pj = exp2f(s[j] - base);
      l += pj;
      const float* vr = sV + j * D;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(pj, vr[c], acc[c]);
    }
  }

  if (row < p.lq) {
    const float l_safe = l == 0.f ? 1.f : l;
    float* orow = go + (long long)row * p.o_sl;
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = acc[c] / l_safe;
    if (p.lse != nullptr) p.lse[(long long)bh * p.lq + row] = (m + log2f(l_safe)) * kLn2;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int threads, int br, int batch, const FwdParams& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.lq + br - 1) / br, batch * p.hq);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(int batch, const FwdParams& p, cudaStream_t stream) {
  using C = MmaCfg<T, D>;
  return launch(flash_fwd_mma_kernel<T, D>, C::kSmemBytes, C::kThreads, C::kBr, batch, p, stream);
}

template <int D>
cudaError_t launch_simt(int batch, const FwdParams& p, cudaStream_t stream) {
  using C = SimtCfg<D>;
  return launch(flash_fwd_simt_kernel<D>, C::kSmemBytes, C::kThreads, C::kBr, batch, p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  head_dim: 64 or 128.
// Strides are in elements; the last dim is contiguous.  lse may be null.
// Returns a cudaError_t (0 on success), or cudaErrorInvalidValue for a
// dtype or head dim this kernel does not instantiate.
extern "C" int fa_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int dtype, int batch, int hq, int hkv, int lq, int lk, int head_dim,
                            long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                            long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                            long long v_sl, long long o_sb, long long o_sh, long long o_sl,
                            float scale_log2, int causal, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || lq <= 0 || lk <= 0 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.hq = hq;
  p.group = hq / hkv;
  p.lq = lq;
  p.lk = lk;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)launch_simt<64>(batch, p, s);
  if (dtype == 0 && head_dim == 128) return (int)launch_simt<128>(batch, p, s);
  if (dtype == 1 && head_dim == 64) return (int)launch_mma<__nv_bfloat16, 64>(batch, p, s);
  if (dtype == 1 && head_dim == 128) return (int)launch_mma<__nv_bfloat16, 128>(batch, p, s);
  if (dtype == 2 && head_dim == 64) return (int)launch_mma<__half, 64>(batch, p, s);
  if (dtype == 2 && head_dim == 128) return (int)launch_mma<__half, 128>(batch, p, s);
  return (int)cudaErrorInvalidValue;
}
