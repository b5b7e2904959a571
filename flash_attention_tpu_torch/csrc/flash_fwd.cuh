// FlashAttention-2 forward for Hopper (sm_90a): the kernel templates behind
// two C entry points, fa_flash_fwd (flash_fwd.cu, K1) and
// fa_flash_fwd_kv_quant (flash_fwd_kv_quant.cu, K4).  Both are loaded
// through ctypes (flash_attention_tpu_torch/kernels/_build.py).
//
// Replaces: flash_attention_tpu/kernels/flash_attention.py::_fwd_kernel
// (K1, launched there by _fwd through pl.pallas_call) and
// flash_attention_tpu/quant/kv.py::_fwd_quant_kernel (K4, launched by
// flash_attention_kv_quant), which is K1's forward without lse over int8 or
// fp8 K/V with one fp32 scale per token.  It computes the same function, not
// a block-by-block copy: online softmax in the exp2 domain, q scaled by
// sm_scale*log2(e) and rounded back to its dtype before QK^T, m / l / the
// accumulator in fp32, one final division with the l == 0 guard, causal
// masking with queries aligned to the end of KV, the sliding window and
// segment ids (_mask_for_block, _seg_mask), GQA by reading KV head
// hq / group (KV is never copied), and an optional lse output (fp32, natural
// log) that the backward kernels (flash_bwd.cu) read.  The kernels are
// templated on the K/V element type KV: KV == T is K1; a 1-byte KV is K4,
// whose K/V tiles are dequantized into shared memory in q's type T as the
// TPU kernel does it (payload.to(T) * scale.to(T), rounded to T;
// load_kv_tile in common.cuh), so from there on K4 is K1.
//
// What bounds it on this card: at the GPT-2 shapes (D = 64, L <= 1024)
// attention is compute-bound in principle (~L/2 FLOPs per byte of Q/K/V
// read with causal skipping), so the limit is the rate at which the tensor
// cores are fed.  K4's 1-byte payload halves the K/V bytes, which leaves it
// as compute-bound as K1.  This first version feeds the tensor cores with
// warp-level mma.sync (m16n8k16, bf16/fp16 in, fp32 out) from tiles staged
// in shared memory by plain 16-byte loads, with no overlap of loads and
// math: it reaches a fraction of the card's 989 TFLOP/s.  The wgmma/TMA
// pipeline that the rate needs is later work.  What the design does about
// the bound it can see:
//   * one thread block per (batch * q head, 64-row q tile), so a GPT-2
//     prefill at b1 L1024 already launches 12 x 16 = 192 blocks for 132 SMs;
//   * the KV loop runs from the first tile the window admits to the last
//     tile the causal rule admits, so masked tiles are never loaded (this
//     replaces the TPU's scalar-prefetched cell tables), and only tiles that
//     cross the diagonal, the window edge or the ragged KV end, or carry
//     segment ids, pay for the element mask;
//   * ragged Lq / Lkv are masked in the kernel: no host-side padding copy;
//   * inputs are read through their strides, so q/k/v sliced out of the
//     fused QKV projection are never copied;
//   * K4 dequantizes each K/V tile once, in shared memory, where all 64 query
//     rows of the block reuse it (the TPU kernel made the same choice over
//     scaling the scores, kv.py:143-148).
// fp32 inputs take a SIMT path (one thread per query row, fp32 FMA), since
// the tensor cores' TF32 would miss the fp32 tolerance of 1e-5.  ptxas -v
// (sm_90a, CUDA 12.8): the mma path uses 128 registers at D = 64 and 228 at
// D = 128, the SIMT path 202 and 255 (88 bytes spilled at D = 128).
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry points return cudaGetLastError() so that the wrapper can raise.
#pragma once

#include "common.cuh"

namespace fa {

struct FwdParams {
  const void* q;
  const void* k;      // KV payload
  const void* v;
  const float* ks;    // K4: per-token scales [batch, hkv, lk], last stride 1
  const float* vs;
  void* o;
  float* lse;        // [batch, hq, lq] contiguous, or null
  const int* q_ids;  // [batch, lq] contiguous segment ids, or null
  const int* kv_ids; // [batch, lk], null exactly when q_ids is
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long s_sb, s_sh;  // strides of ks and vs
  int hq, group;
  Mask mask;
  float scale_log2;  // sm_scale * log2(e)
};

template <typename T, int D>
struct MmaCfg {
  static constexpr int kBr = 64;   // 4 warps x 16 rows
  static constexpr int kBc = 64;
  static constexpr int kThreads = 128;
  static constexpr int kLds = D + 8;  // padded row: spreads rows over banks
  static constexpr int kSmemBytes = (kBr + 2 * kBc) * kLds * sizeof(T);
};

// This block's K and V (and, for a quantized cache, their scales).
template <typename KV>
struct KvRows {
  const KV* k;
  const KV* v;
  const float* ks;
  const float* vs;
  __device__ __forceinline__ KvRows(const FwdParams& p, int b, int hk)
      : k(static_cast<const KV*>(p.k) + b * p.k_sb + hk * p.k_sh),
        v(static_cast<const KV*>(p.v) + b * p.v_sb + hk * p.v_sh),
        ks(p.ks ? p.ks + b * p.s_sb + hk * p.s_sh : nullptr),
        vs(p.vs ? p.vs + b * p.s_sb + hk * p.s_sh : nullptr) {}
};

template <typename T, typename KV, int D>
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
  __shared__ int sKvIds[kBc];

  const Mask mk = p.mask;
  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int r0 = tile * kBr;
  const int r1 = min(r0 + kBr, mk.lq);

  const T* gq = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const KvRows<KV> kv(p, b, hk);
  T* go = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* kv_ids = p.kv_ids ? p.kv_ids + (long long)b * mk.lk : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row group
  const int t = lane % 4;  // column pair
  const int row_a = r0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8
  int q_id[2] = {0, 0};
  if (p.q_ids != nullptr) {
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      q_id[r] = row < mk.lq ? p.q_ids[(long long)b * mk.lq + row] : 0;
    }
  }

  // Q tile: scale by sm_scale*log2(e) and round back to T, as the TPU
  // kernel does before its QK^T.
  load_tile_scaled2<T, kBr, D, kLds, C::kThreads>(sQ, p.scale_log2, nullptr, 0.f, gq, p.q_sl, r0, mk.lq);
  __syncthreads();

  // Q fragments stay in registers for the whole KV loop.
  uint32_t qf[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) load_a<T>(qf[ks], sQ + warp * 16 * kLds + ks * 16, kLds, g, t);

  float acc[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  const int kv_end = mk.kv_end(r1);
  const int j0 = mk.kv_first(r0) / kBc;
  const int n_tiles = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;

  for (int jt = j0; jt < n_tiles; ++jt) {
    const int c0 = jt * kBc;
    __syncthreads();  // previous tile fully consumed
    load_kv_tile<T, KV, kBc, D, kLds, C::kThreads>(sK, kv.k, p.k_sl, kv.ks, c0, mk.lk);
    load_kv_tile<T, KV, kBc, D, kLds, C::kThreads>(sV, kv.v, p.v_sl, kv.vs, c0, mk.lk);
    load_ids<kBc, C::kThreads>(sKvIds, kv_ids, c0, mk.lk, 0);
    __syncthreads();

    // S = Qs K^T for this warp's 16 rows: [16, kBc] as kNB 16x8 blocks.
    float s[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        uint32_t b0, b1;
        load_b_t<T>(b0, b1, sK + nb * 8 * kLds + ks * 16, kLds, g, t);
        mma16816<T>(s[nb], qf[ks], b0, b1);
      }
    }

    // Element mask only where the tile crosses the diagonal, the window
    // edge or the KV end, or where segment ids apply.
    if (kv_ids != nullptr || !mk.tile_visible(r0, kBr, c0, kBc)) {
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int cl = nb * 8 + 2 * t + (e & 1);
          bool ok = mk.visible(row_a + 8 * r, c0 + cl);
          if (kv_ids != nullptr) ok = ok && q_id[r] == sKvIds[cl];
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
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        uint32_t b0, b1;
        load_b<T>(b0, b1, sV + kk * 16 * kLds + nd * 8, kLds, g, t);
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
    if (row >= mk.lq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    T* orow = go + (long long)row * p.o_sl + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          Pack<T>::two(acc[nd][2 * r] * inv, acc[nd][2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(long long)bh * mk.lq + row] = (m[r] + log2f(l_safe)) * kLn2;
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

template <typename KV, int D>
__global__ void __launch_bounds__(64)
flash_fwd_simt_kernel(const FwdParams p) {
  using C = SimtCfg<D>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kLdq = C::kLdq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBr * kLdq;
  float* sV = sK + kBc * D;
  __shared__ int sKvIds[kBc];

  const Mask mk = p.mask;
  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int r0 = tile * kBr;
  const int r1 = min(r0 + kBr, mk.lq);

  const float* gq = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const KvRows<KV> kv(p, b, hk);
  float* go = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* kv_ids = p.kv_ids ? p.kv_ids + (long long)b * mk.lk : nullptr;

  load_tile_f32<kBr, D, kLdq, C::kThreads>(sQ, gq, p.q_sl, r0, mk.lq, p.scale_log2);

  const int row = r0 + threadIdx.x;
  const int q_id = p.q_ids != nullptr && row < mk.lq ? p.q_ids[(long long)b * mk.lq + row] : 0;
  const int kv_end = mk.kv_end(r1);
  const int j0 = mk.kv_first(r0) / kBc;
  const int n_tiles = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;
  const float* q = sQ + threadIdx.x * kLdq;

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int jt = j0; jt < n_tiles; ++jt) {
    const int c0 = jt * kBc;
    __syncthreads();
    load_kv_tile<float, KV, kBc, D, D, C::kThreads>(sK, kv.k, p.k_sl, kv.ks, c0, mk.lk);
    load_kv_tile<float, KV, kBc, D, D, C::kThreads>(sV, kv.v, p.v_sl, kv.vs, c0, mk.lk);
    load_ids<kBc, C::kThreads>(sKvIds, kv_ids, c0, mk.lk, 0);
    __syncthreads();

    float s[kBc];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBc; ++j) {
      const bool ok = mk.visible(row, c0 + j) && (kv_ids == nullptr || q_id == sKvIds[j]);
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

  if (row < mk.lq) {
    const float l_safe = l == 0.f ? 1.f : l;
    float* orow = go + (long long)row * p.o_sl;
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = acc[c] / l_safe;
    if (p.lse != nullptr) p.lse[(long long)bh * mk.lq + row] = (m + log2f(l_safe)) * kLn2;
  }
}

template <typename Kernel>
cudaError_t launch_fwd(Kernel kernel, int smem, int threads, int br, int batch, const FwdParams& p,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.mask.lq + br - 1) / br, batch * p.hq);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The kernel for q's dtype (0 = float32, 1 = bfloat16, 2 = float16), K/V
// element type KV (KV = void: q's own type) and head dim (64 or 128);
// cudaErrorInvalidValue for a combination that is not instantiated.
template <typename KV>
cudaError_t launch_fwd_for(int dtype, int head_dim, int batch, const FwdParams& p, cudaStream_t s) {
  using F32 = typename std::conditional<std::is_void<KV>::value, float, KV>::type;
  using BF16 = typename std::conditional<std::is_void<KV>::value, __nv_bfloat16, KV>::type;
  using F16 = typename std::conditional<std::is_void<KV>::value, __half, KV>::type;
  if (dtype == 0 && head_dim == 64)
    return launch_fwd(flash_fwd_simt_kernel<F32, 64>, SimtCfg<64>::kSmemBytes, 64, 64, batch, p, s);
  if (dtype == 0 && head_dim == 128)
    return launch_fwd(flash_fwd_simt_kernel<F32, 128>, SimtCfg<128>::kSmemBytes, 64, 64, batch, p, s);
  if (dtype == 1 && head_dim == 64)
    return launch_fwd(flash_fwd_mma_kernel<__nv_bfloat16, BF16, 64>, MmaCfg<__nv_bfloat16, 64>::kSmemBytes, 128,
                      64, batch, p, s);
  if (dtype == 1 && head_dim == 128)
    return launch_fwd(flash_fwd_mma_kernel<__nv_bfloat16, BF16, 128>, MmaCfg<__nv_bfloat16, 128>::kSmemBytes,
                      128, 64, batch, p, s);
  if (dtype == 2 && head_dim == 64)
    return launch_fwd(flash_fwd_mma_kernel<__half, F16, 64>, MmaCfg<__half, 64>::kSmemBytes, 128, 64, batch, p, s);
  if (dtype == 2 && head_dim == 128)
    return launch_fwd(flash_fwd_mma_kernel<__half, F16, 128>, MmaCfg<__half, 128>::kSmemBytes, 128, 64, batch, p,
                      s);
  return cudaErrorInvalidValue;
}

// Fill the parameters both entry points share.  strides: q, k, v, o, each
// (batch, head, row), in elements.
inline bool fill_fwd_params(FwdParams& p, int batch, int hq, int hkv, int lq, int lk, const long long* st,
                            float scale_log2, int causal, int window) {
  if (hkv <= 0 || hq % hkv != 0 || lq <= 0 || lk <= 0 || batch <= 0 || (p.q_ids == nullptr) != (p.kv_ids == nullptr))
    return false;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_sl = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_sl = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_sl = st[8];
  p.o_sb = st[9]; p.o_sh = st[10]; p.o_sl = st[11];
  p.hq = hq;
  p.group = hq / hkv;
  p.mask = Mask{lq, lk, causal, causal ? window : 0};
  p.scale_log2 = scale_log2;
  return true;
}

}  // namespace fa
