// One-token decode attention for Hopper (sm_90a): K5, the paged kernel
// (fa_paged_decode), and K6, the slot-major kernel (fa_fused_decode), two
// instantiations of one kernel template with a plain C interface loaded
// through ctypes (flash_attention_tpu_torch/kernels/_build.py).
//
// Replaces: flash_attention_tpu/inference/paged_attention.py::_paged_kernel
// (K5, launched by paged_attention) and
// flash_attention_tpu/inference/decode_attention.py::_fused_kernel (K6,
// launched by decode_attention_fused).  Both compute, for each sequence, the
// attention of its one new query row per q head over the sequence's first n
// cached tokens, with int8/fp8 payloads dequantized by one fp32 scale per
// token.  They differ in how a token's row is found: K5 reads the
// sequence's page-table row (page = table[t / page_size], row t % page_size
// of that page; no scalar prefetch), K6 reads slot-major rows of one layer
// [kv_heads, slots, max_len, D] through a base pointer and strides, so the
// layer's cache is read in place (no per-layer copy).  Numerics, as the TPU
// kernels:
//   * K5: s = (q . k) * sm_scale in fp32, then * k_scale; n = max(lengths, 1)
//     (paged_attention.py:187, :197, :371).
//   * K6: q pre-scaled by sm_scale and rounded to q's dtype, s = (q . k) *
//     k_scale; n = lengths + 1 (decode_attention.py:473, :527).
//   * Both: natural exp, an online softmax in fp32, p * v_scale rounded to
//     q's dtype before the PV product, V's payload read in q's dtype (exact
//     for int8 and fp8), one final division with the l == 0 guard.  The TPU
//     K6 rounds p to bf16 for an int8 cache and to fp8 for an fp8 cache
//     (pv_dtype, decode_attention.py:361); this port rounds it to q's dtype,
//     as the einsum path and K5 do.
// Lane packing for D < 128, the score-column-order scale layout and the
// parity-fold matmuls of the TPU kernels were layout rules of the TPU's
// (8, 128) tiles and have no counterpart here.
//
// What bounds it on this card: bytes.  A decode step reads each live
// token's K and V row once (at 8 slots x 12 heads x 512 live tokens x D 64
// int8, about 6.3 MB of payload and 0.4 MB of scales: 2 us at 3.35 TB/s),
// and does 4 FLOPs per element read, far below the card's balance point.
// What the design does about it:
//   * one thread block per (sequence, KV head) holds the whole GQA group's
//     query rows (in shared memory, fp32), so K and V are read once for the
//     group;
//   * warps split the sequence's tokens; within a warp, D / (16 / sizeof(KV))
//     lanes read one token's row with 16-byte loads, and each lane keeps
//     kUnroll tokens' K and V in flight before it computes;
//   * the loop stops at the sequence's length, so the bytes read track the
//     live context, not the cache's capacity;
//   * each lane group keeps its own (m, l, acc) over its tokens; they are
//     merged with shuffles inside the warp and through shared memory across
//     warps at the end.
// At the serving shapes a call is expected to be bound by launch latency
// and by the latency of the dependent loads of a short loop, not by the
// bytes; split-KV across blocks and cp.async pipelining are later work.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry points return cudaGetLastError() so that the wrapper can raise.

#include "common.cuh"

namespace {

using namespace fa;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // tokens each lane group has in flight
constexpr unsigned kFull = 0xffffffffu;

struct DecodeParams {
  const void* q;         // [batch, hq, D], last dim contiguous
  const void* k;         // payload: paged [hkv, pages, page_size, D] or slot-major [hkv, slots, max_len, D]
  const void* v;
  const float* ks;       // scales [hkv, pages or slots, rows], last stride 1; null unless quantized
  const float* vs;
  const int* lengths;    // [batch]
  const int* table;      // [batch, pages_per_seq] (K5) or null (K6)
  void* o;               // [batch, hq, D]
  long long q_sb, q_sh, o_sb, o_sh;
  long long k_sh, k_sp, k_sr, v_sh, v_sp, v_sr, s_sh, s_sp;
  int group, page_size, pages_per_seq, len_add;
  float q_scale, score_scale;
};

template <typename T, typename KV, int D, int kMaxG, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const DecodeParams p) {
  constexpr int kE = 16 / sizeof(KV);  // elements in one 16-byte load
  constexpr int kC = D / kE;           // lanes that read one token's row
  constexpr int kTPW = 32 / kC;        // tokens of a warp's step
  constexpr int kStep = kWarps * kTPW * kUnroll;
  constexpr bool kQuant = sizeof(KV) == 1;
  static_assert(kC <= 32 && 32 % kC == 0, "a token's row spans at most one warp");

  __shared__ float sQ[kMaxG][D];
  __shared__ float sM[kWarps][kMaxG];
  __shared__ float sL[kWarps][kMaxG];
  __shared__ float sAcc[kWarps][kMaxG][D];

  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int G = p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunk = lane % kC;  // which 16 bytes of a token's row
  const int sub = lane / kC;    // which token of the warp's step

  // The group's query rows in fp32, scaled by q_scale and rounded to T
  // (K6's pre-scaling; K5 passes 1, which leaves q as it is).
  const T* gq = static_cast<const T*>(p.q) + b * p.q_sb + (long long)hk * G * p.q_sh;
  for (int i = threadIdx.x; i < kMaxG * D; i += kThreads) {
    const int g = i / D, d = i % D;
    sQ[g][d] = g < G ? round_to<T>(to_float(gq[g * p.q_sh + d]) * p.q_scale) : 0.f;
  }
  __syncthreads();

  const int capacity = kPaged ? p.page_size * p.pages_per_seq : p.page_size;
  const int n = min(max(p.lengths[b] + p.len_add, 1), capacity);
  const KV* gk = static_cast<const KV*>(p.k) + hk * p.k_sh + chunk * kE;
  const KV* gv = static_cast<const KV*>(p.v) + hk * p.v_sh + chunk * kE;
  const float* gks = kQuant ? p.ks + hk * p.s_sh : nullptr;
  const float* gvs = kQuant ? p.vs + hk * p.s_sh : nullptr;
  const int* table = kPaged ? p.table + (long long)b * p.pages_per_seq : nullptr;

  float m[kMaxG], l[kMaxG], acc[kMaxG][kE];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = warp * kTPW * kUnroll; t0 < n; t0 += kStep) {
    uint4 kr[kUnroll], vr[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kTPW + sub;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      ksc[u] = vsc[u] = 0.f;
      if (t < n) {
        const int page = kPaged ? table[t / p.page_size] : b;
        const int row = kPaged ? t % p.page_size : t;
        kr[u] = *reinterpret_cast<const uint4*>(gk + page * p.k_sp + row * p.k_sr);
        vr[u] = *reinterpret_cast<const uint4*>(gv + page * p.v_sp + row * p.v_sr);
        if (kQuant) {
          ksc[u] = gks[page * p.s_sp + row];
          vsc[u] = gvs[page * p.s_sp + row];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = t0 + u * kTPW + sub < n;
      const KV* kx = reinterpret_cast<const KV*>(&kr[u]);
      const KV* vx = reinterpret_cast<const KV*>(&vr[u]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;  // G is uniform over the block: the shuffles stay converged
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) s = fmaf(sQ[g][chunk * kE + e], to_float(kx[e]), s);
#pragma unroll
        for (int off = kC / 2; off > 0; off /= 2) s += __shfl_xor_sync(kFull, s, off);
        s *= p.score_scale;
        if (kQuant) s *= ksc[u];
        if (!valid) continue;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);  // 0 while m[g] is -inf
        const float pe = expf(s - m_new);
        l[g] = l[g] * alpha + pe;
        const float pr = round_to<T>(kQuant ? pe * vsc[u] : pe);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(pr, to_float(vx[e]), acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

  // Merge the lane groups of the warp (lanes that differ in `sub`).
#pragma unroll
  for (int off = kC; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = m[g] == -CUDART_INF_F ? 0.f : expf(m[g] - mn);
      const float ao = mo == -CUDART_INF_F ? 0.f : expf(mo - mn);
      l[g] = l[g] * a + lo * ao;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] = acc[g][e] * a + __shfl_xor_sync(kFull, acc[g][e], off) * ao;
      m[g] = mn;
    }
  }
  if (lane < kC) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int e = 0; e < kE; ++e) sAcc[warp][g][chunk * kE + e] = acc[g][e];
      if (lane == 0) {
        sM[warp][g] = m[g];
        sL[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // Merge the warps and write the group's output rows.
  T* go = static_cast<T*>(p.o) + b * p.o_sb + (long long)hk * G * p.o_sh;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (sM[w][g] == -CUDART_INF_F) continue;
      const float a = expf(sM[w][g] - mx);
      lsum += sL[w][g] * a;
      o += sAcc[w][g][d] * a;
    }
    go[g * p.o_sh + d] = from_float<T>(o / (lsum == 0.f ? 1.f : lsum));
  }
}

template <typename T, typename KV, bool kPaged>
cudaError_t launch_group(const DecodeParams& p, int head_dim, dim3 grid, cudaStream_t s) {
  const int g = p.group;
  if (head_dim == 64) {
    if (g == 1) decode_kernel<T, KV, 64, 1, kPaged><<<grid, kThreads, 0, s>>>(p);
    else if (g <= 4) decode_kernel<T, KV, 64, 4, kPaged><<<grid, kThreads, 0, s>>>(p);
    else if (g <= 8) decode_kernel<T, KV, 64, 8, kPaged><<<grid, kThreads, 0, s>>>(p);
    else return cudaErrorInvalidValue;
  } else if (head_dim == 128) {
    if (g == 1) decode_kernel<T, KV, 128, 1, kPaged><<<grid, kThreads, 0, s>>>(p);
    else if (g <= 4) decode_kernel<T, KV, 128, 4, kPaged><<<grid, kThreads, 0, s>>>(p);
    else if (g <= 8) decode_kernel<T, KV, 128, 8, kPaged><<<grid, kThreads, 0, s>>>(p);
    else return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool kPaged>
int launch_decode(DecodeParams& p, int q_dtype, int kv_dtype, int batch, int hq, int hkv, int head_dim,
                  const long long* st, cudaStream_t s) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || p.page_size <= 0 || p.pages_per_seq <= 0 ||
      (kv_dtype != 0) != (p.ks != nullptr && p.vs != nullptr))
    return (int)cudaErrorInvalidValue;
  p.q_sb = st[0]; p.q_sh = st[1];
  p.o_sb = st[2]; p.o_sh = st[3];
  p.k_sh = st[4]; p.k_sp = st[5]; p.k_sr = st[6];
  p.v_sh = st[7]; p.v_sp = st[8]; p.v_sr = st[9];
  p.s_sh = st[10]; p.s_sp = st[11];
  p.group = hq / hkv;
  const dim3 grid(batch, hkv);
  if (q_dtype == 0) {
    if (kv_dtype == 0) return (int)launch_group<float, float, kPaged>(p, head_dim, grid, s);
    if (kv_dtype == 1) return (int)launch_group<float, int8_t, kPaged>(p, head_dim, grid, s);
    if (kv_dtype == 2) return (int)launch_group<float, __nv_fp8_e4m3, kPaged>(p, head_dim, grid, s);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return (int)launch_group<__nv_bfloat16, __nv_bfloat16, kPaged>(p, head_dim, grid, s);
    if (kv_dtype == 1) return (int)launch_group<__nv_bfloat16, int8_t, kPaged>(p, head_dim, grid, s);
    if (kv_dtype == 2) return (int)launch_group<__nv_bfloat16, __nv_fp8_e4m3, kPaged>(p, head_dim, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Common arguments.  q_dtype: 0 = float32, 1 = bfloat16.  kv_dtype: 0 = the
// payload is q's dtype (no scales), 1 = int8, 2 = float8_e4m3fn (both with
// k_scales / v_scales).  head_dim 64 or 128; hq / hkv <= 8.  strides
// (elements): q (batch, head), out (batch, head), k and v (head, page or
// slot, row), scales (head, page or slot); every last dim is contiguous and
// payload rows are 16-byte aligned.  Returns a cudaError_t (0 on success).

// K5.  lengths [batch] int32 count the current token; n = max(lengths +
// len_add, 1) tokens are read.  page_indices [batch, pages_per_seq] int32.
extern "C" int fa_paged_decode(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                               const void* v_scales, const void* lengths, const void* page_indices, void* out,
                               int q_dtype, int kv_dtype, int batch, int hq, int hkv, int head_dim,
                               int page_size, int pages_per_seq, int len_add, const long long* strides,
                               float sm_scale, void* stream) {
  DecodeParams p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.table = static_cast<const int*>(page_indices);
  p.o = out;
  p.page_size = page_size;
  p.pages_per_seq = pages_per_seq;
  p.len_add = len_add;
  p.q_scale = 1.f;
  p.score_scale = sm_scale;
  if (page_indices == nullptr) return (int)cudaErrorInvalidValue;
  return launch_decode<true>(p, q_dtype, kv_dtype, batch, hq, hkv, head_dim, strides,
                             static_cast<cudaStream_t>(stream));
}

// K6.  k / v are one layer of the slot-major cache, [hkv, slots, max_len,
// D]; lengths [slots] int32 exclude the current token (n = lengths + 1).
extern "C" int fa_fused_decode(const void* q, const void* k, const void* v, const void* k_scales,
                               const void* v_scales, const void* lengths, void* out, int q_dtype, int kv_dtype,
                               int slots, int hq, int hkv, int head_dim, int max_len, const long long* strides,
                               float sm_scale, void* stream) {
  DecodeParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.table = nullptr;
  p.o = out;
  p.page_size = max_len;
  p.pages_per_seq = 1;
  p.len_add = 1;
  p.q_scale = sm_scale;
  p.score_scale = 1.f;
  return launch_decode<false>(p, q_dtype, kv_dtype, slots, hq, hkv, head_dim, strides,
                              static_cast<cudaStream_t>(stream));
}
