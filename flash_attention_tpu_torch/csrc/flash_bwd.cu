// FlashAttention-2 backward for Hopper (sm_90a): dK/dV and dQ, with a plain
// C interface loaded through ctypes (flash_attention_tpu_torch/kernels/_build.py).
//
// Replaces, in flash_attention_tpu/kernels/flash_attention.py:
//   * fa_flash_bwd_dkv: _dkv_kernel (launched by _bwd_dkv through
//     pl.pallas_call): dV = P^T dO and dK = dS^T (q * scale) with
//     dS = P o (dO V^T - di), the KV tile pinned and the q tiles iterated;
//   * fa_flash_bwd_dq: _dq_kernel (launched by _bwd_dq): dQ = dS (k * scale),
//     the q tile pinned and the KV tiles iterated.
// Both recompute P as the forward made it (_recompute_p): exp2(qs K^T -
// lse * log2(e)) with qs = q * sm_scale * log2(e) rounded to q's dtype, so P
// equals flash_fwd.cu's.  Then, as on the TPU: P is rounded to dO's dtype
// before P^T dO; dS is rounded to the inputs' dtype before each product;
// q * scale and k * scale are rounded to their dtype; every sum is fp32.
// di = rowsum(o * dO) (minus the lse cotangent) comes from the wrapper, as
// JAX computes it outside its kernels.  Masked entries get P = 0 outright,
// so a query row that sees no key (lse = -inf) gives no NaN.
//
// On the TPU the grid ran in order and carried dK/dV (or dQ) in scratch from
// one step to the next.  On Hopper blocks run in parallel, so the loop moves
// inside the block and the sums stay in registers:
//   * dK/dV: one thread block per (batch * kv head, 64 KV rows); each warp
//     owns 16 KV rows and computes S^T = K qs^T, so that P^T is already the
//     A operand of dV += P^T dO (as P is in the forward's P V) and dS^T the
//     A operand of dK += dS^T q.  The block walks the q tiles that the
//     causal rule and the window admit, for each of the G query heads of its
//     GQA group in turn: the group sums into its KV head inside the block,
//     with no atomics and no [B, Hq, Lk, D] scratch, in a fixed order.
//   * dQ: one thread block per (batch * q head, 64 q rows); the KV loop
//     runs over the tiles K1 visits.
// Two kernels keep the result deterministic; fusing them with atomic dQ is
// a choice to measure later.
//
// What bounds it on this card: the backward does 2.5x the forward's matrix
// work (five products instead of two, K2 and K3 each recomputing P) on the
// same bytes, so at the GPT-2 train shape (D = 64, L = 1024) it is
// compute-bound in principle.  Like K1 this first version feeds the tensor
// cores with warp-level mma.sync m16n8k16 from tiles staged in shared
// memory by 16-byte loads, with no overlap of loads and math, and reaches
// a fraction of the card's rate; wgmma, TMA and warp specialisation are
// later work.  Registers are the scarce resource: dK and dV of 16 rows take
// 2 x D/2 fp32 registers a thread, so K and V fragments are re-read from
// shared memory per q tile instead of being held in registers.  ptxas -v
// (sm_90a, CUDA 12.8) gives, with no spills: dK/dV 168 registers at D = 64
// and 252 at D = 128; dQ 128 and 168.  Five 64-row tiles of shared memory
// (45 KB at D = 64, 85 KB at D = 128) leave room for two or more blocks on
// an SM at D = 64.
// fp32 inputs take a SIMT path (one thread per pinned row, fp32 FMA), since
// TF32 tensor cores would miss the fp32 backward tolerance of 1e-4.  Its
// dK/dV keeps 2 x D fp32 sums a thread and spills at D = 128 (255
// registers, 168 bytes); dQ uses 128 / 166 registers without spills.
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry points return cudaGetLastError() so that the wrapper can raise.

#include "common.cuh"

namespace {

using namespace fa;

struct Strides {
  long long sb, sh, sl;
};

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // [batch, hq, lq] contiguous
  const float* di;    // [batch, hq, lq] contiguous
  const int* q_ids;   // [batch, lq] contiguous segment ids, or null
  const int* kv_ids;  // [batch, lk], null exactly when q_ids is
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int hq, group;
  Mask mask;
  float scale_log2;  // sm_scale * log2(e)
  float scale;       // sm_scale
};

template <typename T, int D>
struct BwdMmaCfg {
  static constexpr int kBr = 64;  // the block's pinned rows: 4 warps x 16
  static constexpr int kBc = 64;  // rows of each tile the loop walks
  static constexpr int kThreads = 128;
  static constexpr int kLds = D + 8;  // padded row: spreads rows over banks
  static constexpr int kSmemBytes = 5 * 64 * kLds * sizeof(T);  // five tiles
};

// Scores of one warp's 16 pinned rows against a 64-row tile:
// s[nb] += A[16, D] B[64, D]^T, A and B row-major in shared memory.
template <typename T, int D, int LDS>
__device__ __forceinline__ void scores(float (&s)[8][4], const T* a, const T* b, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    load_a<T>(af, a + ks * 16, LDS, g, t);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      uint32_t b0, b1;
      load_b_t<T>(b0, b1, b + nb * 8 * LDS + ks * 16, LDS, g, t);
      mma16816<T>(s[nb], af, b0, b1);
    }
  }
}

// acc[16, D] += W[16, 64] X[64, D]: W in registers as the fp32 layout of
// scores(), rounded to T; X row-major in shared memory.
template <typename T, int D, int LDS>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&w)[8][4], const T* x,
                                           int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t wa[4];
    wa[0] = Pack<T>::two(w[2 * kk][0], w[2 * kk][1]);
    wa[1] = Pack<T>::two(w[2 * kk][2], w[2 * kk][3]);
    wa[2] = Pack<T>::two(w[2 * kk + 1][0], w[2 * kk + 1][1]);
    wa[3] = Pack<T>::two(w[2 * kk + 1][2], w[2 * kk + 1][3]);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      uint32_t b0, b1;
      load_b<T>(b0, b1, x + kk * 16 * LDS + nd * 8, LDS, g, t);
      mma16816<T>(acc[nd], wa, b0, b1);
    }
  }
}

// Store a warp's 16 x D fp32 accumulator as T, rows from row_a (and + 8)
// that lie below n.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long ld, const float (&acc)[D / 8][4], int row_a,
                                           int n, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n) continue;
    T* dst = base + (long long)row * ld + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) = Pack<T>::two(acc[nd][2 * r], acc[nd][2 * r + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_mma_kernel(const BwdParams p) {
  using C = BwdMmaCfg<T, D>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kLds = C::kLds, kND = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kBr * kLds;
  T* sQs = sV + kBr * kLds;   // q * scale * log2(e): the scores' B operand
  T* sQk = sQs + kBc * kLds;  // q * scale: dK's B operand
  T* sDo = sQk + kBc * kLds;
  __shared__ float sLse[kBc], sDi[kBc];
  __shared__ int sQIds[kBc], sKvIds[kBr];

  const Mask mk = p.mask;
  const int hkv = p.hq / p.group;
  const int b = blockIdx.y / hkv;
  const int hk = blockIdx.y % hkv;
  const int c0 = blockIdx.x * kBr;
  const int c1 = min(c0 + kBr, mk.lk);
  const bool segmented = p.q_ids != nullptr;

  const T* gk = static_cast<const T*>(p.k) + b * p.sk.sb + hk * p.sk.sh;
  const T* gv = static_cast<const T*>(p.v) + b * p.sv.sb + hk * p.sv.sh;
  load_tile<T, kBr, D, kLds, C::kThreads>(sK, gk, p.sk.sl, c0, mk.lk);
  load_tile<T, kBr, D, kLds, C::kThreads>(sV, gv, p.sv.sl, c0, mk.lk);
  if (segmented) load_ids<kBr, C::kThreads>(sKvIds, p.kv_ids + (long long)b * mk.lk, c0, mk.lk, 0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kv_a = c0 + warp * 16 + g;  // this thread's KV rows: kv_a, kv_a + 8
  const T* wK = sK + warp * 16 * kLds;
  const T* wV = sV + warp * 16 * kLds;

  float dk[kND][4], dv[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  const int i0 = mk.q_first(c0) / kBc;
  const int q_end = mk.q_end(c1);
  const int n_q = q_end > 0 ? (q_end + kBc - 1) / kBc : 0;

  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const T* gq = static_cast<const T*>(p.q) + b * p.sq.sb + h * p.sq.sh;
    const T* gdo = static_cast<const T*>(p.dout) + b * p.sdo.sb + h * p.sdo.sh;
    const long long stat = ((long long)b * p.hq + h) * mk.lq;
    for (int it = i0; it < n_q; ++it) {
      const int r0 = it * kBc;
      __syncthreads();  // previous tile fully consumed
      load_tile_scaled2<T, kBc, D, kLds, C::kThreads>(sQs, p.scale_log2, sQk, p.scale, gq, p.sq.sl, r0, mk.lq);
      load_tile<T, kBc, D, kLds, C::kThreads>(sDo, gdo, p.sdo.sl, r0, mk.lq);
      for (int i = threadIdx.x; i < kBc; i += C::kThreads) {
        const bool in = r0 + i < mk.lq;
        sLse[i] = in ? p.lse[stat + r0 + i] : 0.f;
        sDi[i] = in ? p.di[stat + r0 + i] : 0.f;
      }
      if (segmented) load_ids<kBc, C::kThreads>(sQIds, p.q_ids + (long long)b * mk.lq, r0, mk.lq, 0);
      __syncthreads();

      // P^T = exp2(K qs^T - lse * log2 e): rows are KV, columns are q.
      float pt[8][4];
      scores<T, D, kLds>(pt, wK, sQs, g, t);
      const bool full = !segmented && mk.tile_visible(r0, kBc, c0, kBr);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nb * 8 + 2 * t + (e & 1);
          const int kv = kv_a + 8 * (e >> 1);
          const bool ok = full || (mk.visible(r0 + ql, kv) &&
                                   (!segmented || sQIds[ql] == sKvIds[kv - c0]));
          pt[nb][e] = ok ? exp2f(pt[nb][e] - sLse[ql] * kLog2e) : 0.f;
        }

      // dV += P^T dO, P rounded to dO's dtype.
      accumulate<T, D, kLds>(dv, pt, sDo, g, t);

      // dP^T = V dO^T, then dS^T = P^T o (dP^T - di) in place.
      float ds[8][4];
      scores<T, D, kLds>(ds, wV, sDo, g, t);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[nb][e] = pt[nb][e] * (ds[nb][e] - sDi[nb * 8 + 2 * t + (e & 1)]);

      // dK += dS^T (q * scale), dS rounded to q's dtype.
      accumulate<T, D, kLds>(dk, ds, sQk, g, t);
    }
  }

  store_rows<T, D>(static_cast<T*>(p.dk) + b * p.sdk.sb + hk * p.sdk.sh, p.sdk.sl, dk, kv_a, mk.lk, t);
  store_rows<T, D>(static_cast<T*>(p.dv) + b * p.sdv.sb + hk * p.sdv.sh, p.sdv.sl, dv, kv_a, mk.lk, t);
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma_kernel(const BwdParams p) {
  using C = BwdMmaCfg<T, D>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kLds = C::kLds, kND = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQs = reinterpret_cast<T*>(smem_raw);  // q * scale * log2(e)
  T* sDo = sQs + kBr * kLds;
  T* sK = sDo + kBr * kLds;
  T* sKs = sK + kBc * kLds;  // k * scale: dQ's B operand
  T* sV = sKs + kBc * kLds;
  __shared__ int sKvIds[kBc];

  const Mask mk = p.mask;
  const int b = blockIdx.y / p.hq;
  const int h = blockIdx.y % p.hq;
  const int hk = h / p.group;
  const int r0 = blockIdx.x * kBr;
  const int r1 = min(r0 + kBr, mk.lq);
  const bool segmented = p.q_ids != nullptr;

  const T* gq = static_cast<const T*>(p.q) + b * p.sq.sb + h * p.sq.sh;
  const T* gdo = static_cast<const T*>(p.dout) + b * p.sdo.sb + h * p.sdo.sh;
  const T* gk = static_cast<const T*>(p.k) + b * p.sk.sb + hk * p.sk.sh;
  const T* gv = static_cast<const T*>(p.v) + b * p.sv.sb + hk * p.sv.sh;
  load_tile_scaled2<T, kBr, D, kLds, C::kThreads>(sQs, p.scale_log2, nullptr, 0.f, gq, p.sq.sl, r0, mk.lq);
  load_tile<T, kBr, D, kLds, C::kThreads>(sDo, gdo, p.sdo.sl, r0, mk.lq);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_a = r0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8
  const long long stat = ((long long)b * p.hq + h) * mk.lq;
  float lse_l2[2], di[2];
  int q_id[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool in = row < mk.lq;
    lse_l2[r] = in ? p.lse[stat + row] * kLog2e : 0.f;
    di[r] = in ? p.di[stat + row] : 0.f;
    if (segmented && in) q_id[r] = p.q_ids[(long long)b * mk.lq + row];
  }
  const T* wQ = sQs + warp * 16 * kLds;
  const T* wDo = sDo + warp * 16 * kLds;

  float dq[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;

  const int kv_end = mk.kv_end(r1);
  const int j0 = mk.kv_first(r0) / kBc;
  const int n_tiles = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;

  for (int jt = j0; jt < n_tiles; ++jt) {
    const int c0 = jt * kBc;
    __syncthreads();  // previous tile (or the q staging) fully consumed
    load_tile_scaled2<T, kBc, D, kLds, C::kThreads>(sK, 1.f, sKs, p.scale, gk, p.sk.sl, c0, mk.lk);
    load_tile<T, kBc, D, kLds, C::kThreads>(sV, gv, p.sv.sl, c0, mk.lk);
    if (segmented) load_ids<kBc, C::kThreads>(sKvIds, p.kv_ids + (long long)b * mk.lk, c0, mk.lk, 0);
    __syncthreads();

    // P = exp2(qs K^T - lse * log2 e)
    float pr[8][4];
    scores<T, D, kLds>(pr, wQ, sK, g, t);
    const bool full = !segmented && mk.tile_visible(r0, kBr, c0, kBc);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int cl = nb * 8 + 2 * t + (e & 1);
        const bool ok = full || (mk.visible(row_a + 8 * r, c0 + cl) && (!segmented || q_id[r] == sKvIds[cl]));
        pr[nb][e] = ok ? exp2f(pr[nb][e] - lse_l2[r]) : 0.f;
      }

    // dP = dO V^T, then dS = P o (dP - di) in place.
    float ds[8][4];
    scores<T, D, kLds>(ds, wDo, sV, g, t);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nb][e] = pr[nb][e] * (ds[nb][e] - di[e >> 1]);

    // dQ += dS (k * scale), dS rounded to k's dtype.
    accumulate<T, D, kLds>(dq, ds, sKs, g, t);
  }

  store_rows<T, D>(static_cast<T*>(p.dq) + b * p.sdq.sb + h * p.sdq.sh, p.sdq.sl, dq, row_a, mk.lq, t);
}

// ---------------------------------------------------------------------------
// fp32 path: SIMT, one thread per pinned row, fp32 FMA
// ---------------------------------------------------------------------------

template <int D>
struct BwdSimtCfg {
  static constexpr int kBr = 64;  // pinned rows, one per thread
  static constexpr int kBc = 32;  // rows of each tile the loop walks
  static constexpr int kThreads = kBr;
  static constexpr int kLdr = D + 1;  // odd stride: row-per-thread reads hit distinct banks
  static constexpr int kSmemBytes = (2 * kBr * kLdr + 3 * kBc * D) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(64)
flash_bwd_dkv_simt_kernel(const BwdParams p) {
  using C = BwdSimtCfg<D>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kLdr = C::kLdr;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kBr * kLdr;
  float* sQs = sV + kBr * kLdr;
  float* sQk = sQs + kBc * D;
  float* sDo = sQk + kBc * D;
  __shared__ float sLse[kBc], sDi[kBc];
  __shared__ int sQIds[kBc];

  const Mask mk = p.mask;
  const int hkv = p.hq / p.group;
  const int b = blockIdx.y / hkv;
  const int hk = blockIdx.y % hkv;
  const int c0 = blockIdx.x * kBr;
  const int c1 = min(c0 + kBr, mk.lk);
  const bool segmented = p.q_ids != nullptr;

  const float* gk = static_cast<const float*>(p.k) + b * p.sk.sb + hk * p.sk.sh;
  const float* gv = static_cast<const float*>(p.v) + b * p.sv.sb + hk * p.sv.sh;
  load_tile_f32<kBr, D, kLdr, C::kThreads>(sK, gk, p.sk.sl, c0, mk.lk, 1.f);
  load_tile_f32<kBr, D, kLdr, C::kThreads>(sV, gv, p.sv.sl, c0, mk.lk, 1.f);

  const int kv = c0 + threadIdx.x;
  const int kv_id = segmented && kv < mk.lk ? p.kv_ids[(long long)b * mk.lk + kv] : 0;
  const float* kr = sK + threadIdx.x * kLdr;
  const float* vr = sV + threadIdx.x * kLdr;
  float dk[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) dk[c] = dv[c] = 0.f;

  const int i0 = mk.q_first(c0) / kBc;
  const int q_end = mk.q_end(c1);
  const int n_q = q_end > 0 ? (q_end + kBc - 1) / kBc : 0;

  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const float* gq = static_cast<const float*>(p.q) + b * p.sq.sb + h * p.sq.sh;
    const float* gdo = static_cast<const float*>(p.dout) + b * p.sdo.sb + h * p.sdo.sh;
    const long long stat = ((long long)b * p.hq + h) * mk.lq;
    for (int it = i0; it < n_q; ++it) {
      const int r0 = it * kBc;
      __syncthreads();
      load_tile_f32<kBc, D, D, C::kThreads>(sQs, gq, p.sq.sl, r0, mk.lq, p.scale_log2);
      load_tile_f32<kBc, D, D, C::kThreads>(sQk, gq, p.sq.sl, r0, mk.lq, p.scale);
      load_tile_f32<kBc, D, D, C::kThreads>(sDo, gdo, p.sdo.sl, r0, mk.lq, 1.f);
      for (int i = threadIdx.x; i < kBc; i += C::kThreads) {
        const bool in = r0 + i < mk.lq;
        sLse[i] = in ? p.lse[stat + r0 + i] : 0.f;
        sDi[i] = in ? p.di[stat + r0 + i] : 0.f;
      }
      if (segmented) load_ids<kBc, C::kThreads>(sQIds, p.q_ids + (long long)b * mk.lq, r0, mk.lq, 0);
      __syncthreads();

      for (int j = 0; j < kBc; ++j) {
        if (!mk.visible(r0 + j, kv) || (segmented && sQIds[j] != kv_id)) continue;
        const float* qs = sQs + j * D;
        const float* dor = sDo + j * D;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) {
          s = fmaf(qs[c], kr[c], s);
          dp = fmaf(dor[c], vr[c], dp);
        }
        const float pj = exp2f(s - sLse[j] * kLog2e);
        const float ds = pj * (dp - sDi[j]);
        const float* qk = sQk + j * D;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          dv[c] = fmaf(pj, dor[c], dv[c]);
          dk[c] = fmaf(ds, qk[c], dk[c]);
        }
      }
    }
  }

  if (kv < mk.lk) {
    float* dkr = static_cast<float*>(p.dk) + b * p.sdk.sb + hk * p.sdk.sh + (long long)kv * p.sdk.sl;
    float* dvr = static_cast<float*>(p.dv) + b * p.sdv.sb + hk * p.sdv.sh + (long long)kv * p.sdv.sl;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dkr[c] = dk[c];
      dvr[c] = dv[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(64)
flash_bwd_dq_simt_kernel(const BwdParams p) {
  using C = BwdSimtCfg<D>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kLdr = C::kLdr;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQs = reinterpret_cast<float*>(smem_raw);
  float* sDo = sQs + kBr * kLdr;
  float* sK = sDo + kBr * kLdr;
  float* sKs = sK + kBc * D;
  float* sV = sKs + kBc * D;
  __shared__ int sKvIds[kBc];

  const Mask mk = p.mask;
  const int b = blockIdx.y / p.hq;
  const int h = blockIdx.y % p.hq;
  const int hk = h / p.group;
  const int r0 = blockIdx.x * kBr;
  const int r1 = min(r0 + kBr, mk.lq);
  const bool segmented = p.q_ids != nullptr;

  const float* gq = static_cast<const float*>(p.q) + b * p.sq.sb + h * p.sq.sh;
  const float* gdo = static_cast<const float*>(p.dout) + b * p.sdo.sb + h * p.sdo.sh;
  const float* gk = static_cast<const float*>(p.k) + b * p.sk.sb + hk * p.sk.sh;
  const float* gv = static_cast<const float*>(p.v) + b * p.sv.sb + hk * p.sv.sh;
  load_tile_f32<kBr, D, kLdr, C::kThreads>(sQs, gq, p.sq.sl, r0, mk.lq, p.scale_log2);
  load_tile_f32<kBr, D, kLdr, C::kThreads>(sDo, gdo, p.sdo.sl, r0, mk.lq, 1.f);

  const int row = r0 + threadIdx.x;
  const bool in = row < mk.lq;
  const long long stat = ((long long)b * p.hq + h) * mk.lq;
  const float lse_l2 = in ? p.lse[stat + row] * kLog2e : 0.f;
  const float di = in ? p.di[stat + row] : 0.f;
  const int q_id = segmented && in ? p.q_ids[(long long)b * mk.lq + row] : 0;
  const float* qs = sQs + threadIdx.x * kLdr;
  const float* dor = sDo + threadIdx.x * kLdr;
  float dq[D];
#pragma unroll
  for (int c = 0; c < D; ++c) dq[c] = 0.f;

  const int kv_end = mk.kv_end(r1);
  const int j0 = mk.kv_first(r0) / kBc;
  const int n_tiles = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;

  for (int jt = j0; jt < n_tiles; ++jt) {
    const int c0 = jt * kBc;
    __syncthreads();
    load_tile_f32<kBc, D, D, C::kThreads>(sK, gk, p.sk.sl, c0, mk.lk, 1.f);
    load_tile_f32<kBc, D, D, C::kThreads>(sKs, gk, p.sk.sl, c0, mk.lk, p.scale);
    load_tile_f32<kBc, D, D, C::kThreads>(sV, gv, p.sv.sl, c0, mk.lk, 1.f);
    if (segmented) load_ids<kBc, C::kThreads>(sKvIds, p.kv_ids + (long long)b * mk.lk, c0, mk.lk, 0);
    __syncthreads();

    for (int j = 0; j < kBc; ++j) {
      if (!mk.visible(row, c0 + j) || (segmented && sKvIds[j] != q_id)) continue;
      const float* kr = sK + j * D;
      const float* vr = sV + j * D;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) {
        s = fmaf(qs[c], kr[c], s);
        dp = fmaf(dor[c], vr[c], dp);
      }
      const float ds = exp2f(s - lse_l2) * (dp - di);
      const float* ks = sKs + j * D;
#pragma unroll
      for (int c = 0; c < D; ++c) dq[c] = fmaf(ds, ks[c], dq[c]);
    }
  }

  if (in) {
    float* dqr = static_cast<float*>(p.dq) + b * p.sdq.sb + h * p.sdq.sh + (long long)row * p.sdq.sl;
#pragma unroll
    for (int c = 0; c < D; ++c) dqr[c] = dq[c];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int threads, int rows, int len, int heads, int batch,
                   const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((len + rows - 1) / rows, batch * heads);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// which: 0 = dK/dV (grid over KV tiles and KV heads), 1 = dQ (grid over q
// tiles and q heads).
template <int D>
cudaError_t dispatch(int which, int dtype, int batch, const BwdParams& p, cudaStream_t s) {
  const int hkv = p.hq / p.group;
  if (dtype == 0) {
    using C = BwdSimtCfg<D>;
    return which == 0
        ? launch(flash_bwd_dkv_simt_kernel<D>, C::kSmemBytes, C::kThreads, C::kBr, p.mask.lk, hkv, batch, p, s)
        : launch(flash_bwd_dq_simt_kernel<D>, C::kSmemBytes, C::kThreads, C::kBr, p.mask.lq, p.hq, batch, p, s);
  }
  if (dtype == 1) {
    using C = BwdMmaCfg<__nv_bfloat16, D>;
    return which == 0
        ? launch(flash_bwd_dkv_mma_kernel<__nv_bfloat16, D>, C::kSmemBytes, C::kThreads, C::kBr, p.mask.lk, hkv,
                 batch, p, s)
        : launch(flash_bwd_dq_mma_kernel<__nv_bfloat16, D>, C::kSmemBytes, C::kThreads, C::kBr, p.mask.lq, p.hq,
                 batch, p, s);
  }
  if (dtype == 2) {
    using C = BwdMmaCfg<__half, D>;
    return which == 0
        ? launch(flash_bwd_dkv_mma_kernel<__half, D>, C::kSmemBytes, C::kThreads, C::kBr, p.mask.lk, hkv, batch,
                 p, s)
        : launch(flash_bwd_dq_mma_kernel<__half, D>, C::kSmemBytes, C::kThreads, C::kBr, p.mask.lq, p.hq, batch,
                 p, s);
  }
  return cudaErrorInvalidValue;
}

int run(int which, const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* di, const void* q_ids, const void* kv_ids, void* dq, void* dk, void* dv, int dtype,
        int batch, int hq, int hkv, int lq, int lk, int head_dim, const long long* strides, float scale,
        float scale_log2, int causal, int window, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || lq <= 0 || lk <= 0 || batch <= 0 || (q_ids == nullptr) != (kv_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.q_ids = static_cast<const int*>(q_ids);
  p.kv_ids = static_cast<const int*>(kv_ids);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  Strides* st[7] = {&p.sq, &p.sk, &p.sv, &p.sdo, &p.sdq, &p.sdk, &p.sdv};
  for (int i = 0; i < 7; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.hq = hq;
  p.group = hq / hkv;
  p.mask = Mask{lq, lk, causal, causal ? window : 0};
  p.scale = scale;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)dispatch<64>(which, dtype, batch, p, s);
  if (head_dim == 128) return (int)dispatch<128>(which, dtype, batch, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  head_dim: 64 or 128.
// lse and di are fp32 [batch, hq, lq] contiguous (lse as flash_fwd wrote
// it).  q_ids / kv_ids are both null or both contiguous int32 [batch, lq]
// and [batch, lk].  strides: 21 values, (batch, head, row) strides in
// elements of q, k, v, dout, dq, dk, dv in that order (the last dim of each
// is contiguous; the entries of an output the call does not write are
// ignored).  scale is sm_scale, scale_log2 sm_scale * log2(e) as flash_fwd
// took it.  window <= 0 means no window.  Returns a cudaError_t (0 on
// success), or cudaErrorInvalidValue for a dtype or head dim the kernels do
// not instantiate.
extern "C" int fa_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, const void* q_ids, const void* kv_ids,
                                void* dk, void* dv, int dtype, int batch, int hq, int hkv, int lq, int lk,
                                int head_dim, const long long* strides, float scale, float scale_log2,
                                int causal, int window, void* stream) {
  return run(0, q, k, v, dout, lse, di, q_ids, kv_ids, nullptr, dk, dv, dtype, batch, hq, hkv, lq, lk,
             head_dim, strides, scale, scale_log2, causal, window, stream);
}

extern "C" int fa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, const void* q_ids, const void* kv_ids,
                               void* dq, int dtype, int batch, int hq, int hkv, int lq, int lk,
                               int head_dim, const long long* strides, float scale, float scale_log2,
                               int causal, int window, void* stream) {
  return run(1, q, k, v, dout, lse, di, q_ids, kv_ids, dq, nullptr, nullptr, dtype, batch, hq, hkv, lq, lk,
             head_dim, strides, scale, scale_log2, causal, window, stream);
}
