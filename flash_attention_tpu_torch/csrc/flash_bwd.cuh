// The warp-specialised TMA + wgmma backward kernels for bf16 / fp16 (K2
// dK/dV and K3 dQ at head dims 64, 128 and 256) and the parameters every
// backward kernel reads.  flash_bwd.cu instantiates them at 64 and 128
// beside the pre-pass, the fp32 kernels (flash_bwd_fp32.cuh) and the C
// entry points;
// flash_bwd_d256.cu instantiates both at 256 in a source of its own,
// flash_bwd_wide.cu / flash_bwd_wide_d1024.cu the wide kernels at 512 and
// 1024 (flash_bwd_wide.cuh), and flash_bwd_fp32_wide.cu /
// flash_bwd_fp32_wide_d1024.cu the fp32 kernels at 256, 512 and 1024
// (flash_bwd_fp32_wide.cuh).
// The design notes are at the top of flash_bwd.cu.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace fa {

struct Strides {
  long long sb, sh, sl;
};

struct BwdParams {
  const void* q;
  const void* qs;     // bf16 / fp16: the pre-pass's qs, [batch, hq, lq, D] contiguous
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
  int batch, hq, group;
  Mask mask;
  float scale_log2;  // sm_scale * log2(e)
  float scale;       // sm_scale
};

// BwdParams from the C entry points' arguments (their order is
// fa_flash_bwd_dkv's); false for arguments no kernel takes.
inline bool fill_bwd_params(BwdParams& p, const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, const void* qs, const void* q_ids, const void* kv_ids,
                            void* dq, void* dk, void* dv, int batch, int hq, int hkv, int lq, int lk,
                            const long long* strides, float scale, float scale_log2, int causal, int window) {
  if (hkv <= 0 || hq % hkv != 0 || lq <= 0 || lk <= 0 || batch <= 0 || (q_ids == nullptr) != (kv_ids == nullptr))
    return false;
  p.q = q;
  p.qs = qs;
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
  p.batch = batch;
  p.hq = hq;
  p.group = hq / hkv;
  p.mask = Mask{lq, lk, causal, causal ? window : 0};
  p.scale = scale;
  p.scale_log2 = scale_log2;
  return true;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the warp-specialised TMA + wgmma kernels
// ---------------------------------------------------------------------------

// setmaxnreg for a block of one producer and two consumer warpgroups:
// 128 x 24 + 256 x 240 = 65,536 registers.  A block with one consumer
// warpgroup (D = 256) has 255 a thread and sets none.
constexpr int kBwdProducerRegs = 24;
constexpr int kBwdConsumerRegs = 240;

// K3: qs and dO pinned; the ring's K and V slots; the KV segment ids of each
// slot; the barriers; + 1024 to align the base for the 128-byte swizzle.
// kernels/block_sizes.py mirrors the constants and both layouts
// (backward_smem_bytes).
template <int D>
struct DqCfg {
  static_assert(D == 64 || D == 128 || D == 256, "head dims 64, 128 and 256");
  // At D = 256 the dQ accumulator alone is 128 registers a thread, past the
  // 168 that ptxas allocates a consumer of a 384-thread block whatever
  // setmaxnreg grants: the block is one consumer warpgroup of 64 pinned q
  // rows beside the producer warpgroup (256 threads, 255 registers a
  // thread, no setmaxnreg), and two 64 KB ring slots of 64-row K/V tiles
  // fit beside the 64 KB of pinned qs and dO.  (32-row tiles in four slots
  // took 230 registers against 220 and ran 21% slower; PERF.md has both.)
  static constexpr int kConsumers = D == 256 ? 1 : 2;  // consumer warpgroups, 64 pinned q rows each
  static constexpr int kPinned = 64 * kConsumers;      // q rows of a block
  static constexpr int kStream = 64;                   // KV rows of each streamed tile
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPinnedBytes = kPinned * D * 2;  // one pinned operand
  static constexpr int kTileBytes = kStream * D * 2;    // one streamed operand in one slot
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kOffDo = kPinnedBytes;  // qs at 0
  static constexpr int kOffK = 2 * kPinnedBytes;
  static constexpr int kOffV = kOffK + kStages * kTileBytes;
  static constexpr int kOffIds = kOffV + kStages * kTileBytes;
  static constexpr int kOffBars = kOffIds + kStages * kStream * 4;
  static constexpr int kBars = 1 + 2 * kStages;  // q; full and empty per slot
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
};

// K2: K and V pinned; the ring's qs, q and dO slots; per slot the q rows'
// lse * log2(e), di and segment ids; the barriers; the alignment slack.
template <int D>
struct DkvCfg {
  static_assert(D == 64 || D == 128 || D == 256, "head dims 64, 128 and 256");
  // At D = 128 a consumer thread cannot hold dK and dV (128 registers) with
  // S^T and dP^T (64) without spilling: the block walks its q tiles twice,
  // dV in the first pass (S^T, P^T, dV += P^T dO; no q tile loaded) and dK
  // in the second (S^T, dP^T, dS^T, dK += dS^T q), five products a tile
  // pair instead of four.  At D = 256 one accumulator alone is 128
  // registers, past what a consumer of a 384-thread block keeps (ptxas
  // allocates it the 168 of the launch, not what setmaxnreg grants): the
  // block has one consumer warpgroup of 64 pinned KV rows and a producer
  // warpgroup (256 threads, 255 registers a thread, no setmaxnreg), walks
  // twice as at 128, and streams 32-row q tiles, so that S^T and dP^T take
  // 16 registers each and three ring slots fit beside the pinned K and V.
  static constexpr int kConsumers = D == 256 ? 1 : 2;  // consumer warpgroups, 64 pinned KV rows each
  static constexpr int kPinned = 64 * kConsumers;      // KV rows of a block
  static constexpr int kStream = D == 256 ? 32 : 64;   // q rows of each streamed tile
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPinnedBytes = kPinned * D * 2;  // one pinned operand
  static constexpr int kTileBytes = kStream * D * 2;    // one streamed operand in one slot
  static constexpr int kPasses = D == 64 ? 1 : 2;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kOffV = kPinnedBytes;  // K at 0
  static constexpr int kOffQs = 2 * kPinnedBytes;
  static constexpr int kOffQ = kOffQs + kStages * kTileBytes;
  static constexpr int kOffDo = kOffQ + kStages * kTileBytes;
  static constexpr int kOffStats = kOffDo + kStages * kTileBytes;
  static constexpr int kStatBytes = 3 * kStream * 4;
  static constexpr int kOffBars = kOffStats + kStages * kStatBytes;
  static constexpr int kBars = 1 + 2 * kStages;  // K/V; full and empty per slot
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
};

struct BwdMaps {
  CUtensorMap qs, q, dout, k, v;  // K3 does not read q
};

// Descriptor of k16 step kk of a K-major operand: the 64 rows from `row0` of
// a [rows, D] tile stored as TMA's 128-byte swizzle writes it (64-column
// blocks one after the other, `rows` rows of 128 bytes each).  A step moves
// 32 bytes along a row, every fourth one to the next 64-column block.
template <typename T>
__device__ __forceinline__ uint64_t desc_k(const T* tile, int rows, int row0, int kk) {
  return sm90::smem_desc(tile + (kk / 4) * rows * 64 + row0 * 64 + (kk % 4) * 16, 16, 1024);
}

// Descriptor of k16 step kk of an MN-major B operand, a [rows, D] tile read
// as [K = rows, N = D]: a step moves 16 rows (2 KB) down its 64-column
// blocks, which lie rows * 128 bytes apart.
template <typename T>
__device__ __forceinline__ uint64_t desc_mn(const T* tile, int rows, int kk) {
  return sm90::smem_desc(tile + kk * 16 * 64, rows * 128, 1024);
}

// k16 steps of an SS product committed together: one 64-column block of the
// head dim, so that a group's descriptors take 16 registers a thread at any
// head dim (K2 at D = 128 has none to spare).
constexpr int kSsGroupSteps = 4;

// Issue d = A B^T over the head dim (SS form, both operands K-major): A the
// 64 rows from `a_row0` of the [a_rows, D] tile `a`, B the [N, D] tile `b`.
// Committed in groups of kSsGroupSteps steps; the caller waits.
template <typename T, int D, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], const T* a, int a_rows, int a_row0, const T* b) {
  constexpr int kG = kSsGroupSteps < D / 16 ? kSsGroupSteps : D / 16;
#pragma unroll
  for (int k0 = 0; k0 < D / 16; k0 += kG) {
    uint64_t da[kG], db[kG];
#pragma unroll
    for (int kk = 0; kk < kG; ++kk) {
      da[kk] = desc_k(a, a_rows, a_row0, k0 + kk);
      db[kk] = desc_k(b, N, 0, k0 + kk);
    }
    sm90::fence_regs(da);
    sm90::fence_regs(db);
    sm90::fence_regs(d);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kG; ++kk) sm90::wgmma_ss<T, N>(d, da[kk], db[kk], k0 + kk > 0);
    sm90::wgmma_commit();
  }
}

// Issue d += A B (RS form): A [64, K] in registers (`a`, the A fragments of
// an accumulator), B the [K, D] tile `b` read MN-major.  Committed as one
// group; the caller waits.  wgmma's N is at most 128 here, so at D = 256
// each k16 step is two products of 128 columns: the first into d[0, 64)
// (columns 0-127), the second, whose B starts two 64-column blocks on, into
// d[64, 128).
template <typename T, int D, int K>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2], uint32_t (&a)[K / 16][4], const T* b) {
  constexpr int kN = D < 128 ? D : 128;
  constexpr int kParts = D / kN;
  uint64_t db[K / 16 * kParts];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int n = 0; n < kParts; ++n) db[kk * kParts + n] = desc_mn(b + n * (kN / 64) * K * 64, K, kk);
  sm90::fence_regs(a);
  sm90::fence_regs(db);
  sm90::fence_regs(d);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int n = 0; n < kParts; ++n)
      sm90::wgmma_rs<T, kN>(*reinterpret_cast<float(*)[kN / 2]>(d + n * (kN / 2)), a[kk], db[kk * kParts + n]);
  sm90::wgmma_commit();
}

// issue_rs for two products in one group: a wgmma reads its A registers
// until the wait, so nothing may be computed between the two issues.
template <typename T, int D, int K>
__device__ __forceinline__ void issue_rs2(float (&d1)[D / 2], uint32_t (&a1)[K / 16][4], const T* b1,
                                          float (&d2)[D / 2], uint32_t (&a2)[K / 16][4], const T* b2) {
  uint64_t db1[K / 16], db2[K / 16];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    db1[kk] = desc_mn(b1, K, kk);
    db2[kk] = desc_mn(b2, K, kk);
  }
  sm90::fence_regs(a1);
  sm90::fence_regs(a2);
  sm90::fence_regs(db1);
  sm90::fence_regs(db2);
  sm90::fence_regs(d1);
  sm90::fence_regs(d2);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) sm90::wgmma_rs<T, D>(d1, a1[kk], db1[kk]);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) sm90::wgmma_rs<T, D>(d2, a2[kk], db2[kk]);
  sm90::wgmma_commit();
}

// An [64, N] fp32 accumulator as the A fragments of N / 16 k16 steps,
// rounded to T: its 8-column blocks 2kk and 2kk + 1 are step kk.
template <typename T, int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = Pack<T>::two(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = Pack<T>::two(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = Pack<T>::two(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = Pack<T>::two(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Store a warpgroup's [64, D] fp32 accumulator times `scale` as T: this
// thread's rows row_a and row_a + 8 that lie below n.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* base, long long ld, const float (&acc)[D / 2], float scale, int row_a,
                                          int n, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n) continue;
    T* dst = base + (long long)row * ld + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) =
          Pack<T>::two(acc[4 * nd + 2 * r] * scale, acc[4 * nd + 2 * r + 1] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 1)
flash_bwd_dq_ws_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps maps) {
  using C = DqCfg<D>;
  constexpr int kBr = C::kPinned, kBc = C::kStream, kS = C::kStages;
  constexpr int kTile = kBc * D;  // elements of a K or V slot

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  T* sQs = reinterpret_cast<T*>(smem);
  T* sDo = reinterpret_cast<T*>(smem + C::kOffDo);
  T* sK = reinterpret_cast<T*>(smem + C::kOffK);  // kS slots
  T* sV = reinterpret_cast<T*>(smem + C::kOffV);
  int* sIds = reinterpret_cast<int*>(smem + C::kOffIds);  // kS x kBc KV segment ids
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full = q_full + 1;  // slot s holds its K/V tile
  uint64_t* empty = full + kS;  // every consumer warpgroup is done with slot s

  const Mask mk = p.mask;
  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest causal KV loops first
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int r0 = tile * kBr;
  const int* kv_ids = p.kv_ids ? p.kv_ids + (long long)b * mk.lk : nullptr;
  // The block's KV tiles [j_lo, j_hi): the union of its warpgroups' ranges.
  const int j_lo = mk.kv_first(r0) / kBc;
  const int kv_end = mk.kv_end(min(r0 + kBr, mk.lq));
  const int j_hi = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;
  // With segment ids every producer thread stages one and arrives on "full".
  const bool all_produce = kv_ids != nullptr;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], all_produce ? 128 : 1);
      sm90::mbar_init(&empty[s], 128 * C::kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup's index broadcast from lane 0, so that ptxas sees every
  // branch on it (and on values made from it) as uniform.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---------------- producer warpgroup ----------------
    if constexpr (C::kConsumers > 1) sm90::reg_dealloc<kBwdProducerRegs>();
    if (!all_produce && tid != 0) return;
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(q_full, 2 * C::kPinnedBytes);
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(sQs + c * kBr * 64, &maps.qs, q_full, c * 64, r0, h, b);
        sm90::tma_load_4d(sDo + c * kBr * 64, &maps.dout, q_full, c * 64, r0, h, b);
      }
    }
    for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
      const int s = it % kS;
      sm90::mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
      if (kv_ids != nullptr && tid < kBc) sIds[s * kBc + tid] = j * kBc + tid < mk.lk ? kv_ids[j * kBc + tid] : -1;
      if (tid == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], 2 * C::kTileBytes);
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load_4d(sK + s * kTile + c * kBc * 64, &maps.k, &full[s], c * 64, j * kBc, hk, b);
          sm90::tma_load_4d(sV + s * kTile + c * kBc * 64, &maps.v, &full[s], c * 64, j * kBc, hk, b);
        }
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  if constexpr (C::kConsumers > 1) sm90::reg_alloc<kBwdConsumerRegs>();
  const int cw = wg - 1;  // this warpgroup's 64 q rows of the block
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // row within the 8-row group
  const int t = lane % 4;  // column pair
  const int wr0 = r0 + 64 * cw;
  const bool active = wr0 < mk.lq;
  int my_lo = 0, my_hi = 0;  // this warpgroup's KV tiles
  if (active) {
    my_lo = mk.kv_first(wr0) / kBc;
    const int end = mk.kv_end(min(wr0 + 64, mk.lq));
    my_hi = end > 0 ? (end + kBc - 1) / kBc : 0;
  }
  const int row_a = wr0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8
  // Per row: the keys [lo, hi] it sees (Mask::visible: causal, window,
  // ragged ends; empty past Lq), its segment id, lse * log2(e) and di.
  const long long stat = (long long)bh * mk.lq;
  int lo[2], hi[2], q_id[2] = {0, 0};
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool in = row < mk.lq;
    lo[r] = mk.kv_first(row);
    hi[r] = in ? mk.kv_end(row + 1) - 1 : -1;
    lse2[r] = in ? p.lse[stat + row] * kLog2e : 0.f;
    di[r] = in ? p.di[stat + row] : 0.f;
    if (p.q_ids != nullptr && in) q_id[r] = p.q_ids[(long long)b * mk.lq + row];
  }
  sm90::mbar_wait(q_full, 0);

  float acc[D / 2];
  float sc[kBc / 2], dp[kBc / 2];  // S and dP: [64, kBc] as kBc / 8 blocks of 8 columns x 4 registers
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBc / 2; ++i) sc[i] = dp[i] = 0.f;

  for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
    const int s = it % kS;
    sm90::mbar_wait(&full[s], (it / kS) & 1);
    if (j >= my_lo && j < my_hi) {
      const T* k_s = sK + s * kTile;
      const T* v_s = sV + s * kTile;
      const int c0 = j * kBc;
      // S = qs K^T and dP = dO V^T
      issue_ss<T, D, kBc>(sc, sQs, kBr, 64 * cw, k_s);
      issue_ss<T, D, kBc>(dp, sDo, kBr, 64 * cw, v_s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // P = exp2(S - lse log2 e), 0 where masked; dS = P (dP - di) in dp.
      const bool masked = kv_ids != nullptr || !mk.tile_visible(wr0, 64, c0, kBc);
      const int* ids = sIds + s * kBc;
#pragma unroll
      for (int nb = 0; nb < kBc / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int cl = nb * 8 + 2 * t + (e & 1);
          bool ok = true;
          if (masked) {
            ok = c0 + cl >= lo[r] && c0 + cl <= hi[r];
            if (kv_ids != nullptr) ok = ok && q_id[r] == ids[cl];
          }
          const float pr = ok ? exp2_ftz(sc[4 * nb + e] - lse2[r]) : 0.f;
          dp[4 * nb + e] = pr * (dp[4 * nb + e] - di[r]);
        }

      // dQ += dS K, dS rounded to T
      uint32_t dsa[kBc / 16][4];
      to_a_frags<T, kBc>(dsa, dp);
      issue_rs<T, D, kBc>(acc, dsa, k_s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(&empty[s]);
  }
  if (!active) return;
  store_acc<T, D>(static_cast<T*>(p.dq) + b * p.sdq.sb + h * p.sdq.sh, p.sdq.sl, acc, p.scale, row_a, mk.lq, t);
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
flash_bwd_dkv_ws_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps maps) {
  using C = DkvCfg<D>;
  constexpr int kBr = C::kPinned, kBq = C::kStream, kS = C::kStages;
  constexpr int kTile = kBq * D;  // elements of a qs, q or dO slot
  static_assert(kBq <= 128, "one producer thread stages each q row's statistics");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + C::kOffV);
  T* sQs = reinterpret_cast<T*>(smem + C::kOffQs);  // kS slots each
  T* sQ = reinterpret_cast<T*>(smem + C::kOffQ);
  T* sDo = reinterpret_cast<T*>(smem + C::kOffDo);
  float* sStats = reinterpret_cast<float*>(smem + C::kOffStats);  // per slot: lse2, di, ids (int)
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full = kv_full + 1;  // slot s holds its q tile
  uint64_t* empty = full + kS;   // every consumer warpgroup is done with slot s

  const Mask mk = p.mask;
  const int hkv = p.hq / p.group;
  const int b = blockIdx.y / hkv;
  const int hk = blockIdx.y % hkv;
  const int c0 = blockIdx.x * kBr;  // KV tile 0 has the longest causal q loop: issued first
  const int c1 = min(c0 + kBr, mk.lk);
  // The block's q tiles [i_lo, i_hi) for each head of the group: the union
  // of its warpgroups' ranges.
  const int i_lo = mk.q_first(c0) / kBq;
  const int q_end = mk.q_end(c1);
  const int i_hi = q_end > 0 ? (q_end + kBq - 1) / kBq : 0;
  const int* q_ids = p.q_ids ? p.q_ids + (long long)b * mk.lq : nullptr;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], 128);  // the TMA thread's and the statistics' arrivals
      sm90::mbar_init(&empty[s], 128 * C::kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---------------- producer warpgroup ----------------
    if constexpr (C::kConsumers > 1) sm90::reg_dealloc<kBwdProducerRegs>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(kv_full, 2 * C::kPinnedBytes);
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(sK + c * kBr * 64, &maps.k, kv_full, c * 64, c0, hk, b);
        sm90::tma_load_4d(sV + c * kBr * 64, &maps.v, kv_full, c * 64, c0, hk, b);
      }
    }
    int n = 0;  // tiles issued
    for (int pass = 0; pass < C::kPasses; ++pass) {
      const bool dk_pass = C::kPasses == 1 || pass == 1;  // the q tile is dK's B operand
      for (int gi = 0; gi < p.group; ++gi) {
        const int h = hk * p.group + gi;
        const long long stat = ((long long)b * p.hq + h) * mk.lq;
        for (int i = i_lo; i < i_hi; ++i, ++n) {
          const int s = n % kS;
          sm90::mbar_wait(&empty[s], ((n / kS) & 1) ^ 1);
          if (tid < kBq) {
            const int row = i * kBq + tid;
            const bool in = row < mk.lq;
            float* st = sStats + s * 3 * kBq;
            st[tid] = in ? p.lse[stat + row] * kLog2e : 0.f;
            st[kBq + tid] = in ? p.di[stat + row] : 0.f;
            reinterpret_cast<int*>(st)[2 * kBq + tid] = q_ids != nullptr && in ? q_ids[row] : -1;
          }
          if (tid == 0) {
            sm90::mbar_arrive_expect_tx(&full[s], (dk_pass ? 3 : 2) * C::kTileBytes);
            for (int c = 0; c < D / 64; ++c) {
              const int off = s * kTile + c * kBq * 64;
              sm90::tma_load_4d(sQs + off, &maps.qs, &full[s], c * 64, i * kBq, h, b);
              if (dk_pass) sm90::tma_load_4d(sQ + off, &maps.q, &full[s], c * 64, i * kBq, h, b);
              sm90::tma_load_4d(sDo + off, &maps.dout, &full[s], c * 64, i * kBq, h, b);
            }
          } else {
            sm90::mbar_arrive(&full[s]);
          }
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  if constexpr (C::kConsumers > 1) sm90::reg_alloc<kBwdConsumerRegs>();
  const int cw = wg - 1;  // this warpgroup's 64 KV rows of the block
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int cw0 = c0 + 64 * cw;
  const bool active = cw0 < mk.lk;
  int my_lo = 0, my_hi = 0;  // this warpgroup's q tiles, the same for each head
  if (active) {
    my_lo = mk.q_first(cw0) / kBq;
    const int end = mk.q_end(min(cw0 + 64, mk.lk));
    my_hi = end > 0 ? (end + kBq - 1) / kBq : 0;
  }
  const int row_a = cw0 + warp * 16 + g;  // this thread's KV rows: row_a, row_a + 8
  // Per KV row: the query rows [lo, hi] that see it (Mask::visible; empty
  // past Lk) and its segment id.
  const int offset = mk.lk - mk.lq;
  int lo[2], hi[2], kv_id[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = row_a + 8 * r;
    lo[r] = 0;
    hi[r] = mk.lq - 1;
    if (c >= mk.lk) {
      lo[r] = mk.lq;
      hi[r] = -1;
    } else if (mk.causal) {
      lo[r] = max(c - offset, 0);
      if (mk.window > 0) hi[r] = min(c - offset + mk.window - 1, mk.lq - 1);
    }
    if (p.kv_ids != nullptr && c < mk.lk) kv_id[r] = p.kv_ids[(long long)b * mk.lk + c];
  }
  sm90::mbar_wait(kv_full, 0);

  // One walk over the block's q tiles, every head of the group in turn,
  // adding to dV (kDv) and dK (kDk).
  float dk[D / 2], dv[D / 2];
  int n = 0;  // tiles consumed
  auto walk = [&](auto dv_on, auto dk_on) {
    constexpr bool kDv = decltype(dv_on)::value, kDk = decltype(dk_on)::value;
    float st[kBq / 2], dpt[kBq / 2];  // S^T and dP^T: [64, kBq]
#pragma unroll
    for (int i = 0; i < kBq / 2; ++i) st[i] = dpt[i] = 0.f;
    for (int gi = 0; gi < p.group; ++gi) {
      for (int i = i_lo; i < i_hi; ++i, ++n) {
        const int s = n % kS;
        sm90::mbar_wait(&full[s], (n / kS) & 1);
        if (i >= my_lo && i < my_hi) {
          const T* qs_s = sQs + s * kTile;
          const T* do_s = sDo + s * kTile;
          const float* stats = sStats + s * 3 * kBq;
          const int* ids = reinterpret_cast<const int*>(stats + 2 * kBq);
          const int r0 = i * kBq;
          // S^T = K qs^T and dP^T = V dO^T
          issue_ss<T, D, kBq>(st, sK, kBr, 64 * cw, qs_s);
          if constexpr (kDk) issue_ss<T, D, kBq>(dpt, sV, kBr, 64 * cw, do_s);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(st);
          if constexpr (kDk) sm90::fence_regs(dpt);

          // P^T = exp2(S^T - lse log2 e), 0 where masked, in st.  Columns
          // are q rows: their lse and di come from the slot, two adjacent
          // columns at a time.
          const bool masked = q_ids != nullptr || !mk.tile_visible(r0, kBq, cw0, 64);
#pragma unroll
          for (int nb = 0; nb < kBq / 8; ++nb) {
            const int col = nb * 8 + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(stats + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int x = e & 1;
              bool ok = true;
              if (masked) {
                const int q = r0 + col + x;
                ok = q >= lo[r] && q <= hi[r];
                if (q_ids != nullptr) ok = ok && kv_id[r] == ids[col + x];
              }
              st[4 * nb + e] = ok ? exp2_ftz(st[4 * nb + e] - (x ? l2.y : l2.x)) : 0.f;
            }
          }
          // dV += P^T dO, P rounded to dO's dtype
          uint32_t pa[kBq / 16][4], dsa[kBq / 16][4];
          if constexpr (kDv) to_a_frags<T, kBq>(pa, st);
          if constexpr (kDk) {
            // dS^T = P^T (dP^T - di) in dpt
#pragma unroll
            for (int nb = 0; nb < kBq / 8; ++nb) {
              const float2 dd = *reinterpret_cast<const float2*>(stats + kBq + nb * 8 + 2 * t);
#pragma unroll
              for (int e = 0; e < 4; ++e) dpt[4 * nb + e] = st[4 * nb + e] * (dpt[4 * nb + e] - (e & 1 ? dd.y : dd.x));
            }
            to_a_frags<T, kBq>(dsa, dpt);
          }
          // dK += dS^T q, dS rounded to q's dtype
          const T* q_s = sQ + s * kTile;
          if constexpr (kDv && kDk) issue_rs2<T, D, kBq>(dv, pa, do_s, dk, dsa, q_s);
          else if constexpr (kDv) issue_rs<T, D, kBq>(dv, pa, do_s);
          else issue_rs<T, D, kBq>(dk, dsa, q_s);
          sm90::wgmma_wait<0>();
          if constexpr (kDv) sm90::fence_regs(dv);
          if constexpr (kDk) sm90::fence_regs(dk);
        }
        sm90::mbar_arrive(&empty[s]);
      }
    }
  };
  using On = std::true_type;
  using Off = std::false_type;
  T* gdk = static_cast<T*>(p.dk) + b * p.sdk.sb + hk * p.sdk.sh;
  T* gdv = static_cast<T*>(p.dv) + b * p.sdv.sb + hk * p.sdv.sh;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = 0.f;
  if constexpr (C::kPasses == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
    walk(On{}, On{});
  } else {
    walk(On{}, Off{});
    if (active) store_acc<T, D>(gdv, p.sdv.sl, dv, 1.f, row_a, mk.lk, t);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
    walk(Off{}, On{});
  }
  if (!active) return;
  store_acc<T, D>(gdk, p.sdk.sl, dk, p.scale, row_a, mk.lk, t);
  if constexpr (C::kPasses == 1) store_acc<T, D>(gdv, p.sdv.sl, dv, 1.f, row_a, mk.lk, t);
}

// q rows and KV rows of one TMA box: the streamed and pinned tile heights.
template <typename T, int D>
bool make_bwd_maps(BwdMaps& maps, const BwdParams& p, int q_rows, int kv_rows, bool with_q) {
  constexpr CUtensorMapDataType kType =
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  const Mask& mk = p.mask;
  const int hkv = p.hq / p.group;
  const long long qs_sl = D, qs_sh = (long long)mk.lq * D, qs_sb = (long long)p.hq * mk.lq * D;
  bool ok = sm90::make_map_4d(&maps.qs, kType, 2, p.qs, D, mk.lq, p.hq, p.batch, qs_sl, qs_sh, qs_sb, 64, q_rows, kSw);
  ok = ok && sm90::make_map_4d(&maps.dout, kType, 2, p.dout, D, mk.lq, p.hq, p.batch, p.sdo.sl, p.sdo.sh, p.sdo.sb,
                               64, q_rows, kSw);
  ok = ok && sm90::make_map_4d(&maps.k, kType, 2, p.k, D, mk.lk, hkv, p.batch, p.sk.sl, p.sk.sh, p.sk.sb, 64,
                               kv_rows, kSw);
  ok = ok && sm90::make_map_4d(&maps.v, kType, 2, p.v, D, mk.lk, hkv, p.batch, p.sv.sl, p.sv.sh, p.sv.sb, 64,
                               kv_rows, kSw);
  if (with_q)
    ok = ok && sm90::make_map_4d(&maps.q, kType, 2, p.q, D, mk.lq, p.hq, p.batch, p.sq.sl, p.sq.sh, p.sq.sb, 64,
                                 q_rows, kSw);
  return ok;
}

// K2 (dK/dV): a grid over KV tiles and KV heads; pins KV rows, streams q rows.
template <typename T, int D>
cudaError_t launch_dkv_ws(const BwdParams& p, cudaStream_t stream) {
  using C = DkvCfg<D>;
  BwdMaps maps{};
  if (!make_bwd_maps<T, D>(maps, p, C::kStream, C::kPinned, true)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_ws_kernel<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.mask.lk + C::kPinned - 1) / C::kPinned, p.batch * (p.hq / p.group));
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(p, maps);
  return cudaGetLastError();
}

// K3 (dQ): a grid over q tiles and q heads; pins q rows, streams KV rows.
template <typename T, int D>
cudaError_t launch_dq_ws(const BwdParams& p, cudaStream_t stream) {
  using C = DqCfg<D>;
  BwdMaps maps{};
  if (!make_bwd_maps<T, D>(maps, p, C::kPinned, C::kStream, false)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_ws_kernel<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.mask.lq + C::kPinned - 1) / C::kPinned, p.batch * p.hq);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(p, maps);
  return cudaGetLastError();
}

// K2 and K3 at D = 256 for bf16 (dtype 1) and fp16 (2), instantiated in
// flash_bwd_d256.cu.
cudaError_t launch_dkv_ws_d256(int dtype, const BwdParams& p, cudaStream_t stream);
cudaError_t launch_dq_ws_d256(int dtype, const BwdParams& p, cudaStream_t stream);
// K2 (which 0) and K3 (1) at D = 512 and 1024 for bf16 (dtype 1) and fp16
// (2): flash_bwd_wide.cuh's kernels, instantiated in flash_bwd_wide.cu and
// flash_bwd_wide_d1024.cu.
cudaError_t launch_bwd_wide_d512(int which, int dtype, const BwdParams& p, cudaStream_t stream);
cudaError_t launch_bwd_wide_d1024(int which, int dtype, const BwdParams& p, cudaStream_t stream);
// fp32 K2 (which 0) and K3 (1) at D = 256 and 512 and at 1024: the 3xTF32
// kernels of flash_bwd_fp32_wide.cuh, instantiated in flash_bwd_fp32_wide.cu
// and flash_bwd_fp32_wide_d1024.cu.
cudaError_t launch_bwd_fp32_wide(int which, int head_dim, const BwdParams& p, cudaStream_t stream);
cudaError_t launch_bwd_fp32_wide_d1024(int which, const BwdParams& p, cudaStream_t stream);

}  // namespace fa
