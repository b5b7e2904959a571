// K2 (dK/dV) and K3 (dQ) at padded head dims 512 and 1024 for bf16 and
// fp16: warp-specialised TMA + wgmma kernels whose accumulators hold the
// transposed gradients, so that the head dim, not the pinned rows, is
// wgmma's M.  flash_bwd_wide.cu instantiates D = 512, flash_bwd_wide_d1024.cu
// D = 1024, each in a source of its own so that they compile beside the
// rest; fa_flash_bwd_dkv / fa_flash_bwd_dq (flash_bwd.cu) launch them.
//
// Replaces, at these head dims (the entry points zero-pad 257-512 to 512
// and 513-1024 to 1024): flash_attention_tpu/kernels/flash_attention.py::
// _dkv_kernel (:637, launched by _bwd_dkv :890 through pl.pallas_call :921 /
// :963) and ::_dq_kernel (:765, _bwd_dq :995, :1014 / :1060), which recompute
// P through _recompute_p (:608).  They compute what flash_bwd.cuh's kernels
// compute at D <= 256: P = exp2(qs K^T - lse log2 e) with the pre-pass's qs,
// P = 0 where masked (a row with lse = -inf gives 0, not NaN); P rounded to
// dO's dtype before P^T dO; dS = P (dP - di) rounded to T before dS^T q and
// dS K; every sum in fp32, sm_scale applied at the store.  Causal masks
// aligned to the end of KV, the window, segment ids, GQA (the group's q
// heads walked in the block, no atomics, so the result is deterministic),
// ragged Lq / Lk and strides.  They read the wide forward's lse
// (flash_fwd_wide.cuh) and the pre-pass's di and qs.
//
// What bounds them: at b8 h12 L1024 causal, K2's four products are 206 /
// 412 GFLOP at D = 512 / 1024 (0.21 / 0.42 ms at 989 TFLOP/s) and K3's three
// 155 / 309 GFLOP, against 0.2 / 0.4 ms of bytes at 3.35 TB/s: their
// operations.  What stands in the way at this width is room, not
// arithmetic:
//   * registers: dK and dV for 64 KV rows at D = 512 are 2 x 64 x 512 fp32,
//     the whole register file of an SM, and ptxas gives a thread of a
//     384-thread block 168 registers whatever setmaxnreg grants.
//     So the accumulators are transposed: dV^T [D, kv] += dO^T P and dK^T
//     [D, kv] += q^T dS (K3: dQ^T [D, q] += K^T dS^T), with A the streamed
//     dO / q / K tile read M-major (wgmma's transposed A) and B the P / dS
//     tile that the kernel writes to shared memory.  wgmma's M is then 64
//     columns of the head dim and its N the pinned rows, which can be as
//     few as 16: a block pins kKv = 16384 / D KV rows (32 / 16) for K2 and
//     kQ = 32 q rows for K3, and its two consumer warpgroups each own half
//     of the head dim's columns, D / 128 accumulators of 64 x N: 128
//     registers a thread for dK^T and dV^T together, 64 / 128 for dQ^T;
//   * the full-D contractions: S = qs K^T and dP = dO V^T (K3: S^T = K qs^T,
//     dP^T = V dO^T) contract over all of D, and each warpgroup computes one
//     of them whole, warpgroup 0 S and warpgroup 1 dP.  dP meets S through
//     shared memory (fp32, one named barrier), warpgroup 0 writes P and dS
//     rounded to T in the 128-byte swizzle the B descriptor reads, and a
//     second named barrier hands them to both warpgroups.  One P / dS
//     buffer suffices: the first barrier of the next tile comes after both
//     warpgroups waited for their products of this one;
//   * shared memory: a 64-row q tile at D = 1024 is 128 KB an operand, so
//     no streamed operand is whole in shared memory.  The ring's slots are
//     four TMA boxes of 64 rows x 64 columns (32 KB), four slots, and a tile
//     is D / 64 slots: D / 128 with two blocks of qs and of dO (K3: K and
//     V) for S and dP, then D / 128 with warpgroup 0's and warpgroup 1's
//     block of dO and q for dV and dK (K3: D / 256 with two blocks of K a
//     warpgroup for dQ).  dO (K3: K) is read twice a tile; the pinned K
//     and V are 64 KB at both head dims, K3's qs and dO 64 / 128 KB, so
//     K3 keeps two slots at D = 1024: 32 pinned q rows there halve the KV
//     tiles' re-streaming and were 27% faster than 16 rows in four slots
//     (at D = 512, 64 rows in two slots were 2% slower than 32 in four);
//   * a producer warpgroup: one thread issues the TMA loads (4-D maps, rows
//     past Lq or Lk read as zero); lse, di and segment ids are read from
//     global memory by the threads that use them;
//   * every wgmma operand is ready before wgmma.fence and every branch
//     around a wgmma is uniform (the warpgroup index is broadcast from lane
//     0), else ptxas serialises them (C7518).
// K2 takes its pinned KV rows through the q tiles once.  The other
// candidate for its accumulators, two walks (dV, then dK, recomputing S) at
// twice the pinned rows (64 / 32, half the re-streaming, two ring slots),
// spilled 988 / 356 bytes and was 1.84x / 1.11x slower at D = 512 / 1024
// (PERF.md has the A/B).
#pragma once

#include "flash_bwd.cuh"

namespace fa {
namespace wide {

// The streamed operands travel in TMA boxes of 64 rows x 64 columns (128
// bytes a row, 128-byte swizzle, 8 KB), four a ring slot.
constexpr int kBoxElems = 64 * 64;
constexpr int kSlotBytes = 4 * kBoxElems * 2;
constexpr int kBwdThreads = 3 * 128;  // two consumer warpgroups, then the producer warpgroup

// K2: K and V pinned; the ring; dP (fp32 [64 x kKv], the fragment layout);
// P^T and dS^T (T [kKv x 64], swizzled); the pinned rows' segment ids; the
// barriers; + 1024 to align the base for the 128-byte swizzle.
// kernels/block_sizes.py mirrors the layout (backward_smem_bytes).
template <int D>
struct DkvCfg {
  static_assert(D == 512 || D == 1024, "padded head dims 512 and 1024");
  static constexpr int kKv = 16384 / D;  // pinned KV rows: wgmma's N in every product
  static constexpr int kStages = 4;
  static constexpr int kPinBytes = kKv * D * 2;
  static constexpr int kOffV = kPinBytes;  // K at 0
  static constexpr int kOffRing = 2 * kPinBytes;
  static constexpr int kOffX = kOffRing + kStages * kSlotBytes;
  static constexpr int kOffP = kOffX + 64 * kKv * 4;
  static constexpr int kOffDs = kOffP + kKv * 128;
  static constexpr int kOffIds = kOffDs + kKv * 128;
  static constexpr int kOffBars = kOffIds + kKv * 4;
  static constexpr int kBars = 1 + 2 * kStages;  // K/V; full and empty per slot
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
  static_assert(kOffP % 1024 == 0 && kOffDs % 1024 == 0, "the swizzled P and dS want 1024-byte alignment");
};

// K3: qs and dO pinned; the ring; dP^T (fp32 [64 x kQ]); dS (T [kQ x 64],
// swizzled); the pinned rows' lse * log2(e), di and segment ids; the
// barriers; the alignment slack.
template <int D>
struct DqCfg {
  static_assert(D == 512 || D == 1024, "padded head dims 512 and 1024");
  static constexpr int kQ = 32;  // pinned q rows: wgmma's N in every product
  static constexpr int kStages = D == 512 ? 4 : 2;
  static constexpr int kPinBytes = kQ * D * 2;
  static constexpr int kOffDo = kPinBytes;  // qs at 0
  static constexpr int kOffRing = 2 * kPinBytes;
  static constexpr int kOffX = kOffRing + kStages * kSlotBytes;
  static constexpr int kOffDs = kOffX + 64 * kQ * 4;
  static constexpr int kOffStats = kOffDs + kQ * 128;
  static constexpr int kOffBars = kOffStats + 3 * kQ * 4;
  static constexpr int kBars = 1 + 2 * kStages;  // qs/dO; full and empty per slot
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
  static_assert(kOffDs % 1024 == 0, "the swizzled dS wants 1024-byte alignment");
};

// Element (n, k) of a [rows x 64] T tile in the 128-byte swizzle (row n of
// 128 bytes, its 16-byte chunks permuted by n % 8), as a K-major B operand
// reads it: x rounded to T.
template <typename T>
__device__ __forceinline__ void put_swizzled(unsigned char* tile, int n, int k, float x) {
  *reinterpret_cast<T*>(tile + n * 128 + ((((k >> 3) ^ n) & 7) << 4) + (k & 7) * 2) = from_float<T>(x);
}

// x += A B^T over two 64-column blocks (SS, both K-major): A two [64 x 64]
// boxes one after the other, B two [N x 64] blocks one after the other.
// One commit group a block; the caller waits.
template <typename T, int N>
__device__ __forceinline__ void issue_nt(float (&x)[N / 2], const T* a, const T* b) {
#pragma unroll
  for (int cb = 0; cb < 2; ++cb) {
    uint64_t da[4], db[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      da[kk] = sm90::smem_desc(a + cb * kBoxElems + kk * 16, 16, 1024);
      db[kk] = sm90::smem_desc(b + cb * N * 64 + kk * 16, 16, 1024);
    }
    sm90::fence_regs(da);
    sm90::fence_regs(db);
    sm90::fence_regs(x);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::wgmma_ss<T, N>(x, da[kk], db[kk], 1);
    sm90::wgmma_commit();
  }
}

// x += A^T B^T (SS) in one commit group: A a [64 x 64] box read as the
// transposed, M-major A (its rows are wgmma's k: a k16 step moves 16 rows,
// 2 KB, down the box; the box's 64 columns are M), B a swizzled [N x 64]
// tile written by the kernel (K-major: N rows of 64 k).  The caller waits.
template <typename T, int N>
__device__ __forceinline__ void issue_tn(float (&x)[N / 2], const T* box, const unsigned char* b) {
  uint64_t da[4], db[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    da[kk] = sm90::smem_desc(box + kk * 16 * 64, 8192, 1024);
    db[kk] = sm90::smem_desc(b + kk * 32, 16, 1024);
  }
  sm90::fence_regs(da);
  sm90::fence_regs(db);
  sm90::fence_regs(x);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::wgmma_ss<T, N, true>(x, da[kk], db[kk], 1);
  sm90::wgmma_commit();
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps maps) {
  using C = DkvCfg<D>;
  constexpr int kKv = C::kKv, kS = C::kStages;
  constexpr int kHalf = D / 128;  // 64-column blocks of dK / dV a warpgroup owns; also the S / dP slots a tile

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + C::kOffV);
  T* sRing = reinterpret_cast<T*>(smem + C::kOffRing);
  float4* sX = reinterpret_cast<float4*>(smem + C::kOffX);
  unsigned char* sP = smem + C::kOffP;
  unsigned char* sDs = smem + C::kOffDs;
  int* sIds = reinterpret_cast<int*>(smem + C::kOffIds);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full = kv_full + 1;  // slot s holds its boxes
  uint64_t* empty = full + kS;   // both consumer warpgroups are done with slot s

  const Mask mk = p.mask;
  const int hkv = p.hq / p.group;
  const int b = blockIdx.y / hkv;
  const int hk = blockIdx.y % hkv;
  const int c0 = blockIdx.x * kKv;  // KV tile 0 has the longest causal q loop: issued first
  const int c1 = min(c0 + kKv, mk.lk);
  // The q tiles of 64 rows that reach the pinned KV rows, for each head of the group.
  const int i_lo = mk.q_first(c0) / 64;
  const int q_end = mk.q_end(c1);
  const int i_hi = q_end > 0 ? (q_end + 63) / 64 : 0;
  const int* q_ids = p.q_ids ? p.q_ids + (long long)b * mk.lq : nullptr;

  if (threadIdx.x < kKv) {
    const int c = c0 + threadIdx.x;
    sIds[threadIdx.x] = p.kv_ids != nullptr && c < mk.lk ? p.kv_ids[(long long)b * mk.lk + c] : -1;
  }
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup's index broadcast from lane 0, so that ptxas sees every
  // branch on it as uniform.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  if (wg == 2) {
    // ---------------- producer warpgroup ----------------
    if (tid != 0) return;
    sm90::mbar_arrive_expect_tx(kv_full, 2 * C::kPinBytes);
    for (int c = 0; c < D / 64; ++c) {
      sm90::tma_load_4d(sK + c * kKv * 64, &maps.k, kv_full, c * 64, c0, hk, b);
      sm90::tma_load_4d(sV + c * kKv * 64, &maps.v, kv_full, c * 64, c0, hk, b);
    }
    int n = 0;  // slots issued
    for (int gi = 0; gi < p.group; ++gi) {
      const int h = hk * p.group + gi;
      for (int i = i_lo; i < i_hi; ++i) {
        for (int step = 0; step < 2 * kHalf; ++step, ++n) {
          const int s = n % kS;
          sm90::mbar_wait(&empty[s], ((n / kS) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], kSlotBytes);
          T* slot = sRing + s * 4 * kBoxElems;
          for (int x = 0; x < 4; ++x) {
            // qs and dO blocks 2 step, 2 step + 1 for S and dP; then dO and q
            // of warpgroup 0's block, and of warpgroup 1's, for dV and dK
            const bool first = step < kHalf;
            const CUtensorMap* m = first ? (x < 2 ? &maps.qs : &maps.dout) : (x & 1 ? &maps.q : &maps.dout);
            const int blk = first ? 2 * step + (x & 1) : step - kHalf + (x >> 1) * kHalf;
            sm90::tma_load_4d(slot + x * kBoxElems, m, &full[s], blk * 64, i * 64, h, b);
          }
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  // Warpgroup cw computes S (0) or dP (1) of a tile, and dV^T / dK^T of the
  // head dim's 64-column blocks [kHalf cw, kHalf (cw + 1)).
  const int cw = wg;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // row within the 8-row group
  const int t = lane % 4;  // column pair
  const int r_a = warp * 16 + g;  // this thread's fragment rows: r_a, r_a + 8
  float dv[kHalf][kKv / 2], dk[kHalf][kKv / 2];  // dV^T and dK^T: [64 head-dim columns x kKv] a block
  float x1[kKv / 2];                             // S or dP: [64 q rows x kKv]
#pragma unroll
  for (int j = 0; j < kHalf; ++j)
#pragma unroll
    for (int e = 0; e < kKv / 2; ++e) dv[j][e] = dk[j][e] = 0.f;
  sm90::mbar_wait(kv_full, 0);

  int n = 0;  // slots consumed
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const long long stat = ((long long)b * p.hq + h) * mk.lq;
    for (int i = i_lo; i < i_hi; ++i) {
      const int r0 = i * 64;
      // warpgroup 0: its q rows' lse * log2(e), di and segment ids
      float lse2[2] = {0.f, 0.f}, di[2] = {0.f, 0.f};
      int q_id[2] = {-1, -1};
      if (cw == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + r_a + 8 * r;
          if (row < mk.lq) {
            lse2[r] = p.lse[stat + row] * kLog2e;
            di[r] = p.di[stat + row];
            if (q_ids != nullptr) q_id[r] = q_ids[row];
          }
        }
      }

      // ---- S = qs K^T (warpgroup 0) and dP = dO V^T (warpgroup 1) ----
#pragma unroll
      for (int e = 0; e < kKv / 2; ++e) x1[e] = 0.f;
      for (int j = 0; j < kHalf; ++j, ++n) {
        const int s = n % kS;
        sm90::mbar_wait(&full[s], (n / kS) & 1);
        const T* a = sRing + s * 4 * kBoxElems + 2 * cw * kBoxElems;
        const T* pinned = (cw == 0 ? sK : sV) + 2 * j * kKv * 64;
        issue_nt<T, kKv>(x1, a, pinned);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(x1);
        sm90::mbar_arrive(&empty[s]);
      }

      // ---- P and dS = P (dP - di), rounded to T, into shared memory ----
      if (cw == 1) {
#pragma unroll
        for (int v = 0; v < kKv / 8; ++v)
          sX[v * 128 + tid] = make_float4(x1[4 * v], x1[4 * v + 1], x1[4 * v + 2], x1[4 * v + 3]);
      }
      sm90::named_bar_sync(1, 256);  // dP is in sX; both warpgroups are done with P and dS of the last tile
      if (cw == 0) {
        // element mask only where the tile crosses the diagonal, the window
        // edge or a ragged end, or where segment ids apply
        const bool masked = q_ids != nullptr || !mk.tile_visible(r0, 64, c0, kKv);
#pragma unroll
        for (int nb = 0; nb < kKv / 8; ++nb) {
          const float4 d4 = sX[nb * 128 + tid];
          const float dp[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int ql = r_a + 8 * r;
            const int kvl = nb * 8 + 2 * t + (e & 1);
            bool ok = true;
            if (masked) ok = mk.visible(r0 + ql, c0 + kvl) && (q_ids == nullptr || q_id[r] == sIds[kvl]);
            const float pr = ok ? exp2_ftz(x1[4 * nb + e] - lse2[r]) : 0.f;
            put_swizzled<T>(sP, kvl, ql, pr);
            put_swizzled<T>(sDs, kvl, ql, pr * (dp[e] - di[r]));
          }
        }
        sm90::fence_proxy_async();  // the generic writes, before wgmma reads them
      }
      sm90::named_bar_sync(2, 256);  // P and dS are in shared memory

      // ---- dV^T += dO^T P and dK^T += q^T dS over this warpgroup's blocks ----
      // (one commit group each, so that a group's descriptors take 16
      // registers beside the 128 of the accumulators)
#pragma unroll
      for (int j = 0; j < kHalf; ++j, ++n) {
        const int s = n % kS;
        const T* box = sRing + s * 4 * kBoxElems + 2 * cw * kBoxElems;  // dO, then q
        sm90::mbar_wait(&full[s], (n / kS) & 1);
        issue_tn<T, kKv>(dv[j], box, sP);
        issue_tn<T, kKv>(dk[j], box + kBoxElems, sDs);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv[j]);
        sm90::fence_regs(dk[j]);
        sm90::mbar_arrive(&empty[s]);
      }
    }
  }

  // The accumulators' fragments as dK / dV rows: times `scale`, rounded to
  // T, KV rows below lk.
  auto store = [&](float (&a)[kHalf][kKv / 2], void* out, const Strides& st, float scale) {
    T* base = static_cast<T*>(out) + b * st.sb + hk * st.sh;
#pragma unroll
    for (int j = 0; j < kHalf; ++j)
#pragma unroll
      for (int nb = 0; nb < kKv / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = c0 + nb * 8 + 2 * t + (e & 1);
          const int d = (cw * kHalf + j) * 64 + r_a + 8 * (e >> 1);
          if (kv < mk.lk) base[(long long)kv * st.sl + d] = from_float<T>(a[j][4 * nb + e] * scale);
        }
  };
  store(dv, p.dv, p.sdv, 1.f);
  store(dk, p.dk, p.sdk, p.scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
dq_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps maps) {
  using C = DqCfg<D>;
  constexpr int kQ = C::kQ, kS = C::kStages;
  constexpr int kHalf = D / 128;  // 64-column blocks of dQ a warpgroup owns; also the S / dP slots a tile

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  T* sQs = reinterpret_cast<T*>(smem);
  T* sDo = reinterpret_cast<T*>(smem + C::kOffDo);
  T* sRing = reinterpret_cast<T*>(smem + C::kOffRing);
  float4* sX = reinterpret_cast<float4*>(smem + C::kOffX);
  unsigned char* sDs = smem + C::kOffDs;
  float* sLse = reinterpret_cast<float*>(smem + C::kOffStats);  // lse * log2(e), di, segment ids (int)
  float* sDi = sLse + kQ;
  int* sQid = reinterpret_cast<int*>(sDi + kQ);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kS;

  const Mask mk = p.mask;
  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest causal KV loops first
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int r0 = tile * kQ;
  const int* kv_ids = p.kv_ids ? p.kv_ids + (long long)b * mk.lk : nullptr;
  // The KV tiles of 64 rows that the pinned q rows reach.
  const int j_lo = mk.kv_first(r0) / 64;
  const int kv_end = mk.kv_end(min(r0 + kQ, mk.lq));
  const int j_hi = kv_end > 0 ? (kv_end + 63) / 64 : 0;

  if (threadIdx.x < kQ) {
    const int row = r0 + threadIdx.x;
    const bool in = row < mk.lq;
    const long long stat = (long long)bh * mk.lq + row;
    sLse[threadIdx.x] = in ? p.lse[stat] * kLog2e : 0.f;
    sDi[threadIdx.x] = in ? p.di[stat] : 0.f;
    sQid[threadIdx.x] = p.q_ids != nullptr && in ? p.q_ids[(long long)b * mk.lq + row] : -1;
  }
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  if (wg == 2) {
    // ---------------- producer warpgroup ----------------
    if (tid != 0) return;
    sm90::mbar_arrive_expect_tx(q_full, 2 * C::kPinBytes);
    for (int c = 0; c < D / 64; ++c) {
      sm90::tma_load_4d(sQs + c * kQ * 64, &maps.qs, q_full, c * 64, r0, h, b);
      sm90::tma_load_4d(sDo + c * kQ * 64, &maps.dout, q_full, c * 64, r0, h, b);
    }
    int n = 0;
    for (int j = j_lo; j < j_hi; ++j) {
      for (int step = 0; step < kHalf + kHalf / 2; ++step, ++n) {
        const int s = n % kS;
        sm90::mbar_wait(&empty[s], ((n / kS) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], kSlotBytes);
        T* slot = sRing + s * 4 * kBoxElems;
        for (int x = 0; x < 4; ++x) {
          // K and V blocks 2 step, 2 step + 1 for S^T and dP^T; then K blocks
          // 2 i, 2 i + 1 of warpgroup 0's half and of warpgroup 1's for dQ^T
          const int i = step - kHalf;
          const bool v = step < kHalf && x >= 2;
          const int blk = step < kHalf ? 2 * step + (x & 1) : (x >> 1) * kHalf + 2 * i + (x & 1);
          sm90::tma_load_4d(slot + x * kBoxElems, v ? &maps.v : &maps.k, &full[s], blk * 64, j * 64, hk, b);
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  // Warpgroup cw computes S^T (0) or dP^T (1) of a KV tile, and dQ^T of the
  // head dim's 64-column blocks [kHalf cw, kHalf (cw + 1)).
  const int cw = wg;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r_a = warp * 16 + g;  // this thread's fragment rows (KV rows of S^T): r_a, r_a + 8
  float acc[kHalf][kQ / 2];  // dQ^T: [64 head-dim columns x kQ]
  float x1[kQ / 2];          // S^T or dP^T: [64 KV rows x kQ]
#pragma unroll
  for (int j = 0; j < kHalf; ++j)
#pragma unroll
    for (int e = 0; e < kQ / 2; ++e) acc[j][e] = 0.f;
  sm90::mbar_wait(q_full, 0);

  int n = 0;
  for (int jt = j_lo; jt < j_hi; ++jt) {
    const int c0 = jt * 64;
    int kv_id[2] = {-1, -1};
    if (cw == 0 && kv_ids != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (c0 + r_a + 8 * r < mk.lk) kv_id[r] = __ldg(kv_ids + c0 + r_a + 8 * r);
    }

    // ---- S^T = K qs^T (warpgroup 0) and dP^T = V dO^T (warpgroup 1) ----
#pragma unroll
    for (int e = 0; e < kQ / 2; ++e) x1[e] = 0.f;
    for (int j = 0; j < kHalf; ++j, ++n) {
      const int s = n % kS;
      sm90::mbar_wait(&full[s], (n / kS) & 1);
      const T* a = sRing + s * 4 * kBoxElems + 2 * cw * kBoxElems;
      const T* pinned = (cw == 0 ? sQs : sDo) + 2 * j * kQ * 64;
      issue_nt<T, kQ>(x1, a, pinned);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(x1);
      sm90::mbar_arrive(&empty[s]);
    }

    // ---- dS = P (dP - di), rounded to T, into shared memory as [kQ x 64] ----
    if (cw == 1) {
#pragma unroll
      for (int v = 0; v < kQ / 8; ++v)
        sX[v * 128 + tid] = make_float4(x1[4 * v], x1[4 * v + 1], x1[4 * v + 2], x1[4 * v + 3]);
    }
    sm90::named_bar_sync(1, 256);
    if (cw == 0) {
      const bool masked = kv_ids != nullptr || !mk.tile_visible(r0, kQ, c0, 64);
#pragma unroll
      for (int nb = 0; nb < kQ / 8; ++nb) {
        const float4 d4 = sX[nb * 128 + tid];
        const float dp[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kvl = r_a + 8 * r;
          const int ql = nb * 8 + 2 * t + (e & 1);
          bool ok = true;
          if (masked) ok = mk.visible(r0 + ql, c0 + kvl) && (kv_ids == nullptr || kv_id[r] == sQid[ql]);
          const float pr = ok ? exp2_ftz(x1[4 * nb + e] - sLse[ql]) : 0.f;
          put_swizzled<T>(sDs, ql, kvl, pr * (dp[e] - sDi[ql]));
        }
      }
      sm90::fence_proxy_async();
    }
    sm90::named_bar_sync(2, 256);

    // ---- dQ^T += K^T dS^T over this warpgroup's blocks, two a slot ----
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i, ++n) {
      const int s = n % kS;
      const T* box = sRing + s * 4 * kBoxElems + 2 * cw * kBoxElems;
      sm90::mbar_wait(&full[s], (n / kS) & 1);
      issue_tn<T, kQ>(acc[2 * i], box, sDs);
      issue_tn<T, kQ>(acc[2 * i + 1], box + kBoxElems, sDs);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc[2 * i]);
      sm90::fence_regs(acc[2 * i + 1]);
      sm90::mbar_arrive(&empty[s]);
    }
  }

  T* base = static_cast<T*>(p.dq) + b * p.sdq.sb + h * p.sdq.sh;
#pragma unroll
  for (int j = 0; j < kHalf; ++j)
#pragma unroll
    for (int nb = 0; nb < kQ / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = r0 + nb * 8 + 2 * t + (e & 1);
        const int d = (cw * kHalf + j) * 64 + r_a + 8 * (e >> 1);
        if (q < mk.lq) base[(long long)q * p.sdq.sl + d] = from_float<T>(acc[j][4 * nb + e] * p.scale);
      }
}

// K2 (dK/dV): a grid over KV tiles of kKv rows and KV heads.
template <typename T, int D>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  using C = DkvCfg<D>;
  BwdMaps maps{};
  if (!make_bwd_maps<T, D>(maps, p, 64, C::kKv, true)) return cudaErrorInvalidValue;
  auto kernel = dkv_kernel<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.mask.lk + C::kKv - 1) / C::kKv, p.batch * (p.hq / p.group));
  kernel<<<grid, kBwdThreads, C::kSmemBytes, stream>>>(p, maps);
  return cudaGetLastError();
}

// K3 (dQ): a grid over q tiles of kQ rows and q heads.
template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  using C = DqCfg<D>;
  BwdMaps maps{};
  if (!make_bwd_maps<T, D>(maps, p, C::kQ, 64, false)) return cudaErrorInvalidValue;
  auto kernel = dq_kernel<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.mask.lq + C::kQ - 1) / C::kQ, p.batch * p.hq);
  kernel<<<grid, kBwdThreads, C::kSmemBytes, stream>>>(p, maps);
  return cudaGetLastError();
}

// K2 (which 0) or K3 (1) for bf16 (dtype 1) and fp16 (2) at head dim D;
// cudaErrorInvalidValue for any other dtype.
template <int D>
cudaError_t launch_bwd_for(int which, int dtype, const BwdParams& p, cudaStream_t s) {
  if (dtype == 1) return which == 0 ? launch_dkv<__nv_bfloat16, D>(p, s) : launch_dq<__nv_bfloat16, D>(p, s);
  if (dtype == 2) return which == 0 ? launch_dkv<__half, D>(p, s) : launch_dq<__half, D>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace wide
}  // namespace fa
