// The fp32 backward kernels at head dims 64 and 128 (K2 dK/dV and K3 dQ) on
// the tensor cores in 3xTF32: TMA loads into an mbarrier ring as in
// flash_bwd.cuh's 16-bit kernels (issued by warp 0, which computes too),
// every product on mma.sync.m16n8k8 tf32 and every fp32 operand split into
// two TF32 halves (the helpers of tf32x3.cuh, which the fp32 forward
// shares).  flash_bwd.cu instantiates them and reaches them for dtype 0;
// its header note has the design and the numbers.
#pragma once

#include "flash_bwd.cuh"
#include "tf32x3.cuh"

namespace fa {

// ---------------------------------------------------------------------------
// The backward's products and stores (the 3xTF32 helpers are in tf32x3.cuh)
// ---------------------------------------------------------------------------

// s1 = A1 X1^T and s2 = A2 X2^T over the head dim, from zero, in one
// walk over it: A1, A2 the 16 rows from m0 of pinned [PR, D] tiles (kPre:
// split already, lo in a1lo / a2lo), X1, X2 streamed [N, D] tiles.
template <int PR, int N, int D, bool kPre>
__device__ __forceinline__ void products_nt(float (&s1)[N / 8][4], const float* a1, const float* a1lo,
                                            const float* x1, float (&s2)[N / 8][4], const float* a2,
                                            const float* a2lo, const float* x2, int m0, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s1[nb][e] = s2[nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t h1[4], l1[4], h2[4], l2[4];
    frag_pinned<PR, kPre>(h1, l1, a1, a1lo, m0, kk * 8, g, t);
    frag_pinned<PR, kPre>(h2, l2, a2, a2lo, m0, kk * 8, g, t);
#pragma unroll
    for (int nb0 = 0; nb0 < N / 8; nb0 += 2) {
      // two column blocks of each product: four independent sums
      float d[4][4];
      uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nb = nb0 + j % 2;
        frag_b_nk<N>(bh[j], bl[j], j < 2 ? x1 : x2, nb * 8, kk * 8, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[j][e] = j < 2 ? s1[nb][e] : s2[nb][e];
          ah[j][e] = j < 2 ? h1[e] : h2[e];
          al[j][e] = j < 2 ? l1[e] : l2[e];
        }
      }
      mma3<4>(d, ah, al, bh, bl);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) (j < 2 ? s1 : s2)[nb0 + j % 2][e] = d[j][e];
    }
  }
}

// lse * log2(e) of a row, +inf where lse = -inf (a row that sees no key), so
// that exp2(s - lse2) is 0 there and never inf or NaN.
__device__ __forceinline__ float lse_log2(float lse) { return lse == -CUDART_INF_F ? CUDART_INF_F : lse * kLog2e; }

// Store a warp's [16, D] accumulator times `scale`: this thread's rows
// row_a and row_a + 8 that lie below n, two columns a block.
template <int D>
__device__ __forceinline__ void store_acc_f32(float* base, long long ld, const float (&acc)[D / 8][4], float scale,
                                              int row_a, int n, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n) continue;
    float* dst = base + (long long)row * ld + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(dst + nd * 8) = make_float2(acc[nd][2 * r] * scale, acc[nd][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Configurations: eight warps of 16 pinned rows each, warp 0 also the
// producer (256 threads, one block an SM, up to 255 registers a thread; a
// ninth, producer-only warp makes 288 threads, which ptxas and the launch
// budget as 384: 168 registers and spills); + 1024 bytes to align the base
// for the swizzle.
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;

// K3: q and dO pinned; the ring's K and V slots; the KV segment ids of each
// slot; the barriers.
template <int D>
struct DqF32Cfg {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static constexpr int kPinned = 16 * kF32Warps;       // q rows of a block
  static constexpr int kStream = 32;                   // KV rows of each streamed tile
  static constexpr int kStages = D == 64 ? 6 : 3;
  static constexpr int kThreads = 32 * kF32Warps;
  static constexpr int kPinnedBytes = kPinned * D * 4;  // one pinned operand
  static constexpr int kTileBytes = kStream * D * 4;    // one streamed operand in one slot
  static constexpr int kOffDo = kPinnedBytes;  // q at 0
  static constexpr int kOffK = 2 * kPinnedBytes;
  static constexpr int kOffV = kOffK + kStages * kTileBytes;
  static constexpr int kOffIds = kOffV + kStages * kTileBytes;
  static constexpr int kOffBars = kOffIds + kStages * kStream * 4;
  static constexpr int kBars = 1 + 2 * kStages;  // q; full and empty per slot
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
};

// K2: K and V pinned; the ring's q and dO slots; per slot the q rows'
// lse * log2(e), di and segment ids; the barriers.
template <int D>
struct DkvF32Cfg {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static constexpr int kPinned = 16 * kF32Warps;      // KV rows of a block
  static constexpr int kStream = 32;                  // q rows of each streamed tile
  // At D = 64 each warp splits its pinned K and V rows once (lo beside them)
  // instead of at every q tile: 3% faster (at 128 the lo copies would not
  // fit; for K3's q and dO at 64 it gained nothing).
  static constexpr bool kPreSplit = D == 64;
  static constexpr int kStages = D == 64 ? 5 : 3;
  static constexpr int kThreads = 32 * kF32Warps;
  static constexpr int kPinnedBytes = kPinned * D * 4;
  static constexpr int kTileBytes = kStream * D * 4;
  static constexpr int kOffV = kPinnedBytes;  // K at 0
  static constexpr int kOffLo = 2 * kPinnedBytes;  // K's lo, then V's, when pre-split
  static constexpr int kOffQ = (kPreSplit ? 4 : 2) * kPinnedBytes;
  static constexpr int kOffDo = kOffQ + kStages * kTileBytes;
  static constexpr int kOffStats = kOffDo + kStages * kTileBytes;
  static constexpr int kStatBytes = 3 * kStream * 4;
  static constexpr int kOffBars = kOffStats + kStages * kStatBytes;
  static constexpr int kBars = 1 + 2 * kStages;  // K/V; full and empty per slot
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
};

// ---------------------------------------------------------------------------
// K3 (dQ): q rows pinned, KV tiles streamed
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(DqF32Cfg<D>::kThreads, 1)
flash_bwd_dq_fp32_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps maps) {
  using C = DqF32Cfg<D>;
  constexpr int kBr = C::kPinned, kBc = C::kStream, kS = C::kStages;
  constexpr int kTile = kBc * D;  // floats of a K or V slot

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDo = reinterpret_cast<float*>(smem + C::kOffDo);
  float* sK = reinterpret_cast<float*>(smem + C::kOffK);  // kS slots
  float* sV = reinterpret_cast<float*>(smem + C::kOffV);
  int* sIds = reinterpret_cast<int*>(smem + C::kOffIds);  // kS x kBc KV segment ids
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full = q_full + 1;  // slot s holds its K/V tile
  uint64_t* empty = full + kS;  // every consumer warp is done with slot s

  const Mask mk = p.mask;
  // The grid is (heads, q tiles), so that the blocks run tile by tile, the
  // longest causal KV loops first across every head.
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int r0 = tile * kBr;
  const int* kv_ids = p.kv_ids ? p.kv_ids + (long long)b * mk.lk : nullptr;
  // The block's KV tiles [j_lo, j_hi): the union of its warps' ranges.
  const int j_lo = mk.kv_first(r0) / kBc;
  const int kv_end = mk.kv_end(min(r0 + kBr, mk.lq));
  const int j_hi = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], 32);  // every producer lane
      sm90::mbar_init(&empty[s], 32 * kF32Warps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The warp's index broadcast from lane 0, so that ptxas sees every branch
  // on it as uniform.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int n_tiles = max(j_hi - j_lo, 0);
  // Warp 0 also produces: tile `it` of the walk (KV tile j_lo + it) into its
  // ring slot once every warp has released the slot's previous tile, the
  // segment ids by its lanes, the TMA loads by lane 0.
  auto issue = [&](int it) {
    const int s = it % kS;
    const int j = j_lo + it;
    sm90::mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
    if (kv_ids != nullptr)
      for (int x = lane; x < kBc; x += 32) sIds[s * kBc + x] = j * kBc + x < mk.lk ? kv_ids[j * kBc + x] : -1;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&full[s], 2 * C::kTileBytes);
      for (int c = 0; c < D / 32; ++c) {
        sm90::tma_load_4d(sK + s * kTile + c * kBc * 32, &maps.k, &full[s], c * 32, j * kBc, hk, b);
        sm90::tma_load_4d(sV + s * kTile + c * kBc * 32, &maps.v, &full[s], c * 32, j * kBc, hk, b);
      }
    } else {
      sm90::mbar_arrive(&full[s]);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(q_full, 2 * C::kPinnedBytes);
      for (int c = 0; c < D / 32; ++c) {
        sm90::tma_load_4d(sQ + c * kBr * 32, &maps.q, q_full, c * 32, r0, h, b);
        sm90::tma_load_4d(sDo + c * kBr * 32, &maps.dout, q_full, c * 32, r0, h, b);
      }
    }
    for (int it = 0; it < min(kS, n_tiles); ++it) issue(it);
  }

  const int cw = warp;  // this warp's 16 q rows of the block
  const int g = lane / 4;
  const int t = lane % 4;
  const int wr0 = r0 + 16 * cw;
  const bool active = wr0 < mk.lq;
  int my_lo = 0, my_hi = 0;  // this warp's KV tiles
  if (active) {
    my_lo = mk.kv_first(wr0) / kBc;
    const int end = mk.kv_end(min(wr0 + 16, mk.lq));
    my_hi = end > 0 ? (end + kBc - 1) / kBc : 0;
  }
  const int row_a = wr0 + g;  // this thread's rows: row_a, row_a + 8
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
    lse2[r] = in ? lse_log2(p.lse[stat + row]) : 0.f;
    di[r] = in ? p.di[stat + row] : 0.f;
    if (p.q_ids != nullptr && in) q_id[r] = p.q_ids[(long long)b * mk.lq + row];
  }
  sm90::mbar_wait(q_full, 0);

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
    const int s = it % kS;
    sm90::mbar_wait(&full[s], (it / kS) & 1);
    if (j >= my_lo && j < my_hi) {
      const float* k_s = sK + s * kTile;
      const float* v_s = sV + s * kTile;
      const int c0 = j * kBc;
      // S = q K^T and dP = dO V^T over the head dim
      float sc[kBc / 8][4], dp[kBc / 8][4];
      products_nt<kBr, kBc, D, false>(sc, sQ, nullptr, k_s, dp, sDo, nullptr, v_s, 16 * cw, g, t);

      // P = exp2(S scale log2 e - lse log2 e), 0 where masked; dS = P (dP -
      // di) in dp.
      const bool masked = kv_ids != nullptr || !mk.tile_visible(wr0, 16, c0, kBc);
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
          const float pr = ok ? exp2_ftz(fmaf(sc[nb][e], p.scale_log2, -lse2[r])) : 0.f;
          dp[nb][e] = pr * (dp[nb][e] - di[r]);
        }

      // dQ += dS K
      uint32_t dsh[kBc / 8][4], dsl[kBc / 8][4];
      frags_of<kBc>(dsh, dsl, dp);
      add_product<kBc, D>(acc, dsh, dsl, k_s, g, t);
    }
    sm90::mbar_arrive(&empty[s]);
    if (warp == 0 && it + kS < n_tiles) issue(it + kS);
  }
  if (!active) return;
  store_acc_f32<D>(static_cast<float*>(p.dq) + b * p.sdq.sb + h * p.sdq.sh, p.sdq.sl, acc, p.scale, row_a, mk.lq,
                   t);
}

// ---------------------------------------------------------------------------
// K2 (dK/dV): KV rows pinned, q tiles of every head of the group streamed
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(DkvF32Cfg<D>::kThreads, 1)
flash_bwd_dkv_fp32_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps maps) {
  using C = DkvF32Cfg<D>;
  constexpr int kBr = C::kPinned, kBq = C::kStream, kS = C::kStages;
  constexpr int kTile = kBq * D;  // floats of a q or dO slot

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = reinterpret_cast<float*>(smem + C::kOffV);
  float* sQ = reinterpret_cast<float*>(smem + C::kOffQ);  // kS slots each
  float* sDo = reinterpret_cast<float*>(smem + C::kOffDo);
  float* sStats = reinterpret_cast<float*>(smem + C::kOffStats);  // per slot: lse2, di, ids (int)
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full = kv_full + 1;  // slot s holds its q tile
  uint64_t* empty = full + kS;   // every consumer warp is done with slot s

  const Mask mk = p.mask;
  const int hkv = p.hq / p.group;
  // The grid is (KV heads, KV tiles), so that the blocks run tile by tile,
  // KV tile 0 (the longest causal q loop) first across every head.
  const int b = blockIdx.x / hkv;
  const int hk = blockIdx.x % hkv;
  const int c0 = blockIdx.y * kBr;
  const int c1 = min(c0 + kBr, mk.lk);
  // The block's q tiles [i_lo, i_hi) for each head of the group: the union
  // of its warps' ranges.
  const int i_lo = mk.q_first(c0) / kBq;
  const int q_end = mk.q_end(c1);
  const int i_hi = q_end > 0 ? (q_end + kBq - 1) / kBq : 0;
  const int* q_ids = p.q_ids ? p.q_ids + (long long)b * mk.lq : nullptr;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], 32);  // the TMA lane's and the statistics' arrivals
      sm90::mbar_init(&empty[s], 32 * kF32Warps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  // The walk: group x (i_hi - i_lo) q tiles.  Warp 0 also
  // produces: tile n into its ring slot once every warp has released the
  // slot's previous tile, the q rows' statistics by its lanes, the TMA loads
  // by lane 0.
  const int per_head = max(i_hi - i_lo, 0);
  const int n_tiles = p.group * per_head;
  auto issue = [&](int n) {
    const int s = n % kS;
    const int gi = n / per_head;
    const int i = i_lo + n % per_head;
    const int h = hk * p.group + gi;
    const long long stat = ((long long)b * p.hq + h) * mk.lq;
    sm90::mbar_wait(&empty[s], ((n / kS) & 1) ^ 1);
    float* st = sStats + s * 3 * kBq;
    for (int x = lane; x < kBq; x += 32) {
      const int row = i * kBq + x;
      const bool in = row < mk.lq;
      st[x] = in ? lse_log2(p.lse[stat + row]) : 0.f;
      st[kBq + x] = in ? p.di[stat + row] : 0.f;
      reinterpret_cast<int*>(st)[2 * kBq + x] = q_ids != nullptr && in ? q_ids[row] : -1;
    }
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&full[s], 2 * C::kTileBytes);
      for (int c = 0; c < D / 32; ++c) {
        const int off = s * kTile + c * kBq * 32;
        sm90::tma_load_4d(sQ + off, &maps.q, &full[s], c * 32, i * kBq, h, b);
        sm90::tma_load_4d(sDo + off, &maps.dout, &full[s], c * 32, i * kBq, h, b);
      }
    } else {
      sm90::mbar_arrive(&full[s]);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(kv_full, 2 * C::kPinnedBytes);
      for (int c = 0; c < D / 32; ++c) {
        sm90::tma_load_4d(sK + c * kBr * 32, &maps.k, kv_full, c * 32, c0, hk, b);
        sm90::tma_load_4d(sV + c * kBr * 32, &maps.v, kv_full, c * 32, c0, hk, b);
      }
    }
    for (int n = 0; n < min(kS, n_tiles); ++n) issue(n);
  }

  const int cw = warp;  // this warp's 16 KV rows of the block
  const int g = lane / 4;
  const int t = lane % 4;
  const int cw0 = c0 + 16 * cw;
  const bool active = cw0 < mk.lk;
  int my_lo = 0, my_hi = 0;  // this warp's q tiles, the same for each head
  if (active) {
    my_lo = mk.q_first(cw0) / kBq;
    const int end = mk.q_end(min(cw0 + 16, mk.lk));
    my_hi = end > 0 ? (end + kBq - 1) / kBq : 0;
  }
  const int row_a = cw0 + g;  // this thread's KV rows: row_a, row_a + 8
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
  float* sKlo = nullptr;
  float* sVlo = nullptr;
  if constexpr (C::kPreSplit) {
    sKlo = reinterpret_cast<float*>(smem + C::kOffLo);
    sVlo = sKlo + kBr * D;
    split_pinned<kBr, D>(sK, sKlo, 16 * cw, lane);
    split_pinned<kBr, D>(sV, sVlo, 16 * cw, lane);
  }

  // One walk over the block's q tiles, every head of the group in turn,
  // adding to dV and dK.
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kS;
    const int i = i_lo + n % per_head;
    sm90::mbar_wait(&full[s], (n / kS) & 1);
    if (i >= my_lo && i < my_hi) {
      const float* q_s = sQ + s * kTile;
      const float* do_s = sDo + s * kTile;
      const float* stats = sStats + s * 3 * kBq;
      const int* ids = reinterpret_cast<const int*>(stats + 2 * kBq);
      const int r0 = i * kBq;
      // S^T = K q^T and dP^T = V dO^T over the head dim
      float st[kBq / 8][4], dpt[kBq / 8][4];
      products_nt<kBr, kBq, D, C::kPreSplit>(st, sK, sKlo, q_s, dpt, sV, sVlo, do_s, 16 * cw, g, t);

      // P^T = exp2(S^T scale log2 e - lse log2 e), 0 where masked, in st.
      // Columns are q rows: their lse and di come from the slot, two
      // adjacent columns at a time.
      const bool masked = q_ids != nullptr || !mk.tile_visible(r0, kBq, cw0, 16);
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
          st[nb][e] = ok ? exp2_ftz(fmaf(st[nb][e], p.scale_log2, -(x ? l2.y : l2.x))) : 0.f;
        }
      }
      // dV += P^T dO
      {
        uint32_t ph[kBq / 8][4], pl[kBq / 8][4];
        frags_of<kBq>(ph, pl, st);
        add_product<kBq, D>(dv, ph, pl, do_s, g, t);
      }
      // dS^T = P^T (dP^T - di) in dpt, dK += dS^T q
#pragma unroll
      for (int nb = 0; nb < kBq / 8; ++nb) {
        const float2 dd = *reinterpret_cast<const float2*>(stats + kBq + nb * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[nb][e] = st[nb][e] * (dpt[nb][e] - (e & 1 ? dd.y : dd.x));
      }
      uint32_t sh[kBq / 8][4], sl[kBq / 8][4];
      frags_of<kBq>(sh, sl, dpt);
      add_product<kBq, D>(dk, sh, sl, q_s, g, t);
    }
    sm90::mbar_arrive(&empty[s]);
    if (warp == 0 && n + kS < n_tiles) issue(n + kS);
  }
  if (!active) return;
  store_acc_f32<D>(static_cast<float*>(p.dk) + b * p.sdk.sb + hk * p.sdk.sh, p.sdk.sl, dk, p.scale, row_a, mk.lk, t);
  store_acc_f32<D>(static_cast<float*>(p.dv) + b * p.sdv.sb + hk * p.sdv.sh, p.sdv.sl, dv, 1.f, row_a, mk.lk, t);
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// fp32 maps of q, dO, K and V with 32-column boxes (128 bytes, the swizzle's
// span) of q_rows / kv_rows rows; rows past Lq or Lk read as zero.
inline bool make_fp32_maps(BwdMaps& maps, const BwdParams& p, int head_dim, int q_rows, int kv_rows) {
  constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  const Mask& mk = p.mask;
  const int hkv = p.hq / p.group;
  const int d = head_dim;
  bool ok = sm90::make_map_4d(&maps.q, kType, 4, p.q, d, mk.lq, p.hq, p.batch, p.sq.sl, p.sq.sh, p.sq.sb, 32,
                              q_rows, kSw);
  ok = ok && sm90::make_map_4d(&maps.dout, kType, 4, p.dout, d, mk.lq, p.hq, p.batch, p.sdo.sl, p.sdo.sh, p.sdo.sb,
                               32, q_rows, kSw);
  ok = ok && sm90::make_map_4d(&maps.k, kType, 4, p.k, d, mk.lk, hkv, p.batch, p.sk.sl, p.sk.sh, p.sk.sb, 32,
                               kv_rows, kSw);
  ok = ok && sm90::make_map_4d(&maps.v, kType, 4, p.v, d, mk.lk, hkv, p.batch, p.sv.sl, p.sv.sh, p.sv.sb, 32,
                               kv_rows, kSw);
  return ok;
}

// K2: a grid over KV tiles and KV heads.
template <int D>
cudaError_t launch_dkv_fp32(const BwdParams& p, cudaStream_t stream) {
  using C = DkvF32Cfg<D>;
  BwdMaps maps{};
  if (!make_fp32_maps(maps, p, D, C::kStream, C::kPinned)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_fp32_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * (p.hq / p.group), (p.mask.lk + C::kPinned - 1) / C::kPinned);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(p, maps);
  return cudaGetLastError();
}

// K3: a grid over q tiles and q heads.
template <int D>
cudaError_t launch_dq_fp32(const BwdParams& p, cudaStream_t stream) {
  using C = DqF32Cfg<D>;
  BwdMaps maps{};
  if (!make_fp32_maps(maps, p, D, C::kPinned, C::kStream)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_fp32_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.hq, (p.mask.lq + C::kPinned - 1) / C::kPinned);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(p, maps);
  return cudaGetLastError();
}

}  // namespace fa
