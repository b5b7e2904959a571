// The fp32 backward at padded head dims 256, 512 and 1024 on the tensor
// cores in 3xTF32: K2 (dK, dV; fa_flash_bwd_dkv) and K3 (dQ;
// fa_flash_bwd_dq) for dtype 0.  flash_bwd_fp32_wide.cu instantiates D =
// 256 and 512, flash_bwd_fp32_wide_d1024.cu D = 1024, each in a source of
// its own so that they compile beside the rest; flash_bwd.cu's run() calls
// them.
//
// Replaces, at these head dims (the entry points zero-pad 129-256 to 256,
// 257-512 to 512 and 513-1024 to 1024; zero columns add nothing to S or
// dP and give zero gradient columns): flash_attention_tpu/kernels/
// flash_attention.py::_dkv_kernel (K2, launched by _bwd_dkv through
// pl.pallas_call) and ::_dq_kernel (K3, launched by _bwd_dq) at fp32, where
// JAX runs every product at Precision.HIGHEST.  The function is
// flash_bwd_fp32.cuh's (64 and 128): P = exp2(S sm_scale log2(e) - lse
// log2(e)) from unscaled q K^T, 0 where masked, and a row that sees no key
// (lse = -inf) gives P = 0 (lse_log2); dS = P (dP - di) with the pre-pass's
// di; dV = P^T dO, dK = sm_scale dS^T q, dQ = sm_scale dS K, sm_scale
// applied at the store; P and dS stay fp32 and are split like any other
// operand; causal end-aligned masking, window, segment ids, GQA (K2 walks
// every q head of the group in the block, no atomics), ragged Lq / Lk,
// inputs read through their strides.
//
// What bounds it on this card: at b8 h12 L1024 causal K2's four products
// are 103 / 206 / 412 GFLOP at D = 256 / 512 / 1024 and K3's three 77 /
// 155 / 309, 0.625 / 1.249 / 2.499 and 0.469 / 0.937 / 1.874 ms at 165
// TFLOP/s (TF32's 495 over the three passes of 3xTF32), against 604 / 1208
// / 2416 MB (K2) of fp32 q, k, v, dO, dK and dV: their operations.  What
// stands in the way is room, as in the fp32 forward of
// flash_fwd_fp32_wide.cuh: flash_bwd_fp32.cuh's warp owns 16 pinned rows
// and all D gradient columns, and at D = 128 K2's dK and dV take 128
// registers of its 255.  Design:
//   * column slabs, as the wide fp32 forward: a warp owns 128 gradient
//     columns of 16 pinned rows (K2: dK and dV, 128 registers; K3: dQ, 64),
//     and the kG warps of a 16-row group split its columns; eight warps a
//     block, 64 KB of each pinned operand (K and V for K2, q and dO for
//     K3).  Warp c computes partial S and dP over its 128 columns of the
//     pinned and streamed operands (slab_nt: fragments loaded by
//     ldmatrix, the cross passes summed apart from hi hi), writes both to
//     shared memory and, after a barrier of the
//     group, sums the group's partials in one fixed order (exchange), so
//     that every warp of the group holds the same S and dP bit for bit and
//     computes the same P and dS; then P^T / dS^T (K2) or dS (K3) are the A
//     operand straight from the accumulator layout (frags_of), against the
//     warp's 128 columns of the streamed tile, each tile's part summed from
//     zero and added in fp32 (add_product; the tensor cores truncate what
//     they add);
//   * at D = 1024 a cluster of two blocks splits the columns: each holds
//     512 of them for 32 pinned rows (D512's room, so 16-row tiles fit
//     where one block could stream only 8).  Each block sums its group's
//     partials once (a named barrier of the group, a quarter of the values
//     a warp), and after one cluster barrier a tile every warp adds the
//     other block's sum, read through distributed shared memory, block 0's
//     first; 12-14% faster than one block with 8-row tiles with every
//     remote partial read by every warp, and that exchange 16-22% slower
//     than this one (tools/d256_ab.py in turns, PERF.md);
//   * every split leaves lo unrounded (split_tf32<false>: mma.sync reads
//     only a TF32's bits), three operations instead of five: the splits
//     are most of these kernels' instructions, and it was 3-15% faster;
//   * two streamed operands on rings of their own: K3's V is read only by
//     dP and released right after it, its K by S, the mask's segment ids
//     and dQ; K2's dO by dP^T and dV, its q (with the q rows' lse log2(e),
//     di and segment ids) by S^T, the mask, dS^T and dK.  A tile computes
//     dP first, so that each operand's next tile loads while the other's
//     products run.  One slot of each, two for K2 at D = 256, whose 16-row
//     tiles leave room (3% faster);
//   * the exchange's partials are double-buffered where room allows (in a
//     block, one barrier a tile), and single-buffered with a second named
//     barrier before they are written for K3 at D = 256, whose 32-row
//     tiles (14% faster than 16-row tiles in two slots) leave no room for
//     two;
//   * warp 0 also produces, as in the other fp32 kernels: its lanes issue
//     the TMA loads of its block's columns (fp32, 32-column boxes, the
//     128-byte swizzle; rows past Lq or Lk read as zero) and stage K2's
//     q-row statistics and the segment ids with plain loads, each slot once
//     every thread has released it;
//   * the grid is (heads x blocks of a cluster, tiles), the longest causal
//     loop first across every head; every warp waits on and releases every
//     tile of the block's walk, and a group computes only its own range.
// Tiles<K2, D> sets the streamed rows, the ring slots, the buffering and
// the cluster: K2 16 rows in two slots at D = 256, K3 32 rows
// single-buffered there; 16 rows in one slot at 512 and at 1024 (a
// cluster).  What holds it (PERF.md): the splits of every mma.sync's
// operands (the pinned ones are re-split every tile), one slot of each
// operand at 512 and 1024, K2's 255 registers, and at 1024 the cluster's
// barrier and remote reads of every tile.
// ptxas -v (sm_90a, CUDA 12.8): K2 255 / 255 / 254 registers at D = 256 /
// 512 / 1024, K3 253 / 211 / 223; no spills.
//
// The kernels allocate nothing and launch on the caller's stream;
// cudaGetLastError() goes back to the C entry point, and
// cudaErrorInvalidValue when a tensor map cannot be made.
#pragma once

#include "flash_bwd_fp32.cuh"

namespace fa {
namespace bwd32 {

// The tiling each kernel (K2 true, K3 false) and head dim is built with:
// rows of each streamed tile, ring slots of each streamed operand, whether
// the partials are double-buffered, and the blocks of a cluster that split
// the columns (kernels/block_sizes.py::KERNEL_FP32_WIDE_BWD mirrors it).
template <int STREAM, int STAGES, bool DOUBLE, int CTAS>
struct TilesOf {
  static constexpr int kStream = STREAM;
  static constexpr int kStages = STAGES;
  static constexpr bool kDouble = DOUBLE;
  static constexpr int kCTAs = CTAS;
};
template <bool K2, int D> struct Tiles;
template <> struct Tiles<true, 256> : TilesOf<16, 2, true, 1> {};
template <> struct Tiles<false, 256> : TilesOf<32, 1, false, 1> {};
template <bool K2> struct Tiles<K2, 512> : TilesOf<16, 1, true, 1> {};
template <bool K2> struct Tiles<K2, 1024> : TilesOf<16, 1, true, 2> {};

// A kernel's room: two pinned operands (K3: q, dO; K2: K, V), the ring
// slots of each streamed operand (K3: K, V; K2: q, dO), the warps' partial
// S and dP, per slot the streamed rows' statistics (K3: KV segment ids; K2:
// lse log2(e), di and q segment ids), the barriers; each block of a
// cluster holds its kDC = D / kCTAs columns of every operand.
template <bool K2, int D>
struct Cfg {
  static_assert(D == 256 || D == 512 || D == 1024, "padded head dims 256, 512 and 1024");
  static constexpr int kCTAs = Tiles<K2, D>::kCTAs;   // blocks of a cluster
  static constexpr int kDC = D / kCTAs;               // columns of a block
  static constexpr int kG = kDC / 128;                // warps of a 16-row group, 128 columns each
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kGroups = kWarps / kG;         // 16-row groups of a block
  static constexpr int kPinned = 16 * kGroups;        // pinned rows of a block
  static constexpr int kStream = Tiles<K2, D>::kStream;  // rows of each streamed tile
  static constexpr int kNB = kStream / 8;
  static constexpr int kStages = Tiles<K2, D>::kStages;
  static constexpr bool kDouble = Tiles<K2, D>::kDouble;
  static constexpr int kBufs = kDouble ? 2 : 1;
  static constexpr int kPinnedBytes = kPinned * kDC * 4;  // one pinned operand
  static constexpr int kTileBytes = kStream * kDC * 4;    // one streamed operand
  static constexpr int kXFloats = 2 * 16 * kStream;       // a warp's partial S and dP
  static constexpr int kOffP2 = kPinnedBytes;             // the second pinned operand
  static constexpr int kOffX = 2 * kPinnedBytes;  // the slots of the streamed operand of S (K3: K; K2: q)
  static constexpr int kOffY = kOffX + kStages * kTileBytes;  // those of dP's (K3: V; K2: dO)
  static constexpr int kOffParts = kOffY + kStages * kTileBytes;
  static constexpr int kOffStats = kOffParts + kBufs * kWarps * kXFloats * 4;
  static constexpr int kStatFloats = 3 * kStream;  // a slot's statistics
  static constexpr int kOffBars = kOffStats + kStages * kStatFloats * 4;
  static constexpr int kBars = 1 + 4 * kStages;  // pinned; full and empty of X and of Y per slot
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;  // + 1024 to align the base for the swizzle
  static_assert(kGroups >= 1 && kGroups <= 15, "whole 128-column slabs, a named barrier a group");
  static_assert(kCTAs == 1 || kDouble, "a cluster exchanges through double-buffered partials");
  static_assert(kStream == 16 || kStream == 32, "a producer lane stages a row; slab_nt's B in pairs of blocks");
  static_assert(kTileBytes % 1024 == 0, "boxes start on the swizzle's 1024-byte period");
  static_assert(kDC / 32 <= 32, "a producer lane loads a box");
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
};

// Four 8 x 4 fp32 blocks of a swizzled tile (ldmatrix's 8 x 8 b16), one
// register each: lane l gives the address of row l % 8 of block l / 8, and
// receives element (l / 4, l % 4) of each block.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// s = A X^T over a warp's 128-column slab, from zero: A the 16 rows from m0
// of a pinned [PR, 128] slab, X a streamed [8 NB, 128] slab (NB even), both
// split as they are read (lo unrounded: split_tf32), their fragments loaded
// by ldmatrix (one instruction and one address for four loads; 3-12%
// faster than plain loads).  hi hi and the two cross passes are summed
// apart (as tf32x3.cuh's scores), at NB = 2 each in two sums that take the
// k8 steps in turn, so that an mma.sync seldom waits on the one before it.
template <int PR, int NB>
__device__ __forceinline__ void slab_nt(float (&s)[NB][4], const float* a, const float* x, int m0, int g, int t) {
  static_assert(NB % 2 == 0, "B fragments are loaded two 8-row blocks at a time");
  constexpr int kChains = NB >= 4 ? 1 : 2;
  const int lane = 4 * g + t;
  // A: blocks (rows m0 + [0, 8) / [8, 16), columns k0 + [0, 4) / [4, 8)), in
  // frag_a's order; B: per pair of 8-row blocks (columns k0, k0 + 4) of
  // each.  A lane's row and 16-byte chunk; the chunk moves by 2 a k8 step,
  // XORed with the row as the swizzle does.
  const int ra = m0 + lane % 8 + 8 * (lane / 8 % 2), ca = lane / 16;
  const int rb = lane % 8 + 8 * (lane / 16), cb = lane / 8 % 2;
  const uint32_t a0 = sm90::smem_addr(a) + 4 * (ra * 32);
  const uint32_t b0 = sm90::smem_addr(x) + 4 * (rb * 32);
  float hh[kChains][NB][4], cr[kChains][NB][4];
#pragma unroll
  for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[ch][nb][e] = cr[ch][nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int ch = kk % kChains;
    const int box = kk / 4;  // 32-column boxes of the slab
    uint32_t ar[4], br[NB][2];
    ldsm_x4(ar, a0 + 4 * (box * PR * 32 + ((((2 * kk) % 8) + ca) ^ (ra % 8)) * 4));
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t r4[4];
      ldsm_x4(r4, b0 + 4 * (box * 8 * NB * 32 + nb * 8 * 32 + ((((2 * kk) % 8) + cb) ^ (rb % 8)) * 4));
      br[nb][0] = r4[0];
      br[nb][1] = r4[1];
      br[nb + 1][0] = r4[2];
      br[nb + 1][1] = r4[3];
    }
    uint32_t ah[4], al[4], bh[NB][2], bl[NB][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32<false>(__uint_as_float(ar[i]), ah[i], al[i]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 2; ++i) split_tf32<false>(__uint_as_float(br[nb][i]), bh[nb][i], bl[nb][i]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(cr[ch][nb], al, bh[nb]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(cr[ch][nb], ah, bl[nb]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(hh[ch][nb], ah, bh[nb]);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h = hh[0][nb][e], c = cr[0][nb][e];
#pragma unroll
      for (int ch = 1; ch < kChains; ++ch) {
        h += hh[ch][nb][e];
        c += cr[ch][nb][e];
      }
      s[nb][e] = h + c;
    }
}

// The float2 index of element pair (j: 0 S, 1 dP; block nb; half e) of a
// lane in a warp's part of the partials.
template <int NB>
__device__ __forceinline__ int part_at(int j, int nb, int e, int lane) {
  return (2 * NB * j + 2 * nb + e) * 32 + lane;
}

// S and dP of a tile summed over the group's warps, in one fixed order, in
// every warp of the group alike, so that they hold the same S and dP bit
// for bit: each warp writes its two [16, 8 NB] partials into its part of
// `parts` (this tile's buffer), and after a barrier over the group reads
// those of the group's kG warps in warp order.  A single-buffered block
// first waits until the group has read the last tile's.  In a cluster the
// group's warps of both blocks take part: each block's sum is made once,
// into its first warp's part, and read once from the other block (22% /
// 16% faster K3 / K2 at D = 1024 than every warp reading every remote
// partial).  The cluster's barrier is every thread's, every tile, so that
// the blocks call this whatever their groups' ranges; `in_range` says
// whether this warp's group sums.
template <class C>
__device__ __forceinline__ void exchange(float (&s)[C::kNB][4], float (&dp)[C::kNB][4], float* parts, int& xn,
                                         int warp, int grp, int lane, uint32_t rank, bool in_range) {
  constexpr int kNB = C::kNB, kG = C::kG, kHalf = C::kXFloats / 2;  // float2s of a warp's part
  if (!in_range && C::kCTAs == 1) return;
  float2* buf = reinterpret_cast<float2*>(parts + (xn % C::kBufs) * C::kWarps * C::kXFloats);
  ++xn;
  if (C::kCTAs == 1 && !C::kDouble && xn > 1) sm90::named_bar_sync(1 + grp, 32 * kG);
  if (in_range) {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        buf[warp * kHalf + part_at<kNB>(0, nb, e, lane)] = make_float2(s[nb][2 * e], s[nb][2 * e + 1]);
        buf[warp * kHalf + part_at<kNB>(1, nb, e, lane)] = make_float2(dp[nb][2 * e], dp[nb][2 * e + 1]);
      }
  }
  if constexpr (C::kCTAs > 1) {
    // The group's own partials first, summed in warp order into its first
    // warp's part, each warp a kG-th of the elements; then, after the
    // cluster's barrier, this block's sum plus the other's, read remotely
    // once (block 0's first: the same float in both).
    constexpr int kElems = 4 * kNB;  // float2s of a lane's part
    static_assert(kElems % kG == 0, "the group's warps split a lane's part");
    float2* first = buf + grp * kG * kHalf;
    sm90::named_bar_sync(1 + grp, 32 * kG);
    if (in_range) {
#pragma unroll
      for (int q = warp % kG; q < kElems; q += kG) {
        float2 sum = first[q * 32 + lane];
#pragma unroll
        for (int w = 1; w < kG; ++w) {
          const float2 x = first[w * kHalf + q * 32 + lane];
          sum.x += x.x;
          sum.y += x.y;
        }
        first[q * 32 + lane] = sum;
      }
    }
    sm90::cluster_sync();
    if (!in_range) return;
    const uint32_t peer = sm90::cluster_addr(first, rank ^ 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = part_at<kNB>(j, nb, e, lane);
          const float2 own = first[at];
          const float2 other = sm90::ld_cluster_f2(peer + 8 * at);
          float(&dst)[kNB][4] = j == 0 ? s : dp;
          dst[nb][2 * e] = own.x + other.x;
          dst[nb][2 * e + 1] = own.y + other.y;
        }
    return;
  }
  sm90::named_bar_sync(1 + grp, 32 * kG);
  if (!in_range) return;
  const float2* own = buf + grp * kG * kHalf;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int at = part_at<kNB>(j, nb, e, lane);
        float2 sum = own[at];
#pragma unroll
        for (int w = 1; w < kG; ++w) {
          const float2 x = own[w * kHalf + at];
          sum.x += x.x;
          sum.y += x.y;
        }
        float(&dst)[kNB][4] = j == 0 ? s : dp;
        dst[nb][2 * e] = sum.x;
        dst[nb][2 * e + 1] = sum.y;
      }
}

// ---------------------------------------------------------------------------
// K3 (dQ): q and dO rows pinned, K and V tiles streamed
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<false, D>::kThreads, 1)
dq_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps maps) {
  using C = Cfg<false, D>;
  constexpr int kBr = C::kPinned, kBc = C::kStream, kG = C::kG, kNB = C::kNB, kS = C::kStages;
  constexpr int kTile = kBc * C::kDC;  // floats of a K or V slot

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDo = reinterpret_cast<float*>(smem + C::kOffP2);
  float* sK = reinterpret_cast<float*>(smem + C::kOffX);  // kS slots each
  float* sV = reinterpret_cast<float*>(smem + C::kOffY);
  float* sParts = reinterpret_cast<float*>(smem + C::kOffParts);  // [buffer][warp] partial S and dP
  int* sIds = reinterpret_cast<int*>(smem + C::kOffStats);         // per slot the K tile's segment ids
  uint64_t* pin_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full_k = pin_full + 1;   // slot s holds its K tile (and ids)
  uint64_t* empty_k = full_k + kS;   // every thread is done with them
  uint64_t* full_v = empty_k + kS;
  uint64_t* empty_v = full_v + kS;

  const Mask mk = p.mask;
  // The grid is (heads, q tiles), so that the blocks run tile by tile, the
  // longest causal KV loops first across every head.
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x / C::kCTAs;
  const uint32_t rank = C::kCTAs > 1 ? sm90::cluster_rank() : 0;  // the block's columns: rank kDC on
  const int col0 = rank * C::kDC;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int r0 = tile * kBr;
  const int* kv_ids = p.kv_ids ? p.kv_ids + (long long)b * mk.lk : nullptr;
  // The block's KV tiles [j_lo, j_hi): the union of its groups' ranges.
  const int j_lo = mk.kv_first(r0) / kBc;
  const int kv_end = mk.kv_end(min(r0 + kBr, mk.lq));
  const int j_hi = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(pin_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full_k[s], 32);  // every producer lane
      sm90::mbar_init(&full_v[s], 32);
      sm90::mbar_init(&empty_k[s], C::kThreads);
      sm90::mbar_init(&empty_v[s], C::kThreads);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The warp's index broadcast from lane 0, so that ptxas sees every branch
  // on it as uniform.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int n_tiles = max(j_hi - j_lo, 0);
  // Warp 0 also produces: the K (v_part false, with its segment ids) or V
  // tile of walk step `it` (KV tile j_lo + it), the block's columns, into
  // its ring slot once every thread has released the slot's last one.
  // Lane 0 expects the bytes, each lane issues a box and stages a row's id.
  auto issue = [&](int it, bool v_part) {
    const int s = it % kS;
    const int j = j_lo + it;
    uint64_t* full = v_part ? &full_v[s] : &full_k[s];
    sm90::mbar_wait(v_part ? &empty_v[s] : &empty_k[s], ((it / kS) & 1) ^ 1);
    if (!v_part && kv_ids != nullptr && lane < kBc)
      sIds[s * C::kStatFloats + lane] = j * kBc + lane < mk.lk ? kv_ids[j * kBc + lane] : -1;
    if (lane == 0) sm90::mbar_arrive_expect_tx(full, C::kTileBytes);
    __syncwarp();
    if (lane < C::kDC / 32)
      sm90::tma_load_4d((v_part ? sV : sK) + s * kTile + lane * kBc * 32, v_part ? &maps.v : &maps.k, full,
                        col0 + lane * 32, j * kBc, hk, b);
    if (lane != 0) sm90::mbar_arrive(full);
  };
  if (warp == 0) {
    if (lane == 0) sm90::mbar_arrive_expect_tx(pin_full, 2 * C::kPinnedBytes);
    __syncwarp();
    if (lane < C::kDC / 32) {
      sm90::tma_load_4d(sQ + lane * kBr * 32, &maps.q, pin_full, col0 + lane * 32, r0, h, b);
      sm90::tma_load_4d(sDo + lane * kBr * 32, &maps.dout, pin_full, col0 + lane * 32, r0, h, b);
    }
    for (int it = 0; it < min(kS, n_tiles); ++it) {
      issue(it, true);
      issue(it, false);
    }
  }

  const int g = lane / 4;
  const int t = lane % 4;
  const int grp = warp / kG;  // this warp's 16-row group
  const int c = warp % kG;    // and its 128 gradient columns
  const int wr0 = r0 + 16 * grp;
  const bool active = wr0 < mk.lq;
  int my_lo = 0, my_hi = 0;  // the group's KV tiles
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
  // This warp's slabs: columns [128 c, 128 c + 128) start 128 c rows' worth
  // of 32-column boxes in.
  const float* qa = sQ + c * 128 * kBr;
  const float* da = sDo + c * 128 * kBr;
  const float* k_slabs = sK + c * 128 * kBc;  // of slot 0
  const float* v_slabs = sV + c * 128 * kBc;
  sm90::mbar_wait(pin_full, 0);

  float acc[16][4];  // dQ's 128 columns of this warp
#pragma unroll
  for (int nd = 0; nd < 16; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  int xn = 0;  // the group's tiles so far: the partials' buffer
  for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
    const int s = it % kS;
    const uint32_t phase = (it / kS) & 1;
    const bool in_range = j >= my_lo && j < my_hi;
    const float* k_slab = k_slabs + s * kTile;
    float sc[kNB][4], dp[kNB][4];
    // dP = dO V^T over this warp's slab; V is read by nothing else
    sm90::mbar_wait(&full_v[s], phase);
    if (in_range) slab_nt<kBr, kNB>(dp, da, v_slabs + s * kTile, 16 * grp, g, t);
    sm90::mbar_arrive(&empty_v[s]);
    if (warp == 0 && it + kS < n_tiles) issue(it + kS, true);
    sm90::mbar_wait(&full_k[s], phase);
    // S = q K^T, then both summed over the group
    if (in_range) slab_nt<kBr, kNB>(sc, qa, k_slab, 16 * grp, g, t);
    exchange<C>(sc, dp, sParts, xn, warp, grp, lane, rank, in_range);
    if (in_range) {
      // dS = P (dP - di) with P = exp2(S scale log2 e - lse log2 e), 0
      // where masked (element mask only where the tile crosses the
      // diagonal, the window edge or a ragged end, or has segment ids)
      const int c0 = j * kBc;
      const bool masked = kv_ids != nullptr || !mk.tile_visible(wr0, 16, c0, kBc);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int cl = nb * 8 + 2 * t + (e & 1);
          bool ok = true;
          if (masked) {
            ok = c0 + cl >= lo[r] && c0 + cl <= hi[r];
            if (kv_ids != nullptr) ok = ok && q_id[r] == sIds[s * C::kStatFloats + cl];
          }
          const float pr = ok ? exp2_ftz(fmaf(sc[nb][e], p.scale_log2, -lse2[r])) : 0.f;
          dp[nb][e] = pr * (dp[nb][e] - di[r]);
        }
      // dQ += dS K over this warp's slab
      uint32_t dsh[kNB][4], dsl[kNB][4];
      frags_of<kBc, false>(dsh, dsl, dp);
      add_product<kBc, 128, false>(acc, dsh, dsl, k_slab, g, t);
    }
    sm90::mbar_arrive(&empty_k[s]);  // after the tile's last read of K and its ids
    if (warp == 0 && it + kS < n_tiles) issue(it + kS, false);
  }
  if constexpr (C::kCTAs > 1) sm90::cluster_sync();  // the other block has read this one's partials
  if (!active) return;
  store_acc_f32<128>(static_cast<float*>(p.dq) + b * p.sdq.sb + h * p.sdq.sh + col0 + c * 128, p.sdq.sl, acc,
                     p.scale, row_a, mk.lq, t);
}

// ---------------------------------------------------------------------------
// K2 (dK/dV): K and V rows pinned, q and dO tiles of every head of the
// group streamed
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<true, D>::kThreads, 1)
dkv_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps maps) {
  using C = Cfg<true, D>;
  constexpr int kBr = C::kPinned, kBq = C::kStream, kG = C::kG, kNB = C::kNB, kS = C::kStages;
  constexpr int kTile = kBq * C::kDC;  // floats of a q or dO slot

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = reinterpret_cast<float*>(smem + C::kOffP2);
  float* sQ = reinterpret_cast<float*>(smem + C::kOffX);  // kS slots each
  float* sDo = reinterpret_cast<float*>(smem + C::kOffY);
  float* sParts = reinterpret_cast<float*>(smem + C::kOffParts);
  float* sStats = reinterpret_cast<float*>(smem + C::kOffStats);  // per slot the q tile's lse2, di, ids (int)
  uint64_t* pin_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full_q = pin_full + 1;  // slot s holds its q tile (and statistics)
  uint64_t* empty_q = full_q + kS;
  uint64_t* full_do = empty_q + kS;
  uint64_t* empty_do = full_do + kS;

  const Mask mk = p.mask;
  const int hkv = p.hq / p.group;
  // The grid is (KV heads, KV tiles), so that the blocks run tile by tile,
  // KV tile 0 (the longest causal q loop) first across every head.
  const int b = blockIdx.x / C::kCTAs / hkv;
  const int hk = blockIdx.x / C::kCTAs % hkv;
  const uint32_t rank = C::kCTAs > 1 ? sm90::cluster_rank() : 0;  // the block's columns: rank kDC on
  const int col0 = rank * C::kDC;
  const int c0 = blockIdx.y * kBr;
  const int c1 = min(c0 + kBr, mk.lk);
  // The block's q tiles [i_lo, i_hi) for each head of the group: the union
  // of its groups' ranges.
  const int i_lo = mk.q_first(c0) / kBq;
  const int q_end = mk.q_end(c1);
  const int i_hi = q_end > 0 ? (q_end + kBq - 1) / kBq : 0;
  const int* q_ids = p.q_ids ? p.q_ids + (long long)b * mk.lq : nullptr;

  if (threadIdx.x == 0) {
    sm90::mbar_init(pin_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full_q[s], 32);
      sm90::mbar_init(&full_do[s], 32);
      sm90::mbar_init(&empty_q[s], C::kThreads);
      sm90::mbar_init(&empty_do[s], C::kThreads);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  // The walk: group x (i_hi - i_lo) q tiles, every head of the group in
  // turn.  Warp 0 also produces: the q (do_part false, with its rows'
  // statistics) or dO tile of walk step n, the block's columns, into its
  // ring slot once every thread has released the slot's last one.
  const int per_head = max(i_hi - i_lo, 0);
  const int n_tiles = p.group * per_head;
  auto issue = [&](int n, bool do_part) {
    const int i = i_lo + n % per_head;
    const int h = hk * p.group + n / per_head;
    const int s = n % kS;
    uint64_t* full = do_part ? &full_do[s] : &full_q[s];
    sm90::mbar_wait(do_part ? &empty_do[s] : &empty_q[s], ((n / kS) & 1) ^ 1);
    if (!do_part && lane < kBq) {
      const int row = i * kBq + lane;
      const bool in = row < mk.lq;
      const long long stat = ((long long)b * p.hq + h) * mk.lq;
      float* st = sStats + s * C::kStatFloats;
      st[lane] = in ? lse_log2(p.lse[stat + row]) : 0.f;
      st[kBq + lane] = in ? p.di[stat + row] : 0.f;
      reinterpret_cast<int*>(st)[2 * kBq + lane] = q_ids != nullptr && in ? q_ids[row] : -1;
    }
    if (lane == 0) sm90::mbar_arrive_expect_tx(full, C::kTileBytes);
    __syncwarp();
    if (lane < C::kDC / 32)
      sm90::tma_load_4d((do_part ? sDo : sQ) + s * kTile + lane * kBq * 32, do_part ? &maps.dout : &maps.q, full,
                        col0 + lane * 32, i * kBq, h, b);
    if (lane != 0) sm90::mbar_arrive(full);
  };
  if (warp == 0) {
    if (lane == 0) sm90::mbar_arrive_expect_tx(pin_full, 2 * C::kPinnedBytes);
    __syncwarp();
    if (lane < C::kDC / 32) {
      sm90::tma_load_4d(sK + lane * kBr * 32, &maps.k, pin_full, col0 + lane * 32, c0, hk, b);
      sm90::tma_load_4d(sV + lane * kBr * 32, &maps.v, pin_full, col0 + lane * 32, c0, hk, b);
    }
    for (int n = 0; n < min(kS, n_tiles); ++n) {
      issue(n, true);
      issue(n, false);
    }
  }

  const int g = lane / 4;
  const int t = lane % 4;
  const int grp = warp / kG;  // this warp's 16 KV rows
  const int c = warp % kG;    // and its 128 gradient columns
  const int cw0 = c0 + 16 * grp;
  const bool active = cw0 < mk.lk;
  int my_lo = 0, my_hi = 0;  // the group's q tiles, the same for each head
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
    const int kc = row_a + 8 * r;
    lo[r] = 0;
    hi[r] = mk.lq - 1;
    if (kc >= mk.lk) {
      lo[r] = mk.lq;
      hi[r] = -1;
    } else if (mk.causal) {
      lo[r] = max(kc - offset, 0);
      if (mk.window > 0) hi[r] = min(kc - offset + mk.window - 1, mk.lq - 1);
    }
    if (p.kv_ids != nullptr && kc < mk.lk) kv_id[r] = p.kv_ids[(long long)b * mk.lk + kc];
  }
  const float* ka = sK + c * 128 * kBr;
  const float* va = sV + c * 128 * kBr;
  const float* q_slabs = sQ + c * 128 * kBq;  // of slot 0
  const float* do_slabs = sDo + c * 128 * kBq;
  sm90::mbar_wait(pin_full, 0);

  float dk[16][4], dv[16][4];  // this warp's 128 columns of dK and dV
#pragma unroll
  for (int nd = 0; nd < 16; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  int xn = 0;
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kS;
    const uint32_t phase = (n / kS) & 1;
    const int i = i_lo + n % per_head;
    const bool in_range = i >= my_lo && i < my_hi;
    const float* q_slab = q_slabs + s * kTile;
    const float* do_slab = do_slabs + s * kTile;
    const float* stats = sStats + s * C::kStatFloats;
    float st[kNB][4], dpt[kNB][4];
    sm90::mbar_wait(&full_do[s], phase);
    // dP^T = V dO^T over this warp's slab
    if (in_range) slab_nt<kBr, kNB>(dpt, va, do_slab, 16 * grp, g, t);
    sm90::mbar_wait(&full_q[s], phase);
    // S^T = K q^T, then both summed over the group
    if (in_range) slab_nt<kBr, kNB>(st, ka, q_slab, 16 * grp, g, t);
    exchange<C>(st, dpt, sParts, xn, warp, grp, lane, rank, in_range);
    if (in_range) {
      // P^T = exp2(S^T scale log2 e - lse log2 e), 0 where masked, and
      // dS^T = P^T (dP^T - di): columns are q rows, whose statistics come
      // from the slot, two adjacent columns at a time
      const int r0 = i * kBq;
      const int* ids = reinterpret_cast<const int*>(stats + 2 * kBq);
      const bool masked = q_ids != nullptr || !mk.tile_visible(r0, kBq, cw0, 16);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const int col = nb * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(stats + col);
        const float2 dd = *reinterpret_cast<const float2*>(stats + kBq + col);
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
          dpt[nb][e] = st[nb][e] * (dpt[nb][e] - (x ? dd.y : dd.x));
        }
      }
      // dV += P^T dO, then dK += dS^T q, over this warp's slab
      {
        uint32_t ph[kNB][4], pl[kNB][4];
        frags_of<kBq, false>(ph, pl, st);
        add_product<kBq, 128, false>(dv, ph, pl, do_slab, g, t);
      }
    }
    sm90::mbar_arrive(&empty_do[s]);  // after the tile's last read of dO
    if (warp == 0 && n + kS < n_tiles) issue(n + kS, true);
    if (in_range) {
      uint32_t sh[kNB][4], sl[kNB][4];
      frags_of<kBq, false>(sh, sl, dpt);
      add_product<kBq, 128, false>(dk, sh, sl, q_slab, g, t);
    }
    sm90::mbar_arrive(&empty_q[s]);  // after the tile's last read of q and its statistics
    if (warp == 0 && n + kS < n_tiles) issue(n + kS, false);
  }
  if constexpr (C::kCTAs > 1) sm90::cluster_sync();  // the other block has read this one's partials
  if (!active) return;
  store_acc_f32<128>(static_cast<float*>(p.dk) + b * p.sdk.sb + hk * p.sdk.sh + col0 + c * 128, p.sdk.sl, dk,
                     p.scale, row_a, mk.lk, t);
  store_acc_f32<128>(static_cast<float*>(p.dv) + b * p.sdv.sb + hk * p.sdv.sh + col0 + c * 128, p.sdv.sl, dv, 1.f,
                     row_a, mk.lk, t);
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// K2 (which 0: a grid over KV heads and KV tiles) or K3 (1: over q heads and
// q tiles) at head dim D.
template <bool K2, int D>
cudaError_t launch_one(const BwdParams& p, cudaStream_t stream) {
  using C = Cfg<K2, D>;
  BwdMaps maps{};
  if (!make_fp32_maps(maps, p, D, K2 ? C::kStream : C::kPinned, K2 ? C::kPinned : C::kStream))
    return cudaErrorInvalidValue;
  auto kernel = K2 ? dkv_kernel<D> : dq_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int heads = K2 ? p.batch * (p.hq / p.group) : p.batch * p.hq;
  const int rows = K2 ? p.mask.lk : p.mask.lq;
  // (heads x blocks of a cluster, tiles); the cluster's blocks adjacent in x
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads * C::kCTAs, (rows + C::kPinned - 1) / C::kPinned);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C::kCTAs;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = C::kCTAs > 1 ? 1 : 0;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, p, maps);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

template <int D>
cudaError_t launch(int which, const BwdParams& p, cudaStream_t stream) {
  return which == 0 ? launch_one<true, D>(p, stream) : launch_one<false, D>(p, stream);
}

}  // namespace bwd32
}  // namespace fa
