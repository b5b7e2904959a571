// The fp32 forward at padded head dims 256, 512 and 1024 on the tensor
// cores in 3xTF32: K1 (fa_flash_fwd) and K4 (fa_flash_fwd_kv_quant) for
// dtype 0, reached through flash_fwd.cuh's launch_fwd_for.
// flash_fwd_fp32_wide.cu instantiates D = 256 and 512,
// flash_fwd_fp32_wide_d1024.cu D = 1024, each in a source of its own so
// that they compile beside the rest.
//
// Replaces, at these head dims (the entry points zero-pad 129-256 to 256,
// 257-512 to 512 and 513-1024 to 1024; zero columns add nothing to a score
// and give zero output columns, so the numbers are JAX's, which pads to a
// multiple of 8): flash_attention_tpu/kernels/flash_attention.py::
// _fwd_kernel (K1, launched by _fwd through pl.pallas_call) and
// flash_attention_tpu/quant/kv.py::_fwd_quant_kernel (K4) at fp32, where
// JAX runs both products at Precision.HIGHEST.  The function is
// flash_fwd_fp32.cu's: q scaled by sm_scale * log2(e) in fp32, online
// softmax in the exp2 domain, P kept in fp32 before PV, m, l and O in fp32,
// one final division with the l == 0 guard, lse in natural log (the
// 3xTF32 backward of flash_bwd_fp32_wide.cuh reads it); causal end-aligned
// masking, window, segment ids, GQA by reading KV head h / group, ragged Lq
// / Lk, inputs read through their strides; K4's K/V are payload.to(fp32) *
// scale.
//
// What bounds it on this card: at b8 h12 L1024 causal the two products are
// 51.5 / 103 / 206 GFLOP at D = 256 / 512 / 1024, 0.312 / 0.625 / 1.249 ms
// at 165 TFLOP/s (TF32's 495 over the three passes of 3xTF32), against 201
// / 403 / 805 MB of fp32 q, k, v and o (0.060 / 0.120 / 0.240 ms): its
// operations.  What stands in the way at this width is room, not
// arithmetic: flash_fwd_fp32.cu's warp owns 16 query rows and all D output
// columns, and at D = 128 that already takes 253 registers.  Design:
//   * column slabs: a warp owns 128 output columns of 16 query rows, so
//     kG = D / 128 warps (2 / 4 / 8) serve each 16-row group, and eight
//     warps pin 64 / 32 / 16 query rows (q is 64 KB at every head dim).
//     Warp c of a group computes the partial S over q's and K's columns
//     [128 c, 128 c + 128) (the cross passes summed apart from hi hi, as in
//     flash_fwd_fp32.cu), writes it to shared memory and, after a named
//     barrier of the group, sums the kG partials in one fixed order, so
//     that every warp of the group holds the same S bit for bit and runs
//     the same masked online softmax: m and l agree, and each warp scales,
//     accumulates (O += P V over its 128 columns of V, each tile's part
//     summed from zero and added in fp32: add_product) and divides its own
//     columns.  The partials are double-buffered by tile parity, so one
//     barrier a tile suffices;
//   * no column is split or read twice by the block's S: each K column is
//     split by one warp of each group (at D = 1024, by one warp of the
//     block), against all eight at D = 128;
//   * warp 0 also produces, as in flash_fwd_fp32.cu: its lanes issue the
//     TMA loads (fp32: 32-column boxes with the 128-byte swizzle; K4's
//     payloads: 128-column boxes with the 128-byte swizzle, read straight
//     into the B fragments by PayloadBoxes) of kStream-row K tiles and of
//     the block's columns of V tiles into a ring of kStages slots, and
//     stage the segment ids and K4's scales (plain loads: their row stride
//     breaks TMA's 16-byte rule).  K and V have full and empty mbarriers of
//     their own, so that the next K tile loads while PV runs and the next
//     V while S runs, with one slot of each; each is released only after
//     the tile's last read of it (K after S and the mask, which reads the
//     ids; V after PV), scales included;
//   * the grid is (heads, q tiles), the longest causal KV loop
//     first across every head; every warp waits on and releases every tile
//     of the block's walk, and computes only its group's range;
//   * Tiles<D> sets kStream and whether q is split once into hi and lo
//     (kPre; a lo copy is another 64 KB) or split as
//     it is read.  A K + V tile is 2 / 4 / 8 KB a KV row, so the ring's
//     rows and stages trade against q's lo copy in 227 KB.  Timed in turns
//     at b8 h12 L1024 (tools/d256_ab.py --dtype float32; PERF.md), the keys
//     a tile decide it: the exchange, its barrier, the mbarrier waits and
//     the softmax are paid once a tile and an A fragment of q serves kStream
//     / 8 products, so 32-row tiles beat 16 by 15% at D = 256 (q split
//     once) and by 9% at D = 512 (q then split as read, the one way 32 rows
//     fit), and 16 beat 8 by 32% at D = 1024, where 32 rows of K and V (256
//     KB) do not fit; one slot of each ring at every head dim.  Two blocks
//     a query tile of 32 rows at D = 1024, each with half the output
//     columns and S recomputed over all of them (as flash_fwd_wide.cuh
//     does), leave room for one stage of 8 rows beside a 128 KB q, and
//     lost 11% to this design's 8-row tiles (PERF.md, PR 17).
// What holds it: at D = 1024 a block pins 16 query rows, so the blocks
// stream 25.8 GB of K and V through L2 at b8 h12 L1024 causal (3.4 TB/s at
// 7.6 ms; K4's 1-byte payloads run 9% faster than K1 despite their
// conversions), and each k8 step splits 4 q and 4 K values for 6 products.
// ptxas -v (sm_90a, CUDA 12.9): K1 254 / 254 / 230 registers at D = 256 /
// 512 / 1024, K4 253-255 / 252-254 / 236; no spills.
//
// The kernels allocate nothing and launch on the caller's stream;
// cudaGetLastError() goes back to the C entry point, and
// cudaErrorInvalidValue when a tensor map cannot be made.
#pragma once

#include "flash_fwd.cuh"
#include "tf32x3.cuh"

namespace fa {
namespace wide32 {

// The tiling each head dim is built with: KV rows a streamed tile, and q
// split once (kernels/block_sizes.py::KERNEL_FP32_WIDE mirrors it).
template <int STREAM, bool PRE>
struct TilesOf {
  static constexpr int kStream = STREAM;
  static constexpr bool kPre = PRE;
};
template <int D> struct Tiles;
template <> struct Tiles<256> : TilesOf<32, true> {};
template <> struct Tiles<512> : TilesOf<32, false> {};
template <> struct Tiles<1024> : TilesOf<16, false> {};

template <typename KV, int D>
struct Cfg {
  static_assert(D == 256 || D == 512 || D == 1024, "padded head dims 256, 512 and 1024");
  static constexpr bool kQuant = !std::is_same<KV, float>::value;
  static constexpr int kG = D / 128;           // warps of a 16-row group, 128 columns each
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kGroups = kWarps / kG;  // 16-row groups of a block
  static constexpr int kPinned = 16 * kGroups;  // q rows of a block
  static constexpr int kStream = Tiles<D>::kStream;  // KV rows of each streamed tile
  // One slot of each ring: a second does not fit beside these tiles and q.
  static constexpr int kStages = 1;
  static constexpr bool kPre = Tiles<D>::kPre;
  static constexpr int kQBytes = kPinned * D * 4;
  static constexpr int kKBytes = kStream * D * (kQuant ? 1 : 4);  // a K or V tile, or its payload
  static constexpr int kSlotBytes = 2 * kKBytes;                    // K, then V
  static constexpr int kXFloats = 16 * kStream;  // a warp's partial S
  static constexpr int kOffLo = kQBytes;         // q (its hi) at 0, its lo beside it (kPre)
  static constexpr int kOffRing = kOffLo + (kPre ? kQBytes : 0);
  static constexpr int kOffX = kOffRing + kStages * kSlotBytes;  // partials, two per warp (tile parity)
  static constexpr int kOffIds = kOffX + 2 * kWarps * kXFloats * 4;
  static constexpr int kOffScales = kOffIds + kStages * kStream * 4;  // K4: per slot, K's then V's
  static constexpr int kOffBars = kOffScales + (kQuant ? kStages * 2 * kStream * 4 : 0);
  static constexpr int kBars = 1 + 4 * kStages;  // q; full and empty per slot, for K and for V
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;  // + 1024 to align the base for the swizzle
  static_assert(kGroups >= 1 && kGroups <= 15, "whole 128-column slabs, a named barrier a group");
  static_assert(kStream == 8 || kStream == 16 || kStream == 32, "a producer lane stages a row");
  static_assert(kKBytes % 1024 == 0 && kSlotBytes % 1024 == 0, "boxes start on the swizzle's 1024-byte period");
  static_assert(D / 32 <= 32, "a producer lane loads a box");
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
};

// K4: element (r, c) of [ROWS, 128 n] payload columns as TMA writes them:
// 128-column boxes one after the other, each ROWS rows of 128 bytes whose
// 16-byte chunks are permuted by XOR with r % 8, times the row's scale.
template <typename KV, int ROWS>
struct PayloadBoxes {
  const uint8_t* pay;  // the box of column 0
  const float* scale;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int chunk = ((c % 128) / 16) ^ (r % 8);
    return payload_value<KV>(pay[(c / 128) * ROWS * 128 + r * 128 + chunk * 16 + c % 16]) * scale[r];
  }
};

// A warp's 16 rows from m0 of a pinned [PR, D] tile times `scale`, in
// place (q when it is split as it is read).
template <int PR, int D>
__device__ __forceinline__ void scale_pinned(float* tile, int m0, int lane, float scale) {
  for (int i = lane; i < 16 * D; i += 32) tile[swz<PR>(m0 + i / D, i % D)] *= scale;
  __syncwarp();
}

template <typename KV, int D>
__global__ void __launch_bounds__(Cfg<KV, D>::kThreads, 1)
fwd_kernel(const __grid_constant__ FwdParams p, const __grid_constant__ FwdMaps maps) {
  using C = Cfg<KV, D>;
  constexpr int kBr = C::kPinned, kBc = C::kStream, kS = C::kStages, kG = C::kG, kNB = kBc / 8;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  float* sQ = reinterpret_cast<float*>(smem);
  float* sQlo = C::kPre ? reinterpret_cast<float*>(smem + C::kOffLo) : nullptr;
  unsigned char* ring = smem + C::kOffRing;  // kS slots of (K, V)
  float* sX = reinterpret_cast<float*>(smem + C::kOffX);  // [parity][warp] partial S
  int* sIds = reinterpret_cast<int*>(smem + C::kOffIds);  // kS x kBc KV segment ids
  float* sScales = reinterpret_cast<float*>(smem + C::kOffScales);  // K4: kS x (K, V) x kBc
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full_k = q_full + 1;     // slot s holds its K tile (and its ids and K4's K scales)
  uint64_t* empty_k = full_k + kS;   // every thread is done with them
  uint64_t* full_v = empty_k + kS;   // slot s holds its V columns (and K4's V scales)
  uint64_t* empty_v = full_v + kS;

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
  const KvRows<KV> kv(p, b, hk);  // K4: the rows' scales
  // The block's KV tiles [j_lo, j_hi): the union of its groups' ranges.
  const int j_lo = mk.kv_first(r0) / kBc;
  const int kv_end = mk.kv_end(min(r0 + kBr, mk.lq));
  const int j_hi = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full_k[s], 32);  // every producer lane
      sm90::mbar_init(&empty_k[s], C::kThreads);
      sm90::mbar_init(&full_v[s], 32);
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
  // Warp 0 also produces: the K tile and the V columns of tile `it` of the
  // walk (KV tile j_lo + it) into its ring slot, each once every thread has
  // released the slot's previous one (K after S and the mask, V after PV), so
  // that the next K loads while PV runs and the next V while S runs.  Lane 0
  // expects the bytes, each lane issues a box and stages a row's segment id
  // (with K) and K4's scales.
  auto issue = [&](int it, bool v_part) {
    constexpr int kBox = C::kQuant ? 128 : 32;  // columns a box
    const int s = it % kS;
    const int j = j_lo + it;
    uint64_t* full = v_part ? &full_v[s] : &full_k[s];
    sm90::mbar_wait(v_part ? &empty_v[s] : &empty_k[s], ((it / kS) & 1) ^ 1);
    const int row = j * kBc + lane;
    if (lane < kBc) {
      if (kv_ids != nullptr && !v_part) sIds[s * kBc + lane] = row < mk.lk ? kv_ids[row] : -1;
      if constexpr (C::kQuant) {
        const float* scale = v_part ? kv.vs : kv.ks;
        sScales[(2 * s + v_part) * kBc + lane] = row < mk.lk ? scale[row] : 0.f;
      }
    }
    if (lane == 0) sm90::mbar_arrive_expect_tx(full, C::kKBytes);
    __syncwarp();
    unsigned char* slot = ring + s * C::kSlotBytes;
    if (!v_part && lane < D / kBox)
      sm90::tma_load_4d(slot + lane * kBc * 128, &maps.k, full, lane * kBox, j * kBc, hk, b);
    if (v_part && lane < D / kBox)
      sm90::tma_load_4d(slot + C::kKBytes + lane * kBc * 128, &maps.v, full, lane * kBox, j * kBc, hk, b);
    if (lane != 0) sm90::mbar_arrive(full);
  };
  if (warp == 0) {
    if (lane == 0) sm90::mbar_arrive_expect_tx(q_full, C::kQBytes);
    __syncwarp();
    if (lane < D / 32) sm90::tma_load_4d(sQ + lane * kBr * 32, &maps.q, q_full, lane * 32, r0, h, b);
    for (int it = 0; it < min(kS, n_tiles); ++it) {
      issue(it, false);
      issue(it, true);
    }
  }

  const int g = lane / 4;
  const int t = lane % 4;
  const int grp = warp / kG;  // this warp's 16-row group
  const int c = warp % kG;    // and its 128 output columns in the block
  const int wr0 = r0 + 16 * grp;  // the group's 16 q rows
  const bool active = wr0 < mk.lq;
  int my_lo = 0, my_hi = 0;  // the group's KV tiles
  if (active) {
    my_lo = mk.kv_first(wr0) / kBc;
    const int end = mk.kv_end(min(wr0 + 16, mk.lq));
    my_hi = end > 0 ? (end + kBc - 1) / kBc : 0;
  }
  const int row_a = wr0 + g;  // this thread's rows: row_a, row_a + 8
  // Per row: the keys [lo, hi] it sees (Mask::visible: causal, window,
  // ragged ends; empty past Lq) and its segment id.
  int lo[2], hi[2], q_id[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lo[r] = mk.kv_first(row);
    hi[r] = row < mk.lq ? mk.kv_end(row + 1) - 1 : -1;
    if (p.q_ids != nullptr && row < mk.lq) q_id[r] = p.q_ids[(long long)b * mk.lq + row];
  }

  // q scaled by sm_scale * log2(e) in fp32, as the TPU kernel does before
  // its QK^T: this warp's rows and S columns (32-column boxes of kBr rows,
  // so column 128 c starts 128 c kBr floats in), split once when kPre.
  const int q_off = c * 128 * kBr;
  float* qa = sQ + q_off;
  float* qlo = C::kPre ? sQlo + q_off : nullptr;
  sm90::mbar_wait(q_full, 0);
  if constexpr (C::kPre) {
    split_pinned<kBr, 128>(qa, qlo, 16 * grp, lane, p.scale_log2);
  } else {
    scale_pinned<kBr, 128>(qa, 16 * grp, lane, p.scale_log2);
  }

  float acc[16][4];  // O's 128 columns of this warp
#pragma unroll
  for (int nd = 0; nd < 16; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum; quad-summed at the end

  // A tile's S = Qs K^T, then P: [16, kBc] as 8-column blocks.  The lambdas
  // below capture it: a lambda parameter of type reference to an array
  // whose bound depends on the template makes cudafe++ (CUDA 12.9) crash.
  float sc[kNB][4];

  // One tile's S for this warp's rows, summed over the group's partials
  // and masked: K read through kx (an fp32 tile, or K4's payload reader) at
  // this warp's first S column.
  auto scores_of = [&](const auto& kx, int j, int s, int parity) {
    const int c0 = j * kBc;
    scores<kBr, 128, kNB, C::kPre>(sc, qa, qlo, kx, 16 * grp, g, t);
    if constexpr (kG > 1) {
      // The group's partials summed in warp order, in every warp alike.
      float2* mine = reinterpret_cast<float2*>(sX + (parity * C::kWarps + warp) * C::kXFloats);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) mine[(2 * nb + e) * 32 + lane] = make_float2(sc[nb][2 * e], sc[nb][2 * e + 1]);
      sm90::named_bar_sync(1 + grp, 32 * kG);
      const float2* first = reinterpret_cast<const float2*>(sX + (parity * C::kWarps + grp * kG) * C::kXFloats);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float2 sum = first[(2 * nb + e) * 32 + lane];
#pragma unroll
          for (int w = 1; w < kG; ++w) {
            const float2 x = first[w * C::kXFloats / 2 + (2 * nb + e) * 32 + lane];
            sum.x += x.x;
            sum.y += x.y;
          }
          sc[nb][2 * e] = sum.x;
          sc[nb][2 * e + 1] = sum.y;
        }
    }

    // Element mask only where the tile crosses the diagonal, the window
    // edge or the KV end, or where segment ids apply.
    if (kv_ids != nullptr || !mk.tile_visible(wr0, 16, c0, kBc)) {
      const int* ids = sIds + s * kBc;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int cl = nb * 8 + 2 * t + (e & 1);
          bool ok = c0 + cl >= lo[r] && c0 + cl <= hi[r];
          if (kv_ids != nullptr) ok = ok && q_id[r] == ids[cl];
          if (!ok) sc[nb][e] = -CUDART_INF_F;
        }
    }
  };

  // The online softmax of S into P, in place, and O rescaled: rows g (e =
  // 0, 1) and g + 8 (e = 2, 3); the four threads of a quad hold a row
  // between them.
  auto softmax = [&]() {
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float row_max = -CUDART_INF_F;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) row_max = fmaxf(row_max, fmaxf(sc[nb][2 * r], sc[nb][2 * r + 1]));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      const float m_new = fmaxf(m[r], row_max);
      base[r] = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked so far
      alpha[r] = exp2_ftz(m[r] - base[r]);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nb][e] = exp2_ftz(sc[nb][e] - base[e >> 1]);
        sum[e >> 1] += sc[nb][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int nd = 0; nd < 16; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
  };

  // O += P V over this warp's 128 columns, P in fp32 (split like any
  // operand), V read through vx.
  auto add_pv = [&](const auto& vx) {
    uint32_t ph[kNB][4], pl[kNB][4];
    frags_of<kBc>(ph, pl, sc);
    add_product<kBc, 128>(acc, ph, pl, vx, g, t);
  };

  for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
    const int s = it % kS;
    const uint32_t phase = (it / kS) & 1;
    const unsigned char* slot = ring + s * C::kSlotBytes;
    const bool in_range = j >= my_lo && j < my_hi;
    sm90::mbar_wait(&full_k[s], phase);
    if (in_range) {
      if constexpr (C::kQuant) {
        scores_of(PayloadBoxes<KV, kBc>{slot + c * 128 * kBc, sScales + 2 * s * kBc}, j, s, it & 1);
      } else {
        scores_of(reinterpret_cast<const float*>(slot) + c * 128 * kBc, j, s, it & 1);
      }
    }
    sm90::mbar_arrive(&empty_k[s]);  // after the tile's last read of K, its ids and scales
    if (warp == 0 && it + kS < n_tiles) issue(it + kS, false);
    if (in_range) softmax();
    sm90::mbar_wait(&full_v[s], phase);
    if (in_range) {
      const unsigned char* v_slot = slot + C::kKBytes;
      if constexpr (C::kQuant) {
        add_pv(PayloadBoxes<KV, kBc>{v_slot + c * 128 * kBc, sScales + (2 * s + 1) * kBc});
      } else {
        add_pv(reinterpret_cast<const float*>(v_slot) + c * 128 * kBc);
      }
    }
    sm90::mbar_arrive(&empty_v[s]);  // after the tile's last read of V and its scales
    if (warp == 0 && it + kS < n_tiles) issue(it + kS, true);
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* go = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + c * 128;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= mk.lq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    float* orow = go + (long long)row * p.o_sl + 2 * t;
#pragma unroll
    for (int nd = 0; nd < 16; ++nd)
      *reinterpret_cast<float2*>(orow + nd * 8) = make_float2(acc[nd][2 * r] / l_safe, acc[nd][2 * r + 1] / l_safe);
    if (p.lse != nullptr && c == 0 && t == 0)
      p.lse[(long long)bh * mk.lq + row] = (m[r] + log2f(l_safe)) * kLn2;
  }
}

template <typename KV, int D>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  using C = Cfg<KV, D>;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  const Mask& mk = p.mask;
  FwdMaps maps;
  bool ok = sm90::make_map_4d(&maps.q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.q, D, mk.lq, p.hq, p.batch, p.q_sl,
                              p.q_sh, p.q_sb, 32, C::kPinned, kSw);
  if constexpr (C::kQuant) {  // 128-column boxes of payload bytes, for PayloadBoxes
    constexpr CUtensorMapDataType kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
    ok = ok && sm90::make_map_4d(&maps.k, kU8, 1, p.k, D, mk.lk, p.hkv, p.batch, p.k_sl, p.k_sh, p.k_sb, 128,
                                 C::kStream, kSw);
    ok = ok && sm90::make_map_4d(&maps.v, kU8, 1, p.v, D, mk.lk, p.hkv, p.batch, p.v_sl, p.v_sh, p.v_sb, 128,
                                 C::kStream, kSw);
  } else {
    constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    ok = ok && sm90::make_map_4d(&maps.k, kF32, 4, p.k, D, mk.lk, p.hkv, p.batch, p.k_sl, p.k_sh, p.k_sb, 32,
                                 C::kStream, kSw);
    ok = ok && sm90::make_map_4d(&maps.v, kF32, 4, p.v, D, mk.lk, p.hkv, p.batch, p.v_sl, p.v_sh, p.v_sb, 32,
                                 C::kStream, kSw);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = fwd_kernel<KV, D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.hq, (mk.lq + C::kPinned - 1) / C::kPinned);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(p, maps);
  return cudaGetLastError();
}

// K1 (kv_dtype 0, fp32 K/V) and K4 (1 int8, 2 fp8 e4m3) at head dim D.
template <int D>
cudaError_t launch_for(int kv_dtype, const FwdParams& p, cudaStream_t s) {
  if (kv_dtype == 0) return launch<float, D>(p, s);
  if (kv_dtype == 1) return launch<int8_t, D>(p, s);
  if (kv_dtype == 2) return launch<__nv_fp8_e4m3, D>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace wide32
}  // namespace fa
