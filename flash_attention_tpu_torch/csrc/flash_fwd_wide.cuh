// K1 and K4 at padded head dims 512 and 1024 for bf16 and fp16: a
// warp-specialised TMA + wgmma forward whose two consumer warpgroups share
// one 64-row query tile.  flash_fwd_wide.cu instantiates D = 512,
// flash_fwd_wide_d1024.cu D = 1024, each in a source of its own so that they
// compile beside the rest; flash_fwd.cuh's launch_fwd_for calls them for
// fa_flash_fwd and fa_flash_fwd_kv_quant.
//
// Replaces, at these head dims (the entry points zero-pad 257-512 to 512 and
// 513-1024 to 1024): flash_attention_tpu/kernels/flash_attention.py::
// _fwd_kernel (K1) and flash_attention_tpu/quant/kv.py::_fwd_quant_kernel
// (K4).  It computes what flash_fwd.cuh's kernel computes: q scaled by
// sm_scale*log2(e) and rounded to T, the exp2-domain online softmax with
// fp32 m, l and accumulator, P rounded to T before PV, the l == 0 guard,
// lse = (m + log2 l) ln 2 (the wide backward, flash_bwd_wide.cuh, reads
// it), causal alignment to the end of KV, the window, segment ids, GQA,
// ragged Lq / Lk and strides; K4's tiles dequantized as payload.to(T) *
// scale.to(T) rounded to T.
//
// What bounds it: at b8 h12 L1024 causal the two products are 103 GFLOP at
// D = 512 (0.104 ms at 989 TFLOP/s) and 206 GFLOP at D = 1024, and q, k,
// v and o 0.120 / 0.240 ms at 3.35 TB/s, so the bytes set the floor by a
// little; K4's 1-byte K / V make it the products.  What stands in the way
// of the tensor cores at this width is room, not arithmetic:
//   * registers: a 64 x D fp32 accumulator is D / 2 registers a thread of
//     one warpgroup, 256 at D = 512.  Two consumer warpgroups share the
//     block's 64 query rows and split the output columns: warpgroup c
//     accumulates O[:, 256 c .. 256 c + 256) of the block's slab of 512
//     columns (128 registers).  At D = 1024 even that split cannot hold all
//     1024 columns, so a block produces one slab of 512 output columns and
//     the grid has two blocks a query tile (side by side in its x
//     dimension, so the two slabs of a tile run together and share K / V
//     in L2; y is batch x heads, as in every forward); each slab
//     recomputes S, 1.5x the products;
//   * no extra products for S within a block: warpgroup c computes the
//     partial S over its half of the head dim (q and K columns [D/2 c,
//     D/2 (c + 1))), writes it to shared memory, and after a named barrier
//     of the pair adds the other's; both then hold the same S (fp32 adds
//     commute) and run the same masked online softmax, so m and l agree and
//     each warpgroup scales and divides its own columns.  The partials are
//     double-buffered by tile parity, so one barrier a tile suffices.  (Each
//     warpgroup computing S whole, with no exchange, so that the two drift
//     apart, was slower: 0.64 / 2.20 ms against 0.56 / 1.71 at D = 512 /
//     1024, tools/wide_ab.py);
//   * shared memory: the q tile (64 x D, 64 / 128 KB) stays resident.  K
//     and V have full / empty mbarriers of their own, so the next K tile
//     loads while the softmax and PV run and the next V tile while S runs.
//     K1: tiles of kBc = 32 KV rows in two K and two V slots at D = 512;
//     16 rows at D = 1024 (a K tile is 32 KB, the V slab tile 16 KB) in two
//     K slots and one V slot, which fill the room q leaves (the second K
//     slot took 9% off K1 there, tools/wide_ab.py);
//   * a producer warpgroup: one thread issues the TMA loads.  K4: TMA lands
//     the 1-byte payloads in kStaging staging slots ahead, and the 128
//     threads dequantize K into the one K slot once S has read the last,
//     and V into the V slot once PV has, so the conversion overlaps the
//     consumers' math (consumers dequantizing their own halves cost them
//     2.3-2.6x K1's time); each thread loads its rows' scales while the
//     payloads land (17-21% off K4);
//   * ptxas gives a thread of this block 168 registers (65,536 / 384),
//     and did so too with a one-warp producer (288 threads), so the
//     consumers spill where the accumulator, S and its partials meet;
//   * every wgmma operand is ready before wgmma.fence and every branch
//     around a wgmma is uniform (the warpgroup index is broadcast from lane
//     0), else ptxas serialises them (C7518).
// ptxas -v (sm_90a, CUDA 12.8): 167 registers and 64 bytes of spill stores
// at D = 512 (K1 and K4), 162 registers and no spills at D = 1024; no wgmma
// serialised (C7518).
#pragma once

#include "flash_fwd.cuh"

namespace fa {
namespace wide {

template <typename T, typename KV, int D>
struct Cfg {
  static_assert(D == 512 || D == 1024, "padded head dims 512 and 1024");
  static constexpr bool kQuant = !std::is_same<T, KV>::value;
  static constexpr int kBr = 64;            // query rows, shared by both consumer warpgroups
  static constexpr int kSlab = 512;         // output columns of a block, 256 a consumer warpgroup
  static constexpr int kSlabs = D / kSlab;  // blocks a query tile
  static constexpr int kHalf = D / 2;       // the columns of q and K a consumer warpgroup reduces S over
  static constexpr int kBc = D == 512 ? 32 : 16;
  // K and V slots the consumers read (T tiles): K1's TMA rings, two K
  // slots at both widths (at D = 1024 the second fills the room q leaves)
  // and two V slots at D = 512; K4's one slot of each, dequantized by the
  // producer warpgroup from kStaging slots of payload that TMA fills ahead
  static constexpr int kStagesK = kQuant ? 1 : 2;
  static constexpr int kStagesV = D == 512 && !kQuant ? 2 : 1;
  static constexpr int kStaging = kQuant ? (D == 512 ? 2 : 1) : 0;
  static constexpr int kThreads = 3 * 128;  // a producer warpgroup, two consumer warpgroups
  static constexpr int kKBytes = kBc * D * 2;      // a K slot
  static constexpr int kVBytes = kBc * kSlab * 2;  // a V slot: the slab's columns
  static constexpr int kPayKBytes = kBc * D;       // K4: a staging slot's K payload, then its V payload
  static constexpr int kPayBytes = kBc * (D + kSlab);
  static constexpr int kOffK = kBr * D * 2;  // the q tile sits at 0
  static constexpr int kOffV = kOffK + kStagesK * kKBytes;
  static constexpr int kOffPay = kOffV + kStagesV * kVBytes;
  static constexpr int kOffX = kOffPay + kStaging * kPayBytes;  // S partials: [tile parity][warpgroup][kBr x kBc] fp32
  static constexpr int kOffBars = kOffX + 2 * 2 * kBr * kBc * 4;
  // q; full and empty a K slot and a V slot; landed a staging slot
  static constexpr int kBars = 1 + 2 * kStagesK + 2 * kStagesV + kStaging;
  // + 1024 to align the base for the 128-byte swizzle
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
  static_assert(kOffK % 1024 == 0 && kKBytes % 1024 == 0 && kVBytes % 1024 == 0 && kPayBytes % 1024 == 0,
                "TMA's 128-byte swizzle wants 1024-byte aligned tiles");
};

// K4: a payload tile of kBc rows x NCOLS columns staged by TMA as [chunk
// of 256 columns][kBc rows][256 bytes] is dequantized into a T tile laid
// out as swizzle128 says (kBc rows a 64-column block) by the 128 threads of
// the producer warpgroup, piece n of a thread (16 payload bytes) at index
// tid + 128 n of the tile's pieces in row-major order.  load_scales fetches
// the scale of each piece's row, rounded to T in both halves of a pair;
// rows at or past lk (zero payloads, scales not to be read) get 0.
template <typename T, int kBc, int NCOLS>
__device__ __forceinline__ void load_scales(uint32_t (&sc)[kBc * NCOLS / 16 / 128], const float* scales, int row0,
                                            int lk, int tid) {
  constexpr int kPieces = NCOLS / 16;
  static_assert(kBc * kPieces % 128 == 0, "pieces spread evenly over the warpgroup");
#pragma unroll
  for (int n = 0; n < kBc * kPieces / 128; ++n) {
    const int row = row0 + (tid + 128 * n) / kPieces;
    const float s = row < lk ? __ldg(scales + row) : 0.f;
    sc[n] = Pack<T>::two(s, s);
  }
}

template <typename T, typename KV, int kBc, int NCOLS>
__device__ __forceinline__ void dequant_tile(T* dst, const uint8_t* src, const uint32_t (&sc)[kBc * NCOLS / 16 / 128],
                                             int tid) {
  constexpr int kPieces = NCOLS / 16;  // 16-byte pieces of a row
#pragma unroll
  for (int n = 0; n < kBc * kPieces / 128; ++n) {
    const int i = tid + 128 * n;
    const int r = i / kPieces;
    const int col = (i % kPieces) * 16;
    uint4 out[2];
    dequant16<T, KV>(*reinterpret_cast<const uint4*>(src + (col / 256) * kBc * 256 + r * 256 + col % 256), sc[n],
                     out);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(dst) + swizzle128(r, col / 8 + hh, kBc)) = out[hh];
  }
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(Cfg<T, KV, D>::kThreads, 1)
fwd_kernel(const __grid_constant__ FwdParams p, const __grid_constant__ FwdMaps maps) {
  using C = Cfg<T, KV, D>;
  constexpr int kBc = C::kBc, kSK = C::kStagesK, kSV = C::kStagesV, kSt = C::kStaging;
  constexpr int kSlab = C::kSlab, kHalf = C::kHalf;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + C::kOffK);  // kSK slots
  T* sV = reinterpret_cast<T*>(smem + C::kOffV);  // kSV slots
  uint8_t* sPay = smem + C::kOffPay;  // K4: kSt staging slots of (K, V) payload
  float4* sX = reinterpret_cast<float4*>(smem + C::kOffX);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full_k = q_full + 1;
  uint64_t* empty_k = full_k + kSK;
  uint64_t* full_v = empty_k + kSK;
  uint64_t* empty_v = full_v + kSV;
  uint64_t* landed = empty_v + kSV;  // K4: staging slot i's payloads have arrived

  const Mask mk = p.mask;
  // x runs over query tiles x slabs, the slabs of a tile side by side; the
  // longest causal KV loops first
  const int tile = gridDim.x / C::kSlabs - 1 - blockIdx.x / C::kSlabs;
  const int slab = blockIdx.x % C::kSlabs;
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.group;
  const int r0 = tile * C::kBr;
  const int* kv_ids = p.kv_ids ? p.kv_ids + (long long)b * mk.lk : nullptr;
  const int j_lo = mk.kv_first(r0) / kBc;
  const int kv_end = mk.kv_end(min(r0 + C::kBr, mk.lq));
  const int j_hi = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kSK; ++s) {
      sm90::mbar_init(&full_k[s], C::kQuant ? 128 : 1);  // K4: every producer thread after its dequant
      sm90::mbar_init(&empty_k[s], 256);                 // every consumer thread
    }
    for (int s = 0; s < kSV; ++s) {
      sm90::mbar_init(&full_v[s], C::kQuant ? 128 : 1);
      sm90::mbar_init(&empty_v[s], 256);
    }
    for (int i = 0; i < kSt; ++i) sm90::mbar_init(&landed[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup's index broadcast from lane 0, so that ptxas sees every
  // branch on it as uniform in each warp.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  if (wg == 2) {
    // ---------------- producer warpgroup ----------------
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(q_full, C::kBr * D * 2);
      for (int c = 0; c < D / 64; ++c) sm90::tma_load_4d(sQ + c * C::kBr * 64, &maps.q, q_full, c * 64, r0, h, b);
    }
    if constexpr (!C::kQuant) {
      // K1: one thread issues the TMA loads of each K and V tile into the
      // ring, as soon as the consumers release the slot
      if (tid != 0) return;
      for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
        const int sk = it % kSK, sv = it % kSV;
        sm90::mbar_wait(&empty_k[sk], ((it / kSK) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full_k[sk], C::kKBytes);
        for (int c = 0; c < D / 64; ++c)
          sm90::tma_load_4d(sK + sk * kBc * D + c * kBc * 64, &maps.k, &full_k[sk], c * 64, j * kBc, hk, b);
        sm90::mbar_wait(&empty_v[sv], ((it / kSV) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full_v[sv], C::kVBytes);
        for (int c = 0; c < kSlab / 64; ++c)
          sm90::tma_load_4d(sV + sv * kBc * kSlab + c * kBc * 64, &maps.v, &full_v[sv], slab * kSlab + c * 64,
                            j * kBc, hk, b);
      }
    } else {
      // K4: TMA lands tile j's payloads (all of K's columns, the slab's of
      // V) in staging slot it % kSt: with two slots one tile ahead, with one
      // as soon as the previous tile's are converted.  The 128 threads
      // dequantize K into the K slot once the consumers are done with the
      // previous K (after S), V into the V slot once they are done with the
      // previous V (after PV), so that the conversion overlaps their math.
      const KvRows<KV> kv(p, b, hk);
      constexpr int kRowsK = kBc * D / 16 / 128, kRowsV = kBc * kSlab / 16 / 128;  // pieces a thread converts
      auto fetch = [&](int it, int j) {
        uint64_t* bar = &landed[it % kSt];
        uint8_t* dst = sPay + (it % kSt) * C::kPayBytes;
        sm90::mbar_arrive_expect_tx(bar, C::kPayBytes);
        for (int c = 0; c < D / 256; ++c) sm90::tma_load_4d(dst + c * kBc * 256, &maps.k, bar, c * 256, j * kBc, hk, b);
        for (int c = 0; c < kSlab / 256; ++c)
          sm90::tma_load_4d(dst + C::kPayKBytes + c * kBc * 256, &maps.v, bar, slab * kSlab + c * 256, j * kBc, hk, b);
      };
      if (tid == 0 && j_lo < j_hi) fetch(0, j_lo);
      for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
        const uint32_t free_parity = (it & 1) ^ 1;  // one K and one V slot
        if (kSt == 2 && tid == 0 && j + 1 < j_hi) fetch(it + 1, j + 1);
        // this thread's rows' scales, loaded while the payloads land
        uint32_t k_sc[kRowsK], v_sc[kRowsV];
        load_scales<T, kBc, D>(k_sc, kv.ks, j * kBc, mk.lk, tid);
        load_scales<T, kBc, kSlab>(v_sc, kv.vs, j * kBc, mk.lk, tid);
        sm90::mbar_wait(&landed[it % kSt], (it / kSt) & 1);
        const uint8_t* pay = sPay + (it % kSt) * C::kPayBytes;
        sm90::mbar_wait(&empty_k[0], free_parity);
        dequant_tile<T, KV, kBc, D>(sK, pay, k_sc, tid);
        sm90::fence_proxy_async();  // the generic writes, before wgmma reads them
        sm90::mbar_arrive(&full_k[0]);
        sm90::mbar_wait(&empty_v[0], free_parity);
        dequant_tile<T, KV, kBc, kSlab>(sV, pay + C::kPayKBytes, v_sc, tid);
        sm90::fence_proxy_async();
        sm90::mbar_arrive(&full_v[0]);
        sm90::named_bar_sync(4, 128);  // every producer thread is done with staging slot it % kSt
        if (kSt == 1 && tid == 0 && j + 1 < j_hi) fetch(it + 1, j + 1);
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  const int cw = wg;  // S over q / K columns [kHalf cw, kHalf (cw + 1)); O columns 256 cw .. of the slab
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // row within the 8-row group
  const int t = lane % 4;  // column pair
  const int row_a = r0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8
  int lo[2], hi[2], q_id[2] = {0, 0};
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lo[r] = mk.kv_first(row);
    hi[r] = row < mk.lq ? mk.kv_end(row + 1) - 1 : -1;
    if (p.q_ids != nullptr && row < mk.lq) q_id[r] = p.q_ids[(long long)b * mk.lq + row];
  }

  // q scaled by sm_scale*log2(e) and rounded back to T, in place: this
  // warpgroup's 64-column blocks, which only it reads.
  constexpr int kBlocks = kHalf / 64;  // 64-column blocks of q / K a warpgroup reduces over
  sm90::mbar_wait(q_full, 0);
  for (int cb = cw * kBlocks; cb < (cw + 1) * kBlocks; ++cb) {
    uint4* rows = reinterpret_cast<uint4*>(sQ + cb * C::kBr * 64);
    for (int i = tid; i < C::kBr * 8; i += 128) {
      uint4 v = rows[i];
      T* x = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = from_float<T>(to_float(x[e]) * p.scale_log2);
      rows[i] = v;
    }
  }
  sm90::fence_proxy_async();
  sm90::named_bar_sync(2 + cw, 128);

  float acc[128];  // O[:, 256 cw .. 256 cw + 256) of the slab, two N = 128 halves
  float sc[kBc / 2];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBc / 2; ++i) sc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
    const int sk = it % kSK, sv = it % kSV;
    const int c0 = j * kBc;

    // ---- S partial = Qs[:, half] K[:, half]^T ----
    const T* k_s = sK + sk * kBc * D;
    sm90::mbar_wait(&full_k[sk], (it / kSK) & 1);
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb) {
      const int blk = cw * kBlocks + cb;
      uint64_t da[4], db[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        da[kk] = sm90::smem_desc(sQ + blk * C::kBr * 64 + kk * 16, 16, 1024);
        db[kk] = sm90::smem_desc(k_s + blk * kBc * 64 + kk * 16, 16, 1024);
      }
      sm90::fence_regs(da);
      sm90::fence_regs(db);
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_ss<T, kBc>(sc, da[kk], db[kk], cb > 0 || kk > 0);
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::mbar_arrive(&empty_k[sk]);  // K is read

    // ---- the two partials meet: S = own + other, the same bits in both ----
    {
      float4* mine = sX + ((it & 1) * 2 + cw) * (kBc / 8) * 128 + tid;
      const float4* other = sX + ((it & 1) * 2 + (1 - cw)) * (kBc / 8) * 128 + tid;
#pragma unroll
      for (int i = 0; i < kBc / 8; ++i) mine[i * 128] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
      sm90::named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < kBc / 8; ++i) {
        const float4 o = other[i * 128];
        sc[4 * i] += o.x;
        sc[4 * i + 1] += o.y;
        sc[4 * i + 2] += o.z;
        sc[4 * i + 3] += o.w;
      }
    }

    // Element mask only where the tile crosses the diagonal, the window
    // edge or the KV end, or where segment ids apply (read from global
    // memory; a visible key is below lk).
    if (kv_ids != nullptr || !mk.tile_visible(r0, C::kBr, c0, kBc)) {
#pragma unroll
      for (int nb = 0; nb < kBc / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = c0 + nb * 8 + 2 * t + (e & 1);
          bool ok = col >= lo[r] && col <= hi[r];
          if (kv_ids != nullptr) ok = ok && q_id[r] == __ldg(kv_ids + col);
          if (!ok) sc[4 * nb + e] = -CUDART_INF_F;
        }
    }

    // Online softmax for rows g (e = 0, 1) and g + 8 (e = 2, 3); the four
    // threads of a quad hold one row between them.
    constexpr int kNb = kBc / 8;
    constexpr int kPart = kNb < 4 ? kNb : 4;  // partial maxima and sums a row
    float mx[2][kPart], sum[2][kPart];
#pragma unroll
    for (int q = 0; q < kPart; ++q) {
      mx[0][q] = fmaxf(sc[4 * q], sc[4 * q + 1]);
      mx[1][q] = fmaxf(sc[4 * q + 2], sc[4 * q + 3]);
    }
#pragma unroll
    for (int nb = kPart; nb < kNb; ++nb) {
      mx[0][nb % kPart] = fmaxf(mx[0][nb % kPart], fmaxf(sc[4 * nb], sc[4 * nb + 1]));
      mx[1][nb % kPart] = fmaxf(mx[1][nb % kPart], fmaxf(sc[4 * nb + 2], sc[4 * nb + 3]));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float row_max = mx[r][0];
#pragma unroll
      for (int q = 1; q < kPart; ++q) row_max = fmaxf(row_max, mx[r][q]);
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      const float m_new = fmaxf(m[r], row_max);
      base[r] = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked so far
      alpha[r] = exp2_ftz(m[r] - base[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[4 * nb + e] = exp2_ftz(sc[4 * nb + e] - base[e >> 1]);
      if (nb < kPart) {
        sum[0][nb] = sc[4 * nb] + sc[4 * nb + 1];
        sum[1][nb] = sc[4 * nb + 2] + sc[4 * nb + 3];
      } else {
        sum[0][nb % kPart] += sc[4 * nb] + sc[4 * nb + 1];
        sum[1][nb % kPart] += sc[4 * nb + 2] + sc[4 * nb + 3];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // per-thread partial; quad-summed at the end
      float total = sum[r][0];
#pragma unroll
      for (int q = 1; q < kPart; ++q) total += sum[r][q];
      l[r] = l[r] * alpha[r] + total;
    }
#pragma unroll
    for (int nd = 0; nd < 32; ++nd) {
      acc[4 * nd] *= alpha[0];
      acc[4 * nd + 1] *= alpha[0];
      acc[4 * nd + 2] *= alpha[1];
      acc[4 * nd + 3] *= alpha[1];
    }

    // ---- acc += P V[:, this warpgroup's 256 columns], P rounded to T ----
    // V is the MN-major B operand: a k16 step moves 16 rows (2 KB) down
    // its 64-column blocks, which lie kBc rows (kBc * 128 bytes) apart;
    // each step is two N = 128 products, into acc[0, 64) and acc[64, 128).
    const T* v_s = sV + sv * kBc * kSlab;
    uint32_t pa[kBc / 16][4];
    uint64_t dv[kBc / 16 * 2];
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      pa[kk][0] = Pack<T>::two(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = Pack<T>::two(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = Pack<T>::two(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = Pack<T>::two(sc[8 * kk + 6], sc[8 * kk + 7]);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        dv[kk * 2 + n] = sm90::smem_desc(v_s + (4 * cw + 2 * n) * kBc * 64 + kk * 16 * 64, kBc * 128, 1024);
    }
    sm90::mbar_wait(&full_v[sv], (it / kSV) & 1);
    sm90::fence_regs(pa);
    sm90::fence_regs(dv);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        sm90::wgmma_rs<T, 128>(*reinterpret_cast<float(*)[64]>(acc + n * 64), pa[kk], dv[kk * 2 + n]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty_v[sv]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* go = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + slab * kSlab + 256 * cw + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= mk.lq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    T* orow = go + (long long)row * p.o_sl;
#pragma unroll
    for (int nd = 0; nd < 32; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) = Pack<T>::two(acc[4 * nd + 2 * r] * inv, acc[4 * nd + 2 * r + 1] * inv);
    // m and l are the same in both warpgroups and both slabs
    if (p.lse != nullptr && t == 0 && cw == 0 && slab == 0)
      p.lse[(long long)bh * mk.lq + row] = (m[r] + log2f(l_safe)) * kLn2;
  }
}

template <typename T, typename KV, int D>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  using C = Cfg<T, KV, D>;
  constexpr CUtensorMapDataType kType =
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  const Mask& mk = p.mask;
  FwdMaps maps;
  bool ok = sm90::make_map_4d(&maps.q, kType, 2, p.q, D, mk.lq, p.hq, p.batch, p.q_sl, p.q_sh, p.q_sb, 64, C::kBr,
                              kSw);
  if constexpr (C::kQuant) {  // 256-byte rows of payload into the ring, unswizzled
    constexpr CUtensorMapDataType kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
    constexpr CUtensorMapSwizzle kNone = CU_TENSOR_MAP_SWIZZLE_NONE;
    ok = ok && sm90::make_map_4d(&maps.k, kU8, 1, p.k, D, mk.lk, p.hkv, p.batch, p.k_sl, p.k_sh, p.k_sb, 256, C::kBc,
                                 kNone);
    ok = ok && sm90::make_map_4d(&maps.v, kU8, 1, p.v, D, mk.lk, p.hkv, p.batch, p.v_sl, p.v_sh, p.v_sb, 256, C::kBc,
                                 kNone);
  } else {
    ok = ok && sm90::make_map_4d(&maps.k, kType, 2, p.k, D, mk.lk, p.hkv, p.batch, p.k_sl, p.k_sh, p.k_sb, 64,
                                 C::kBc, kSw);
    ok = ok && sm90::make_map_4d(&maps.v, kType, 2, p.v, D, mk.lk, p.hkv, p.batch, p.v_sl, p.v_sh, p.v_sb, 64,
                                 C::kBc, kSw);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = fwd_kernel<T, KV, D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((mk.lq + C::kBr - 1) / C::kBr * C::kSlabs, p.batch * p.hq);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(p, maps);
  return cudaGetLastError();
}

// K1 (kv_dtype 0) and K4 (int8 1, fp8 e4m3 2) for bf16 (dtype 1) and fp16
// (2) q at head dim D; cudaErrorInvalidValue for any other.
template <int D>
cudaError_t launch_for(int dtype, int kv_dtype, const FwdParams& p, cudaStream_t s) {
  if (dtype == 1 && kv_dtype == 0) return launch<__nv_bfloat16, __nv_bfloat16, D>(p, s);
  if (dtype == 2 && kv_dtype == 0) return launch<__half, __half, D>(p, s);
  if (dtype == 1 && kv_dtype == 1) return launch<__nv_bfloat16, int8_t, D>(p, s);
  if (dtype == 2 && kv_dtype == 1) return launch<__half, int8_t, D>(p, s);
  if (dtype == 1 && kv_dtype == 2) return launch<__nv_bfloat16, __nv_fp8_e4m3, D>(p, s);
  if (dtype == 2 && kv_dtype == 2) return launch<__half, __nv_fp8_e4m3, D>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace wide
}  // namespace fa
