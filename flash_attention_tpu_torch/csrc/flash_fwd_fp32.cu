// The fp32 forward at head dims 64 and 128 on the tensor cores in 3xTF32:
// K1 (fa_flash_fwd) and K4 (fa_flash_fwd_kv_quant) for dtype 0, reached
// through flash_fwd.cuh's launch_fwd_for.  In a source of its own so that
// it compiles beside flash_fwd.cu and flash_fwd_kv_quant.cu.
//
// Replaces: flash_attention_tpu/kernels/flash_attention.py::_fwd_kernel
// (K1, launched by _fwd through pl.pallas_call) and
// flash_attention_tpu/quant/kv.py::_fwd_quant_kernel (K4) at fp32, where
// JAX runs both products at Precision.HIGHEST.  The function: q scaled by
// sm_scale * log2(e) in fp32, online softmax in the exp2 domain, P kept in
// fp32 before PV (JAX's p.astype(v.dtype) is fp32 here), m, l and O in
// fp32, one final division with the l == 0 guard, lse in natural log;
// causal end-aligned masking, window, segment ids, GQA by reading KV head
// h / group, ragged Lq / Lk, inputs read through their strides.  K4's K/V
// are payload.to(fp32) * scale, one fp32 rounding, as the TPU kernel does
// at fp32.
//
// What bounds it on this card: at b8 h12 L1024 causal the two products are
// 12.9 / 25.8 GFLOP at D = 64 / 128, 0.078 / 0.156 ms at 165 TFLOP/s
// (TF32's 495 over the three passes of 3xTF32), against 50 / 101 MB of fp32
// q, k, v and o (0.015 / 0.030 ms): its operations.  One TF32 pass would
// miss the forward's 1e-5, so every product is three (tf32x3.cuh), and the
// splits of the operands cost the integer pipe about as much as the
// products cost the tensor cores.  Design, from the fp32 K3
// (flash_bwd_fp32.cuh), which is this forward plus dO; the choices timed
// in turns at b8 h12 L1024 (tools/bwd_ab.py --fp32-only; PERF.md):
//   * eight warps of 16 query rows (128 a block, one block an SM, up to 255
//     registers a thread; four warps of 64 rows were 25% / 30% slower at D
//     = 64 / 128); warp 0 also produces: its lane 0 issues the TMA loads of
//     q (once) and of 32-row K/V tiles (fp32: 32-column boxes, 128-byte
//     swizzle; rows past Lq or Lk read as zero) into an mbarrier ring of
//     6 / 3 slots once every warp has released the slot (3 / 2 slots were
//     1-2% slower), and its lanes stage the slot's KV segment ids and, for
//     K4, the rows' scales;
//   * the grid is (heads, q tiles), the longest causal KV loop first across
//     every head (13-20% faster than (tiles, heads) for the fp32 K3); each
//     warp has its own KV range (causal rule, window) and waits on and
//     releases the tiles it skips, so the barrier counts always match;
//   * each warp scales its q rows by sm_scale * log2(e) in place once and
//     splits them once, hi in place and lo beside (6% / 3% faster than
//     splitting per tile; at D = 128 the lo copy leaves room for three ring
//     slots, not four);
//   * S = Qs K^T on mma.sync.m16n8k8 tf32: four 8-column blocks a k8 step,
//     each pass issued across the four.  The cross passes (lo hi, hi lo)
//     are summed apart from hi hi and added to it in fp32 at the end: the
//     tensor cores truncate what they add, and a sum that takes all three
//     passes of every k8 step loses an ulp of S three times as often;
//   * the online softmax on the accumulator's registers: a thread holds
//     rows g and g + 8, quad shuffles reduce the row max; only tiles that
//     cross the diagonal, the window edge or a ragged end, or carry
//     segment ids, pay for the element mask (Mask::tile_visible);
//   * O += P V with P the A operand straight from the accumulators
//     (frag_acc: depth order 0, 2, 4, 6, 1, 3, 5, 7, V's rows read in the
//     same order), each 8-column block of a tile's PV summed from zero and
//     added to the rescaled O in fp32 (add_product), so that O's thousand
//     keys are not summed by the tensor cores' truncating adds;
//   * K4 lands the 1-byte payload tiles in the ring and builds the B
//     fragments from the payload bytes (TMA's D-byte swizzle keeps the byte
//     loads free of bank conflicts) times the row's scale: an integer and
//     two fp32 operations a value for int8, a few more for fp8.  For int8
//     this was 12% faster at D = 64 than dequantizing each tile once into
//     fp32 tiles behind a block-wide barrier, even at 128; for fp8 the
//     tiles were 16% faster at D = 128, but one reading path serves both
//     types and keeps every slot released after its last reader.
// ptxas -v (sm_90a): K1 181 / 253 registers at D = 64 / 128, K4 183 / 252
// (int8) and 175 / 252 (fp8); no spills.
//
// The kernels allocate nothing and launch on the caller's stream;
// cudaGetLastError() goes back to the C entry point, and
// cudaErrorInvalidValue when a tensor map cannot be made.

#include "flash_fwd.cuh"
#include "tf32x3.cuh"

namespace fa {
namespace {

// The tile and shared memory of K1 (KV = float) and K4 (int8, fp8 e4m3).
template <typename KV, int D>
struct FwdF32Cfg {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static constexpr bool kQuant = !std::is_same<KV, float>::value;
  static constexpr int kWarps = 8;
  static constexpr int kStages = D == 64 ? 6 : 3;
  static constexpr int kPinned = 16 * kWarps;  // q rows of a block
  static constexpr int kStream = 32;           // KV rows of each streamed tile
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kPinnedBytes = kPinned * D * 4;
  static constexpr int kTileBytes = kStream * D * 4;  // an fp32 K or V tile
  static constexpr int kPayloadBytes = kQuant ? kStream * D : 0;  // K4: a K or V payload tile
  static constexpr int kSlotBytes = kQuant ? 2 * kPayloadBytes : 2 * kTileBytes;  // K, then V, as loaded
  static constexpr int kOffLo = kPinnedBytes;  // q (its hi) at 0, its lo beside it
  static constexpr int kOffRing = kOffLo + kPinnedBytes;
  static constexpr int kOffIds = kOffRing + kStages * kSlotBytes;
  static constexpr int kOffScales = kOffIds + kStages * kStream * 4;  // K4: per slot, K's then V's
  static constexpr int kOffBars = kOffScales + (kQuant ? kStages * 2 * kStream * 4 : 0);
  static constexpr int kBars = 1 + 2 * kStages;  // q; full and empty per slot
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;  // + 1024 to align the base for the swizzle
  static_assert(kSlotBytes % 1024 == 0, "slots start on the swizzle's 1024-byte period");
  static_assert(kStream == 32, "a producer lane stages a row");
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
};

// K4: element (r, c) of a [32, D] payload tile as
// TMA writes it with the D-byte swizzle (16-byte chunks permuted by XOR
// with r % 8 at D = 128, (r / 2) % 4 at 64), times its row's scale.
template <typename KV, int D>
struct PayloadTile {
  const uint8_t* pay;
  const float* scale;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int chunk = (c / 16) ^ (D == 128 ? r % 8 : (r / 2) % 4);
    return payload_value<KV>(pay[r * D + chunk * 16 + c % 16]) * scale[r];
  }
};

template <typename KV, int D>
__global__ void __launch_bounds__(FwdF32Cfg<KV, D>::kThreads, 1)
flash_fwd_fp32_kernel(const __grid_constant__ FwdParams p, const __grid_constant__ FwdMaps maps) {
  using C = FwdF32Cfg<KV, D>;
  constexpr int kBr = C::kPinned, kBc = C::kStream, kS = C::kStages;
  constexpr int kTile = kBc * D;  // floats of an fp32 K or V tile

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  float* sQ = reinterpret_cast<float*>(smem);
  float* sQlo = reinterpret_cast<float*>(smem + C::kOffLo);
  unsigned char* ring = smem + C::kOffRing;  // kS slots of (K, V)
  int* sIds = reinterpret_cast<int*>(smem + C::kOffIds);  // kS x kBc KV segment ids
  float* sScales = reinterpret_cast<float*>(smem + C::kOffScales);  // K4: kS x (K, V) x kBc
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full = q_full + 1;  // slot s holds its K/V tile
  uint64_t* empty = full + kS;  // every thread is done with slot s

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
  // The block's KV tiles [j_lo, j_hi): the union of its warps' ranges.
  const int j_lo = mk.kv_first(r0) / kBc;
  const int kv_end = mk.kv_end(min(r0 + kBr, mk.lq));
  const int j_hi = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], 32);  // every producer lane
      sm90::mbar_init(&empty[s], C::kThreads);
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
  // ring slot once every thread has released the slot's previous tile, the
  // segment ids and K4's scales by its lanes, the TMA loads by lane 0.
  auto issue = [&](int it) {
    const int s = it % kS;
    const int j = j_lo + it;
    sm90::mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
    const int row = j * kBc + lane;  // kBc == 32: one row a lane
    if (kv_ids != nullptr) sIds[s * kBc + lane] = row < mk.lk ? kv_ids[row] : -1;
    if constexpr (C::kQuant) {
      sScales[(2 * s) * kBc + lane] = row < mk.lk ? kv.ks[row] : 0.f;
      sScales[(2 * s + 1) * kBc + lane] = row < mk.lk ? kv.vs[row] : 0.f;
    }
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&full[s], C::kSlotBytes);
      unsigned char* slot = ring + s * C::kSlotBytes;
      if constexpr (C::kQuant) {
        sm90::tma_load_4d(slot, &maps.k, &full[s], 0, j * kBc, hk, b);
        sm90::tma_load_4d(slot + C::kPayloadBytes, &maps.v, &full[s], 0, j * kBc, hk, b);
      } else {
        for (int c = 0; c < D / 32; ++c) {
          sm90::tma_load_4d(slot + c * kBc * 128, &maps.k, &full[s], c * 32, j * kBc, hk, b);
          sm90::tma_load_4d(slot + C::kTileBytes + c * kBc * 128, &maps.v, &full[s], c * 32, j * kBc, hk, b);
        }
      }
    } else {
      sm90::mbar_arrive(&full[s]);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(q_full, C::kPinnedBytes);
      for (int c = 0; c < D / 32; ++c) sm90::tma_load_4d(sQ + c * kBr * 32, &maps.q, q_full, c * 32, r0, h, b);
    }
    for (int it = 0; it < min(kS, n_tiles); ++it) issue(it);
  }

  const int g = lane / 4;
  const int t = lane % 4;
  const int wr0 = r0 + 16 * warp;  // this warp's 16 q rows
  const bool active = wr0 < mk.lq;
  int my_lo = 0, my_hi = 0;  // this warp's KV tiles
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
  // its QK^T, and split once: this warp's rows, hi in place, lo beside.
  sm90::mbar_wait(q_full, 0);
  split_pinned<kBr, D>(sQ, sQlo, 16 * warp, lane, p.scale_log2);

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum; quad-summed at the end

  // One tile's S, softmax and PV for this warp's rows: K and V read through
  // kx and vx (fp32 tiles, or K4's payload readers).
  auto tile_math = [&](const auto& kx, const auto& vx, int j, int s) {
    const int c0 = j * kBc;
    float sc[4][4];  // S = Qs K^T: [16, 32] as four 8-column blocks
    scores<kBr, D, 4, true>(sc, sQ, sQlo, kx, 16 * warp, g, t);

    // Element mask only where the tile crosses the diagonal, the window
    // edge or the KV end, or where segment ids apply.
    if (kv_ids != nullptr || !mk.tile_visible(wr0, 16, c0, kBc)) {
      const int* ids = sIds + s * kBc;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int cl = nb * 8 + 2 * t + (e & 1);
          bool ok = c0 + cl >= lo[r] && c0 + cl <= hi[r];
          if (kv_ids != nullptr) ok = ok && q_id[r] == ids[cl];
          if (!ok) sc[nb][e] = -CUDART_INF_F;
        }
    }

    // Online softmax for rows g (e = 0, 1) and g + 8 (e = 2, 3); the four
    // threads of a quad hold a row between them.
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float row_max = -CUDART_INF_F;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) row_max = fmaxf(row_max, fmaxf(sc[nb][2 * r], sc[nb][2 * r + 1]));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      const float m_new = fmaxf(m[r], row_max);
      base[r] = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked so far
      alpha[r] = exp2_ftz(m[r] - base[r]);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nb][e] = exp2_ftz(sc[nb][e] - base[e >> 1]);
        sum[e >> 1] += sc[nb][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];

    // O += P V, P in fp32 (split like any operand)
    uint32_t ph[4][4], pl[4][4];
    frags_of<kBc>(ph, pl, sc);
    add_product<kBc, D>(acc, ph, pl, vx, g, t);
  };

  for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
    const int s = it % kS;
    sm90::mbar_wait(&full[s], (it / kS) & 1);
    const unsigned char* slot = ring + s * C::kSlotBytes;
    if (j >= my_lo && j < my_hi) {
      if constexpr (C::kQuant) {
        const float* sc = sScales + 2 * s * kBc;
        tile_math(PayloadTile<KV, D>{slot, sc}, PayloadTile<KV, D>{slot + C::kPayloadBytes, sc + kBc}, j, s);
      } else {
        const float* k_s = reinterpret_cast<const float*>(slot);
        tile_math(k_s, k_s + kTile, j, s);
      }
    }
    sm90::mbar_arrive(&empty[s]);  // after the tile's last read of the slot, its ids and scales
    if (warp == 0 && it + kS < n_tiles) issue(it + kS);
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* go = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= mk.lq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    float* orow = go + (long long)row * p.o_sl + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(orow + nd * 8) = make_float2(acc[nd][2 * r] / l_safe, acc[nd][2 * r + 1] / l_safe);
    if (p.lse != nullptr && t == 0) p.lse[(long long)bh * mk.lq + row] = (m[r] + log2f(l_safe)) * kLn2;
  }
}

template <typename KV, int D>
cudaError_t launch_f32(const FwdParams& p, cudaStream_t stream) {
  using C = FwdF32Cfg<KV, D>;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  const Mask& mk = p.mask;
  FwdMaps maps;
  bool ok = sm90::make_map_4d(&maps.q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.q, D, mk.lq, p.hq, p.batch, p.q_sl,
                              p.q_sh, p.q_sb, 32, C::kPinned, kSw);
  if constexpr (C::kQuant) {  // whole payload rows, D-byte swizzled for PayloadTile
    constexpr CUtensorMapDataType kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
    constexpr CUtensorMapSwizzle kPay = D == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    ok = ok && sm90::make_map_4d(&maps.k, kU8, 1, p.k, D, mk.lk, p.hkv, p.batch, p.k_sl, p.k_sh, p.k_sb, D,
                                 C::kStream, kPay);
    ok = ok && sm90::make_map_4d(&maps.v, kU8, 1, p.v, D, mk.lk, p.hkv, p.batch, p.v_sl, p.v_sh, p.v_sb, D,
                                 C::kStream, kPay);
  } else {
    constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    ok = ok && sm90::make_map_4d(&maps.k, kF32, 4, p.k, D, mk.lk, p.hkv, p.batch, p.k_sl, p.k_sh, p.k_sb, 32,
                                 C::kStream, kSw);
    ok = ok && sm90::make_map_4d(&maps.v, kF32, 4, p.v, D, mk.lk, p.hkv, p.batch, p.v_sl, p.v_sh, p.v_sb, 32,
                                 C::kStream, kSw);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_fp32_kernel<KV, D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.hq, (mk.lq + C::kPinned - 1) / C::kPinned);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(p, maps);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_fwd_fp32(int kv_dtype, int head_dim, const FwdParams& p, cudaStream_t s) {
  if (kv_dtype == 0 && head_dim == 64) return launch_f32<float, 64>(p, s);
  if (kv_dtype == 0 && head_dim == 128) return launch_f32<float, 128>(p, s);
  if (kv_dtype == 1 && head_dim == 64) return launch_f32<int8_t, 64>(p, s);
  if (kv_dtype == 1 && head_dim == 128) return launch_f32<int8_t, 128>(p, s);
  if (kv_dtype == 2 && head_dim == 64) return launch_f32<__nv_fp8_e4m3, 64>(p, s);
  if (kv_dtype == 2 && head_dim == 128) return launch_f32<__nv_fp8_e4m3, 128>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace fa
