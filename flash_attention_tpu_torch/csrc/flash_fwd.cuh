// FlashAttention forward for Hopper (sm_90a): the kernel templates behind
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
// accumulator in fp32, P rounded to T before PV, one final division with the
// l == 0 guard, causal masking with queries aligned to the end of KV, the
// sliding window and segment ids (_mask_for_block, _seg_mask), GQA by
// reading KV head hq / group (KV is never copied), ragged Lq / Lk, inputs
// read through their strides, and an optional lse output (fp32, natural log)
// that the backward kernels (flash_bwd.cu) read.  K4's K/V tiles are
// dequantized in q's type T as the TPU kernel does it (payload.to(T) *
// scale.to(T), rounded to T), so from there on K4 is K1.
//
// Head dims: 64, 128 and, for bf16 / fp16, 256 (flash_fwd_d256.cu
// instantiates D = 256 in a source of its own), 512 and 1024 (the wide
// kernel of flash_fwd_wide.cuh: two consumer warpgroups share a 64-row
// query tile, each reduces S over half the head dim and accumulates 256 of
// a block's 512 output columns; flash_fwd_wide.cu and
// flash_fwd_wide_d1024.cu).  fp32 runs 3xTF32 tensor-core kernels
// with design notes of their own: flash_fwd_fp32.cu at 64 and 128,
// flash_fwd_fp32_wide.cuh at 256, 512 and 1024.
//
// What bounds it on this card: at the GPT-2 shapes (h12, L1024, D64, causal)
// the two products need 12.9 GFLOP at b8 (13.0 us at 989 TFLOP/s) and q, k, v
// and o 50 MB (15.0 us at 3.35 TB/s), so at D = 64 the bytes set the bound by
// a hair, and the FLOPs at any larger head dim or longer sequence (at b8 h12
// L1024 D256: 51.5 GFLOP, 0.052 ms, against 201 MB, 0.060 ms, so the bytes
// by a hair again).  In
// practice the limit is the softmax: at D = 64 the exp2 of each score costs
// the special-function unit as long as the score's 256 FLOPs of products
// cost the tensor cores.  What feeds the tensor cores at their rate on
// Hopper is wgmma fed by TMA, so the bf16 / fp16 kernel (flash_fwd_ws_kernel)
// is warp-specialised:
//   * one producer warpgroup: one thread issues the TMA loads of the q tile
//     (once) and of each K/V tile into a ring of kStages shared-memory slots,
//     each slot with a "full" mbarrier (TMA transaction bytes) and an
//     "empty" one (one arrival per consumer thread), so that loads run ahead
//     of the math.  Segment ids are staged into the slot beside K and V by
//     the warpgroup's threads.  K4: TMA lands the 1-byte payload tiles in two
//     staging slots one tile ahead, and the 128 threads dequantize them into
//     the ring slot with integer and fp32 adds (not the conversion unit,
//     which the consumers' exp2 needs), fp32 scales by plain loads (their row
//     stride of Lk * 4 bytes breaks TMA's 16-byte rule), then arrive on
//     "full";
//   * kConsumers consumer warpgroups (by default 3 at D = 64, 2 at D = 128,
//     as the registers allow; at D = 256 1 for K1 and 2 for K4, below; K1
//     is also built with fewer, for tiles of 128 and 64 rows at D = 64 and
//     64 at D = 128, which the autotuner sweeps), each
//     owning 64 query rows: S = Q K^T by wgmma from
//     shared memory (K stored [Bc, D], K-major), the online softmax on the
//     accumulator's registers (a thread holds parts of two rows; quad
//     shuffles reduce them), and O += P V by wgmma with P from registers (the
//     accumulator's layout is the A operand's) and V as an MN-major
//     (transposed) B operand.  Three warpgroups at D = 64 give each
//     scheduler three softmaxes to interleave;
//   * setmaxnreg moves registers from the producer to the consumers; every
//     wgmma operand is ready before wgmma.fence, and every branch around a
//     wgmma is uniform by construction, else ptxas serialises all of them;
//   * tiles are kBr x 64 (kBr = 64 kConsumers) with 128-byte swizzled rows, as
//     TMA writes them and wgmma's descriptors read them; q/k/v tensor maps
//     are 4-D (D, L, H, B), so rows past Lq or Lk read as zero, never as the
//     next head's rows;
//   * the KV loop of each warpgroup runs from the first tile the window
//     admits to the last the causal rule admits (the block loads the union
//     of its warpgroups' ranges), and only tiles that cross the diagonal, the
//     window edge or the ragged end, or carry segment ids, pay for the
//     element mask: two compares against each row's visible key range;
//   * blocks are issued longest causal KV loop first;
//   * D = 256: the 64 x 256 fp32 accumulator is 128 registers a consumer
//     thread, and ptxas gives a thread of a 384-thread block 168 whatever
//     setmaxnreg grants, so with two consumer warpgroups it spills.  K1
//     has one (64 query rows, 256 threads, 255 registers without
//     setmaxnreg) and no spills, and is faster for it (tools/d256_ab.py);
//     K4 keeps two and spills, since with half the rows a block its
//     producer, which dequantizes every K/V tile it loads, would convert
//     twice as many tiles.  The ring has two slots (a K and a V tile are 64
//     KB), K4 one payload staging slot (two would pass 227 KB).  q's
//     descriptors are made per 64-column block instead of held (32
//     registers), S is issued in four commit groups of four k16 steps, and
//     each k16 step of PV is two N = 128 products into the accumulator's
//     halves.
// fp32 inputs run flash_fwd_fp32.cu's kernel at 64 and 128 and
// flash_fwd_fp32_wide.cuh's at 256, 512 and 1024: one TF32 pass would miss
// the fp32 tolerance of 1e-5, so they split every operand and product in
// three (3xTF32 on mma.sync; tf32x3.cuh).
// ptxas -v (sm_90a, CUDA 12.8) reports the registers at launch, 65,536 /
// threads: 128 at D = 64 (512 threads; setmaxnreg: producer 32, K4's 40,
// consumers 160, K4's 152) and 168 at D = 128 (384 threads; producer 32,
// K4's 56, consumers 232, K4's 224); no spills, except 8 bytes in each of
// K4's four D = 128 instantiations.  At D = 256: K1 198 registers (256
// threads), no spills; K4 168 with 280 bytes of spill stores (K1 with two
// consumer warpgroups: 168, 308 bytes).  The wide kernel (flash_fwd_wide.cuh,
// 384 threads): 167 registers and 64 bytes of spill stores at D = 512 (K1
// and K4), 162 and no spills at D = 1024; with a one-warp producer (288
// threads) ptxas still gave 168 and K1 spilled 136 bytes at D = 512.  No
// wgmma is serialised (C7518).
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry points return cudaGetLastError() so that the wrapper can raise (and
// cudaErrorInvalidValue when a tensor map cannot be made).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

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
  int batch, hq, hkv, group;
  Mask mask;
  float scale_log2;  // sm_scale * log2(e)
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

// ---------------------------------------------------------------------------
// bf16 / fp16: the warp-specialised TMA + wgmma kernel
// ---------------------------------------------------------------------------

// Consumer warpgroups, 64 query rows each, of the default tile.  At D = 256
// a consumer holds a 128-register accumulator, and ptxas gives a thread of a
// 384-thread block 168 whatever setmaxnreg grants: K1 has one consumer
// warpgroup (256 threads, 255 registers, no setmaxnreg, no spills); K4 keeps
// two (and spills), since with half the rows a block its producer would
// dequantize every K/V tile twice as often.
template <typename T, typename KV, int D>
constexpr int default_consumers() {
  return D == 64 ? 3 : D == 128 || !std::is_same<T, KV>::value ? 2 : 1;
}

// Its tile and shared memory.  The Python side mirrors kBr, kBc, kStages,
// kStaging and the layout (kernels/block_sizes.py::forward_smem_bytes).
// NC, the consumer warpgroups, sets the tile's height kBr = 64 NC: K1 is
// built at every height its registers allow (block_sizes.py::K1_TILES:
// 192, 128 and 64 rows at D = 64, 128 and 64 at D = 128, 64 at D = 256),
// K4 at its default only.
template <typename T, typename KV, int D, int NC = default_consumers<T, KV, D>()>
struct WsCfg {
  static_assert(D == 64 || D == 128 || D == 256, "head dims 64, 128 and 256");
  static_assert(NC >= 1 && NC <= 3 && (D == 64 || NC <= 2) && (D < 256 || NC <= default_consumers<T, KV, D>()),
                "the consumer warpgroups the registers allow");
  static constexpr bool kQuant = !std::is_same<T, KV>::value;
  static constexpr int kConsumers = NC;
  static constexpr int kBr = 64 * kConsumers;
  static constexpr int kBc = 64;
  // K/V ring slots: a K and a V tile take 64 KB at D = 256, where a third
  // slot for K1 was measured no faster
  static constexpr int kStages = D < 256 ? 4 : 2;
  static constexpr int kStaging = D == 256 ? 1 : 2;  // K4's payload staging slots, as shared memory allows
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kTileBytes = kBc * D * 2;  // a K or V slot
  static constexpr int kPayloadBytes = kQuant ? kBc * D : 0;  // K4: one K or V payload tile
  static constexpr int kOffK = kBr * D * 2;  // the q tile sits at 0
  static constexpr int kOffV = kOffK + kStages * kTileBytes;
  static constexpr int kOffPayload = kOffV + kStages * kTileBytes;  // K4: kStaging slots of (K, V)
  static constexpr int kOffIds = kOffPayload + kStaging * 2 * kPayloadBytes;
  static constexpr int kOffBars = kOffIds + kStages * kBc * 4;
  // q; full and empty per slot; landed per staging slot
  static constexpr int kBars = 1 + 2 * kStages + kStaging;
  // + 1024 to align the base for the 128-byte swizzle
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
  // setmaxnreg: the producer warpgroup hands registers to the consumers
  // (with one consumer warpgroup every thread has 255 from the start).  At
  // launch a thread has 65,536 / kThreads (to a multiple of 8); K4's
  // producer converts tiles and keeps more.
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = kQuant ? (kConsumers == 2 ? 56 : 40) : 32;
  static constexpr int kConsumerRegs =
      (kLaunchRegs + (kLaunchRegs - kProducerRegs) / kConsumers) / 8 * 8 < 240
          ? (kLaunchRegs + (kLaunchRegs - kProducerRegs) / kConsumers) / 8 * 8
          : 240;
};

struct FwdMaps {
  CUtensorMap q, k, v;  // K4: k and v map the 1-byte payloads
};

// Byte offset of the 16-byte chunk `col8` (columns 8 col8 .. 8 col8 + 7) of
// row r in a [rows, D] tile of 2-byte elements laid out as TMA's 128-byte
// swizzle writes it: 64-column blocks one after the other, each `rows` rows
// of 128 bytes whose eight chunks are permuted by XOR with r % 8.
__device__ __forceinline__ int swizzle128(int r, int col8, int rows) {
  return (col8 / 8) * rows * 128 + r * 128 + (((col8 % 8) ^ (r % 8)) * 16);
}

// K4: 16 payload values (int8 or fp8 e4m3) to 16 T in two uint4, each
// payload.to(T) * scale.to(T) rounded to T, as the TPU kernel does it
// (quant/kv.py:149-151, :175-177); scale2 holds the scale, already rounded
// to T, in both halves of a T pair.  Every payload value is exact in T, so
// the conversion is exact and the pairwise T multiply rounds once, as the
// TPU's does.  int8 goes through the float 2^23 + 128 + x, built with a
// byte permute (full-rate integer and fp32 adds instead of the conversion
// unit, which the consumers' exp2 needs); fp8 through the hardware's fp8x2
// to half2 conversion.
template <typename T, typename KV>
__device__ __forceinline__ void dequant16(const uint4& raw, uint32_t scale2, uint4 (&out)[2]) {
  using T2 = typename std::conditional<std::is_same<T, __half>::value, __half2, __nv_bfloat162>::type;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
  uint32_t* y = reinterpret_cast<uint32_t*>(out);
  const T2 sc = *reinterpret_cast<const T2*>(&scale2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t pair[2];  // payload bytes 4i .. 4i + 3 as two exact T pairs
    if constexpr (std::is_same<KV, int8_t>::value) {
      const uint32_t u = w[i] ^ 0x80808080u;  // x + 128, a byte each
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - 8388736.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) pair[h] = Pack<T>::two(f[2 * h], f[2 * h + 1]);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __half2 x2(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), __NV_E4M3));
        if constexpr (std::is_same<T, __half>::value) {
          pair[h] = *reinterpret_cast<const uint32_t*>(&x2);
        } else {
          const float2 f = __half22float2(x2);
          pair[h] = Pack<T>::two(f.x, f.y);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const T2 prod = __hmul2(*reinterpret_cast<const T2*>(&pair[h]), sc);
      y[2 * i + h] = *reinterpret_cast<const uint32_t*>(&prod);
    }
  }
}

// K4: pieces [part * PIECES, (part + 1) * PIECES) (16 payload bytes each)
// of row r of a payload tile (row-major, one byte an element) into row r of
// a T tile laid out as swizzle128 says, dequantized with `scale2` (the row's
// scale rounded to T, in both halves of a pair); `valid` false (past the end
// of KV) writes zeros.  A thread converts whole pieces of one row, so that
// it needs one scale; it starts at its own piece to spread its neighbours'
// shared-memory reads over the banks.
template <typename T, typename KV, int D, int ROWS, int PIECES>
__device__ __forceinline__ void dequant_row(T* dst, const uint8_t* src, int r, int part, uint32_t scale2,
                                            bool valid) {
  static_assert(sizeof(KV) == 1, "quantized payloads are 1 byte");
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int piece = part * PIECES + (i + r) % PIECES;  // output chunks 2 piece, 2 piece + 1
    uint4 out[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    if (valid) dequant16<T, KV>(*reinterpret_cast<const uint4*>(src + r * D + piece * 16), scale2, out);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(dst) + swizzle128(r, 2 * piece + h, ROWS)) = out[h];
  }
}

template <typename T, typename KV, int D, int NC>
__global__ void __launch_bounds__(WsCfg<T, KV, D, NC>::kThreads, 1)
flash_fwd_ws_kernel(const __grid_constant__ FwdParams p, const __grid_constant__ FwdMaps maps) {
  using C = WsCfg<T, KV, D, NC>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kS = C::kStages;
  constexpr int kTile = kBc * D;  // elements of a K or V slot
  constexpr int kRowThreads = 128 / kBc;  // K4: producer threads converting one KV row
  static_assert(kBc <= 128 && 128 % kBc == 0, "KV rows spread evenly over the producer's 128 threads");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + C::kOffK);  // kS slots
  T* sV = reinterpret_cast<T*>(smem + C::kOffV);
  uint8_t* sPay = smem + C::kOffPayload;  // K4: 2 x (K, V) payload tiles
  int* sIds = reinterpret_cast<int*>(smem + C::kOffIds);  // kS x kBc KV segment ids
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full = q_full + 1;        // slot s holds its K/V tile
  uint64_t* empty = full + kS;        // every consumer warpgroup is done with slot s
  uint64_t* landed = empty + kS;      // K4: staging slot i's payloads have arrived
  constexpr int kSt = C::kStaging;

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
  // Producer threads that write into a slot (segment ids, K4's tiles) arrive
  // on its "full" barrier; otherwise only the TMA thread does.
  const bool all_produce = C::kQuant || kv_ids != nullptr;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], all_produce ? 128 : 1);
      sm90::mbar_init(&empty[s], 128 * C::kConsumers);
    }
    for (int i = 0; i < kSt; ++i) sm90::mbar_init(&landed[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup's index broadcast from lane 0, so that ptxas sees every
  // branch on it (and on values made from it) as uniform in each warp:
  // a wgmma under a branch it takes for divergent makes it serialise every
  // wgmma of the kernel.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---------------- producer warpgroup ----------------
    if constexpr (C::kConsumers > 1) sm90::reg_dealloc<C::kProducerRegs>();
    if (!all_produce && tid != 0) return;
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(q_full, kBr * D * 2);
      for (int c = 0; c < D / 64; ++c) sm90::tma_load_4d(sQ + c * kBr * 64, &maps.q, q_full, c * 64, r0, h, b);
    }
    const bool has_row = tid < kBc;  // the KV row of the tile this thread stages
    if constexpr (!C::kQuant) {
      for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
        const int s = it % kS;
        sm90::mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
        if (kv_ids != nullptr && has_row) sIds[s * kBc + tid] = j * kBc + tid < mk.lk ? kv_ids[j * kBc + tid] : -1;
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
    } else {
      // K4: TMA lands tile j's payloads in staging slot it % kSt: with two
      // slots one tile ahead of the conversion, with one (D = 256) as soon
      // as the previous tile's conversion is done.  Only this warpgroup
      // reads the staging, so a named barrier among its 128 threads at the
      // end of each tile frees the slot.
      const KvRows<KV> kv(p, b, hk);
      auto fetch = [&](int it, int j) {
        uint64_t* bar = &landed[it % kSt];
        uint8_t* dst = sPay + 2 * (it % kSt) * C::kPayloadBytes;
        sm90::mbar_arrive_expect_tx(bar, 2 * C::kPayloadBytes);
        sm90::tma_load_4d(dst, &maps.k, bar, 0, j * kBc, hk, b);
        sm90::tma_load_4d(dst + C::kPayloadBytes, &maps.v, bar, 0, j * kBc, hk, b);
      };
      // this thread's row's scales, as T pairs, loaded a tile ahead
      auto scales = [&](int j, uint32_t& k_sc, uint32_t& v_sc) {
        const int row = j * kBc + tid / kRowThreads;
        const bool ok = j < j_hi && row < mk.lk;
        const float k = ok ? __ldg(kv.ks + row) : 0.f;
        const float v = ok ? __ldg(kv.vs + row) : 0.f;
        k_sc = Pack<T>::two(k, k);
        v_sc = Pack<T>::two(v, v);
      };
      if (tid == 0 && j_lo < j_hi) fetch(0, j_lo);
      uint32_t k_sc, v_sc;
      scales(j_lo, k_sc, v_sc);
      for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
        const int s = it % kS;
        const int row = j * kBc + tid / kRowThreads;  // the row this thread converts
        if (kSt == 2 && tid == 0 && j + 1 < j_hi) fetch(it + 1, j + 1);
        uint32_t k_next, v_next;
        scales(j + 1, k_next, v_next);
        sm90::mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
        if (kv_ids != nullptr && has_row) sIds[s * kBc + tid] = j * kBc + tid < mk.lk ? kv_ids[j * kBc + tid] : -1;
        sm90::mbar_wait(&landed[it % kSt], (it / kSt) & 1);
        {
          constexpr int kPieces = D / 16 / kRowThreads;
          const uint8_t* pay = sPay + 2 * (it % kSt) * C::kPayloadBytes;
          const int r = tid / kRowThreads, part = tid % kRowThreads;
          dequant_row<T, KV, D, kBc, kPieces>(sK + s * kTile, pay, r, part, k_sc, row < mk.lk);
          dequant_row<T, KV, D, kBc, kPieces>(sV + s * kTile, pay + C::kPayloadBytes, r, part, v_sc, row < mk.lk);
        }
        sm90::fence_proxy_async();  // the generic writes, before wgmma reads them
        sm90::mbar_arrive(&full[s]);
        sm90::named_bar_sync(1, 128);  // every producer thread is done with staging slot it % kSt
        if (kSt == 1 && tid == 0 && j + 1 < j_hi) fetch(it + 1, j + 1);
        k_sc = k_next;
        v_sc = v_next;
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  if constexpr (C::kConsumers > 1) sm90::reg_alloc<C::kConsumerRegs>();
  const int cw = wg - 1;  // this warpgroup's 64 rows of the tile
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
  // The keys [lo, hi] each of them sees (Mask::visible: causal, window,
  // ragged ends; empty past Lq), and its segment id.
  int lo[2], hi[2], q_id[2] = {0, 0};
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lo[r] = mk.kv_first(row);
    hi[r] = row < mk.lq ? mk.kv_end(row + 1) - 1 : -1;
    if (p.q_ids != nullptr && row < mk.lq) q_id[r] = p.q_ids[(long long)b * mk.lq + row];
  }

  // q scaled by sm_scale*log2(e) and rounded back to T, as the TPU kernel
  // does before its QK^T: in place, this warpgroup's rows of each 64-column
  // block (the swizzle permutes chunks within a row, which an elementwise
  // pass does not see).
  sm90::mbar_wait(q_full, 0);
  if (active) {
    for (int c = 0; c < D / 64; ++c) {
      uint4* rows = reinterpret_cast<uint4*>(sQ + c * kBr * 64 + cw * 64 * 64);
      for (int i = tid; i < 64 * 8; i += 128) {
        uint4 v = rows[i];
        T* x = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = from_float<T>(to_float(x[e]) * p.scale_log2);
        rows[i] = v;
      }
    }
    sm90::fence_proxy_async();
  }
  sm90::named_bar_sync(2 + cw, 128);

  // K-major descriptors: a k16 step moves 32 bytes along a 128-byte row, and
  // every fourth one to the next 64-column block.  Up to D = 128 q's are
  // made once; at D = 256 they would hold 32 registers, so S is issued a
  // 64-column block (4 steps) at a time with both operands' descriptors made
  // for that block.
  constexpr bool kGrouped = D > 128;
  auto q_desc = [&](int kk) {
    return sm90::smem_desc(sQ + (kk / 4) * kBr * 64 + cw * 64 * 64 + (kk % 4) * 16, 16, 1024);
  };
  uint64_t dq[kGrouped ? 1 : D / 16];
  if constexpr (!kGrouped) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) dq[kk] = q_desc(kk);
  }

  float acc[D / 2];
  float sc[kBc / 2];  // S = Qs K^T: [64, kBc], as kBc / 8 blocks of 8 columns x 4 registers
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBc / 2; ++i) sc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
    const int s = it % kS;
    sm90::mbar_wait(&full[s], (it / kS) & 1);
    if (j >= my_lo && j < my_hi) {
      const T* k_s = sK + s * kTile;
      const T* v_s = sV + s * kTile;
      const int c0 = j * kBc;

      // S = Qs K^T.  Descriptors, like every operand, are ready before
      // wgmma.fence (fence_regs).
      auto k_desc = [&](int kk) { return sm90::smem_desc(k_s + (kk / 4) * kBc * 64 + (kk % 4) * 16, 16, 1024); };
      if constexpr (!kGrouped) {
        uint64_t dk[D / 16];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) dk[kk] = k_desc(kk);
        sm90::fence_regs(dk);
        sm90::fence_regs(sc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) sm90::wgmma_ss<T, kBc>(sc, dq[kk], dk[kk], kk > 0);
        sm90::wgmma_commit();
      } else {
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          uint64_t da[4], db[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            da[kk] = q_desc(4 * c + kk);
            db[kk] = k_desc(4 * c + kk);
          }
          sm90::fence_regs(da);
          sm90::fence_regs(db);
          sm90::fence_regs(sc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) sm90::wgmma_ss<T, kBc>(sc, da[kk], db[kk], c > 0 || kk > 0);
          sm90::wgmma_commit();
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // Element mask only where the tile crosses the diagonal, the window
      // edge or the KV end, or where segment ids apply.
      if (kv_ids != nullptr || !mk.tile_visible(wr0, 64, c0, kBc)) {
        const int* ids = sIds + s * kBc;
#pragma unroll
        for (int nb = 0; nb < kBc / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int cl = nb * 8 + 2 * t + (e & 1);
            bool ok = c0 + cl >= lo[r] && c0 + cl <= hi[r];
            if (kv_ids != nullptr) ok = ok && q_id[r] == ids[cl];
            if (!ok) sc[4 * nb + e] = -CUDART_INF_F;
          }
      }

      // Online softmax for rows g (e = 0, 1) and g + 8 (e = 2, 3); the four
      // threads of a quad hold one row between them.  Four partial maxima
      // and sums a row shorten the dependency chains.
      float mx[2][4], sum[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mx[0][q] = fmaxf(sc[4 * q], sc[4 * q + 1]);
        mx[1][q] = fmaxf(sc[4 * q + 2], sc[4 * q + 3]);
      }
#pragma unroll
      for (int nb = 4; nb < kBc / 8; ++nb) {
        mx[0][nb % 4] = fmaxf(mx[0][nb % 4], fmaxf(sc[4 * nb], sc[4 * nb + 1]));
        mx[1][nb % 4] = fmaxf(mx[1][nb % 4], fmaxf(sc[4 * nb + 2], sc[4 * nb + 3]));
      }
      float base[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float row_max = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
        const float m_new = fmaxf(m[r], row_max);
        base[r] = m_new == -CUDART_INF_F ? 0.f : m_new;  // fully masked so far
        alpha[r] = exp2_ftz(m[r] - base[r]);
        m[r] = m_new;
      }
#pragma unroll
      for (int nb = 0; nb < kBc / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * nb + e] = exp2_ftz(sc[4 * nb + e] - base[e >> 1]);
        if (nb < 4) {
          sum[0][nb] = sc[4 * nb] + sc[4 * nb + 1];
          sum[1][nb] = sc[4 * nb + 2] + sc[4 * nb + 3];
        } else {
          sum[0][nb % 4] += sc[4 * nb] + sc[4 * nb + 1];
          sum[1][nb % 4] += sc[4 * nb + 2] + sc[4 * nb + 3];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)  // per-thread partial; quad-summed at the end
        l[r] = l[r] * alpha[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        acc[4 * nd] *= alpha[0];
        acc[4 * nd + 1] *= alpha[0];
        acc[4 * nd + 2] *= alpha[1];
        acc[4 * nd + 3] *= alpha[1];
      }

      // acc += P V, P rounded to T: the accumulator's two 8-column blocks
      // 2kk, 2kk + 1 are the A fragment of k16 step kk.  V is the MN-major B
      // operand: a step moves 16 rows (2 KB) down its 64-column blocks, which
      // lie kBc rows (kBc * 128 bytes) apart.  wgmma's N is at most 128 here,
      // so at D = 256 each step is two products of 128 columns, the first
      // into acc[0, 64) (columns 0-127), the second into acc[64, 128).
      constexpr int kN = D < 128 ? D : 128;
      uint32_t pa[kBc / 16][4];
      uint64_t dv[kBc / 16 * (D / kN)];
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) {
        pa[kk][0] = Pack<T>::two(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = Pack<T>::two(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = Pack<T>::two(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = Pack<T>::two(sc[8 * kk + 6], sc[8 * kk + 7]);
#pragma unroll
        for (int n = 0; n < D / kN; ++n)
          dv[kk * (D / kN) + n] = sm90::smem_desc(v_s + n * (kN / 64) * kBc * 64 + kk * 16 * 64, kBc * 128, 1024);
      }
      sm90::fence_regs(pa);
      sm90::fence_regs(dv);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk)
#pragma unroll
        for (int n = 0; n < D / kN; ++n)
          sm90::wgmma_rs<T, kN>(*reinterpret_cast<float(*)[kN / 2]>(acc + n * (kN / 2)), pa[kk],
                                dv[kk * (D / kN) + n]);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(&empty[s]);
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* go = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= mk.lq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    T* orow = go + (long long)row * p.o_sl + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          Pack<T>::two(acc[4 * nd + 2 * r] * inv, acc[4 * nd + 2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(long long)bh * mk.lq + row] = (m[r] + log2f(l_safe)) * kLn2;
    }
  }
}

template <typename T, typename KV, int D, int NC = default_consumers<T, KV, D>()>
cudaError_t launch_ws(const FwdParams& p, cudaStream_t stream) {
  using C = WsCfg<T, KV, D, NC>;
  constexpr CUtensorMapDataType kType =
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  const Mask& mk = p.mask;
  FwdMaps maps;
  bool ok = sm90::make_map_4d(&maps.q, kType, 2, p.q, D, mk.lq, p.hq, p.batch, p.q_sl, p.q_sh, p.q_sb, 64,
                              C::kBr, kSw);
  if constexpr (C::kQuant) {  // whole payload rows into the staging buffer, unswizzled
    constexpr CUtensorMapDataType kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
    ok = ok && sm90::make_map_4d(&maps.k, kU8, 1, p.k, D, mk.lk, p.hkv, p.batch, p.k_sl, p.k_sh, p.k_sb, D, C::kBc,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
    ok = ok && sm90::make_map_4d(&maps.v, kU8, 1, p.v, D, mk.lk, p.hkv, p.batch, p.v_sl, p.v_sh, p.v_sb, D, C::kBc,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    ok = ok && sm90::make_map_4d(&maps.k, kType, 2, p.k, D, mk.lk, p.hkv, p.batch, p.k_sl, p.k_sh, p.k_sb, 64,
                                 C::kBc, kSw);
    ok = ok && sm90::make_map_4d(&maps.v, kType, 2, p.v, D, mk.lk, p.hkv, p.batch, p.v_sl, p.v_sh, p.v_sb, 64,
                                 C::kBc, kSw);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_ws_kernel<T, KV, D, NC>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((mk.lq + C::kBr - 1) / C::kBr, p.batch * p.hq);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(p, maps);
  return cudaGetLastError();
}

// K1 and K4 at D = 256 for bf16 (dtype 1) and fp16 (2), over K/V of q's
// dtype (kv_dtype 0), int8 (1) or fp8 e4m3 (2): flash_fwd_d256.cu.
cudaError_t launch_ws_d256(int dtype, int kv_dtype, const FwdParams& p, cudaStream_t s);

// K1 and K4 at D = 512 (flash_fwd_wide.cu) and 1024 (flash_fwd_wide_d1024.cu)
// for bf16 (dtype 1) and fp16 (2): flash_fwd_wide.cuh's kernel, two consumer
// warpgroups sharing a 64-row query tile.
cudaError_t launch_fwd_wide_d512(int dtype, int kv_dtype, const FwdParams& p, cudaStream_t s);
cudaError_t launch_fwd_wide_d1024(int dtype, int kv_dtype, const FwdParams& p, cudaStream_t s);

// K1 and K4 for fp32 q (dtype 0), over fp32 K/V (kv_dtype 0), int8 (1) or
// fp8 e4m3 (2), on 3xTF32 tensor-core kernels: at D = 64 and 128
// flash_fwd_fp32.cu's; at 256 and 512 (flash_fwd_fp32_wide.cu) and 1024
// (flash_fwd_fp32_wide_d1024.cu) flash_fwd_fp32_wide.cuh's, whose warps
// split the output columns and sum S from partials.
cudaError_t launch_fwd_fp32(int kv_dtype, int head_dim, const FwdParams& p, cudaStream_t s);
cudaError_t launch_fwd_fp32_wide(int kv_dtype, int head_dim, const FwdParams& p, cudaStream_t s);
cudaError_t launch_fwd_fp32_wide_d1024(int kv_dtype, const FwdParams& p, cudaStream_t s);

// K1's tiles other than the default, bf16 (dtype 1) and fp16 (2), each
// head dim's in a source of its own so that they compile beside the rest:
// block_q 128 and 64 at D = 64 (flash_fwd_tiles_d64.cu), 64 at D = 128
// (flash_fwd_tiles_d128.cu); cudaErrorInvalidValue for any other.
cudaError_t launch_k1_tile_d64(int dtype, int block_q, const FwdParams& p, cudaStream_t s);
cudaError_t launch_k1_tile_d128(int dtype, int block_q, const FwdParams& p, cudaStream_t s);

// The kernel for q's dtype (0 = float32, 1 = bfloat16, 2 = float16), K/V
// element type KV (KV = void: q's own type) and head dim: 64, 128, 256, 512
// or 1024 (fp32: the 3xTF32 kernels of flash_fwd_fp32.cu and
// flash_fwd_fp32_wide.cuh); cudaErrorInvalidValue for a combination that is
// not instantiated.  block_q picks K1's tile height
// (bf16 / fp16): 0 or the default's (192 at D = 64, 128 at D = 128, 64 at
// D = 256) for the default, or another of K1_TILES; fp32, K4 and the wide
// kernels (D = 512, 1024) have one tile and take 0 only.
template <typename KV>
cudaError_t launch_fwd_for(int dtype, int head_dim, const FwdParams& p, cudaStream_t s, int block_q = 0) {
  using BF16 = typename std::conditional<std::is_void<KV>::value, __nv_bfloat16, KV>::type;
  using F16 = typename std::conditional<std::is_void<KV>::value, __half, KV>::type;
  constexpr int kKv = std::is_void<KV>::value ? 0 : std::is_same<KV, int8_t>::value ? 1 : 2;
  if (block_q != 0) {
    const bool wgmma = std::is_void<KV>::value && (dtype == 1 || dtype == 2);
    const int rows = head_dim == 64 ? 192 : head_dim == 128 ? 128 : 64;  // the default tile's
    if (!wgmma || head_dim > 256) return cudaErrorInvalidValue;
    if (block_q != rows) {
      if (head_dim == 64) return launch_k1_tile_d64(dtype, block_q, p, s);
      if (head_dim == 128) return launch_k1_tile_d128(dtype, block_q, p, s);
      return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0 && (head_dim == 64 || head_dim == 128)) return launch_fwd_fp32(kKv, head_dim, p, s);
  if (dtype == 0 && (head_dim == 256 || head_dim == 512)) return launch_fwd_fp32_wide(kKv, head_dim, p, s);
  if (dtype == 0 && head_dim == 1024) return launch_fwd_fp32_wide_d1024(kKv, p, s);
  if (dtype == 1 && head_dim == 64) return launch_ws<__nv_bfloat16, BF16, 64>(p, s);
  if (dtype == 1 && head_dim == 128) return launch_ws<__nv_bfloat16, BF16, 128>(p, s);
  if (dtype == 2 && head_dim == 64) return launch_ws<__half, F16, 64>(p, s);
  if (dtype == 2 && head_dim == 128) return launch_ws<__half, F16, 128>(p, s);
  if ((dtype == 1 || dtype == 2) && head_dim == 256) return launch_ws_d256(dtype, kKv, p, s);
  if ((dtype == 1 || dtype == 2) && head_dim == 512) return launch_fwd_wide_d512(dtype, kKv, p, s);
  if ((dtype == 1 || dtype == 2) && head_dim == 1024) return launch_fwd_wide_d1024(dtype, kKv, p, s);
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
  p.batch = batch;
  p.hq = hq;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.mask = Mask{lq, lk, causal, causal ? window : 0};
  p.scale_log2 = scale_log2;
  return true;
}

}  // namespace fa
