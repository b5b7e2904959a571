// One-token decode attention for Hopper (sm_90a): K5, the paged kernel
// (fa_paged_decode), and K6, the slot-major kernel (fa_fused_decode), two
// instantiations of one split-KV kernel template, at head dims 64, 128 and
// 256.  This header holds the template; decode.cu holds the plain C entry
// points loaded through ctypes (flash_attention_tpu_torch/kernels/_build.py),
// and the instantiations are split by q dtype and head dim over
// decode_<fp32|bf16|fp16>_d<D>.cu (9 sources, one nvcc each), so that no
// one nvcc holds the build up.  Head dims 8-32 run decode_narrow.cuh (groups
// of up to 8), head dims above 256 decode_wide.cuh, a GQA group above 8
// decode_group.cuh (16-bit q) or decode_group_fp32.cuh (fp32 q): the host
// routes no group above 8 to this kernel's group tiles, which still take
// one (the entry point checks only that the tiles cover the group).
//
// Replaces: flash_attention_tpu/inference/paged_attention.py::_paged_kernel
// (K5, launched by paged_attention) and
// flash_attention_tpu/inference/decode_attention.py::_fused_kernel (K6,
// launched by decode_attention_fused).  Both compute, for each sequence, the
// attention of its one new query row per q head over the sequence's first n
// cached tokens, with int8/fp8 payloads dequantized by one fp32 scale per
// token.  They differ in how a token's row is found: K5 reads the
// sequence's page-table row (page = table[t / page_size], row t % page_size
// of that page), K6 reads slot-major rows of one layer [kv_heads, slots,
// max_len, D] through a base pointer and strides, so the layer's cache is
// read in place (no per-layer copy).  Numerics, as the TPU kernels:
//   * K5: s = (q . k) * sm_scale in fp32, then * k_scale; n = max(lengths +
//     len_add, 1) (paged_attention.py:187, :197, :371).
//   * K6: q pre-scaled by sm_scale and rounded to q's dtype, s = (q . k) *
//     k_scale; n = lengths + 1 (decode_attention.py:473, :527).
//   * Both: natural exp, an online softmax in fp32, p * v_scale rounded to
//     q's dtype before the PV product, V's payload read in q's dtype (exact
//     for int8 and fp8 in bf16 and fp16), one final division with the
//     l == 0 guard.  The TPU K6 rounds p to bf16 for an int8 cache and to
//     fp8 for an fp8 cache (pv_dtype, decode_attention.py:361); this port
//     rounds it to q's dtype, as the einsum path and K5 do.  Only the order
//     of summation differs from the plain versions (per tile of 16 tokens,
//     then across a block's warps, then across splits).
// Lane packing for D < 128, the score-column-order scale layout and the
// parity-fold matmuls of the TPU kernels were layout rules of the TPU's
// (8, 128) tiles and have no counterpart here.
//
// What it takes: q in fp32, bf16 or fp16; K/V in q's dtype, or int8 / fp8
// e4m3 with scales; any GQA group; head dims 64, 128 and 256 (Width<D>).
//
// What bounds it on this card: bytes.  A decode step reads each live
// token's K and V row once, at 2 FLOPs per byte and q row of the GQA group
// for a 1-byte cache (4 FLOPs per element), far below the card's balance
// point.  Reaching the byte rate needs many bytes in flight: a DRAM round
// trip takes about a microsecond, so at 3.35 TB/s some 25 KB must be on
// their way to each SM at all times.  What the design does about it:
//   * split-KV (flash-decoding): the grid is (KV head x group tile,
//     sequence, split), splits last so that the live blocks (low splits)
//     are dispatched first.  Each block takes a chunk of `chunk` tokens of
//     its sequence (whole pages for K5, a row range for K6), chosen by the
//     host from the cache's capacity and the SM count (never from the
//     lengths, which would cost a device sync), so that the card holds
//     several blocks per SM.  A block whose chunk starts at or past its
//     sequence's length exits at once.  K5 reads its chunk's page-table
//     entries once, into shared memory, beside the length rather than
//     after it;
//   * a GQA group of more than kMaxRows (8) q heads is split into group
//     tiles of at most 8 rows (multi-query attention: 16-71 q heads on one
//     KV head), a block each: the registers of a lane hold 8 rows of q and
//     of the output.  The blocks of one KV head's tiles read the same K/V
//     rows, the later ones mostly from L2;
//   * inside a block each of the 4 warps takes every fourth 16-token tile of
//     the chunk through a shared-memory ring of its own (4 stages for
//     64-byte rows, 2 for wider ones), filled with 16-byte `cp.async`
//     copies (4-byte ones for the scales of a quantized cache), rows past
//     the length zero-filled without a read.  A warp
//     computes on one stage while the next ones land, and keeps its own
//     softmax state: no block-wide barrier until the four warps' states
//     merge at the end.  So the block's ring has 16 (or 8) tile slots, 12
//     (or 4) of them in flight while the warps compute; a deeper ring for
//     wider rows fits fewer blocks on an SM and was slower on the H100
//     (Layout, below);
//   * at D256 a token's row is split into column slabs (Width<D>::kSlabs:
//     2 of 128 columns), a warp each: the warps of a slab set take the same
//     tiles, each stages and
//     reads only its own slab of K and V, computes a partial S over it and
//     P V for its own columns; the partial S are summed through shared
//     memory in one fixed order (a named barrier of the set per tile), so
//     every warp of the set holds the same S and the same softmax state;
//   * per tile: S = q K^T with (slab width) / 8 lanes per token, the group's
//     q rows held in registers in fp32 and the lanes' partial sums
//     reduce-scattered across the group's rows by shuffles, or, for a GQA
//     group with bf16 or fp16 q, on the tensor cores (mma.sync, below); one
//     online-softmax step per tile and q row (a half-warp per row, a lane
//     per token); P V with each lane owning 8 output columns of every q row
//     for a subset of the tile's tokens, so K and V are read from shared
//     memory once for the block's q rows;
//   * merge in the same launch: a sequence's live splits write their
//     (m, l, acc) to an fp32 workspace; an arrival counter per (sequence,
//     KV head, group tile) (__threadfence, then atomicAdd) picks the last
//     to finish, which merges them with the lse rule in one pass, writes the
//     output and resets the counter to 0.  A sequence with one live split
//     writes its output directly.  So a layer's decode step stays one
//     launch.
// The workspace and counters belong to the caller (the wrapper allocates
// them once per device and size and reuses them): two launches that share
// one workspace must not run concurrently, so two streams must not share
// one workspace.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry points return cudaGetLastError() so that the wrapper can raise.
#pragma once

#include "common.cuh"

namespace fa {
namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;        // tokens of one stage of a warp's ring
constexpr int kMaxSplits = 64;   // splits per sequence (the host keeps to it)
constexpr int kMaxPages = 256;   // page-table entries of one chunk (the host keeps to it)
constexpr int kMaxRows = 8;      // q rows of a group tile, a block's share of a GQA group
constexpr unsigned kFull = 0xffffffffu;

struct DecodeParams {
  const void* q;         // [batch, hq, d], last dim contiguous
  const void* k;         // payload: paged [hkv, pages, page_size, d] or slot-major [hkv, slots, max_len, d]
  const void* v;
  const float* ks;       // scales [hkv, pages or slots, rows], last stride 1; null unless quantized
  const float* vs;
  const int* lengths;    // [batch]
  const int* table;      // [batch, pages_per_seq] (K5) or null (K6)
  void* o;               // [batch, hq, d]
  float* ws;             // partials [batch, hkv * gtiles, splits, rows, d + 2] (m, l, acc)
  int* counters;         // [batch, hkv * gtiles], zero between launches
  long long q_sb, q_sh, o_sb, o_sh;
  long long k_sh, k_sp, k_sr, v_sh, v_sp, v_sr, s_sh, s_sp;
  int group, page_size, pages_per_seq, len_add, chunk, splits;
  int head_dim;          // d, at most the instantiated D
  int gtiles, rows;      // group tiles per KV head, q rows per tile (the last may hold fewer)
  float q_scale, score_scale;
};

// The instantiated head dims.  kSlabs: the column slabs a token's row is
// split into (a warp each).
template <int D>
struct Width {
  static_assert(D == 64 || D == 128 || D == 256, "instantiated head dims");
  static constexpr int kSlabs = D <= 128 ? 1 : 2;
  static constexpr int kCols = D / kSlabs;  // columns of a slab
};

// The padded head dim of the whole-group kernels that runs head dim d (32
// for d = 8, 16 and 32), or 0 when none does.
inline int instantiated_width(int d) {
  if (d == 8 || d == 16 || d == 32) return 32;
  if (d == 64 || d == 128 || d == 256) return d;
  return 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes global -> shared, asynchronously; src_bytes 0 writes zeros and
// reads nothing.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src), "n"(N),
                 "r"(src_bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A barrier of `threads` threads on barrier `id` (1 and up: 0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 8 consecutive elements of a K or V row in shared memory, as float (exact
// for every payload type).  int8 through the float 2^23 + 128 + x built with
// a byte permute (full-rate ALU work instead of the conversion unit), fp8
// through the hardware's fp8x2 -> half2 conversion.
template <typename KV>
__device__ __forceinline__ void load8(const KV* s, float (&f)[8]) {
  if constexpr (std::is_same<KV, float>::value) {
    const float4 a = reinterpret_cast<const float4*>(s)[0], b = reinterpret_cast<const float4*>(s)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    const uint4 r = *reinterpret_cast<const uint4*>(s);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (std::is_same<KV, __half>::value) {
    const uint4 r = *reinterpret_cast<const uint4*>(s);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  } else if constexpr (std::is_same<KV, int8_t>::value) {
    const uint2 r = *reinterpret_cast<const uint2*>(s);
    const uint32_t w[2] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u};  // x + 128, a byte each
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[4 * i + e] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + e)) - 8388736.f;
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(s);
    const uint32_t w[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = __half22float2(
            __half2(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), __NV_E4M3)));
        f[4 * i + 2 * h] = x.x;
        f[4 * i + 2 * h + 1] = x.y;
      }
  }
}

// The G partial dot products of each of the L lanes (L a power of two >= G)
// that share one token, reduce-scattered: lane j ends with, in s[0], the
// full sum of row rs_row<G>(j).  G - 1 + log2(L / G) shuffles instead of
// G log2(L).
template <int G>
__device__ __forceinline__ int rs_row(int j) {
  int g = 0;
#pragma unroll
  for (int lvl = 0; (1 << lvl) < G; ++lvl)
    if (j & (1 << lvl)) g += (G >> lvl) / 2;
  return g;
}
template <int G, int L>
__device__ __forceinline__ float reduce_scatter(float (&s)[G], int j) {
#pragma unroll
  for (int lvl = 0; (1 << lvl) < G; ++lvl) {  // halve the vector: lanes j and j ^ 2^lvl keep opposite halves
    const int half = (G >> lvl) / 2;
    const bool hi = j & (1 << lvl);
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = hi ? s[i] : s[i + half];
      const float keep = hi ? s[i + half] : s[i];
      s[i] = keep + __shfl_xor_sync(kFull, send, 1 << lvl);
    }
  }
#pragma unroll
  for (int off = G; off < L; off *= 2) s[0] += __shfl_xor_sync(kFull, s[0], off);
  return s[0];
}

// 4 bytes of an 8-bit payload (e0 in the low byte) as T pairs (bf16 or
// fp16): lo = (e0, e1), hi = (e2, e3), exact (int8 through the exact float,
// whose high half is its bf16; fp8 through the fp8x2 -> half2 conversion).
template <typename T, typename KV>
__device__ __forceinline__ void cvt4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    const uint32_t u = w ^ 0x80808080u;  // x + 128, a byte each
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - 8388736.f;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
      hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
    } else {
      lo = Pack<__half>::two(f[0], f[1]);
      hi = Pack<__half>::two(f[2], f[3]);
    }
  } else {
    static_assert(std::is_same<KV, __nv_fp8_e4m3>::value, "16-bit q reads its own dtype, int8 or fp8 K");
    uint32_t out[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w >> (16 * h)), __NV_E4M3);
      if constexpr (std::is_same<T, __half>::value) {
        out[h] = static_cast<uint32_t>(r.x) | (static_cast<uint32_t>(r.y) << 16);
      } else {
        const float2 x = __half22float2(__half2(r));
        out[h] = __byte_perm(__float_as_uint(x.x), __float_as_uint(x.y), 0x7632);
      }
    }
    lo = out[0];
    hi = out[1];
  }
}

// The A fragment of mma.m16n8k16 from 4 contiguous elements of a K row in
// shared memory: lo = (e0, e1), hi = (e2, e3) as T pairs (bf16 or fp16),
// exact for every payload type.
template <typename T, typename KV>
__device__ __forceinline__ void a_frag(const unsigned char* s, uint32_t& lo, uint32_t& hi) {
  if constexpr (sizeof(KV) == 2) {
    static_assert(std::is_same<KV, T>::value, "a 16-bit payload is q's dtype");
    const uint2 r = *reinterpret_cast<const uint2*>(s);
    lo = r.x;
    hi = r.y;
  } else {
    cvt4<T, KV>(*reinterpret_cast<const uint32_t*>(s), lo, hi);
  }
}

// d += a b: one m16n8k16 product, bf16 or fp16 inputs, fp32 accumulate.
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Shared memory of a block.  A warp's ring has 4 stages for slab rows of up
// to 64 bytes (an int8/fp8 cache at D64) and 2 for wider ones, so that
// enough blocks fit on an SM for the other warps to hide a warp's wait:
// with 3 stages for 128-byte rows a block takes 51 KB instead of 35, 4
// blocks fit an SM instead of 6, and a long context on a bf16 cache at D64
// ran slower on the H100.  With column slabs (D256) the partial S are
// double-buffered (a set's warps write tile j + 1's while a slower one
// still reads tile j's).
template <typename KV, int D, int kMaxG>
struct Layout {
  static constexpr int kRow = Width<D>::kCols * (int)sizeof(KV);   // bytes of a K or V slab row
  static constexpr int kStage = kTile * kRow;                      // bytes of a K or V tile
  static constexpr int kStages = kRow <= 64 ? 4 : 2;
  static constexpr int kRing = 2 * kStages * kStage;               // a warp's K and V rings
  static constexpr int kSBufs = Width<D>::kSlabs > 1 ? 2 : 1;
  static constexpr int kScales = kWarps * kRing;                   // [warp][2][stage][kTile] fp32
  static constexpr int kS = kScales + kWarps * 2 * kStages * kTile * 4;  // scores [buf][warp][kMaxG][kTile]
  static constexpr int kP = kS + kSBufs * kWarps * kMaxG * kTile * 4;    // p [warp][kTile][kMaxG]
  static constexpr int kVec = kP + kWarps * kTile * kMaxG * 4;     // alpha, m, l [warp][kMaxG] each
  static constexpr int kTable = kVec + 3 * kWarps * kMaxG * 4;     // page ids [kMaxPages]; the merge flag
  static constexpr int kBytes = kTable + kMaxPages * 4;
  static_assert(kWarps * kMaxG * Width<D>::kCols * 4 <= kScales, "the block's final reduction aliases the rings");
  static_assert(kBytes <= 227 * 1024, "shared memory of a block");
};

template <typename T, typename KV, int D, int kMaxG, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const DecodeParams p) {
  using L = Layout<KV, D, kMaxG>;
  using W = Width<D>;
  constexpr int S = L::kStages;
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int kSlabs = W::kSlabs;
  constexpr int kStreams = kWarps / kSlabs;  // warps taking tiles of their own
  constexpr int kLanes = W::kCols / 8;       // lanes of one token in S = q K^T, 8 columns each
  constexpr int kTokPass = 32 / kLanes;      // tokens of one S pass of a warp
  constexpr int kCols = W::kCols / 8;        // column groups of P V, 8 columns each
  constexpr int kSub = 32 / kCols;           // token subsets of a warp's P V
  constexpr int kCopies = L::kRow / 16;       // 16-byte copies of a slab row
  constexpr int kRows2 = (kMaxG + 1) / 2;    // q rows of a half-warp in the softmax
  static_assert(kTile % kTokPass == 0 && kTile % kSub == 0 && kTile == 16 && kWarps % kSlabs == 0, "tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  // splits last: live blocks start first; a KV head's group tiles side by side
  const int hk = blockIdx.x / p.gtiles, gt = blockIdx.x % p.gtiles, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int stream = warp / kSlabs, slab = warp % kSlabs;
  const int G = min(p.rows, p.group - gt * p.rows);  // q rows of this block
  const int capacity = kPaged ? p.page_size * p.pages_per_seq : p.page_size;
  const int c0 = split * p.chunk;
  int* sTable = reinterpret_cast<int*>(smem + L::kTable);
  if constexpr (kPaged) {
    // The chunk's page ids, read beside the length (not after it): entries
    // past the length are read but never used.
    const int first = c0 / p.page_size;  // the host makes the chunk whole pages
    const int count = min(p.chunk / p.page_size, p.pages_per_seq - first);
    for (int i = tid; i < count; i += kThreads) sTable[i] = p.table[(long long)b * p.pages_per_seq + first + i];
  }
  const int n = min(max(p.lengths[b] + p.len_add, 1), capacity);
  if (c0 >= n) return;  // an empty split: nothing to read, nothing to merge
  const int limit = min(c0 + p.chunk, n);
  const int live = (n + p.chunk - 1) / p.chunk;
  const int ntiles = (limit - c0 + kTile - 1) / kTile;
  if constexpr (kPaged) __syncthreads();

  // Stream `stream` takes the chunk's tiles stream, stream + kStreams, ...
  // through a ring of each of its warps' own: no block-wide barrier until
  // the streams' states merge.
  const int mytiles = ntiles > stream ? (ntiles - stream + kStreams - 1) / kStreams : 0;
  unsigned char* ring = smem + warp * L::kRing;
  float* sScale = reinterpret_cast<float*>(smem + L::kScales) + warp * 2 * S * kTile;
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sP = reinterpret_cast<float*>(smem + L::kP) + warp * kTile * kMaxG;
  float* sAlpha = reinterpret_cast<float*>(smem + L::kVec) + warp * kMaxG;
  float* sM = reinterpret_cast<float*>(smem + L::kVec) + (kWarps + warp) * kMaxG;
  float* sL = reinterpret_cast<float*>(smem + L::kVec) + (2 * kWarps + warp) * kMaxG;

  const unsigned char* gk = static_cast<const unsigned char*>(p.k) + hk * p.k_sh * (long long)sizeof(KV);
  const unsigned char* gv = static_cast<const unsigned char*>(p.v) + hk * p.v_sh * (long long)sizeof(KV);
  const float* gks = kQuant ? p.ks + hk * p.s_sh : nullptr;
  const float* gvs = kQuant ? p.vs + hk * p.s_sh : nullptr;

  // A GQA group tile (4 or 8 q rows per KV row) with 16-bit q computes
  // S^T = K q^T on the tensor cores (below), reading K as mma A fragments:
  // 8 rows at a time, 4 elements of each.  K's 16-byte chunks are then
  // stored XOR-swizzled by row, so that those 8 rows fall in distinct
  // shared-memory banks (rows of 128 bytes or more, and int8/fp8 rows of
  // 64; narrower rows are left as they are).  One q row (GPT-2) keeps the
  // FMAs: the mma computes 8 rows for its one, and with it the 32-slot
  // long-context timing of chip_smoke.DECODE_SHAPES ran slower on the H100.
  constexpr bool kMma = !std::is_same<T, float>::value && kMaxG >= 4;
  auto swz = [](int r) -> int {
    if constexpr (!kMma) return 0;
    else if constexpr (sizeof(KV) == 2) return L::kRow >= 128 ? (2 * r) & 7 : 0;
    else if constexpr (L::kRow == 64) return (r >> 1) & 3;
    else if constexpr (L::kRow >= 128) return r & 7;
    else return 0;
  };

  // Stage the warp's slab of the stream's j-th tile, rows past the chunk's
  // live end zero-filled.  With pages of a multiple of kTile tokens (the
  // host's chunks are whole pages) a tile lies in one page, found once per
  // tile.
  const bool one_page = !kPaged || p.page_size % kTile == 0;
  auto issue = [&](int j, int stage) {
    const int t0 = c0 + (stream + j * kStreams) * kTile;
    unsigned char* dk = ring + stage * L::kStage;
    unsigned char* dv = ring + (S + stage) * L::kStage;
    int page0 = b, row0 = t0;
    if (kPaged && one_page) {
      page0 = sTable[(t0 - c0) / p.page_size];
      row0 = t0 % p.page_size;
    }
    auto locate = [&](int r, int& page, int& row) {
      page = page0;
      row = row0 + r;
      if (!one_page) {
        page = sTable[(t0 + r - c0) / p.page_size];
        row = (t0 + r) % p.page_size;
      }
    };
#pragma unroll
    for (int i = lane; i < kTile * kCopies; i += 32) {
      const int r = i / kCopies, c = i % kCopies;
      const int at = slab * L::kRow + c * 16;  // the copy's byte in the whole row
      const bool ok = t0 + r < limit;
      long long ko = 0, vo = 0;
      if (ok) {
        int page, row;
        locate(r, page, row);
        ko = (page * p.k_sp + row * p.k_sr) * (long long)sizeof(KV) + at;
        vo = (page * p.v_sp + row * p.v_sr) * (long long)sizeof(KV) + at;
      }
      const int in = c * 16;  // the copy's byte in the slab row
      cp_async<16>(dk + r * L::kRow + ((in / 16) ^ swz(r)) * 16, gk + ko, ok ? 16 : 0);
      cp_async<16>(dv + r * L::kRow + in, gv + vo, ok ? 16 : 0);
    }
    if constexpr (kQuant) {  // lanes 0-15 a K scale each, 16-31 a V scale
      const int r = lane % kTile;
      const bool ok = t0 + r < limit;
      long long so = 0;
      if (ok) {
        int page, row;
        locate(r, page, row);
        so = page * p.s_sp + row;
      }
      cp_async<4>(sScale + ((lane / kTile) * S + stage) * kTile + r, (lane < kTile ? gks : gvs) + so, ok ? 4 : 0);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < mytiles) issue(j, j);
    else cp_async_commit();  // empty groups keep the wait counts uniform
  }

  // kMma: S^T = K q^T on the tensor cores (mma.sync m16n8k16, fp32
  // accumulate; every product of 16-bit q and a K payload is exact in
  // fp32), 16 tokens by 8 q rows (the tile's, zero-padded) per tile, q's B
  // fragments of the warp's slab held in registers.  Otherwise fp32 FMAs
  // (below).
  const T* gq0 = static_cast<const T*>(p.q) + b * p.q_sb + ((long long)hk * p.group + gt * p.rows) * p.q_sh;
  const int col0 = slab * W::kCols;  // the slab's first column
  auto q_at = [&](int g, int col) -> float {
    return g < G ? round_to<T>(to_float(gq0[g * p.q_sh + col]) * p.q_scale) : 0.f;
  };
  uint32_t qb[W::kCols / 16][2];
  if constexpr (kMma) {
    // B fragment of k-step ks, lane (n = lane / 4, c = lane % 4): the mma's
    // k indices 2c, 2c + 1, 2c + 8, 2c + 9 are taken as the columns
    // 16 ks + 4c ... + 3 (the sum over the columns does not depend on their
    // order), so that the A fragment of K is 4 contiguous elements of a row.
    const int g = lane / 4, c = lane % 4;
#pragma unroll
    for (int ks = 0; ks < W::kCols / 16; ++ks) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = q_at(g, col0 + ks * 16 + 4 * c + e);
      qb[ks][0] = Pack<T>::two(x[0], x[1]);
      qb[ks][1] = Pack<T>::two(x[2], x[3]);
    }
  }
  // FMAs: this lane's 8 columns of the tile's q rows, scaled by q_scale
  // and rounded to T (K6's pre-scaling; K5 passes 1, which leaves q as it
  // is); rows past the tile are zero.
  const int qj = lane % kLanes;
  float q[kMaxG][8];
  if constexpr (!kMma) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) q[g][e] = q_at(g, col0 + qj * 8 + e);
  }

  const int pc = lane % kCols, psub = lane / kCols;  // P V: columns pc * 8 .. + 8, tokens psub + i * kSub
  const int half = lane / 16, ht = lane % 16;        // softmax: rows half + 2 i, token ht
  float acc[kMaxG][8];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  float m_run[kRows2], l_run[kRows2];
#pragma unroll
  for (int i = 0; i < kRows2; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
  }

  for (int j = 0; j < mytiles; ++j) {
    const int stage = j % S;
    cp_async_wait<S - 2>();
    __syncwarp();  // the tile has landed; the warp is done with tile j - 1's slot
    if (j + S - 1 < mytiles) issue(j + S - 1, (j + S - 1) % S);
    else cp_async_commit();
    const unsigned char* sK = ring + stage * L::kStage;
    const unsigned char* sV = ring + (S + stage) * L::kStage;
    const int buf = L::kSBufs > 1 ? j & 1 : 0;
    float* sSw = sS + (buf * kWarps + warp) * kMaxG * kTile;  // this warp's (partial) S

    if constexpr (kMma) {
      // S^T: rows (tokens) lane / 4 and + 8, columns (q rows) 2c and 2c + 1.
      const int r = lane / 4, c = lane % 4;
      float acc_s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < W::kCols / 16; ++ks) {
        uint32_t a[4];
        const int at = (ks * 16 + 4 * c) * (int)sizeof(KV);  // the 4 elements' byte in the slab row
        a_frag<T, KV>(sK + r * L::kRow + ((at / 16) ^ swz(r)) * 16 + at % 16, a[0], a[2]);
        a_frag<T, KV>(sK + (r + 8) * L::kRow + ((at / 16) ^ swz(r + 8)) * 16 + at % 16, a[1], a[3]);
        mma16<T>(acc_s, a, qb[ks]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (2 * c + h < kMaxG) {
          sSw[(2 * c + h) * kTile + r] = acc_s[h];
          sSw[(2 * c + h) * kTile + r + 8] = acc_s[2 + h];
        }
      }
    } else {
      // S = q K^T: kLanes lanes per token, partial sums reduce-scattered
      // (or, with fewer lanes than rows, summed in every lane).
#pragma unroll
      for (int pass = 0; pass < kTile / kTokPass; ++pass) {
        const int tok = pass * kTokPass + lane / kLanes;
        float kf[8];
        load8<KV>(reinterpret_cast<const KV*>(sK + tok * L::kRow) + qj * 8, kf);
        float s[kMaxG];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          s[g] = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s[g] = fmaf(q[g][e], kf[e], s[g]);
        }
        if constexpr (kLanes >= kMaxG) {
          const float r = reduce_scatter<kMaxG, kLanes>(s, qj);
          if (qj < kMaxG) sSw[rs_row<kMaxG>(qj) * kTile + tok] = r;
        } else {
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
            for (int off = 1; off < kLanes; off *= 2) s[g] += __shfl_xor_sync(kFull, s[g], off);
            if (g % kLanes == qj) sSw[g * kTile + tok] = s[g];
          }
        }
      }
    }
    if constexpr (kSlabs > 1) named_barrier(1 + stream, 32 * kSlabs);  // the set's partial S are in
    else __syncwarp();

    // One online-softmax step per q row and tile: a half-warp per row, a
    // lane per token.  With one row both halves compute it, the second
    // writing nothing.  S is the sum of the set's partials, in slab order.
    const bool valid = c0 + (stream + j * kStreams) * kTile + ht < limit;
    const float* sSet = sS + (buf * kWarps + stream * kSlabs) * kMaxG * kTile;
#pragma unroll
    for (int i = 0; i < kRows2; ++i) {
      const int g = min(half + 2 * i, kMaxG - 1);
      const bool mine = half + 2 * i < kMaxG;
      float s = sSet[g * kTile + ht];
#pragma unroll
      for (int sl = 1; sl < kSlabs; ++sl) s += sSet[(sl * kMaxG + g) * kTile + ht];
      s *= p.score_scale;
      if constexpr (kQuant) s *= sScale[stage * kTile + ht];
      s = valid ? s : -CUDART_INF_F;
      float mt = s;
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_new = fmaxf(m_run[i], mt);     // finite: the tile holds a live token
      const float alpha = expf(m_run[i] - m_new);  // 0 while m_run is -inf
      const float pe = valid ? expf(s - m_new) : 0.f;
      float ps = pe;
#pragma unroll
      for (int off = 8; off > 0; off /= 2) ps += __shfl_xor_sync(kFull, ps, off);
      l_run[i] = l_run[i] * alpha + ps;
      m_run[i] = m_new;
      float pv = pe;
      if constexpr (kQuant) pv *= sScale[(S + stage) * kTile + ht];
      if (mine) {
        sP[ht * kMaxG + g] = round_to<T>(pv);
        if (ht == 0) sAlpha[g] = alpha;
      }
    }
    __syncwarp();

    // acc = acc * alpha + P V over this lane's tokens and 8 columns.
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      const float a = sAlpha[g];
      if (a != 1.f) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= a;
      }
    }
#pragma unroll
    for (int i = 0; i < kTile / kSub; ++i) {
      const int tok = psub + i * kSub;
      float vf[8];
      load8<KV>(reinterpret_cast<const KV*>(sV + tok * L::kRow) + pc * 8, vf);
      float pr[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; g += 4) {
        if constexpr (kMaxG % 4 == 0) {
          const float4 x = *reinterpret_cast<const float4*>(sP + tok * kMaxG + g);
          pr[g] = x.x; pr[g + 1] = x.y; pr[g + 2] = x.z; pr[g + 3] = x.w;
        } else {
          pr[g] = sP[tok * kMaxG + g];
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr[g], vf[e], acc[g][e]);
    }
  }
  cp_async_wait<0>();

  // Sum the warp's token subsets by shuffles; then, once every warp is
  // done with its ring, merge the streams' states through shared memory.
#pragma unroll
  for (int off = kCols; off < 32; off *= 2)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], off);
  __syncthreads();
  constexpr int Dw = W::kCols;
  float* sRed = reinterpret_cast<float*>(smem);  // [kWarps][kMaxG][Dw], over the rings
  if (lane < kCols) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int e = 0; e < 8; e += 4)
        *reinterpret_cast<float4*>(sRed + (warp * kMaxG + g) * Dw + pc * 8 + e) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
  }
#pragma unroll
  for (int i = 0; i < kRows2; ++i) {
    if (ht == 0 && half + 2 * i < kMaxG) {
      sM[half + 2 * i] = m_run[i];
      sL[half + 2 * i] = l_run[i];
    }
  }
  __syncthreads();
  const float* sMs = reinterpret_cast<const float*>(smem + L::kVec) + kWarps * kMaxG;  // [warp][kMaxG]
  const float* sLs = sMs + kWarps * kMaxG;

  T* go = static_cast<T*>(p.o) + b * p.o_sb + ((long long)hk * p.group + gt * p.rows) * p.o_sh;
  const long long pair = (long long)b * gridDim.x + blockIdx.x;
  constexpr int d = D;
  float* part = live > 1 ? p.ws + (pair * p.splits + split) * p.rows * (d + 2) : nullptr;
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, col = i % d;
    const int sl = col / Dw, cc = col % Dw;  // the column's slab, and its column there
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int st = 0; st < kStreams; ++st) mx = fmaxf(mx, sMs[(st * kSlabs + sl) * kMaxG + g]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int st = 0; st < kStreams; ++st) {
      const int w = st * kSlabs + sl;
      const float m = sMs[w * kMaxG + g];
      if (m == -CUDART_INF_F) continue;  // a stream without tiles
      const float a = expf(m - mx);
      o += sRed[(w * kMaxG + g) * Dw + cc] * a;
      l += sLs[w * kMaxG + g] * a;
    }
    if (live == 1) {  // the sequence's only live split: write the output
      go[g * p.o_sh + col] = from_float<T>(o / (l == 0.f ? 1.f : l));
    } else {  // publish this split's state
      part[g * (d + 2) + 2 + col] = o;
      if (col == 0) {
        part[g * (d + 2)] = mx;
        part[g * (d + 2) + 1] = l;
      }
    }
  }
  if (live == 1) return;

  // The last split of the sequence to arrive merges.
  __threadfence();
  __syncthreads();
  if (tid == 0) sTable[0] = atomicAdd(p.counters + pair, 1) == live - 1;
  __syncthreads();
  if (!sTable[0]) return;

  // out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), merged online in
  // one pass over the splits whose loads do not wait on each other; the
  // other blocks' states are read through L2 (ld.cg), never a stale L1.
  const float* parts = p.ws + pair * p.splits * p.rows * (d + 2);
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, col = i % d;
    float mx = -CUDART_INF_F, l = 0.f, o = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s) {
      const float* st = parts + ((long long)s * p.rows + g) * (d + 2);
      const float m = __ldcg(st), ls = __ldcg(st + 1), os = __ldcg(st + 2 + col);
      const float m_new = fmaxf(mx, m);
      const float a = expf(mx - m_new), w = expf(m - m_new);  // live splits: m finite
      l = l * a + ls * w;
      o = o * a + os * w;
      mx = m_new;
    }
    go[g * p.o_sh + col] = from_float<T>(o / (l == 0.f ? 1.f : l));
  }
  if (tid == 0) p.counters[pair] = 0;  // ready for the next launch
}

template <typename T, typename KV, int D, int kMaxG, bool kPaged>
cudaError_t launch_one(const DecodeParams& p, dim3 grid, cudaStream_t s) {
  constexpr int bytes = Layout<KV, D, kMaxG>::kBytes;
  auto kernel = decode_kernel<T, KV, D, kMaxG, kPaged>;
  if (bytes > 48 * 1024) {  // once per device: above 48 KB only as opted-in dynamic shared memory
    static bool done[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64 || !done[dev]) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
      if (dev < 64) done[dev] = true;
    }
  }
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

// The q-row capacity (kMaxG) of a group tile of `rows` q rows: 1, 4 (at D64
// and D128 only) or 8.
template <typename T, typename KV, int D, bool kPaged>
cudaError_t launch_rows(const DecodeParams& p, dim3 grid, cudaStream_t s) {
  if (p.rows == 1) return launch_one<T, KV, D, 1, kPaged>(p, grid, s);
  if constexpr (D == 64 || D == 128) {
    if (p.rows <= 4) return launch_one<T, KV, D, 4, kPaged>(p, grid, s);
  }
  if (p.rows <= kMaxRows) return launch_one<T, KV, D, 8, kPaged>(p, grid, s);
  return cudaErrorInvalidValue;
}

// Every instantiation of one q dtype and padded head dim: the payload
// (kv_dtype 0 = q's dtype, 1 = int8, 2 = fp8 e4m3) and K5 / K6.  Each
// source file instantiates its own (q dtype, D) pairs; decode.cu declares
// them extern.
template <typename T, int D>
cudaError_t launch_width(const DecodeParams& p, int kv_dtype, bool paged, dim3 grid, cudaStream_t s) {
  if (kv_dtype == 0) {
    return paged ? launch_rows<T, T, D, true>(p, grid, s) : launch_rows<T, T, D, false>(p, grid, s);
  }
  if (kv_dtype == 1) {
    return paged ? launch_rows<T, int8_t, D, true>(p, grid, s) : launch_rows<T, int8_t, D, false>(p, grid, s);
  }
  if (kv_dtype == 2) {
    return paged ? launch_rows<T, __nv_fp8_e4m3, D, true>(p, grid, s)
                 : launch_rows<T, __nv_fp8_e4m3, D, false>(p, grid, s);
  }
  return cudaErrorInvalidValue;
}

#define FA_DECODE_WIDTHS(X)                                                                      \
  X(float, 64) X(float, 128) X(float, 256)                                                       \
  X(__nv_bfloat16, 64) X(__nv_bfloat16, 128) X(__nv_bfloat16, 256)                               \
  X(__half, 64) X(__half, 128) X(__half, 256)

}  // namespace decode
}  // namespace fa
