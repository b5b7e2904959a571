// One-token decode attention for a GQA group of more than 8 q heads
// (multi-query attention) with bf16 or fp16 q at head dims 8-32 (run at 32)
// and every multiple of 16 from 48 to 256 (run at 64, 128 or 256): K5
// (paged, fa_paged_decode_group) and K6 (slot-major,
// fa_fused_decode_group), two instantiations of one kernel template.  This
// header holds the template; decode.cu holds the C entry points, and the
// instantiations are split by q dtype, head dim and entry point over the 16
// sources decode_group_<bf16|fp16>_d<32|64|128|256>_<k5|k6>.cu.
//
// Replaces, for those configurations: flash_attention_tpu/inference/
// paged_attention.py::_paged_kernel (K5) and flash_attention_tpu/inference/
// decode_attention.py::_fused_kernel (K6).  Head dims above 256 run
// decode_wide.cuh, fp32 q decode_group_fp32.cuh (this kernel's plan in
// 3xTF32); groups of up to 8 decode.cuh's group tiles.  The function and
// its rounding points are decode.cuh's: S = q K^T in
// fp32 (K5: * sm_scale; K6: q pre-scaled by sm_scale and rounded to q's
// dtype), times the token's k_scale; natural exp and an online softmax in
// fp32; p * v_scale rounded to q's dtype before P V; an int8 / fp8 payload
// read exactly in q's dtype; one final division with the l == 0 guard.  Only
// the order of summation differs from the plain versions.
//
// What bounds it on this card: bytes, and at few (sequence, KV head) pairs
// latency.  A decode step reads each live token's K and V rows once;
// SantaCoder's layer (8 slots, 16 q heads on one KV head of 128, ~2000
// tokens) is 8.2 MB of bf16 cache, 2.4 us at 3.35 TB/s, and holds only 8
// pairs.  decode.cuh's group tiles read a group of 16 twice (a block per 8 q
// heads), cut each tile's sequence into 16-32 splits of 64-128 tokens and
// merge them serially in the last block to arrive.  A step here is a chain
// of latencies (the launch, q, a DRAM round trip, per stage ldmatrix -> mma
// -> shuffles -> exp -> mma and three barriers, then the cluster's merge)
// with an SM holding one or two blocks.  What the design does about it:
//   * the whole group in one block: ceil(group / 16) m16 row tiles of q heads
//     (up to 8, 2 at D256; a larger group runs in passes of at most 128 q
//     heads, 32 at D256, a cluster each), every K / V tile staged once into
//     shared memory with `cp.async` and read from there by every row tile;
//   * S = q K^T and O += P V on mma.sync m16n8k16 with fp32 accumulators.
//     q's rows are staged once through shared memory (one 16-byte load a
//     thread, all in flight at once), and its A fragments stay in registers.
//     K is read as S's B operand as it is stored (row-major by token)
//     through ldmatrix, V as P V's B operand through ldmatrix.trans;
//   * at D64 to D256 the 8 warps of a block split each row tile's stage two
//     ways, in one fixed order: for S by 16-token sub-tiles, for P V by output
//     columns (kRW row-tile groups of 8 / kRW warps, a column slice each).
//     The sub-tiles' row maxima meet in shared memory (a barrier), every
//     warp of the row tile takes the same stage maximum, writes its P in T
//     to the row tile's P tile with its row sums (a barrier), and multiplies
//     P by its V columns.  So all warps of a row tile share one softmax state
//     and the block needs no merge of its warps' states; S's k-steps run as
//     two accumulator chains, and so does P V where a slice has few n-tiles.
//     At D256 a stage of a 16-bit payload is 64 tokens (4 sub-tiles: with one
//     row tile, 4 of its 8 warps compute S);
//   * at D32 a column slice would be narrower than an n-tile, so the warps of
//     a row tile split the stage by tokens instead (decode_group_fp32.cuh's
//     plan): each is a token group taking every kCS-th 16-token sub-tile with
//     its own online softmax, P goes from S's accumulators straight to P V's
//     A fragments, and the token groups' states merge in the block at the
//     end, in group order.  One barrier a stage.  Rows of 64 bytes (a 16-bit
//     payload) or 32 (8-bit) are staged with 8-byte `cp.async` (an int8 row
//     at d = 8 is 8 bytes), the columns d..31 zero-filled in shared memory;
//     within a sub-tile's 8-token halves the tokens are taken in the order
//     0, 4, 1, 5, 2, 6, 3, 7, so that an 8-bit V's 4-byte reads of rows 2t
//     and 2t + 1 fall in distinct banks;
//   * a head dim d below the instantiated D (d 8-16 at D32, a multiple of 16
//     from 48 to 240 at D64 to D256: Phi-2's 80, GPT-NeoX-20B's 96): a row's
//     d columns are copied from the cache, the columns d..D-1 zero-filled in
//     the ring without a read (`src_bytes` 0) and zero in q, so that the
//     bytes read track d and S is exact; an 8-bit V is widened only for its d
//     columns, and only d output columns are written;
//   * an int8 / fp8 payload is read exactly in q's dtype: K straight from its
//     bytes into S's B fragments (4 consecutive columns a lane, q's columns
//     in the same order); at D64 to D256 V widened by each warp, for its
//     share of the stage's tokens and its column slice, into a 16-bit tile,
//     so that the ring's slot is free as soon as S is done; at D32 V's B
//     fragments from its bytes too (4 consecutive columns a lane, P V's
//     output columns in the same order);
//   * enough blocks: the blocks of one (sequence, KV head, pass) form one
//     thread-block cluster of `cluster` blocks, the most up to 8 whose
//     clusters the card holds all at once (`paged_attention.decode_cluster_split`
//     reads cudaOccupancyMaxActiveClusters through fa_decode_group_resident:
//     a cluster left for a second wave doubles the step).  The capacity is
//     cut into chunks of one stage (whole pages for K5), never by the
//     lengths; block c of a cluster walks chunks c, c + cluster, ... through
//     one ring of 2-4 stages (96 KB; at D256 one block an SM: 192 KB of a
//     16-bit payload, 128 KB of an 8-bit one), all in flight, with one online
//     state;
//   * a parallel merge in the cluster (decode_cluster.cuh's cluster_merge,
//     shared with the wide kernel): each block's state (m, l, acc) is in its
//     own shared memory; after a cluster barrier each block weighs the
//     group's rows once, then merges its slice of the rows x columns, 4
//     columns a thread, reading its peers' states over distributed shared
//     memory in rank order, and writes the output.  No
//     global workspace, no arrival counter, no serial last block: a block
//     with no live token publishes m = -inf, l = 0 and stays for both cluster
//     barriers (a block must not leave while a peer reads it).

// The kernel allocates nothing and launches on the caller's stream; the C
// entry points return the launch's cudaError_t.
#pragma once

#include "decode.cuh"
#include "decode_cluster.cuh"
#include "sm90.cuh"

namespace fa {
namespace decode {

constexpr int kGWarps = 8;                // warps of a block
constexpr int kGThreads = kGWarps * 32;
constexpr int kGMaxRows = kGWarps * 16;   // q heads of a pass: a row tile of 16 a warp
constexpr int kGMaxRowsD256 = 32;         // at D256: 2 row tiles (q's fragments and a slice's accumulators)

// Shared memory of a block, for kRW row-tile groups (below).  While
// streaming: the ring (K and V payload tiles of kTok tokens: as many rows as
// fill 32 KB of K, at most 128, `paged_attention.group_tokens`; kStages of
// them, as many as fit kBudget, 2 to 4), for an 8-bit payload its scales
// and, at D64 to D256, the 16-bit tile its V is widened into; then each row
// tile's P [16][kTok] in T and the sub-tiles' row maxima and sums (none at
// D32, whose P stays in registers).  While merging, over the ring: the
// block's state (acc [row][D], m, l), which the cluster's peers read, the
// cluster's weights and, at D32, each token group's own state [kTG][row][D]
// with its m and l (MergeLayout, decode_cluster.cuh).  After both, the block's page ids.  q's rows go over the
// P tiles where they fit, else over the ring before its first stage.  16-bit
// tiles store a row's 16-byte chunk c at c ^ swizzle(row), so that
// ldmatrix's 8 rows fall in distinct banks; 8-bit rows likewise.
template <typename KV, int D, int kRW>
struct GroupLayout {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr bool kTokSplit = D == 32;                       // P V split by tokens, not by columns
  static constexpr bool kWiden = kQuant && !kTokSplit;             // an 8-bit V widened into a 16-bit tile
  static constexpr int kRow = D * (int)sizeof(KV);                 // payload bytes of a token's row
  static constexpr int kTok = 128 * kRow > 32768 ? 32768 / kRow : 128;  // tokens of a stage of the ring
  static constexpr int kSub = kTok / 16;                           // 16-token sub-tiles of a stage
  static constexpr int kStage = kTok * kRow;                      // a stage's K (or V) tile
  static constexpr int kBudget = (D == 256 ? (kQuant ? 128 : 192) : 96) * 1024;
  static constexpr int kFit = kBudget / (2 * kStage);
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  static constexpr int kRing = 2 * kStages * kStage;
  static constexpr int kScales = kRing;                            // [stage][2][kTok] fp32
  static constexpr int kCvt = kScales + (kQuant ? kStages * 2 * kTok * 4 : 0);  // 16-bit V [kTok][D]
  static constexpr int kCvtScales = kCvt + (kWiden ? kTok * D * 2 : 0);         // [2][kTok] fp32
  static constexpr int kP = kCvtScales + (kWiden ? 2 * kTok * 4 : 0);           // [kRW][16][kTok] T
  static constexpr int kMax = kP + (kTokSplit ? 0 : kRW * 16 * kTok * 2);       // [kRW][kSub][16] fp32
  static constexpr int kSum = kMax + (kTokSplit ? 0 : kRW * kSub * 16 * 4);     // [kRW][kSub][16] fp32
  static constexpr int kTable = kSum + (kTokSplit ? 0 : kRW * kSub * 16 * 4);
  static constexpr int kStream = kTable + kClusterMaxPages * 4;
  static constexpr int kRows = kRW * 16;
  static constexpr bool kQOverP = !kTokSplit && D <= kTok;         // q's rows [kRows][D] T over the P tiles
  static constexpr int kQ = kQOverP ? kP : 0;                      // else over the ring
  static constexpr int kTG = kTokSplit ? kGWarps / kRW : 1;        // token groups of a row tile
  using Merge = MergeLayout<kRows, D, kTG>;                        // over the ring: the states (decode_cluster.cuh)
  static constexpr int kBytes = kStream > Merge::kEnd ? kStream : Merge::kEnd;
  static_assert(kTokSplit || Merge::kEnd <= kRing, "the merge's state fits over the ring");
  static_assert(kQOverP || kRows * D * 2 <= kRing, "q's rows fit over the ring");
  static_assert(kBytes <= 227 * 1024, "shared memory of a block");
};

// 4 payload bytes (elements e0..e3) as two pairs of T, exactly: int8 into
// fp16 through the half 1024 + (x + 128), built by a byte permute, minus
// 1152 (two elements an instruction); otherwise decode.cuh's a_frag.
template <typename T, typename KV>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (std::is_same<KV, int8_t>::value && std::is_same<T, __half>::value) {
    const uint32_t u = w ^ 0x80808080u;  // x + 128, a byte each
    const uint32_t biased[2] = {__byte_perm(u, 0x64646464u, 0x5140), __byte_perm(u, 0x64646464u, 0x7362)};
    const __half2 magic = __floats2half2_rn(1152.f, 1152.f);
    const __half2 x01 = __hsub2(*reinterpret_cast<const __half2*>(&biased[0]), magic);
    const __half2 x23 = __hsub2(*reinterpret_cast<const __half2*>(&biased[1]), magic);
    lo = *reinterpret_cast<const uint32_t*>(&x01);
    hi = *reinterpret_cast<const uint32_t*>(&x23);
  } else {
    cvt4<T, KV>(w, lo, hi);
  }
}
template <typename T, typename KV>
__device__ __forceinline__ void widen4(const unsigned char* s, uint32_t& lo, uint32_t& hi) {
  widen4<T, KV>(*reinterpret_cast<const uint32_t*>(s), lo, hi);
}

// The 16-byte chunk that chunk 0 of row r of a tile with kRow-byte rows is
// stored at, XOR'd with each chunk index: 8 consecutive rows' chunk c land in
// distinct banks for ldmatrix (rows of 64 bytes or more) and for the 4-byte
// reads of one chunk of 8 rows of 64 or 32 bytes.
template <int kRow>
__device__ __forceinline__ int swizzle(int r) {
  if constexpr (kRow >= 128) return r & 7;
  else if constexpr (kRow == 64) return (r >> 1) & 3;
  else return (r >> 2) & 1;
}

// The token of n index j of an 8-token half of a D32 sub-tile: 0, 4, 1, 5,
// 2, 6, 3, 7 (so that P V's k indices 2t and 2t + 1 are rows t and t + 4).
__device__ __forceinline__ int tok8(int j) { return (j & 1) * 4 + j / 2; }

template <typename T, typename KV, int D, int kRW, bool kPaged>
__global__ void __launch_bounds__(kGThreads) group_kernel(const GroupParams p) {
  using L = GroupLayout<KV, D, kRW>;
  constexpr bool kQuant = L::kQuant;
  constexpr bool kTokSplit = L::kTokSplit;
  constexpr int S = L::kStages;
  constexpr int kTok = L::kTok;                  // tokens of a stage
  constexpr int kSub = L::kSub;                  // its 16-token sub-tiles, a warp's unit of work
  constexpr int kCS = kGWarps / kRW;             // warps of a row tile: column slices, or (D32) token groups
  constexpr int kW = D / kCS;                    // columns of a slice
  constexpr int kU = (kSub + kCS - 1) / kCS;     // sub-tiles whose S a warp computes
  constexpr int kSliceNt = kTokSplit ? D / 8 : kW / 8;  // n-tiles of a warp's P V
  constexpr int kChains = !kTokSplit && kSliceNt < 4 ? 2 : 1;  // P V's accumulator chains: even and odd k-steps
  constexpr int kCopy = D == 32 ? 8 : 16;        // bytes of a payload row's cp.async
  constexpr int kChunks = L::kRow / kCopy;       // copies of a payload row
  constexpr int kRowStep = kGThreads / kChunks;  // rows between a thread's copies
  constexpr int kKs = D / 16;                    // k-steps of S
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "head dims 32 (d 8-32), 64, 128 and 256");
  static_assert(D != 256 || kRW <= 2, "at most 2 row tiles at D256");
  static_assert(sizeof(KV) == 1 || std::is_same<KV, T>::value, "a 16-bit payload is q's dtype");
  static_assert(kKs % 2 == 0 && kRowStep % 8 == 0 && kTok % kRowStep == 0 && (kTokSplit || kW >= 8), "tiling");

  extern __shared__ __align__(128) unsigned char smem[];
  const int C = (int)cluster_size();
  const int rank = (int)sm90::cluster_rank();
  const int hk = blockIdx.y / p.passes, pass = blockIdx.y % p.passes, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g0 = pass * p.pass_rows;
  const int G = min(p.pass_rows, p.group - g0);  // q rows of this block, at most 16 kRW (the host keeps to it)
  const int rt = warp / kCS, slice = warp % kCS;  // this warp's row tile and column slice (D32: token group)
  const bool rows_live = rt * 16 < G;
  const int d = p.head_dim;                      // the columns past d are zero in q, K and V
  const int len = p.lengths[b];

  // q's rows of the pass into shared memory (over the P tiles, which the
  // stages write later, or over the ring, before its first stage), one
  // 16-byte load a thread, scaled by q_scale and rounded to T (K6's
  // pre-scaling; K5 passes 1), rows past the group and columns past d zero;
  // read beside the length, before anything waits on it.  Then each warp's
  // A fragments of its row tile by ldmatrix (matrix i: rows 8 (i % 2) ..,
  // columns 16 ks + 8 (i / 2) ..), kept in registers for the whole chunk.
  const T* gq = static_cast<const T*>(p.q) + b * p.q_sb + ((long long)hk * p.group + g0) * p.q_sh;
  unsigned char* sQ = smem + L::kQ;
  for (int i = tid; i < kRW * 16 * (D / 8); i += kGThreads) {
    const int g = i / (D / 8), c = i % (D / 8);
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (g < G && c * 8 < d) {
      w = *reinterpret_cast<const uint4*>(gq + g * p.q_sh + c * 8);
      if (p.q_scale != 1.f) {
        uint32_t* h = &w.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* x = reinterpret_cast<const T*>(h + e);
          h[e] = Pack<T>::two(to_float(x[0]) * p.q_scale, to_float(x[1]) * p.q_scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(sQ + g * D * 2 + ((c ^ swizzle<D * 2>(g)) * 16)) = w;
  }
  __syncthreads();
  const int qr = lane / 4, qc = 2 * (lane % 4);
  const int mat = lane / 8, mrow = lane % 8;  // ldmatrix: lane l gives row l % 8 of matrix l / 8
  uint32_t qa[kKs][4];
  if constexpr (kQuant) {
    // An 8-bit K is read as S's B operand straight from its bytes, 4
    // consecutive columns a lane (below): the mma's k indices 2c, 2c + 1,
    // 2c + 8, 2c + 9 of k-step ks are taken as the columns 16 ks + 4c ... + 3
    // (a sum over the columns does not depend on their order), and q's A
    // fragments follow the same order.
    auto q_pair = [&](int row, int col) {
      return *reinterpret_cast<const uint32_t*>(sQ + row * D * 2 + (((col / 8) ^ swizzle<D * 2>(row)) * 16) +
                                                (col % 8) * 2);
    };
    const int c = lane % 4;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const int col = ks * 16 + 4 * c;
      qa[ks][0] = q_pair(rt * 16 + qr, col);
      qa[ks][1] = q_pair(rt * 16 + qr + 8, col);
      qa[ks][2] = q_pair(rt * 16 + qr, col + 2);
      qa[ks][3] = q_pair(rt * 16 + qr + 8, col + 2);
    }
  } else {
    const int row = rt * 16 + (mat % 2) * 8 + mrow;
    const uint32_t q_base = smem_u32(sQ) + row * D * 2;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) ldsm_x4<false>(qa[ks], q_base + (((2 * ks + mat / 2) ^ swizzle<D * 2>(row)) * 16));
  }

  const int capacity = kPaged ? p.page_size * p.pages_per_seq : p.page_size;
  const int ppc = kPaged ? p.chunk / p.page_size : 1;  // pages of a chunk
  int* sTable = reinterpret_cast<int*>(smem + L::kTable);
  if constexpr (kPaged) {
    // The page ids of the block's chunks, read beside the length (not after
    // it): entries past the length are read but never used.
    for (int i = tid; i < p.walks * ppc; i += kGThreads) {
      const int page = (rank + (i / ppc) * C) * ppc + i % ppc;
      sTable[i] = page < p.pages_per_seq ? p.table[(long long)b * p.pages_per_seq + page] : 0;
    }
  }
  const int n = min(max(len + p.len_add, 1), capacity);
  const int live_chunks = (n + p.chunk - 1) / p.chunk;
  const int mywalks = live_chunks > rank ? min((live_chunks - rank + C - 1) / C, p.walks) : 0;
  const int spc = (p.chunk + kTok - 1) / kTok;  // stages of a chunk
  int nstages = 0;
  if (mywalks > 0) {  // full chunks, then the last live one
    const int last = rank + (mywalks - 1) * C;
    nstages = (mywalks - 1) * spc + (min(p.chunk, n - last * p.chunk) + kTok - 1) / kTok;
  }
  // the page ids are in, and every warp is done with q's rows over the ring
  if constexpr (kPaged || !L::kQOverP) __syncthreads();

  // Stage j: chunk rank + (j / spc) * C, its tokens [t0, tend).
  auto stage_range = [&](int j, int& t0, int& tend, int& walk, int& c0) {
    walk = j / spc;
    c0 = (rank + walk * C) * p.chunk;
    t0 = c0 + (j % spc) * kTok;
    tend = min(min(t0 + kTok, c0 + p.chunk), n);
  };

  unsigned char* ring = smem;
  float* sScale = reinterpret_cast<float*>(smem + L::kScales);
  const unsigned char* gk = static_cast<const unsigned char*>(p.k) + hk * p.k_sh * (long long)sizeof(KV);
  const unsigned char* gv = static_cast<const unsigned char*>(p.v) + hk * p.v_sh * (long long)sizeof(KV);
  const float* gks = kQuant ? p.ks + hk * p.s_sh : nullptr;
  const float* gvs = kQuant ? p.vs + hk * p.s_sh : nullptr;
  // With pages of a multiple of kTok tokens (or no pages) a stage lies in
  // one page, found once a stage.
  const bool one_page = !kPaged || p.page_size % kTok == 0;
  // A thread copies the kCopy-byte piece cc of rows r0, r0 + kRowStep, ...:
  // (row & 7) is r0's, so the piece's swizzled place is fixed.  A piece past
  // the row's d columns is zero-filled without a read (d x the payload's
  // bytes is whole pieces).
  const int cc = tid % kChunks, r0 = tid / kChunks;
  const int at = cc * kCopy;  // the piece's byte in the row
  const bool col_ok = at < d * (int)sizeof(KV);
  const int dst0 = r0 * L::kRow + ((at / 16) ^ swizzle<L::kRow>(r0)) * 16 + at % 16;

  // Stage j into ring slot `slot`: rows past the stage's live end are
  // zero-filled without a read.
  auto issue = [&](int j, int slot) {
    int t0, tend, walk, c0;
    stage_range(j, t0, tend, walk, c0);
    unsigned char* dk = ring + slot * L::kStage + dst0;
    unsigned char* dv = ring + (S + slot) * L::kStage + dst0;
    if (one_page) {
      const int page = kPaged ? sTable[walk * ppc + (t0 - c0) / p.page_size] : b;
      const int row = (kPaged ? t0 % p.page_size : t0) + r0;
      const unsigned char* sk = gk + (page * p.k_sp + row * p.k_sr) * (long long)sizeof(KV) + at;
      const unsigned char* sv = gv + (page * p.v_sp + row * p.v_sr) * (long long)sizeof(KV) + at;
      const long long kstep = kRowStep * p.k_sr * (long long)sizeof(KV), vstep = kRowStep * p.v_sr * (long long)sizeof(KV);
#pragma unroll
      for (int i = 0; i < kTok / kRowStep; ++i) {
        const bool ok = col_ok && t0 + r0 + i * kRowStep < tend;
        cp_async<kCopy>(dk + i * kRowStep * L::kRow, ok ? sk + i * kstep : gk, ok ? kCopy : 0);
        cp_async<kCopy>(dv + i * kRowStep * L::kRow, ok ? sv + i * vstep : gv, ok ? kCopy : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTok / kRowStep; ++i) {
        const int t = t0 + r0 + i * kRowStep;
        const bool ok = col_ok && t < tend;
        long long ko = 0, vo = 0;
        if (ok) {
          const int page = sTable[walk * ppc + (t - c0) / p.page_size], row = t % p.page_size;
          ko = (page * p.k_sp + row * p.k_sr) * (long long)sizeof(KV) + at;
          vo = (page * p.v_sp + row * p.v_sr) * (long long)sizeof(KV) + at;
        }
        cp_async<kCopy>(dk + i * kRowStep * L::kRow, gk + ko, ok ? kCopy : 0);
        cp_async<kCopy>(dv + i * kRowStep * L::kRow, gv + vo, ok ? kCopy : 0);
      }
    }
    if constexpr (kQuant) {  // i: token i % kTok's K (i < kTok) or V scale
      for (int i = tid; i < 2 * kTok; i += kGThreads) {
        const int r = i % kTok, t = t0 + r;
        const bool ok = t < tend;
        long long so = 0;
        if (ok) {
          const int page = kPaged ? sTable[walk * ppc + (t - c0) / p.page_size] : b;
          so = page * p.s_sp + (kPaged ? t % p.page_size : t);
        }
        cp_async<4>(sScale + slot * 2 * kTok + i, (i < kTok ? gks : gvs) + so, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (j < nstages) issue(j, j);
    else cp_async_commit();  // empty groups keep the wait counts uniform
  }

  unsigned char* sP = smem + L::kP + rt * 16 * kTok * 2;           // this row tile's P
  float* sMax = reinterpret_cast<float*>(smem + L::kMax) + rt * kSub * 16;
  float* sSum = reinterpret_cast<float*>(smem + L::kSum) + rt * kSub * 16;
  float o[kChains][kSliceNt][4];  // P V's accumulators, the chains summed at the end
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int nt = 0; nt < kSliceNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][nt][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};  // rows qr, qr + 8

  for (int j = 0; j < nstages; ++j) {
    const int slot = j % S;
    if constexpr (L::kWiden) {
      cp_async_wait<S - 1>();
      __syncthreads();  // stage j has landed; every warp is done with stage j - 1
    } else {
      if (j == 0) cp_async_wait<S - 1>();
      else cp_async_wait<S - 2>();  // one group fewer: stage j - 1 + S is issued below
      __syncthreads();  // stage j has landed; every warp is done with stage j - 1 and its slot
      if (j > 0) {
        if (j - 1 + S < nstages) issue(j - 1 + S, (j - 1) % S);
        else cp_async_commit();
      }
    }
    const unsigned char* sK = ring + slot * L::kStage;
    const unsigned char* sV = ring + (S + slot) * L::kStage;
    const float* sKs = sScale + slot * 2 * kTok;
    int t0, tend, walk, c0;
    stage_range(j, t0, tend, walk, c0);
    const uint32_t k_base = smem_u32(sK);
    uint32_t v_base = smem_u32(sV);

    if constexpr (kTokSplit) {
      // D32: the warp's token group takes sub-tiles slice, slice + kCS, ...
      // of the stage with its own online softmax.  Within each 8-token half
      // n index i is token tok8(i) (S's columns, P's k indices and V's rows
      // alike).
      for (int u = slice; u < kSub; u += kCS) {
        const int tok0 = u * 16;
        if (!rows_live || t0 + tok0 >= tend) break;
        // S of the sub-tile: s[nt][e] is row qr + 8 (e / 2), token tok0 + 8
        // nt + tok8(qc + e % 2); the two k-steps in two chains.
        float s[2][4], s2[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = s2[nt][e] = 0.f;
        const int krow = tok0 + (mat / 2) * 8 + tok8(mrow);
#pragma unroll
        for (int ks = 0; ks < kKs; ++ks) {
          uint32_t b0[2], b1[2];
          if constexpr (kQuant) {  // lane: token tok0 + 8 nt + tok8(lane / 4), columns 16 ks + 4 (lane % 4) ... + 3
            const int r = tok0 + tok8(qr), c4 = 4 * (lane % 4);
            widen4<T, KV>(sK + r * L::kRow + ((ks ^ swizzle<L::kRow>(r)) * 16) + c4, b0[0], b0[1]);
            widen4<T, KV>(sK + (r + 8) * L::kRow + ((ks ^ swizzle<L::kRow>(r + 8)) * 16) + c4, b1[0], b1[1]);
          } else {
            uint32_t kb[4];
            ldsm_x4<false>(kb, k_base + krow * L::kRow + (((2 * ks + mat % 2) ^ swizzle<L::kRow>(krow)) * 16));
            b0[0] = kb[0];
            b0[1] = kb[1];
            b1[0] = kb[2];
            b1[1] = kb[3];
          }
          mma16<T>(ks % 2 ? s2[0] : s[0], qa[ks], b0);
          mma16<T>(ks % 2 ? s2[1] : s[1], qa[ks], b1);
        }
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tok = tok0 + 8 * nt + tok8(qc + e % 2);
            float x = (s[nt][e] + s2[nt][e]) * p.score_scale;
            if constexpr (kQuant) x *= sKs[tok];
            s[nt][e] = t0 + tok < tend ? x : -CUDART_INF_F;
            mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
          }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
          const float m_new = fmaxf(m_run[h], mx[h]);  // finite: token t0 + tok0 is live
          alpha[h] = expf(m_run[h] - m_new);          // 0 while m_run is -inf
          m_run[h] = m_new;
          l_run[h] *= alpha[h];
        }
        // P = e^(s - m) * v_scale in T as P V's A fragment (k indices 2t, 2t +
        // 1 of half nt are S's n indices 2t, 2t + 1 of n-tile nt); the lane's
        // share of the row sums of e^(s - m), summed over the quad at the end.
        uint32_t pa[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float pv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int tok = tok0 + 8 * nt + tok8(qc + e);
              const float pe = t0 + tok < tend ? expf(s[nt][2 * h + e] - m_run[h]) : 0.f;
              l_run[h] += pe;
              pv[e] = kQuant ? pe * sKs[kTok + tok] : pe;
            }
            pa[2 * nt + h] = Pack<T>::two(pv[0], pv[1]);
          }
#pragma unroll
        for (int nt = 0; nt < kSliceNt; ++nt) {
          o[0][nt][0] *= alpha[0];
          o[0][nt][1] *= alpha[0];
          o[0][nt][2] *= alpha[1];
          o[0][nt][3] *= alpha[1];
        }
        if constexpr (kQuant) {
          // V's B fragments from its bytes: lane (g, t) reads columns 4g ...
          // 4g + 3 of rows tok0 + t, + 4, + 8 and + 12 (k indices 2t, 2t + 1,
          // 2t + 8, 2t + 9), which serve n-tiles 0-3 at n index g: n-tile e
          // holds column 4 i + e at n index i.
          const int vt = lane % 4, vg = lane / 4;
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = tok0 + vt + 4 * i;
            w[i] = *reinterpret_cast<const uint32_t*>(sV + r * L::kRow + (((vg / 4) ^ swizzle<L::kRow>(r)) * 16) +
                                                      4 * (vg % 4));
          }
          uint32_t vb0[4], vb1[4];  // n-tile e: (k 2t, 2t + 1) and (k 2t + 8, 2t + 9)
          widen4<T, KV>(__byte_perm(w[0], w[1], 0x5140), vb0[0], vb0[1]);
          widen4<T, KV>(__byte_perm(w[0], w[1], 0x7362), vb0[2], vb0[3]);
          widen4<T, KV>(__byte_perm(w[2], w[3], 0x5140), vb1[0], vb1[1]);
          widen4<T, KV>(__byte_perm(w[2], w[3], 0x7362), vb1[2], vb1[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t bv[2] = {vb0[e], vb1[e]};
            mma16<T>(o[0][e], pa, bv);
          }
        } else {
          // V's B fragments by ldmatrix.trans: matrix (nt, half) = rows tok0 +
          // 8 half + tok8(..), the 16-byte chunk (8 columns) of n-tile nt.
          const int vrow = tok0 + (mat % 2) * 8 + tok8(mrow);
#pragma unroll
          for (int nt = 0; nt < kSliceNt; nt += 2) {
            uint32_t vb[4];
            ldsm_x4<true>(vb, v_base + vrow * L::kRow + (((nt + mat / 2) ^ swizzle<L::kRow>(vrow)) * 16));
            const uint32_t bv0[2] = {vb[0], vb[1]}, bv1[2] = {vb[2], vb[3]};
            mma16<T>(o[0][nt], pa, bv0);
            mma16<T>(o[0][nt + 1], pa, bv1);
          }
        }
      }
    } else {
      unsigned char* cvt = smem + L::kCvt;
      float* cvt_scales = reinterpret_cast<float*>(smem + L::kCvtScales);
      if constexpr (L::kWiden) {
        // An 8-bit V into a 16-bit tile (exact), each warp the rows of its
        // share of the stage's tokens and the columns of its slice, which only
        // the warps of that slice read (after the barriers below); the scales
        // beside it, so that the ring's slot is free once S is done.  Only
        // the d columns: the columns past d feed only output columns that are
        // never written.  A lane's pieces are all at one column of their rows
        // (32 is a multiple of a row's pieces), so that is tested once.
        constexpr int kPieces = kW / 4;  // 4-byte pieces of a slice's row
        static_assert(32 % kPieces == 0, "a lane's pieces are one column of their rows");
        const int first = rt * (kTok / kRW);
        if (slice * kW + (lane % kPieces) * 4 < d) {
#pragma unroll 4
          for (int i = lane; i < (kTok / kRW) * kPieces; i += 32) {
            const int r = first + i / kPieces, col = slice * kW + (i % kPieces) * 4;
            uint2 w;
            widen4<T, KV>(sV + r * L::kRow + (((col / 16) ^ swizzle<L::kRow>(r)) * 16) + col % 16, w.x, w.y);
            *reinterpret_cast<uint2*>(cvt + r * D * 2 + (((col / 8) ^ (r & 7)) * 16) + (col % 8) * 2) = w;
          }
        }
        for (int i = tid; i < 2 * kTok; i += kGThreads) cvt_scales[i] = sKs[i];
        v_base = smem_u32(cvt);
      }

      // S for the warp's sub-tiles slice, slice + kCS, ... of its row tile: 16
      // q rows x 16 tokens each, the k-steps in two chains (even, odd).  K's B
      // fragments by ldmatrix: matrix (nt, half) = tokens tok0 + 8 nt .. + 7,
      // the 16-byte chunk 2 ks + half (an 8-bit K: from its bytes, above).  Each sub-tile's row maxima go to
      // shared memory (-inf for a sub-tile past the stage's live end).  With
      // fewer sub-tiles than warps (D256, one row tile) the last warps have none.
      float s[kU][2][4];
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        const int tok0 = (slice + i * kCS) * 16;
        const bool mine = kSub % kCS == 0 || slice + i * kCS < kSub;
        const bool live = mine && rows_live && t0 + tok0 < tend;
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
        if (live) {
          float s2[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][nt][e] = s2[nt][e] = 0.f;
          const int krow = tok0 + (mat / 2) * 8 + mrow;
#pragma unroll
          for (int ks = 0; ks < kKs; ++ks) {
            uint32_t b0[2], b1[2];
            if constexpr (kQuant) {  // lane: token tok0 + 8 nt + lane / 4, columns 16 ks + 4 (lane % 4) ... + 3
              const int r = tok0 + qr, c4 = 4 * (lane % 4);
              widen4<T, KV>(sK + r * L::kRow + ((ks ^ swizzle<L::kRow>(r)) * 16) + c4, b0[0], b0[1]);
              widen4<T, KV>(sK + (r + 8) * L::kRow + ((ks ^ swizzle<L::kRow>(r + 8)) * 16) + c4, b1[0], b1[1]);
            } else {
              uint32_t kb[4];
              ldsm_x4<false>(kb, k_base + krow * (D * 2) + (((2 * ks + mat % 2) ^ (krow & 7)) * 16));
              b0[0] = kb[0];
              b0[1] = kb[1];
              b1[0] = kb[2];
              b1[1] = kb[3];
            }
            mma16<T>(ks % 2 ? s2[0] : s[i][0], qa[ks], b0);
            mma16<T>(ks % 2 ? s2[1] : s[i][1], qa[ks], b1);
          }
          // s[i][nt][e]: row qr + 8 (e / 2), token tok0 + 8 nt + qc + e % 2
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int tok = tok0 + 8 * nt + qc + e % 2;
              float x = (s[i][nt][e] + s2[nt][e]) * p.score_scale;
              if constexpr (kQuant) x *= sKs[tok];
              s[i][nt][e] = t0 + tok < tend ? x : -CUDART_INF_F;
              mx[e / 2] = fmaxf(mx[e / 2], s[i][nt][e]);
            }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
          }
        }
        if (mine && rows_live && lane % 4 == 0) {
          sMax[(slice + i * kCS) * 16 + qr] = mx[0];
          sMax[(slice + i * kCS) * 16 + qr + 8] = mx[1];
        }
      }
      __syncthreads();  // every sub-tile's row maxima are in (and an 8-bit stage's slot is read)
      if constexpr (L::kWiden) {
        if (j + S < nstages) issue(j + S, slot);
        else cp_async_commit();
      }

      // The stage's row maxima, in sub-tile order (every warp of a row tile
      // the same); P = e^(s - m) * v_scale in T into the row tile's P, and
      // each sub-tile's row sums of e^(s - m).
      float m_new[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = m_run[h];
#pragma unroll
        for (int u = 0; u < kSub; ++u) m_new[h] = fmaxf(m_new[h], sMax[u * 16 + qr + 8 * h]);
        alpha[h] = expf(m_run[h] - m_new[h]);  // 0 while m_run is -inf; m_new is finite (token t0 is live)
      }
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        const int tok0 = (slice + i * kCS) * 16;
        const bool mine = kSub % kCS == 0 || slice + i * kCS < kSub;
        const bool live = mine && rows_live && t0 + tok0 < tend;
        float ls[2] = {0.f, 0.f};
        if (live) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float pv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int tok = tok0 + 8 * nt + qc + e;
                const float pe = t0 + tok < tend ? expf(s[i][nt][2 * h + e] - m_new[h]) : 0.f;
                ls[h] += pe;
                pv[e] = pe;
                if constexpr (kQuant) pv[e] *= cvt_scales[kTok + tok];
              }
              const int row = qr + 8 * h, tok = tok0 + 8 * nt + qc;
              *reinterpret_cast<uint32_t*>(sP + row * kTok * 2 + (((tok / 8) ^ (row & 7)) * 16) + (tok % 8) * 2) =
                  Pack<T>::two(pv[0], pv[1]);
            }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ls[h] += __shfl_xor_sync(kFull, ls[h], 1);
            ls[h] += __shfl_xor_sync(kFull, ls[h], 2);
          }
        }
        if (mine && rows_live && lane % 4 == 0) {
          sSum[(slice + i * kCS) * 16 + qr] = ls[0];
          sSum[(slice + i * kCS) * 16 + qr + 8] = ls[1];
        }
      }
      __syncthreads();  // P and the row sums are in

      // l = l alpha + the sub-tiles' sums in order; O = O alpha + P V over the
      // stage's live 16-token k-steps for the warp's column slice.  P's A
      // fragments by ldmatrix (matrix i: rows 8 (i % 2) .., tokens 8 (i / 2)
      // ..); V's B fragments by ldmatrix.trans: matrix (nt, half) = tokens 16
      // ks + 8 half .. + 7, the 16-byte chunk (8 columns) of n-tile nt.
      if (rows_live) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float l = l_run[h] * alpha[h];
#pragma unroll
          for (int u = 0; u < kSub; ++u) l += sSum[u * 16 + qr + 8 * h];
          l_run[h] = l;
          m_run[h] = m_new[h];
        }
#pragma unroll
        for (int c = 0; c < kChains; ++c)
#pragma unroll
          for (int nt = 0; nt < kSliceNt; ++nt) {
            o[c][nt][0] *= alpha[0];
            o[c][nt][1] *= alpha[0];
            o[c][nt][2] *= alpha[1];
            o[c][nt][3] *= alpha[1];
          }
        const uint32_t p_base = smem_u32(sP);
        const int nks = (tend - t0 + 15) / 16;
        const int prow = (mat % 2) * 8 + mrow;
#pragma unroll
        for (int ks = 0; ks < kSub; ++ks) {
          if (ks < nks) {
            uint32_t pa[4];
            ldsm_x4<false>(pa, p_base + prow * (kTok * 2) + (((2 * ks + mat / 2) ^ (prow & 7)) * 16));
            const int vrow = ks * 16 + (mat % 2) * 8 + mrow;
#pragma unroll
            for (int nt = 0; nt < kSliceNt; nt += 2) {
              const int chunk = slice * kSliceNt + nt + (kSliceNt > 1 ? mat / 2 : 0);
              uint32_t vb[4];
              ldsm_x4<true>(vb, v_base + vrow * (D * 2) + ((chunk ^ (vrow & 7)) * 16));
              const uint32_t b0[2] = {vb[0], vb[1]};
              mma16<T>(o[ks % kChains][nt], pa, b0);
              if (nt + 1 < kSliceNt) {
                const uint32_t b1[2] = {vb[2], vb[3]};
                mma16<T>(o[ks % kChains][nt + 1], pa, b1);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: the block's state goes over them

  float* state = reinterpret_cast<float*>(smem);
  float* state_m = reinterpret_cast<float*>(smem + L::Merge::kStateM);
  float* state_l = reinterpret_cast<float*>(smem + L::Merge::kStateL);
  if constexpr (kTokSplit) {
    // Each token group's state (the block's, when a row tile has one group):
    // acc [row][D] (n-tile nt's n index i is column 8 nt + i, or for an 8-bit
    // V column 4 i + nt), with m and l [row] from the quad's first lane; then
    // the groups merged into the block's state.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(kFull, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(kFull, l_run[h], 2);
    }
    float* gacc = L::Merge::group_acc(smem, slice);
    float* gm = L::Merge::group_m(smem, slice);
    float* gl = L::Merge::group_l(smem, slice);
    if (rows_live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rt * 16 + qr + 8 * h;
#pragma unroll
        for (int nt = 0; nt < kSliceNt; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = kQuant ? 4 * (qc + e) + nt : 8 * nt + qc + e;
            gacc[row * D + col] = o[0][nt][2 * h + e];
          }
        if (lane % 4 == 0) {
          gm[row] = m_run[h];
          gl[row] = l_run[h];
        }
      }
    }
    L::Merge::template merge_groups<kGThreads>(smem, G, tid);
  } else if (rows_live) {
    // The block's state: each warp its row tile's slice of acc; the first
    // slice's warp the rows' m and l.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rt * 16 + qr + 8 * h;
#pragma unroll
      for (int nt = 0; nt < kSliceNt; ++nt) {
        float2 x = make_float2(o[0][nt][2 * h], o[0][nt][2 * h + 1]);
        if constexpr (kChains > 1) {
          x.x += o[1][nt][2 * h];
          x.y += o[1][nt][2 * h + 1];
        }
        *reinterpret_cast<float2*>(state + row * D + slice * kW + nt * 8 + qc) = x;
      }
      if (slice == 0 && lane % 4 == 0) {
        state_m[row] = m_run[h];
        state_l[row] = l_run[h];
      }
    }
  }

  // Every block's state is in: merge them over the cluster and write the
  // output's d columns.
  cluster_merge<T, kGThreads, D>(state, state_m, state_l, reinterpret_cast<float*>(smem + L::Merge::kWeights),
                                 reinterpret_cast<float*>(smem + L::Merge::kSums), G, d, C, rank, tid,
                                 static_cast<T*>(p.o) + b * p.o_sb + ((long long)hk * p.group + g0) * p.o_sh,
                                 p.o_sh);
}

template <typename T, typename KV, int D, int kRW, bool kPaged>
cudaError_t group_launch_one(const GroupParams& p, int cluster, dim3 grid, cudaStream_t s, int* resident) {
  return cluster_launch<GroupParams, group_kernel<T, KV, D, kRW, kPaged>, kGThreads, GroupLayout<KV, D, kRW>::kBytes>(
      p, cluster, grid, s, resident);
}

// The row-tile groups (kRW) of a pass of `rows` q heads: its m16 row tiles
// rounded up to a power of two, each taking 8 / kRW warps; at D256 at most 2
// (the host's passes hold at most 32 q heads there: with 4, a warp's q
// fragments for 256 columns and its 128-column slice's accumulators spill).
template <typename T, typename KV, int D, bool kPaged>
cudaError_t group_launch_rows(const GroupParams& p, int cluster, dim3 grid, cudaStream_t s, int* resident) {
  const int tiles = p.pass_rows / 16;
  if (tiles <= 1) return group_launch_one<T, KV, D, 1, kPaged>(p, cluster, grid, s, resident);
  if (tiles <= 2) return group_launch_one<T, KV, D, 2, kPaged>(p, cluster, grid, s, resident);
  if constexpr (D != 256) {
    if (tiles <= 4) return group_launch_one<T, KV, D, 4, kPaged>(p, cluster, grid, s, resident);
    return group_launch_one<T, KV, D, 8, kPaged>(p, cluster, grid, s, resident);
  } else {
    return cudaErrorInvalidValue;
  }
}

// The payload (kv_dtype 0 = q's dtype, 1 = int8, 2 = fp8 e4m3) and K5 / K6
// of one q dtype and head dim.  The sources decode_group_<q dtype>_d<D>_<k5|k6>.cu
// instantiate group_launch_rows for their (q dtype, head dim, K5 or K6), every
// payload and row-tile group, so that no one nvcc holds the build up;
// decode.cu declares them extern.
template <typename T, int D>
cudaError_t group_launch_width(const GroupParams& p, int kv_dtype, bool paged, int cluster, dim3 grid,
                               cudaStream_t s, int* resident) {
  if (kv_dtype == 0) {
    return paged ? group_launch_rows<T, T, D, true>(p, cluster, grid, s, resident)
                 : group_launch_rows<T, T, D, false>(p, cluster, grid, s, resident);
  }
  if (kv_dtype == 1) {
    return paged ? group_launch_rows<T, int8_t, D, true>(p, cluster, grid, s, resident)
                 : group_launch_rows<T, int8_t, D, false>(p, cluster, grid, s, resident);
  }
  if (kv_dtype == 2) {
    return paged ? group_launch_rows<T, __nv_fp8_e4m3, D, true>(p, cluster, grid, s, resident)
                 : group_launch_rows<T, __nv_fp8_e4m3, D, false>(p, cluster, grid, s, resident);
  }
  return cudaErrorInvalidValue;
}

#define FA_GROUP_ROWS(X, T, D, P) X(T, T, D, P) X(T, int8_t, D, P) X(T, __nv_fp8_e4m3, D, P)
#define FA_GROUP_DTYPE(X, T)                                                                           \
  FA_GROUP_ROWS(X, T, 32, true) FA_GROUP_ROWS(X, T, 32, false) FA_GROUP_ROWS(X, T, 64, true)           \
  FA_GROUP_ROWS(X, T, 64, false) FA_GROUP_ROWS(X, T, 128, true) FA_GROUP_ROWS(X, T, 128, false)         \
  FA_GROUP_ROWS(X, T, 256, true) FA_GROUP_ROWS(X, T, 256, false)
#define FA_GROUP_ALL(X) FA_GROUP_DTYPE(X, __nv_bfloat16) FA_GROUP_DTYPE(X, __half)

}  // namespace decode
}  // namespace fa
