// One-token decode attention for a GQA group of more than 8 q heads
// (multi-query attention) with fp32 q at head dims 8-32 (run at 32), 64, 128
// and 256: K5 (paged, fa_paged_decode_group) and K6 (slot-major,
// fa_fused_decode_group) over an fp32, int8 or fp8 e4m3 cache, two
// instantiations of one kernel template.  This header holds the template;
// decode.cu's entry points reach it for q dtype 0, and the instantiations are
// split by head dim and entry point over the 8 sources
// decode_group_fp32_d<32|64|128|256>_<k5|k6>.cu.  bf16 / fp16 q run
// decode_group.cuh, whose plan (a cluster per (sequence, KV head, pass),
// merged over distributed shared memory; GroupParams; decode_cluster.cuh's
// merge and launch) this kernel shares.
//
// Replaces, for those configurations: flash_attention_tpu/inference/
// paged_attention.py::_paged_kernel (K5) and flash_attention_tpu/inference/
// decode_attention.py::_fused_kernel (K6).  The function and its rounding
// points are decode.cuh's at fp32: S = q K^T (K5: * sm_scale; K6: q
// multiplied by sm_scale first, in fp32, nothing rounded), times the
// token's k_scale; natural exp and an online softmax in fp32; p * v_scale in
// fp32 before P V; one final division with the l == 0 guard.  Only the
// order of summation differs from the plain versions.
//
// The products run on the tensor cores, mma.sync m16n8k8 tf32, in
// 3xTF32 (tf32x3.cuh): q is split into hi + lo once, an fp32 K / V value as
// it is read, P as it leaves S's accumulators, and each product is lo hi +
// hi lo + hi hi in fp32 (no product in one TF32 pass: that keeps three
// decimal digits, far from the fp32 tier).  An int8 or fp8 payload is exact
// in TF32 (|x| <= 127; e4m3 has 3 mantissa bits), so its products take two
// passes, q_lo k + q_hi k and P_lo v + P_hi v.
//
// What bounds it on this card: bytes (an fp32 cache is twice bf16's), and
// at few (sequence, KV head) pairs latency.  decode.cuh's group tiles, which
// ran these configurations before, read a group of 16 twice (a block per 8
// q heads), cut each tile's sequence into 16-32 splits and merged them
// serially in the last block to arrive, with S on FMAs.  What the design
// does about it:
//   * the whole group in one block, m16 row tiles of q heads (kRW of them: 1,
//     2, 4 or 8 at D32 / D64, up to 4 at D128, up to 2 at D256; a larger
//     group runs in passes, 128 q heads at D32 / D64, 64 at D128, 32 at
//     D256), every K / V stage staged once into shared memory with
//     `cp.async` and read from there by every row tile; a cluster of blocks
//     per (sequence, KV head, pass), its blocks walking interleaved chunks
//     and merged over distributed shared memory (cluster_merge), with no
//     workspace, counter or serial last block, as decode_group.cuh;
//   * the 8 warps of a block: kRW row tiles, 8 / kRW warps each.  A warp
//     holds q's hi / lo A fragments for 64 head-dim columns in registers (64
//     registers; at D32 all 32 columns, 32 registers); at D128 (D256) the two
//     (four) warps of a split group share a token's columns, compute their
//     partial S, exchange it through shared memory (a named barrier of the
//     group) and sum it in one fixed order (columns 0-63 first), so that all
//     hold the same S.  The split groups (at D32 / D64 the warps) of a row
//     tile are its token groups: each takes every kTG-th 16-token sub-tile
//     of a stage and keeps its own online-softmax state, so a stage needs
//     one block-wide barrier (its slot is landed and the last one free),
//     none for the softmax;
//   * P goes from S's accumulators straight to P V's A fragments
//     (tf32x3.cuh's frag_acc: the depth taken in the order 0, 2, 4, 6, 1, 3,
//     5, 7), and each warp multiplies it by V for its columns; the token
//     groups' states merge in the block at the end, in group order;
//   * lane-contiguous reads: the head dim of S is taken in a permuted order,
//     the same for q's A fragments and K's B fragments, so that a lane reads 4
//     consecutive columns of a K row (16 bytes of fp32, 4 of an 8-bit
//     payload) for two k-steps; P V's output columns are permuted likewise,
//     so that a lane reads 4 consecutive columns of a V row for 4 n-tiles.  A
//     row's 16-byte chunk c is stored at c ^ f(row) (group32_swizzle), which
//     keeps those reads free of bank conflicts (but for an 8-bit V at D64,
//     two ways).  8-bit rows at D32 are 32 bytes, four to a 128-byte line:
//     there each 8-token half of a sub-tile is taken in the order 0, 4, 1, 5,
//     2, 6, 3, 7 (decode_group.cuh's tok8), so that V's reads of the two
//     tokens of a depth pair, rows t and t + 4, fall in distinct banks;
//   * at D32 (d 8, 16, 32) the columns past d are zero in q and, filled
//     without a read, in the ring (a zero q column would not mask a NaN left
//     there): rows are copied 16 bytes at a time (an fp32 row at d = 8 is 32
//     bytes), an 8-bit row 8 bytes at a time (8 bytes at d = 8);
//   * a stage is as many tokens as fill 32 KB of K (128; 64 for an fp32
//     cache at D128, 32 at D256; `paged_attention.group_tokens`), in a ring
//     of 2-4 stages of 96 KB at most (fp32 at D128: 2 of 64 KB); at D256 of
//     3 stages, 192 KB, one block an SM with two stages in flight while it
//     computes on the third.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry points return the launch's cudaError_t.
#pragma once

#include "decode_group.cuh"
#include "tf32x3.cuh"

namespace fa {
namespace decode {

constexpr int kFCols = 64;  // head-dim columns a warp takes at most: all of D64, half of D128, a quarter of D256

// Shared memory of a block, for kRW row tiles.  While streaming: the ring
// (K and V payload tiles of kTok tokens, kStages of them), an 8-bit
// payload's scales, at D128 / D256 each warp's two partial-S buffers for its
// split group, and K5's page ids.  At the end, over all of it: the block's
// state (acc [row][D], m, l), which the cluster's peers read, the cluster's
// weights, and each token group's own state [kTG][row][D] with its m and l
// (MergeLayout, decode_cluster.cuh).
template <typename KV, int D, int kRW>
struct GroupLayout32 {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kCols = D < kFCols ? D : kFCols;          // head-dim columns a warp takes
  static constexpr int kSplit = D / kCols;                       // warps sharing a token's columns
  static constexpr int kCS = kGWarps / kRW;                      // warps of a row tile
  static constexpr int kTG = kCS / kSplit;                       // token groups of a row tile
  static constexpr int kRow = D * (int)sizeof(KV);               // payload bytes of a token's row
  static constexpr int kTok = 128 * kRow > 32768 ? 32768 / kRow : 128;  // tokens of a stage
  static constexpr int kSub = kTok / 16;                         // its 16-token sub-tiles
  static constexpr int kStage = kTok * kRow;
  static constexpr int kFit = (D == 256 ? 192 : 96) * 1024 / (2 * kStage);
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  static constexpr int kRing = 2 * kStages * kStage;
  static constexpr int kScales = kRing;                          // [stage][2][kTok] fp32
  static constexpr int kExch = kScales + (kQuant ? kStages * 2 * kTok * 4 : 0);  // [warp][2][lane][8] fp32
  static constexpr int kTable = kExch + (kSplit > 1 ? kGWarps * 2 * 32 * 8 * 4 : 0);
  static constexpr int kStream = kTable + kClusterMaxPages * 4;
  static constexpr int kRows = kRW * 16;
  using Merge = MergeLayout<kRows, D, kTG>;                      // over all of it at the end (decode_cluster.cuh)
  static constexpr int kBytes = kStream > Merge::kEnd ? kStream : Merge::kEnd;
  static_assert(kTG >= 1 && kCS % kSplit == 0, "a row tile holds whole split groups");
  static_assert(kBytes <= 227 * 1024, "shared memory of a block");
};

// The 16-byte chunk that chunk 0 of row r of a tile with kRow-byte rows is
// stored at, XOR'd with each chunk index.  Rows of 128 bytes or more: f(r) =
// (r & 7) ^ 4 (r & 1), a bijection of 0-7 under which rows r and r + 1 (r
// even) fall in different halves of a 128-byte line and rows 0, 2, 4, 6 (or
// 1, 3, 5, 7) in four distinct quarters: so K's 16-byte reads (rows g, a
// quarter-warp two rows), its 4-byte reads (8 rows) and V's reads (rows 2t
// and 2t + 1, or at D32 rows t and t + 4) touch distinct banks.  64-byte
// rows (an 8-bit payload at D64), two to a line, and 32-byte rows (8-bit at
// D32), four: decode_group.cuh's swizzle, which at 32 bytes gives rows r and
// r + 4 of a line the row's other chunk first.
template <int kRow>
__device__ __forceinline__ int group32_swizzle(int r) {
  return kRow >= 128 ? ((r & 7) ^ ((r & 1) << 2)) : swizzle<kRow>(r);
}

// The token of n index j of an 8-token half of a sub-tile: j, or with
// kTok8 (8-bit rows at D32) decode_group.cuh's tok8 order.
template <bool kTok8>
__device__ __forceinline__ int tok_of(int j) {
  return kTok8 ? tok8(j) : j;
}

template <typename KV>
__device__ __forceinline__ void payload4(uint32_t w, uint32_t (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = __float_as_uint(payload_value<KV>((w >> (8 * e)) & 0xFFu));
}

template <typename KV, int D, int kRW, bool kPaged>
__global__ void __launch_bounds__(kGThreads, 1) group_fp32_kernel(const GroupParams p) {
  using L = GroupLayout32<KV, D, kRW>;
  constexpr bool kQuant = L::kQuant;
  constexpr int S = L::kStages;
  constexpr int kTok = L::kTok;
  constexpr int kCols = L::kCols, kSplit = L::kSplit, kCS = L::kCS, kTG = L::kTG;
  constexpr int kJ = kCols / 16;                 // 16-column blocks of a warp's S (two k-steps each)
  constexpr int kH = kCols / 32;                 // 32-column blocks of its P V (four n-tiles each)
  constexpr int kCopy = D == 32 && kQuant ? 8 : 16;  // bytes of a payload row's cp.async
  constexpr int kChunks = L::kRow / kCopy;       // copies of a payload row
  constexpr int kRowStep = kGThreads / kChunks;  // rows between a thread's copies
  constexpr bool kTok8 = L::kRow == 32;          // 8-bit rows at D32: each 8-token half taken as tok8
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "head dims 32 (d 8-32), 64, 128 and 256");
  static_assert(sizeof(KV) == 1 || std::is_same<KV, float>::value, "an fp32 payload, or int8 / fp8");
  static_assert(kTok % kRowStep == 0, "tiling");

  extern __shared__ __align__(128) unsigned char smem[];
  const int C = (int)cluster_size();
  const int rank = (int)sm90::cluster_rank();
  const int hk = blockIdx.y / p.passes, pass = blockIdx.y % p.passes, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qg = lane / 4, qt = lane % 4;  // the mma fragments' group and thread in group
  const int g0 = pass * p.pass_rows;
  const int G = min(p.pass_rows, p.group - g0);  // q rows of this block, at most 16 kRW (the host keeps to it)
  const int rt = warp / kCS;                     // this warp's row tile,
  const int tg = (warp % kCS) / kSplit;          // its token group
  const int part_of = warp % kSplit;             // and its kCols head-dim columns
  const int col0 = part_of * kCols;
  const bool rows_live = rt * 16 < G;
  const int d = D == 32 ? p.head_dim : D;        // the columns past d (D32) are zero in q, K and V
  const int len = p.lengths[b];

  // q's A fragments of the warp's row tile and columns, split once; rows past
  // the group and columns past d zero.  The head dim is taken in a permuted
  // order: k-steps 2j and 2j + 1 cover columns col0 + 16 j ... + 15, k index
  // t of step 2j + i being column 16 j + 4 t + 2 i and k index t + 4 column
  // 16 j + 4 t + 2 i + 1 (a sum over the columns does not depend on their
  // order); K's B fragments below follow the same order, so a lane reads 4
  // consecutive columns of a row.
  uint32_t qh[2 * kJ][4], ql[2 * kJ][4];
  {
    const float* gq = static_cast<const float*>(p.q) + b * p.q_sb + ((long long)hk * p.group + g0) * p.q_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rt * 16 + qg + 8 * r;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < G && col0 + 16 * j + 4 * qt < d)
          x = *reinterpret_cast<const float4*>(gq + row * p.q_sh + col0 + 16 * j + 4 * qt);
        split_tf32(x.x * p.q_scale, qh[2 * j][r], ql[2 * j][r]);
        split_tf32(x.y * p.q_scale, qh[2 * j][2 + r], ql[2 * j][2 + r]);
        split_tf32(x.z * p.q_scale, qh[2 * j + 1][r], ql[2 * j + 1][r]);
        split_tf32(x.w * p.q_scale, qh[2 * j + 1][2 + r], ql[2 * j + 1][2 + r]);
      }
    }
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
  if constexpr (kPaged) __syncthreads();

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
  // with kRowStep a multiple of 8, (row & 7) is r0's, so the piece's
  // swizzled place is fixed (an fp32 row at D256 takes 64 threads: there it
  // is found for each row).  A piece past the row's d columns (D32) is
  // zero-filled without a read.
  const int cc = tid % kChunks, r0 = tid / kChunks;
  const int at = cc * kCopy;  // the piece's byte in the row
  const bool col_ok = D != 32 || at < d * (int)sizeof(KV);
  auto dst_of = [&](int i) {  // the ring offset of the piece in row r0 + i kRowStep of a stage
    const int r = r0 + i * kRowStep;
    const int row0 = kRowStep % 8 == 0 ? r0 : r;
    return r * L::kRow + ((at / 16) ^ group32_swizzle<L::kRow>(row0)) * 16 + at % 16;
  };

  // Stage j into ring slot `slot`: rows past the stage's live end are
  // zero-filled without a read.
  auto issue = [&](int j, int slot) {
    int t0, tend, walk, c0;
    stage_range(j, t0, tend, walk, c0);
    unsigned char* dk = ring + slot * L::kStage;
    unsigned char* dv = ring + (S + slot) * L::kStage;
    if (one_page) {
      const int page = kPaged ? sTable[walk * ppc + (t0 - c0) / p.page_size] : b;
      const int row = (kPaged ? t0 % p.page_size : t0) + r0;
      const unsigned char* sk = gk + (page * p.k_sp + row * p.k_sr) * (long long)sizeof(KV) + at;
      const unsigned char* sv = gv + (page * p.v_sp + row * p.v_sr) * (long long)sizeof(KV) + at;
      const long long kstep = kRowStep * p.k_sr * (long long)sizeof(KV), vstep = kRowStep * p.v_sr * (long long)sizeof(KV);
#pragma unroll
      for (int i = 0; i < kTok / kRowStep; ++i) {
        const bool ok = col_ok && t0 + r0 + i * kRowStep < tend;
        cp_async<kCopy>(dk + dst_of(i), ok ? sk + i * kstep : gk, ok ? kCopy : 0);
        cp_async<kCopy>(dv + dst_of(i), ok ? sv + i * vstep : gv, ok ? kCopy : 0);
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
        cp_async<kCopy>(dk + dst_of(i), gk + ko, ok ? kCopy : 0);
        cp_async<kCopy>(dv + dst_of(i), gv + vo, ok ? kCopy : 0);
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

  // The warp's state for its row tile's rows qg and qg + 8, over its token
  // group's sub-tiles: O [4 kH n-tiles][4] for its kCols columns (n-tile 4 h
  // + e holds, at n index i, column col0 + 32 h + 4 i + e: P V's output
  // columns permuted so that a lane reads 4 consecutive columns of V), the
  // running maxima and the lane's share of the row sums.
  float o[4 * kH][4];
#pragma unroll
  for (int nt = 0; nt < 4 * kH; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
  float* exch = reinterpret_cast<float*>(smem + L::kExch);
  int par = 0;  // which of the split group's two partial-S buffers this sub-tile uses

  for (int j = 0; j < nstages; ++j) {
    const int slot = j % S;
    if (j == 0) cp_async_wait<S - 1>();
    else cp_async_wait<S - 2>();  // one group fewer: stage j - 1 + S is issued below
    __syncthreads();  // stage j has landed; every warp is done with stage j - 1 and its slot
    if (j > 0) {
      if (j - 1 + S < nstages) issue(j - 1 + S, (j - 1) % S);
      else cp_async_commit();
    }
    const unsigned char* sK = ring + slot * L::kStage;
    const unsigned char* sV = ring + (S + slot) * L::kStage;
    const float* sKs = sScale + slot * 2 * kTok;
    int t0, tend, walk, c0;
    stage_range(j, t0, tend, walk, c0);

    for (int u = tg; u < L::kSub; u += kTG) {
      const int tok0 = u * 16;
      if (!rows_live || t0 + tok0 >= tend) break;  // (every warp of a split group alike)

      // S of the sub-tile's 16 tokens (two n-tiles: token tok0 + 8 nt +
      // tok_of(qg) is n index qg) over the warp's columns: hi hi in s, the
      // cross passes in c, added at the end (tf32x3.cuh's `scores` says why).
      float s[2][4], c[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = c[nt][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = tok0 + 8 * nt + tok_of<kTok8>(qg);
          if constexpr (kQuant) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                sK + r * L::kRow + (((col0 / 16 + jj) ^ group32_swizzle<L::kRow>(r)) * 16) + 4 * qt);
            uint32_t x[4];
            payload4<KV>(w, x);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint32_t bx[2] = {x[2 * i], x[2 * i + 1]};
              mma_tf32(c[nt], ql[2 * jj + i], bx);
              mma_tf32(s[nt], qh[2 * jj + i], bx);
            }
          } else {
            const float4 x = *reinterpret_cast<const float4*>(
                sK + r * L::kRow + (((col0 / 4 + 4 * jj + qt) ^ group32_swizzle<L::kRow>(r)) * 16));
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              uint32_t bh[2], bl[2];
              split_tf32<false>(xs[2 * i], bh[0], bl[0]);
              split_tf32<false>(xs[2 * i + 1], bh[1], bl[1]);
              mma_tf32(c[nt], ql[2 * jj + i], bh);
              mma_tf32(c[nt], qh[2 * jj + i], bl);
              mma_tf32(s[nt], qh[2 * jj + i], bh);
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += c[nt][e];
      if constexpr (kSplit > 1) {
        // The split group's partial S: each warp's in its buffer, then the
        // sum in one order (columns 0-63 first, then 64-127, ...) in every
        // warp of the group, its own part from its registers.
        float4* mine = reinterpret_cast<float4*>(exch + ((warp * 2 + par) * 32 + lane) * 8);
        mine[0] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
        mine[1] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
        sm90::named_bar_sync(1 + warp / kSplit, 32 * kSplit);
        float sum[2][4];
#pragma unroll
        for (int w = 0; w < kSplit; ++w) {
          float x[2][4];
          if (w == part_of) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) x[nt][e] = s[nt][e];
          } else {
            const float4* theirs =
                reinterpret_cast<const float4*>(exch + (((warp - part_of + w) * 2 + par) * 32 + lane) * 8);
            const float4 t0v = theirs[0], t1v = theirs[1];
            x[0][0] = t0v.x, x[0][1] = t0v.y, x[0][2] = t0v.z, x[0][3] = t0v.w;
            x[1][0] = t1v.x, x[1][1] = t1v.y, x[1][2] = t1v.z, x[1][3] = t1v.w;
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[nt][e] = w == 0 ? x[nt][e] : sum[nt][e] + x[nt][e];
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = sum[nt][e];
        par ^= 1;
      }

      // One online-softmax step of the token group: s[nt][e] is row qg + 8
      // (e / 2), token tok0 + 8 nt + tok_of(2 qt + e % 2).
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = tok0 + 8 * nt + tok_of<kTok8>(2 * qt + e % 2);
          float x = s[nt][e] * p.score_scale;
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
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = tok0 + 8 * nt + tok_of<kTok8>(2 * qt + e % 2);
          const float pe = t0 + tok < tend ? expf(s[nt][e] - m_run[e / 2]) : 0.f;
          l_run[e / 2] += pe;
          s[nt][e] = kQuant ? pe * sKs[kTok + tok] : pe;  // P * v_scale, in fp32
        }

      // O = O alpha + P V for the warp's columns, the sub-tile's product
      // summed from zero first (the tensor cores truncate what they add; a
      // sub-tile's part loses that only on its own magnitude).  P's A
      // fragments from S's accumulators (frag_acc: depth t is n index 2t of
      // the n-tile, t + 4 n index 2t + 1), V's B fragments from the rows of
      // those tokens, tok0 + 8 kk + tok_of(2 qt) and tok_of(2 qt + 1), a
      // lane's 4 consecutive columns col0 + 32 h + 4 qg ... + 3 serving
      // n-tiles 4 h ... 4 h + 3.
      float part[4 * kH][4];
#pragma unroll
      for (int nt = 0; nt < 4 * kH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ph[4], pl[4];
        frag_acc<false>(ph, pl, s[kk]);
        const int vr0 = tok0 + 8 * kk + tok_of<kTok8>(2 * qt), vr1 = tok0 + 8 * kk + tok_of<kTok8>(2 * qt + 1);
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          if constexpr (kQuant) {
            const int ch = (col0 + 32 * h) / 16 + qg / 4, at4 = 4 * (qg % 4);  // the lane's chunk, its bytes in it
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
                sV + vr0 * L::kRow + ((ch ^ group32_swizzle<L::kRow>(vr0)) * 16) + at4);
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
                sV + vr1 * L::kRow + ((ch ^ group32_swizzle<L::kRow>(vr1)) * 16) + at4);
            uint32_t x0[4], x1[4];
            payload4<KV>(w0, x0);
            payload4<KV>(w1, x1);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t bx[2] = {x0[e], x1[e]};
              mma_tf32(part[4 * h + e], pl, bx);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t bx[2] = {x0[e], x1[e]};
              mma_tf32(part[4 * h + e], ph, bx);
            }
          } else {
            const float4 v0 = *reinterpret_cast<const float4*>(
                sV + vr0 * L::kRow + (((col0 / 4 + 8 * h + qg) ^ group32_swizzle<L::kRow>(vr0)) * 16));
            const float4 v1 = *reinterpret_cast<const float4*>(
                sV + vr1 * L::kRow + (((col0 / 4 + 8 * h + qg) ^ group32_swizzle<L::kRow>(vr1)) * 16));
            const float a0[4] = {v0.x, v0.y, v0.z, v0.w}, a1[4] = {v1.x, v1.y, v1.z, v1.w};
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              split_tf32<false>(a0[e], bh[e][0], bl[e][0]);
              split_tf32<false>(a1[e], bh[e][1], bl[e][1]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) mma_tf32(part[4 * h + e], pl, bh[e]);
#pragma unroll
            for (int e = 0; e < 4; ++e) mma_tf32(part[4 * h + e], ph, bl[e]);
#pragma unroll
            for (int e = 0; e < 4; ++e) mma_tf32(part[4 * h + e], ph, bh[e]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4 * kH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = fmaf(o[nt][e], alpha[e / 2], part[nt][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the states go over it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(kFull, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(kFull, l_run[h], 2);
  }

  // Each token group's state (the block's, when the row tile has one group):
  // acc [row][D] fp32, with m and l [row] from the columns' first warp.
  float* state = reinterpret_cast<float*>(smem);
  float* state_m = reinterpret_cast<float*>(smem + L::Merge::kStateM);
  float* state_l = reinterpret_cast<float*>(smem + L::Merge::kStateL);
  float* gacc = L::Merge::group_acc(smem, tg);
  float* gm = L::Merge::group_m(smem, tg);
  float* gl = L::Merge::group_l(smem, tg);
  if (rows_live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rt * 16 + qg + 8 * r;
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * r + i;  // n index 2 qt + i of row qg + 8 r
          *reinterpret_cast<float4*>(gacc + row * D + col0 + 32 * h + 4 * (2 * qt + i)) =
              make_float4(o[4 * h][e], o[4 * h + 1][e], o[4 * h + 2][e], o[4 * h + 3][e]);
        }
      if (part_of == 0 && qt == 0) {
        gm[row] = m_run[r];
        gl[row] = l_run[r];
      }
    }
  }
  // The row tiles' token groups merged into the block's state.
  L::Merge::template merge_groups<kGThreads>(smem, G, tid);

  // Every block's state is in: merge them over the cluster and write the
  // output's d columns.
  cluster_merge<float, kGThreads, D>(state, state_m, state_l, reinterpret_cast<float*>(smem + L::Merge::kWeights),
                                     reinterpret_cast<float*>(smem + L::Merge::kSums), G, d, C, rank, tid,
                                     static_cast<float*>(p.o) + b * p.o_sb + ((long long)hk * p.group + g0) * p.o_sh,
                                     p.o_sh);
}

template <typename KV, int D, int kRW, bool kPaged>
cudaError_t group32_launch_one(const GroupParams& p, int cluster, dim3 grid, cudaStream_t s, int* resident) {
  return cluster_launch<GroupParams, group_fp32_kernel<KV, D, kRW, kPaged>, kGThreads,
                        GroupLayout32<KV, D, kRW>::kBytes>(p, cluster, grid, s, resident);
}

constexpr int kGMaxRows32D128 = 64;  // q heads of a pass for fp32 q at D128 (4 row tiles, a warp pair each)
constexpr int kGMaxRows32D256 = 32;  // and at D256 (2 row tiles, a group of four warps each)

// The row tiles (kRW) of a pass of `rows` q heads: its m16 row tiles rounded
// up to a power of two; a row tile takes whole split groups (kSplit warps),
// so at most 4 at D128 and 2 at D256, where the host's passes hold at most
// kGMaxRows32D128 and kGMaxRows32D256 q heads.
template <typename KV, int D, bool kPaged>
cudaError_t group32_launch_rows(const GroupParams& p, int cluster, dim3 grid, cudaStream_t s, int* resident) {
  const int tiles = p.pass_rows / 16;
  if (tiles <= 1) return group32_launch_one<KV, D, 1, kPaged>(p, cluster, grid, s, resident);
  if (tiles <= 2) return group32_launch_one<KV, D, 2, kPaged>(p, cluster, grid, s, resident);
  if constexpr (D == 256) {
    return cudaErrorInvalidValue;
  } else {
    if (tiles <= 4) return group32_launch_one<KV, D, 4, kPaged>(p, cluster, grid, s, resident);
    if constexpr (D != 128) {
      return group32_launch_one<KV, D, 8, kPaged>(p, cluster, grid, s, resident);
    } else {
      return cudaErrorInvalidValue;
    }
  }
}

// The payload (kv_dtype 0 = fp32, 1 = int8, 2 = fp8 e4m3) and K5 / K6 at one
// head dim.  The sources decode_group_fp32_d<D>_<k5|k6>.cu instantiate
// group32_launch_rows for their (head dim, K5 or K6) and every payload;
// decode.cu declares them extern.
template <int D>
cudaError_t group32_launch_width(const GroupParams& p, int kv_dtype, bool paged, int cluster, dim3 grid,
                                 cudaStream_t s, int* resident) {
  if (kv_dtype == 0) {
    return paged ? group32_launch_rows<float, D, true>(p, cluster, grid, s, resident)
                 : group32_launch_rows<float, D, false>(p, cluster, grid, s, resident);
  }
  if (kv_dtype == 1) {
    return paged ? group32_launch_rows<int8_t, D, true>(p, cluster, grid, s, resident)
                 : group32_launch_rows<int8_t, D, false>(p, cluster, grid, s, resident);
  }
  if (kv_dtype == 2) {
    return paged ? group32_launch_rows<__nv_fp8_e4m3, D, true>(p, cluster, grid, s, resident)
                 : group32_launch_rows<__nv_fp8_e4m3, D, false>(p, cluster, grid, s, resident);
  }
  return cudaErrorInvalidValue;
}

#define FA_GROUP32_ROWS(X, D, P) X(float, D, P) X(int8_t, D, P) X(__nv_fp8_e4m3, D, P)
#define FA_GROUP32_ALL(X)                                                                                \
  FA_GROUP32_ROWS(X, 32, true) FA_GROUP32_ROWS(X, 32, false) FA_GROUP32_ROWS(X, 64, true)                \
  FA_GROUP32_ROWS(X, 64, false) FA_GROUP32_ROWS(X, 128, true) FA_GROUP32_ROWS(X, 128, false)             \
  FA_GROUP32_ROWS(X, 256, true) FA_GROUP32_ROWS(X, 256, false)

}  // namespace decode
}  // namespace fa
