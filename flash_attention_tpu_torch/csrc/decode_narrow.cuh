// One-token decode attention for Hopper (sm_90a) at head dims 8, 16 and 32
// for GQA groups of up to 8 q heads a KV head: K5 (fa_paged_decode_narrow)
// and K6 (fa_fused_decode_narrow), one kernel template.  decode.cu holds the
// entry points; the instantiations are split by q dtype over
// decode_narrow_<fp32|bf16|fp16>.cu.  A group above 8 at these head dims
// runs decode_group.cuh / decode_group_fp32.cuh, head dims 64-256 the group
// tiles of decode.cuh.
//
// Replaces: flash_attention_tpu/inference/paged_attention.py::_paged_kernel
// (K5) and flash_attention_tpu/inference/decode_attention.py::_fused_kernel
// (K6) at those head dims.  Numerics as decode.cuh's (K5: (q . k) * sm_scale
// * k_scale, n = max(lengths + len_add, 1); K6: q * sm_scale rounded to q's
// dtype, (q . k) * k_scale, n = lengths + 1; natural exp, an online softmax
// in fp32, p * v_scale rounded to q's dtype before P V, exact fp32 FMAs for
// every q dtype, one final division with the l == 0 guard).  Only the order
// of summation differs from the plain versions: per tile of 32 tokens in a
// warp's online softmax, then the block's warps in warp order, then the
// cluster's blocks in rank order (`paged_attention_narrow_ref` is that order
// in plain PyTorch).  The TPU kernels view consecutive tokens' narrow rows as
// one wide row (lane packing for the (8, 128) tiles); the Hopper counterpart
// of that observation is below: a tile's rows are one span of memory.
//
// What bounds it on this card: bytes, 32 (8-bit) to 128 (fp32) of them a
// token's K or V row.  At such rows the group tiles of decode.cuh (16-token
// tiles, 4 lanes a token's dot product, 8-byte copies per padded row) were
// held by the instructions they issue per byte rather than by the bytes
// (PERF.md §6, PR 25: an int8 cache took 86% of a bf16 cache's time for 56%
// of its bytes).  What the design does about it:
//   * a (sequence, KV head) is one thread-block cluster of 1, 2, 4 or 8
//     blocks (decode_cluster.cuh), the cluster size from what the card holds
//     at once (`paged_attention.decode_cluster_split`); block c walks chunks
//     c, c + C, ... of 128 tokens (K5: whole pages), and the blocks' states
//     merge over distributed shared memory at the end (a cluster of one
//     writes its output at once): no workspace, no arrival counter, no
//     second pass;
//   * each of a block's 4 warps takes every fourth 32-token tile of the
//     block's chunks through a ring of its own (2-4 stages), with no
//     block-wide barrier until the warps' states merge;
//   * a tile's K and V rows are staged as the span they are in memory:
//     lane i copies the 16-byte pieces i, i + 32, ... of the tile (8-byte
//     ones only for 8-byte rows, int8 / fp8 at d = 8), so that a warp's
//     copies read whole sectors in order, only the d columns of a row are
//     read, and rows past the length are zero-filled without a read; each
//     lane copies its own token's two scales;
//   * S with a lane a token: the lane reads its own K row (16-byte chunks
//     XOR-swizzled by row, so that 8 lanes' reads fall in distinct banks),
//     widens it once and takes its dot products with the tile's q rows
//     (broadcast from shared memory); no shuffle per dot product;
//   * one online-softmax step per tile and q row: the tile's max by 5
//     shuffles, p by the lane of its token, and each lane keeps its own
//     partial l (the running max is the warp's, so the partials rescale
//     alike and are summed once, at the end);
//   * P V with each lane owning 8 output columns of every q row for a subset
//     of the tile's tokens (P through shared memory), the subsets summed by
//     shuffles once, at the end.
//
// The kernel allocates nothing and launches on the caller's stream.
#pragma once

#include "decode_cluster.cuh"

namespace fa {
namespace decode {

constexpr int kNThreads = 128;
constexpr int kNWarps = kNThreads / 32;
constexpr int kNTile = 32;                  // tokens of a warp's tile: a lane a token
constexpr int kNChunk = kNWarps * kNTile;   // tokens of a chunk at least (the host's split)
constexpr int kNMaxRows = 8;                // q heads of a KV head at most

// Shared memory of a block: each warp's ring (K and V tiles of 32 rows of
// 32 padded columns, the K rows' 16-byte chunks XOR-swizzled, and for an
// 8-bit payload the tile's K and V scales; 4 stages of an 8-bit payload, 2
// of a 16-bit one, 3 of fp32, the fastest of 2-6 on the H100 at the d32 and
// d32_gqa4 timing rows: PERF.md §6), P [warp][token][row]
// in fp32, q's rows in fp32, K5's page ids; the states that end the kernel
// (MergeLayout) lie over the rings once every warp is done.
template <typename KV, int kG, bool kPaged>
struct NarrowLayout {
  static constexpr int kRow = 32 * (int)sizeof(KV);             // bytes of a padded K or V row
  static constexpr int kTileBytes = kNTile * kRow;
  static constexpr int kScaleBytes = sizeof(KV) == 1 ? 2 * kNTile * 4 : 0;
  static constexpr int kStage = 2 * kTileBytes + kScaleBytes;   // a stage of a warp's ring
  static constexpr int kStages = sizeof(KV) == 1 ? 4 : sizeof(KV) == 2 ? 2 : 3;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kP = kNWarps * kRing;
  static constexpr int kQ = kP + kNWarps * kNTile * kG * 4;
  static constexpr int kTable = kQ + kG * 32 * 4;
  static constexpr int kBytes = kTable + (kPaged ? kClusterMaxPages * 4 : 0);
  // (rows for 4 q heads at least: the warps' states are read as float4, and
  // with fewer rows MergeLayout's later arrays would not start on 16 bytes)
  using Merge = MergeLayout<(kG < 4 ? 4 : kG), 32, kNWarps>;
  static_assert(Merge::kEnd <= kP, "the states lie over the rings");
  static_assert(kBytes <= 227 * 1024, "shared memory of a block");
};

// The 16-byte chunk of padded row r (of kRow bytes) where logical chunk c
// lies: consecutive rows are 32-128 bytes apart, so without the swizzle the
// 8 lanes of a 16-byte read would share banks.
template <int kRow>
__device__ __forceinline__ int narrow_swizzle(int r) {
  constexpr int C = kRow / 16;  // chunks of a row: 2, 4 or 8
  return (r * C / 8) % C;
}

// Columns 8 cg .. 8 cg + 7 of K row r in a stage (swizzled) as float.
template <typename KV, int kRow>
__device__ __forceinline__ void k_cols8(const unsigned char* tile, int r, int cg, float (&f)[8]) {
  const unsigned char* row = tile + r * kRow;
  const int swz = narrow_swizzle<kRow>(r);
  constexpr int kBytes8 = 8 * (int)sizeof(KV);  // bytes of 8 columns: 8, 16 or 32
  if constexpr (kBytes8 == 32) {
    float4 a = *reinterpret_cast<const float4*>(row + (((2 * cg) ^ swz) * 16));
    float4 b = *reinterpret_cast<const float4*>(row + (((2 * cg + 1) ^ swz) * 16));
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    const int at = cg * kBytes8;  // the 8 columns' byte in the logical row
    load8<KV>(reinterpret_cast<const KV*>(row + (((at / 16) ^ swz) * 16) + at % 16), f);
  }
}

template <typename T, typename KV, int kG, bool kPaged>
__global__ void __launch_bounds__(kNThreads) narrow_kernel(const GroupParams p) {
  using L = NarrowLayout<KV, kG, kPaged>;
  constexpr int S = L::kStages;
  constexpr bool kQuant = sizeof(KV) == 1;
  static_assert(sizeof(KV) == 1 || std::is_same<KV, T>::value, "a 16-bit or fp32 payload is q's dtype");

  extern __shared__ __align__(128) unsigned char smem[];
  const int C = (int)cluster_size();
  const int rank = (int)sm90::cluster_rank();
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.group;  // q rows of the block (1-8; the host keeps to it)
  const int d = p.head_dim;
  const int len = p.lengths[b];

  // q's rows, scaled by q_scale and rounded to T (K6's pre-scaling; K5
  // passes 1), rows past the group and columns past d zero; read beside
  // the length, before anything waits on it.
  const T* gq = static_cast<const T*>(p.q) + b * p.q_sb + (long long)hk * p.group * p.q_sh;
  auto q_at = [&](int g, int col) -> float {
    return g < G && col < d ? round_to<T>(to_float(gq[g * p.q_sh + col]) * p.q_scale) : 0.f;
  };
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  for (int i = tid; i < kG * 32; i += kNThreads) sQ[i] = q_at(i / 32, i % 32);

  const int capacity = kPaged ? p.page_size * p.pages_per_seq : p.page_size;
  const int ppc = kPaged ? p.chunk / p.page_size : 1;  // pages of a chunk
  int* sTable = reinterpret_cast<int*>(smem + L::kTable);
  if constexpr (kPaged) {
    // The page ids of the block's chunks, read beside the length: entries
    // past the length are read but never used.
    for (int i = tid; i < p.walks * ppc; i += kNThreads) {
      const int page = (rank + (i / ppc) * C) * ppc + i % ppc;
      sTable[i] = page < p.pages_per_seq ? p.table[(long long)b * p.pages_per_seq + page] : 0;
    }
  }
  const int n = min(max(len + p.len_add, 1), capacity);
  // The block's tiles: tile i is tile i % tpc of chunk rank + (i / tpc) C;
  // the live ones are a prefix (every chunk before the last live one is
  // whole).
  const int tpc = (p.chunk + kNTile - 1) / kNTile;  // tiles of a chunk: 4 or more (chunks of 128 tokens or more)
  const int live_chunks = (n + p.chunk - 1) / p.chunk;
  const int mywalks = live_chunks > rank ? min((live_chunks - rank + C - 1) / C, p.walks) : 0;
  int ntiles = 0;
  if (mywalks > 0) {
    const int last = rank + (mywalks - 1) * C;
    ntiles = (mywalks - 1) * tpc + (min(p.chunk, n - last * p.chunk) + kNTile - 1) / kNTile;
  }
  const int mytiles = ntiles > warp ? (ntiles - warp + kNWarps - 1) / kNWarps : 0;
  __syncthreads();  // q's rows and the page ids are in

  // A warp walks the block's tiles warp, warp + 4, ...: a cursor holds the
  // tile's walk and its place k in its chunk, and steps without a division
  // (tpc >= 4: a step crosses at most one chunk).
  struct Cursor {
    int walk, k;
  };
  auto step = [&](Cursor& c) {
    c.k += kNWarps;
    if (c.k >= tpc) {
      c.k -= tpc;
      ++c.walk;
    }
  };
  auto range = [&](const Cursor& c, int& t0, int& tend, int& c0) {  // the tile's tokens [t0, tend), its chunk's c0
    c0 = (rank + c.walk * C) * p.chunk;
    t0 = c0 + c.k * kNTile;
    tend = min(min(t0 + kNTile, c0 + p.chunk), n);
  };

  unsigned char* ring = smem + warp * L::kRing;
  constexpr long long kv = sizeof(KV);
  const unsigned char* gk = static_cast<const unsigned char*>(p.k) + hk * p.k_sh * kv;
  const unsigned char* gv = static_cast<const unsigned char*>(p.v) + hk * p.v_sh * kv;
  const float* gks = kQuant ? p.ks + hk * p.s_sh : nullptr;
  const float* gvs = kQuant ? p.vs + hk * p.s_sh : nullptr;
  // A tile's rows, d columns each, in pieces of 16 bytes (8 for an 8-byte
  // row); lane i copies pieces i, i + 32, ...: the piece at byte `at` of
  // rows r0, r0 + rstep, ... (per_row pieces a row, a power of two).
  const int row_bytes = d * (int)sizeof(KV);
  const int piece = row_bytes >= 16 ? 16 : 8;
  const int per_row = row_bytes / piece;
  const int r0 = lane >> (__ffs(per_row) - 1), rstep = kNTile / per_row;
  const int at = (lane & (per_row - 1)) * piece;
  // With pages of a multiple of 32 tokens (or no pages) a tile lies in one
  // page (chunks are whole pages): tile k of a chunk in its page k / tpp.
  const bool one_page = !kPaged || p.page_size % kNTile == 0;
  const int tpp = one_page && kPaged ? p.page_size / kNTile : 1;
  const int tpp_log = (tpp & (tpp - 1)) == 0 ? __ffs(tpp) - 1 : -1;

  // The tile at cursor c into ring slot `slot`, rows past its live end
  // zero-filled without a read.
  auto issue = [&](const Cursor& c, int slot) {
    int t0, tend, c0;
    range(c, t0, tend, c0);
    unsigned char* dk = ring + slot * L::kStage;
    unsigned char* dv = dk + L::kTileBytes;
    float* ss = reinterpret_cast<float*>(dk + 2 * L::kTileBytes);
    int page0 = b, row0 = t0;  // the tile's page and first row there (one_page)
    if (kPaged && one_page) {
      const int pk = tpp_log >= 0 ? c.k >> tpp_log : c.k / tpp;  // the tile's page in its chunk
      page0 = sTable[c.walk * ppc + pk];
      row0 = (c.k - pk * tpp) * kNTile;
    }
    auto locate = [&](int r, long long& page, long long& row) {  // tile row r's page and row there
      if (one_page) {
        page = page0;
        row = row0 + r;
      } else {
        page = sTable[c.walk * ppc + (t0 + r - c0) / p.page_size];
        row = (t0 + r) % p.page_size;
      }
    };
    for (int m = 0; m < per_row; ++m) {
      const int r = r0 + m * rstep;
      const bool ok = t0 + r < tend;
      long long page = 0, row = 0;
      if (ok) locate(r, page, row);
      unsigned char* kdst = dk + r * L::kRow + (((at / 16) ^ narrow_swizzle<L::kRow>(r)) * 16) + at % 16;
      const unsigned char* sk = gk + (page * p.k_sp + row * p.k_sr) * kv + at;
      const unsigned char* sv = gv + (page * p.v_sp + row * p.v_sr) * kv + at;
      if (piece == 16) {
        cp_async<16>(kdst, sk, ok ? 16 : 0);
        cp_async<16>(dv + r * L::kRow + at, sv, ok ? 16 : 0);
      } else {
        cp_async<8>(kdst, sk, ok ? 8 : 0);
        cp_async<8>(dv + r * L::kRow + at, sv, ok ? 8 : 0);
      }
    }
    if constexpr (kQuant) {  // lane: its token's K and V scales
      const bool ok = t0 + lane < tend;
      long long page = 0, row = 0;
      if (ok) locate(lane, page, row);
      cp_async<4>(ss + lane, gks + page * p.s_sp + row, ok ? 4 : 0);
      cp_async<4>(ss + kNTile + lane, gvs + page * p.s_sp + row, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  Cursor ci{0, warp}, cc{0, warp};  // the next tile to issue, the next to compute
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < mytiles) {
      issue(ci, j);
      step(ci);
    } else {
      cp_async_commit();  // empty groups keep the wait counts uniform
    }
  }

  float* sP = reinterpret_cast<float*>(smem + L::kP) + warp * kNTile * kG;
  const int ncols = d / 8;              // P V: column groups of 8 (1, 2 or 4)
  const int nsub = 32 / ncols;          // token subsets of a tile
  const int pc = lane & (ncols - 1), psub = lane >> (__ffs(ncols) - 1);
  float acc[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  float m_run[kG], l_lane[kG];  // the warp's running max (alike in every lane), this lane's partial l
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m_run[g] = -CUDART_INF_F;
    l_lane[g] = 0.f;
  }

  for (int j = 0; j < mytiles; ++j) {
    const int slot = j % S;
    cp_async_wait<S - 2>();
    __syncwarp();  // the tile has landed; the warp is done with tile j - 1's slot and P
    if (j + S - 1 < mytiles) {
      issue(ci, (j + S - 1) % S);
      step(ci);
    } else {
      cp_async_commit();
    }
    const unsigned char* sK = ring + slot * L::kStage;
    const unsigned char* sV = sK + L::kTileBytes;
    const float* sS = reinterpret_cast<const float*>(sK + 2 * L::kTileBytes);

    // S for this lane's token: its K row's d columns, 8 at a time, against
    // q's rows broadcast from shared memory (with an fp32 payload 8 rows in
    // passes of 2, reading the K row 4 times: in fewer, K5 spills).
    float s[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) s[g] = 0.f;
    constexpr int kPass = sizeof(KV) == 4 && kG == 8 ? 2 : kG;
#pragma unroll
    for (int g0 = 0; g0 < kG; g0 += kPass) {
#pragma unroll
      for (int cg = 0; cg < 4; ++cg) {
        if (cg * 8 < d) {
          float kf[8];
          k_cols8<KV, L::kRow>(sK, lane, cg, kf);
#pragma unroll
          for (int g = g0; g < g0 + kPass; ++g) {
            const float4 a = *reinterpret_cast<const float4*>(sQ + g * 32 + cg * 8);
            const float4 c = *reinterpret_cast<const float4*>(sQ + g * 32 + cg * 8 + 4);
            const float qv[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) s[g] = fmaf(qv[e], kf[e], s[g]);
          }
        }
      }
    }

    // One online-softmax step per q row: the tile's max over the warp, p
    // for this lane's token, its partial l; P * v_scale in T to shared memory.
    int t0, tend, c0;
    range(cc, t0, tend, c0);
    step(cc);
    const bool valid = t0 + lane < tend;
    const float ksc = kQuant ? sS[lane] : 1.f, vsc = kQuant ? sS[kNTile + lane] : 1.f;
    float alpha[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float x = valid ? s[g] * p.score_scale * ksc : -CUDART_INF_F;
      float mt = x;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_new = fmaxf(m_run[g], mt);  // finite: token t0 is live
      alpha[g] = expf(m_run[g] - m_new);        // 0 while m_run is -inf
      const float pe = valid ? expf(x - m_new) : 0.f;
      l_lane[g] = l_lane[g] * alpha[g] + pe;
      m_run[g] = m_new;
      sP[lane * kG + g] = round_to<T>(pe * vsc);
    }
    __syncwarp();

    // acc = acc * alpha + P V over this lane's tokens and 8 columns.
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (alpha[g] != 1.f) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= alpha[g];
      }
    }
    for (int i = 0; i < ncols; ++i) {
      const int tok = psub + i * nsub;
      float vf[8];
      load8<KV>(reinterpret_cast<const KV*>(sV + tok * L::kRow) + pc * 8, vf);
      float pr[kG];
      if constexpr (kG % 4 == 0) {
#pragma unroll
        for (int g = 0; g < kG; g += 4) {
          const float4 x = *reinterpret_cast<const float4*>(sP + tok * kG + g);
          pr[g] = x.x; pr[g + 1] = x.y; pr[g + 2] = x.z; pr[g + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < kG; ++g) pr[g] = sP[tok * kG + g];
      }
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr[g], vf[e], acc[g][e]);
    }
  }
  cp_async_wait<0>();

  // The warp's state: acc summed over its token subsets and l over its
  // lanes by shuffles; then, once every warp is done with its ring, the
  // warps' states (over the rings) merged in warp order into the block's.
  for (int off = ncols; off < 32; off *= 2)
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], off);
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int off = 16; off > 0; off /= 2) l_lane[g] += __shfl_xor_sync(kFull, l_lane[g], off);
  using M = typename L::Merge;
  __syncthreads();
  float* gacc = M::group_acc(smem, warp);
  if (psub == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < 8; e += 4)
        *reinterpret_cast<float4*>(gacc + g * 32 + pc * 8 + e) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      M::group_m(smem, warp)[g] = m_run[g];
      M::group_l(smem, warp)[g] = l_lane[g];
    }
  }
  M::template merge_groups<kNThreads>(smem, G, tid);

  // A cluster of one block writes its state's d columns; a larger one
  // merges its blocks' states over the cluster first.
  T* out = static_cast<T*>(p.o) + b * p.o_sb + (long long)hk * p.group * p.o_sh;
  if (C == 1) {
    if constexpr (kNWarps > 1) __syncthreads();  // merge_groups' state is in
    const float* state = reinterpret_cast<const float*>(smem);
    const float* state_l = reinterpret_cast<const float*>(smem + M::kStateL);
    for (int i = tid; i < G * d; i += kNThreads) {
      const int g = i / d, col = i % d;
      const float l = state_l[g];
      out[g * p.o_sh + col] = from_float<T>(state[g * 32 + col] / (l == 0.f ? 1.f : l));
    }
    return;
  }
  cluster_merge<T, kNThreads, 32>(reinterpret_cast<float*>(smem), reinterpret_cast<float*>(smem + M::kStateM),
                                  reinterpret_cast<float*>(smem + M::kStateL),
                                  reinterpret_cast<float*>(smem + M::kWeights),
                                  reinterpret_cast<float*>(smem + M::kSums), G, d, C, rank, tid, out, p.o_sh);
}

template <typename T, typename KV, int kG, bool kPaged>
cudaError_t narrow_launch_one(const GroupParams& p, int cluster, dim3 grid, cudaStream_t s, int* resident) {
  return cluster_launch<GroupParams, narrow_kernel<T, KV, kG, kPaged>, kNThreads,
                        NarrowLayout<KV, kG, kPaged>::kBytes>(p, cluster, grid, s, resident);
}

// The q-row capacity (kG) of a group of `rows` q heads: 1, 2, 4 or 8.
template <typename T, typename KV, bool kPaged>
cudaError_t narrow_launch_rows(const GroupParams& p, int cluster, dim3 grid, cudaStream_t s, int* resident) {
  if (p.pass_rows <= 1) return narrow_launch_one<T, KV, 1, kPaged>(p, cluster, grid, s, resident);
  if (p.pass_rows <= 2) return narrow_launch_one<T, KV, 2, kPaged>(p, cluster, grid, s, resident);
  if (p.pass_rows <= 4) return narrow_launch_one<T, KV, 4, kPaged>(p, cluster, grid, s, resident);
  if (p.pass_rows <= kNMaxRows) return narrow_launch_one<T, KV, 8, kPaged>(p, cluster, grid, s, resident);
  return cudaErrorInvalidValue;
}

// Every instantiation of one q dtype: the payload (kv_dtype 0 = q's dtype,
// 1 = int8, 2 = fp8 e4m3) and K5 / K6.  The sources decode_narrow_<q
// dtype>.cu instantiate it; decode.cu declares them extern.
template <typename T>
cudaError_t narrow_launch_dtype(const GroupParams& p, int kv_dtype, bool paged, int cluster, dim3 grid,
                                cudaStream_t s, int* resident) {
  if (kv_dtype == 0) {
    return paged ? narrow_launch_rows<T, T, true>(p, cluster, grid, s, resident)
                 : narrow_launch_rows<T, T, false>(p, cluster, grid, s, resident);
  }
  if (kv_dtype == 1) {
    return paged ? narrow_launch_rows<T, int8_t, true>(p, cluster, grid, s, resident)
                 : narrow_launch_rows<T, int8_t, false>(p, cluster, grid, s, resident);
  }
  if (kv_dtype == 2) {
    return paged ? narrow_launch_rows<T, __nv_fp8_e4m3, true>(p, cluster, grid, s, resident)
                 : narrow_launch_rows<T, __nv_fp8_e4m3, false>(p, cluster, grid, s, resident);
  }
  return cudaErrorInvalidValue;
}

#define FA_NARROW_DTYPES(X) X(float) X(__nv_bfloat16) X(__half)

}  // namespace decode
}  // namespace fa
