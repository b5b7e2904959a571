// One-token decode attention at head dims above 256 (true d 384-1024, run
// at padded D = 512 or 1024): K5 (paged, fa_paged_decode_wide) and K6
// (slot-major, fa_fused_decode_wide), two instantiations of one kernel
// template, for q in fp32, bf16 and fp16, payloads in q's dtype, int8 and
// fp8 e4m3 with per-token fp32 scales, and every GQA group.  This header
// holds the template; decode.cu holds the C entry points, and the
// instantiations are split by q dtype, D and entry point over the 12 sources
// decode_wide_<fp32|bf16|fp16>_d<512|1024>_<k5|k6>.cu.
//
// Replaces, for those head dims: flash_attention_tpu/inference/
// paged_attention.py::_paged_kernel (K5) and flash_attention_tpu/inference/
// decode_attention.py::_fused_kernel (K6).  The function and its rounding
// points are decode.cuh's: S = q K^T in fp32 (K5: * sm_scale; K6: q
// pre-scaled by sm_scale and rounded to q's dtype), times the token's
// k_scale; natural exp and an online softmax in fp32; p * v_scale rounded to
// q's dtype before P V; one final division with the l == 0 guard.  Only the
// order of summation differs from the plain versions.  The columns past d
// are never read or stored.
//
// What bounds it on this card: bytes.  A row of K and V is 0.75-4 KB, so a
// decode step over a long context reads tens of MB (8 slots of ~2000 tokens
// on 2 KV heads at d 1024: 131 MB of bf16), at 4-16 FLOPs a byte for a GQA
// group of 4.  What the design does about it:
//   * a (sequence, KV head, pass) is one thread-block cluster of `cluster`
//     blocks, one block an SM, as many as the card holds in one wave
//     (`paged_attention.decode_cluster_split` reads cudaOccupancyMaxActiveClusters
//     through fa_decode_wide_resident: 16 pairs take clusters of 6 on an H100,
//     where 15 of 7 or 8 fit).  The capacity is cut into chunks of one stage
//     (whole pages for K5), never by the lengths; block c walks chunks c,
//     c + cluster, ... with one online softmax state a q row, and the blocks'
//     states merge over distributed shared memory in rank order
//     (decode_cluster.cuh's cluster_merge, shared with the whole-group
//     kernel): no workspace, no arrival counters, no serial last block;
//   * a producer warp keeps the block's ring full: lane r copies row r of a
//     stage's K (or V) with one bulk copy (`cp.async.bulk`, completing on the
//     slot's mbarrier) and an 8-bit payload's scale with a 4-byte `cp.async`
//     tracked by the same mbarrier.  A stage is kTok tokens (32; 16 for fp32
//     rows of 4 KB), its K and its V each one ring slot of up to 64 KB, 192 KB
//     of ring (3-8 slots), rows padded by 16 bytes so that the 8 rows an
//     ldmatrix or a fragment load reads fall in distinct banks: two slots are
//     on their way while the consumers read the third, and the consumers
//     release K's slot as soon as S is done.  The bulk copies of a fill
//     retire about one a 45-50 ns whatever their bytes, so a fill of 32 rows
//     takes about 1.5 us: the floor of a stage at 512-byte rows (int8 at D512;
//     a TMA tensor copy of the whole stage lifts it there, but its column-block
//     order made D1024 slower, PERF.md §6);
//   * 8 consumer warps, warp w the column slab w (D / 8 columns): each computes
//     its slab's partial S for every token of the stage, then one named
//     barrier a stage, after which every warp sums the live slabs' partials
//     in slab order and runs the same online-softmax step (a lane a token,
//     the rows side by side): one exchange a stage of 32 tokens, and every
//     warp holds the same softmax state, so the block needs no merge of its
//     warps' states;
//   * 16-bit q: S^T = K q^T and O^T = V^T P^T on mma.sync m16n8k16 with fp32
//     accumulators (the group's rows padded to the n of 8 cost no bytes); K
//     and V by ldmatrix(.trans) from the padded rows, an 8-bit payload read
//     exactly in q's dtype straight from its bytes (cvt4).  fp32 q:
//     FMAs in fp32 (8 columns a lane, the lanes of a token reduce-scattered
//     over the q rows), which hold the fp32 tier's 1e-5;
//   * only the group's rows: a pass holds 1, 4 or 8 q rows (kMaxG), a group
//     above 8 runs in passes of at most 8, a cluster each.
// A block whose chunks hold no live token publishes m = -inf, l = 0 and stays
// for both cluster barriers (a block must not leave while a peer reads it).
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry points return the launch's cudaError_t.
#pragma once

#include "decode.cuh"
#include "decode_cluster.cuh"
#include "sm90.cuh"

namespace fa {
namespace decode {

constexpr int kWConsumers = 8;                     // consumer warps: warp w owns column slab w
constexpr int kWThreads = (kWConsumers + 1) * 32;  // and one producer warp
constexpr int kWMaxRows = 8;                       // q heads of a pass
constexpr int kWRingBytes = 192 * 1024;            // the ring's bytes (at least 3 slots)
constexpr int kWSlotBytes = 64 * 1024;             // a K (or V) slot's bytes at most, unpadded

struct WideParams {
  const void* q;         // [batch, hq, d], last dim contiguous
  const void* k;         // payload: paged [hkv, pages, page_size, d] or slot-major [hkv, slots, max_len, d]
  const void* v;
  const float* ks;       // scales [hkv, pages or slots, rows]; null unless quantized
  const float* vs;
  const int* lengths;    // [batch]
  const int* table;      // [batch, pages_per_seq] (K5) or null (K6)
  void* o;               // [batch, hq, d], rows 16-byte aligned
  long long q_sb, q_sh, o_sb, o_sh;
  long long k_sh, k_sp, k_sr, v_sh, v_sp, v_sr, s_sh, s_sp;
  int group, passes, pass_rows;  // q heads a KV head, passes of the group, q heads a pass (1-8)
  int head_dim;                  // d: 384-1024, a multiple of 128, at most D
  int page_size, pages_per_seq, len_add;
  int chunk, walks;              // tokens of a chunk; chunks a block walks
  float q_scale, score_scale;
};

// Shared memory of a block.  While streaming: the ring (kSlots slots of kTok
// rows, K and V of a stage in consecutive fills; a row is padded by 16
// bytes, so that the 8 rows an ldmatrix or a fragment load reads fall in
// distinct banks), the scales of an 8-bit payload's fills, the consumer
// warps' partial S (double-buffered: a warp writes stage j + 1's while a
// slower one still reads stage j's), each warp's P (fp32 [kTok][kMaxG] for
// fp32 q; T [8][kTok + 8] for 16-bit q, the B operand of P V), the slots'
// mbarriers (full, empty) and the block's page ids.  While merging, over the
// ring: the block's state (acc [row][D], m, l), which the cluster's peers
// read, and the cluster's weights.
template <typename T, typename KV, int D, int kMaxG>
struct WideLayout {
  static constexpr bool kMma = !std::is_same<T, float>::value;
  static constexpr int kRow = D * (int)sizeof(KV) + 16;            // bytes of a padded row
  static constexpr int kTok = kWSlotBytes / (kRow - 16) < 32 ? kWSlotBytes / (kRow - 16) : 32;  // tokens of a stage
  static constexpr int kSlot = kTok * kRow;                        // a K or V tile
  static constexpr int kFit = kWRingBytes / kSlot;
  static constexpr int kSlots = kFit < 3 ? 3 : (kFit > 8 ? 8 : kFit);
  static constexpr int kScales = kSlots * kSlot;                   // [slot][kTok] fp32
  static constexpr int kS = kScales + kSlots * kTok * 4;           // [2][warp][kMaxG][kTok] fp32
  static constexpr int kPRow = kTok + 8;                           // 16-bit P: elements of a padded row
  static constexpr int kPWarp = kMma ? 8 * kPRow * 2 : kTok * kMaxG * 4;  // bytes of a warp's P
  static constexpr int kP = kS + 2 * kWConsumers * kMaxG * kTok * 4;
  static constexpr int kBars = kP + kWConsumers * kPWarp;          // full [kSlots], empty [kSlots]
  static constexpr int kTable = kBars + 2 * kSlots * 8;
  static constexpr int kBytes = kTable + kClusterMaxPages * 4;
  static constexpr int kStateM = kMaxG * D * 4;                    // over the ring: acc, m, l
  static constexpr int kStateL = kStateM + kMaxG * 4;
  static constexpr int kWeights = kStateL + kMaxG * 4;             // [row][block]
  static constexpr int kSums = kWeights + kMaxG * kClusterMax * 4;  // [row]
  static_assert(kTok >= 16 && kTok <= 32 && (!kMma || kTok == 32), "a stage of 16-32 tokens, 32 on mma.sync");
  static_assert(kSums + kMaxG * 4 <= kScales, "the merge's state fits over the ring");
  static_assert(kBytes <= 227 * 1024, "shared memory of a block");
};

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// One arrival on `bar` when every cp.async this thread issued so far has
// landed (the barrier's count includes it).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// `bytes` (a multiple of 16) global -> shared, counted in bytes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename T, typename KV, int D, int kMaxG, bool kPaged>
__global__ void __launch_bounds__(kWThreads, 1) wide_kernel(const WideParams p) {
  using L = WideLayout<T, KV, D, kMaxG>;
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr bool kMma = L::kMma;
  constexpr int NS = L::kSlots;
  constexpr int kTok = L::kTok;
  constexpr int kCols = D / kWConsumers;  // columns of a warp's slab
  constexpr int kLanes = kCols / 8;       // FMAs: lanes of a token, 8 columns each
  constexpr int kTokPass = 32 / kLanes;   // FMAs: tokens of a warp's pass (S) or subset (P V)
  constexpr int kKs = kCols / 16;         // mma: k-steps of S over the slab, m-tiles of P V
  static_assert(D == 512 || D == 1024, "padded head dims 512 and 1024");
  static_assert(kTok % kTokPass == 0 && kLanes >= kMaxG, "tiling");

  extern __shared__ __align__(128) unsigned char smem[];
  const int C = (int)cluster_size();
  const int rank = (int)sm90::cluster_rank();
  const int hk = blockIdx.y / p.passes, pass = blockIdx.y % p.passes, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g0 = pass * p.pass_rows;
  const int G = min(p.pass_rows, p.group - g0);  // q rows of this block, at most kMaxG (the host keeps to it)
  const int d = p.head_dim;
  const int len = p.lengths[b];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + NS;
  unsigned char* ring = smem;
  float* sScale = reinterpret_cast<float*>(smem + L::kScales);
  int* sTable = reinterpret_cast<int*>(smem + L::kTable);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(full + s, 32);            // the producer's lanes, one arrival each a fill
      sm90::mbar_init(empty + s, kWConsumers);  // the consumer warps, one each a fill
    }
    sm90::fence_barrier_init();
  }
  if constexpr (kMma) {  // the P tiles' rows past the group stay zero
    for (int i = tid; i < kWConsumers * L::kPWarp / 16; i += kWThreads)
      reinterpret_cast<uint4*>(smem + L::kP)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int capacity = kPaged ? p.page_size * p.pages_per_seq : p.page_size;
  const int ppc = kPaged ? p.chunk / p.page_size : 1;  // pages of a chunk
  if constexpr (kPaged) {
    // The page ids of the block's chunks, read beside the length (not after
    // it): entries past the length are read but never used.
    for (int i = tid; i < p.walks * ppc; i += kWThreads) {
      const int page = (rank + (i / ppc) * C) * ppc + i % ppc;
      sTable[i] = page < p.pages_per_seq ? p.table[(long long)b * p.pages_per_seq + page] : 0;
    }
  }

  // The consumers' q rows of their slab, scaled by q_scale and rounded to T
  // (K6's pre-scaling; K5 passes 1), rows past the pass and slabs past d
  // zero; read beside the length.  FMAs: a lane's 8 columns of every row.
  // mma: S^T = K q^T, q the B operand (k = columns, n = q rows), lane (g =
  // lane / 4, c = lane % 4) holding row g's columns 16 ks + 2c, 2c + 1,
  // 2c + 8, 2c + 9 of each k-step (an 8-bit K is read from its bytes as 4
  // consecutive columns a lane, so there the k indices are taken as columns
  // 16 ks + 4c ... + 3: a sum over the columns does not depend on their
  // order).
  const int qj = lane % kLanes, tp = lane / kLanes;  // FMAs: a lane's 8 columns, and its token of a pass
  const int fg = lane / 4, fc = lane % 4;            // mma: a lane's fragment row and column pair
  const bool slab_live = warp < kWConsumers && warp * kCols < d;
  const T* gq = static_cast<const T*>(p.q) + b * p.q_sb + ((long long)hk * p.group + g0) * p.q_sh + warp * kCols;
  auto q_at = [&](int g, int col) -> float {
    return slab_live && g < G ? round_to<T>(to_float(gq[g * p.q_sh + col]) * p.q_scale) : 0.f;
  };
  float q[kMma ? 1 : kMaxG][8];
  uint32_t qb[kMma ? kKs : 1][2];
  if constexpr (kMma) {
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const int c0 = ks * 16 + (kQuant ? 4 * fc : 2 * fc), c1 = kQuant ? c0 + 2 : c0 + 8;
      qb[ks][0] = Pack<T>::two(q_at(fg, c0), q_at(fg, c0 + 1));
      qb[ks][1] = Pack<T>::two(q_at(fg, c1), q_at(fg, c1 + 1));
    }
  } else {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) q[g][e] = q_at(g, qj * 8 + e);
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
  // Stage j: chunk rank + (j / spc) C, its tokens [t0, tend).
  auto stage_range = [&](int j, int& t0, int& tend, int& walk, int& c0) {
    walk = j / spc;
    c0 = (rank + walk * C) * p.chunk;
    t0 = c0 + (j % spc) * kTok;
    tend = min(min(t0 + kTok, c0 + p.chunk), n);
  };
  __syncthreads();  // the barriers are initialised, the page ids in

  // P V's accumulators.  FMAs: acc[row][e], a lane's 8 columns (qj) of its
  // token subset (tp).  mma: O^T = V^T P^T, m-tile mt of the slab's columns,
  // fragment rows (columns of O) fg and fg + 8, fragment columns (q rows) 2
  // fc and 2 fc + 1: acc[mt][0..3] = O[2 fc][col], O[2 fc + 1][col], O[2 fc]
  // [col + 8], O[2 fc + 1][col + 8] (an 8-bit V: see the P V below for the
  // columns).
  float acc[kMma ? kKs : kMaxG][kMma ? 4 : 8];
  float m_run[kMaxG], l_run[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m_run[g] = -CUDART_INF_F;
    l_run[g] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < (kMma ? kKs : kMaxG); ++i)
#pragma unroll
    for (int e = 0; e < (kMma ? 4 : 8); ++e) acc[i][e] = 0.f;

  if (warp == kWConsumers) {
    // The producer: fill f is stage f / 2's K (f even) or V, into slot
    // f % NS once the consumers have released its previous fill: lane r
    // copies the stage's row r, one bulk copy (rows past the live end are not
    // read), and an 8-bit payload's scale of row r.  The products on mma.sync read whole
    // 16-token tiles, and P is 0 past the live end, so there V's rows past
    // it are zero-filled (`cp.async` of 0 source bytes): 0 times whatever
    // an earlier kernel left in shared memory could be NaN.
    const int row_bytes = d * (int)sizeof(KV);
    for (int f = 0; f < 2 * nstages; ++f) {
      const int slot = f % NS;
      if (f >= NS) {
        sm90::mbar_wait(empty + slot, ((f / NS) - 1) & 1);
        if constexpr (kMma) sm90::fence_proxy_async();  // a zero fill of the slot before the bulk copies
      }
      int t0, tend, walk, c0;
      stage_range(f / 2, t0, tend, walk, c0);
      const bool isv = f & 1;
      const unsigned char* src = static_cast<const unsigned char*>(isv ? p.v : p.k);
      const long long sh = isv ? p.v_sh : p.k_sh, sp = isv ? p.v_sp : p.k_sp, sr = isv ? p.v_sr : p.k_sr;
      auto locate = [&](int t, int& page, int& row) {
        page = kPaged ? sTable[walk * ppc + (t - c0) / p.page_size] : b;
        row = kPaged ? t % p.page_size : t;
      };
      if (lane == 0) mbar_expect_tx(full + slot, (tend - t0) * row_bytes);
      __syncwarp();
      if (t0 + lane < tend) {
        int page, row;
        locate(t0 + lane, page, row);
        bulk_copy(ring + slot * L::kSlot + lane * L::kRow,
                  src + (hk * sh + page * sp + row * sr) * (long long)sizeof(KV), row_bytes, full + slot);
        if constexpr (kQuant) {
          cp_async<4>(sScale + slot * kTok + lane, (isv ? p.vs : p.ks) + hk * p.s_sh + page * p.s_sp + row, 4);
        }
      }
      if (kMma && isv && tend - t0 < kTok) {
        const int chunks = row_bytes / 16, dead = (kTok - (tend - t0)) * chunks;
        for (int i = lane; i < dead; i += 32)
          cp_async<16>(ring + slot * L::kSlot + (tend - t0 + i / chunks) * L::kRow + (i % chunks) * 16, p.v, 0);
      }
      cp_async_mbar_arrive(full + slot);  // once this lane's copies have landed
    }
  } else {
    // A consumer warp: its slab's partial S of every token of the stage; one
    // named barrier of the consumers; the stage's S summed over the live
    // slabs in slab order and its online-softmax step (lane t: token t %
    // kTok, rows in registers, max and sum over the warp), P rounded to T into
    // the warp's own P; then acc = acc alpha + P V over the warp's slab.
    float* sS = reinterpret_cast<float*>(smem + L::kS);
    unsigned char* sP = smem + L::kP + warp * L::kPWarp;
    const int nslabs = d / kCols;
    const int tok = lane % kTok;
    const int slab_off = warp * kCols * (int)sizeof(KV);
    for (int j = 0; j < nstages; ++j) {
      int t0, tend, walk, c0;
      stage_range(j, t0, tend, walk, c0);
      const int ntok = tend - t0;
      const int fk = 2 * j, fv = 2 * j + 1, sk = fk % NS, sv = fv % NS;
      sm90::mbar_wait(full + sk, (fk / NS) & 1);
      const float ksc = kQuant ? sScale[sk * kTok + tok] : 1.f;
      float* sSb = sS + (j & 1) * kWConsumers * kMaxG * kTok;
      const unsigned char* sK = ring + sk * L::kSlot + slab_off;
      if (slab_live) {
        if constexpr (kMma) {
          // S^T for each 16-token tile: tokens 16 mt + fg (+ 8), q rows 2 fc,
          // 2 fc + 1.  A 16-bit K's A fragments by ldmatrix (matrix i: tokens
          // 8 (i % 2) .., columns 8 (i / 2) ..); an 8-bit K's from its bytes.
#pragma unroll
          for (int mt = 0; mt < kTok / 16; ++mt) {
            float acc_s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // even and odd k-steps
#pragma unroll
            for (int ks = 0; ks < kKs; ++ks) {
              uint32_t a[4];
              if constexpr (kQuant) {
                const int r = mt * 16 + fg, at = ks * 16 + 4 * fc;
                a_frag<T, KV>(sK + r * L::kRow + at, a[0], a[2]);
                a_frag<T, KV>(sK + (r + 8) * L::kRow + at, a[1], a[3]);
              } else {
                const int r = mt * 16 + ((lane / 8) % 2) * 8 + lane % 8, col = ks * 16 + (lane / 16) * 8;
                ldsm_x4<false>(a, smem_u32(sK + r * L::kRow + col * 2));
              }
              mma16<T>(acc_s[ks % 2], a, qb[ks]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (2 * fc + h < kMaxG) {
                sSb[(warp * kMaxG + 2 * fc + h) * kTok + mt * 16 + fg] = acc_s[0][h] + acc_s[1][h];
                sSb[(warp * kMaxG + 2 * fc + h) * kTok + mt * 16 + fg + 8] = acc_s[0][2 + h] + acc_s[1][2 + h];
              }
            }
          }
        } else {
          // kTokPass tokens a pass, kLanes lanes each, reduce-scattered over
          // the q rows
#pragma unroll
          for (int ps = 0; ps < kTok / kTokPass; ++ps) {
            const int t = ps * kTokPass + tp;
            float kf[8];
            load8<KV>(reinterpret_cast<const KV*>(sK + t * L::kRow) + qj * 8, kf);
            float s[kMaxG];
#pragma unroll
            for (int g = 0; g < kMaxG; ++g) {
              s[g] = 0.f;
#pragma unroll
              for (int e = 0; e < 8; ++e) s[g] = fmaf(q[g][e], kf[e], s[g]);
            }
            const float r = reduce_scatter<kMaxG, kLanes>(s, qj);
            if (qj < kMaxG) sSb[(warp * kMaxG + rs_row<kMaxG>(qj)) * kTok + t] = r;
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + sk);  // K's slot is free
      sm90::named_bar_sync(1, kWConsumers * 32);     // every slab's partial S is in

      sm90::mbar_wait(full + sv, (fv / NS) & 1);
      const float vsc = kQuant ? sScale[sv * kTok + tok] : 1.f;
      const bool valid = lane < kTok && tok < ntok;
      // every row's step side by side: the slabs' partials (in slab order),
      // the row maxima, the exponentials, the row sums, each one chain for all
      // rows
      float sc[kMaxG], mx[kMaxG], pe[kMaxG], alpha[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) sc[g] = sSb[g * kTok + tok];
#pragma unroll
      for (int w = 1; w < kWConsumers; ++w)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (w < nslabs) sc[g] += sSb[(w * kMaxG + g) * kTok + tok];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float x = sc[g] * p.score_scale;
        if constexpr (kQuant) x *= ksc;
        sc[g] = valid ? x : -CUDART_INF_F;
        mx[g] = sc[g];
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(kFull, mx[g], off));
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        const float m_new = fmaxf(m_run[g], mx[g]);  // finite: the stage holds a live token
        alpha[g] = expf(m_run[g] - m_new);            // 0 while m_run is -inf
        pe[g] = valid ? expf(sc[g] - m_new) : 0.f;
        m_run[g] = m_new;
        const float pv = valid ? pe[g] * vsc : 0.f;
        if (lane < kTok) {
          if constexpr (kMma) reinterpret_cast<T*>(sP)[g * L::kPRow + tok] = from_float<T>(pv);
          else reinterpret_cast<float*>(sP)[tok * kMaxG + g] = round_to<T>(pv);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) pe[g] += __shfl_xor_sync(kFull, pe[g], off);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) l_run[g] = l_run[g] * alpha[g] + pe[g];
      __syncwarp();
      const unsigned char* sV = ring + sv * L::kSlot + slab_off;
      if (slab_live) {
        if constexpr (kMma) {
          // O^T += V^T P^T over the stage's live 16-token k-steps: P^T's B
          // fragments from the warp's P (q row fg, tokens 2 fc, 2 fc + 1 and
          // + 8).  A 16-bit V's A fragments by ldmatrix.trans (matrix i:
          // tokens 8 (i / 2) .., columns 8 (i % 2) ..).  An 8-bit V's from its
          // bytes, two m-tiles at a time: lane (fg, fc) reads columns 4 fg ..
          // 4 fg + 3 of the pair's 32 of tokens 2 fc, 2 fc + 1, 2 fc + 8, 2 fc
          // + 9, and the pair's fragment rows fg, fg + 8 stand for columns
          // 4 fg, 4 fg + 1 (first m-tile) and 4 fg + 2, 4 fg + 3 (second).
          float alo = 1.f, ahi = 1.f;  // alpha of q rows 2 fc, 2 fc + 1
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g == 2 * fc) alo = alpha[g];
            if (g == 2 * fc + 1) ahi = alpha[g];
          }
#pragma unroll
          for (int mt = 0; mt < kKs; ++mt) {
            acc[mt][0] *= alo;
            acc[mt][1] *= ahi;
            acc[mt][2] *= alo;
            acc[mt][3] *= ahi;
          }
          const T* pt = reinterpret_cast<const T*>(sP) + fg * L::kPRow + 2 * fc;
#pragma unroll
          for (int kk = 0; kk < kTok / 16; ++kk) {
            if (kk * 16 < ntok) {
              const uint32_t pb[2] = {*reinterpret_cast<const uint32_t*>(pt + kk * 16),
                                      *reinterpret_cast<const uint32_t*>(pt + kk * 16 + 8)};
              if constexpr (kQuant) {
#pragma unroll
                for (int mp = 0; mp < kKs / 2; ++mp) {
                  uint32_t w[4];
#pragma unroll
                  for (int i = 0; i < 4; ++i) {
                    const int t = kk * 16 + 2 * fc + (i % 2) + (i / 2) * 8;
                    w[i] = *reinterpret_cast<const uint32_t*>(sV + t * L::kRow + mp * 32 + 4 * fg);
                  }
                  uint32_t a0[4], a1[4];  // the pair's two m-tiles
                  cvt4<T, KV>(__byte_perm(w[0], w[1], 0x5140), a0[0], a0[1]);
                  cvt4<T, KV>(__byte_perm(w[0], w[1], 0x7362), a1[0], a1[1]);
                  cvt4<T, KV>(__byte_perm(w[2], w[3], 0x5140), a0[2], a0[3]);
                  cvt4<T, KV>(__byte_perm(w[2], w[3], 0x7362), a1[2], a1[3]);
                  mma16<T>(acc[2 * mp], a0, pb);
                  mma16<T>(acc[2 * mp + 1], a1, pb);
                }
              } else {
                const int t = kk * 16 + (lane / 16) * 8 + lane % 8;
#pragma unroll
                for (int mt = 0; mt < kKs; ++mt) {
                  uint32_t a[4];
                  ldsm_x4<true>(a, smem_u32(sV + t * L::kRow + (mt * 16 + ((lane / 8) % 2) * 8) * 2));
                  mma16<T>(acc[mt], a, pb);
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (alpha[g] != 1.f) {
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[g][e] *= alpha[g];
            }
          }
          const float* pf = reinterpret_cast<const float*>(sP);
#pragma unroll
          for (int i = 0; i < kTok / kTokPass; ++i) {
            const int t = tp + i * kTokPass;
            if (t < ntok) {  // rows past the live end were not copied
              float vf[8];
              load8<KV>(reinterpret_cast<const KV*>(sV + t * L::kRow) + qj * 8, vf);
              float pr[kMaxG];
#pragma unroll
              for (int g = 0; g < kMaxG; g += 4) {
                if constexpr (kMaxG % 4 == 0) {
                  const float4 x = *reinterpret_cast<const float4*>(pf + t * kMaxG + g);
                  pr[g] = x.x; pr[g + 1] = x.y; pr[g + 2] = x.z; pr[g + 3] = x.w;
                } else {
                  pr[g] = pf[t * kMaxG + g];
                }
              }
#pragma unroll
              for (int g = 0; g < kMaxG; ++g)
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr[g], vf[e], acc[g][e]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + sv);  // V's slot is free
    }
    if constexpr (!kMma) {  // the warp's token subsets summed
#pragma unroll
      for (int off = kLanes; off < 32; off *= 2)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], off);
    }
  }
  __syncthreads();  // the ring is free: the block's state goes over it

  // The block's state: each live slab's acc, and warp 0's m and l (every
  // consumer warp holds the same).
  float* state = reinterpret_cast<float*>(smem);
  float* state_m = reinterpret_cast<float*>(smem + L::kStateM);
  float* state_l = reinterpret_cast<float*>(smem + L::kStateL);
  if (slab_live) {
    float* slab = state + warp * kCols;
    if constexpr (kMma) {
#pragma unroll
      for (int mt = 0; mt < kKs; ++mt) {
        // the fragment rows' columns: fg and fg + 8 of the m-tile, or (an
        // 8-bit V) 4 fg (+ 1) and 4 fg + 2 (+ 3) of the m-tile pair
        const int c_lo = kQuant ? (mt / 2) * 32 + 4 * fg + 2 * (mt % 2) : mt * 16 + fg;
        const int c_hi = kQuant ? c_lo + 1 : c_lo + 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * fc + h < kMaxG) {
            slab[(2 * fc + h) * D + c_lo] = acc[mt][h];
            slab[(2 * fc + h) * D + c_hi] = acc[mt][2 + h];
          }
        }
      }
    } else if (tp == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float* dst = slab + g * D + qj * 8;
        *reinterpret_cast<float4*>(dst) = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (lane == g) {
        state_m[g] = m_run[g];
        state_l[g] = l_run[g];
      }
    }
  }

  // Every block's state is in: merge them over the cluster and write the
  // output's first d columns.
  cluster_merge<T, kWThreads, D>(state, state_m, state_l, reinterpret_cast<float*>(smem + L::kWeights),
                                 reinterpret_cast<float*>(smem + L::kSums), G, d, C, rank, tid,
                                 static_cast<T*>(p.o) + b * p.o_sb + ((long long)hk * p.group + g0) * p.o_sh,
                                 p.o_sh);
}

template <typename T, typename KV, int D, int kMaxG, bool kPaged>
cudaError_t wide_launch_one(const WideParams& p, int cluster, dim3 grid, cudaStream_t s, int* resident) {
  return cluster_launch<WideParams, wide_kernel<T, KV, D, kMaxG, kPaged>, kWThreads,
                        WideLayout<T, KV, D, kMaxG>::kBytes>(p, cluster, grid, s, resident);
}

// The q-row capacity (kMaxG) of a pass of `pass_rows` q heads: 1, 4 or 8;
// then the payload (kv_dtype 0 = q's dtype, 1 = int8, 2 = fp8 e4m3).  The
// sources decode_wide_<q dtype>_d<D>_<k5|k6>.cu instantiate
// wide_launch_width for their (q dtype, D, K5 or K6); decode.cu declares
// them extern.
template <typename T, typename KV, int D, bool kPaged>
cudaError_t wide_launch_rows(const WideParams& p, int cluster, dim3 grid, cudaStream_t s, int* resident) {
  if (p.pass_rows == 1) return wide_launch_one<T, KV, D, 1, kPaged>(p, cluster, grid, s, resident);
  if (p.pass_rows <= 4) return wide_launch_one<T, KV, D, 4, kPaged>(p, cluster, grid, s, resident);
  if (p.pass_rows <= kWMaxRows) return wide_launch_one<T, KV, D, 8, kPaged>(p, cluster, grid, s, resident);
  return cudaErrorInvalidValue;
}

template <typename T, int D, bool kPaged>
cudaError_t wide_launch_width(const WideParams& p, int kv_dtype, int cluster, dim3 grid, cudaStream_t s,
                              int* resident) {
  if (kv_dtype == 0) return wide_launch_rows<T, T, D, kPaged>(p, cluster, grid, s, resident);
  if (kv_dtype == 1) return wide_launch_rows<T, int8_t, D, kPaged>(p, cluster, grid, s, resident);
  if (kv_dtype == 2) return wide_launch_rows<T, __nv_fp8_e4m3, D, kPaged>(p, cluster, grid, s, resident);
  return cudaErrorInvalidValue;
}

#define FA_WIDE_ALL(X)                                                                                 \
  X(float, 512, true) X(float, 512, false) X(float, 1024, true) X(float, 1024, false)                  \
  X(__nv_bfloat16, 512, true) X(__nv_bfloat16, 512, false) X(__nv_bfloat16, 1024, true)               \
  X(__nv_bfloat16, 1024, false) X(__half, 512, true) X(__half, 512, false) X(__half, 1024, true)      \
  X(__half, 1024, false)

}  // namespace decode
}  // namespace fa
