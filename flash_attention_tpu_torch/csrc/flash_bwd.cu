// FlashAttention backward for Hopper (sm_90a): a di/qs pre-pass, dK/dV and
// dQ, with a plain C interface loaded through ctypes
// (flash_attention_tpu_torch/kernels/_build.py).
//
// Replaces, in flash_attention_tpu/kernels/flash_attention.py:
//   * fa_flash_bwd_dkv (K2): _dkv_kernel (:637, launched by _bwd_dkv :890
//     through pl.pallas_call :921 / :963): dV = P^T dO and dK = dS^T q scale
//     with dS = P o (dO V^T - di), the KV tile pinned and the q tiles
//     iterated;
//   * fa_flash_bwd_dq (K3): _dq_kernel (:765, launched by _bwd_dq :995
//     through :1014 / :1060): dQ = dS k scale, the q tile pinned and the KV
//     tiles iterated;
//   * fa_flash_bwd_prep, the pre-pass: no Pallas kernel, but the expressions
//     the JAX package leaves to XLA around those two: di = rowsum(o * dO) -
//     dlse in fp32 (_flash_bwd_rule :1112, _flash_lse_bwd_rule :1142-1143)
//     and qs = q * sm_scale * log2(e) rounded to q's dtype, which
//     _recompute_p (:608) makes on every tile.  One pass over q, o and dO
//     writes both, once per backward instead of once per (KV block, q tile).
//
// Arithmetic, as on the TPU: P = exp2(qs K^T - lse * log2(e)) with the
// forward's qs (flash_fwd.cuh rounds q the same way), so P is K1's P; P = 0
// where masked, so a query row that sees no key (lse = -inf) gives no NaN;
// P is rounded to dO's dtype before P^T dO; dS is rounded to the inputs'
// dtype before dS^T q and dS k; every sum is fp32.  sm_scale is applied to
// the fp32 dK and dQ at the store (dK = scale * sum dS^T q, dQ = scale *
// sum dS k) instead of to rounded q * scale and k * scale operands: at head
// dim 64 (sm_scale = 2^-3, GPT-2's case) both forms give the same bits; at
// 128 the store form skips one rounding of each operand, inside the 16-bit
// tier either way.  The plain versions (kernels/flash_attention.py) keep the
// TPU's operand form.
//
// On the TPU the grid ran in order and carried dK/dV (or dQ) in scratch from
// one step to the next.  On Hopper blocks run in parallel, so the loop moves
// inside the block and the sums stay in registers.  Two kernels keep the
// result deterministic: dK/dV blocks own KV rows and dQ blocks own q rows,
// so nothing is summed across blocks.
//
// What bounds it on this card: K2 does four products of the forward's size
// (S^T, dP^T, dV, dK) and K3 three (S, dP, dQ), each recomputing P, on the
// forward's bytes plus dO and qs: at b8 h12 L1024 D64 causal 25.8 and 19.3
// GFLOP (0.026 and 0.020 ms at 989 TFLOP/s) against 76 and 64 MB (0.023 and
// 0.019 ms at 3.35 TB/s; K2's function needs q or qs, not both), so both are
// bound by their operations, K3 barely, and more so at any larger head dim
// or sequence.  The pre-pass is bound by its bytes: q, o,
// dO read and qs, di written, 51 MB (0.015 ms).  What feeds the tensor
// cores at their rate is wgmma fed by TMA, so the bf16 / fp16 kernels are
// warp-specialised, as K1 is (flash_fwd.cuh):
//   * one producer warpgroup: one thread issues TMA loads (4-D maps, so rows
//     past Lq or Lk read as zero) into a ring of shared-memory slots, each
//     with a "full" and an "empty" mbarrier;
//   * two consumer warpgroups of 64 pinned rows each (128 a block), every
//     product a wgmma; setmaxnreg hands the producer's registers (24) to the
//     consumers (240);
//   * K3 (dQ) is K1's pipeline plus one product.  A warpgroup pins 64 rows of
//     qs and dO (loaded once); the ring streams 64-row K/V tiles.  Per tile:
//     S = qs K^T and dP = dO V^T (SS, both K-major), dS = P o (dP - di) on
//     the accumulators' registers (lse and di are per-row registers), dQ +=
//     dS K (RS: dS from registers as K1's P, K the MN-major B operand as K1's
//     V).  Blocks are issued longest causal KV loop first;
//   * K2 (dK/dV) is the mirror.  A warpgroup pins 64 rows of K and V (loaded
//     once, never re-read per tile); the ring streams 64-row (qs, q, dO)
//     tiles of every q head of the GQA group in turn, so the group sums into
//     its KV head inside the block, with no atomics.  Per tile: S^T = K qs^T
//     and dP^T = V dO^T (SS), P^T = exp2(S^T - lse log2 e), dS^T = P^T o
//     (dP^T - di), dV += P^T dO and dK += dS^T q (RS, dO and q MN-major).
//     The producer stages each q tile's lse * log2(e), di and segment ids
//     into the slot with plain loads: a [B * H, Lq] fp32 row breaks TMA's
//     16-byte stride rule for most Lq.  KV tile 0 has the longest causal q
//     loop and is issued first.  At D = 128 the block walks its q tiles
//     twice, dV first and dK second (DkvCfg::kPasses);
//   * each consumer warpgroup has its own tile range (causal rule, window);
//     the producer loads the union and a warpgroup waits on and releases the
//     tiles it skips, so the barrier counts always match.  Only tiles that
//     cross the diagonal, the window edge or a ragged end, or carry segment
//     ids, pay for the element mask: two compares against each pinned row's
//     visible range;
//   * every wgmma operand (descriptors, register fragments) is computed and
//     pinned (sm90::fence_regs) before wgmma.fence, every branch around a
//     wgmma is uniform by construction, and each product is waited for
//     before its accumulator is read, else ptxas serialises them all (a
//     version that computed P while dP ran did just that).
// fp32 inputs take a SIMT path (one thread per pinned row, fp32 FMA), since
// TF32 tensor cores would miss the fp32 backward tolerance of 1e-4.
// Registers: ptxas does not allocate the consumers what setmaxnreg grants.
// K2 in one pass at D = 128 needs about 210 a thread (dK and dV 128, S^T
// and dP^T 64): built so, it spilled with the consumers granted 240 or 208
// alike and ran slower than in two passes (scratch builds; a one-warp
// producer, 288 threads, did not help either).  ptxas -v (sm_90a, CUDA 12.8):
// every warp-specialised instantiation 168 registers at launch, no C7518
// (wgmma serialisation); spills: K3 none, K2 8 bytes at D = 64 and 20 at
// D = 128; the pre-pass 28 registers, none.  The SIMT dK/dV keeps 2 x D
// fp32 sums a thread and spills at D = 128 (255 registers, 168 bytes); its
// dQ uses 127 / 166 registers without spills.
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry points return cudaGetLastError() so that the wrapper can raise (and
// cudaErrorInvalidValue when a tensor map cannot be made).

#include "common.cuh"
#include "flash_d256.cuh"
#include "sm90.cuh"

namespace {

using namespace fa;

struct Strides {
  long long sb, sh, sl;
};

struct BwdParams {
  const void* q;
  const void* qs;     // bf16 / fp16: the pre-pass's qs, [batch, hq, lq, D] contiguous
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // [batch, hq, lq] contiguous
  const float* di;    // [batch, hq, lq] contiguous
  const int* q_ids;   // [batch, lq] contiguous segment ids, or null
  const int* kv_ids;  // [batch, lk], null exactly when q_ids is
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int batch, hq, group;
  Mask mask;
  float scale_log2;  // sm_scale * log2(e)
  float scale;       // sm_scale
};

// ---------------------------------------------------------------------------
// The pre-pass: di = rowsum(o * dO) - dlse and qs = round_T(q * scale_log2)
// ---------------------------------------------------------------------------

struct PrepParams {
  const void* q;
  const void* o;
  const void* dout;
  const float* dlse;  // [batch, hq, lq] contiguous, or null
  void* qs;           // [batch, hq, lq, D] contiguous, or null (fp32)
  float* di;          // [batch, hq, lq] contiguous
  Strides sq, so, sdo;
  int hq, lq;
  long long rows;     // batch * hq * lq
  float scale_log2;
};

// min(D / (16 / sizeof(T)), 32) threads a row, each kChunks 16-byte chunks
// of q, o and dO (one, except fp32 at D = 256: two).
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const PrepParams p) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = D / kVec < 32 ? D / kVec : 32;  // 8, 16 or 32: a divisor of 32
  constexpr int kChunks = D / kVec / kLanes;
  constexpr int kRows = 256 / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / kLanes;
  const bool in = row < p.rows;  // the same for a row's lanes, which share a warp
  const long long bh = in ? row / p.lq : 0;
  const long long r = in ? row % p.lq : 0;
  const long long b = bh / p.hq, h = bh % p.hq;
  float sum = 0.f;
  if (in) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * kLanes + lane) * kVec;
      const T* o = static_cast<const T*>(p.o) + b * p.so.sb + h * p.so.sh + r * p.so.sl + col;
      const T* dout = static_cast<const T*>(p.dout) + b * p.sdo.sb + h * p.sdo.sh + r * p.sdo.sl + col;
      const uint4 ov = *reinterpret_cast<const uint4*>(o);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout);
      const T* x = reinterpret_cast<const T*>(&ov);
      const T* y = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum = fmaf(to_float(x[e]), to_float(y[e]), sum);
      if (p.qs != nullptr) {
        const T* q = static_cast<const T*>(p.q) + b * p.sq.sb + h * p.sq.sh + r * p.sq.sl + col;
        uint4 qv = *reinterpret_cast<const uint4*>(q);
        T* z = reinterpret_cast<T*>(&qv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) z[e] = from_float<T>(to_float(z[e]) * p.scale_log2);
        *reinterpret_cast<uint4*>(static_cast<T*>(p.qs) + row * D + col) = qv;
      }
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (in && lane == 0) p.di[row] = sum - (p.dlse != nullptr ? p.dlse[row] : 0.f);
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the warp-specialised TMA + wgmma kernels
// ---------------------------------------------------------------------------

// What the two kernels share.  kernels/block_sizes.py mirrors these
// constants and both layouts below (backward_smem_bytes).
template <int D>
struct BwdWs {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static constexpr int kConsumers = 2;              // consumer warpgroups, 64 pinned rows each
  static constexpr int kPinned = 64 * kConsumers;   // K2: KV rows, K3: q rows of a block
  static constexpr int kStream = 64;                // rows of each streamed tile
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPinnedBytes = kPinned * D * 2;  // one pinned operand
  static constexpr int kTileBytes = kStream * D * 2;    // one streamed operand in one slot
  // setmaxnreg: 128 x 24 + 256 x 240 = 65,536 registers.
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
};

// K3: qs and dO pinned; the ring's K and V slots; the KV segment ids of each
// slot; the barriers; + 1024 to align the base for the 128-byte swizzle.
template <int D>
struct DqCfg : BwdWs<D> {
  using W = BwdWs<D>;
  static constexpr int kStages = 4;
  static constexpr int kOffDo = W::kPinnedBytes;  // qs at 0
  static constexpr int kOffK = 2 * W::kPinnedBytes;
  static constexpr int kOffV = kOffK + kStages * W::kTileBytes;
  static constexpr int kOffIds = kOffV + kStages * W::kTileBytes;
  static constexpr int kOffBars = kOffIds + kStages * W::kStream * 4;
  static constexpr int kBars = 1 + 2 * kStages;  // q; full and empty per slot
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
};

// K2: K and V pinned; the ring's qs, q and dO slots; per slot the q rows'
// lse * log2(e), di and segment ids; the barriers; the alignment slack.
template <int D>
struct DkvCfg : BwdWs<D> {
  using W = BwdWs<D>;
  // At D = 128 a consumer thread cannot hold dK and dV (128 registers) with
  // S^T and dP^T (64) without spilling: the block walks its q tiles twice,
  // dV in the first pass (S^T, P^T, dV += P^T dO; no q tile loaded) and dK
  // in the second (S^T, dP^T, dS^T, dK += dS^T q), five products a tile
  // pair instead of four.
  static constexpr int kPasses = D == 64 ? 1 : 2;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kOffV = W::kPinnedBytes;  // K at 0
  static constexpr int kOffQs = 2 * W::kPinnedBytes;
  static constexpr int kOffQ = kOffQs + kStages * W::kTileBytes;
  static constexpr int kOffDo = kOffQ + kStages * W::kTileBytes;
  static constexpr int kOffStats = kOffDo + kStages * W::kTileBytes;
  static constexpr int kStatBytes = 3 * W::kStream * 4;
  static constexpr int kOffBars = kOffStats + kStages * kStatBytes;
  static constexpr int kBars = 1 + 2 * kStages;  // K/V; full and empty per slot
  static constexpr int kSmemBytes = kOffBars + kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "an H100 block has at most 227 KB of shared memory");
};

struct BwdMaps {
  CUtensorMap qs, q, dout, k, v;  // K3 does not read q
};

// Descriptor of k16 step kk of a K-major operand: the 64 rows from `row0` of
// a [rows, D] tile stored as TMA's 128-byte swizzle writes it (64-column
// blocks one after the other, `rows` rows of 128 bytes each).  A step moves
// 32 bytes along a row, every fourth one to the next 64-column block.
template <typename T>
__device__ __forceinline__ uint64_t desc_k(const T* tile, int rows, int row0, int kk) {
  return sm90::smem_desc(tile + (kk / 4) * rows * 64 + row0 * 64 + (kk % 4) * 16, 16, 1024);
}

// Descriptor of k16 step kk of an MN-major B operand, a [rows, D] tile read
// as [K = rows, N = D]: a step moves 16 rows (2 KB) down its 64-column
// blocks, which lie rows * 128 bytes apart.
template <typename T>
__device__ __forceinline__ uint64_t desc_mn(const T* tile, int rows, int kk) {
  return sm90::smem_desc(tile + kk * 16 * 64, rows * 128, 1024);
}

// k16 steps of an SS product committed together: one 64-column block of the
// head dim, so that a group's descriptors take 16 registers a thread at any
// head dim (K2 at D = 128 has none to spare).
constexpr int kSsGroupSteps = 4;

// Issue d = A B^T over the head dim (SS form, both operands K-major): A the
// 64 rows from `a_row0` of the [a_rows, D] tile `a`, B the [N, D] tile `b`.
// Committed in groups of kSsGroupSteps steps; the caller waits.
template <typename T, int D, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], const T* a, int a_rows, int a_row0, const T* b) {
  constexpr int kG = kSsGroupSteps < D / 16 ? kSsGroupSteps : D / 16;
#pragma unroll
  for (int k0 = 0; k0 < D / 16; k0 += kG) {
    uint64_t da[kG], db[kG];
#pragma unroll
    for (int kk = 0; kk < kG; ++kk) {
      da[kk] = desc_k(a, a_rows, a_row0, k0 + kk);
      db[kk] = desc_k(b, N, 0, k0 + kk);
    }
    sm90::fence_regs(da);
    sm90::fence_regs(db);
    sm90::fence_regs(d);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kG; ++kk) sm90::wgmma_ss<T, N>(d, da[kk], db[kk], k0 + kk > 0);
    sm90::wgmma_commit();
  }
}

// Issue d += A B (RS form): A [64, K] in registers (`a`, the A fragments of
// an accumulator), B the [K, D] tile `b` read MN-major.  Committed as one
// group; the caller waits.
template <typename T, int D, int K>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2], uint32_t (&a)[K / 16][4], const T* b) {
  uint64_t db[K / 16];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) db[kk] = desc_mn(b, K, kk);
  sm90::fence_regs(a);
  sm90::fence_regs(db);
  sm90::fence_regs(d);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) sm90::wgmma_rs<T, D>(d, a[kk], db[kk]);
  sm90::wgmma_commit();
}

// issue_rs for two products in one group: a wgmma reads its A registers
// until the wait, so nothing may be computed between the two issues.
template <typename T, int D, int K>
__device__ __forceinline__ void issue_rs2(float (&d1)[D / 2], uint32_t (&a1)[K / 16][4], const T* b1,
                                          float (&d2)[D / 2], uint32_t (&a2)[K / 16][4], const T* b2) {
  uint64_t db1[K / 16], db2[K / 16];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    db1[kk] = desc_mn(b1, K, kk);
    db2[kk] = desc_mn(b2, K, kk);
  }
  sm90::fence_regs(a1);
  sm90::fence_regs(a2);
  sm90::fence_regs(db1);
  sm90::fence_regs(db2);
  sm90::fence_regs(d1);
  sm90::fence_regs(d2);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) sm90::wgmma_rs<T, D>(d1, a1[kk], db1[kk]);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) sm90::wgmma_rs<T, D>(d2, a2[kk], db2[kk]);
  sm90::wgmma_commit();
}

// An [64, N] fp32 accumulator as the A fragments of N / 16 k16 steps,
// rounded to T: its 8-column blocks 2kk and 2kk + 1 are step kk.
template <typename T, int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = Pack<T>::two(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = Pack<T>::two(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = Pack<T>::two(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = Pack<T>::two(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Store a warpgroup's [64, D] fp32 accumulator times `scale` as T: this
// thread's rows row_a and row_a + 8 that lie below n.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* base, long long ld, const float (&acc)[D / 2], float scale, int row_a,
                                          int n, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n) continue;
    T* dst = base + (long long)row * ld + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) =
          Pack<T>::two(acc[4 * nd + 2 * r] * scale, acc[4 * nd + 2 * r + 1] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BwdWs<D>::kThreads, 1)
flash_bwd_dq_ws_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps maps) {
  using C = DqCfg<D>;
  constexpr int kBr = C::kPinned, kBc = C::kStream, kS = C::kStages;
  constexpr int kTile = kBc * D;  // elements of a K or V slot

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  T* sQs = reinterpret_cast<T*>(smem);
  T* sDo = reinterpret_cast<T*>(smem + C::kOffDo);
  T* sK = reinterpret_cast<T*>(smem + C::kOffK);  // kS slots
  T* sV = reinterpret_cast<T*>(smem + C::kOffV);
  int* sIds = reinterpret_cast<int*>(smem + C::kOffIds);  // kS x kBc KV segment ids
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full = q_full + 1;  // slot s holds its K/V tile
  uint64_t* empty = full + kS;  // every consumer warpgroup is done with slot s

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
  // With segment ids every producer thread stages one and arrives on "full".
  const bool all_produce = kv_ids != nullptr;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], all_produce ? 128 : 1);
      sm90::mbar_init(&empty[s], 128 * C::kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup's index broadcast from lane 0, so that ptxas sees every
  // branch on it (and on values made from it) as uniform.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---------------- producer warpgroup ----------------
    sm90::reg_dealloc<C::kProducerRegs>();
    if (!all_produce && tid != 0) return;
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(q_full, 2 * C::kPinnedBytes);
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(sQs + c * kBr * 64, &maps.qs, q_full, c * 64, r0, h, b);
        sm90::tma_load_4d(sDo + c * kBr * 64, &maps.dout, q_full, c * 64, r0, h, b);
      }
    }
    for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
      const int s = it % kS;
      sm90::mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
      if (kv_ids != nullptr && tid < kBc) sIds[s * kBc + tid] = j * kBc + tid < mk.lk ? kv_ids[j * kBc + tid] : -1;
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
    return;
  }

  // ---------------- consumer warpgroups ----------------
  sm90::reg_alloc<C::kConsumerRegs>();
  const int cw = wg - 1;  // this warpgroup's 64 q rows of the block
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
    lse2[r] = in ? p.lse[stat + row] * kLog2e : 0.f;
    di[r] = in ? p.di[stat + row] : 0.f;
    if (p.q_ids != nullptr && in) q_id[r] = p.q_ids[(long long)b * mk.lq + row];
  }
  sm90::mbar_wait(q_full, 0);

  float acc[D / 2];
  float sc[kBc / 2], dp[kBc / 2];  // S and dP: [64, kBc] as kBc / 8 blocks of 8 columns x 4 registers
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBc / 2; ++i) sc[i] = dp[i] = 0.f;

  for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
    const int s = it % kS;
    sm90::mbar_wait(&full[s], (it / kS) & 1);
    if (j >= my_lo && j < my_hi) {
      const T* k_s = sK + s * kTile;
      const T* v_s = sV + s * kTile;
      const int c0 = j * kBc;
      // S = qs K^T and dP = dO V^T
      issue_ss<T, D, kBc>(sc, sQs, kBr, 64 * cw, k_s);
      issue_ss<T, D, kBc>(dp, sDo, kBr, 64 * cw, v_s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // P = exp2(S - lse log2 e), 0 where masked; dS = P (dP - di) in dp.
      const bool masked = kv_ids != nullptr || !mk.tile_visible(wr0, 64, c0, kBc);
      const int* ids = sIds + s * kBc;
#pragma unroll
      for (int nb = 0; nb < kBc / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int cl = nb * 8 + 2 * t + (e & 1);
          bool ok = true;
          if (masked) {
            ok = c0 + cl >= lo[r] && c0 + cl <= hi[r];
            if (kv_ids != nullptr) ok = ok && q_id[r] == ids[cl];
          }
          const float pr = ok ? exp2_ftz(sc[4 * nb + e] - lse2[r]) : 0.f;
          dp[4 * nb + e] = pr * (dp[4 * nb + e] - di[r]);
        }

      // dQ += dS K, dS rounded to T
      uint32_t dsa[kBc / 16][4];
      to_a_frags<T, kBc>(dsa, dp);
      issue_rs<T, D, kBc>(acc, dsa, k_s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(&empty[s]);
  }
  if (!active) return;
  store_acc<T, D>(static_cast<T*>(p.dq) + b * p.sdq.sb + h * p.sdq.sh, p.sdq.sl, acc, p.scale, row_a, mk.lq, t);
}

template <typename T, int D>
__global__ void __launch_bounds__(BwdWs<D>::kThreads, 1)
flash_bwd_dkv_ws_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps maps) {
  using C = DkvCfg<D>;
  constexpr int kBr = C::kPinned, kBq = C::kStream, kS = C::kStages;
  constexpr int kTile = kBq * D;  // elements of a qs, q or dO slot
  static_assert(kBq <= 128, "one producer thread stages each q row's statistics");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + C::kOffV);
  T* sQs = reinterpret_cast<T*>(smem + C::kOffQs);  // kS slots each
  T* sQ = reinterpret_cast<T*>(smem + C::kOffQ);
  T* sDo = reinterpret_cast<T*>(smem + C::kOffDo);
  float* sStats = reinterpret_cast<float*>(smem + C::kOffStats);  // per slot: lse2, di, ids (int)
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kOffBars);
  uint64_t* full = kv_full + 1;  // slot s holds its q tile
  uint64_t* empty = full + kS;   // every consumer warpgroup is done with slot s

  const Mask mk = p.mask;
  const int hkv = p.hq / p.group;
  const int b = blockIdx.y / hkv;
  const int hk = blockIdx.y % hkv;
  const int c0 = blockIdx.x * kBr;  // KV tile 0 has the longest causal q loop: issued first
  const int c1 = min(c0 + kBr, mk.lk);
  // The block's q tiles [i_lo, i_hi) for each head of the group: the union
  // of its warpgroups' ranges.
  const int i_lo = mk.q_first(c0) / kBq;
  const int q_end = mk.q_end(c1);
  const int i_hi = q_end > 0 ? (q_end + kBq - 1) / kBq : 0;
  const int* q_ids = p.q_ids ? p.q_ids + (long long)b * mk.lq : nullptr;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], 128);  // the TMA thread's and the statistics' arrivals
      sm90::mbar_init(&empty[s], 128 * C::kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---------------- producer warpgroup ----------------
    sm90::reg_dealloc<C::kProducerRegs>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(kv_full, 2 * C::kPinnedBytes);
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(sK + c * kBr * 64, &maps.k, kv_full, c * 64, c0, hk, b);
        sm90::tma_load_4d(sV + c * kBr * 64, &maps.v, kv_full, c * 64, c0, hk, b);
      }
    }
    int n = 0;  // tiles issued
    for (int pass = 0; pass < C::kPasses; ++pass) {
      const bool dk_pass = C::kPasses == 1 || pass == 1;  // the q tile is dK's B operand
      for (int gi = 0; gi < p.group; ++gi) {
        const int h = hk * p.group + gi;
        const long long stat = ((long long)b * p.hq + h) * mk.lq;
        for (int i = i_lo; i < i_hi; ++i, ++n) {
          const int s = n % kS;
          sm90::mbar_wait(&empty[s], ((n / kS) & 1) ^ 1);
          if (tid < kBq) {
            const int row = i * kBq + tid;
            const bool in = row < mk.lq;
            float* st = sStats + s * 3 * kBq;
            st[tid] = in ? p.lse[stat + row] * kLog2e : 0.f;
            st[kBq + tid] = in ? p.di[stat + row] : 0.f;
            reinterpret_cast<int*>(st)[2 * kBq + tid] = q_ids != nullptr && in ? q_ids[row] : -1;
          }
          if (tid == 0) {
            sm90::mbar_arrive_expect_tx(&full[s], (dk_pass ? 3 : 2) * C::kTileBytes);
            for (int c = 0; c < D / 64; ++c) {
              const int off = s * kTile + c * kBq * 64;
              sm90::tma_load_4d(sQs + off, &maps.qs, &full[s], c * 64, i * kBq, h, b);
              if (dk_pass) sm90::tma_load_4d(sQ + off, &maps.q, &full[s], c * 64, i * kBq, h, b);
              sm90::tma_load_4d(sDo + off, &maps.dout, &full[s], c * 64, i * kBq, h, b);
            }
          } else {
            sm90::mbar_arrive(&full[s]);
          }
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  sm90::reg_alloc<C::kConsumerRegs>();
  const int cw = wg - 1;  // this warpgroup's 64 KV rows of the block
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int cw0 = c0 + 64 * cw;
  const bool active = cw0 < mk.lk;
  int my_lo = 0, my_hi = 0;  // this warpgroup's q tiles, the same for each head
  if (active) {
    my_lo = mk.q_first(cw0) / kBq;
    const int end = mk.q_end(min(cw0 + 64, mk.lk));
    my_hi = end > 0 ? (end + kBq - 1) / kBq : 0;
  }
  const int row_a = cw0 + warp * 16 + g;  // this thread's KV rows: row_a, row_a + 8
  // Per KV row: the query rows [lo, hi] that see it (Mask::visible; empty
  // past Lk) and its segment id.
  const int offset = mk.lk - mk.lq;
  int lo[2], hi[2], kv_id[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = row_a + 8 * r;
    lo[r] = 0;
    hi[r] = mk.lq - 1;
    if (c >= mk.lk) {
      lo[r] = mk.lq;
      hi[r] = -1;
    } else if (mk.causal) {
      lo[r] = max(c - offset, 0);
      if (mk.window > 0) hi[r] = min(c - offset + mk.window - 1, mk.lq - 1);
    }
    if (p.kv_ids != nullptr && c < mk.lk) kv_id[r] = p.kv_ids[(long long)b * mk.lk + c];
  }
  sm90::mbar_wait(kv_full, 0);

  // One walk over the block's q tiles, every head of the group in turn,
  // adding to dV (kDv) and dK (kDk).
  float dk[D / 2], dv[D / 2];
  int n = 0;  // tiles consumed
  auto walk = [&](auto dv_on, auto dk_on) {
    constexpr bool kDv = decltype(dv_on)::value, kDk = decltype(dk_on)::value;
    float st[kBq / 2], dpt[kBq / 2];  // S^T and dP^T: [64, kBq]
#pragma unroll
    for (int i = 0; i < kBq / 2; ++i) st[i] = dpt[i] = 0.f;
    for (int gi = 0; gi < p.group; ++gi) {
      for (int i = i_lo; i < i_hi; ++i, ++n) {
        const int s = n % kS;
        sm90::mbar_wait(&full[s], (n / kS) & 1);
        if (i >= my_lo && i < my_hi) {
          const T* qs_s = sQs + s * kTile;
          const T* do_s = sDo + s * kTile;
          const float* stats = sStats + s * 3 * kBq;
          const int* ids = reinterpret_cast<const int*>(stats + 2 * kBq);
          const int r0 = i * kBq;
          // S^T = K qs^T and dP^T = V dO^T
          issue_ss<T, D, kBq>(st, sK, kBr, 64 * cw, qs_s);
          if constexpr (kDk) issue_ss<T, D, kBq>(dpt, sV, kBr, 64 * cw, do_s);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(st);
          if constexpr (kDk) sm90::fence_regs(dpt);

          // P^T = exp2(S^T - lse log2 e), 0 where masked, in st.  Columns
          // are q rows: their lse and di come from the slot, two adjacent
          // columns at a time.
          const bool masked = q_ids != nullptr || !mk.tile_visible(r0, kBq, cw0, 64);
#pragma unroll
          for (int nb = 0; nb < kBq / 8; ++nb) {
            const int col = nb * 8 + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(stats + col);
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
              st[4 * nb + e] = ok ? exp2_ftz(st[4 * nb + e] - (x ? l2.y : l2.x)) : 0.f;
            }
          }
          // dV += P^T dO, P rounded to dO's dtype
          uint32_t pa[kBq / 16][4], dsa[kBq / 16][4];
          if constexpr (kDv) to_a_frags<T, kBq>(pa, st);
          if constexpr (kDk) {
            // dS^T = P^T (dP^T - di) in dpt
#pragma unroll
            for (int nb = 0; nb < kBq / 8; ++nb) {
              const float2 dd = *reinterpret_cast<const float2*>(stats + kBq + nb * 8 + 2 * t);
#pragma unroll
              for (int e = 0; e < 4; ++e) dpt[4 * nb + e] = st[4 * nb + e] * (dpt[4 * nb + e] - (e & 1 ? dd.y : dd.x));
            }
            to_a_frags<T, kBq>(dsa, dpt);
          }
          // dK += dS^T q, dS rounded to q's dtype
          const T* q_s = sQ + s * kTile;
          if constexpr (kDv && kDk) issue_rs2<T, D, kBq>(dv, pa, do_s, dk, dsa, q_s);
          else if constexpr (kDv) issue_rs<T, D, kBq>(dv, pa, do_s);
          else issue_rs<T, D, kBq>(dk, dsa, q_s);
          sm90::wgmma_wait<0>();
          if constexpr (kDv) sm90::fence_regs(dv);
          if constexpr (kDk) sm90::fence_regs(dk);
        }
        sm90::mbar_arrive(&empty[s]);
      }
    }
  };
  using On = std::true_type;
  using Off = std::false_type;
  T* gdk = static_cast<T*>(p.dk) + b * p.sdk.sb + hk * p.sdk.sh;
  T* gdv = static_cast<T*>(p.dv) + b * p.sdv.sb + hk * p.sdv.sh;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = 0.f;
  if constexpr (C::kPasses == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
    walk(On{}, On{});
  } else {
    walk(On{}, Off{});
    if (active) store_acc<T, D>(gdv, p.sdv.sl, dv, 1.f, row_a, mk.lk, t);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
    walk(Off{}, On{});
  }
  if (!active) return;
  store_acc<T, D>(gdk, p.sdk.sl, dk, p.scale, row_a, mk.lk, t);
  if constexpr (C::kPasses == 1) store_acc<T, D>(gdv, p.sdv.sl, dv, 1.f, row_a, mk.lk, t);
}

// ---------------------------------------------------------------------------
// fp32 path: SIMT, one thread per pinned row, fp32 FMA
// ---------------------------------------------------------------------------

template <int D>
struct BwdSimtCfg {
  static constexpr int kBr = 64;  // pinned rows, one per thread
  static constexpr int kBc = 32;  // rows of each tile the loop walks
  static constexpr int kThreads = kBr;
  static constexpr int kLdr = D + 1;  // odd stride: row-per-thread reads hit distinct banks
  static constexpr int kSmemBytes = (2 * kBr * kLdr + 3 * kBc * D) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(64)
flash_bwd_dkv_simt_kernel(const BwdParams p) {
  using C = BwdSimtCfg<D>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kLdr = C::kLdr;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kBr * kLdr;
  float* sQs = sV + kBr * kLdr;
  float* sQk = sQs + kBc * D;
  float* sDo = sQk + kBc * D;
  __shared__ float sLse[kBc], sDi[kBc];
  __shared__ int sQIds[kBc];

  const Mask mk = p.mask;
  const int hkv = p.hq / p.group;
  const int b = blockIdx.y / hkv;
  const int hk = blockIdx.y % hkv;
  const int c0 = blockIdx.x * kBr;
  const int c1 = min(c0 + kBr, mk.lk);
  const bool segmented = p.q_ids != nullptr;

  const float* gk = static_cast<const float*>(p.k) + b * p.sk.sb + hk * p.sk.sh;
  const float* gv = static_cast<const float*>(p.v) + b * p.sv.sb + hk * p.sv.sh;
  load_tile_f32<kBr, D, kLdr, C::kThreads>(sK, gk, p.sk.sl, c0, mk.lk, 1.f);
  load_tile_f32<kBr, D, kLdr, C::kThreads>(sV, gv, p.sv.sl, c0, mk.lk, 1.f);

  const int kv = c0 + threadIdx.x;
  const int kv_id = segmented && kv < mk.lk ? p.kv_ids[(long long)b * mk.lk + kv] : 0;
  const float* kr = sK + threadIdx.x * kLdr;
  const float* vr = sV + threadIdx.x * kLdr;
  float dk[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) dk[c] = dv[c] = 0.f;

  const int i0 = mk.q_first(c0) / kBc;
  const int q_end = mk.q_end(c1);
  const int n_q = q_end > 0 ? (q_end + kBc - 1) / kBc : 0;

  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const float* gq = static_cast<const float*>(p.q) + b * p.sq.sb + h * p.sq.sh;
    const float* gdo = static_cast<const float*>(p.dout) + b * p.sdo.sb + h * p.sdo.sh;
    const long long stat = ((long long)b * p.hq + h) * mk.lq;
    for (int it = i0; it < n_q; ++it) {
      const int r0 = it * kBc;
      __syncthreads();
      load_tile_f32<kBc, D, D, C::kThreads>(sQs, gq, p.sq.sl, r0, mk.lq, p.scale_log2);
      load_tile_f32<kBc, D, D, C::kThreads>(sQk, gq, p.sq.sl, r0, mk.lq, p.scale);
      load_tile_f32<kBc, D, D, C::kThreads>(sDo, gdo, p.sdo.sl, r0, mk.lq, 1.f);
      for (int i = threadIdx.x; i < kBc; i += C::kThreads) {
        const bool in = r0 + i < mk.lq;
        sLse[i] = in ? p.lse[stat + r0 + i] : 0.f;
        sDi[i] = in ? p.di[stat + r0 + i] : 0.f;
      }
      if (segmented) load_ids<kBc, C::kThreads>(sQIds, p.q_ids + (long long)b * mk.lq, r0, mk.lq, 0);
      __syncthreads();

      for (int j = 0; j < kBc; ++j) {
        if (!mk.visible(r0 + j, kv) || (segmented && sQIds[j] != kv_id)) continue;
        const float* qs = sQs + j * D;
        const float* dor = sDo + j * D;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) {
          s = fmaf(qs[c], kr[c], s);
          dp = fmaf(dor[c], vr[c], dp);
        }
        const float pj = exp2f(s - sLse[j] * kLog2e);
        const float ds = pj * (dp - sDi[j]);
        const float* qk = sQk + j * D;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          dv[c] = fmaf(pj, dor[c], dv[c]);
          dk[c] = fmaf(ds, qk[c], dk[c]);
        }
      }
    }
  }

  if (kv < mk.lk) {
    float* dkr = static_cast<float*>(p.dk) + b * p.sdk.sb + hk * p.sdk.sh + (long long)kv * p.sdk.sl;
    float* dvr = static_cast<float*>(p.dv) + b * p.sdv.sb + hk * p.sdv.sh + (long long)kv * p.sdv.sl;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dkr[c] = dk[c];
      dvr[c] = dv[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(64)
flash_bwd_dq_simt_kernel(const BwdParams p) {
  using C = BwdSimtCfg<D>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kLdr = C::kLdr;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQs = reinterpret_cast<float*>(smem_raw);
  float* sDo = sQs + kBr * kLdr;
  float* sK = sDo + kBr * kLdr;
  float* sKs = sK + kBc * D;
  float* sV = sKs + kBc * D;
  __shared__ int sKvIds[kBc];

  const Mask mk = p.mask;
  const int b = blockIdx.y / p.hq;
  const int h = blockIdx.y % p.hq;
  const int hk = h / p.group;
  const int r0 = blockIdx.x * kBr;
  const int r1 = min(r0 + kBr, mk.lq);
  const bool segmented = p.q_ids != nullptr;

  const float* gq = static_cast<const float*>(p.q) + b * p.sq.sb + h * p.sq.sh;
  const float* gdo = static_cast<const float*>(p.dout) + b * p.sdo.sb + h * p.sdo.sh;
  const float* gk = static_cast<const float*>(p.k) + b * p.sk.sb + hk * p.sk.sh;
  const float* gv = static_cast<const float*>(p.v) + b * p.sv.sb + hk * p.sv.sh;
  load_tile_f32<kBr, D, kLdr, C::kThreads>(sQs, gq, p.sq.sl, r0, mk.lq, p.scale_log2);
  load_tile_f32<kBr, D, kLdr, C::kThreads>(sDo, gdo, p.sdo.sl, r0, mk.lq, 1.f);

  const int row = r0 + threadIdx.x;
  const bool in = row < mk.lq;
  const long long stat = ((long long)b * p.hq + h) * mk.lq;
  const float lse_l2 = in ? p.lse[stat + row] * kLog2e : 0.f;
  const float di = in ? p.di[stat + row] : 0.f;
  const int q_id = segmented && in ? p.q_ids[(long long)b * mk.lq + row] : 0;
  const float* qs = sQs + threadIdx.x * kLdr;
  const float* dor = sDo + threadIdx.x * kLdr;
  float dq[D];
#pragma unroll
  for (int c = 0; c < D; ++c) dq[c] = 0.f;

  const int kv_end = mk.kv_end(r1);
  const int j0 = mk.kv_first(r0) / kBc;
  const int n_tiles = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;

  for (int jt = j0; jt < n_tiles; ++jt) {
    const int c0 = jt * kBc;
    __syncthreads();
    load_tile_f32<kBc, D, D, C::kThreads>(sK, gk, p.sk.sl, c0, mk.lk, 1.f);
    load_tile_f32<kBc, D, D, C::kThreads>(sKs, gk, p.sk.sl, c0, mk.lk, p.scale);
    load_tile_f32<kBc, D, D, C::kThreads>(sV, gv, p.sv.sl, c0, mk.lk, 1.f);
    if (segmented) load_ids<kBc, C::kThreads>(sKvIds, p.kv_ids + (long long)b * mk.lk, c0, mk.lk, 0);
    __syncthreads();

    for (int j = 0; j < kBc; ++j) {
      if (!mk.visible(row, c0 + j) || (segmented && sKvIds[j] != q_id)) continue;
      const float* kr = sK + j * D;
      const float* vr = sV + j * D;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) {
        s = fmaf(qs[c], kr[c], s);
        dp = fmaf(dor[c], vr[c], dp);
      }
      const float ds = exp2f(s - lse_l2) * (dp - di);
      const float* ks = sKs + j * D;
#pragma unroll
      for (int c = 0; c < D; ++c) dq[c] = fmaf(ds, ks[c], dq[c]);
    }
  }

  if (in) {
    float* dqr = static_cast<float*>(p.dq) + b * p.sdq.sb + h * p.sdq.sh + (long long)row * p.sdq.sl;
#pragma unroll
    for (int c = 0; c < D; ++c) dqr[c] = dq[c];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int threads, int rows, int len, int heads, int batch,
                   const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((len + rows - 1) / rows, batch * heads);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// which: 0 = dK/dV (grid over KV tiles and KV heads), 1 = dQ (grid over q
// tiles and q heads).  K2 pins KV rows and streams q rows, K3 the reverse.
template <typename T, int D>
cudaError_t launch_ws(int which, const BwdParams& p, cudaStream_t stream) {
  using W = BwdWs<D>;
  constexpr CUtensorMapDataType kType =
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  const Mask& mk = p.mask;
  const int hkv = p.hq / p.group;
  const int q_rows = which == 0 ? W::kStream : W::kPinned;
  const int kv_rows = which == 0 ? W::kPinned : W::kStream;
  BwdMaps maps{};
  const long long qs_sl = D, qs_sh = (long long)mk.lq * D, qs_sb = (long long)p.hq * mk.lq * D;
  bool ok = sm90::make_map_4d(&maps.qs, kType, 2, p.qs, D, mk.lq, p.hq, p.batch, qs_sl, qs_sh, qs_sb, 64, q_rows, kSw);
  ok = ok && sm90::make_map_4d(&maps.dout, kType, 2, p.dout, D, mk.lq, p.hq, p.batch, p.sdo.sl, p.sdo.sh, p.sdo.sb,
                               64, q_rows, kSw);
  ok = ok && sm90::make_map_4d(&maps.k, kType, 2, p.k, D, mk.lk, hkv, p.batch, p.sk.sl, p.sk.sh, p.sk.sb, 64,
                               kv_rows, kSw);
  ok = ok && sm90::make_map_4d(&maps.v, kType, 2, p.v, D, mk.lk, hkv, p.batch, p.sv.sl, p.sv.sh, p.sv.sb, 64,
                               kv_rows, kSw);
  if (which == 0)
    ok = ok && sm90::make_map_4d(&maps.q, kType, 2, p.q, D, mk.lq, p.hq, p.batch, p.sq.sl, p.sq.sh, p.sq.sb, 64,
                                 q_rows, kSw);
  if (!ok) return cudaErrorInvalidValue;
  if (which == 0) {
    using C = DkvCfg<D>;
    auto kernel = flash_bwd_dkv_ws_kernel<T, D>;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((mk.lk + W::kPinned - 1) / W::kPinned, p.batch * hkv);
    kernel<<<grid, W::kThreads, C::kSmemBytes, stream>>>(p, maps);
  } else {
    using C = DqCfg<D>;
    auto kernel = flash_bwd_dq_ws_kernel<T, D>;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((mk.lq + W::kPinned - 1) / W::kPinned, p.batch * p.hq);
    kernel<<<grid, W::kThreads, C::kSmemBytes, stream>>>(p, maps);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int which, int dtype, const BwdParams& p, cudaStream_t s) {
  const int hkv = p.hq / p.group;
  if (dtype == 0) {
    using C = BwdSimtCfg<D>;
    return which == 0
        ? launch(flash_bwd_dkv_simt_kernel<D>, C::kSmemBytes, C::kThreads, C::kBr, p.mask.lk, hkv, p.batch, p, s)
        : launch(flash_bwd_dq_simt_kernel<D>, C::kSmemBytes, C::kThreads, C::kBr, p.mask.lq, p.hq, p.batch, p, s);
  }
  if (p.qs == nullptr) return cudaErrorInvalidValue;
  if (dtype == 1) return launch_ws<__nv_bfloat16, D>(which, p, s);
  if (dtype == 2) return launch_ws<__half, D>(which, p, s);
  return cudaErrorInvalidValue;
}

int run(int which, const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* di, const void* qs, const void* q_ids, const void* kv_ids, void* dq, void* dk, void* dv,
        int dtype, int batch, int hq, int hkv, int lq, int lk, int head_dim, const long long* strides,
        float scale, float scale_log2, int causal, int window, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || lq <= 0 || lk <= 0 || batch <= 0 || (q_ids == nullptr) != (kv_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q;
  p.qs = qs;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.q_ids = static_cast<const int*>(q_ids);
  p.kv_ids = static_cast<const int*>(kv_ids);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  Strides* st[7] = {&p.sq, &p.sk, &p.sv, &p.sdo, &p.sdq, &p.sdk, &p.sdv};
  for (int i = 0; i < 7; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.batch = batch;
  p.hq = hq;
  p.group = hq / hkv;
  p.mask = Mask{lq, lk, causal, causal ? window : 0};
  p.scale = scale;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)dispatch<64>(which, dtype, p, s);
  if (head_dim == 128) return (int)dispatch<128>(which, dtype, p, s);
  if (head_dim == 256) {  // the SIMT family of flash_d256.cuh, every dtype
    if (dtype == 0) return (int)d256::launch_bwd<float>(which, p, s);
    if (dtype == 1) return (int)d256::launch_bwd<__nv_bfloat16>(which, p, s);
    if (dtype == 2) return (int)d256::launch_bwd<__half>(which, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch_prep(const PrepParams& p, cudaStream_t stream) {
  constexpr int kLanes = D / (16 / (int)sizeof(T)) < 32 ? D / (16 / (int)sizeof(T)) : 32;
  constexpr int kRows = 256 / kLanes;
  const long long blocks = (p.rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  flash_bwd_prep_kernel<T, D><<<(unsigned)blocks, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_prep(int dtype, const PrepParams& p, cudaStream_t s) {
  if (dtype == 0) return launch_prep<float, D>(p, s);
  if (dtype == 1) return launch_prep<__nv_bfloat16, D>(p, s);
  if (dtype == 2) return launch_prep<__half, D>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  head_dim: 64, 128 or 256
// (256: the SIMT kernels of flash_d256.cuh, which do not read qs).
// lse and di are fp32 [batch, hq, lq] contiguous (lse as flash_fwd wrote
// it, di as fa_flash_bwd_prep wrote it).  qs is fa_flash_bwd_prep's qs
// ([batch, hq, lq, head_dim] contiguous, q's dtype): required for bf16 /
// fp16, ignored for fp32.  q_ids / kv_ids are both null or both contiguous
// int32 [batch, lq] and [batch, lk].  strides: 21 values, (batch, head,
// row) strides in elements of q, k, v, dout, dq, dk, dv in that order (the
// last dim of each is contiguous, every other stride a multiple of 16
// bytes; the entries of an output the call does not write are ignored).
// scale is sm_scale, scale_log2 sm_scale * log2(e) as flash_fwd took it.
// window <= 0 means no window.  Returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for a dtype or head dim the kernels do not
// instantiate, or when a tensor map cannot be made.
extern "C" int fa_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, const void* qs, const void* q_ids,
                                const void* kv_ids, void* dk, void* dv, int dtype, int batch, int hq, int hkv,
                                int lq, int lk, int head_dim, const long long* strides, float scale,
                                float scale_log2, int causal, int window, void* stream) {
  return run(0, q, k, v, dout, lse, di, qs, q_ids, kv_ids, nullptr, dk, dv, dtype, batch, hq, hkv, lq, lk,
             head_dim, strides, scale, scale_log2, causal, window, stream);
}

extern "C" int fa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, const void* qs, const void* q_ids,
                               const void* kv_ids, void* dq, int dtype, int batch, int hq, int hkv, int lq,
                               int lk, int head_dim, const long long* strides, float scale, float scale_log2,
                               int causal, int window, void* stream) {
  return run(1, q, k, v, dout, lse, di, qs, q_ids, kv_ids, dq, nullptr, nullptr, dtype, batch, hq, hkv, lq, lk,
             head_dim, strides, scale, scale_log2, causal, window, stream);
}

// The pre-pass: di = rowsum(o * dout) - dlse (fp32, [batch, hq, lq]
// contiguous; dlse the same shape, or null for none) and, when qs is not
// null, qs = q * scale_log2 rounded to q's dtype ([batch, hq, lq, head_dim]
// contiguous).  q, o and dout share the dtype; strides: 9 values, (batch,
// head, row) strides in elements of q, o, dout (last dim contiguous, the
// others multiples of 16 bytes).
extern "C" int fa_flash_bwd_prep(const void* q, const void* o, const void* dout, const void* dlse, void* qs,
                                 void* di, int dtype, int batch, int hq, int lq, int head_dim,
                                 const long long* strides, float scale_log2, void* stream) {
  if (batch <= 0 || hq <= 0 || lq <= 0) return (int)cudaErrorInvalidValue;
  PrepParams p;
  p.q = q;
  p.o = o;
  p.dout = dout;
  p.dlse = static_cast<const float*>(dlse);
  p.qs = qs;
  p.di = static_cast<float*>(di);
  Strides* st[3] = {&p.sq, &p.so, &p.sdo};
  for (int i = 0; i < 3; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.hq = hq;
  p.lq = lq;
  p.rows = (long long)batch * hq * lq;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)dispatch_prep<64>(dtype, p, s);
  if (head_dim == 128) return (int)dispatch_prep<128>(dtype, p, s);
  if (head_dim == 256) return (int)dispatch_prep<256>(dtype, p, s);
  return (int)cudaErrorInvalidValue;
}
