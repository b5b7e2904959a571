// FlashAttention backward for Hopper (sm_90a): a di/qs pre-pass, dK/dV and
// dQ, with a plain C interface loaded through ctypes
// (flash_attention_tpu_torch/kernels/_build.py).  The warp-specialised
// kernels are in flash_bwd.cuh (K2 and K3 at D = 256 instantiated in
// flash_bwd_d256.cu) and, at 512 and 1024, flash_bwd_wide.cuh (their own
// design notes; flash_bwd_wide.cu, flash_bwd_wide_d1024.cu); fp32's are in
// flash_bwd_fp32.cuh at 64 and 128 and flash_bwd_fp32_wide.cuh at 256, 512
// and 1024 (flash_bwd_fp32_wide.cu, flash_bwd_fp32_wide_d1024.cu).
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
// dims 64, 256 and 1024 (sm_scale = 2^-3, 2^-4 and 2^-5, powers of two) both
// forms give the same bits; at 128 and 512 the store form skips one rounding
// of each operand, inside the 16-bit tier either way.  The plain versions (kernels/flash_attention.py) keep the
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
// or sequence (at b8 h12 L1024 D256, K2 103 GFLOP, 0.104 ms).  The
// pre-pass is bound by its bytes: q, o,
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
//     twice, dV first and dK second (DkvCfg::kPasses).  At D = 256 one
//     accumulator is 128 registers a thread, past the 168 that ptxas gives
//     a consumer of a 384-thread block whatever setmaxnreg grants: the
//     block is one consumer warpgroup of 64 pinned KV rows beside the
//     producer warpgroup (256 threads, 255 registers, no setmaxnreg),
//     walks twice, and streams 32-row q tiles, so that S^T and dP^T take 16
//     registers each and three 48 KB ring slots fit beside the 64 KB of
//     pinned K and V; wgmma's N is at most 128 here, so each k16 step of dV
//     and dK is two products of 128 columns.  K3 at D = 256 is the same
//     kernel as at 64 and 128 with one consumer warpgroup of 64 pinned q
//     rows beside the producer (256 threads, no setmaxnreg) and 64-row K/V
//     tiles in two 64 KB ring slots beside 64 KB of pinned qs and dO
//     (DqCfg<256>): S and dP are 16 k16 steps of m64n64k16 (SS, four
//     commit groups each), 32 registers each; dQ += dS K is two N = 128
//     products a k16 step into the accumulator's halves.  32-row tiles in
//     four slots (S and dP m64n32k16) used more registers (230) and ran
//     21% slower;
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
// fp32 K2 and K3 (flash_bwd_fp32.cuh) compute the same function on the
// tensor cores in 3xTF32: one TF32 pass keeps about three decimal digits and
// misses the fp32 backward tier (1e-4), so every fp32 operand x is split
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi) and each product is lo hi
// + hi lo + hi hi, summed in fp32; P and dS stay fp32 and are split the
// same way.  They replace the SIMT pair of PR 2 (one thread per pinned row,
// fp32 FMA, 64 threads a block; dK/dV 255 registers and 168 bytes spilled
// at D = 128), 3.13 / 21.29 ms (K2) and 2.69 / 11.21 ms (K3) at b8 h12
// L1024 D64 / D128 causal.  What bounds them: K2's 25.8 / 51.5 GFLOP and
// K3's 19.3 / 38.7 at 165 TFLOP/s (TF32's 495 over three passes), 0.156 /
// 0.312 and 0.117 / 0.234 ms, against 151 / 302 MB and 126 / 252 MB of
// fp32 bytes: their operations.  Design:
//   * eight warps of 16 pinned rows (q and dO for K3, K and V for K2), one
//     block an SM; warp 0 also produces: its lane 0 issues TMA loads of
//     fp32 tiles (32-column boxes, 128-byte swizzle, rows past Lq or Lk
//     read as zero) into an mbarrier ring of 32-row tiles once every warp
//     has released the slot, and its lanes stage K2's q rows' lse *
//     log2(e), di and segment ids.  A producer-only ninth warp (288
//     threads) left every kernel 168 registers (ptxas and the launch
//     budget such a block as 384 threads): K3 8% / 23% slower at D = 64 /
//     128, and K2 at 128 needed two walks (below);
//   * the grid is (heads, tiles), so that blocks run tile by tile, the
//     longest causal loop first across every head: 13-20% faster than
//     (tiles, heads), whose first waves mixed long and short blocks;
//   * every product on mma.sync.m16n8k8 tf32 (tf32 wgmma takes its shared
//     operands K-major only: dV += P^T dO, dK += dS^T q and dQ += dS K would
//     need transposed hi and lo copies of every tile, past 227 KB at D =
//     128), fragments read with plain shared loads that the swizzle keeps
//     free of bank conflicts, split in registers with two integer
//     operations a half, and four independent sums issued pass by pass;
//   * P^T / dS^T (K2) and dS (K3) are the A operand straight from the
//     accumulators: the depth is taken in the order 0, 2, 4, 6, 1, 3, 5, 7,
//     and the B operand's rows are read in the same order, so no value
//     moves between lanes;
//   * the tensor cores truncate what they add to an accumulator to its
//     precision: 3 x 512 products straight into dV over a GQA group of 4 at
//     Lq = 1023 lost 2.5e-4 (outside 1e-4).  Each 8-column block of a
//     tile's dV, dK and dQ is summed from zero and added to the running sum
//     with one fp32 add: 1.3e-5 there;
//   * K2 holds dK and dV (128 registers a thread at D = 128) through one walk
//     over the group's q tiles, no atomics, the group summed in the block
//     (two walks, dV then dK, spilled nothing and were 35% slower); at D =
//     64 each warp splits its pinned K and V once, lo copies beside them.
// ptxas -v (sm_90a, CUDA 12.8), 256 threads: K3 218 / 239 registers at D =
// 64 / 128, K2 250 / 255; no spills but K2's 32 bytes at D = 128.
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry points return cudaGetLastError() so that the wrapper can raise (and
// cudaErrorInvalidValue when a tensor map cannot be made).

#include "flash_bwd_fp32.cuh"

namespace {

using namespace fa;

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
// of q, o and dO (one up to D = 256 in 16-bit types and D = 128 in fp32,
// then D / 256 or D / 128).
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

template <int D>
cudaError_t dispatch(int which, int dtype, const BwdParams& p, cudaStream_t s) {
  if (dtype == 0) return which == 0 ? launch_dkv_fp32<D>(p, s) : launch_dq_fp32<D>(p, s);
  if (p.qs == nullptr) return cudaErrorInvalidValue;
  if (dtype == 1) return which == 0 ? launch_dkv_ws<__nv_bfloat16, D>(p, s) : launch_dq_ws<__nv_bfloat16, D>(p, s);
  if (dtype == 2) return which == 0 ? launch_dkv_ws<__half, D>(p, s) : launch_dq_ws<__half, D>(p, s);
  return cudaErrorInvalidValue;
}

int run(int which, const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* di, const void* qs, const void* q_ids, const void* kv_ids, void* dq, void* dk, void* dv,
        int dtype, int batch, int hq, int hkv, int lq, int lk, int head_dim, const long long* strides,
        float scale, float scale_log2, int causal, int window, void* stream) {
  BwdParams p;
  if (!fill_bwd_params(p, q, k, v, dout, lse, di, qs, q_ids, kv_ids, dq, dk, dv, batch, hq, hkv, lq, lk, strides,
                       scale, scale_log2, causal, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)dispatch<64>(which, dtype, p, s);
  if (head_dim == 128) return (int)dispatch<128>(which, dtype, p, s);
  // D = 256, 512 and 1024: fp32 K2 and K3 in 3xTF32
  // (flash_bwd_fp32_wide.cu, flash_bwd_fp32_wide_d1024.cu); bf16 / fp16 on
  // wgmma (flash_bwd_d256.cu, flash_bwd_wide.cu, flash_bwd_wide_d1024.cu).
  if (dtype == 0) {
    if (head_dim == 256 || head_dim == 512) return (int)launch_bwd_fp32_wide(which, head_dim, p, s);
    if (head_dim == 1024) return (int)launch_bwd_fp32_wide_d1024(which, p, s);
    return (int)cudaErrorInvalidValue;
  }
  if (p.qs == nullptr || (dtype != 1 && dtype != 2)) return (int)cudaErrorInvalidValue;
  if (head_dim == 256) return (int)(which == 0 ? launch_dkv_ws_d256(dtype, p, s) : launch_dq_ws_d256(dtype, p, s));
  if (head_dim == 512) return (int)launch_bwd_wide_d512(which, dtype, p, s);
  if (head_dim == 1024) return (int)launch_bwd_wide_d1024(which, dtype, p, s);
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  head_dim: 64, 128, 256,
// 512 or 1024.
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

// The pre-pass, at head dims 64, 128, 256, 512 and 1024: di = rowsum(o *
// dout) - dlse (fp32, [batch, hq, lq] contiguous; dlse the same shape, or
// null for none) and, when qs is not null, qs = q * scale_log2 rounded to
// q's dtype ([batch, hq, lq, head_dim] contiguous).  q, o and dout share the dtype; strides: 9 values, (batch,
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
  if (head_dim == 512) return (int)dispatch_prep<512>(dtype, p, s);
  if (head_dim == 1024) return (int)dispatch_prep<1024>(dtype, p, s);
  return (int)cudaErrorInvalidValue;
}
