// The SIMT backward: dK/dV (K2) and dQ (K3) for fp32 inputs at padded head
// dims D = 256, 512 and 1024.  flash_simt_bwd.cu instantiates it with
// flash_bwd.cuh's BwdParams; the pre-pass (di) is flash_bwd.cu's own at
// every head dim, and the forward whose lse it reads is the 3xTF32 kernel of
// flash_fwd_fp32_wide.cuh.
//
// Replaces, at the head dims these kernels run (the entry points zero-pad
// 129-256 to 256, 257-512 to 512 and 513-1024 to 1024, as the JAX package
// pads any head dim to a multiple of 8):
// flash_attention_tpu/kernels/flash_attention.py::_dkv_kernel (K2) and
// ::_dq_kernel (K3).  Which inputs take them: fp32 at every one of these
// head dims; bf16 / fp16 K2 and K3 run wgmma kernels (flash_bwd.cuh,
// flash_bwd_wide.cuh), and the dispatch below refuses them.  They compute
// what the plain backward in kernels/flash_attention.py computes, in the
// operand form: dK += dS (q * scale) and dQ += dS (k * scale), P recomputed
// as exp2(q * scale_log2 k - lse log2 e) and 0 where masked, dS = P (dP -
// di); causal (queries aligned to the end of KV), window and segment masks,
// GQA by reading KV head hq / group, ragged lengths, inputs read through
// their strides.
//
// What bounds it on this card: the operations (at b8 h12 L1024 D256 causal
// dK/dV's four products are 103 GFLOP, 0.62 ms at the 3xTF32 rate of 165
// TFLOP/s, against 604 MB of q, k, v, dO, dK and dV, 0.18 ms; each
// doubling of D doubles both).  These
// kernels do not reach the tensor cores: fp32 FMA, at most 67 TFLOP/s.
// What the design does about the width: a 64 x D fp32 accumulator in a
// warpgroup's registers is 128 a thread at D = 256 and does not fit above
// it, so here each pinned row is split over kSplit = D / 32 lanes, each
// owning 32 of its columns (4 contiguous columns at 4 kSplit (i / 4) + 4 u,
// so that a row's lanes read 16 kSplit contiguous bytes of a shared row and
// the rows of a warp read the same ones, a broadcast), so a thread keeps 32
// columns of each pinned row and each sum at every width.  A dot product is
// each lane's partial sum over its columns, reduced by xor-shuffles inside
// the row's kSplit lanes (the whole warp at D = 1024, which is why 1024 is
// the widest head dim); every lane then holds the full score and updates
// its own columns.  Blocks of 256 threads pin kRows = 256 / kSplit rows (32,
// 16, 8) and stream kBc-row tiles, staged in shared memory as fp32 (three
// a tile): kBc is the largest power of two whose tiles fit 227 KB, 32 at D
// = 256 and 512, 16 at D = 1024.
#pragma once

#include "common.cuh"

namespace fa {
namespace simt {

template <int D>
struct Cfg {
  static_assert(D == 256 || D == 512 || D == 1024, "padded head dims 256, 512 and 1024");
  static constexpr int kCols = 32;               // columns a lane owns
  static constexpr int kSplit = D / kCols;       // lanes of a pinned row: 8, 16, 32
  static constexpr int kThreads = 256;
  static constexpr int kRows = kThreads / kSplit;  // pinned rows of a block: 32, 16, 8
  static constexpr int kBc = D == 1024 ? 16 : 32;  // rows of each streamed tile
  static constexpr int kTile = kBc * D;            // floats of a staged tile
  static constexpr int kBwdSmem = 3 * kTile * 4;   // dK/dV: qs, q * scale, dO; dQ: K, K * scale, V
  static_assert(kBwdSmem <= 232448, "an H100 block has at most 227 KB of shared memory");
};

// Column of this lane's element i (i < kCols): 4 contiguous columns at
// 4 kSplit (i / 4) + 4 u.
template <int D>
__device__ __forceinline__ int col_of(int u, int i) {
  return 4 * Cfg<D>::kSplit * (i / 4) + 4 * u + i % 4;
}

// A [ROWS, D] tile of g (rows from row0, those at or past nrows zero) into
// shared memory as fp32 rows of D floats, round_T(x * mul).  16-byte loads:
// the wrapper keeps every row 16-byte aligned.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(float* __restrict__ s, const T* __restrict__ g, long long ld, int row0,
                                      int nrows, float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += Cfg<D>::kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kVec;
    float y[kVec];
    if (row0 + r < nrows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * ld + col);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) y[e] = round_to<T>(to_float(x[e]) * mul);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) y[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(s + r * D + col + e) = make_float4(y[e], y[e + 1], y[e + 2], y[e + 3]);
  }
}

// This lane's columns of one row of T in global memory, round_T(x * mul);
// zeros when `in` is false.
template <typename T, int D>
__device__ __forceinline__ void load_row(float (&dst)[32], const T* g, int u, bool in, float mul) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dst[i] = in ? round_to<T>(to_float(g[col_of<D>(u, i)]) * mul) : 0.f;
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* g, const float (&src)[32], int u, float div) {
#pragma unroll
  for (int i = 0; i < 32; ++i) g[col_of<D>(u, i)] = from_float<T>(src[i] / div);
}

// Partial dot product of this lane's columns with row `r` of a staged tile.
template <int D>
__device__ __forceinline__ float dot_row(const float (&a)[32], const float* __restrict__ r, int u) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    const float4 b = *reinterpret_cast<const float4*>(r + col_of<D>(u, i));
    acc = fmaf(a[i], b.x, acc);
    acc = fmaf(a[i + 1], b.y, acc);
    acc = fmaf(a[i + 2], b.z, acc);
    acc = fmaf(a[i + 3], b.w, acc);
  }
  return acc;
}

// acc += w * (this lane's columns of row `r` of a staged tile).
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[32], float w, const float* __restrict__ r, int u) {
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    const float4 b = *reinterpret_cast<const float4*>(r + col_of<D>(u, i));
    acc[i] = fmaf(w, b.x, acc[i]);
    acc[i + 1] = fmaf(w, b.y, acc[i + 1]);
    acc[i + 2] = fmaf(w, b.z, acc[i + 2]);
    acc[i + 3] = fmaf(w, b.w, acc[i + 3]);
  }
}

// The sum of x over a pinned row's kSplit lanes (consecutive lanes of one
// warp); every lane executes it, so the full mask holds.
template <int D>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < Cfg<D>::kSplit; off *= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// Backward (K2, K3).  P is BwdParams; the pre-pass's di and the forward's
// lse are read, its qs is not (the kernels round q * scale_log2 as they
// stage it).
// ---------------------------------------------------------------------------

// K2: a block pins kRows KV rows of one KV head and walks the q tiles of
// every q head of its GQA group that reach them, so the group sums into the
// KV head inside the block.
template <typename T, int D, typename P>
__global__ void __launch_bounds__(256) bwd_dkv_kernel(const P p) {
  using C = Cfg<D>;
  constexpr int kBc = C::kBc, kSplit = C::kSplit, kRows = C::kRows;
  extern __shared__ float4 smem_f4[];
  float* sQs = reinterpret_cast<float*>(smem_f4);  // round_T(q * scale_log2)
  float* sQk = sQs + C::kTile;                     // round_T(q * scale)
  float* sDo = sQk + C::kTile;
  __shared__ float sLse[kBc], sDi[kBc];
  __shared__ int sIds[kBc];

  const Mask mk = p.mask;
  const int hkv = p.hq / p.group;
  const int b = blockIdx.y / hkv;
  const int hk = blockIdx.y % hkv;
  const int c0 = blockIdx.x * kRows;
  const int c1 = min(c0 + kRows, mk.lk);
  const int u = threadIdx.x % kSplit;
  const int kv = c0 + threadIdx.x / kSplit;
  const bool in = kv < mk.lk;
  const bool segmented = p.q_ids != nullptr;
  const int kv_id = segmented && in ? p.kv_ids[(long long)b * mk.lk + kv] : 0;

  float k[32], v[32], dk[32], dv[32];
  load_row<T, D>(k, static_cast<const T*>(p.k) + b * p.sk.sb + hk * p.sk.sh + (long long)kv * p.sk.sl, u, in, 1.f);
  load_row<T, D>(v, static_cast<const T*>(p.v) + b * p.sv.sb + hk * p.sv.sh + (long long)kv * p.sv.sl, u, in, 1.f);
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  const int i0 = mk.q_first(c0) / kBc;
  const int q_end = mk.q_end(c1);
  const int n_q = q_end > 0 ? (q_end + kBc - 1) / kBc : 0;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const T* gq = static_cast<const T*>(p.q) + b * p.sq.sb + h * p.sq.sh;
    const T* gdo = static_cast<const T*>(p.dout) + b * p.sdo.sb + h * p.sdo.sh;
    const long long stat = ((long long)b * p.hq + h) * mk.lq;
    for (int it = i0; it < n_q; ++it) {
      const int r0 = it * kBc;
      __syncthreads();
      stage<T, D, kBc>(sQs, gq, p.sq.sl, r0, mk.lq, p.scale_log2);
      stage<T, D, kBc>(sQk, gq, p.sq.sl, r0, mk.lq, p.scale);
      stage<T, D, kBc>(sDo, gdo, p.sdo.sl, r0, mk.lq, 1.f);
      for (int i = threadIdx.x; i < kBc; i += C::kThreads) {
        const bool q_in = r0 + i < mk.lq;
        sLse[i] = q_in ? p.lse[stat + r0 + i] * kLog2e : 0.f;
        sDi[i] = q_in ? p.di[stat + r0 + i] : 0.f;
      }
      if (segmented) load_ids<kBc, C::kThreads>(sIds, p.q_ids + (long long)b * mk.lq, r0, mk.lq, 0);
      __syncthreads();

      for (int j = 0; j < kBc; ++j) {
        const float s = row_sum<D>(dot_row<D>(k, sQs + j * D, u));
        const float dp = row_sum<D>(dot_row<D>(v, sDo + j * D, u));
        const bool ok = mk.visible(r0 + j, kv) && (!segmented || sIds[j] == kv_id);
        const float pj = ok ? exp2f(s - sLse[j]) : 0.f;
        const float ds = pj * (dp - sDi[j]);
        axpy_row<D>(dv, round_to<T>(pj), sDo + j * D, u);
        axpy_row<D>(dk, round_to<T>(ds), sQk + j * D, u);
      }
    }
  }

  if (in) {
    store_row<T, D>(static_cast<T*>(p.dk) + b * p.sdk.sb + hk * p.sdk.sh + (long long)kv * p.sdk.sl, dk, u, 1.f);
    store_row<T, D>(static_cast<T*>(p.dv) + b * p.sdv.sb + hk * p.sdv.sh + (long long)kv * p.sdv.sl, dv, u, 1.f);
  }
}

// K3: a block pins kRows query rows of one q head and walks the KV tiles
// they reach.
template <typename T, int D, typename P>
__global__ void __launch_bounds__(256) bwd_dq_kernel(const P p) {
  using C = Cfg<D>;
  constexpr int kBc = C::kBc, kSplit = C::kSplit, kRows = C::kRows;
  extern __shared__ float4 smem_f4[];
  float* sK = reinterpret_cast<float*>(smem_f4);
  float* sKs = sK + C::kTile;  // round_T(k * scale)
  float* sV = sKs + C::kTile;
  __shared__ int sIds[kBc];

  const Mask mk = p.mask;
  const int b = blockIdx.y / p.hq;
  const int h = blockIdx.y % p.hq;
  const int hk = h / p.group;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest causal KV loops first
  const int r1 = min(r0 + kRows, mk.lq);
  const int u = threadIdx.x % kSplit;
  const int row = r0 + threadIdx.x / kSplit;
  const bool in = row < mk.lq;
  const bool segmented = p.q_ids != nullptr;
  const long long stat = ((long long)b * p.hq + h) * mk.lq;
  const float lse_l2 = in ? p.lse[stat + row] * kLog2e : 0.f;
  const float di = in ? p.di[stat + row] : 0.f;
  const int q_id = segmented && in ? p.q_ids[(long long)b * mk.lq + row] : 0;

  float qs[32], dout[32], dq[32];
  const long long q_off = (long long)row * p.sq.sl;
  load_row<T, D>(qs, static_cast<const T*>(p.q) + b * p.sq.sb + h * p.sq.sh + q_off, u, in, p.scale_log2);
  load_row<T, D>(dout, static_cast<const T*>(p.dout) + b * p.sdo.sb + h * p.sdo.sh + (long long)row * p.sdo.sl,
                 u, in, 1.f);
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  const T* gk = static_cast<const T*>(p.k) + b * p.sk.sb + hk * p.sk.sh;
  const T* gv = static_cast<const T*>(p.v) + b * p.sv.sb + hk * p.sv.sh;

  const int kv_end = mk.kv_end(r1);
  const int j0 = mk.kv_first(r0) / kBc;
  const int n_tiles = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;
  for (int jt = j0; jt < n_tiles; ++jt) {
    const int c0 = jt * kBc;
    __syncthreads();
    stage<T, D, kBc>(sK, gk, p.sk.sl, c0, mk.lk, 1.f);
    stage<T, D, kBc>(sKs, gk, p.sk.sl, c0, mk.lk, p.scale);
    stage<T, D, kBc>(sV, gv, p.sv.sl, c0, mk.lk, 1.f);
    if (segmented) load_ids<kBc, C::kThreads>(sIds, p.kv_ids + (long long)b * mk.lk, c0, mk.lk, 0);
    __syncthreads();

    for (int j = 0; j < kBc; ++j) {
      const float s = row_sum<D>(dot_row<D>(qs, sK + j * D, u));
      const float dp = row_sum<D>(dot_row<D>(dout, sV + j * D, u));
      const bool ok = mk.visible(row, c0 + j) && (!segmented || sIds[j] == q_id);
      const float ds = ok ? exp2f(s - lse_l2) * (dp - di) : 0.f;
      axpy_row<D>(dq, round_to<T>(ds), sKs + j * D, u);
    }
  }

  if (in)
    store_row<T, D>(static_cast<T*>(p.dq) + b * p.sdq.sb + h * p.sdq.sh + (long long)row * p.sdq.sl, dq, u, 1.f);
}

// which: 0 = dK/dV (grid over KV tiles and KV heads), 1 = dQ (grid over q
// tiles and q heads).
template <typename T, int D, typename P>
cudaError_t launch_bwd(int which, const P& p, cudaStream_t stream) {
  using C = Cfg<D>;
  const int hkv = p.hq / p.group;
  auto kernel = which == 0 ? bwd_dkv_kernel<T, D, P> : bwd_dq_kernel<T, D, P>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBwdSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(which == 0 ? (p.mask.lk + C::kRows - 1) / C::kRows : (p.mask.lq + C::kRows - 1) / C::kRows,
                  p.batch * (which == 0 ? hkv : p.hq));
  kernel<<<grid, C::kThreads, C::kBwdSmem, stream>>>(p);
  return cudaGetLastError();
}

// The backward for q's dtype: fp32 (0) only.
template <int D, typename P>
cudaError_t launch_bwd_dim(int which, int dtype, const P& p, cudaStream_t s) {
  if (dtype == 0) return launch_bwd<float, D>(which, p, s);
  return cudaErrorInvalidValue;
}

// dK/dV (which 0) or dQ (1) for fp32 q at head dim 256, 512 or 1024.
template <typename P>
cudaError_t launch_bwd_for(int which, int dtype, int head_dim, const P& p, cudaStream_t s) {
  if (head_dim == 256) return launch_bwd_dim<256>(which, dtype, p, s);
  if (head_dim == 512) return launch_bwd_dim<512>(which, dtype, p, s);
  if (head_dim == 1024) return launch_bwd_dim<1024>(which, dtype, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace simt
}  // namespace fa
