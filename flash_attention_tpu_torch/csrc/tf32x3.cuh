// 3xTF32 products on mma.sync, shared by the fp32 kernels: the forward
// (flash_fwd_fp32.cu at head dims 64 and 128, flash_fwd_fp32_wide.cuh at
// 256, 512 and 1024; K1 and K4) and the backward (flash_bwd_fp32.cuh at 64
// and 128, flash_bwd_fp32_wide.cuh above; K2 and K3).  Every fp32 operand x
// is split into hi = x rounded to TF32 and lo = (x - hi) rounded to TF32
// (or not rounded: split_tf32), and each product is lo hi + hi lo + hi hi,
// summed in fp32 (lo lo, about 2^-22 of it, is left out): one TF32 pass
// keeps about three decimal digits, which misses the
// fp32 tiers (forward 1e-5, backward 1e-4).  Tiles are fp32 as TMA writes
// them with the 128-byte swizzle and 32-column boxes (swz); fragments are
// read with plain shared loads that the swizzle keeps free of bank
// conflicts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fa {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the same bits for every finite x), in two integer operations:
// ptxas expands cvt.rna.tf32.f32 to several, compares and selects among
// them, and the splits are most of these kernels' instructions (17-23%
// faster with these at head dims 64 and 128; PERF.md).
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo to about 2^-22 of x: hi is x rounded to TF32, lo the rest,
// rounded to TF32 (kRound) or passed as it is: mma.sync reads a TF32
// operand's top 19 bits, so an unrounded lo differs from the rounded one by
// at most one TF32 ulp of lo, about 2^-22 of x (the size of the lo lo term
// left out), for three operations a split instead of five.
template <bool kRound = true>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  const float rest = x - __uint_as_float(hi);
  lo = kRound ? to_tf32(rest) : __float_as_uint(rest);
}

// d += a b on one m16n8k8 tile.  Fragments (g = lane / 4, t = lane % 4):
// a = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of A [16, 8]; b = (t, g),
// (t + 4, g) of B [8, 8]; d = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a[j] b[j] in 3xTF32 for G independent products: each is lo hi +
// hi lo + hi hi, the two small cross terms first, summed in fp32.  Issued
// pass by pass across the G products, so that an mma.sync never waits on
// the one before it.
template <int G>
__device__ __forceinline__ void mma3(float (&d)[G][4], const uint32_t (&ah)[G][4], const uint32_t (&al)[G][4],
                                     const uint32_t (&bh)[G][2], const uint32_t (&bl)[G][2]) {
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d[j], al[j], bh[j]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d[j], ah[j], bl[j]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d[j], ah[j], bh[j]);
}

// Float index of (r, c) in a [ROWS, D] fp32 tile as TMA writes it with the
// 128-byte swizzle and 32-column boxes: D / 32 blocks of [ROWS, 32] one after
// the other, and in each row the 16-byte chunk c / 4 at chunk (c / 4) ^ (r %
// 8).  Every fragment load below then touches 32 distinct banks.
template <int ROWS>
__device__ __forceinline__ int swz(int r, int c) {
  return (c / 32) * ROWS * 32 + r * 32 + ((((c / 4) % 8) ^ (r % 8)) * 4) + c % 4;
}

// Element (r, c) of a [ROWS, D] streamed tile: an fp32 tile (a pointer)
// laid out as swz says, or any reader with operator()(r, c) (the forward's
// quantized K/V, dequantized as it is read).
template <int ROWS, class Tile>
__device__ __forceinline__ float tile_at(const Tile& tile, int r, int c) {
  if constexpr (std::is_pointer<Tile>::value) {
    return tile[swz<ROWS>(r, c)];
  } else {
    return tile(r, c);
  }
}

// A payload byte (int8, or fp8 e4m3) as the float it holds, exactly.  int8
// through the float 2^23 + 128 + x; fp8 by moving its exponent and
// mantissa into an fp32's (a denormal there for e4m3's denormals) and
// scaling by 2^120, the difference of the two biases.
template <typename KV>
__device__ __forceinline__ float payload_value(uint32_t byte) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    return __uint_as_float(0x4B000000u | ((byte ^ 0x80u) & 0xFFu)) - 8388736.f;
  } else {
    const float x = __uint_as_float((byte & 0x7Fu) << 20) * 0x1p120f;
    return byte & 0x80u ? -x : x;
  }
}

// The A fragment of rows [m0, m0 + 16) and columns [k0, k0 + 8) of a
// [ROWS, D] tile, split.
template <int ROWS>
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* tile, int m0, int k0,
                                       int g, int t) {
  split_tf32(tile[swz<ROWS>(m0 + g, k0 + t)], hi[0], lo[0]);
  split_tf32(tile[swz<ROWS>(m0 + g + 8, k0 + t)], hi[1], lo[1]);
  split_tf32(tile[swz<ROWS>(m0 + g, k0 + t + 4)], hi[2], lo[2]);
  split_tf32(tile[swz<ROWS>(m0 + g + 8, k0 + t + 4)], hi[3], lo[3]);
}

// The B fragment of A X^T: X a [ROWS, D] tile whose rows [n0, n0 + 8) are
// the product's columns, its columns [k0, k0 + 8) the depth; split.
template <int ROWS, class Tile>
__device__ __forceinline__ void frag_b_nk(uint32_t (&hi)[2], uint32_t (&lo)[2], const Tile& tile, int n0, int k0,
                                          int g, int t) {
  split_tf32(tile_at<ROWS>(tile, n0 + g, k0 + t), hi[0], lo[0]);
  split_tf32(tile_at<ROWS>(tile, n0 + g, k0 + t + 4), hi[1], lo[1]);
}

// The A fragment of an accumulator block (16 rows x 8 columns, frag d of
// mma_tf32), split.  The accumulator holds columns 2t and 2t + 1 where A
// wants t and t + 4, so the depth is taken in the order 0, 2, 4, 6, 1, 3, 5,
// 7: depth t is column 2t and depth t + 4 column 2t + 1, and frag_b_kn reads
// B's rows in the same order.  No value moves between lanes.
template <bool kRound = true>
__device__ __forceinline__ void frag_acc(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c)[4]) {
  split_tf32<kRound>(c[0], hi[0], lo[0]);
  split_tf32<kRound>(c[2], hi[1], lo[1]);
  split_tf32<kRound>(c[1], hi[2], lo[2]);
  split_tf32<kRound>(c[3], hi[3], lo[3]);
}

// The B fragment of (accumulator) X: X a [ROWS, D] tile whose rows [k0, k0
// + 8) are the depth, in frag_acc's order, and columns [n0, n0 + 8) the
// product's columns; split.
template <int ROWS, bool kRound = true, class Tile>
__device__ __forceinline__ void frag_b_kn(uint32_t (&hi)[2], uint32_t (&lo)[2], const Tile& tile, int k0, int n0,
                                          int g, int t) {
  split_tf32<kRound>(tile_at<ROWS>(tile, k0 + 2 * t, n0 + g), hi[0], lo[0]);
  split_tf32<kRound>(tile_at<ROWS>(tile, k0 + 2 * t + 1, n0 + g), hi[1], lo[1]);
}

// The A fragment of rows [m0, m0 + 16) and columns [k0, k0 + 8) of a
// pinned [PR, D] tile: split here, or (kPre) split already, its hi in `a`
// and its lo in `alo` (split_pinned).
template <int PR, bool kPre>
__device__ __forceinline__ void frag_pinned(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* a, const float* alo,
                                            int m0, int k0, int g, int t) {
  if constexpr (kPre) {
    const int idx[4] = {swz<PR>(m0 + g, k0 + t), swz<PR>(m0 + g + 8, k0 + t), swz<PR>(m0 + g, k0 + t + 4),
                        swz<PR>(m0 + g + 8, k0 + t + 4)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = __float_as_uint(a[idx[i]]);
      lo[i] = __float_as_uint(alo[idx[i]]);
    }
  } else {
    frag_a<PR>(hi, lo, a, m0, k0, g, t);
  }
}

// Split a warp's 16 rows from m0 of a pinned [PR, D] tile once, each value
// times `scale` first: hi in place, lo at the same index of `lo`.  Only
// this warp reads those rows.
template <int PR, int D>
__device__ __forceinline__ void split_pinned(float* tile, float* lo, int m0, int lane, float scale = 1.f) {
  for (int i = lane; i < 16 * D; i += 32) {
    const int idx = swz<PR>(m0 + i / D, i % D);
    uint32_t h, l;
    split_tf32(tile[idx] * scale, h, l);
    tile[idx] = __uint_as_float(h);
    lo[idx] = __uint_as_float(l);
  }
  __syncwarp();
}

// s = A X^T over K columns, from zero, for the forward's S = Qs K^T: A the
// 16 rows from m0 of a pinned [PR, .] q tile (split already, lo in alo,
// when kPre), X a streamed [8 NB, .] K tile (tile_at: fp32, or a payload
// reader), both at the first of the K columns.  hi hi in s, the two cross
// passes in c, added at the end: the tensor cores truncate what they add,
// and a sum that takes all three passes of every k8 step loses an ulp of S
// three times as often.
template <int PR, int K, int NB, bool kPre, class Tile>
__device__ __forceinline__ void scores(float (&s)[NB][4], const float* a, const float* alo, const Tile& x, int m0,
                                       int g, int t) {
  float c[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = c[nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t ah[4], al[4], bh[NB][2], bl[NB][2];
    frag_pinned<PR, kPre>(ah, al, a, alo, m0, kk * 8, g, t);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) frag_b_nk<8 * NB>(bh[nb], bl[nb], x, nb * 8, kk * 8, g, t);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(c[nb], al, bh[nb]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(c[nb], ah, bl[nb]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(s[nb], ah, bh[nb]);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] += c[nb][e];
}

// acc += A X over one streamed tile: A [16, K] the split fragments of an
// accumulator (frag_acc, K / 8 blocks), X the [K, D] tile.  Each 8-column
// block of the tile's product is summed from zero and then added to acc
// with one fp32 add: the tensor cores truncate what they add to a sum to the
// sum's own precision, so 3 x K / 8 products straight into a sum that runs
// over thousands of rows (dK and dV of a GQA group over Lq = 1023, 4 heads)
// lose about 1e-4 of it; a tile's part loses that only on its own, smaller
// magnitude, and the adds into acc round to nearest.  Four column blocks
// are summed side by side (mma3<4>; 5-6% faster at D = 128 than one at a
// time, 1% slower at 64).
template <int K, int D, bool kRound = true, class Tile>
__device__ __forceinline__ void add_product(float (&acc)[D / 8][4], const uint32_t (&ah)[K / 8][4],
                                            const uint32_t (&al)[K / 8][4], const Tile& tile, int g, int t) {
  constexpr int G = 4;
#pragma unroll
  for (int nd0 = 0; nd0 < D / 8; nd0 += G) {
    float part[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < K / 8; ++kb) {
      uint32_t gh[G][4], gl[G][4], bh[G][2], bl[G][2];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        frag_b_kn<K, kRound>(bh[j], bl[j], tile, kb * 8, (nd0 + j) * 8, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gh[j][e] = ah[kb][e];
          gl[j][e] = al[kb][e];
        }
      }
      mma3<G>(part, gh, gl, bh, bl);
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd0 + j][e] += part[j][e];
  }
}

// The split A fragments of every 8-column block of a [16, N] accumulator.
template <int N, bool kRound = true>
__device__ __forceinline__ void frags_of(uint32_t (&hi)[N / 8][4], uint32_t (&lo)[N / 8][4],
                                         const float (&c)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) frag_acc<kRound>(hi[i], lo[i], c[i]);
}

}  // namespace fa
