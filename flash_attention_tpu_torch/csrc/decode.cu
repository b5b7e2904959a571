// The plain C entry points of K5 (fa_paged_decode, fa_paged_decode_narrow,
// fa_paged_decode_group, fa_paged_decode_wide) and K6 (fa_fused_decode,
// fa_fused_decode_narrow, fa_fused_decode_group, fa_fused_decode_wide),
// loaded through ctypes (flash_attention_tpu_torch/kernels/_build.py).  The
// group-tile kernel template and its design are in decode.cuh (head dims 64,
// 128 and 256), the narrow kernel's (head dims 8-32, GQA groups of up to 8)
// in decode_narrow.cuh, the whole-group kernel's (GQA groups above 8 at
// head dims 8-256) in decode_group.cuh (bf16 / fp16 q) and
// decode_group_fp32.cuh (fp32 q), the wide kernel's (head dims above 256)
// in decode_wide.cuh; their instantiations are built by the decode_*.cu
// sources, one nvcc each, and declared extern here.

#include "decode.cuh"
#include "decode_group.cuh"
#include "decode_group_fp32.cuh"
#include "decode_narrow.cuh"
#include "decode_wide.cuh"

namespace fa {
namespace decode {

#define FA_DECODE_EXTERN(T, D) \
  extern template cudaError_t launch_width<T, D>(const DecodeParams&, int, bool, dim3, cudaStream_t);
FA_DECODE_WIDTHS(FA_DECODE_EXTERN)
#undef FA_DECODE_EXTERN
#define FA_GROUP_EXTERN(T, KV, D, P) \
  extern template cudaError_t group_launch_rows<T, KV, D, P>(const GroupParams&, int, dim3, cudaStream_t, int*);
FA_GROUP_ALL(FA_GROUP_EXTERN)
#undef FA_GROUP_EXTERN
#define FA_GROUP32_EXTERN(KV, D, P) \
  extern template cudaError_t group32_launch_rows<KV, D, P>(const GroupParams&, int, dim3, cudaStream_t, int*);
FA_GROUP32_ALL(FA_GROUP32_EXTERN)
#undef FA_GROUP32_EXTERN
#define FA_WIDE_EXTERN(T, D, P) \
  extern template cudaError_t wide_launch_width<T, D, P>(const WideParams&, int, int, dim3, cudaStream_t, int*);
FA_WIDE_ALL(FA_WIDE_EXTERN)
#undef FA_WIDE_EXTERN
#define FA_NARROW_EXTERN(T) \
  extern template cudaError_t narrow_launch_dtype<T>(const GroupParams&, int, bool, int, dim3, cudaStream_t, int*);
FA_NARROW_DTYPES(FA_NARROW_EXTERN)
#undef FA_NARROW_EXTERN

namespace {

template <typename T>
cudaError_t launch_dtype(const DecodeParams& p, int kv_dtype, bool paged, int width, dim3 grid, cudaStream_t s) {
  switch (width) {
    case 64: return launch_width<T, 64>(p, kv_dtype, paged, grid, s);
    case 128: return launch_width<T, 128>(p, kv_dtype, paged, grid, s);
    case 256: return launch_width<T, 256>(p, kv_dtype, paged, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kPaged>
int launch_decode(DecodeParams& p, int q_dtype, int kv_dtype, int batch, int hq, int hkv, int group_tiles,
                  int group_rows, int head_dim, const long long* st, cudaStream_t s) {
  const int width = head_dim == 64 || head_dim == 128 || head_dim == 256 ? head_dim : 0;
  if (batch <= 0 || hkv <= 0 || hq <= 0 || hq % hkv != 0 || group_rows < 1 || group_rows > kMaxRows ||
      group_rows > hq / hkv || group_tiles < 1 || (long long)group_tiles * group_rows < hq / hkv ||
      (long long)(group_tiles - 1) * group_rows >= hq / hkv || width == 0 || p.page_size <= 0 ||
      p.pages_per_seq <= 0 || p.chunk <= 0 || p.splits <= 0 || p.splits > kMaxSplits ||
      (kv_dtype != 0) != (p.ks != nullptr && p.vs != nullptr) ||
      (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int capacity = kPaged ? p.page_size * p.pages_per_seq : p.page_size;
  if ((long long)p.chunk * p.splits < capacity ||
      (kPaged && (p.chunk % p.page_size != 0 || p.chunk / p.page_size > kMaxPages)))
    return (int)cudaErrorInvalidValue;
  p.q_sb = st[0]; p.q_sh = st[1];
  p.o_sb = st[2]; p.o_sh = st[3];
  p.k_sh = st[4]; p.k_sp = st[5]; p.k_sr = st[6];
  p.v_sh = st[7]; p.v_sp = st[8]; p.v_sr = st[9];
  p.s_sh = st[10]; p.s_sp = st[11];
  p.head_dim = head_dim;
  p.group = hq / hkv;
  p.rows = group_rows;
  p.gtiles = group_tiles;
  const dim3 grid(hkv * p.gtiles, batch, p.splits);
  if (q_dtype == 0) return (int)launch_dtype<float>(p, kv_dtype, kPaged, width, grid, s);
  if (q_dtype == 1) return (int)launch_dtype<__nv_bfloat16>(p, kv_dtype, kPaged, width, grid, s);
  if (q_dtype == 2) return (int)launch_dtype<__half>(p, kv_dtype, kPaged, width, grid, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
cudaError_t group_width(const GroupParams& p, int kv_dtype, int width, bool paged, int cluster, dim3 grid,
                        cudaStream_t s, int* resident) {
  switch (width) {
    case 32: return group_launch_width<T, 32>(p, kv_dtype, paged, cluster, grid, s, resident);
    case 64: return group_launch_width<T, 64>(p, kv_dtype, paged, cluster, grid, s, resident);
    case 128: return group_launch_width<T, 128>(p, kv_dtype, paged, cluster, grid, s, resident);
    case 256: return group_launch_width<T, 256>(p, kv_dtype, paged, cluster, grid, s, resident);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t group32_width(const GroupParams& p, int kv_dtype, int width, bool paged, int cluster, dim3 grid,
                          cudaStream_t s, int* resident) {
  switch (width) {
    case 32: return group32_launch_width<32>(p, kv_dtype, paged, cluster, grid, s, resident);
    case 64: return group32_launch_width<64>(p, kv_dtype, paged, cluster, grid, s, resident);
    case 128: return group32_launch_width<128>(p, kv_dtype, paged, cluster, grid, s, resident);
    case 256: return group32_launch_width<256>(p, kv_dtype, paged, cluster, grid, s, resident);
    default: return cudaErrorInvalidValue;
  }
}

// The whole-group kernel of q's dtype at the padded head dim (32 for d 8-32).
cudaError_t group_dispatch(const GroupParams& p, int q_dtype, int kv_dtype, int head_dim, bool paged, int cluster,
                           dim3 grid, cudaStream_t s, int* resident) {
  const int width = instantiated_width(head_dim);
  if (q_dtype == 0) return group32_width(p, kv_dtype, width, paged, cluster, grid, s, resident);
  if (q_dtype == 1) return group_width<__nv_bfloat16>(p, kv_dtype, width, paged, cluster, grid, s, resident);
  return group_width<__half>(p, kv_dtype, width, paged, cluster, grid, s, resident);
}

// The head dims the whole-group kernel takes, for every q dtype: 8, 16, 32,
// 64, 128 and 256.
bool group_head_dim(int d) { return instantiated_width(d) != 0; }

// The q heads a pass of the whole-group kernel holds at most: 128; for fp32
// q 64 at D128 and 32 at D256 (decode_group_fp32.cuh: a row tile's two or
// four warps share a token's columns), for bf16 / fp16 q 32 at D256
// (decode_group.cuh: 2 row tiles).
int group_max_rows(int q_dtype, int head_dim) {
  if (head_dim == 256) return q_dtype == 0 ? kGMaxRows32D256 : kGMaxRowsD256;
  return q_dtype == 0 && head_dim == 128 ? kGMaxRows32D128 : kGMaxRows;
}

// The whole-group kernel: passes x pass_rows q heads cover the group (every
// pass live, pass_rows a multiple of 16 up to group_max_rows), a cluster of
// `cluster` blocks per (sequence, KV head, pass), each walking `walks`
// chunks of `chunk` tokens.
template <bool kPaged>
int launch_group(GroupParams& p, int q_dtype, int kv_dtype, int batch, int hq, int hkv, int passes,
                 int pass_rows, int head_dim, int cluster, const long long* st, cudaStream_t s) {
  if (batch <= 0 || batch > 65535 || hkv <= 0 || hq <= 0 || hq % hkv != 0 || q_dtype < 0 || q_dtype > 2 ||
      !group_head_dim(head_dim) || kv_dtype < 0 || kv_dtype > 2 || pass_rows < 16 || pass_rows % 16 != 0 ||
      pass_rows > group_max_rows(q_dtype, head_dim) || passes < 1 || (long long)hkv * passes > 65535 ||
      (long long)passes * pass_rows < hq / hkv || (long long)(passes - 1) * pass_rows >= hq / hkv ||
      cluster < 1 || cluster > kClusterMax || p.page_size <= 0 ||
      p.pages_per_seq <= 0 || p.chunk <= 0 || p.walks <= 0 ||
      (kv_dtype != 0) != (p.ks != nullptr && p.vs != nullptr))
    return (int)cudaErrorInvalidValue;
  const int capacity = kPaged ? p.page_size * p.pages_per_seq : p.page_size;
  if ((long long)cluster * p.chunk * p.walks < capacity ||
      (kPaged && (p.chunk % p.page_size != 0 || (long long)p.walks * (p.chunk / p.page_size) > kClusterMaxPages)))
    return (int)cudaErrorInvalidValue;
  p.q_sb = st[0]; p.q_sh = st[1];
  p.o_sb = st[2]; p.o_sh = st[3];
  p.k_sh = st[4]; p.k_sp = st[5]; p.k_sr = st[6];
  p.v_sh = st[7]; p.v_sp = st[8]; p.v_sr = st[9];
  p.s_sh = st[10]; p.s_sp = st[11];
  p.group = hq / hkv;
  p.passes = passes;
  p.pass_rows = pass_rows;
  p.head_dim = head_dim;
  const dim3 grid(cluster, hkv * passes, batch);
  return (int)group_dispatch(p, q_dtype, kv_dtype, head_dim, kPaged, cluster, grid, s, nullptr);
}

template <typename T, int D>
cudaError_t wide_paged(const WideParams& p, int kv_dtype, bool paged, int cluster, dim3 grid, cudaStream_t s,
                       int* resident) {
  return paged ? wide_launch_width<T, D, true>(p, kv_dtype, cluster, grid, s, resident)
               : wide_launch_width<T, D, false>(p, kv_dtype, cluster, grid, s, resident);
}

// The padded head dim (512 for d 384 and 512, 1024 for 640-1024) and q's dtype.
cudaError_t wide_dispatch(const WideParams& p, int q_dtype, int kv_dtype, int head_dim, bool paged, int cluster,
                          dim3 grid, cudaStream_t s, int* resident) {
  const bool narrow = head_dim <= 512;
  if (q_dtype == 0) {
    return narrow ? wide_paged<float, 512>(p, kv_dtype, paged, cluster, grid, s, resident)
                  : wide_paged<float, 1024>(p, kv_dtype, paged, cluster, grid, s, resident);
  }
  if (q_dtype == 1) {
    return narrow ? wide_paged<__nv_bfloat16, 512>(p, kv_dtype, paged, cluster, grid, s, resident)
                  : wide_paged<__nv_bfloat16, 1024>(p, kv_dtype, paged, cluster, grid, s, resident);
  }
  return narrow ? wide_paged<__half, 512>(p, kv_dtype, paged, cluster, grid, s, resident)
                : wide_paged<__half, 1024>(p, kv_dtype, paged, cluster, grid, s, resident);
}

bool wide_head_dim(int d) { return d >= 384 && d <= 1024 && d % 128 == 0; }

// The narrow kernel of q's dtype (head dims 8, 16 and 32).
cudaError_t narrow_dispatch(const GroupParams& p, int q_dtype, int kv_dtype, bool paged, int cluster, dim3 grid,
                            cudaStream_t s, int* resident) {
  if (q_dtype == 0) return narrow_launch_dtype<float>(p, kv_dtype, paged, cluster, grid, s, resident);
  if (q_dtype == 1) return narrow_launch_dtype<__nv_bfloat16>(p, kv_dtype, paged, cluster, grid, s, resident);
  return narrow_launch_dtype<__half>(p, kv_dtype, paged, cluster, grid, s, resident);
}

bool narrow_head_dim(int d) { return d == 8 || d == 16 || d == 32; }

// The narrow kernel: a GQA group of 1-8 q heads (rows == the group), a
// cluster of `cluster` blocks (1-8) per (sequence, KV head), each walking
// `walks` chunks of `chunk` tokens.
template <bool kPaged>
int launch_narrow(GroupParams& p, int q_dtype, int kv_dtype, int batch, int hq, int hkv, int passes, int rows,
                  int head_dim, int cluster, const long long* st, cudaStream_t s) {
  if (batch <= 0 || batch > 65535 || hkv <= 0 || hkv > 65535 || hq <= 0 || hq % hkv != 0 ||
      !narrow_head_dim(head_dim) || q_dtype < 0 || q_dtype > 2 || kv_dtype < 0 || kv_dtype > 2 || passes != 1 ||
      rows != hq / hkv || rows > kNMaxRows || cluster < 1 || cluster > kClusterMax || p.page_size <= 0 ||
      p.pages_per_seq <= 0 || p.chunk <= 0 || p.walks <= 0 || (kv_dtype != 0) != (p.ks != nullptr && p.vs != nullptr))
    return (int)cudaErrorInvalidValue;
  const int capacity = kPaged ? p.page_size * p.pages_per_seq : p.page_size;
  if ((long long)cluster * p.chunk * p.walks < capacity ||
      (kPaged && (p.chunk % p.page_size != 0 || (long long)p.walks * (p.chunk / p.page_size) > kClusterMaxPages)))
    return (int)cudaErrorInvalidValue;
  p.q_sb = st[0]; p.q_sh = st[1];
  p.o_sb = st[2]; p.o_sh = st[3];
  p.k_sh = st[4]; p.k_sp = st[5]; p.k_sr = st[6];
  p.v_sh = st[7]; p.v_sp = st[8]; p.v_sr = st[9];
  p.s_sh = st[10]; p.s_sp = st[11];
  p.group = hq / hkv;
  p.passes = 1;
  p.pass_rows = rows;
  p.head_dim = head_dim;
  const dim3 grid(cluster, hkv, batch);
  return (int)narrow_dispatch(p, q_dtype, kv_dtype, kPaged, cluster, grid, s, nullptr);
}

// The wide kernel: passes x pass_rows q heads cover the group (every pass
// live, pass_rows 1-8), a cluster of `cluster` blocks (1-8) per (sequence,
// KV head, pass), each walking `walks` chunks of `chunk` tokens.
template <bool kPaged>
int launch_wide(WideParams& p, int q_dtype, int kv_dtype, int batch, int hq, int hkv, int passes, int pass_rows,
                int head_dim, int cluster, const long long* st, cudaStream_t s) {
  if (batch <= 0 || batch > 65535 || hkv <= 0 || hq <= 0 || hq % hkv != 0 || !wide_head_dim(head_dim) ||
      q_dtype < 0 || q_dtype > 2 || kv_dtype < 0 || kv_dtype > 2 || pass_rows < 1 || pass_rows > kWMaxRows ||
      passes < 1 || (long long)hkv * passes > 65535 || (long long)passes * pass_rows < hq / hkv ||
      (long long)(passes - 1) * pass_rows >= hq / hkv || cluster < 1 || cluster > kClusterMax ||
      p.page_size <= 0 || p.pages_per_seq <= 0 || p.chunk <= 0 || p.walks <= 0 ||
      (kv_dtype != 0) != (p.ks != nullptr && p.vs != nullptr))
    return (int)cudaErrorInvalidValue;
  const int capacity = kPaged ? p.page_size * p.pages_per_seq : p.page_size;
  if ((long long)cluster * p.chunk * p.walks < capacity ||
      (kPaged && (p.chunk % p.page_size != 0 || (long long)p.walks * (p.chunk / p.page_size) > kClusterMaxPages)))
    return (int)cudaErrorInvalidValue;
  p.q_sb = st[0]; p.q_sh = st[1];
  p.o_sb = st[2]; p.o_sh = st[3];
  p.k_sh = st[4]; p.k_sp = st[5]; p.k_sr = st[6];
  p.v_sh = st[7]; p.v_sp = st[8]; p.v_sr = st[9];
  p.s_sh = st[10]; p.s_sp = st[11];
  p.group = hq / hkv;
  p.passes = passes;
  p.pass_rows = pass_rows;
  p.head_dim = head_dim;
  const dim3 grid(cluster, hkv * passes, batch);
  return (int)wide_dispatch(p, q_dtype, kv_dtype, head_dim, kPaged, cluster, grid, s, nullptr);
}

}  // namespace
}  // namespace decode
}  // namespace fa

using fa::decode::DecodeParams;
using fa::decode::GroupParams;
using fa::decode::WideParams;
using fa::decode::launch_decode;
using fa::decode::group_dispatch;
using fa::decode::group_head_dim;
using fa::decode::group_max_rows;
using fa::decode::launch_group;
using fa::decode::launch_narrow;
using fa::decode::launch_wide;
using fa::decode::narrow_dispatch;
using fa::decode::narrow_head_dim;
using fa::decode::wide_dispatch;

// Common arguments.  q_dtype: 0 = float32, 1 = bfloat16, 2 = float16.
// kv_dtype: 0 = the payload is q's dtype (no scales), 1 = int8, 2 =
// float8_e4m3fn (both with k_scales / v_scales).  head_dim 64, 128 or 256
// (8-32 and above 256: the narrow, whole-group and wide entry points,
// below); any hq / hkv, run in group_tiles tiles of
// group_rows (1-8) q heads, a block each (the last tile may hold fewer;
// the caller chooses both, and a pair that does not cover the group with
// every tile live is refused).  strides (elements): q (batch,
// head), out (batch, head), k and v (head, page or slot, row), scales
// (head, page or slot); every last dim is contiguous and payload rows are
// 16-byte aligned.  The split: `splits`
// blocks of `chunk` tokens per (sequence, KV head, group tile), chunk *
// splits >= the capacity, splits <= 64; for K5 the chunk is whole pages, at
// most 256 of them.  workspace: batch * hkv * group_tiles * splits * group_rows *
// (head_dim + 2) fp32; counters:
// batch * hkv * group_tiles int32, zero before the first launch (each launch
// leaves them zero); both may be null when splits == 1.  Returns a
// cudaError_t (0 on success).

// K5.  lengths [batch] int32 count the current token; n = max(lengths +
// len_add, 1) tokens are read.  page_indices [batch, pages_per_seq] int32.
extern "C" int fa_paged_decode(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                               const void* v_scales, const void* lengths, const void* page_indices, void* out,
                               void* workspace, void* counters, int q_dtype, int kv_dtype, int batch, int hq,
                               int hkv, int group_tiles, int group_rows, int head_dim, int page_size,
                               int pages_per_seq,
                               int len_add, int chunk, int splits, const long long* strides, float sm_scale,
                               void* stream) {
  DecodeParams p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.table = static_cast<const int*>(page_indices);
  p.o = out;
  p.ws = static_cast<float*>(workspace);
  p.counters = static_cast<int*>(counters);
  p.page_size = page_size;
  p.pages_per_seq = pages_per_seq;
  p.len_add = len_add;
  p.chunk = chunk;
  p.splits = splits;
  p.q_scale = 1.f;
  p.score_scale = sm_scale;
  if (page_indices == nullptr) return (int)cudaErrorInvalidValue;
  return launch_decode<true>(p, q_dtype, kv_dtype, batch, hq, hkv, group_tiles, group_rows, head_dim, strides,
                             static_cast<cudaStream_t>(stream));
}

// K6.  k / v are one layer of the slot-major cache, [hkv, slots, max_len,
// D]; lengths [slots] int32 exclude the current token (n = lengths + 1).
extern "C" int fa_fused_decode(const void* q, const void* k, const void* v, const void* k_scales,
                               const void* v_scales, const void* lengths, void* out, void* workspace,
                               void* counters, int q_dtype, int kv_dtype, int slots, int hq, int hkv,
                               int group_tiles, int group_rows, int head_dim, int max_len, int chunk,
                               int splits,
                               const long long* strides, float sm_scale, void* stream) {
  DecodeParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.table = nullptr;
  p.o = out;
  p.ws = static_cast<float*>(workspace);
  p.counters = static_cast<int*>(counters);
  p.page_size = max_len;
  p.pages_per_seq = 1;
  p.len_add = 1;
  p.chunk = chunk;
  p.splits = splits;
  p.q_scale = sm_scale;
  p.score_scale = 1.f;
  return launch_decode<false>(p, q_dtype, kv_dtype, slots, hq, hkv, group_tiles, group_rows, head_dim, strides,
                              static_cast<cudaStream_t>(stream));
}

// The whole-group kernels: a GQA group above 8 at head_dim 8, 16, 32, 64,
// 128 or 256 with fp32 (q_dtype 0; decode_group_fp32.cuh), bf16 (1) or fp16
// (2) q (decode_group.cuh).  Arguments as above, but no workspace or
// counters: the group runs in `passes` passes of `pass_rows` q heads (a
// multiple of 16, at most 128, 64 for fp32 q at 128, 32 at 256; every pass
// live), a
// cluster of `cluster` blocks (1-8) per (sequence, KV head,
// pass), block c of a cluster walking chunks c, c + cluster, ... of `chunk`
// tokens, `walks` of them; cluster * chunk * walks >= the capacity; for K5
// the chunk is whole pages and walks * pages of a chunk <= 1024.

// K5 over a GQA group above 8.
extern "C" int fa_paged_decode_group(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                                     const void* v_scales, const void* lengths, const void* page_indices, void* out,
                                     int q_dtype, int kv_dtype, int batch, int hq, int hkv, int passes,
                                     int pass_rows, int head_dim, int page_size, int pages_per_seq, int len_add,
                                     int cluster, int chunk, int walks, const long long* strides, float sm_scale,
                                     void* stream) {
  GroupParams p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.table = static_cast<const int*>(page_indices);
  p.o = out;
  p.page_size = page_size;
  p.pages_per_seq = pages_per_seq;
  p.len_add = len_add;
  p.chunk = chunk;
  p.walks = walks;
  p.q_scale = 1.f;
  p.score_scale = sm_scale;
  if (page_indices == nullptr) return (int)cudaErrorInvalidValue;
  return launch_group<true>(p, q_dtype, kv_dtype, batch, hq, hkv, passes, pass_rows, head_dim, cluster, strides,
                            static_cast<cudaStream_t>(stream));
}

// K6 over a GQA group above 8: one layer of the slot-major cache, lengths
// exclude the current token.
extern "C" int fa_fused_decode_group(const void* q, const void* k, const void* v, const void* k_scales,
                                     const void* v_scales, const void* lengths, void* out, int q_dtype,
                                     int kv_dtype, int slots, int hq, int hkv, int passes, int pass_rows,
                                     int head_dim, int max_len, int cluster, int chunk, int walks,
                                     const long long* strides, float sm_scale, void* stream) {
  GroupParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.table = nullptr;
  p.o = out;
  p.page_size = max_len;
  p.pages_per_seq = 1;
  p.len_add = 1;
  p.chunk = chunk;
  p.walks = walks;
  p.q_scale = sm_scale;
  p.score_scale = 1.f;
  return launch_group<false>(p, q_dtype, kv_dtype, slots, hq, hkv, passes, pass_rows, head_dim, cluster, strides,
                             static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` blocks of the whole-group kernel for (q
// dtype, payload, head_dim, pass_rows, K5 or K6) the card holds at once
// (cudaOccupancyMaxActiveClusters); the host's split keeps a step's
// clusters within it.  Returns the count, or minus a cudaError_t.
extern "C" int fa_decode_group_resident(int q_dtype, int kv_dtype, int head_dim, int pass_rows, int paged,
                                        int cluster) {
  if (q_dtype < 0 || q_dtype > 2 || !group_head_dim(head_dim) || kv_dtype < 0 || kv_dtype > 2 ||
      pass_rows < 16 || pass_rows % 16 != 0 || pass_rows > group_max_rows(q_dtype, head_dim) || cluster < 1 ||
      cluster > fa::decode::kClusterMax)
    return -(int)cudaErrorInvalidValue;
  GroupParams p{};
  p.pass_rows = pass_rows;
  int resident = 0;
  const cudaError_t e =
      group_dispatch(p, q_dtype, kv_dtype, head_dim, paged != 0, cluster, dim3(cluster), nullptr, &resident);
  return e != cudaSuccess ? -(int)e : resident;
}

// The wide kernels (decode_wide.cuh): head_dim 384-1024 (a multiple of 128)
// for every q dtype, payload and group.  Arguments as the whole-group entry
// points', but passes of `pass_rows` q heads (1-8; every pass live), a
// cluster of `cluster` blocks (1-8) per (sequence, KV head, pass), block c
// walking chunks c, c + cluster, ... of `chunk` tokens, `walks` of them;
// cluster * chunk * walks >= the capacity; for K5 the chunk is whole pages
// and walks * pages of a chunk <= 1024.  Rows of q, K and V 16-byte aligned.

// K5 at head dims above 256.
extern "C" int fa_paged_decode_wide(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                                    const void* v_scales, const void* lengths, const void* page_indices, void* out,
                                    int q_dtype, int kv_dtype, int batch, int hq, int hkv, int passes, int pass_rows,
                                    int head_dim, int page_size, int pages_per_seq, int len_add, int cluster,
                                    int chunk, int walks, const long long* strides, float sm_scale, void* stream) {
  WideParams p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.table = static_cast<const int*>(page_indices);
  p.o = out;
  p.page_size = page_size;
  p.pages_per_seq = pages_per_seq;
  p.len_add = len_add;
  p.chunk = chunk;
  p.walks = walks;
  p.q_scale = 1.f;
  p.score_scale = sm_scale;
  if (page_indices == nullptr) return (int)cudaErrorInvalidValue;
  return launch_wide<true>(p, q_dtype, kv_dtype, batch, hq, hkv, passes, pass_rows, head_dim, cluster, strides,
                           static_cast<cudaStream_t>(stream));
}

// K6 at head dims above 256: one layer of the slot-major cache, lengths
// exclude the current token.
extern "C" int fa_fused_decode_wide(const void* q, const void* k, const void* v, const void* k_scales,
                                    const void* v_scales, const void* lengths, void* out, int q_dtype, int kv_dtype,
                                    int slots, int hq, int hkv, int passes, int pass_rows, int head_dim, int max_len,
                                    int cluster, int chunk, int walks, const long long* strides, float sm_scale,
                                    void* stream) {
  WideParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.table = nullptr;
  p.o = out;
  p.page_size = max_len;
  p.pages_per_seq = 1;
  p.len_add = 1;
  p.chunk = chunk;
  p.walks = walks;
  p.q_scale = sm_scale;
  p.score_scale = 1.f;
  return launch_wide<false>(p, q_dtype, kv_dtype, slots, hq, hkv, passes, pass_rows, head_dim, cluster, strides,
                            static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` blocks of the wide kernel for (q dtype,
// payload, head_dim, pass_rows, K5 or K6) the card holds at once
// (cudaOccupancyMaxActiveClusters).  Returns the count, or minus a
// cudaError_t.
extern "C" int fa_decode_wide_resident(int q_dtype, int kv_dtype, int head_dim, int pass_rows, int paged,
                                       int cluster) {
  if (!fa::decode::wide_head_dim(head_dim) || q_dtype < 0 || q_dtype > 2 || kv_dtype < 0 || kv_dtype > 2 ||
      pass_rows < 1 || pass_rows > fa::decode::kWMaxRows || cluster < 1 || cluster > fa::decode::kClusterMax)
    return -(int)cudaErrorInvalidValue;
  WideParams p{};
  p.pass_rows = pass_rows;
  int resident = 0;
  const cudaError_t e =
      wide_dispatch(p, q_dtype, kv_dtype, head_dim, paged != 0, cluster, dim3(cluster), nullptr, &resident);
  return e != cudaSuccess ? -(int)e : resident;
}

// The narrow kernels (decode_narrow.cuh): head_dim 8, 16 or 32 at a GQA
// group of 1-8 q heads, every q dtype and payload.  Arguments as the
// whole-group entry points', but passes 1 and pass_rows the group; a
// cluster of `cluster` blocks (1-8) per (sequence, KV head), block c
// walking chunks c, c + cluster, ... of `chunk` tokens, `walks` of them;
// cluster * chunk * walks >= the capacity; for K5 the chunk is whole pages
// and walks * pages of a chunk <= 1024.  Payload rows min(16, d * its
// itemsize)-byte aligned.

// K5 at head dims 8-32.
extern "C" int fa_paged_decode_narrow(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                                      const void* v_scales, const void* lengths, const void* page_indices, void* out,
                                      int q_dtype, int kv_dtype, int batch, int hq, int hkv, int passes, int rows,
                                      int head_dim, int page_size, int pages_per_seq, int len_add, int cluster,
                                      int chunk, int walks, const long long* strides, float sm_scale, void* stream) {
  GroupParams p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.table = static_cast<const int*>(page_indices);
  p.o = out;
  p.page_size = page_size;
  p.pages_per_seq = pages_per_seq;
  p.len_add = len_add;
  p.chunk = chunk;
  p.walks = walks;
  p.q_scale = 1.f;
  p.score_scale = sm_scale;
  if (page_indices == nullptr) return (int)cudaErrorInvalidValue;
  return launch_narrow<true>(p, q_dtype, kv_dtype, batch, hq, hkv, passes, rows, head_dim, cluster, strides,
                             static_cast<cudaStream_t>(stream));
}

// K6 at head dims 8-32: one layer of the slot-major cache, lengths exclude
// the current token.
extern "C" int fa_fused_decode_narrow(const void* q, const void* k, const void* v, const void* k_scales,
                                      const void* v_scales, const void* lengths, void* out, int q_dtype,
                                      int kv_dtype, int slots, int hq, int hkv, int passes, int rows, int head_dim,
                                      int max_len, int cluster, int chunk, int walks, const long long* strides,
                                      float sm_scale, void* stream) {
  GroupParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.table = nullptr;
  p.o = out;
  p.page_size = max_len;
  p.pages_per_seq = 1;
  p.len_add = 1;
  p.chunk = chunk;
  p.walks = walks;
  p.q_scale = sm_scale;
  p.score_scale = 1.f;
  return launch_narrow<false>(p, q_dtype, kv_dtype, slots, hq, hkv, passes, rows, head_dim, cluster, strides,
                              static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` blocks of the narrow kernel for (q dtype,
// payload, head_dim, rows, K5 or K6) the card holds at once
// (cudaOccupancyMaxActiveClusters).  Returns the count, or minus a
// cudaError_t.
extern "C" int fa_decode_narrow_resident(int q_dtype, int kv_dtype, int head_dim, int rows, int paged, int cluster) {
  if (!narrow_head_dim(head_dim) || q_dtype < 0 || q_dtype > 2 || kv_dtype < 0 || kv_dtype > 2 || rows < 1 ||
      rows > fa::decode::kNMaxRows || cluster < 1 || cluster > fa::decode::kClusterMax)
    return -(int)cudaErrorInvalidValue;
  GroupParams p{};
  p.pass_rows = rows;
  int resident = 0;
  const cudaError_t e = narrow_dispatch(p, q_dtype, kv_dtype, paged != 0, cluster, dim3(cluster), nullptr, &resident);
  return e != cudaSuccess ? -(int)e : resident;
}
