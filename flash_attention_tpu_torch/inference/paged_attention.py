"""Paged attention: decode against a non-contiguous paged KV cache.

Port of `flash_attention_tpu/inference/paged_attention.py`.  The cache lives
as pages [kv_heads, total_pages, page_size, head_dim]; each sequence owns a
`page_indices` row mapping its logical blocks to physical pages.
`paged_attention` looks at the device of its inputs:

* CUDA tensors go to K5, `fa_paged_decode` (`csrc/decode.cuh`), a split-KV
  kernel: each (sequence, KV head) is split into chunks of whole pages
  (`decode_split`, from the cache's capacity and the SM count), one thread
  block each; a block stages its chunk's page ids once, streams its rows
  through a shared-memory ring with `cp.async`, stops at the length (so a
  decode step's bytes track the live context) and dequantizes int8/fp8
  rows by their per-token scales; the last block of a sequence to finish
  merges the chunks' softmax states in the same launch, through a
  workspace this module allocates once per device and size.  Nothing falls
  back: what the kernel does not take raises.
* CPU tensors go to the plain version, `paged_attention_ref` (gather +
  dequantize + dense masked softmax, a port of the JAX reference).
  `paged_attention_split_ref` is the kernels' chunk-and-merge arithmetic
  in plain PyTorch, which the tests hold against the JAX package.

`_launch_decode` is also K6's launcher (`decode_attention.decode_attention_fused`):
both kernels are one template in `csrc/decode.cuh`, with two entry points in
`csrc/decode.cu`.  They take fp32, bf16 and fp16 q, any GQA group (split
into group tiles of at most 8 q heads, `group_tiles`) and every head dim
that is a multiple of 16 from 48 to 256, run at 64, 128 or 256
(`decode_width`: a row's d columns are copied, the columns past them
zero-filled in shared memory).  Head dims 8, 16 and 32 at GQA groups of up to 8
(`uses_narrow_kernel`, every q dtype and payload) run the narrow kernels of
`csrc/decode_narrow.cuh` (`fa_paged_decode_narrow`, `fa_fused_decode_narrow`;
launch keys "paged_decode_narrow" / "fused_decode_narrow"): a (sequence, KV
head) is a thread-block cluster whose blocks walk interleaved chunks of 128
tokens, each warp 32-token tiles with a lane a token, merged over
distributed shared memory; their plan in plain PyTorch is
`paged_attention_narrow_ref`.  Head dims above 256 (every multiple of 16
from 272 to 1024, run at 512 or 1024; `uses_wide_kernel`, for every q dtype
and group) run the wide kernels of `csrc/decode_wide.cuh`
(`fa_paged_decode_wide`, `fa_fused_decode_wide`; launch keys
"paged_decode_wide" / "fused_decode_wide"): a (sequence, KV head, pass of at
most 8 q heads) is a thread-block cluster whose blocks walk chunks of one
stage and merge over distributed shared memory, a producer warp keeping
several stages in flight with bulk copies; their plan
in plain PyTorch is `paged_attention_group_ref` at the wide split's cluster
and chunk.  `HEAD_DIMS` lists every head dim the decode kernels take.  A GQA
group above 8 (`uses_group_kernel`: multi-query attention, Falcon-40B's 16
q heads a KV head, RecurrentGemma-2B's 10 at D256) runs instead the
whole-group kernels (`fa_paged_decode_group`, `fa_fused_decode_group`):
with bf16 or fp16 q at head dims 8-256 (8-32 run at 32, 48-256 at 64, 128
or 256) those of `csrc/decode_group.cuh`
(launch keys "paged_decode_group" / "fused_decode_group", S and P V on
`mma.sync`; 8-32 run at 32, where the warps split P V by tokens), with fp32
q at the same head dims those of `csrc/decode_group_fp32.cuh` (keys
"paged_decode_group_fp32" / "fused_decode_group_fp32", 3xTF32 on
`mma.sync`, two passes over an int8 / fp8 payload): the whole group in one
block and a (sequence, KV head)'s blocks merged in a thread-block cluster,
with no workspace; their chunk-and-merge plan in plain PyTorch is
`paged_attention_group_ref`, at stages of `group_tokens`.  Both cluster
kernels share their merge and launch (`csrc/decode_cluster.cuh`) and their
plan (`cluster_plan`, split by `decode_cluster_split`).
The TPU kernel's `pages_per_compute_block` (pages per DMA step) has no
counterpart: the CUDA kernel's chunks are set by the split.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from ..config import kernel_route
from ..kernels.flash_attention import _DTYPE_CODES, KERNEL_LAUNCHES
from ..kernels.vanilla import DEFAULT_MASK_VALUE
from ..quant.kv import QUANT_DTYPES

__all__ = [
    "cluster_plan", "decode_cluster_split", "decode_split", "decode_width", "group_max_rows", "group_passes",
    "group_tiles", "group_tokens", "paged_attention", "paged_attention_group_ref", "paged_attention_narrow_ref",
    "paged_attention_ref", "paged_attention_split_ref", "uses_group_kernel", "uses_narrow_kernel", "uses_wide_kernel",
    "wide_passes", "wide_tokens",
]

_Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # what csrc/decode.cuh instantiates
# head dims the decode kernels take: 8, 16 and 32 (the narrow kernel; the
# whole-group kernels run them at 32) and every multiple of 16 from 48 to
# the 1024 that caps the port's flash kernels, each run at `decode_width`.
# The JAX package's decode entry points answer at every head dim (their
# kernels where d divides 128 or 128 divides d, their einsum elsewhere); the
# kernels here copy a row's d columns in 16-byte pieces, so d x 1 byte (an
# 8-bit row) must be whole pieces: d = 24, 40, 56, ... and d < 8 or above
# 1024 raise
HEAD_DIMS = (8, 16, 32) + tuple(range(48, 1025, 16))
# the head dims the kernel templates are instantiated at (`decode_width`)
DECODE_WIDTHS = (32, 64, 128, 256, 512, 1024)
# csrc/decode.cuh's split: tokens of a ring tile (kTile), warps of a block
# (kWarps; each takes every fourth tile of its block's chunk), q rows of a
# group tile (kMaxRows), splits a sequence may have (kMaxSplits), page ids a
# chunk may hold (kMaxPages)
DECODE_TILE = 16
DECODE_WARPS = 4
MAX_ROWS = 8
MAX_SPLITS = 64
MAX_CHUNK_UNITS = 256
BLOCKS_PER_SM = 4  # the blocks per SM the split aims at over the whole capacity
# csrc/decode_cluster.cuh's limits, shared by the whole-group and the wide
# kernels: blocks of a cluster at most (kClusterMax; the kernels take any
# size up to it), page ids a block stages (kClusterMaxPages)
CLUSTER_MAX = 8
CLUSTER_MAX_PAGES = 1024
# the cluster sizes the split may choose for each cluster kernel.  The wide
# kernel takes any (one block an SM: 16 pairs run clusters of 6, where 15 of
# 7 or 8 fit).  The whole-group kernel's blocks share SMs two at a time, and
# there a size between the powers of two was slower: Falcon-40B's K5 layer
# (64 pairs, 16 chunks) in clusters of 3 against 2 (PERF.md §6,
# `tools/decode_ab.py --cluster 3`)
CLUSTER_SIZES = {"group": (1, 2, 4, 8), "wide": tuple(range(1, CLUSTER_MAX + 1)), "narrow": (1, 2, 4, 8)}
# csrc/decode_narrow.cuh's plan: its head dims (at groups of up to
# MAX_ROWS), the tokens of a warp's tile (kNTile, a lane a token) and of a
# chunk at least (kNChunk: a tile for each of a block's 4 warps)
NARROW_HEAD_DIMS = (8, 16, 32)
NARROW_TILE = 32
NARROW_TOKENS = DECODE_WARPS * NARROW_TILE
# the whole-group kernels' plan: tokens of a ring stage at most
# (GroupLayout::kTok, GroupLayout32::kTok; `group_tokens`), bytes of a
# stage's K tile at most, q heads of a pass (kGMaxRows, 8 row tiles of 16;
# for fp32 q at D128 kGMaxRows32D128, 4 row tiles, each two warps a token,
# and at D256 kGMaxRows32D256, 2 row tiles, each four warps a token; for
# bf16 / fp16 q at D256 kGMaxRowsD256, 2 row tiles), head dims by q's dtype
GROUP_TOKENS = 128
GROUP_STAGE_BYTES = 32768
GROUP_MAX_ROWS = 128
GROUP_MAX_ROWS_FP32_D128 = 64
GROUP_MAX_ROWS_FP32_D256 = 32
GROUP_MAX_ROWS_D256 = 32
GROUP_HEAD_DIMS = {dtype: (8, 16, 32) + tuple(range(48, 257, 16))
                   for dtype in (torch.float32, torch.bfloat16, torch.float16)}
# csrc/decode_wide.cuh's plan: bytes of a K (or V) ring slot at most
# (kWSlotBytes; a stage is at most 32 tokens of padded rows), q heads of a
# pass (kWMaxRows)
WIDE_SLOT_BYTES = 65536
WIDE_MAX_ROWS = 8


def paged_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain version of K5: gather and dequantize the pages, dense masked
    attention in fp32 over the first max(lengths, 1) tokens.  Rows past the
    length are zeroed before the PV product, so garbage there (NaN in a
    recycled page) cannot leak through 0 * NaN; the kernel never reads
    them."""
    batch, hq, d = q.shape
    hkv, _, page_size, _ = k_pages.shape
    group = hq // hkv
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    pi = page_indices.long()
    k = k_pages[:, pi].float().movedim(1, 0)  # [batch, hkv, pps, page_size, d]
    v = v_pages[:, pi].float().movedim(1, 0)
    if k_scales is not None:
        k = k * k_scales[:, pi].movedim(1, 0)[..., None]
        v = v * v_scales[:, pi].movedim(1, 0)[..., None]
    l_max = k.shape[2] * page_size
    k = k.reshape(batch, hkv, l_max, d)
    v = v.reshape(batch, hkv, l_max, d)
    q4 = q.reshape(batch, hkv, group, d).float()
    s = torch.einsum("bhgd,bhld->bhgl", q4, k) * sm_scale
    valid = torch.arange(l_max, device=q.device)[None, :] < lengths.clamp(min=1)[:, None]
    s = torch.where(valid[:, None, None, :], s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    v = torch.where(valid[:, None, :, None], v, 0.0)
    o = torch.einsum("bhgl,bhld->bhgd", p, v)
    return o.reshape(batch, hq, d).to(q.dtype)


def paged_attention_split_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    chunk: int,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    sm_scale: float | None = None,
    prescale_q: bool = False,
) -> torch.Tensor:
    """Plain version of the decode kernels' split-KV arithmetic: each
    sequence's first max(lengths, 1) tokens in chunks of `chunk` tokens
    (the kernels' splits), each chunk's softmax state (m, l, acc) taken
    alone in fp32, then merged with the lse rule, out = sum_s acc_s
    e^(m_s - M) / sum_s l_s e^(m_s - M), with the l == 0 guard.  A chunk at
    or past a sequence's length is empty (m = -inf, l = 0) and adds nothing.
    `prescale_q` False scores as K5 does, (q . k) * sm_scale * k_scale; True
    as K6 does, with q * sm_scale rounded to q's dtype first (K6 over the
    slot-major cache is this function over `page_view(cache, layer,
    max_len)` and its identity page table, with lengths + 1).  p * v_scale
    is rounded to q's dtype before the PV product; rows past the length are
    never read (masked before any product, so NaN there cannot leak)."""
    states = _chunk_states(q, k_pages, v_pages, lengths, page_indices, chunk, k_scales, v_scales, sm_scale, prescale_q)
    return _finish(q, _merge(states))


def paged_attention_group_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    cluster: int,
    chunk: int,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    sm_scale: float | None = None,
    prescale_q: bool = False,
) -> torch.Tensor:
    """Plain version of the cluster kernels' plan (`csrc/decode_group.cuh`,
    `csrc/decode_wide.cuh`): the whole GQA group at once; each sequence's
    capacity in chunks of `chunk` tokens (`decode_cluster_split`), block c
    of a cluster of `cluster` taking chunks c, c + cluster, ... and merging
    their softmax states in walk order into its own (m, l, acc); then the
    cluster's merge, the
    blocks' states in rank order, with the l == 0 guard.  A block whose
    chunks hold no live token has m = -inf, l = 0 and adds nothing.
    Scoring, rounding and `prescale_q` as `paged_attention_split_ref`."""
    states = _chunk_states(q, k_pages, v_pages, lengths, page_indices, chunk, k_scales, v_scales, sm_scale, prescale_q)
    blocks = [_merge(states[c::cluster]) for c in range(min(cluster, len(states)))]  # a block past them: empty
    return _finish(q, _merge(blocks))


def paged_attention_narrow_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    cluster: int,
    chunk: int,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    sm_scale: float | None = None,
    prescale_q: bool = False,
) -> torch.Tensor:
    """Plain version of the narrow kernels' plan (`csrc/decode_narrow.cuh`,
    head dims 8-32 at groups of up to 8): each sequence's capacity in
    chunks of `chunk` tokens, block c of a cluster of `cluster` walking
    chunks c, c + cluster, ...; a chunk in tiles of NARROW_TILE (32) tokens
    (the last may hold fewer), the block's tiles in walk order dealt to its
    DECODE_WARPS (4) warps in turn; each warp an online softmax over its
    tiles (a tile's max joins the running max m, p = e^(s - m) after it, l
    and acc rescaled by e^(m_old - m), p * v_scale rounded to q's dtype
    before P V); the warps' states merged in warp order, then the blocks'
    in rank order, with the l == 0 guard.  A tile at or past a sequence's
    length is skipped; a warp or block without one has m = -inf, l = 0 and
    adds nothing.  Scoring, rounding and `prescale_q` as
    `paged_attention_split_ref`."""
    q4, score_scale, k, v, ks, vs, n = _gathered(q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales,
                                                 sm_scale, prescale_q)
    cap = k.shape[2]
    pos = torch.arange(cap, device=q.device)
    blocks = []
    for c in range(cluster):
        tiles = [(t0, min(t0 + NARROW_TILE, c0 + chunk, cap)) for c0 in range(c * chunk, cap, cluster * chunk)
                 for t0 in range(c0, min(c0 + chunk, cap), NARROW_TILE)]
        warps = []
        for w in range(DECODE_WARPS):
            m = torch.full(q4.shape[:3], -math.inf, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(q4)
            for t0, t1 in tiles[w::DECODE_WARPS]:
                valid = (pos[t0:t1][None, :] < n[:, None])[:, None, :]  # [batch, 1, tile]
                live = valid[..., 0:1]  # the tile's first token: the tile is the warp's
                s = torch.einsum("bhgd,bhld->bhgl", q4, torch.where(valid[..., None], k[:, :, t0:t1], 0.0))
                s = (s * score_scale) * ks[:, :, None, t0:t1]
                s = torch.where(valid[:, :, None], s, -math.inf)
                m_new = torch.where(live, torch.maximum(m, s.amax(dim=-1)), m)
                alpha = torch.where(live, torch.exp(m - m_new), 1.0)  # 0 while m is -inf
                p = torch.where(valid[:, :, None], torch.exp(s - m_new[..., None]), 0.0)
                pr = torch.where(valid[:, :, None], p * vs[:, :, None, t0:t1], 0.0).to(q.dtype).float()
                vt = torch.where(valid[..., None], v[:, :, t0:t1], 0.0)
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum("bhgl,bhld->bhgd", pr, vt)
                m = m_new
            warps.append((m, l, acc))
        blocks.append(_merge(warps))
    return _finish(q, _merge(blocks))


def _gathered(q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales, sm_scale, prescale_q):
    """The kernels' inputs in plain form, in fp32: q [batch, hkv, group, d]
    as scored (K6's pre-scaled and rounded to q's dtype with
    `prescale_q`) and the score scale that goes with it, K and V [batch,
    hkv, capacity, d] gathered through the page table, their scales [batch,
    hkv, capacity] (ones without), and each sequence's live tokens
    max(lengths, 1) up to the capacity."""
    batch, hq, d = q.shape
    hkv, _, page_size, _ = k_pages.shape
    group = hq // hkv
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    pi = page_indices.long()
    cap = pi.shape[1] * page_size
    k = k_pages[:, pi].movedim(1, 0).float().reshape(batch, hkv, cap, d)
    v = v_pages[:, pi].movedim(1, 0).float().reshape(batch, hkv, cap, d)
    ones = torch.ones(batch, hkv, cap, device=q.device)
    ks = k_scales[:, pi].movedim(1, 0).reshape(batch, hkv, cap) if k_scales is not None else ones
    vs = v_scales[:, pi].movedim(1, 0).reshape(batch, hkv, cap) if v_scales is not None else ones
    if prescale_q:
        q4, score_scale = (q.float() * sm_scale).to(q.dtype).float(), 1.0
    else:
        q4, score_scale = q.float(), sm_scale
    q4 = q4.reshape(batch, hkv, group, d)
    n = lengths.long().clamp(min=1, max=cap)
    return q4, score_scale, k, v, ks, vs, n


def _chunk_states(q, k_pages, v_pages, lengths, page_indices, chunk, k_scales, v_scales, sm_scale, prescale_q):
    """Each chunk's softmax state (m, l, acc) over [batch, hkv, group(, d)],
    in fp32, for chunks of `chunk` tokens over the page table's capacity:
    the first max(lengths, 1) tokens live, the rest masked before any
    product (m = -inf, l = 0 for a chunk without a live token)."""
    q4, score_scale, k, v, ks, vs, n = _gathered(q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales,
                                                 sm_scale, prescale_q)
    cap = k.shape[2]
    pos = torch.arange(cap, device=q.device)
    states = []
    for c0 in range(0, cap, chunk):
        c1 = min(c0 + chunk, cap)
        valid = (pos[c0:c1][None, :] < n[:, None])[:, None, :]  # [batch, 1, c]
        s = torch.einsum("bhgd,bhld->bhgl", q4, torch.where(valid[..., None], k[:, :, c0:c1], 0.0))
        s = (s * score_scale) * ks[:, :, None, c0:c1]
        s = torch.where(valid[:, :, None], s, -math.inf)
        m = s.amax(dim=-1)  # -inf for an empty chunk
        p = torch.exp(s - torch.where(m == -math.inf, 0.0, m)[..., None])  # 0 where masked
        pr = torch.where(valid[:, :, None], p * vs[:, :, None, c0:c1], 0.0).to(q.dtype).float()
        vc = torch.where(valid[..., None], v[:, :, c0:c1], 0.0)
        states.append((m, p.sum(dim=-1), torch.einsum("bhgl,bhld->bhgd", pr, vc)))
    return states


def _merge(states):
    """Softmax states merged with the lse rule, in list order: M = max m_s,
    l = sum_s l_s e^(m_s - M), acc = sum_s acc_s e^(m_s - M); a state with
    m = -inf adds nothing (all of them empty: m = -inf, l = 0)."""
    m = torch.stack([s[0] for s in states])
    top = m.amax(dim=0)
    w = torch.where(m == -math.inf, 0.0, torch.exp(m - top))
    l = (torch.stack([s[1] for s in states]) * w).sum(dim=0)
    acc = (torch.stack([s[2] for s in states]) * w[..., None]).sum(dim=0)
    return top, l, acc


def _finish(q, state):
    """out = acc / l (l == 0 read as 1), [batch, hq, d] in q's dtype."""
    _, l, acc = state
    o = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return o.reshape(q.shape).to(q.dtype)


def group_tiles(group: int) -> tuple[int, int]:
    """(tiles, rows): a GQA group of `group` q heads runs in `tiles` blocks
    of `rows` q heads each (the last may hold fewer), at most MAX_ROWS rows
    a tile and as even as they go (multi-query attention at 16 q heads: 2
    tiles of 8; Falcon-7B's 71: 9 tiles of 8, the last of 7).  The
    launcher passes both to the kernels, which launch `tiles` blocks a KV
    head and only check that the pair covers the group."""
    tiles = -(-group // MAX_ROWS)
    return tiles, -(-group // tiles)


def decode_split(capacity: int, pairs: int, unit: int, sms: int) -> tuple[int, int]:
    """(chunk, splits) of the decode kernels: the tokens each thread block
    takes, and the blocks per (sequence, KV head, group tile).  Chosen from
    the cache's capacity, the number of those triples (`pairs`) and the SM
    count, never from the lengths (they live on the card: reading them
    would cost a sync).  The chunk is the largest power of two, at least one ring tile
    per warp, of at most capacity * pairs / (BLOCKS_PER_SM * sms) tokens, rounded up to
    whole `unit`s (K5's page size; K6 passes the tile) and capped at
    MAX_CHUNK_UNITS units (K5 stages a chunk's page ids in shared memory);
    splits * chunk covers the capacity.  At half the capacity live that
    leaves about two blocks with work per SM: at 8 slots x 12 heads over
    1024 tokens, chunks of 128 and 8 splits, of which 4-5 hold live tokens
    at contexts near 512."""
    want = capacity * pairs / (BLOCKS_PER_SM * sms)
    chunk = DECODE_WARPS * DECODE_TILE
    while chunk * 2 <= want:
        chunk *= 2
    chunk = max(chunk, -(-capacity // MAX_SPLITS))
    chunk = min(-(-chunk // unit), -(-capacity // unit), MAX_CHUNK_UNITS) * unit
    splits = -(-capacity // chunk)
    if splits > MAX_SPLITS:
        raise NotImplementedError(
            f"the decode kernels split a sequence into at most {MAX_SPLITS} chunks of at most {MAX_CHUNK_UNITS} "
            f"pages; a capacity of {capacity} tokens in pages of {unit} needs {splits}"
        )
    return chunk, splits


def decode_width(head_dim: int) -> int:
    """The head dim D that the decode kernels run `head_dim` at: 32 for 8,
    16 and 32 (the whole-group kernels' D32; the narrow kernel has no D),
    else the first of 64, 128, 256, 512 and 1024 that holds it, the rule K1
    pads by (`kernels.flash_attention.padded_head_dim`).  A row's d columns
    are copied from the cache and the columns d..D-1 zero-filled in shared
    memory without a read, so that the bytes read track d; the layouts,
    registers and stage sizes are D's."""
    return next(w for w in DECODE_WIDTHS if head_dim <= w)


def uses_group_kernel(q_dtype: torch.dtype, head_dim: int, group: int) -> bool:
    """Whether a decode call runs the whole-group kernels: a GQA group above
    MAX_ROWS (8) q heads at head dim 8, 16, 32 (run at 32) or a multiple of
    16 from 48 to 256 (run at 64, 128 or 256; GROUP_HEAD_DIMS), with bf16 or
    fp16 q (`csrc/decode_group.cuh`) or fp32 q (`csrc/decode_group_fp32.cuh`).
    Head dims above 256 run the wide kernels (`uses_wide_kernel`), groups of
    up to 8 the narrow kernels at head dims 8-32 (`uses_narrow_kernel`) and
    the group tiles of `csrc/decode.cuh` at 48-256."""
    return group > MAX_ROWS and head_dim in GROUP_HEAD_DIMS.get(q_dtype, ())


def uses_narrow_kernel(q_dtype: torch.dtype, head_dim: int, group: int) -> bool:
    """Whether a decode call runs the narrow kernels
    (`csrc/decode_narrow.cuh`): head dims 8, 16 and 32 (NARROW_HEAD_DIMS) at
    GQA groups of up to MAX_ROWS (8) q heads, for every q dtype and
    payload.  A larger group at those head dims runs the whole-group
    kernels (`uses_group_kernel`)."""
    return head_dim in NARROW_HEAD_DIMS and group <= MAX_ROWS


def group_max_rows(q_dtype: torch.dtype, head_dim: int) -> int:
    """The q heads a pass of the whole-group kernels holds at most:
    GROUP_MAX_ROWS (128); for fp32 q GROUP_MAX_ROWS_FP32_D128 (64) at head
    dim 128 and GROUP_MAX_ROWS_FP32_D256 (32) at 256, where a row tile's
    head dim is split over two or four of the block's 8 warps; and
    GROUP_MAX_ROWS_D256 (32) for bf16 / fp16 q at 256, where a warp holds
    q's A fragments for all 256 columns (64 registers) beside its column
    slice's accumulators (with 4 row tiles, a slice of 128 columns, they
    spill).  The limits are the instantiated width's (`decode_width`): d 80
    runs in D128's."""
    width = decode_width(head_dim)
    if q_dtype == torch.float32 and width in (128, 256):
        return GROUP_MAX_ROWS_FP32_D128 if width == 128 else GROUP_MAX_ROWS_FP32_D256
    return GROUP_MAX_ROWS_D256 if width == 256 else GROUP_MAX_ROWS


def group_passes(group: int, max_rows: int = GROUP_MAX_ROWS) -> tuple[int, int]:
    """(passes, rows): the whole-group kernels hold at most `max_rows`
    (`group_max_rows`: 128; 64 for fp32 q at D128, 32 at D256) q heads a
    block, in m16 row tiles; a larger group runs in `passes` passes of
    `rows` q heads (a multiple of 16, as even as they go; the last may hold
    fewer), a cluster each.  At 128 every real group is one pass: 16 -> (1,
    16), 71 -> (1, 80), 128 -> (1, 128), 200 -> (2, 112); at 64, 71 -> (2,
    48); at 32, 48 -> (2, 32), 71 -> (3, 32)."""
    tiles = -(-group // 16)
    passes = -(-tiles // (max_rows // 16))
    return passes, 16 * -(-tiles // passes)


def group_tokens(head_dim: int, itemsize: int) -> int:
    """Tokens of a stage of the whole-group kernels (`GroupLayout::kTok`,
    `GroupLayout32::kTok`) for a payload of `itemsize` bytes: as many rows
    as fill GROUP_STAGE_BYTES (32 KB) of K, at most GROUP_TOKENS (128): 128
    at head dims 8-128 for every 8- and 16-bit payload, for fp32 at head dims
    8-64 and for an 8-bit payload at D256; 64 for fp32 at D128 and for a
    16-bit payload at D256; 32 for fp32 at D256.  A chunk of the split holds
    at least one stage.  Rows are the instantiated width's (`decode_width`):
    an fp32 cache at d 80 takes D128's 64 tokens."""
    return min(GROUP_TOKENS, GROUP_STAGE_BYTES // (decode_width(head_dim) * itemsize))


def uses_wide_kernel(q_dtype: torch.dtype, head_dim: int, group: int) -> bool:
    """Whether a decode call runs the wide kernels (`csrc/decode_wide.cuh`):
    every head dim above 256 (272-1024, run at 512 or 1024), for every q
    dtype and GQA group."""
    return head_dim > 256


def wide_tokens(head_dim: int, itemsize: int) -> int:
    """Tokens of a stage of the wide kernels (`WideLayout::kTok`) for a
    payload of `itemsize` bytes: as many padded rows (512 or 1024 columns) as
    fill a 64 KB ring slot, at most 32: 32 for every 8- and 16-bit payload,
    16 for fp32 at 1024."""
    row = decode_width(head_dim) * itemsize
    return min(32, WIDE_SLOT_BYTES // row)


def wide_passes(group: int) -> tuple[int, int]:
    """(passes, rows): the wide kernels hold at most WIDE_MAX_ROWS (8) q
    heads a block; a larger group runs in `passes` passes of `rows` q heads
    (as even as they go; the last may hold fewer), a cluster each: 4 -> (1,
    4), 16 -> (2, 8), 71 -> (9, 8), 12 -> (2, 6)."""
    passes = -(-group // WIDE_MAX_ROWS)
    return passes, -(-group // passes)


def decode_cluster_split(capacity: int, pairs: int, unit: int, resident: dict[int, int], paged: bool,
                         tokens: int) -> tuple[int, int, int]:
    """(cluster, chunk, walks) of the cluster kernels (the whole-group and
    the wide kernels): the blocks of a (sequence, KV head, pass)'s cluster,
    the tokens of a chunk, and the chunks each block walks (block c takes
    chunks c, c + cluster, ...).  Chosen from the cache's capacity, the
    number of those `pairs` and what the card holds at once (`resident`:
    cluster size -> clusters of that size of this kernel resident together,
    from the SM count and each block's registers and shared memory), never
    from the lengths; its keys are the sizes the kernel may take,
    CLUSTER_SIZES).  A chunk is one ring stage of the kernel (`tokens`:
    `group_tokens`, or `wide_tokens`) rounded up to whole `unit`s (K5's page
    size; K6 passes the stage), so that the live tokens of a sequence spread
    evenly over its cluster.  The cluster is the largest of those sizes
    whose clusters all fit the card at once (one wave: a cluster left for a
    second wave doubles a step's time) and that leaves each block a chunk;
    K5 (`paged`) stages a block's page ids, at most CLUSTER_MAX_PAGES, which
    may ask for a larger cluster.  On an H100: SantaCoder's layer (8 slots,
    one KV head, 2048 tokens, the whole-group kernel) 8 clusters of 8, each
    block walking 2 chunks of 128 tokens; 16 pairs of the wide kernel
    clusters of 6 (17 of 6 fit at once, 15 of 7 or 8), 96 blocks."""
    chunk = -(-tokens // unit) * unit
    chunks = -(-capacity // chunk)
    sizes = sorted(c for c in resident if c <= CLUSTER_MAX)
    cluster = max((c for c in sizes if c <= chunks and pairs <= resident[c]), default=1)
    while paged and cluster < max(sizes, default=1) and -(-chunks // cluster) * (chunk // unit) > CLUSTER_MAX_PAGES:
        cluster = min(c for c in sizes if c > cluster)
    walks = -(-chunks // cluster)
    if paged and walks * (chunk // unit) > CLUSTER_MAX_PAGES:
        raise NotImplementedError(
            f"the cluster decode kernels stage at most {CLUSTER_MAX_PAGES} page ids a block, {CLUSTER_MAX} blocks "
            f"a sequence; a capacity of {capacity} tokens in pages of {unit} needs {walks * (chunk // unit)}"
        )
    return cluster, chunk, walks


@functools.lru_cache(maxsize=None)
def _resident_clusters(kind: str, index: int, q_code: int, kv_code: int, d: int, rows: int,
                       paged: bool) -> dict[int, int]:
    """What `decode_cluster_split` reads: for each cluster size the `kind`
    ("group" or "wide") kernel may take (CLUSTER_SIZES), how many clusters
    of it for this configuration the card `index` holds at once (asked of
    the CUDA runtime once per configuration)."""
    from ..kernels._build import library

    query = getattr(library(), f"fa_decode_{kind}_resident")
    resident = {}
    with _on(torch.device("cuda", index)):
        for cluster in CLUSTER_SIZES[kind]:
            n = query(q_code, kv_code, d, rows, int(paged), cluster)
            if n < 0:
                raise RuntimeError(f"decode {kind} kernel: occupancy query failed with cudaError {-n}")
            resident[cluster] = n
    return resident


def cluster_plan(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int, group: int, capacity: int, unit: int,
                 pairs: int, paged: bool, index: int) -> tuple[str, int, int, int, int, int] | None:
    """The launch plan of a decode call that runs a cluster kernel:
    (kind, passes, rows, cluster, chunk, walks), kind "wide" for a head dim
    above 256 (`uses_wide_kernel`), "group" for a GQA group above 8
    (`uses_group_kernel`), "narrow" for head dims 8-32 at groups of up to 8
    (`uses_narrow_kernel`: one pass of the whole group, chunks of at least
    NARROW_TOKENS); None for a call that runs decode.cuh's group tiles.  `kv_dtype` is the cache's, `unit` K5's
    page size (ignored for K6), `pairs` sequences x KV heads and `index`
    the card the split asks for its residency."""
    if uses_wide_kernel(q_dtype, head_dim, group):
        kind, (passes, rows), tokens = "wide", wide_passes(group), wide_tokens(head_dim, kv_dtype.itemsize)
    elif uses_group_kernel(q_dtype, head_dim, group):
        kind, tokens = "group", group_tokens(head_dim, kv_dtype.itemsize)
        passes, rows = group_passes(group, group_max_rows(q_dtype, head_dim))
    elif uses_narrow_kernel(q_dtype, head_dim, group):
        kind, passes, rows, tokens = "narrow", 1, group, NARROW_TOKENS
    else:
        return None
    resident = _resident_clusters(kind, index, _DTYPE_CODES[q_dtype], QUANT_DTYPES.get(kv_dtype, 0), head_dim, rows,
                                  paged)
    split = decode_cluster_split(capacity, pairs * passes, unit if paged else tokens, resident, paged, tokens)
    return (kind, passes, rows) + split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORKSPACES: dict = {}


def _workspace(device: torch.device, floats: int, pairs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 partials and the int32 arrival counters (zero) of the
    kernels' in-launch merge, allocated once per (device, size) and reused
    by every later call of that size, so that a call allocates only its
    output.  They are never freed: a CUDA graph that captured a call keeps
    their addresses.  Launches that share them must not run concurrently
    (two streams must not share one workspace)."""
    key = (device, floats, pairs)
    ws = _WORKSPACES.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode kernels: call once at this size before capturing a CUDA graph, so that "
                               "their workspace is allocated outside the graph")
        ws = _WORKSPACES[key] = (torch.empty(floats, dtype=torch.float32, device=device),
                                 torch.zeros(pairs, dtype=torch.int32, device=device))
    return ws


@functools.lru_cache(maxsize=256)
def _stride_array(*strides: int):
    return (ctypes.c_longlong * len(strides))(*strides)


def _check_rows(name: str, t: torch.Tensor) -> None:
    """The decode kernels read payload rows with 16-byte copies through the
    tensor's strides (at head dims 8-32 a row's d columns in 16-byte pieces,
    8-byte ones for the 8-byte rows of an int8/fp8 cache at d = 8).  A
    cache view that breaks that raises: copying the cache on every call
    would hide its whole cost."""
    align = min(16, t.shape[-1] * t.element_size())
    vec = align // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % align or any(st % vec for st in t.stride()[:-1]):
        raise ValueError(f"{name}: rows must be contiguous and {align}-byte aligned, got strides {t.stride()}")


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int32 and t.is_contiguous() else t.to(torch.int32).contiguous()


def _launch_decode(
    entry: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scales: torch.Tensor | None,
    v_scales: torch.Tensor | None,
    lengths: torch.Tensor,
    page_indices: torch.Tensor | None,
    *,
    sm_scale: float,
    len_add: int,
) -> torch.Tensor:
    """Run K5 (entry "paged_decode": k/v pages [hkv, n_pages, page_size, d],
    page_indices [batch, pages_per_seq]) or K6 (entry "fused_decode": k/v one
    layer [hkv, slots, max_len, d], page_indices None) on CUDA tensors;
    returns [batch, hq, d] in q's dtype.  Each sequence reads max(lengths +
    len_add, 1) tokens (K6 always adds 1), split across blocks as
    `decode_split` chooses, a GQA group in `group_tiles`.  What the kernels
    do not take (q dtype, payload, head dim) raises before any launch.
    Head dims 8-32 at groups of up to 8 (`uses_narrow_kernel`) run the
    narrow kernel of the same entry (launch key `entry` + "_narrow"), a GQA
    group above 8 (`uses_group_kernel`) the whole-group kernel (`entry` +
    "_group", + "_group_fp32" for fp32 q), and a head dim above 256
    (`uses_wide_kernel`) the wide kernel (`entry` + "_wide"), each as
    `cluster_plan` chooses and with no workspace."""
    batch, hq, d = q.shape
    hkv = k.shape[0]
    quantized = k_scales is not None
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"the decode kernels take float32/bfloat16/float16 q, got {q.dtype}")
    if k.dtype != v.dtype or (quantized and k.dtype not in QUANT_DTYPES) or (not quantized and k.dtype != q.dtype):
        raise TypeError(
            f"the decode kernels take K/V in q's dtype, or int8/fp8 with scales; got {k.dtype}/{v.dtype} "
            f"for q {q.dtype}{' with scales' if quantized else ''}"
        )
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"the decode kernels take head dims 8, 16, 32 and every multiple of 16 from 48 to 1024, got {d}"
        )
    if hq % hkv:
        raise ValueError(f"num_q_heads ({hq}) must be divisible by num_kv_heads ({hkv})")
    tensors = [q, k, v, lengths] + ([k_scales, v_scales] if quantized else [])
    tensors += [page_indices] if page_indices is not None else []
    if kernel_route(*tensors) != "cuda":
        raise RuntimeError(f"{entry} runs on CUDA tensors only; CPU tensors take the plain version")
    from ..kernels._build import library

    _check_rows("k", k)
    _check_rows("v", v)
    if q.stride(-1) != 1 or (uses_group_kernel(q.dtype, d, hq // hkv)
                             and (q.data_ptr() % 16 or q.stride(0) % 8 or q.stride(1) % 8)):
        q = q.contiguous()  # the whole-group kernels read q's rows 16 bytes at a time
    if quantized:
        if k_scales.dtype != torch.float32 or k_scales.stride() != v_scales.stride() or k_scales.stride(-1) != 1:
            raise ValueError("k_scales/v_scales must be fp32 with equal strides and contiguous rows")
    lengths = _int32(lengths)
    paged = entry == "paged_decode"
    if paged:
        page_indices = _int32(page_indices)
        capacity, unit = k.shape[2] * page_indices.shape[1], k.shape[2]
    else:
        capacity, unit = k.shape[2], DECODE_TILE
    device = q.device
    out = torch.empty(batch, hq, d, dtype=q.dtype, device=device)
    sc = k_scales.stride()[:2] if quantized else (0, 0)
    strides = _stride_array(*q.stride()[:2], *out.stride()[:2], *k.stride()[:3], *v.stride()[:3], *sc)
    ptrs = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None, lengths.data_ptr(),
    )
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    kv_code = QUANT_DTYPES[k.dtype] if quantized else 0
    plan = cluster_plan(q.dtype, k.dtype, d, hq // hkv, capacity, unit, batch * hkv, paged, device.index)
    if plan is not None:
        kind, passes, rows, cluster, chunk, walks = plan
        launch = getattr(library(), f"fa_{entry}_{kind}")
        key = f"{entry}_{kind}" + ("_fp32" if kind == "group" and q.dtype == torch.float32 else "")
        codes = (_DTYPE_CODES[q.dtype], kv_code, batch, hq, hkv, passes, rows, d)
        with _on(device):
            if paged:
                err = launch(
                    *ptrs, page_indices.data_ptr(), out.data_ptr(), *codes, k.shape[2], page_indices.shape[1],
                    len_add, cluster, chunk, walks, strides, sm_scale, stream,
                )
            else:
                err = launch(*ptrs, out.data_ptr(), *codes, k.shape[2], cluster, chunk, walks, strides, sm_scale, stream)
    else:
        key = entry
        tiles, rows = group_tiles(hq // hkv)
        chunk, splits = decode_split(capacity, batch * hkv * tiles, unit, _sm_count(device.index))
        ws, counters = (None, None)
        if splits > 1:
            # a partial row is the instantiated width + 2 floats (csrc/decode.cuh), whatever d
            ws, counters = _workspace(device, batch * hkv * tiles * splits * rows * (decode_width(d) + 2),
                                      batch * hkv * tiles)
        work = (None if ws is None else ws.data_ptr(), None if counters is None else counters.data_ptr())
        codes = (_DTYPE_CODES[q.dtype], kv_code, batch, hq, hkv, tiles, rows, d)
        with _on(device):
            if paged:
                err = library().fa_paged_decode(
                    *ptrs, page_indices.data_ptr(), out.data_ptr(), *work, *codes, k.shape[2],
                    page_indices.shape[1], len_add, chunk, splits, strides, sm_scale, stream,
                )
            else:
                err = library().fa_fused_decode(
                    *ptrs, out.data_ptr(), *work, *codes, k.shape[2], chunk, splits, strides, sm_scale, stream,
                )
    if err != 0:
        raise RuntimeError(f"{key} launch failed with cudaError {err}")
    KERNEL_LAUNCHES[key] += 1
    return out


def _on(device: torch.device):
    """The device context of a launch, entered only when `device` is not
    the current one already (it costs more than the launch's own work)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Decode-step attention over a paged KV cache.

    Args:
      q: [batch, q_heads, head_dim], one new token per sequence.
      k_pages, v_pages: [kv_heads, total_pages, page_size, head_dim] in q's
        dtype, or int8/fp8 with k_scales/v_scales given.
      lengths: [batch] int32, valid tokens per sequence INCLUDING the current
        token already written to its page; values below 1 count as 1.
      page_indices: [batch, pages_per_seq] int32 physical page ids.
      k_scales, v_scales: [kv_heads, total_pages, page_size] fp32 per-token
        dequantization scales of quantized pages.

    Returns [batch, q_heads, head_dim] in q's dtype.  On CUDA: float32,
    bfloat16 or float16 q, any GQA group, head dims 8, 16, 32 and every
    multiple of 16 from 48 to 1024; anything else raises.
    """
    batch, hq, d = q.shape
    hkv = k_pages.shape[0]
    if hq % hkv:
        raise ValueError(f"num_q_heads ({hq}) must be divisible by num_kv_heads ({hkv})")
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    if kernel_route(q, k_pages, v_pages) == "cuda":
        return _launch_decode(
            "paged_decode", q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices,
            sm_scale=float(sm_scale), len_add=0,
        )
    return paged_attention_ref(
        q, k_pages, v_pages, lengths, page_indices, k_scales=k_scales, v_scales=v_scales, sm_scale=sm_scale
    )
