"""Block-size selection: the chunk counts of the attention tile loop.

Port of `flash_attention_tpu/kernels/block_sizes.py`.  `BlockSizes`,
`MIN_BLOCK`, `auto_num_chunks`, `blocks_from_chunks` and
`resolve_bwd_blocks` are carried over exactly, so the chunk-count API means
the same thing in both packages.  `default_blocks` is chosen afresh for
Hopper: the TPU's 1024-row tiles were sized for many megabytes of VMEM,
while an H100 block has at most 227 KB of shared memory and registers are
the scarcer resource.
"""

from __future__ import annotations

import dataclasses
import math

import torch

MIN_BLOCK = 128
MAX_BLOCK_Q = 1024
MAX_BLOCK_KV = 1024

# The CUDA forward kernel's tile (csrc/flash_fwd.cuh, WsCfg): 64 query rows
# per consumer warpgroup (three at head dim 64, two at 128 and 256, as the
# registers allow) by 64 KV rows, the K/V tiles in a ring of
# `kernel_stages` shared-memory slots.
KERNEL_BLOCK_KV = 64
KERNEL_STAGES = 4
# The CUDA backward kernels' tiles (csrc/flash_bwd.cuh, DkvCfg,
# DqCfg): at head dims 64 and 128 two consumer warpgroups of 64 pinned rows
# each (KV rows for dK/dV, query rows for dQ) against streamed tiles of 64
# rows (query rows for dK/dV, KV rows for dQ) in a ring of
# `backward_stages` slots.  At 256 (bf16/fp16) both have one consumer
# warpgroup of 64 pinned rows, dK/dV against 32-row query tiles in three
# slots, dQ against 64-row KV tiles in two.
KERNEL_BWD_PINNED = 128
KERNEL_BWD_STREAM = 64
KERNEL_DKV_D256 = (64, 32)  # (pinned KV rows, streamed query rows)
KERNEL_DQ_D256 = (64, 64)  # (pinned query rows, streamed KV rows)
# The fp32 backward above 128 (csrc/flash_bwd_fp32_wide.cuh, bwd32::Tiles):
# eight warps of 128 gradient columns a block, the columns of a 16-row group
# split over its warps and, at 1024, over the two blocks of a cluster, so a
# block pins 16384 x blocks / D rows (KV rows for dK/dV, query rows for dQ)
# against ring slots of each streamed operand; {kernel: {padded head dim:
# (rows a streamed tile, ring slots, the partial S and dP double-buffered,
# blocks of a cluster)}}.
KERNEL_FP32_WIDE_BWD = {
    "dkv": {256: (16, 2, True, 1), 512: (16, 1, True, 1), 1024: (16, 1, True, 2)},
    "dq": {256: (32, 1, False, 1), 512: (16, 1, True, 1), 1024: (16, 1, True, 2)},
}
# The fp32 forward above 128 (csrc/flash_fwd_fp32_wide.cuh, wide32::Tiles):
# eight warps of 128 output columns, D / 128 of them to each 16-row group,
# so a block pins 16384 / D query rows, against one slot of a K ring and one
# of a V ring; {padded head dim: (KV rows a streamed tile, q split once into
# hi and lo)}.
KERNEL_FP32_WIDE = {256: (32, True), 512: (32, False), 1024: (16, False)}
# The bf16/fp16 forward at 512 and 1024 (csrc/flash_fwd_wide.cuh, wide::Cfg):
# two consumer warpgroups share 64 query rows and split the output columns
# (512 a block), against KV tiles in rings of K and of V slots; {padded
# head dim: (KV rows of a tile, K1's K slots, K1's V slots, K4's payload
# staging slots)}.  K4 keeps one K and one V slot, which its producer
# dequantizes into.
KERNEL_WIDE_Q = 64
KERNEL_WIDE_KV = {512: (32, 2, 2, 2), 1024: (16, 2, 1, 1)}
# The bf16/fp16 backward at 512 and 1024 (csrc/flash_bwd_wide.cuh, DkvCfg,
# DqCfg): dK/dV pins 16384 / D KV rows and dQ 32 query rows (wgmma's N:
# the accumulators hold dK^T, dV^T and dQ^T), against streamed tiles of 64
# rows that travel in ring slots of four 64 x 64 boxes (32 KB); {padded
# head dim: (pinned rows, ring slots)}.
KERNEL_WIDE_DKV = {512: (32, 4), 1024: (16, 4)}
KERNEL_WIDE_DQ = {512: (32, 4), 1024: (32, 2)}
KERNEL_WIDE_BWD_STREAM = 64
KERNEL_WIDE_BWD_SLOT = 4 * 64 * 64 * 2
# Shared memory an H100 thread block can use (227 KB).
SMEM_PER_BLOCK = 232_448


def _padded(head_dim: int) -> int:
    """The head dim the kernels run `head_dim` at (the entry points pad to
    the next of 64, 128, 256, 512 and 1024)."""
    return next((d for d in (64, 128, 256, 512) if head_dim <= d), 1024)


def kernel_block_q(head_dim: int, quantized: bool = False) -> int:
    """Query rows of the bf16/fp16 forward kernel's default tile: 192 (three
    consumer warpgroups) at head dim 64 and below, 128 (two) up to 128 and
    for K4 (`quantized`) at 256, 64 (one) for K1 at 256, and 64 (shared by
    two) at 512 and 1024."""
    if head_dim <= 64:
        return 192
    if _padded(head_dim) > 256:
        return KERNEL_WIDE_Q
    return 64 if _padded(head_dim) == 256 and not quantized else 128


# The tile heights (query rows, 64 per consumer warpgroup) that the bf16/fp16
# K1 is built at, {padded head dim: (block_q, ...)}, the default
# (`kernel_block_q`) first: as many consumer warpgroups as the registers
# allow at each head dim, and fewer.  The autotuner sweeps them; K4 and fp32
# have one tile each.
K1_TILES = {64: (192, 128, 64), 128: (128, 64), 256: (64,)}


def kernel_stages(head_dim: int) -> int:
    """K/V ring slots of the bf16/fp16 forward kernel: 4, 2 at head dim 256,
    where a K and a V tile take 64 KB, and at 512 and 1024 the wide K1's K
    slots (2; its V slots are 2 and 1, `KERNEL_WIDE_KV`)."""
    d = _padded(head_dim)
    if d > 256:
        return KERNEL_WIDE_KV[d][1]
    return 2 if d == 256 else KERNEL_STAGES


def forward_smem_bytes(head_dim: int, quantized: bool, block_q: int | None = None) -> int:
    """Shared memory of the bf16/fp16 forward kernel with a tile of
    `block_q` query rows (default `kernel_block_q`), as WsCfg::kSmemBytes
    lays it out: the q tile; per ring slot a K and a V tile (2-byte
    elements) and the KV segment ids; K4's staging slots (two, one at head
    dim 256) of 1-byte K and V payloads; the mbarriers (q, full and empty
    per slot, one per staging slot); 1024 bytes to align the base for the
    128-byte swizzle.  At 512 and 1024 the wide kernel's layout
    (`wide_forward_smem_bytes`)."""
    if _padded(head_dim) > 256:
        return wide_forward_smem_bytes(head_dim, quantized)
    stages = kernel_stages(head_dim)
    staging = 1 if _padded(head_dim) == 256 else 2
    tile = KERNEL_BLOCK_KV * head_dim * 2
    payloads = staging * 2 * KERNEL_BLOCK_KV * head_dim if quantized else 0
    barriers = (1 + 2 * stages + staging) * 8
    rows = block_q or kernel_block_q(head_dim, quantized)
    return (rows * head_dim * 2 + stages * (2 * tile + KERNEL_BLOCK_KV * 4)
            + payloads + barriers + 1024)


def wide_forward_smem_bytes(head_dim: int, quantized: bool) -> int:
    """Shared memory of the bf16/fp16 forward at 512 and 1024, as
    wide::Cfg::kSmemBytes lays it out: the q tile (64 x D, 2-byte
    elements); per slot a K tile and a V slab tile (512 columns; K1's ring,
    K4's one slot); K4's staging slots of 1-byte K and V slab payloads; the
    two warpgroups' fp32 partials of S, double-buffered; the mbarriers (q,
    full and empty of K and of V per slot, one per staging slot); 1024
    bytes to align the base for the 128-byte swizzle."""
    d = _padded(head_dim)
    bc, k_slots, v_slots, staging = KERNEL_WIDE_KV[d]
    if quantized:
        k_slots = v_slots = 1
    else:
        staging = 0
    tiles = k_slots * bc * d * 2 + v_slots * bc * 512 * 2 + staging * bc * (d + 512)
    return (KERNEL_WIDE_Q * d * 2 + tiles + 2 * 2 * KERNEL_WIDE_Q * bc * 4
            + (1 + 2 * k_slots + 2 * v_slots + staging) * 8 + 1024)


def fp32_wide_forward_tile(head_dim: int) -> tuple[int, int]:
    """(pinned query rows, streamed KV rows) of the fp32 forward at padded
    head dim 256, 512 or 1024 (`KERNEL_FP32_WIDE`)."""
    d = _padded(head_dim)
    return 16384 // d, KERNEL_FP32_WIDE[d][0]


def fp32_wide_forward_smem_bytes(head_dim: int, quantized: bool) -> int:
    """Shared memory of the fp32 forward at 256, 512 and 1024, as
    wide32::Cfg::kSmemBytes lays it out: the q tile (fp32, 64 KB) and,
    when it is split once, its lo copy; a K and a V tile (fp32, or K4's
    1-byte payloads); the warps' partial S, double-buffered; the KV
    segment ids and K4's K and V scales; the mbarriers (q, full and empty
    of K and of V); 1024 bytes to
    align the base for the 128-byte swizzle."""
    d = _padded(head_dim)
    stream, pre = KERNEL_FP32_WIDE[d]
    elem = 1 if quantized else 4
    q = 16384 * 4 * (2 if pre else 1)
    slot = 2 * stream * d * elem
    per_slot = stream * 4 * (3 if quantized else 1)
    return q + slot + per_slot + 2 * 8 * 16 * stream * 4 + 5 * 8 + 1024


def _fp32_wide_bwd(head_dim: int, kernel: str) -> tuple[int, int, bool, int]:
    if kernel not in ("dkv", "dq"):
        raise ValueError(f"kernel must be 'dkv' or 'dq', got {kernel!r}")
    return KERNEL_FP32_WIDE_BWD[kernel][_padded(head_dim)]


def fp32_wide_backward_tile(head_dim: int, kernel: str) -> tuple[int, int]:
    """(pinned rows, streamed rows) of the fp32 K2 (`kernel` "dkv": KV rows
    pinned, query rows streamed) or K3 ("dq": the reverse) at padded head
    dim 256, 512 or 1024 (`KERNEL_FP32_WIDE_BWD`)."""
    stream, _, _, ctas = _fp32_wide_bwd(head_dim, kernel)
    return 16384 * ctas // _padded(head_dim), stream


def fp32_wide_backward_smem_bytes(head_dim: int, kernel: str) -> int:
    """Shared memory of a block of the fp32 K2 or K3 at 256, 512 and 1024,
    as bwd32::Cfg::kSmemBytes lays it out: two pinned operands (fp32, 64 KB
    each: its pinned rows by its columns, D / blocks of a cluster); the ring
    slots of the two streamed operands; the eight warps' partial S and dP,
    16 rows by the streamed rows each, in one or two buffers; per slot the
    streamed rows' statistics (lse, di and segment ids, 4 bytes each); the
    mbarriers (the pinned tiles', full and empty of each streamed operand
    per slot); 1024 bytes to align the base for the 128-byte swizzle."""
    stream, stages, double, ctas = _fp32_wide_bwd(head_dim, kernel)
    cols = _padded(head_dim) // ctas
    return (2 * 16384 * 4 + stages * 2 * stream * cols * 4 + (2 if double else 1) * 8 * 2 * 16 * stream * 4
            + stages * 3 * stream * 4 + (1 + 4 * stages) * 8 + 1024)


def backward_tiles(head_dim: int, kernel: str) -> tuple[int, int]:
    """(pinned rows, streamed rows) of the bf16/fp16 backward kernel
    `kernel` ("dkv" or "dq")."""
    if kernel not in ("dkv", "dq"):
        raise ValueError(f"kernel must be 'dkv' or 'dq', got {kernel!r}")
    if _padded(head_dim) > 256:
        return (KERNEL_WIDE_DKV if kernel == "dkv" else KERNEL_WIDE_DQ)[_padded(head_dim)][0], KERNEL_WIDE_BWD_STREAM
    if _padded(head_dim) == 256:
        return KERNEL_DKV_D256 if kernel == "dkv" else KERNEL_DQ_D256
    return KERNEL_BWD_PINNED, KERNEL_BWD_STREAM


def backward_stages(head_dim: int, kernel: str) -> int:
    """Ring slots of the bf16/fp16 backward kernel `kernel` ("dkv" or "dq"):
    dK/dV streams three tiles a slot (qs, q, dO) and keeps three slots above
    head dim 64 to fit; dQ streams two (K, V) and keeps four, two at head
    dim 256.  At 512 and 1024 slots of four 64 x 64 boxes: four, two for
    dQ at 1024, whose pinned qs and dO take 128 KB."""
    if kernel not in ("dkv", "dq"):
        raise ValueError(f"kernel must be 'dkv' or 'dq', got {kernel!r}")
    if _padded(head_dim) > 256:
        return (KERNEL_WIDE_DKV if kernel == "dkv" else KERNEL_WIDE_DQ)[_padded(head_dim)][1]
    if kernel == "dkv":
        return 3 if head_dim > 64 else 4
    return 2 if _padded(head_dim) == 256 else 4


def backward_smem_bytes(head_dim: int, kernel: str) -> int:
    """Shared memory of the bf16/fp16 backward kernel `kernel`, as
    DkvCfg / DqCfg::kSmemBytes lay it out: two pinned tiles (dK/dV: K and V;
    dQ: qs and dO); per ring slot the streamed tiles (dK/dV: qs, q and dO
    with the query rows' lse, di and segment ids, 4 bytes each; dQ: K and V
    with the KV segment ids); the mbarriers (one for the pinned tiles, full
    and empty per slot); 1024 bytes to align the base for the 128-byte
    swizzle.  At 512 and 1024 the wide kernels' layout
    (`wide_backward_smem_bytes`)."""
    if _padded(head_dim) > 256:
        return wide_backward_smem_bytes(head_dim, kernel)
    stages = backward_stages(head_dim, kernel)
    pinned, stream = backward_tiles(head_dim, kernel)
    tile = stream * head_dim * 2
    per_slot = 3 * tile + 3 * stream * 4 if kernel == "dkv" else 2 * tile + stream * 4
    return 2 * pinned * head_dim * 2 + stages * per_slot + (1 + 2 * stages) * 8 + 1024


def wide_backward_smem_bytes(head_dim: int, kernel: str) -> int:
    """Shared memory of the bf16/fp16 backward at 512 and 1024, as
    wide::DkvCfg / DqCfg::kSmemBytes lay it out: two pinned tiles (dK/dV: K
    and V; dQ: qs and dO; 2-byte elements); the ring's slots of four 64 x 64
    boxes; dP (dK/dV) or dP^T (dQ) in fp32, 64 x pinned; the swizzled T
    tiles the kernel writes (dK/dV: P^T and dS^T, pinned x 64 each; dQ: dS);
    the pinned rows' segment ids (dK/dV) or lse, di and segment ids (dQ), 4
    bytes each; the mbarriers (one for the pinned tiles, full and empty per
    slot); 1024 bytes to align the base for the 128-byte swizzle."""
    d = _padded(head_dim)
    pinned, _ = backward_tiles(d, kernel)
    stages = backward_stages(d, kernel)
    written = 2 if kernel == "dkv" else 1
    stats = 1 if kernel == "dkv" else 3
    return (2 * pinned * d * 2 + stages * KERNEL_WIDE_BWD_SLOT + 64 * pinned * 4 + written * pinned * 128
            + stats * pinned * 4 + (1 + 2 * stages) * 8 + 1024)


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Static tiling configuration for the flash attention tile loop."""

    block_q: int = 128
    block_kv: int = 128
    # Backward pass tiles (dKV iterates q inside kv; dQ the reverse).
    block_q_dkv: int | None = None
    block_kv_dkv: int | None = None
    block_q_dq: int | None = None
    block_kv_dq: int | None = None

    _BWD_CAP = 512

    def bwd_dkv(self) -> tuple[int, int]:
        return (
            self.block_q_dkv or min(self.block_q, self._BWD_CAP),
            self.block_kv_dkv or min(self.block_kv, self._BWD_CAP),
        )

    def bwd_dq(self) -> tuple[int, int]:
        return (
            self.block_q_dq or min(self.block_q, self._BWD_CAP),
            self.block_kv_dq or min(self.block_kv, self._BWD_CAP),
        )


def _clamp_pow2(x: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, x))


def _divisor_block(padded_len: int, desired: int) -> int:
    """Largest multiple of MIN_BLOCK that divides `padded_len` and is
    <= `desired` (MIN_BLOCK itself is the floor)."""
    best = MIN_BLOCK
    b = MIN_BLOCK
    cap = min(desired, padded_len)
    while b <= cap:
        if padded_len % b == 0:
            best = b
        b += MIN_BLOCK
    return best


def resolve_bwd_blocks(
    blocks: BlockSizes, lq_padded: int, lk_padded: int
) -> BlockSizes:
    """Pin the backward block sizes to exact divisors of the padded lengths,
    so that no backward grid drops tail rows."""
    q_dkv, kv_dkv = blocks.bwd_dkv()
    q_dq, kv_dq = blocks.bwd_dq()
    return dataclasses.replace(
        blocks,
        block_q_dkv=_divisor_block(lq_padded, q_dkv),
        block_kv_dkv=_divisor_block(lk_padded, kv_dkv),
        block_q_dq=_divisor_block(lq_padded, q_dq),
        block_kv_dq=_divisor_block(lk_padded, kv_dq),
    )


def auto_num_chunks(seq_len: int, head_dim: int) -> tuple[int, int]:
    """Reference-parity auto-chunking heuristic:
    num_chunks_q = 2^ceil(log2(max(L, D) // D) / 2),
    num_chunks_kv = 2^floor(log2(max(L, D) // D) / 2),
    so that a scores chunk has at most as many elements as Q."""
    ratio = max(seq_len, head_dim) // head_dim
    log2 = math.log2(ratio) if ratio > 0 else 0.0
    return 2 ** math.ceil(log2 / 2), 2 ** math.floor(log2 / 2)


def blocks_from_chunks(
    q_len: int,
    kv_len: int,
    num_chunks_q: int,
    num_chunks_kv: int,
) -> BlockSizes:
    """Map reference chunk counts to block sizes (block = L / chunks),
    clamped to [MIN_BLOCK, MAX_BLOCK]."""
    bq = _clamp_pow2(q_len // max(num_chunks_q, 1), MIN_BLOCK, MAX_BLOCK_Q)
    bkv = _clamp_pow2(kv_len // max(num_chunks_kv, 1), MIN_BLOCK, MAX_BLOCK_KV)
    return BlockSizes(block_q=bq, block_kv=bkv)


def default_blocks(
    q_len: int, kv_len: int, head_dim: int, group: int = 1, dtype=None, quantized: bool = False
) -> BlockSizes:
    """Tiling of the Hopper kernels, which the plain tile loops follow by
    default so that both skip the same blocks.

    The forward's tile is `kernel_block_q(head_dim, quantized)` x 64 (192
    x 64 at head dim 64, 128 x 64 at 128 and for K4 at 256, 64 x 64 for K1
    at 256) for any GQA group: the group's query
    heads run in separate thread blocks that read the same KV head, so the
    group does not grow the tile as it did on the TPU.  The backward's:
    dK/dV pins 128 KV rows and walks 64-row query tiles (`bwd_dkv` = (64,
    128)), dQ pins 128 query rows and walks 64-row KV tiles (`bwd_dq` =
    (128, 64)); at 256 dK/dV pins 64 KV rows and walks 32-row query tiles,
    and dQ keeps 32 x 32 tiles where its kernel pins 64 query rows against
    64-row KV tiles (`KERNEL_DQ_D256`): the plain loop's dQ tile sets only
    its order of summation, well inside the bf16 tolerance.  fp32 above
    128 takes the 3xTF32 forward's tile (`fp32_wide_forward_tile`: 64 x
    32, 32 x 32 and 16 x 16 at 256, 512 and 1024) and the 3xTF32
    backward's (`fp32_wide_backward_tile`: dK/dV 64 / 32 / 32 KV rows
    against 16-row query tiles, dQ 64 / 32 / 32 query rows against 32 /
    16 / 16 KV rows); at 512 and
    1024 the bf16/fp16 forward takes
    64 query rows against `KERNEL_WIDE_KV` rows, and its backward pins
    `KERNEL_WIDE_DKV` / `KERNEL_WIDE_DQ` rows against 64-row tiles (dK/dV
    64 query rows against 32 / 16 KV rows, dQ 32 query rows against 64 KV
    rows).  `dtype` is the inputs' (None: a 16-bit type; float32 changes the
    tile only from 256 up, since at 64 and 128 its 3xTF32 K1, K4, K2 and
    K3, 128 pinned rows against 32-row tiles, differ from the 16-bit
    kernels' tiles in the order of summation alone).  q_len, kv_len and
    group are taken for signature parity with the JAX package."""
    del q_len, kv_len, group
    d = _padded(head_dim)
    if d > 256 and dtype != torch.float32:
        stream = KERNEL_WIDE_BWD_STREAM
        return BlockSizes(block_q=KERNEL_WIDE_Q, block_kv=KERNEL_WIDE_KV[d][0], block_q_dkv=stream,
                          block_kv_dkv=KERNEL_WIDE_DKV[d][0], block_q_dq=KERNEL_WIDE_DQ[d][0], block_kv_dq=stream)
    if d > 256 or (d == 256 and dtype == torch.float32):
        kv_rows, q_stream = fp32_wide_backward_tile(d, "dkv")
        q_rows, kv_stream = fp32_wide_backward_tile(d, "dq")
        fwd_q, fwd_kv = fp32_wide_forward_tile(d)
        return BlockSizes(block_q=fwd_q, block_kv=fwd_kv, block_q_dkv=q_stream, block_kv_dkv=kv_rows,
                          block_q_dq=q_rows, block_kv_dq=kv_stream)
    if d == 256:
        pinned, stream = KERNEL_DKV_D256
        return BlockSizes(block_q=kernel_block_q(d, quantized), block_kv=KERNEL_BLOCK_KV, block_q_dkv=stream,
                          block_kv_dkv=pinned, block_q_dq=32, block_kv_dq=32)
    return BlockSizes(
        block_q=kernel_block_q(head_dim), block_kv=KERNEL_BLOCK_KV,
        block_q_dkv=KERNEL_BWD_STREAM, block_kv_dkv=KERNEL_BWD_PINNED,
        block_q_dq=KERNEL_BWD_PINNED, block_kv_dq=KERNEL_BWD_STREAM,
    )
