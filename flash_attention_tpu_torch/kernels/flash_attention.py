"""Flash attention: the Hopper kernels' wrappers, their autograd Functions
and their plain versions.

Port of `flash_attention_tpu/kernels/flash_attention.py`.  `flash_attention`
and `flash_attention_with_lse` look at the device of their inputs
(`config.kernel_route`):

* CUDA tensors go to the hand-written kernels, for every sequence length:
  the forward in `csrc/flash_fwd.cu` (K1) and, for inputs that require
  grad, the backward in `csrc/flash_bwd.cu` (a pre-pass writing di and
  qs, then K2 dK/dV and K3 dQ).  The kernels are built for head dims 64,
  128, 256, 512 and 1024; the entry points zero-pad any other head dim up
  to 1024 to the next of them and slice the results back
  (`padded_head_dim`).  The bf16/fp16 forward (K1, and K4 in
  `quant/kv.py`) is a warp-specialised TMA + wgmma kernel at every head
  dim: `csrc/flash_fwd.cuh` up to 256, `csrc/flash_fwd_wide.cuh` at 512
  and 1024 (two consumer warpgroups sharing a 64-row query tile, 512
  output columns a block).  The bf16/fp16 backward (K2, K3) is wgmma at
  every head dim too: `csrc/flash_bwd.cuh` up to 256,
  `csrc/flash_bwd_wide.cuh` at 512 and 1024 (transposed accumulators, so
  that the head dim is wgmma's M).  fp32 K1 and K4 are 3xTF32
  tensor-core kernels at every head dim (`csrc/flash_fwd_fp32.cu` at 64
  and 128, `csrc/flash_fwd_fp32_wide.cuh` at 256, 512 and 1024), and so
  are fp32 K2 and K3 (`csrc/flash_bwd_fp32.cuh` at 64 and 128,
  `csrc/flash_bwd_fp32_wide.cuh` at 256, 512 and 1024), inside the same
  entry points (`_route`).
  Nothing falls back: what the kernels do not take raises, a head dim above
  1024 among it.
* CPU tensors go to the plain versions: `flash_attention_reference` (a tile
  loop with the forward kernel's masks, block-skip bounds and lse) and
  `flash_attention_bwd_reference` (the same for the backward).  Below
  `MIN_BLOCK` the CPU route takes dense attention, differentiated by
  autograd, as the JAX package does.

The three `torch.autograd.Function`s mirror the JAX package's three
`custom_vjp`s: plain (`_flash`), lse-differentiable (`_flash_lse`, whose
backward shifts di by the lse cotangent) and segmented (`_flash_seg`, no
grad for the ids).  Each forward saves (q, k, v, o, lse).  di = rowsum(o *
dO) - dlse (fp32) and qs = q * sm_scale * log2(e) (rounded to q's dtype),
which JAX computes outside its kernels, come from the pre-pass kernel on
CUDA and from `flash_attention_bwd_prep_reference` on the CPU.

Layout at the public functions is the JAX package's: q [B, Hq, Lq, D],
k/v [B, Hkv, Lkv, D] with Hq % Hkv == 0 (GQA), queries aligned to the end
of KV under the causal mask.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..config import kernel_route
from .block_sizes import K1_TILES, MIN_BLOCK, BlockSizes, blocks_from_chunks, default_blocks
from .vanilla import vanilla_attention

__all__ = [
    "KERNEL_LAUNCHES",
    "flash_attention",
    "flash_attention_bwd_dkv_reference",
    "flash_attention_bwd_dq_reference",
    "flash_attention_bwd_prep_reference",
    "flash_attention_bwd_reference",
    "flash_attention_reference",
    "flash_attention_with_lse",
    "k1_block_q",
    "padded_head_dim",
]

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453

# The head dims the CUDA kernels are built for, every kernel at each of
# them; 1024 is the widest.
SUPPORTED_HEAD_DIMS = (64, 128, 256, 512, 1024)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def padded_head_dim(d: int) -> int:
    """The head dim the CUDA kernels run a head dim `d` at: the smallest of
    64, 128, 256, 512 and 1024 that is at least d.  Above 1024, `d` itself,
    which they do not take.  (The JAX package pads to a multiple of 8, which
    its TPU kernels take.)"""
    return next((dp for dp in SUPPORTED_HEAD_DIMS if d <= dp), d)


def _pad_head_dim(x: torch.Tensor, dp: int) -> torch.Tensor:
    """`x` zero-padded in its last dim to `dp`.  Zero q/k columns add nothing
    to the scores and zero v columns give zero output columns, so slicing
    the output back is exact; `torch.nn.functional.pad` lets autograd slice
    the grads back too.  1-byte payloads (int8, fp8) are padded as bytes: a
    zero byte is 0 in both."""
    pad = (0, dp - x.shape[-1])
    if x.element_size() == 1:
        return torch.nn.functional.pad(x.view(torch.uint8), pad).view(x.dtype)
    return torch.nn.functional.pad(x, pad)


# Launches of each CUDA kernel of the port, counted by its wrapper where it
# launches: K1-K3 and the backward's pre-pass here, K4 in quant/kv.py, K5
# and K6 in inference/paged_attention.py (head dims 8-32 at GQA groups of up
# to 8 under "paged_decode_narrow" / "fused_decode_narrow", the cluster
# kernels of csrc/decode_narrow.cuh; a GQA group above 8 with 16-bit q at
# head dims 8-256 under "paged_decode_group" / "fused_decode_group",
# the whole-group kernels of csrc/decode_group.cuh, with fp32 q under
# "paged_decode_group_fp32" / "fused_decode_group_fp32", those of
# csrc/decode_group_fp32.cuh; head dims above 256 under
# "paged_decode_wide" / "fused_decode_wide", the cluster kernels of
# csrc/decode_wide.cuh).  fp32 K1, K4, K2 and K3 up to
# head dim 128 are the 3xTF32 kernels (csrc/flash_fwd_fp32.cu,
# csrc/flash_bwd_fp32.cuh), counted under "_fp32" (the fp32 pre-pass is
# the 16-bit one's kernel, under the plain key).  Head dims 256, 512 and
# 1024 run other kernels, counted under keys of their own (`_route`):
# "_d256" for what bf16/fp16 runs at 256 (the wgmma K1, K4, K2 and K3),
# "_wide" at 512 and 1024 (csrc/flash_fwd_wide.cuh, csrc/flash_bwd_wide.cuh,
# and the pre-pass); for fp32 "_d256_fp32" / "_wide_fp32" (the 3xTF32 K1
# and K4 of csrc/flash_fwd_fp32_wide.cuh, K2 and K3 of
# csrc/flash_bwd_fp32_wide.cuh).
KERNEL_LAUNCHES = {
    "flash_fwd": 0,
    "flash_bwd_prep": 0,
    "flash_bwd_dkv": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv_fp32": 0,
    "flash_bwd_dq_fp32": 0,
    "flash_fwd_fp32": 0,
    "flash_fwd_kv_quant_fp32": 0,
    "flash_fwd_kv_quant": 0,
    "paged_decode": 0,
    "fused_decode": 0,
    "paged_decode_narrow": 0,
    "fused_decode_narrow": 0,
    "paged_decode_group": 0,
    "fused_decode_group": 0,
    "paged_decode_group_fp32": 0,
    "fused_decode_group_fp32": 0,
    "paged_decode_wide": 0,
    "fused_decode_wide": 0,
    "flash_fwd_d256": 0,
    "flash_bwd_prep_d256": 0,
    "flash_bwd_dkv_d256": 0,
    "flash_bwd_dq_d256": 0,
    "flash_fwd_kv_quant_d256": 0,
    "flash_fwd_d256_fp32": 0,
    "flash_fwd_kv_quant_d256_fp32": 0,
    "flash_bwd_dkv_d256_fp32": 0,
    "flash_bwd_dq_d256_fp32": 0,
    "flash_fwd_wide": 0,
    "flash_bwd_prep_wide": 0,
    "flash_bwd_dkv_wide": 0,
    "flash_bwd_dq_wide": 0,
    "flash_fwd_kv_quant_wide": 0,
    "flash_fwd_wide_fp32": 0,
    "flash_fwd_kv_quant_wide_fp32": 0,
    "flash_bwd_dkv_wide_fp32": 0,
    "flash_bwd_dq_wide_fp32": 0,
}


def _route(name: str, head_dim: int, dtype: torch.dtype) -> tuple[str, str]:
    """(KERNEL_LAUNCHES key, C entry point) of kernel `name` ("flash_fwd",
    "flash_fwd_kv_quant", "flash_bwd_prep", "flash_bwd_dkv" or
    "flash_bwd_dq") at padded head dim `head_dim` for q's `dtype`.  Keys:
    the name up to 128, with "_fp32" for fp32 K1, K4, K2 and K3 there (the
    3xTF32 kernels, reached through the same entry points as the 16-bit
    ones); "_d256" at 256 and "_wide" at 512 and 1024 for bf16/fp16 K1,
    K4, K2 and K3 (the wgmma kernels of csrc/flash_fwd.cuh,
    csrc/flash_fwd_wide.cuh, csrc/flash_bwd.cuh and csrc/flash_bwd_wide.cuh)
    and for the pre-pass of every dtype; for fp32 K1, K4, K2 and K3
    "_d256_fp32" / "_wide_fp32" (the 3xTF32 kernels of
    csrc/flash_fwd_fp32_wide.cuh and csrc/flash_bwd_fp32_wide.cuh).  Every
    kernel is reached through its plain entry point."""
    fp32 = dtype == torch.float32 and name != "flash_bwd_prep"
    tier = "" if head_dim <= 128 else "_d256" if head_dim == 256 else "_wide"
    return f"{name}{tier}{'_fp32' if fp32 else ''}", f"fa_{name}"


def _call(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry` of the kernel library on `device`'s
    current stream (appended to `args`); raises on a non-zero cudaError."""
    from ._build import library

    with torch.cuda.device(device):
        err = getattr(library(), entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with cudaError {err}")


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What the kernels compute besides their tensors (JAX's `_Params`)."""

    causal: bool
    sm_scale: float
    window: int | None
    blocks: BlockSizes


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected 4-D q/k/v, got {tuple(q.shape)}, {tuple(k.shape)}")
    b, hq, lq, d = q.shape
    bk, hkv, lk, dk = k.shape
    if v.shape != k.shape:
        raise ValueError(f"k and v shapes must match: {tuple(k.shape)} vs {tuple(v.shape)}")
    if bk != b or dk != d:
        raise ValueError(f"q/k shape mismatch: {tuple(q.shape)} vs {tuple(k.shape)}")
    if hq % hkv != 0:
        raise ValueError(f"num_q_heads ({hq}) must be divisible by num_kv_heads ({hkv})")
    return b, hq, hkv, lq, lk, d


def _tile_mask(i0, i1, c0, c1, lq, lk, causal, window, segment_ids, device):
    """Bool mask of the (q rows [i0, i1)) x (KV columns [c0, c1)) tile,
    broadcastable to [B, Hkv, G, rows, cols]: `_mask_for_block` and
    `_seg_mask` of the JAX package."""
    rows = torch.arange(i0, i1, device=device)[:, None]
    cols = torch.arange(c0, c1, device=device)[None, :]
    ok = torch.ones(i1 - i0, c1 - c0, dtype=torch.bool, device=device)
    if causal:
        offset = lk - lq
        ok = ok & (cols <= rows + offset)
        if window is not None:
            ok = ok & (cols >= rows + offset - (window - 1))
    if segment_ids is not None:
        q_ids, kv_ids = segment_ids
        seg = q_ids[:, i0:i1, None] == kv_ids[:, None, c0:c1]
        ok = ok & seg[:, None, None]
    return ok


def _kv_range(i0, i1, lq, lk, bkv, causal, window):
    """KV tiles (as column starts) that the q rows [i0, i1) reach: the
    forward's and dQ's loop bounds (`_causal_cells_qmajor`)."""
    offset = lk - lq
    kv_end = min(lk, i1 + offset) if causal else lk
    j0 = max(0, i0 + offset - (window - 1)) // bkv if causal and window is not None else 0
    return range(j0 * bkv, kv_end, bkv) if kv_end > 0 else range(0)


def _q_range(c0, c1, lq, lk, bq, causal, window):
    """q tiles (as row starts) that reach the KV columns [c0, c1): dK/dV's
    loop bounds (`_causal_cells_kvmajor`)."""
    if not causal:
        return range(0, lq, bq)
    offset = lk - lq
    i0 = max(c0 - offset, 0) // bq
    end = lq if window is None else min(lq, c1 - 1 - offset + window)
    return range(i0 * bq, end, bq)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    segment_ids: tuple[torch.Tensor, torch.Tensor] | None = None,
    block_sizes: BlockSizes | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: (out, lse).

    A tile loop over (block_q x block_kv) tiles, default the kernel's own
    (`default_blocks`), with the kernel's arithmetic: q scaled by
    sm_scale*log2(e) and rounded to its dtype, online softmax in the exp2
    domain with m / l / acc in fp32, P rounded to v's dtype before PV, one
    final division with the l == 0 guard, lse = (m + log2 l) * ln2.  KV
    tiles past the causal diagonal, or wholly behind the window, are
    skipped.  segment_ids is a (q_ids [B, Lq], kv_ids [B, Lkv]) pair.
    """
    b, hq, hkv, lq, lk, d = _shapes(q, k, v)
    group = hq // hkv
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    blocks = block_sizes or default_blocks(lq, lk, d, group, dtype=q.dtype)
    bq, bkv = blocks.block_q, blocks.block_kv
    qs = (q.float() * (sm_scale * _LOG2E)).to(q.dtype).float().reshape(b, hkv, group, lq, d)
    kf = k.float()[:, :, None]
    vf = v[:, :, None]
    out = torch.empty(b, hkv, group, lq, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(b, hkv, group, lq, dtype=torch.float32, device=q.device)
    for i0 in range(0, lq, bq):
        i1 = min(i0 + bq, lq)
        shape = (b, hkv, group, i1 - i0, 1)
        m = torch.full(shape, -math.inf, device=q.device)
        l = torch.zeros(shape, device=q.device)
        acc = torch.zeros(b, hkv, group, i1 - i0, d, device=q.device)
        for c0 in _kv_range(i0, i1, lq, lk, bkv, causal, window):
            c1 = min(c0 + bkv, lk)
            s = torch.matmul(qs[..., i0:i1, :], kf[..., c0:c1, :].transpose(-1, -2))
            ok = _tile_mask(i0, i1, c0, c1, lq, lk, causal, window, segment_ids, q.device)
            s = torch.where(ok, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            base = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s - base)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vf[..., c0:c1, :].float())
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        out[..., i0:i1, :] = acc / l_safe
        lse[..., i0:i1] = ((m + torch.log2(l_safe)) * _LN2)[..., 0]
    return out.reshape(b, hq, lq, d).to(q.dtype), lse.reshape(b, hq, lq)


def flash_attention_bwd_prep_reference(
    q: torch.Tensor, o: torch.Tensor, do: torch.Tensor, *, dlse: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward's pre-pass (`fa_flash_bwd_prep`): (di,
    qs).  di = rowsum(o * do) - dlse in fp32, [B, Hq, Lq], as the JAX package
    computes it outside its kernels (`_flash_bwd_rule`,
    `_flash_lse_bwd_rule`); qs = q * sm_scale * log2(e) rounded to q's
    dtype, as `_recompute_p` makes it on every tile (and the forward before
    its QK^T)."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    di = (o.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse.float()
    return di, (q.float() * (sm_scale * _LOG2E)).to(q.dtype)


def _bwd_operands(q, k, v, o, lse, do, dlse, causal, sm_scale, window, segment_ids, block_sizes):
    """What both plain backward loops read: the tiling and a function of a
    (q rows, KV columns) tile giving (P, dS) in fp32, shaped [B, Hkv, G,
    rows, cols], with the kernels' roundings and P = 0 where masked."""
    b, hq, hkv, lq, lk, d = _shapes(q, k, v)
    group = hq // hkv
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    blocks = block_sizes or default_blocks(lq, lk, d, group, dtype=q.dtype)

    def grouped(x):
        return x.reshape(b, hkv, group, *x.shape[2:])

    di, qs = flash_attention_bwd_prep_reference(q, o, do, dlse=dlse, sm_scale=sm_scale)
    qs = grouped(qs.float())
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    dof = grouped(do.float())
    lse2 = grouped(lse.float() * _LOG2E)[..., None]
    di = grouped(di)[..., None]

    def p_and_ds(i0, i1, c0, c1):
        s = torch.matmul(qs[..., i0:i1, :], kf[..., c0:c1, :].transpose(-1, -2))
        ok = _tile_mask(i0, i1, c0, c1, lq, lk, causal, window, segment_ids, q.device)
        p = torch.where(ok, torch.exp2(s - lse2[..., i0:i1, :]), 0.0)
        dp = torch.matmul(dof[..., i0:i1, :], vf[..., c0:c1, :].transpose(-1, -2))
        return p, p * (dp - di[..., i0:i1, :])

    return blocks, sm_scale, grouped, dof, p_and_ds


def flash_attention_bwd_dkv_reference(q, k, v, o, lse, do, *, dlse=None, causal=True, sm_scale=None,
                                      window=None, segment_ids=None, block_sizes=None):
    """Plain version of K2 (`_dkv_kernel`): (dk, dv).  Arguments as in
    `flash_attention_bwd_reference`."""
    b, hq, hkv, lq, lk, d = _shapes(q, k, v)
    blocks, sm_scale, grouped, dof, p_and_ds = _bwd_operands(
        q, k, v, o, lse, do, dlse, causal, sm_scale, window, segment_ids, block_sizes
    )
    qk = grouped((q.float() * sm_scale).to(q.dtype).float())
    dk = torch.zeros(b, hkv, lk, d, device=q.device)
    dv = torch.zeros(b, hkv, lk, d, device=q.device)
    bq, bkv = blocks.bwd_dkv()
    for c0 in range(0, lk, bkv):
        c1 = min(c0 + bkv, lk)
        for i0 in _q_range(c0, c1, lq, lk, bq, causal, window):
            i1 = min(i0 + bq, lq)
            p, ds = p_and_ds(i0, i1, c0, c1)
            pt = p.to(do.dtype).float().transpose(-1, -2)
            dv[..., c0:c1, :] += torch.matmul(pt, dof[..., i0:i1, :]).sum(2)
            dst = ds.to(q.dtype).float().transpose(-1, -2)
            dk[..., c0:c1, :] += torch.matmul(dst, qk[..., i0:i1, :]).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, o, lse, do, *, dlse=None, causal=True, sm_scale=None,
                                     window=None, segment_ids=None, block_sizes=None):
    """Plain version of K3 (`_dq_kernel`): dq.  Arguments as in
    `flash_attention_bwd_reference`."""
    b, hq, hkv, lq, lk, d = _shapes(q, k, v)
    blocks, sm_scale, _, _, p_and_ds = _bwd_operands(
        q, k, v, o, lse, do, dlse, causal, sm_scale, window, segment_ids, block_sizes
    )
    ks = (k.float() * sm_scale).to(k.dtype).float()[:, :, None]
    dq = torch.zeros(b, hkv, hq // hkv, lq, d, device=q.device)
    bq, bkv = blocks.bwd_dq()
    for i0 in range(0, lq, bq):
        i1 = min(i0 + bq, lq)
        for c0 in _kv_range(i0, i1, lq, lk, bkv, causal, window):
            c1 = min(c0 + bkv, lk)
            _, ds = p_and_ds(i0, i1, c0, c1)
            dq[..., i0:i1, :] += torch.matmul(ds.to(k.dtype).float(), ks[..., c0:c1, :])
    return dq.reshape(b, hq, lq, d).to(q.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    dlse: torch.Tensor | None = None,
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    segment_ids: tuple[torch.Tensor, torch.Tensor] | None = None,
    block_sizes: BlockSizes | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: (dq, dk, dv).

    Tile loops with the kernels' arithmetic (`_recompute_p`, `_dkv_kernel`,
    `_dq_kernel` of the JAX package): di = rowsum(o * do) - dlse in fp32
    and qs = q * sm_scale * log2(e) rounded to q's dtype
    (`flash_attention_bwd_prep_reference`); P = exp2(qs K^T - lse * log2 e),
    and P = 0
    where masked, so a row that sees no key (lse = -inf) gives no NaN;
    dV += P^T dO with P rounded to dO's dtype; dS = P (dO V^T - di);
    dK += dS^T (q * scale) and dQ += dS (k * scale), dS and the scaled
    operands rounded to their dtype; sums in fp32.  dK/dV walk the q tiles
    that reach each KV tile, dQ the KV tiles each q tile reaches, in
    `block_sizes.bwd_dkv()` / `bwd_dq()` tiles (default the kernels' own).
    The GQA group's rows sum into their KV head.
    """
    kw = dict(dlse=dlse, causal=causal, sm_scale=sm_scale, window=window, segment_ids=segment_ids,
              block_sizes=block_sizes)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, o, lse, do, **kw)
    return flash_attention_bwd_dq_reference(q, k, v, o, lse, do, **kw), dk, dv


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernels can read it through its strides, else a
    contiguous copy: a unit last stride, a 16-byte aligned base, and every
    other stride a multiple of 16 bytes (TMA's rule for the forward's tensor
    maps, the backward's too, and the pre-pass's 16-byte loads).  The fused
    QKV projection's q/k/v views pass uncopied.  The only place q, k, v, o
    and dO are copied on their way to a kernel."""
    vec = 16 // t.element_size()
    ok = (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all(st % vec == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)
    )
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _check_kernel_inputs(*ts: torch.Tensor) -> None:
    dtype, d = ts[0].dtype, ts[0].shape[-1]
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in ts):
        raise TypeError(
            f"the flash kernels take float32/bfloat16/float16 inputs of one dtype, got {[t.dtype for t in ts]}"
        )
    if d not in SUPPORTED_HEAD_DIMS:
        raise NotImplementedError(
            f"the flash kernels are built for head dims {SUPPORTED_HEAD_DIMS} (entry points pad up to 1024), got {d}"
        )
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in ts]}")


def _ids_ptrs(segs):
    return (segs[0].data_ptr(), segs[1].data_ptr()) if segs is not None else (None, None)


def k1_block_q(blocks: BlockSizes, head_dim: int, dtype: torch.dtype) -> int:
    """The tile height K1 launches with at (padded) head dim `head_dim`: the
    tiling's block_q where the bf16/fp16 kernel is built at it (`K1_TILES`),
    else that kernel's default; 0, the one tile, for fp32."""
    tiles = K1_TILES.get(head_dim) if dtype != torch.float32 else None
    if tiles is None:
        return 0
    return blocks.block_q if blocks.block_q in tiles else tiles[0]


def _launch(q, k, v, spec: _Spec, segs, need_lse: bool):
    """Run the forward kernel for q's dtype and head dim (`_route`) on CUDA
    tensors, with the tile `k1_block_q` picks: (out, lse or None)."""
    b, hq, hkv, lq, lk, d = _shapes(q, k, v)
    _check_kernel_inputs(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    # [B, Lq, Hq, D] memory: the caller's transpose back to [B, Lq, Hq*D]
    # is then a free view.
    out = torch.empty(b, lq, hq, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b, hq, lq, dtype=torch.float32, device=q.device) if need_lse else None
    key, entry = _route("flash_fwd", d, q.dtype)
    _call(
        entry, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse), *_ids_ptrs(segs),
        _DTYPE_CODES[q.dtype], b, hq, hkv, lq, lk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        spec.sm_scale * _LOG2E, int(spec.causal), spec.window or 0, k1_block_q(spec.blocks, d, q.dtype),
    )
    KERNEL_LAUNCHES[key] += 1
    return out, lse


def _bwd_args(q, k, v, o, lse, do, dlse, spec: _Spec, segs):
    """The backward kernels' common arguments (one dict per call, shared
    by the pre-pass, K2 and K3): inputs read through their strides; the
    pre-pass's outputs, di (fp32 [B, Hq, Lq]) and, for bf16/fp16, whose
    wgmma K2/K3 read it at every head dim, qs ([B, Hq, Lq, D] contiguous;
    the fp32 K2/K3 scale S themselves); and
    the grads in [B, L, H, D] memory, as the forward's output, so that the
    grads of the fused projection's q/k/v views are free views too."""
    b, hq, hkv, lq, lk, d = _shapes(q, k, v)
    _check_kernel_inputs(q, k, v, o, do)
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    di = torch.empty(b, hq, lq, dtype=torch.float32, device=q.device)
    qs = torch.empty(b, hq, lq, d, dtype=q.dtype, device=q.device) if q.dtype != torch.float32 else None
    dq = torch.empty(b, lq, hq, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty(b, lk, hkv, d, dtype=k.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty(b, lk, hkv, d, dtype=v.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 21)(*(s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]))
    prep_strides = (ctypes.c_longlong * 9)(*(s for t in (q, o, do) for s in t.stride()[:3]))
    # keep every tensor whose pointer the kernels read alive in the dict
    return dict(
        tensors=(q, k, v, do, lse.contiguous(), di), qs=qs, segs=segs, dq=dq, dk=dk, dv=dv,
        prep=(o, None if dlse is None else dlse.float().contiguous(), prep_strides),
        tail=(_DTYPE_CODES[q.dtype], b, hq, hkv, lq, lk, d, strides, spec.sm_scale, spec.sm_scale * _LOG2E,
              int(spec.causal), spec.window or 0),
    )


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch_bwd_prep(args: dict) -> None:
    """Run the pre-pass (csrc/flash_bwd.cu, fa_flash_bwd_prep): di and, when
    `args` holds one, qs, into the tensors of `args`."""
    q, _, _, do, _, di = args["tensors"]
    o, dlse, strides = args["prep"]
    dtype, b, hq, _, lq, _, d = args["tail"][:7]
    key, entry = _route("flash_bwd_prep", d, q.dtype)
    _call(
        entry, q.device, q.data_ptr(), o.data_ptr(), do.data_ptr(), _ptr(dlse), _ptr(args["qs"]), di.data_ptr(),
        dtype, b, hq, lq, d, strides, args["tail"][9],
    )
    KERNEL_LAUNCHES[key] += 1


def _bwd_launch(name: str, args: dict, outs: tuple[torch.Tensor, ...]) -> None:
    q = args["tensors"][0]
    key, entry = _route(name, args["tail"][6], q.dtype)
    ins = [*(t.data_ptr() for t in args["tensors"]), _ptr(args["qs"]), *_ids_ptrs(args["segs"])]
    _call(entry, q.device, *ins, *(t.data_ptr() for t in outs), *args["tail"])
    KERNEL_LAUNCHES[key] += 1


def _launch_bwd_dkv(args: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Run K2 (fa_flash_bwd_dkv; `_route`): (dk, dv)."""
    _bwd_launch("flash_bwd_dkv", args, (args["dk"], args["dv"]))
    return args["dk"], args["dv"]


def _launch_bwd_dq(args: dict) -> torch.Tensor:
    """Run K3 (fa_flash_bwd_dq; `_route`): dq."""
    _bwd_launch("flash_bwd_dq", args, (args["dq"],))
    return args["dq"]


def _launch_bwd(q, k, v, o, lse, do, dlse, spec: _Spec, segs):
    """The CUDA backward, the pre-pass, K2, then K3: (dq, dk, dv)."""
    args = _bwd_args(q, k, v, o, lse, do, dlse, spec, segs)
    _launch_bwd_prep(args)
    dk, dv = _launch_bwd_dkv(args)
    return _launch_bwd_dq(args), dk, dv


# ---------------------------------------------------------------------------
# autograd Functions (the JAX package's custom_vjp glue)
# ---------------------------------------------------------------------------


def _forward(q, k, v, spec: _Spec, segs, need_lse: bool):
    if kernel_route(q, k, v) == "cuda":
        return _launch(q, k, v, spec, segs, need_lse)
    return flash_attention_reference(
        q, k, v, causal=spec.causal, sm_scale=spec.sm_scale, window=spec.window,
        segment_ids=segs, block_sizes=spec.blocks,
    )


def _backward(ctx, do, dlse, segs):
    q, k, v, o, lse = ctx.saved_tensors[:5]
    return _bwd(q, k, v, o, lse, do, dlse, ctx.spec, segs)


def _bwd(q, k, v, o, lse, do, dlse, spec: _Spec, segs):
    """(dq, dk, dv) of the attention whose forward gave (o, lse): the
    pre-pass, K2 and K3 on CUDA tensors, their plain versions on the CPU.
    Ring attention calls it on each KV shard with the merged o and lse."""
    if kernel_route(q, k, v, do) == "cuda":
        return _launch_bwd(q, k, v, o, lse, do, dlse, spec, segs)
    return flash_attention_bwd_reference(
        q, k, v, o, lse, do, dlse=dlse, causal=spec.causal, sm_scale=spec.sm_scale,
        window=spec.window, segment_ids=segs, block_sizes=spec.blocks,
    )


class _Flash(torch.autograd.Function):
    """Plain variant (`_flash`): out."""

    @staticmethod
    def forward(ctx, q, k, v, spec):
        o, lse = _forward(q, k, v, spec, None, need_lse=True)
        ctx.spec = spec
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return (*_backward(ctx, do, None, None), None)


class _FlashLse(torch.autograd.Function):
    """lse-differentiable variant (`_flash_lse`): (out, lse).  d lse / d s
    is softmax(s) = P, so the lse cotangent folds into the kernels as
    di -> di - dlse."""

    @staticmethod
    def forward(ctx, q, k, v, spec):
        o, lse = _forward(q, k, v, spec, None, need_lse=True)
        ctx.spec = spec
        ctx.save_for_backward(q, k, v, o, lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return (*_backward(ctx, do, dlse, None), None)


class _FlashSeg(torch.autograd.Function):
    """Segmented variant (`_flash_seg`): out; the ids take no grad."""

    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, spec):
        o, lse = _forward(q, k, v, spec, (q_ids, kv_ids), need_lse=True)
        ctx.spec = spec
        ctx.save_for_backward(q, k, v, o, lse, q_ids, kv_ids)
        return o

    @staticmethod
    def backward(ctx, do):
        segs = tuple(ctx.saved_tensors[5:])
        return (*_backward(ctx, do, None, segs), None, None, None)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _segments(segment_ids, b: int, lq: int, lk: int, device):
    if isinstance(segment_ids, (tuple, list)):
        q_ids, kv_ids = segment_ids
    else:
        q_ids = kv_ids = segment_ids
    q_ids = torch.as_tensor(q_ids, device=device).to(torch.int32).contiguous()
    kv_ids = torch.as_tensor(kv_ids, device=device).to(torch.int32).contiguous()
    if tuple(q_ids.shape) != (b, lq) or tuple(kv_ids.shape) != (b, lk):
        raise ValueError(
            f"segment_ids shapes {tuple(q_ids.shape)}/{tuple(kv_ids.shape)} must be ({b}, {lq}) / ({b}, {lk})"
        )
    return q_ids, kv_ids


def _blocks(lq, lk, d, group, dtype, block_sizes, num_chunks_q, num_chunks_kv) -> BlockSizes:
    """The tiling of the plain versions, chosen as the JAX package chooses
    it: explicit block_sizes, else the chunk counts (`blocks_from_chunks`),
    else the kernels' own tile."""
    if block_sizes is not None:
        return block_sizes
    if num_chunks_q is not None or num_chunks_kv is not None:
        return blocks_from_chunks(lq, lk, num_chunks_q or 1, num_chunks_kv or 1)
    return default_blocks(lq, lk, d, group, dtype=dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    segment_ids=None,
    block_sizes: BlockSizes | None = None,
    num_chunks_q: int | None = None,
    num_chunks_kv: int | None = None,
) -> torch.Tensor:
    """Memory-efficient (flash) attention, differentiable.

    Args:
      q: [batch, num_q_heads, q_len, head_dim].
      k, v: [batch, num_kv_heads, kv_len, head_dim], num_q_heads a multiple
        of num_kv_heads (GQA/MQA).
      causal: causal mask with queries aligned to the end of kv.
      sm_scale: softmax scale; default 1/sqrt(head_dim).
      window: attend only to the last `window` positions, self included.
        Requires causal.
      segment_ids: an int tensor [batch, seq] or a (q_ids, kv_ids) pair;
        tokens attend only within their segment.
      block_sizes: explicit tiling; overrides num_chunks_*.
      num_chunks_q / num_chunks_kv: reference-style chunk counts mapped to
        block sizes (`blocks_from_chunks`).
      With neither, and without window or segment ids, the tiling is the
      autotuner's for this configuration on this device where it has one
      (`autotune.tuned_blocks`, looked up once, at the caller's head dim
      before padding), else `default_blocks`.
      The tiling sets the tiles of the plain versions (CPU tensors).  On
      CUDA it sets the forward kernel's tile height where the bf16/fp16 K1
      is built at its block_q (`K1_TILES`, `k1_block_q`); every other tile
      of the CUDA kernels is their own (`default_blocks` lists them), which
      changes only the order of summation.

    Returns [batch, num_q_heads, q_len, head_dim] in q's dtype.  On CUDA,
    float32, bfloat16 and float16 run natively, at any head dim up to 1024
    (zero-padded to 64, 128, 256, 512 or 1024, as the JAX package pads to a
    multiple of 8); above 1024 the CUDA route raises NotImplementedError.
    """
    b, hq, hkv, lq, lk, d = _shapes(q, k, v)
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window) requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window >= lk:
            window = None  # no window constraint binds
    if (block_sizes is None and num_chunks_q is None and num_chunks_kv is None and window is None
            and segment_ids is None):
        from .autotune import tuned_blocks

        block_sizes = tuned_blocks(q.shape, lk, q.dtype, causal=causal, num_kv_heads=hkv, device=q.device)
    segs = _segments(segment_ids, b, lq, lk, q.device) if segment_ids is not None else None
    dp = padded_head_dim(d)
    if dp != d and kernel_route(q, k, v) == "cuda":
        # the tiling as chosen at the caller's head dim, so that the padded
        # call does not look the autotuner's cache up again
        blocks = _blocks(lq, lk, d, hq // hkv, q.dtype, block_sizes, num_chunks_q, num_chunks_kv)
        q, k, v = (_pad_head_dim(x, dp) for x in (q, k, v))
        return flash_attention(
            q, k, v, causal=causal, sm_scale=sm_scale, window=window, segment_ids=segs, block_sizes=blocks,
        )[..., :d]
    if kernel_route(q, k, v) == "plain" and (lq < MIN_BLOCK or lk < MIN_BLOCK):
        group = hq // hkv
        k_r = k.repeat_interleave(group, dim=1) if group > 1 else k
        v_r = v.repeat_interleave(group, dim=1) if group > 1 else v
        return vanilla_attention(
            q, k_r, v_r, causal=causal, sm_scale=sm_scale, window=window, segment_ids=segs
        )
    blocks = _blocks(lq, lk, d, hq // hkv, q.dtype, block_sizes, num_chunks_q, num_chunks_kv)
    spec = _Spec(causal, float(sm_scale), window, blocks)
    if not _needs_grad(q, k, v):
        return _forward(q, k, v, spec, segs, need_lse=False)[0]
    if segs is not None:
        return _FlashSeg.apply(q, k, v, *segs, spec)
    return _Flash.apply(q, k, v, spec)


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    block_sizes: BlockSizes | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning (out, logsumexp [batch, num_q_heads,
    q_len], fp32, natural log), differentiable in both.  Head dims as in
    `flash_attention`; the padding leaves the lse unchanged."""
    b, hq, hkv, lq, lk, d = _shapes(q, k, v)
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    dp = padded_head_dim(d)
    if dp != d and kernel_route(q, k, v) == "cuda":
        q, k, v = (_pad_head_dim(x, dp) for x in (q, k, v))
        out, lse = flash_attention_with_lse(q, k, v, causal=causal, sm_scale=sm_scale, block_sizes=block_sizes)
        return out[..., :d], lse
    blocks = _blocks(lq, lk, d, hq // hkv, q.dtype, block_sizes, None, None)
    spec = _Spec(causal, float(sm_scale), None, blocks)
    if not _needs_grad(q, k, v):
        return _forward(q, k, v, spec, None, need_lse=True)
    return _FlashLse.apply(q, k, v, spec)
