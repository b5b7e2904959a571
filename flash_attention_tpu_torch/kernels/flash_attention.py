"""Flash attention forward: the Hopper kernel's wrapper and its plain version.

Port of `flash_attention_tpu/kernels/flash_attention.py` (forward only).
`flash_attention` and `flash_attention_with_lse` look at the device of
their inputs (`config.kernel_route`):

* CUDA tensors go to the hand-written kernel in `csrc/flash_fwd.cu`, for
  every sequence length.  What the kernel does not take yet (sliding
  window, segment ids, inputs that require grad) raises
  `NotImplementedError`; nothing falls back.
* CPU tensors go to `flash_attention_reference`, a blockwise tile loop in
  plain PyTorch with the kernel's masks, block-skip bounds and lse.  Below
  `MIN_BLOCK` the CPU route takes dense attention, as the JAX package does.

Layout at the public functions is the JAX package's: q [B, Hq, Lq, D],
k/v [B, Hkv, Lkv, D] with Hq % Hkv == 0 (GQA), queries aligned to the end
of KV under the causal mask.
"""

from __future__ import annotations

import math

import torch

from ..config import kernel_route
from .block_sizes import MIN_BLOCK, BlockSizes, default_blocks
from .vanilla import vanilla_attention

__all__ = [
    "KERNEL_LAUNCHES",
    "flash_attention",
    "flash_attention_reference",
    "flash_attention_with_lse",
]

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453

SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Launches of each CUDA kernel, counted by its wrapper where it launches.
KERNEL_LAUNCHES = {"flash_fwd": 0}


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
    blocks = block_sizes or default_blocks(lq, lk, d, group)
    bq, bkv = blocks.block_q, blocks.block_kv
    qs = (q.float() * (sm_scale * _LOG2E)).to(q.dtype).float().reshape(b, hkv, group, lq, d)
    kf = k.float()[:, :, None]
    vf = v[:, :, None]
    out = torch.empty(b, hkv, group, lq, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(b, hkv, group, lq, dtype=torch.float32, device=q.device)
    offset = lk - lq
    for i0 in range(0, lq, bq):
        i1 = min(i0 + bq, lq)
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        kv_end = min(lk, i1 + offset) if causal else lk
        j0 = 0
        if causal and window is not None:
            j0 = max(0, i0 + offset - (window - 1)) // bkv
        n_tiles = (kv_end + bkv - 1) // bkv if kv_end > 0 else 0
        shape = (b, hkv, group, i1 - i0, 1)
        m = torch.full(shape, -math.inf, device=q.device)
        l = torch.zeros(shape, device=q.device)
        acc = torch.zeros(b, hkv, group, i1 - i0, d, device=q.device)
        for j in range(j0, n_tiles):
            c0, c1 = j * bkv, min((j + 1) * bkv, lk)
            s = torch.matmul(qs[..., i0:i1, :], kf[..., c0:c1, :].transpose(-1, -2))
            cols = torch.arange(c0, c1, device=q.device)[None, :]
            ok = torch.ones(i1 - i0, c1 - c0, dtype=torch.bool, device=q.device)
            if causal:
                ok = ok & (cols <= rows + offset)
                if window is not None:
                    ok = ok & (cols >= rows + offset - (window - 1))
            if segment_ids is not None:
                q_ids, kv_ids = segment_ids
                seg = q_ids[:, i0:i1, None] == kv_ids[:, None, c0:c1]
                ok = ok & seg[:, None, None]
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel's 16-byte vector loads can read it through
    its strides (unit last stride, 16-byte aligned base and rows), else a
    contiguous copy."""
    vec = 16 // t.element_size()
    ok = (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all(st % vec == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)
    )
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _reject_unported(q, k, v, window, segment_ids) -> None:
    if window is not None:
        raise NotImplementedError("sliding window on CUDA comes with a later port PR (CPU tensors support it)")
    if segment_ids is not None:
        raise NotImplementedError("segment ids on CUDA come with a later port PR (CPU tensors support them)")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward on CUDA (kernels K2/K3) comes with the training port PR; "
            "call under torch.no_grad()"
        )


def _launch(q, k, v, causal: bool, sm_scale: float, need_lse: bool):
    """Run csrc/flash_fwd.cu on CUDA tensors: (out, lse or None)."""
    from ._build import library

    b, hq, hkv, lq, lk, d = _shapes(q, k, v)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes float32/bfloat16/float16 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise NotImplementedError(f"flash_fwd is built for head dims {SUPPORTED_HEAD_DIMS}, got {d}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    # [B, Lq, Hq, D] memory: the caller's transpose back to [B, Lq, Hq*D]
    # is then a free view.
    out = torch.empty(b, lq, hq, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b, hq, lq, dtype=torch.float32, device=q.device) if need_lse else None
    with torch.cuda.device(q.device):
        err = library().fa_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _DTYPE_CODES[q.dtype], b, hq, hkv, lq, lk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            sm_scale * _LOG2E, int(causal), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with cudaError {err}")
    KERNEL_LAUNCHES["flash_fwd"] += 1
    return out, lse


def _segments(segment_ids, b: int, lq: int, lk: int):
    if isinstance(segment_ids, (tuple, list)):
        q_ids, kv_ids = segment_ids
    else:
        q_ids = kv_ids = segment_ids
    q_ids, kv_ids = torch.as_tensor(q_ids), torch.as_tensor(kv_ids)
    if tuple(q_ids.shape) != (b, lq) or tuple(kv_ids.shape) != (b, lk):
        raise ValueError(
            f"segment_ids shapes {tuple(q_ids.shape)}/{tuple(kv_ids.shape)} must be ({b}, {lq}) / ({b}, {lk})"
        )
    return q_ids, kv_ids


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    segment_ids=None,
) -> torch.Tensor:
    """Memory-efficient attention, forward.

    Args:
      q: [batch, num_q_heads, q_len, head_dim].
      k, v: [batch, num_kv_heads, kv_len, head_dim], num_q_heads a multiple
        of num_kv_heads (GQA/MQA).
      causal: causal mask with queries aligned to the end of kv.
      sm_scale: softmax scale; default 1/sqrt(head_dim).
      window: attend only to the last `window` positions, self included.
        Requires causal.  CPU tensors only in this version.
      segment_ids: an int tensor [batch, seq] or a (q_ids, kv_ids) pair;
        tokens attend only within their segment.  CPU tensors only.

    Returns [batch, num_q_heads, q_len, head_dim] in q's dtype.  On CUDA,
    float32, bfloat16 and float16 run natively, at head dims 64 and 128.
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
    segs = _segments(segment_ids, b, lq, lk) if segment_ids is not None else None
    if kernel_route(q, k, v) == "cuda":
        _reject_unported(q, k, v, window, segs)
        return _launch(q, k, v, causal, sm_scale, need_lse=False)[0]
    if lq < MIN_BLOCK or lk < MIN_BLOCK:
        group = hq // hkv
        k_r = k.repeat_interleave(group, dim=1) if group > 1 else k
        v_r = v.repeat_interleave(group, dim=1) if group > 1 else v
        return vanilla_attention(
            q, k_r, v_r, causal=causal, sm_scale=sm_scale, window=window, segment_ids=segs
        )
    return flash_attention_reference(
        q, k, v, causal=causal, sm_scale=sm_scale, window=window, segment_ids=segs
    )[0]


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning (out, logsumexp [batch, num_q_heads, q_len],
    fp32, natural log).  Forward only in this version."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    if kernel_route(q, k, v) == "cuda":
        _reject_unported(q, k, v, None, None)
        return _launch(q, k, v, causal, sm_scale, need_lse=True)
    return flash_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
