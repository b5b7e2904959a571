"""Paged attention: decode against a non-contiguous paged KV cache.

Port of `flash_attention_tpu/inference/paged_attention.py`.  The cache lives
as pages [kv_heads, total_pages, page_size, head_dim]; each sequence owns a
`page_indices` row mapping its logical blocks to physical pages.
`paged_attention` looks at the device of its inputs:

* CUDA tensors go to K5, `fa_paged_decode` (`csrc/decode.cu`): one thread
  block per (sequence, KV head) reads the sequence's page-table row itself
  and stops at its length, so a decode step's bytes track the live context,
  with int8/fp8 pages dequantized by their per-token scales in registers.
  Nothing falls back: what the kernel does not take raises.
* CPU tensors go to the plain version, `paged_attention_ref` (gather +
  dequantize + dense masked softmax, a port of the JAX reference).

`_launch_decode` is also K6's launcher (`decode_attention.decode_attention_fused`):
both kernels are one template in `csrc/decode.cu`, with two entry points.
The TPU kernel's `pages_per_compute_block` (pages per DMA step) has no
counterpart: the CUDA kernel walks tokens, not page blocks.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import kernel_route
from ..kernels.flash_attention import _DTYPE_CODES, KERNEL_LAUNCHES, SUPPORTED_HEAD_DIMS
from ..kernels.vanilla import DEFAULT_MASK_VALUE
from ..quant.kv import QUANT_DTYPES

__all__ = ["paged_attention", "paged_attention_ref"]

_Q_DTYPES = (torch.float32, torch.bfloat16)  # what csrc/decode.cu instantiates
_MAX_GROUP = 8


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


def _check_rows(name: str, t: torch.Tensor) -> None:
    """The decode kernels read payload rows with 16-byte loads through the
    tensor's strides.  A cache view that breaks that raises: copying the
    cache on every call would hide its whole cost."""
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(st % vec for st in t.stride()[:-1]):
        raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned, got strides {t.stride()}")


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
    len_add, 1) tokens (K6 always adds 1)."""
    batch, hq, d = q.shape
    hkv = k.shape[0]
    quantized = k_scales is not None
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"the decode kernels take float32/bfloat16 q, got {q.dtype}")
    if k.dtype != v.dtype or (quantized and k.dtype not in QUANT_DTYPES) or (not quantized and k.dtype != q.dtype):
        raise TypeError(
            f"the decode kernels take K/V in q's dtype, or int8/fp8 with scales; got {k.dtype}/{v.dtype} "
            f"for q {q.dtype}{' with scales' if quantized else ''}"
        )
    if d not in SUPPORTED_HEAD_DIMS:
        raise NotImplementedError(f"the decode kernels are built for head dims {SUPPORTED_HEAD_DIMS}, got {d}")
    if hq % hkv or hq // hkv > _MAX_GROUP:
        raise NotImplementedError(f"the decode kernels take GQA groups of 1-{_MAX_GROUP} q heads, got {hq}/{hkv}")
    tensors = [q, k, v, lengths] + ([k_scales, v_scales] if quantized else [])
    tensors += [page_indices] if page_indices is not None else []
    if kernel_route(*tensors) != "cuda":
        raise RuntimeError(f"{entry} runs on CUDA tensors only; CPU tensors take the plain version")
    from ..kernels._build import library

    _check_rows("k", k)
    _check_rows("v", v)
    if q.stride(-1) != 1:
        q = q.contiguous()
    if quantized:
        if k_scales.dtype != torch.float32 or k_scales.stride() != v_scales.stride() or k_scales.stride(-1) != 1:
            raise ValueError("k_scales/v_scales must be fp32 with equal strides and contiguous rows")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty(batch, hq, d, dtype=q.dtype, device=q.device)
    sc = k_scales.stride()[:2] if quantized else (0, 0)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:2], *out.stride()[:2], *k.stride()[:3], *v.stride()[:3], *sc)
    kv_code = QUANT_DTYPES[k.dtype] if quantized else 0
    scale_ptrs = (k_scales.data_ptr(), v_scales.data_ptr()) if quantized else (None, None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if entry == "paged_decode":
            page_indices = page_indices.to(torch.int32).contiguous()
            err = library().fa_paged_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *scale_ptrs, lengths.data_ptr(), page_indices.data_ptr(),
                out.data_ptr(), _DTYPE_CODES[q.dtype], kv_code, batch, hq, hkv, d, k.shape[2], page_indices.shape[1],
                len_add, strides, sm_scale, stream,
            )
        else:
            err = library().fa_fused_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *scale_ptrs, lengths.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[q.dtype], kv_code, batch, hq, hkv, d, k.shape[2], strides, sm_scale, stream,
            )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with cudaError {err}")
    KERNEL_LAUNCHES[entry] += 1
    return out


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

    Returns [batch, q_heads, head_dim] in q's dtype.  On CUDA: float32 or
    bfloat16 q, head dims 64 and 128, GQA groups of up to 8 q heads.
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
