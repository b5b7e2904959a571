"""Decode-step attention: one new token per slot against the KV cache.

Port of `flash_attention_tpu/inference/decode_attention.py`.  Three
implementations of one function, selected by `decode_step(attn_impl=...)`:

* ``decode_attention`` ("einsum", the default): plain PyTorch, what the JAX
  package left to XLA.  It reads the whole capacity of the layer's cache,
  and a quantized cache is read as its payload with the per-token scales
  folded into the scores and the probabilities (`_einsum_attend`).  It is
  also K6's plain version.
* ``decode_attention_paged`` ("paged"): K5 (`paged_attention`) over a
  zero-copy page view of the slot cache and its identity page table.
* ``decode_attention_fused`` ("fused"): K6, the slot-major kernel, which
  reads one layer of the cache in place through its strides.

Both kernels stop at each slot's length and dequantize int8/fp8 payloads in
registers.  They take fp32, bf16 and fp16 q, any GQA group (multi-query
attention included) and head dims 8, 16, 32 and every multiple of 16 from
48 to 1024 (`paged_attention.HEAD_DIMS`: Phi-2's 80, GPT-NeoX-20B's 96,
MPT-30B's 112, StableLM-2-12B's 160 among them).  On CPU tensors the paged
path takes K5's plain version (`paged_attention_ref`) and the fused path the
einsum.  The TPU-only fallbacks of the JAX package (to the einsum for head
dims the TPU could not tile, :172-173, :431-439) are not ported: at those
head dims the kernels run (the same function), and on CUDA a head dim
outside that set raises rather than run an einsum.
"""

from __future__ import annotations

import functools

import torch

from ..config import kernel_route
from ..kernels.vanilla import DEFAULT_MASK_VALUE
from . import kv_cache as kvc
from .kv_cache import KVCache
from .paged_attention import _launch_decode, paged_attention_ref


def decode_attention(
    q: torch.Tensor,
    cache: KVCache,
    layer: int,
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """q: [slots, q_heads, head_dim] (one token per slot) -> same shape.

    Each slot attends to its first `lengths[slot] + 1` cache entries: the
    +1 is the current token, which the caller has already written at
    position lengths[slot] with decode_write.  Scores and softmax in fp32;
    a quantized cache's K scales multiply the scores and its V scales the
    probabilities, which are then rounded to q's dtype before the PV
    product, as in the JAX package (`_einsum_attend`).
    """
    s, hq, d = q.shape
    hkv = cache.kv_heads
    group = hq // hkv
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    q4 = q.reshape(s, hkv, group, d).float()
    k = cache.k[layer].to(q.dtype).float()  # [hkv, s, L, d]
    v = cache.v[layer].to(q.dtype).float()
    scores = torch.einsum("shgd,hsld->shgl", q4, k) * sm_scale
    if cache.quantized:
        scores = scores * cache.k_scale[layer].transpose(0, 1)[:, :, None, :]
    valid = torch.arange(cache.max_len, device=q.device)[None, :] <= cache.lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores, DEFAULT_MASK_VALUE)
    p = torch.softmax(scores, dim=-1)
    if cache.quantized:
        p = p * cache.v_scale[layer].transpose(0, 1)[:, :, None, :]
    out = torch.einsum("shgl,hsld->shgd", p.to(q.dtype).float(), v)
    return out.reshape(s, hq, d).to(q.dtype)


@functools.lru_cache(maxsize=64)
def identity_table(slots: int, max_len: int, page_size: int, device: torch.device) -> torch.Tensor:
    """`kv_cache.identity_page_indices`, made once per (slots, max_len,
    page_size, device) instead of once per layer and decode step.  Callers
    read it and never write it."""
    return kvc.identity_page_indices(slots, max_len, page_size, device=device)


def decode_attention_paged(
    q: torch.Tensor,
    cache: KVCache,
    layer: int,
    *,
    page_size: int = 128,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Decode attention through K5 over the zero-copy page view of the slot
    cache (`kv_cache.page_view`) and its identity page table.  Reads only
    the pages up to each slot's length + 1 (the current token).  On CUDA it
    takes what `paged_attention` takes (fp32/bf16/fp16 q, any GQA group,
    head dims 8, 16, 32 and every multiple of 16 from 48 to 1024,
    `paged_attention.HEAD_DIMS`) and raises on anything else."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    kp, vp, ks, vs = kvc.page_view(cache, layer, page_size)
    pi = identity_table(cache.slots, cache.max_len, page_size, q.device)
    if kernel_route(q, kp) == "cuda":
        # lengths + 1 inside the kernel (len_add): no extra launch per layer
        return _launch_decode(
            "paged_decode", q, kp, vp, ks, vs, cache.lengths, pi, sm_scale=float(sm_scale), len_add=1
        )
    return paged_attention_ref(q, kp, vp, cache.lengths + 1, pi, k_scales=ks, v_scales=vs, sm_scale=sm_scale)


def decode_attention_fused(
    q: torch.Tensor,
    cache: KVCache,
    layer: int,
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Slot-major decode attention, K6: q [slots, q_heads, head_dim] -> same
    shape.  Reads layer `layer` of the cache in place, each slot only up to
    its length + 1, with q pre-scaled by sm_scale and rounded to its dtype
    as the TPU kernel does.  On CUDA: fp32/bf16/fp16 q, any GQA group and
    head dims 8, 16, 32 and every multiple of 16 from 48 to 1024
    (`paged_attention.HEAD_DIMS`), as K5 (anything else raises).  Its plain
    version, for CPU tensors, is the einsum `decode_attention`."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if kernel_route(q, cache.k) == "cuda":
        ks = cache.k_scale[layer] if cache.quantized else None
        vs = cache.v_scale[layer] if cache.quantized else None
        return _launch_decode(
            "fused_decode", q, cache.k[layer], cache.v[layer], ks, vs, cache.lengths, None,
            sm_scale=float(sm_scale), len_add=1,
        )
    return decode_attention(q, cache, layer, sm_scale=sm_scale)
