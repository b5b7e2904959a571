"""KV cache for autoregressive decoding.

Port of `flash_attention_tpu/inference/kv_cache.py`.  Layout: k, v are
[n_layer, kv_heads, slots, max_len, head_dim]; lengths [slots] int32.  With
heads leading, one layer of the cache is an identity-paged cache by a pure
reshape (`page_view`): slot s owns pages [s * max_len / page_size,
(s + 1) * max_len / page_size), so the paged decode kernel (K5) reads it in
place.  Optional int8/fp8 storage: payload plus one fp32 scale per token
(k_scale, v_scale [n_layer, kv_heads, slots, max_len]), written with
`quant.kv.quantize_tokens` and dequantized at attention time (inside the
decode kernels).  Four write paths: `prefill_write` (a fresh prompt),
`chunk_write` (a chunk of a prompt at an offset), `decode_write` (one
token per slot) and `multi_write` (C tokens per slot, the speculative
verify step).

Unlike the JAX package, whose arrays are immutable, every write here
happens IN PLACE on the cache's tensors, which saves a copy of the cache per
write; the functions return the same cache object for call-site parity.  A
caller that needs the old contents keeps a clone.  For the same reason
k_scale and v_scale are two tensors: the JAX package's `init_cache` gives
both one array (kv_cache.py:76), harmless there and a bug under in-place
writes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import resolve_device
from ..quant.kv import QUANT_DTYPES, quantize_tokens


@dataclasses.dataclass
class KVCache:
    """k, v: [n_layer, kv_heads, slots, max_len, head_dim] payloads;
    k_scale/v_scale: [n_layer, kv_heads, slots, max_len] fp32 or None;
    lengths: [slots] int32, the number of valid positions of each slot."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None
    lengths: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def slots(self) -> int:
        return self.k.shape[2]

    @property
    def kv_heads(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(
    n_layer: int,
    slots: int,
    kv_heads: int,
    max_len: int,
    head_dim: int,
    *,
    dtype: torch.dtype = torch.bfloat16,
    quant_dtype: torch.dtype | None = None,
    device=None,
) -> KVCache:
    """An empty cache in `dtype`, or with int8/fp8 payloads and fp32 scales
    (ones) when `quant_dtype` is given, on `device` (default the card,
    "cuda", which raises without one; "cpu" when asked for)."""
    if quant_dtype is not None and quant_dtype not in QUANT_DTYPES:
        raise ValueError(f"quant_dtype must be one of {list(QUANT_DTYPES)}, got {quant_dtype}")
    device = resolve_device(device)
    shape = (n_layer, kv_heads, slots, max_len, head_dim)
    store = quant_dtype or dtype
    k_scale = v_scale = None
    if quant_dtype is not None:  # two tensors: the writes are in place
        k_scale = torch.ones(shape[:-1], device=device)
        v_scale = torch.ones(shape[:-1], device=device)
    return KVCache(
        torch.zeros(shape, dtype=store, device=device),
        torch.zeros(shape, dtype=store, device=device),
        k_scale,
        v_scale,
        torch.zeros(slots, dtype=torch.int32, device=device),
    )


def _payload(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor):
    """(k, v, k_scale, v_scale) as the cache stores them (scales None when
    unquantized)."""
    if cache.quantized:
        kq, ks = quantize_tokens(k_new, cache.k.dtype)
        vq, vs = quantize_tokens(v_new, cache.v.dtype)
        return kq, vq, ks, vs
    return k_new.to(cache.k.dtype), v_new.to(cache.v.dtype), None, None


def prefill_write(cache: KVCache, layer: int, slot: int, k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Write a fresh prompt's K/V into one slot at position 0, in place.
    k_new, v_new: [kv_heads, T, head_dim]."""
    t = k_new.shape[1]
    k, v, ks, vs = _payload(cache, k_new, v_new)
    cache.k[layer, :, slot, :t].copy_(k)
    cache.v[layer, :, slot, :t].copy_(v)
    if cache.quantized:
        cache.k_scale[layer, :, slot, :t].copy_(ks)
        cache.v_scale[layer, :, slot, :t].copy_(vs)
    return cache


def chunk_write(
    cache: KVCache, layer: int, slot: int, k_new: torch.Tensor, v_new: torch.Tensor, start: int
) -> KVCache:
    """Write a chunk of C tokens into one slot at position `start`, in place
    (chunked prefill).  k_new, v_new: [kv_heads, C, head_dim].  The start
    is clamped to [0, max_len - C], as the JAX package's
    `lax.dynamic_update_slice` clamps it; a plain slice would instead cut
    the chunk short at the capacity."""
    c = k_new.shape[1]
    start = min(max(int(start), 0), cache.max_len - c)
    k, v, ks, vs = _payload(cache, k_new, v_new)
    cache.k[layer, :, slot, start:start + c].copy_(k)
    cache.v[layer, :, slot, start:start + c].copy_(v)
    if cache.quantized:
        cache.k_scale[layer, :, slot, start:start + c].copy_(ks)
        cache.v_scale[layer, :, slot, start:start + c].copy_(vs)
    return cache


def decode_write(
    cache: KVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor, positions: torch.Tensor
) -> KVCache:
    """Write one new token per slot, in place: k_new/v_new [slots, kv_heads,
    head_dim] at positions [slots]."""
    sl = torch.arange(cache.slots, device=positions.device)
    pos = positions.long()
    k, v, ks, vs = _payload(cache, k_new, v_new)
    cache.k[layer][:, sl, pos] = k.transpose(0, 1)
    cache.v[layer][:, sl, pos] = v.transpose(0, 1)
    if cache.quantized:
        cache.k_scale[layer][:, sl, pos] = ks.transpose(0, 1)
        cache.v_scale[layer][:, sl, pos] = vs.transpose(0, 1)
    return cache


def multi_write(
    cache: KVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor, positions: torch.Tensor
) -> KVCache:
    """Write C tokens per slot in one indexed write per tensor, in place:
    k_new/v_new [slots, C, kv_heads, head_dim] at positions [slots, C] (the
    speculative verify step's writes).  Positions that repeat within a slot
    (rows clipped at the capacity) leave one of their rows, which one being
    undefined, as in the JAX package's scatter; such rows lie past the
    slot's length."""
    sl = torch.arange(cache.slots, device=positions.device)[:, None]
    pos = positions.long()
    k, v, ks, vs = _payload(cache, k_new, v_new)
    cache.k[layer][:, sl, pos] = k.permute(2, 0, 1, 3)
    cache.v[layer][:, sl, pos] = v.permute(2, 0, 1, 3)
    if cache.quantized:
        cache.k_scale[layer][:, sl, pos] = ks.permute(2, 0, 1)
        cache.v_scale[layer][:, sl, pos] = vs.permute(2, 0, 1)
    return cache


def advance_lengths(cache: KVCache, amount) -> KVCache:
    """lengths += amount (a scalar or a [slots] tensor), in place."""
    cache.lengths += amount
    return cache


def set_length(cache: KVCache, slot, length) -> KVCache:
    """lengths[slot] = length, in place (slot and length may be index
    tensors of equal size)."""
    cache.lengths[slot] = length
    return cache


def layer_kv(cache: KVCache, layer: int, dtype: torch.dtype = torch.bfloat16):
    """K, V of one layer in `dtype`: [kv_heads, slots, max_len, d].  A
    quantized cache is dequantized (payload * scale in fp32, then rounded);
    the decode kernels do that in place instead."""
    k, v = cache.k[layer], cache.v[layer]
    if cache.quantized:
        k = k.float() * cache.k_scale[layer][..., None]
        v = v.float() * cache.v_scale[layer][..., None]
    return k.to(dtype), v.to(dtype)


def page_view(cache: KVCache, layer: int, page_size: int):
    """Zero-copy paged view of one layer for the paged decode kernel.

    Returns (k_pages, v_pages, k_scales, v_scales): pages [kv_heads,
    slots * max_len / page_size, page_size, head_dim], scales [kv_heads,
    pages, page_size] (None when unquantized), all views of the cache."""
    if cache.max_len % page_size:
        raise ValueError(f"max_len {cache.max_len} % page_size {page_size}")
    hkv, s, l = cache.kv_heads, cache.slots, cache.max_len
    n_pages = s * l // page_size
    d = cache.k.shape[-1]
    k_pages = cache.k[layer].view(hkv, n_pages, page_size, d)
    v_pages = cache.v[layer].view(hkv, n_pages, page_size, d)
    ks = vs = None
    if cache.quantized:
        ks = cache.k_scale[layer].view(hkv, n_pages, page_size)
        vs = cache.v_scale[layer].view(hkv, n_pages, page_size)
    return k_pages, v_pages, ks, vs


def identity_page_indices(slots: int, max_len: int, page_size: int, device=None) -> torch.Tensor:
    """[slots, max_len / page_size] int32 page table of the slot-contiguous
    cache: slot s owns pages s * pps ... (s + 1) * pps - 1.  device as in
    `init_cache` (default the card)."""
    pps = max_len // page_size
    return torch.arange(slots * pps, dtype=torch.int32, device=resolve_device(device)).view(slots, pps)
