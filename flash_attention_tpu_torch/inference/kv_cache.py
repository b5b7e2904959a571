"""KV cache for autoregressive decoding.

Port of `flash_attention_tpu/inference/kv_cache.py`, unquantized.  Layout:
k, v are [n_layer, kv_heads, slots, max_len, head_dim]; lengths [slots]
int32.  Unlike the JAX package, whose arrays are immutable, every write
here happens IN PLACE on the cache's tensors, which saves a copy of the
cache per write; the functions return the same cache object for
call-site parity.  A caller that needs the old contents keeps a clone.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import resolve_device


@dataclasses.dataclass
class KVCache:
    """k, v: [n_layer, kv_heads, slots, max_len, head_dim]; lengths: [slots]
    int32, the number of valid positions of each slot."""

    k: torch.Tensor
    v: torch.Tensor
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


def init_cache(
    n_layer: int,
    slots: int,
    kv_heads: int,
    max_len: int,
    head_dim: int,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> KVCache:
    device = resolve_device(device)
    shape = (n_layer, kv_heads, slots, max_len, head_dim)
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(slots, dtype=torch.int32, device=device),
    )


def prefill_write(cache: KVCache, layer: int, slot: int, k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Write a fresh prompt's K/V into one slot at position 0, in place.
    k_new, v_new: [kv_heads, T, head_dim]."""
    t = k_new.shape[1]
    cache.k[layer, :, slot, :t].copy_(k_new)
    cache.v[layer, :, slot, :t].copy_(v_new)
    return cache


def decode_write(
    cache: KVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor, positions: torch.Tensor
) -> KVCache:
    """Write one new token per slot, in place: k_new/v_new [slots, kv_heads,
    head_dim] at positions [slots]."""
    sl = torch.arange(cache.slots, device=positions.device)
    pos = positions.long()
    cache.k[layer][:, sl, pos] = k_new.transpose(0, 1).to(cache.k.dtype)
    cache.v[layer][:, sl, pos] = v_new.transpose(0, 1).to(cache.v.dtype)
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
    """K, V of one layer in `dtype`: [kv_heads, slots, max_len, d]."""
    return cache.k[layer].to(dtype), cache.v[layer].to(dtype)
