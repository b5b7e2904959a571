"""Decode-step attention: one new token per slot against the KV cache.

Port of `flash_attention_tpu/inference/decode_attention.py::decode_attention`,
the engine's default ("einsum") path, which the JAX package left to XLA and
this port leaves to plain PyTorch.  The Pallas decode kernels (the fused
slot-major kernel and the paged kernel) are later port work.
"""

from __future__ import annotations

import torch

from ..kernels.vanilla import DEFAULT_MASK_VALUE
from .kv_cache import KVCache


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
    the probabilities are rounded to q's dtype before the PV product, as
    in the JAX package.
    """
    s, hq, d = q.shape
    hkv = cache.kv_heads
    group = hq // hkv
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    q4 = q.reshape(s, hkv, group, d).float()
    k = cache.k[layer].float()  # [hkv, s, L, d]
    v = cache.v[layer]
    scores = torch.einsum("shgd,hsld->shgl", q4, k) * sm_scale
    valid = torch.arange(cache.max_len, device=q.device)[None, :] <= cache.lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores, DEFAULT_MASK_VALUE)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("shgl,hsld->shgd", p.to(q.dtype).float(), v.to(q.dtype).float())
    return out.reshape(s, hq, d).to(q.dtype)
