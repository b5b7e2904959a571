"""Dense ("vanilla") attention in plain PyTorch: the numerical ground truth.

Port of `flash_attention_tpu/kernels/vanilla.py`.  Masked scores take a
large finite value instead of -inf, and the softmax statistics are fp32
whatever the input dtype; the products are computed on fp32 copies of the
inputs, which is exact for bf16/fp16 and matches the JAX package's
`preferred_element_type=float32` with full-precision fp32 passes.
"""

from __future__ import annotations

import torch

# -0.7 * fp32 max instead of -inf: exp(-inf - (-inf)) is NaN.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _causal_mask(
    q_len: int, kv_len: int, window: int | None, device: torch.device
) -> torch.Tensor:
    """[q_len, kv_len] bool mask; True = attend.

    Query row i sits at absolute position i + kv_len - q_len (queries
    aligned to the end of the KV sequence).  With `window`, only the last
    `window` positions (self included) attend.
    """
    row = torch.arange(q_len, device=device)[:, None]
    col = torch.arange(kv_len, device=device)[None, :]
    mask = col <= row + (kv_len - q_len)
    if window is not None:
        mask = mask & (col >= row + (kv_len - q_len) - (window - 1))
    return mask


def vanilla_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float = 1.0,
    window: int | None = None,
    segment_ids=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense attention returning (out, logsumexp).

    Shapes: q [..., q_len, d], k/v [..., kv_len, d] with matching batch
    dims.  segment_ids: optional (q_ids [B, q_len], kv_ids [B, kv_len]) for
    packed sequences (assumes a leading batch dim B and a head dim).
    Output in q's dtype; lse fp32 [..., q_len].
    """
    q_len, kv_len = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        mask = _causal_mask(q_len, kv_len, window, q.device)
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    if segment_ids is not None:
        q_ids, kv_ids = segment_ids
        seg = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
        s = torch.where(seg, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    out = torch.matmul((p / l).to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def vanilla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float = 1.0,
    window: int | None = None,
    segment_ids=None,
) -> torch.Tensor:
    """Dense attention (differentiable through plain autograd)."""
    out, _ = vanilla_attention_with_lse(
        q, k, v, causal=causal, sm_scale=sm_scale, window=window,
        segment_ids=segment_ids,
    )
    return out
