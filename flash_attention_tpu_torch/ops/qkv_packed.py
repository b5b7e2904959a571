"""Reference-parity packed-QKV op.

Port of `flash_attention_tpu/ops/qkv_packed.py`: the source repo's public
op `flash_attention_qkv_packed(qkv, num_chunks_q, num_chunks_kv)`, with its
validation rules and its contract that no 1/sqrt(D) scaling is applied
(the caller scales Q).  It is differentiable: its backward runs K2/K3 on
CUDA tensors and the plain backward on CPU tensors.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention


def flash_attention_qkv_packed(
    qkv: torch.Tensor,
    num_chunks_q: int = 1,
    num_chunks_kv: int = 1,
) -> torch.Tensor:
    """Causally-masked flash attention on a packed QKV tensor.

    Args:
      qkv: [3, num_groups, seq_len, head_dim]: Q, K, V stacked on axis 0;
        num_groups is typically batch*heads flattened.  Q is expected to be
        pre-scaled by the caller (reference parity).
      num_chunks_q / num_chunks_kv: sequence chunking factors; seq_len must be
        divisible by both.  They set the plain version's tiles
        (`blocks_from_chunks`); the CUDA kernels keep their own tile.

    Returns: [num_groups, seq_len, head_dim].
    """
    if qkv.dim() != 4:
        raise ValueError(f"qkv must have 4 dimensions [3, groups, seq, head_dim]; got {qkv.dim()}")
    if qkv.shape[0] != 3:
        raise ValueError(f"qkv.shape[0] must be 3; got {qkv.shape[0]}")
    seq_len = qkv.shape[2]
    if seq_len % num_chunks_q != 0:
        raise ValueError(f"seq_len ({seq_len}) must be divisible by num_chunks_q ({num_chunks_q})")
    if seq_len % num_chunks_kv != 0:
        raise ValueError(f"seq_len ({seq_len}) must be divisible by num_chunks_kv ({num_chunks_kv})")
    q, k, v = qkv[0], qkv[1], qkv[2]
    # Fold groups into the head axis of a batch-1 call: [1, G, L, D].
    out = flash_attention(
        q[None],
        k[None],
        v[None],
        causal=True,
        sm_scale=1.0,  # the reference op does not scale
        num_chunks_q=num_chunks_q,
        num_chunks_kv=num_chunks_kv,
    )
    return out[0]
