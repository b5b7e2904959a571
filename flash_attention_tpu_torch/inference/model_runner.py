"""GPT forward passes against a KV cache: prefill and decode.

Port of `flash_attention_tpu/inference/model_runner.py` (prefill,
prefill_many, decode_step and decode_loop).  Prefill runs the
flash-attention kernel over the prompt (a fresh slot's cache is empty, so
prompt tokens attend causally among themselves) and writes K/V into the
cache as it goes, quantized when the cache is; decode runs one token per
slot through the decode attention that `attn_impl` names.  The functions
take the `GPT` module where the JAX package took its params pytree and
config; the cache is updated in place.  Weight-only quantized projections
(`quant.weights.quantize_gpt_params`, which swaps the linears for
`QuantizedLinear`s) run through every function here unchanged, as the JAX
package's `_matmul` takes QuantizedTensor leaves.  The Llama family's
prefill and decode live in `models/llama.py`, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..kernels.flash_attention import flash_attention
from ..models.gpt import GPT
from . import kv_cache as kvc
from .decode_attention import decode_attention, decode_attention_fused, decode_attention_paged

# decode_step's attn_impl.  The JAX package's "chunked" worked around an XLA
# strategy of the TPU toolchain and is not ported.
DECODE_ATTENTION = {
    "einsum": decode_attention,
    "paged": decode_attention_paged,
    "fused": decode_attention_fused,
}


def _prefill_blocks(model: GPT, tokens: torch.Tensor, cache: kvc.KVCache, slots: Sequence[int]) -> torch.Tensor:
    """Run prompts [M, T] through every block, writing row i's K/V into
    slot slots[i]; returns the residual stream [M, T, E]."""
    m, t = tokens.shape
    x = model.embed(tokens, torch.arange(t, device=tokens.device))
    for li, blk in enumerate(model.blocks):
        q, k, v = blk.attn.split_heads(blk.ln1(x))
        for i, slot in enumerate(slots):
            kvc.prefill_write(cache, li, slot, k[i], v[i])
        y = flash_attention(q, k, v, causal=True)
        x = x + blk.attn.merge_heads(y)
        x = x + blk.mlp(blk.ln2(x))
    return x


@torch.no_grad()
def prefill(
    model: GPT,
    tokens: torch.Tensor,
    cache: kvc.KVCache,
    slot: int,
    length: int | None = None,
) -> tuple[kvc.KVCache, torch.Tensor]:
    """Run a prompt [T] through the model, filling `slot` of the cache.

    Returns (cache, fp32 logits [vocab] at the last real token).  `length`
    is the true prompt length when the prompt is right-padded to a bucket:
    the logits come from position length-1 and the cache length is set to
    `length`; the padded rows' K/V stay in the cache past that length,
    where the length mask hides them.  The slot must be fresh.
    """
    t = tokens.shape[0]
    n = t if length is None else int(length)
    x = _prefill_blocks(model, tokens[None], cache, [slot])
    logits = model.head(x[0, n - 1]).float()
    kvc.set_length(cache, slot, n)
    return cache, logits


@torch.no_grad()
def prefill_many(
    model: GPT,
    tokens: torch.Tensor,
    cache: kvc.KVCache,
    slots: Sequence[int],
    lengths: Sequence[int],
) -> tuple[kvc.KVCache, torch.Tensor]:
    """Batched admission: prefill M same-bucket prompts in one forward.

    tokens [M, T] (right-padded to the shared bucket T), slots [M], lengths
    [M] true lengths.  Returns (cache, fp32 logits [M, vocab] at each
    prompt's last real token).
    """
    m = tokens.shape[0]
    x = _prefill_blocks(model, tokens, cache, list(slots))
    dev = tokens.device
    lens = torch.as_tensor(list(lengths), dtype=torch.int32, device=dev)
    last = x[torch.arange(m, device=dev), lens.long() - 1]
    logits = model.head(last).float()
    kvc.set_length(cache, torch.as_tensor(list(slots), device=dev).long(), lens)
    return cache, logits


@torch.no_grad()
def decode_step(
    model: GPT,
    tokens: torch.Tensor,
    cache: kvc.KVCache,
    active: torch.Tensor | None = None,
    *,
    attn_impl: str = "einsum",
) -> tuple[kvc.KVCache, torch.Tensor]:
    """One decode step for every slot: tokens [slots] -> fp32 logits
    [slots, vocab].

    Each slot's token sits at position lengths[slot], clamped to the cache
    capacity; its K/V is written there before attention, which then sees
    positions 0..lengths[slot].  Inactive slots compute garbage (fixed
    shapes); `active` [slots] bool gates their length advance.  Lengths
    stop advancing at max_len - 1, so a full slot overwrites its last
    entry instead of corrupting the mask; the engine retires sequences
    before that.  attn_impl: "einsum" (plain PyTorch over the whole cache,
    the default), "paged" (K5 over the cache's page view) or "fused" (K6,
    slot-major); the kernels read each slot only up to its length.
    """
    if attn_impl not in DECODE_ATTENTION:
        raise ValueError(f"attn_impl must be one of {sorted(DECODE_ATTENTION)}, got {attn_impl!r}")
    attend = DECODE_ATTENTION[attn_impl]
    cfg = model.cfg
    s = cache.slots
    h, hkv, d = cfg.n_head, cfg.kv_heads, cfg.head_dim
    positions = cache.lengths.clamp(0, cache.max_len - 1)
    x = model.embed(tokens, positions.clamp(0, cfg.block_size - 1).long())[:, None]
    for li, blk in enumerate(model.blocks):
        q, k, v = blk.attn.split_heads(blk.ln1(x))  # [S, H, 1, D]
        kvc.decode_write(cache, li, k.reshape(s, hkv, d), v.reshape(s, hkv, d), positions)
        y = attend(q.reshape(s, h, d), cache, li)
        x = x + blk.attn.merge_heads(y[:, :, None])
        x = x + blk.mlp(blk.ln2(x))
    logits = model.head(x[:, 0]).float()
    step = torch.ones_like(cache.lengths) if active is None else active.to(torch.int32)
    step = torch.where(cache.lengths < cache.max_len - 1, step, 0)
    kvc.advance_lengths(cache, step)
    return cache, logits


@torch.no_grad()
def decode_loop(
    model: GPT,
    cache: kvc.KVCache,
    first_tokens: torch.Tensor,
    n_steps: int,
    *,
    attn_impl: str = "einsum",
) -> tuple[kvc.KVCache, torch.Tensor]:
    """Greedy decoding of `n_steps` chained decode steps on the device (a
    Python loop in place of the JAX package's lax.scan).  Returns (cache,
    tokens [n_steps, slots])."""
    toks = first_tokens
    out = []
    for _ in range(n_steps):
        cache, logits = decode_step(model, toks, cache, attn_impl=attn_impl)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(toks)
    return cache, torch.stack(out)
