"""GPT forward passes against a KV cache: prefill and decode.

Port of `flash_attention_tpu/inference/model_runner.py` (prefill,
prefill_many, prefill_chunk, verify_step, decode_step and decode_loop).
Prefill runs the flash-attention kernel over the prompt (a fresh slot's
cache is empty, so prompt tokens attend causally among themselves) and
writes K/V into the cache as it goes, quantized when the cache is; decode
runs one token per slot through the decode attention that `attn_impl`
names.  A prompt's chunk (`prefill_chunk`) and the speculative verify step
(`verify_step`) score several rows per slot at an offset into the cache,
through the dense `_offset_attention`, as the JAX package does.  The
functions take the `GPT` module where the JAX package took its params
pytree and config; the cache is updated in place.  Weight-only quantized
projections (`quant.weights.quantize_gpt_params`, which swaps the linears
for `QuantizedLinear`s) run through every function here unchanged, as the
JAX package's `_matmul` takes QuantizedTensor leaves.  The Llama family's
prefill and decode live in `models/llama.py`, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.vanilla import DEFAULT_MASK_VALUE
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


def _offset_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor | None,
    v_scale: torch.Tensor | None,
    starts: torch.Tensor,
) -> torch.Tensor:
    """Dense attention of C rows per slot at per-slot offsets: the one core
    of chunked prefill and of the speculative verify step.

    q [S, Hq, C, D]; k/v [Hkv, S, L, D] (the cache's layout, int8/fp8
    payloads with k_scale/v_scale [Hkv, S, L] when quantized); starts [S].
    Row c of slot s sits at position starts[s] + c and sees the cache
    entries up to it.  The order is the JAX package's (and
    `decode_attention`'s): fp32 scores scaled by d**-0.5 after the product,
    then by the K scales; the mask; softmax; the V scales on P; P and V
    rounded to q's dtype, accumulated in fp32.  Plain PyTorch, as the JAX
    package leaves it to XLA: no flash kernel takes a per-slot offset, and
    like the einsum decode it reads (and upcasts) the slots' whole capacity.
    """
    s, hq, c, d = q.shape
    hkv = k.shape[0]
    q5 = q.reshape(s, hkv, hq // hkv, c, d).float()
    scores = torch.einsum("shgcd,hsld->shgcl", q5, k.to(q.dtype).float()) * (float(d) ** -0.5)
    if k_scale is not None:
        scores = scores * k_scale.transpose(0, 1)[:, :, None, None, :]
    row = torch.arange(c, device=q.device)[None, :, None]
    col = torch.arange(k.shape[2], device=q.device)[None, None, :]
    visible = col <= starts.to(q.device)[:, None, None] + row  # [S, C, L]
    scores = torch.where(visible[:, None, None], scores, DEFAULT_MASK_VALUE)
    p = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        p = p * v_scale.transpose(0, 1)[:, :, None, None, :]
    out = torch.einsum("shgcl,hsld->shgcd", p.to(q.dtype).float(), v.to(q.dtype).float())
    return out.reshape(s, hq, c, d).to(q.dtype)


def _chunk_attention(q: torch.Tensor, cache: kvc.KVCache, layer: int, slot: int, start: int) -> torch.Tensor:
    """One slot's view of `_offset_attention` (chunked prefill): q [1, Hq,
    C, D] against slot `slot`'s cached prefix and itself at offset
    `start`."""
    take = slice(slot, slot + 1)
    return _offset_attention(
        q,
        cache.k[layer][:, take],
        cache.v[layer][:, take],
        cache.k_scale[layer][:, take] if cache.quantized else None,
        cache.v_scale[layer][:, take] if cache.quantized else None,
        torch.full((1,), int(start), device=q.device),
    )


@torch.no_grad()
def prefill_chunk(
    model: GPT,
    tokens: torch.Tensor,
    cache: kvc.KVCache,
    slot: int,
    start: int,
    length: int | None = None,
) -> tuple[kvc.KVCache, torch.Tensor]:
    """Chunked prefill: tokens [C] at positions start .. start + C - 1.

    A long prompt is admitted chunk by chunk, the engine interleaving the
    chunks with decode scans.  The chunk's K/V is written at `start` and
    its rows attend to the slot's cache up to themselves (dense, no
    kernel).  `length` is the number of real tokens in this chunk (less
    than C only on a padded final chunk): it picks the logits row and the
    cache length, as in `prefill`.  The caller has written the prompt's
    earlier chunks (cache rows [0, start)).  Returns (cache, fp32 logits
    [vocab] at the chunk's last real token); the slot's length becomes
    start + length.
    """
    cfg = model.cfg
    c = tokens.shape[0]
    positions = (start + torch.arange(c, device=tokens.device)).clamp(0, cfg.block_size - 1)
    x = model.embed(tokens[None], positions)
    for li, blk in enumerate(model.blocks):
        q, k, v = blk.attn.split_heads(blk.ln1(x))
        kvc.chunk_write(cache, li, slot, k[0], v[0], start)
        y = _chunk_attention(q, cache, li, slot, start)
        x = x + blk.attn.merge_heads(y)
        x = x + blk.mlp(blk.ln2(x))
    valid = c if length is None else int(length)
    logits = model.head(x[0, valid - 1]).float()
    kvc.set_length(cache, slot, int(start) + valid)
    return cache, logits


def _verify_attention(q: torch.Tensor, cache: kvc.KVCache, layer: int, starts: torch.Tensor) -> torch.Tensor:
    """Every slot's view of `_offset_attention` (the verify step)."""
    return _offset_attention(
        q,
        cache.k[layer],
        cache.v[layer],
        cache.k_scale[layer] if cache.quantized else None,
        cache.v_scale[layer] if cache.quantized else None,
        starts,
    )


@torch.no_grad()
def verify_step(model: GPT, tokens: torch.Tensor, cache: kvc.KVCache) -> tuple[kvc.KVCache, torch.Tensor]:
    """Score C tokens per slot in one forward: tokens [S, C] at positions
    lengths[s] .. lengths[s] + C - 1 (clipped to the capacity), their K/V
    written into the cache.

    Returns (cache, fp32 logits [S, C, vocab]): logits at every row, which
    speculative decoding's accept test needs.  The lengths are NOT
    advanced: the caller sets them from the rows it accepts, and the rows
    past them, which later writes overwrite, stay hidden by the length
    mask.  Every slot writes its rows, including slots the caller treats
    as inactive; those rows lie at or past the slot's length.
    """
    cfg = model.cfg
    s, c = tokens.shape
    starts = cache.lengths.clamp(0, cache.max_len - 1)
    pos = (starts[:, None] + torch.arange(c, device=tokens.device)[None, :]).clamp(0, cache.max_len - 1)
    x = model.embed(tokens, pos.clamp(0, cfg.block_size - 1).long())  # [S, C, E]
    for li, blk in enumerate(model.blocks):
        q, k, v = blk.attn.split_heads(blk.ln1(x))  # q [S, H, C, D], k/v [S, Hkv, C, D]
        kvc.multi_write(cache, li, k.transpose(1, 2), v.transpose(1, 2), pos)
        y = _verify_attention(q, cache, li, starts)
        x = x + blk.attn.merge_heads(y)
        x = x + blk.mlp(blk.ln2(x))
    return cache, model.head(x).float()


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
