"""Inference: KV cache (plain or int8/fp8), prefill/decode, chunked prefill
and the speculative verify step (the GPT path here, the Llama one in
`models.llama`), paged and slot-major decode kernels, sampling, greedy
speculative decoding, continuous batching over a GPT or a Llama."""

from .decode_attention import decode_attention, decode_attention_fused, decode_attention_paged
from .engine import InferenceEngine, Request
from .kv_cache import (
    KVCache,
    advance_lengths,
    chunk_write,
    decode_write,
    identity_page_indices,
    init_cache,
    layer_kv,
    multi_write,
    page_view,
    prefill_write,
    set_length,
)
from .model_runner import decode_loop, decode_step, prefill, prefill_chunk, prefill_many, verify_step
from .paged_attention import paged_attention, paged_attention_ref
from .sampling import sample, sample_tokens
from .speculative import gather_tokens, speculative_decode_loop

__all__ = [
    "InferenceEngine",
    "KVCache",
    "Request",
    "advance_lengths",
    "chunk_write",
    "decode_attention",
    "decode_attention_fused",
    "decode_attention_paged",
    "decode_loop",
    "decode_step",
    "decode_write",
    "gather_tokens",
    "identity_page_indices",
    "init_cache",
    "layer_kv",
    "multi_write",
    "page_view",
    "paged_attention",
    "paged_attention_ref",
    "prefill",
    "prefill_chunk",
    "prefill_many",
    "prefill_write",
    "sample",
    "sample_tokens",
    "set_length",
    "speculative_decode_loop",
    "verify_step",
]
