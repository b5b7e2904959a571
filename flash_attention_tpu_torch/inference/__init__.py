"""Inference: KV cache (plain or int8/fp8), prefill/decode (the GPT path
here, the Llama one in `models.llama`), paged and slot-major decode
kernels, sampling, continuous batching over a GPT or a Llama."""

from .decode_attention import decode_attention, decode_attention_fused, decode_attention_paged
from .engine import InferenceEngine, Request
from .kv_cache import (
    KVCache,
    advance_lengths,
    decode_write,
    identity_page_indices,
    init_cache,
    layer_kv,
    page_view,
    prefill_write,
    set_length,
)
from .model_runner import decode_loop, decode_step, prefill, prefill_many
from .paged_attention import paged_attention, paged_attention_ref
from .sampling import sample, sample_tokens

__all__ = [
    "InferenceEngine",
    "KVCache",
    "Request",
    "advance_lengths",
    "decode_attention",
    "decode_attention_fused",
    "decode_attention_paged",
    "decode_loop",
    "decode_step",
    "decode_write",
    "identity_page_indices",
    "init_cache",
    "layer_kv",
    "page_view",
    "paged_attention",
    "paged_attention_ref",
    "prefill",
    "prefill_many",
    "prefill_write",
    "sample",
    "sample_tokens",
    "set_length",
]
