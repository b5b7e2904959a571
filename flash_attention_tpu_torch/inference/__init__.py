"""Inference: KV cache, prefill/decode, sampling, continuous batching."""

from .decode_attention import decode_attention
from .engine import InferenceEngine, Request
from .kv_cache import (
    KVCache,
    advance_lengths,
    decode_write,
    init_cache,
    layer_kv,
    prefill_write,
    set_length,
)
from .model_runner import decode_loop, decode_step, prefill, prefill_many
from .sampling import sample, sample_tokens

__all__ = [
    "InferenceEngine",
    "KVCache",
    "Request",
    "advance_lengths",
    "decode_attention",
    "decode_loop",
    "decode_step",
    "decode_write",
    "init_cache",
    "layer_kv",
    "prefill",
    "prefill_many",
    "prefill_write",
    "sample",
    "sample_tokens",
    "set_length",
]
