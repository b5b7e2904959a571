"""Quantization layer: the int8/fp8 KV cache format and quantized-KV flash
attention (K4).  Weight-only int8/int4 (`weights.py` in the JAX package) is
not ported yet."""

from .kv import (
    QUANT_DTYPES,
    QuantizedKV,
    dequantize_kv,
    flash_attention_kv_quant,
    flash_attention_kv_quant_reference,
    quantize_kv,
    quantize_tokens,
)

__all__ = [
    "QUANT_DTYPES",
    "QuantizedKV",
    "dequantize_kv",
    "flash_attention_kv_quant",
    "flash_attention_kv_quant_reference",
    "quantize_kv",
    "quantize_tokens",
]
