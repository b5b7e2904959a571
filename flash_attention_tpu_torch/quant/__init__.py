"""Quantization layer: weight-only INT8/INT4 (`weights.py`), the int8/fp8
KV cache format and quantized-KV flash attention (K4)."""

from .kv import (
    QUANT_DTYPES,
    QuantizedKV,
    dequantize_kv,
    flash_attention_kv_quant,
    flash_attention_kv_quant_reference,
    quantize_kv,
    quantize_tokens,
)
from .weights import (
    QuantizedLinear,
    QuantizedTensor,
    dequantize,
    gpt_forward_quantized,
    quantize_gpt_params,
    quantize_int4,
    quantize_int8,
    quantize_llama_params,
    quantize_params,
    quantized_matmul,
)

__all__ = [
    "QUANT_DTYPES",
    "QuantizedKV",
    "QuantizedLinear",
    "QuantizedTensor",
    "dequantize",
    "dequantize_kv",
    "flash_attention_kv_quant",
    "flash_attention_kv_quant_reference",
    "gpt_forward_quantized",
    "quantize_gpt_params",
    "quantize_int4",
    "quantize_int8",
    "quantize_kv",
    "quantize_llama_params",
    "quantize_params",
    "quantize_tokens",
    "quantized_matmul",
]
