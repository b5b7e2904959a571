"""Model layer: GPT-2-class and Llama-family transformers over the flash
kernels."""

from . import llama
from .gpt import (
    GPT,
    GPT2_124M,
    SHAKESPEARE_CHAR,
    GPTConfig,
    generate,
    grads_to_jax_layout,
    loss_fn,
    num_params,
    params_from_jax,
)
from .llama import LLAMA2_7B, LLAMA3_8B, TINY_LLAMA, Llama, LlamaConfig

__all__ = [
    "GPT",
    "GPT2_124M",
    "LLAMA2_7B",
    "LLAMA3_8B",
    "Llama",
    "LlamaConfig",
    "SHAKESPEARE_CHAR",
    "TINY_LLAMA",
    "GPTConfig",
    "generate",
    "grads_to_jax_layout",
    "llama",
    "loss_fn",
    "num_params",
    "params_from_jax",
]
