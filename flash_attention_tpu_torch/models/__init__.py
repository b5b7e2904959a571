"""Model layer: GPT-2-class transformer over the flash kernels."""

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

__all__ = [
    "GPT",
    "GPT2_124M",
    "SHAKESPEARE_CHAR",
    "GPTConfig",
    "generate",
    "grads_to_jax_layout",
    "loss_fn",
    "num_params",
    "params_from_jax",
]
