"""Model layer: GPT-2-class transformer over the flash kernel."""

from .gpt import GPT, GPT2_124M, SHAKESPEARE_CHAR, GPTConfig, num_params, params_from_jax

__all__ = ["GPT", "GPT2_124M", "SHAKESPEARE_CHAR", "GPTConfig", "num_params", "params_from_jax"]
