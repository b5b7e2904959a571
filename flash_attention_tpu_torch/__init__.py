"""flash-attention-tpu, ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package `flash_attention_tpu` is the reference; this package keeps
its module names.  Plain tensor code is PyTorch; each Pallas kernel on a
ported path is a kernel written by hand for sm_90a (`csrc/`), built on
first use.  This slice covers the GPT-2 serving path: flash-attention
forward (prefill), einsum decode, sampling and the continuous-batching
engine.
"""

from .kernels import (
    BlockSizes,
    flash_attention,
    flash_attention_with_lse,
    vanilla_attention,
)

__version__ = "0.1.0"

__all__ = [
    "BlockSizes",
    "flash_attention",
    "flash_attention_with_lse",
    "vanilla_attention",
    "__version__",
]
