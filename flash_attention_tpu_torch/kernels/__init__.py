"""Kernel layer: the hand-written Hopper kernels, their wrappers and plain
PyTorch versions, and the dense references."""

from .autotune import autotune, autotune_for_model, tuned_blocks
from .block_sizes import (
    MIN_BLOCK,
    BlockSizes,
    auto_num_chunks,
    blocks_from_chunks,
    default_blocks,
    resolve_bwd_blocks,
)
from .flash_attention import (
    KERNEL_LAUNCHES,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_attention_with_lse,
)
from .vanilla import vanilla_attention, vanilla_attention_with_lse

__all__ = [
    "KERNEL_LAUNCHES",
    "MIN_BLOCK",
    "BlockSizes",
    "auto_num_chunks",
    "autotune",
    "autotune_for_model",
    "blocks_from_chunks",
    "default_blocks",
    "flash_attention",
    "flash_attention_bwd_reference",
    "flash_attention_reference",
    "flash_attention_with_lse",
    "resolve_bwd_blocks",
    "tuned_blocks",
    "vanilla_attention",
    "vanilla_attention_with_lse",
]
