"""Op/API layer: validated public entry points over the kernel layer."""

from .qkv_packed import flash_attention_qkv_packed
from .sdpa import dot_product_attention, install_patch, uninstall_patch

__all__ = [
    "dot_product_attention",
    "flash_attention_qkv_packed",
    "install_patch",
    "uninstall_patch",
]
