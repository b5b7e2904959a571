"""Drop-in scaled dot-product attention with flash routing.

Port of `flash_attention_tpu/ops/sdpa.py`: where the JAX package patches
`jax.nn.dot_product_attention`, this patches
`torch.nn.functional.scaled_dot_product_attention`, with that function's
signature and layout (q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D]).

A call routes to `flash_attention` only where the kernels compute exactly
what torch's function computes.  Everything else falls through to the saved
original, as the JAX router's `_supported` does: an `attn_mask`,
`dropout_p > 0`, inputs that are not 4-D, differing head counts without
`enable_gqa`, arguments torch adds later, on CUDA a head dim above 1024 or
a dtype the kernels are not built for (head dims up to 1024 are
zero-padded to 64, 128, 256, 512 or 1024 by `flash_attention`), and causal
attention with Lq != Lk, where torch aligns the mask to the top-left
corner and the kernels align the queries to the end of the keys.  (The JAX router routes that last case to its
kernel anyway, which gives the end-aligned result.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import kernel_route
from ..kernels.flash_attention import _DTYPE_CODES, SUPPORTED_HEAD_DIMS, flash_attention


def _supported(query, key, value, attn_mask, dropout_p, is_causal, enable_gqa, extra) -> bool:
    if attn_mask is not None or dropout_p > 0.0 or extra:
        return False
    if query.dim() != 4 or key.dim() != 4 or value.dim() != 4:
        return False
    if is_causal and query.shape[-2] != key.shape[-2]:
        return False
    if query.shape[1] != key.shape[1] and not enable_gqa:
        return False
    if kernel_route(query, key, value) == "cuda":
        return query.shape[-1] <= max(SUPPORTED_HEAD_DIMS) and query.dtype in _DTYPE_CODES
    return True


def _try_flash(query, key, value, attn_mask, dropout_p, is_causal, scale, enable_gqa, extra):
    """The flash result when the arguments are expressible there, else None."""
    if not _supported(query, key, value, attn_mask, dropout_p, is_causal, enable_gqa, extra):
        return None
    return flash_attention(query, key, value, causal=is_causal, sm_scale=scale)


def _original():
    sdpa = F.scaled_dot_product_attention
    return getattr(sdpa, "__wrapped__", sdpa)


def dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: torch.Tensor | None = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    scale: float | None = None,
    enable_gqa: bool = False,
    **kwargs,
) -> torch.Tensor:
    """`torch.nn.functional.scaled_dot_product_attention`-compatible entry
    point: the flash kernels where they compute the same thing, torch's own
    function otherwise."""
    out = _try_flash(query, key, value, attn_mask, dropout_p, is_causal, scale, enable_gqa, kwargs)
    if out is not None:
        return out
    return _original()(
        query, key, value, attn_mask=attn_mask, dropout_p=dropout_p, is_causal=is_causal,
        scale=scale, enable_gqa=enable_gqa, **kwargs,
    )


def install_patch() -> None:
    """Replace `torch.nn.functional.scaled_dot_product_attention` with the
    flash router.  Idempotent."""
    from ..utils.patching import patch_function

    original = F.scaled_dot_product_attention
    if getattr(original, "__wrapped__", None) is not None:
        return  # already patched

    @patch_function(original, [F])
    def _flash_sdpa(orig, query, key, value, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None,
                    enable_gqa=False, **kwargs):
        out = _try_flash(query, key, value, attn_mask, dropout_p, is_causal, scale, enable_gqa, kwargs)
        if out is not None:
            return out
        return orig(query, key, value, attn_mask=attn_mask, dropout_p=dropout_p, is_causal=is_causal,
                    scale=scale, enable_gqa=enable_gqa, **kwargs)


def uninstall_patch() -> None:
    """Restore the stock `torch.nn.functional.scaled_dot_product_attention`."""
    from ..utils.patching import unpatch_function

    patched = F.scaled_dot_product_attention
    if getattr(patched, "__wrapped__", None) is not None:
        unpatch_function(patched, [F])
