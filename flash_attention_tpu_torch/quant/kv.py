"""Quantized-KV flash attention: int8/fp8 K/V dequantized inside the kernel.

Port of `flash_attention_tpu/quant/kv.py`.  K/V are stored per token as a
1-byte payload (int8, or fp8 e4m3 as `torch.float8_e4m3fn`) and one fp32
scale.  `quantize_tokens` is the single source of that format for the KV
cache (`inference/kv_cache.py`) and for `QuantizedKV`, so cache contents and
the kernel's inputs cannot drift apart.

`flash_attention_kv_quant` looks at the device of its inputs:

* CUDA tensors go to K4, `fa_flash_fwd_kv_quant` (`csrc/flash_fwd_kv_quant.cu`),
  which is K1's kernel with a K/V tile load that dequantizes in shared
  memory (for bf16/fp16 q at 512 and 1024 the wide kernel of
  `csrc/flash_fwd_wide.cuh`); fp32 q runs the 3xTF32 kernels, which read
  the payload bytes straight into their tensor-core operands:
  `csrc/flash_fwd_fp32.cu` at 64 and 128, counted under
  "flash_fwd_kv_quant_fp32", and `csrc/flash_fwd_fp32_wide.cuh` at 256,
  512 and 1024, under "flash_fwd_kv_quant_d256_fp32" /
  "flash_fwd_kv_quant_wide_fp32" (`_route`).  Nothing falls back: what the
  kernel does not take raises.
* CPU tensors go to the plain version, `flash_attention_kv_quant_reference`:
  K1's plain tile loop on K/V dequantized the kernel's way.  Below the
  kernel's smallest shapes (`lq < MIN_BLOCK // 8` or `lk < MIN_BLOCK`) the
  CPU route takes dense attention, as the JAX package does.

The dequantization is the TPU kernel's (kv.py:149-151, :175-177), not the
one the JAX module's docstring describes: each K/V tile becomes
`payload.to(T) * scale.to(T)` in q's dtype T, the product rounded to T.
Forward only (the inference path).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..config import kernel_route
from ..kernels.block_sizes import MIN_BLOCK, BlockSizes, default_blocks
from ..kernels.flash_attention import (
    _DTYPE_CODES,
    _LOG2E,
    KERNEL_LAUNCHES,
    SUPPORTED_HEAD_DIMS,
    _aligned,
    _call,
    _ids_ptrs,
    _pad_head_dim,
    _route,
    _segments,
    _shapes,
    flash_attention_reference,
    padded_head_dim,
)
from ..kernels.vanilla import vanilla_attention

__all__ = [
    "QUANT_DTYPES",
    "QuantizedKV",
    "dequantize_kv",
    "flash_attention_kv_quant",
    "flash_attention_kv_quant_reference",
    "quantize_kv",
    "quantize_tokens",
]

# Payload types of a quantized KV cache, with their codes in the kernels' C
# interfaces (csrc/flash_fwd_kv_quant.cu, csrc/decode.cu), where 0 means a
# K/V of q's own dtype.
QUANT_DTYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}


@dataclasses.dataclass
class QuantizedKV:
    """Per-token symmetric-quantized K/V: payload [B, H, L, D], scales
    [B, H, L] fp32."""

    k: torch.Tensor
    k_scale: torch.Tensor
    v: torch.Tensor
    v_scale: torch.Tensor

    @property
    def kv_len(self) -> int:
        return self.k.shape[2]


def quantize_tokens(x: torch.Tensor, dtype: torch.dtype = torch.int8) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric quantization: x [..., d] -> (payload [..., d],
    fp32 scales [...]).  int8: scale = amax / 127, payload = round(x /
    scale) clipped to +-127; fp8: scale = amax / 448, payload = (x /
    scale) cast to fp8.  An all-zero row gets scale 1."""
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"quantized payloads are {list(QUANT_DTYPES)}, got {dtype}")
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    fmax = 127.0 if dtype == torch.int8 else float(torch.finfo(dtype).max)
    scale = torch.where(amax == 0, 1.0, amax / fmax)
    y = x32 / scale[..., None]
    if dtype == torch.int8:
        y = torch.clamp(torch.round(y), -127, 127)
    return y.to(dtype), scale


def quantize_kv(k: torch.Tensor, v: torch.Tensor, *, dtype: torch.dtype = torch.int8) -> QuantizedKV:
    """Per-token symmetric quantization of K and V ([B, H, L, D])."""
    kq, ks = quantize_tokens(k, dtype)
    vq, vs = quantize_tokens(v, dtype)
    return QuantizedKV(kq, ks, vq, vs)


def dequantize_kv(qkv: QuantizedKV, dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, v) in `dtype`, each payload * scale in fp32, then rounded."""
    k = (qkv.k.float() * qkv.k_scale[..., None]).to(dtype)
    v = (qkv.v.float() * qkv.v_scale[..., None]).to(dtype)
    return k, v


def _dequantize_like_kernel(payload: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K4's tile dequantization: payload.to(T) * scale.to(T), rounded to T."""
    return payload.to(dtype) * scale.to(dtype)[..., None]


def flash_attention_kv_quant_reference(
    q: torch.Tensor,
    kv: QuantizedKV,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    segment_ids: tuple[torch.Tensor, torch.Tensor] | None = None,
    block_sizes: BlockSizes | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K4: K1's tile loop
    (`flash_attention_reference`) over K/V dequantized as the kernel does it;
    returns out only, at K4's tile by default (`default_blocks(...,
    quantized=True)`).  segment_ids is a (q_ids, kv_ids) pair."""
    if block_sizes is None:
        _, hq, hkv, lq, lk, d = _shapes(q, kv.k, kv.v)
        block_sizes = default_blocks(lq, lk, d, hq // hkv, dtype=q.dtype, quantized=True)
    k = _dequantize_like_kernel(kv.k, kv.k_scale, q.dtype)
    v = _dequantize_like_kernel(kv.v, kv.v_scale, q.dtype)
    out, _ = flash_attention_reference(
        q, k, v, causal=causal, sm_scale=sm_scale, window=window, segment_ids=segment_ids,
        block_sizes=block_sizes,
    )
    return out


def _check_kv(q: torch.Tensor, kv: QuantizedKV):
    b, hq, hkv, lq, lk, d = _shapes(q, kv.k, kv.v)
    if kv.k.dtype not in QUANT_DTYPES or kv.v.dtype != kv.k.dtype:
        raise TypeError(f"quantized K/V payloads are {list(QUANT_DTYPES)}, got {kv.k.dtype}/{kv.v.dtype}")
    if tuple(kv.k_scale.shape) != (b, hkv, lk) or tuple(kv.v_scale.shape) != (b, hkv, lk):
        raise ValueError(
            f"scales {tuple(kv.k_scale.shape)}/{tuple(kv.v_scale.shape)} must be ({b}, {hkv}, {lk})"
        )
    return b, hq, hkv, lq, lk, d


def _launch(q: torch.Tensor, kv: QuantizedKV, causal: bool, sm_scale: float, window: int | None, segs):
    """Run K4 for q's dtype and head dim (`_route`) on CUDA tensors: out."""
    b, hq, hkv, lq, lk, d = _check_kv(q, kv)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"K4 takes float32/bfloat16/float16 q, got {q.dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise NotImplementedError(f"K4 is built for head dims {SUPPORTED_HEAD_DIMS}, got {d}")
    tensors = (q, kv.k, kv.v, kv.k_scale, kv.v_scale)
    if kernel_route(*tensors) != "cuda":
        raise RuntimeError("K4 runs on CUDA tensors only; CPU tensors take the plain version")
    q, k, v = _aligned(q), _aligned(kv.k), _aligned(kv.v)
    ks = kv.k_scale.float().contiguous()
    vs = kv.v_scale.float().contiguous()
    out = torch.empty(b, lq, hq, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 14)(
        *(s for t_ in (q, k, v, out) for s in t_.stride()[:3]), *ks.stride()[:2]
    )
    key, entry = _route("flash_fwd_kv_quant", d, q.dtype)
    _call(
        entry, q.device, q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(), out.data_ptr(),
        *_ids_ptrs(segs), _DTYPE_CODES[q.dtype], QUANT_DTYPES[k.dtype], b, hq, hkv, lq, lk, d, strides,
        sm_scale * _LOG2E, int(causal), window or 0,
    )
    KERNEL_LAUNCHES[key] += 1
    return out


def flash_attention_kv_quant(
    q: torch.Tensor,
    kv: QuantizedKV,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    segment_ids=None,
    block_sizes: BlockSizes | None = None,
) -> torch.Tensor:
    """Flash attention over a quantized KV cache, forward only.

    q: [B, Hq, Lq, D] float32/bfloat16/float16; kv: QuantizedKV with
    [B, Hkv, Lkv, D] int8/fp8 payloads, Hq a multiple of Hkv (GQA).  The
    main op's feature set: causal with queries aligned to the end of KV,
    sliding window, segment ids (an int tensor [B, L] or a (q_ids, kv_ids)
    pair).  block_sizes sets the plain version's tiles only.  Returns
    [B, Hq, Lq, D] in q's dtype.  On CUDA any head dim up to 1024 runs: q
    and the payloads are zero-padded to 64, 128, 256, 512 or 1024
    (`padded_head_dim`; the scales stay as they are) and the output is
    sliced back; above 1024 the CUDA route raises NotImplementedError.
    """
    b, hq, hkv, lq, lk, d = _check_kv(q, kv)
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window) requires causal=True")
        if window >= lk:
            window = None
    segs = _segments(segment_ids, b, lq, lk, q.device) if segment_ids is not None else None
    if kernel_route(q, kv.k, kv.v, kv.k_scale, kv.v_scale) == "cuda":
        dp = padded_head_dim(d)
        if dp != d:
            q = _pad_head_dim(q, dp)
            kv = QuantizedKV(_pad_head_dim(kv.k, dp), kv.k_scale, _pad_head_dim(kv.v, dp), kv.v_scale)
            return _launch(q, kv, causal, float(sm_scale), window, segs)[..., :d]
        return _launch(q, kv, causal, float(sm_scale), window, segs)
    if lq < MIN_BLOCK // 8 or lk < MIN_BLOCK:
        # dense fallback for tiny shapes, on the plain route only
        k_d, v_d = dequantize_kv(kv, dtype=q.dtype)
        group = hq // hkv
        if group > 1:
            k_d = k_d.repeat_interleave(group, dim=1)
            v_d = v_d.repeat_interleave(group, dim=1)
        return vanilla_attention(q, k_d, v_d, causal=causal, sm_scale=sm_scale, window=window, segment_ids=segs)
    return flash_attention_kv_quant_reference(
        q, kv, causal=causal, sm_scale=sm_scale, window=window, segment_ids=segs, block_sizes=block_sizes
    )
