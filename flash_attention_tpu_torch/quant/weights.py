"""Weight-only quantization: INT8 and packed INT4 linear layers.

Port of `flash_attention_tpu/quant/weights.py`.  Symmetric per-output-
channel scales; the weights are dequantized at matmul time in the
activation dtype.  The JAX package reaches no Pallas kernel here (it leaves
the dequantize-and-multiply to XLA), so neither does the port: the products
are plain `torch.matmul`.

`QuantizedTensor` keeps the JAX package's [in, out] layout and its int4
packing bit for bit (split halves: byte j holds column j in its low nibble
and column j + out/2 in its high nibble), so params that the JAX package
quantized load unchanged.  The port's models hold `Linear` modules where
the JAX package held weight arrays, so `quantize_params` replaces the named
linears of a module by `QuantizedLinear`s, in place; embeddings and norms
stay as they are.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.distributed.tensor import DTensor

__all__ = [
    "INT4_LAYOUT",
    "QuantizedLinear",
    "QuantizedTensor",
    "dequantize",
    "gpt_forward_quantized",
    "quantize_gpt_params",
    "quantize_int4",
    "quantize_int8",
    "quantize_llama_params",
    "quantize_params",
    "quantized_matmul",
]

# int4 packing layout identifier, carried by every QuantizedTensor so that
# weights packed in the JAX package's old adjacent-column layout fail loudly
# instead of dequantizing to column-permuted values.
INT4_LAYOUT = "int4-split-halves-v2"


@dataclasses.dataclass
class QuantizedTensor:
    """int8 (or nibble-packed int4) payload + per-channel fp32 scales."""

    values: torch.Tensor  # int8 [in, out] (int4: [in, out / 2] packed)
    scales: torch.Tensor  # fp32 [out]
    bits: int  # 8 or 4
    out_features: int
    layout: str = INT4_LAYOUT  # int4 packing format version


def _check_int4_layout(qt: QuantizedTensor) -> None:
    layout = getattr(qt, "layout", "int4-adjacent-v1")
    if layout != INT4_LAYOUT:
        raise ValueError(
            f"QuantizedTensor has int4 layout {layout!r} but this build unpacks {INT4_LAYOUT!r} (split-halves: "
            "byte j = columns j and j + out/2).  Re-quantize from the original weights with quantize_int4: "
            "dequantizing the old adjacent-column layout here would silently permute columns."
        )


def quantize_int8(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric per-output-channel int8 of w [in, out]: w ~= values * scales."""
    w32 = w.float()
    amax = w32.abs().amax(dim=0)
    scales = torch.where(amax == 0, 1.0, amax / 127.0)
    values = torch.clamp(torch.round(w32 / scales), -127, 127).to(torch.int8)
    return QuantizedTensor(values, scales, 8, w.shape[-1])


def quantize_int4(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric per-output-channel int4 of w [in, out], two values per
    int8 byte in the split-halves packing: byte j holds column j in its low
    nibble and column j + out/2 in its high nibble.  `(q & 0x0F) << 4`
    wraps in int8, as it does in JAX."""
    w32 = w.float()
    out = w.shape[-1]
    if out % 2:
        raise ValueError("int4 packing requires an even out dim")
    amax = w32.abs().amax(dim=0)
    scales = torch.where(amax == 0, 1.0, amax / 7.0)
    q = torch.clamp(torch.round(w32 / scales), -8, 7).to(torch.int8)
    half = out // 2
    lo = q[:, :half] & 0x0F
    hi = (q[:, half:] & 0x0F) << 4
    return QuantizedTensor(lo | hi, scales, 4, out)


def _unpack_int4(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cols [0, out/2), cols [out/2, out)) as int8 from split-halves bytes;
    `>>` on int8 is arithmetic, and the mask drops the sign bits it brings."""
    lo = ((packed & 0x0F) ^ 0x08).to(torch.int8) - 8
    hi = (((packed >> 4) & 0x0F) ^ 0x08).to(torch.int8) - 8
    return lo, hi


def dequantize(qt: QuantizedTensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The [in, out] weights in `dtype`: values * scales in fp32, then cast."""
    if qt.bits == 8:
        w = qt.values.float()
    elif qt.bits == 4:
        _check_int4_layout(qt)
        lo, hi = _unpack_int4(qt.values)
        w = torch.cat([lo, hi], dim=-1).float()
    else:
        raise ValueError(f"unsupported bits {qt.bits}")
    return (w * qt.scales).to(dtype)


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor, *, bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ dequant(w) (+ bias).  The two widths round differently, as in the
    JAX package: int4 runs two half-width matmuls (one per nibble half) on
    the integer values cast to x's dtype, each times its scales cast to x's
    dtype; int8 dequantizes in fp32, casts to x's dtype, then multiplies."""
    if qt.bits == 4:
        _check_int4_layout(qt)
        half = qt.out_features // 2
        lo, hi = _unpack_int4(qt.values)
        sc = qt.scales.to(x.dtype)
        y = torch.cat([(x @ lo.to(x.dtype)) * sc[:half], (x @ hi.to(x.dtype)) * sc[half:]], dim=-1)
    else:
        y = x @ dequantize(qt, dtype=x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


class QuantizedLinear(nn.Module):
    """A linear layer whose weight is a QuantizedTensor (buffers `values`
    and `scales`, so that `.to(device)` moves them) and an optional bias:
    y = quantized_matmul(x, qt, bias=bias)."""

    def __init__(self, qt: QuantizedTensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("values", qt.values)
        self.register_buffer("scales", qt.scales.float())
        self.bits, self.out_features, self.layout = qt.bits, qt.out_features, qt.layout
        self.bias = None if bias is None else nn.Parameter(bias.detach(), requires_grad=False)

    @property
    def qt(self) -> QuantizedTensor:
        return QuantizedTensor(self.values, self.scales, self.bits, self.out_features, self.layout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.values, DTensor):
            return self._tp_forward(x)
        return quantized_matmul(x, self.qt, bias=self.bias)

    def _tp_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The layer with its payload sharded over the model axis
        (`parallel.shard_llama_for_inference`): on the output columns
        (column-parallel: each rank's outputs, from its own int4 packing of
        them) or on the input rows (row-parallel)."""
        from ..parallel.collectives import local, tp_linear

        scales = local(self.scales)
        qt = QuantizedTensor(local(self.values), scales, self.bits, scales.shape[0], self.layout)
        return tp_linear(x, self.values, self.bias, lambda x, b: quantized_matmul(x, qt, bias=b), out_dim=1)

    def extra_repr(self) -> str:
        return f"bits={self.bits}, out_features={self.out_features}"


_QUANT_KEYS = ("wqkv", "wo", "wfc", "wproj")
# Llama projection names (models/llama.py)
_LLAMA_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def quantize_params(model: nn.Module, keys: tuple[str, ...], *, bits: int = 8) -> nn.Module:
    """Replace every linear of `model` whose attribute name is in `keys` by
    a QuantizedLinear of its weight (weight-only; in place, module by
    module, so that the full-precision weights are freed as it goes).
    Embeddings, norms and biases stay as they are.  Returns the model."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    quantize = quantize_int8 if bits == 8 else quantize_int4
    targets = [
        (parent, name)
        for parent in model.modules()
        for name, child in parent.named_children()
        if name in keys and isinstance(child, nn.Linear)
    ]
    for parent, name in targets:
        lin = getattr(parent, name)
        with torch.no_grad():
            qt = quantize(lin.weight.detach().t())  # nn.Linear keeps [out, in]; the JAX layout is [in, out]
        setattr(parent, name, QuantizedLinear(qt, lin.bias))
    return model


def quantize_gpt_params(model: nn.Module, *, bits: int = 8) -> nn.Module:
    return quantize_params(model, _QUANT_KEYS, bits=bits)


def quantize_llama_params(model: nn.Module, *, bits: int = 8) -> nn.Module:
    return quantize_params(model, _LLAMA_QUANT_KEYS, bits=bits)


def gpt_forward_quantized(model: nn.Module, idx: torch.Tensor, **kwargs) -> torch.Tensor:
    """The GPT forward on dequantized weights, as the JAX function
    materialises the dequantized params (the memory win is in storage,
    compute is unchanged): for this call only, each QuantizedLinear is
    swapped for a dense `Linear` of its weight dequantized to the config's
    dtype; the model gets its QuantizedLinears back before this returns."""
    from ..models.gpt import Linear

    swaps = [
        (parent, name, child)
        for parent in model.modules()
        for name, child in parent.named_children()
        if isinstance(child, QuantizedLinear)
    ]
    try:
        for parent, name, q in swaps:
            w = dequantize(q.qt, dtype=model.cfg.dtype).t()
            dense = Linear(w.shape[1], w.shape[0], bias=q.bias is not None, device="meta")
            dense.weight = nn.Parameter(w, requires_grad=False)
            dense.bias = q.bias
            setattr(parent, name, dense)
        return model(idx, **kwargs)
    finally:
        for parent, name, q in swaps:
            setattr(parent, name, q)


def quantized_tensor_from(leaf) -> QuantizedTensor:
    """A QuantizedTensor from any object with the JAX QuantizedTensor's
    fields (`values`, `scales` as arrays, `bits`, `out_features`,
    `layout`), e.g. the JAX package's with numpy leaves."""
    import numpy as np

    def tensor(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))

    return QuantizedTensor(
        tensor(leaf.values).to(torch.int8), tensor(leaf.scales).float(), int(leaf.bits), int(leaf.out_features),
        getattr(leaf, "layout", "int4-adjacent-v1"),
    )


def is_quantized_leaf(leaf) -> bool:
    return all(hasattr(leaf, f) for f in ("values", "scales", "bits", "out_features"))
