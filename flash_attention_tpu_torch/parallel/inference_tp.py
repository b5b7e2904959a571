"""Tensor-parallel inference: one Llama served across the `model` mesh axis.

Port of `flash_attention_tpu/parallel/inference_tp.py`: Megatron-style
column/row parameter sharding, the KV cache sharded over kv heads, and the
port's own `llama.prefill` / `llama.decode_loop` run unchanged on every
rank.  The projections sharded on their outputs run on the local heads and
hidden units; the row-parallel ones (wo, w_down) all_reduce their partial
sums; the LM head's vocabulary shards are gathered; attention is
communication-free (heads are independent), each rank over its kv heads of
the cache.

Works for fp32/bf16 and weight-only-quantized (`QuantizedLinear`) layers:
payloads and scales follow the orientation of the weight they belong to.
An int4 payload packs columns j and j + out/2 into one byte, so a shard of
its bytes is not a shard of its columns: a column-parallel int4 layer is
re-packed per shard (each rank's bytes hold its own output columns).

The cache is updated in place (the port's cache writes are), so it stays
sharded across calls: what the JAX package gets by pinning the jitted
functions' out_shardings.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from .collectives import local
from .mesh import MODEL_AXIS, axis_size, placements
from .sharding import distribute_params, shardings

# Megatron-style rules over the Llama module's linear names: column-parallel
# (output dim sharded): wq/wk/wv over heads, w_gate/w_up over the MLP hidden,
# lm_head over vocab.  Row-parallel (input dim sharded, reduced after): wo,
# w_down.  Everything else replicated (wte kept replicated so that the token
# lookup stays local).
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "lm_head"}
_ROW = {"wo", "w_down"}


def _leaf_spec(name: str, t: torch.Tensor) -> tuple:
    parts = name.split(".")
    layer = parts[-2] if len(parts) >= 2 else ""
    if layer not in _COL and layer not in _ROW:
        return ()
    col = layer in _COL
    if t.dim() == 2:
        if parts[-1] == "weight":  # nn.Linear [out, in]
            return (MODEL_AXIS, None) if col else (None, MODEL_AXIS)
        # QuantizedLinear payload, the JAX [in, out] (int4: [in, out/2])
        return (None, MODEL_AXIS) if col else (MODEL_AXIS, None)
    if t.dim() == 1:
        # per-output-channel scale/bias: follows the output dim
        return (MODEL_AXIS,) if col else ()
    return ()


def llama_param_specs(model: nn.Module) -> dict[str, tuple]:
    """The spec of every parameter and quantized payload/scale of a Llama,
    by name, in the port's layout (linear weights [out, in], quantized
    payloads [in, out] as the JAX package keeps them)."""
    named = dict(model.named_parameters())
    named.update((n, b) for n, b in model.named_buffers() if n.endswith((".values", ".scales")))
    return {name: _leaf_spec(name, t) for name, t in named.items()}


def cache_specs(cache):
    """The specs of a KVCache as a KVCache: payloads and scales shard over
    the kv-heads dim (dim 1 of [n_layer, kv_heads, slots, max_len, ...]);
    lengths replicate."""
    from ..inference.kv_cache import KVCache

    if not isinstance(cache, KVCache):
        raise TypeError(f"expected a KVCache, got {type(cache).__name__}")
    payload = (None, MODEL_AXIS)
    scale = payload if cache.quantized else None
    return KVCache(k=payload, v=payload, k_scale=scale, v_scale=scale, lengths=())


def _repack_int4_columns(packed: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """Rank `rank`'s output columns of an int4 split-halves payload [in,
    out/2], re-packed split-halves over those columns alone."""
    from ..quant.weights import _unpack_int4

    lo, hi = _unpack_int4(packed)
    cols = torch.cat([lo, hi], dim=-1).chunk(n, dim=-1)[rank]
    half = cols.shape[-1] // 2
    return (cols[:, :half] & 0x0F) | ((cols[:, half:] & 0x0F) << 4)


def shard_llama_for_inference(model: nn.Module, cache, mesh: DeviceMesh):
    """Place a Llama's parameters and a cache onto the mesh with TP
    shardings, in place: (model, cache).

    Requires kv_heads % mesh[model] == 0 (GQA groups stay whole per shard,
    so grouped attention remains communication-free).  Every rank holds the
    same global weights and cache beforehand.
    """
    from ..quant.weights import QuantizedLinear

    tp = axis_size(mesh, MODEL_AXIS)
    if cache.kv_heads % tp:
        raise ValueError(f"kv_heads {cache.kv_heads} not divisible by model axis {tp}")
    specs = llama_param_specs(model)
    rank = mesh.get_local_rank(MODEL_AXIS)
    for name, mod in model.named_modules():
        if isinstance(mod, QuantizedLinear) and mod.bits == 4 and name.split(".")[-1] in _COL:
            pl = placements(mesh, specs.pop(f"{name}.values"))
            mod._buffers["values"] = DTensor.from_local(_repack_int4_columns(mod.values, rank, tp), mesh, pl)
    distribute_params(model, shardings(mesh, specs))
    cspecs = cache_specs(cache)
    for f in dataclasses.fields(cache):
        t, spec = getattr(cache, f.name), getattr(cspecs, f.name)
        if t is not None and not isinstance(t, DTensor):
            setattr(cache, f.name, distribute_tensor(t, mesh, placements(mesh, spec), src_data_rank=None))
    return model, cache


def _local_cache(cache):
    """The rank's view of a sharded cache: its kv heads, written in place."""
    return dataclasses.replace(cache, **{f.name: local(getattr(cache, f.name)) for f in dataclasses.fields(cache)})


def tp_prefill(model, tokens, cache, slot, mesh: DeviceMesh, length=None):
    """`llama.prefill` with TP-sharded params and cache: (cache, fp32 logits
    [vocab], the same on every rank).  The cache's shards are updated in
    place, so it stays sharded across calls."""
    from ..models import llama

    _, logits = llama.prefill(model, tokens, _local_cache(cache), slot, length)
    return cache, logits


def tp_decode_loop(model, cache, first_tokens, n_steps, mesh: DeviceMesh):
    """`llama.decode_loop` with TP-sharded params and cache: each step, each
    rank computes its heads' attention and its column slices locally; the
    collectives are the row-parallel all_reduces (wo, w_down) and the
    gather of the vocabulary-sharded logits.  (cache, tokens [n_steps,
    slots])."""
    from ..models import llama

    _, toks = llama.decode_loop(model, _local_cache(cache), first_tokens, n_steps)
    return cache, toks
