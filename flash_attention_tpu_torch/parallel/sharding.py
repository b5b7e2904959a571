"""Parameter sharding rules: tensor parallelism for the GPT model.

Port of `flash_attention_tpu/parallel/sharding.py`: attention QKV/output
projections shard over heads, the MLP over its hidden dim (Megatron-style
column/row split), the embedding over the vocabulary.  A spec is JAX's
PartitionSpec as a tuple (one mesh axis name or None per tensor dim); a
sharding is a `mesh.Sharding`; a placed parameter is a DTensor, which the
model runs on its local shard with the collectives of `collectives.py`
(where XLA would insert the psum after a row-parallel matmul).

The JAX rules are written for its [in, out] weights; `nn.Linear` keeps
[out, in], so a linear weight's spec is the JAX spec reversed: P(None,
MODEL) on wqkv is ("model", None) here (Shard(0)), P(MODEL, None) on wo is
(None, "model") (Shard(1)).

The fused wqkv stacks q | k | v on its rows, so a contiguous row shard
is not a head group.  A module that declares `fused_parts` (the rows of
each part) has such a weight and bias placed part-major by shard: the
rows are permuted once, when placed, so that shard r is the r-th slice of
every part (the q, k and v rows of rank r's heads), and the layer runs
column-parallel on its local shard with no collective of its own.  The
parameter keeps that order as `row_order`: `whole` puts a gathered
parameter or gradient back into the unsharded layout.  A sharded model's
state_dict holds the placed (permuted) order, and restores into a model
placed the same way.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from .mesh import MODEL_AXIS, Sharding, placements

# The JAX package's rules, by its leaf names, in its [in, out] layout:
#   wqkv [E, (Hq+2Hkv)D] column-parallel; wo [E, E] row-parallel;
#   wfc [E, 4E] column-parallel; wproj [4E, E] row-parallel;
#   wte [V, E] vocab-sharded; biases of column-parallel layers follow their
#   outputs; everything small (layernorm, wpe) replicated.
_RULES: dict[str, tuple] = {
    "wqkv": (None, MODEL_AXIS),
    "bqkv": (MODEL_AXIS,),
    "wo": (MODEL_AXIS, None),
    "wfc": (None, MODEL_AXIS),
    "bfc": (MODEL_AXIS,),
    "wproj": (MODEL_AXIS, None),
    "wte": (MODEL_AXIS, None),
}
# The JAX bias name of each GPT linear.
_BIAS = {"wqkv": "bqkv", "wo": "bo", "wfc": "bfc", "wproj": "bproj"}


def jax_leaf_name(name: str) -> tuple[str, bool]:
    """(the JAX package's leaf name, whether the port's tensor is its
    transpose) of a GPT parameter name ("blocks.0.attn.wqkv.weight" ->
    ("wqkv", True); ".bias" -> ("bqkv", False))."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] in _BIAS:
        return (parts[-2], True) if parts[-1] == "weight" else (_BIAS[parts[-2]], False)
    return parts[-1], False


def gpt_param_specs(model: nn.Module) -> dict[str, tuple]:
    """The spec of every parameter of a GPT, by parameter name, in the
    port's layout."""
    specs = {}
    for name, _ in model.named_parameters():
        leaf, transposed = jax_leaf_name(name)
        rule = _RULES.get(leaf, ())
        specs[name] = tuple(reversed(rule)) if transposed and rule else rule
    return specs


def shardings(mesh: DeviceMesh, specs: dict[str, tuple]) -> dict[str, Sharding]:
    return {name: Sharding(mesh, placements(mesh, spec)) for name, spec in specs.items()}


def gpt_param_sharding(mesh: DeviceMesh, model: nn.Module) -> dict[str, Sharding]:
    """The sharding of every parameter of a GPT (for `Trainer`'s
    param_sharding and `distribute_params`)."""
    return shardings(mesh, gpt_param_specs(model))


def _place(t: torch.Tensor, sharding: Sharding) -> DTensor:
    # every rank holds the same global tensor (drawn from one seed, or
    # loaded from one checkpoint): each keeps its shard, nothing is sent
    return distribute_tensor(t.detach(), sharding.mesh, sharding.placements, src_data_rank=None)


def _part_major(parts: tuple[int, ...], sharding: Sharding) -> torch.Tensor | None:
    """The row order that makes each row shard of `sharding` hold its slice
    of every part (None when the rows are not sharded)."""
    n = 1
    for dim, p in enumerate(sharding.placements):
        if isinstance(p, Shard) and p.dim == 0:
            n *= sharding.mesh.size(dim)
    if n == 1:
        return None
    for s in parts:
        if s % n:
            raise ValueError(f"fused projection part of {s} rows does not split over {n} ranks")
    offsets = [sum(parts[:i]) for i in range(len(parts))]
    return torch.cat([torch.arange(off + r * s // n, off + (r + 1) * s // n)
                      for r in range(n) for off, s in zip(offsets, parts)])


def distribute_params(model: nn.Module, param_sharding: dict[str, Sharding]) -> nn.Module:
    """Replace each named parameter (or buffer) of `model` by a DTensor
    placed by its sharding, in place (a fused projection's rows part-major
    by shard, see the module docstring); returns the model."""
    for name, sharding in param_sharding.items():
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        t = getattr(owner, attr)
        if isinstance(t, DTensor):
            continue
        parts = getattr(owner, "fused_parts", None)
        order = _part_major(parts, sharding) if parts else None
        if order is not None:
            t = t[order.to(t.device)]
        if attr in owner._parameters:
            p = nn.Parameter(_place(t, sharding), requires_grad=t.requires_grad)
            if order is not None:
                p.row_order = order
            setattr(owner, attr, p)
        else:
            owner._buffers[attr] = _place(t, sharding)
    return model


def whole(param: torch.Tensor, x: torch.Tensor | None = None) -> torch.Tensor:
    """`x` (default the parameter itself; or its gradient) as one plain
    tensor in the unsharded layout: a DTensor gathered, a part-major fused
    projection's rows put back in order."""
    x = param if x is None else x
    x = x.full_tensor() if isinstance(x, DTensor) else x
    order = getattr(param, "row_order", None)
    return x if order is None else x[torch.argsort(order).to(x.device)]


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Place a GPT's parameters onto the mesh by the GPT rules."""
    return distribute_params(model, gpt_param_sharding(mesh, model))
