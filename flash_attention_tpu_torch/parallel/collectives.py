"""Differentiable collectives and the tensor-parallel layers built on them.

GSPMD derives the collectives of a sharded JAX program from the
shardings of its inputs.  In PyTorch each rank runs its own program on
its local shards, so the models call these functions where the JAX
package's partitioner would have inserted a collective (Megatron-LM's
f / g pair):

* `copy_to(x, group)`: identity forward, all_reduce of the gradient
  backward, at the input of a column-parallel layer, whose input is
  replicated over the group while each rank's gradient covers its columns.
* `reduce_from(x, group)`: all_reduce forward, identity backward, at the
  output of a row-parallel layer (partial sums) and of the sharded loss.
* `gather_from(x, group, dim)`: all_gather forward, this rank's slice of
  the gradient backward, where a sharded result is needed whole (the
  vocabulary-sharded logits; the sequence-sharded logits of `forward`).

A parameter placed by `sharding.distribute_params` is a DTensor: the
models take its local shard with `local` and read how it is sharded over
the model axis with `tp_info`.  Attention never sees a DTensor: it runs
on the local heads.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from .mesh import MODEL_AXIS


def local(p: torch.Tensor | None) -> torch.Tensor | None:
    """The local shard of a DTensor (differentiable), else p itself."""
    return p.to_local() if isinstance(p, DTensor) else p


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.rank, ctx.n = group, dim, dist.get_rank(group), n
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, dist.get_world_size(group)
        return x.chunk(ctx.n, dim=dim)[dist.get_rank(group)]

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g, memory_format=torch.contiguous_format) for _ in range(ctx.n)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=ctx.dim), None, None


def scatter_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of `x` (replicated over the group) along `dim`;
    backward, the chunks' gradients gathered whole on every rank (the
    inverse of `gather_from`)."""
    return _ScatterTo.apply(x, group, dim % x.dim())


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, group, dim % x.dim())


def tp_info(p) -> tuple | None:
    """(group, rank, size, sharded dim) of a DTensor sharded over the model
    axis, else None (a plain tensor, or replicated over that axis)."""
    if not isinstance(p, DTensor) or MODEL_AXIS not in (p.device_mesh.mesh_dim_names or ()):
        return None
    mesh = p.device_mesh
    place = p.placements[mesh.mesh_dim_names.index(MODEL_AXIS)]
    if not isinstance(place, Shard):
        return None
    return mesh.get_group(MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS), mesh.size(
        mesh.mesh_dim_names.index(MODEL_AXIS)), place.dim


def tp_linear(x: torch.Tensor, weight, bias, matmul, out_dim: int = 0) -> torch.Tensor:
    """A linear layer whose weight may be sharded over the model axis:
    `matmul(x, bias or None)` computes the local product with the local
    weight.  A weight sharded on its output dim (`out_dim`: 0 for
    nn.Linear's [out, in], 1 for a quantized [in, out] payload) is
    column-parallel: replicated input through `copy_to`, local outputs,
    local bias.  Sharded on its input dim it is row-parallel: partial sums
    through `reduce_from`, then the replicated bias.  Unsharded, the plain
    product."""
    info = tp_info(weight)
    b = local(bias)
    if info is None:
        return matmul(x, b)
    group, _, _, dim = info
    if dim == out_dim:
        return matmul(copy_to(x, group), b)
    y = reduce_from(matmul(x, None), group)
    return y if b is None else y + b.to(y.dtype)


def tp_embedding(idx: torch.Tensor, weight) -> torch.Tensor:
    """Rows `idx` of an embedding table sharded over the vocabulary on the
    model axis: each rank looks up the ids in its rows, zeros elsewhere,
    and the shards are summed (exact: one non-zero term per id)."""
    group, rank, _, _ = tp_info(weight)
    w = local(weight)
    lo = rank * w.shape[0]
    ids = idx.long() - lo
    mine = (ids >= 0) & (ids < w.shape[0])
    rows = w[ids.clamp(0, w.shape[0] - 1)] * mine[..., None].to(w.dtype)
    return reduce_from(rows, group)


def sum_grads_over(module: torch.nn.Module, groups, scale: float = 1.0) -> None:
    """Register a hook on every parameter of `module` that all_reduces its
    incoming gradient over each process group of `groups` (the data and
    sequence axes a batch is split over) and multiplies it by `scale`:
    each rank's backward covers its own rows and tokens, and the sum is the
    gradient of the whole batch (a context-parallel loss is already the
    batch's mean; a data-parallel rank's loss is its rows' mean, so the
    trainer passes 1 / ranks).  The hook sees each backward's gradient
    before it is accumulated into .grad, so gradient accumulation stays
    exact.  Parameters that already have the hook are skipped, so the
    models call this at every sharded forward (and so cover parameters
    that `distribute_params` replaced)."""
    groups = [g for g in groups if g is not None and dist.get_world_size(g) > 1]
    if not groups:
        return

    def hook(grad):
        is_dt = isinstance(grad, DTensor)
        g = (grad.to_local() if is_dt else grad).clone()
        for group in groups:
            dist.all_reduce(g, group=group)
        if scale != 1.0:
            g.mul_(scale)
        return DTensor.from_local(g, grad.device_mesh, grad.placements, shape=grad.shape,
                                  stride=grad.stride()) if is_dt else g

    for p in module.parameters():
        if p.requires_grad and not getattr(p, "_fa_sums_grads", False):
            p.register_hook(hook)
            p._fa_sums_grads = True
