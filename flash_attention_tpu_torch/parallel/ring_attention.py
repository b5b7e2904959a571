"""Sequence-parallel attention: ring attention over a mesh axis.

Port of `flash_attention_tpu/parallel/ring_attention.py`.  K and V are
sequence-sharded; at each step a rank runs the flash kernel (K1 with lse)
against the KV shard it holds while `torch.distributed` P2P rotates the
shards one rank along the ring, and the partial results merge with the
kernel's own online-softmax correction (`_merge`).  The causal structure
across shards is fixed per step:

  source == self  -> diagonal shard: causal kernel
  source <  self  -> fully visible:  non-causal kernel
  source >  self  -> fully masked:   skipped

The JAX package differentiates its ring with jax.grad, which transposes
each ppermute inside one SPMD program.  Here every rank builds its own
graph, and P2P is not differentiable; under the causal mask rank 0 would
never run the backward of the rotations it made, while rank n-1 waited
for their gradients.  So the ring is one `torch.autograd.Function` with an
explicit backward ring: every rank runs the forward's rotation schedule
again, the dK/dV accumulators travelling with the KV shards, and calls the
backward kernels (pre-pass, K2, K3) on every shard it sees with the MERGED
o and lse (and no lse cotangent).  P = exp(s - lse) with the merged lse is
the full softmax, so the per-shard dQ/dK/dV are the exact blockwise
gradients, and no per-step partial is kept.

Every rank posts the same rotations in the same order, whatever it
computes at a step (skipped steps still rotate): the rotation for step
s+1 is posted before step s's kernel and waited on only before its use,
so the transfer overlaps the kernel, as the JAX body's double-buffered
carry does.  The step functions (`ring_step_calls`, `ring_fwd_step`,
`ring_bwd_step`, `merge_partials`) are rank-local: they take the KV shard a
rank holds, its source and the rank, so that the schedule can be run for
every rank of a ring in one process.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..config import kernel_route
from ..kernels.block_sizes import BlockSizes
from ..kernels.flash_attention import _blocks, _bwd, _forward, _pad_head_dim, _Spec, padded_head_dim
from .collectives import gather_from, reduce_from, scatter_to, sum_grads_over
from .mesh import MODEL_AXIS, axis_size, placements

_NEG_BIG = -1e30


def _merge(o1, lse1, o2, lse2):
    """Combine two normalized partials (o, lse) -> (o, lse), in fp32: the
    cross-shard form of the kernel's online softmax correction."""
    m = torch.maximum(lse1, lse2)
    a = torch.exp(lse1 - m)[..., None]
    b = torch.exp(lse2 - m)[..., None]
    denom = a + b
    o = (a * o1.float() + b * o2.float()) / denom
    return o, m + torch.log(denom[..., 0])


def _empty_partial(q: torch.Tensor):
    """(o, lse) of nothing seen yet: zero weight in `_merge`."""
    return torch.zeros(q.shape, dtype=torch.float32, device=q.device), torch.full(
        q.shape[:-1], _NEG_BIG, dtype=torch.float32, device=q.device
    )


def ring_step_calls(src: int, my: int, lq: int, lk: int, *, causal: bool, zigzag: bool) -> list:
    """The kernel calls of one ring step at rank `my` holding the KV shard
    of rank `src`: [(q rows, kv rows, causal)], empty for a skipped step.

    Zig-zag (causal only): rank d holds chunks (d, 2n-1-d) of 2n, and q_lo,
    q_hi / kv_lo, kv_hi are the halves of the local shards:
      src <  d: q_lo and q_hi see kv_lo fully (one call over all q rows);
      src >  d: q_hi sees the whole shard;
      src == d: q_lo/kv_lo on the diagonal, and q_hi against the whole
                shard with the causal mask aligned to the end of KV
                (Lq = L/2n < Lk = L/n).
    """
    full = slice(None)
    if not causal:
        return [(full, full, False)]
    if not zigzag:
        if src == my:
            return [(full, full, True)]
        return [(full, full, False)] if src < my else []
    lo_q, hi_q, lo_k = slice(0, lq // 2), slice(lq // 2, lq), slice(0, lk // 2)
    if src == my:
        return [(lo_q, lo_k, True), (hi_q, full, True)]
    return [(full, lo_k, False)] if src < my else [(hi_q, full, False)]


def _spec(q, k, causal, sm_scale, block_sizes) -> _Spec:
    b, hq, lq, d = q.shape
    blocks = _blocks(lq, k.shape[2], d, hq // k.shape[1], q.dtype, block_sizes, None, None)
    return _Spec(causal, float(sm_scale), None, blocks)


def ring_fwd_step(q, k, v, src: int, my: int, *, causal: bool, zigzag: bool, sm_scale: float,
                  block_sizes: BlockSizes | None = None) -> list:
    """Step (src, my) of the forward: [(q rows, o, lse)], K1 with lse (its
    plain version on the CPU) per call of `ring_step_calls`."""
    out = []
    for qr, kr, c in ring_step_calls(src, my, q.shape[2], k.shape[2], causal=causal, zigzag=zigzag):
        qs, ks, vs = q[:, :, qr], k[:, :, kr], v[:, :, kr]
        o, lse = _forward(qs, ks, vs, _spec(qs, ks, c, sm_scale, block_sizes), None, need_lse=True)
        out.append((qr, o, lse))
    return out


def ring_bwd_step(q, k, v, o, lse, do, src: int, my: int, *, causal: bool, zigzag: bool, sm_scale: float,
                  block_sizes: BlockSizes | None = None) -> list:
    """Step (src, my) of the backward: [(q rows, kv rows, dq, dk, dv)], the
    pre-pass, K2 and K3 (their plain versions on the CPU) per call, with
    the merged o and lse of the q rows and no lse cotangent."""
    out = []
    for qr, kr, c in ring_step_calls(src, my, q.shape[2], k.shape[2], causal=causal, zigzag=zigzag):
        qs, ks, vs = q[:, :, qr], k[:, :, kr], v[:, :, kr]
        dq, dk, dv = _bwd(qs, ks, vs, o[:, :, qr], lse[:, :, qr], do[:, :, qr], None,
                          _spec(qs, ks, c, sm_scale, block_sizes), None)
        out.append((qr, kr, dq, dk, dv))
    return out


def merge_partials(o_acc: torch.Tensor, lse_acc: torch.Tensor, parts: list) -> None:
    """Merge the partials of one forward step into the fp32 accumulators,
    in place, row range by row range."""
    for qr, o, lse in parts:
        o_acc[:, :, qr], lse_acc[:, :, qr] = _merge(o_acc[:, :, qr], lse_acc[:, :, qr], o, lse)


def _rotate(tensors, group, n: int, my: int):
    """Post the sends of `tensors` to the next rank of the ring and the
    receives from the previous one: (receive buffers, requests)."""
    sends = [t.contiguous() for t in tensors]
    bufs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, group=group, group_peer=(my + 1) % n) for t in sends]
    ops += [dist.P2POp(dist.irecv, b, group=group, group_peer=(my - 1) % n) for b in bufs]
    return bufs, (dist.batch_isend_irecv(ops), sends)


def _wait(pending) -> None:
    for req in pending[0]:
        req.wait()


class _Ring(torch.autograd.Function):
    """Ring attention of the local shards, with the explicit backward ring."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, zigzag, sm_scale, block_sizes):
        n, my = dist.get_world_size(group), dist.get_rank(group)
        kw = dict(causal=causal, zigzag=zigzag, sm_scale=sm_scale, block_sizes=block_sizes)
        o_acc, lse_acc = _empty_partial(q)
        kb, vb = k, v
        for step in range(n):
            if step < n - 1:
                (kn, vn), pending = _rotate((kb, vb), group, n, my)
            merge_partials(o_acc, lse_acc, ring_fwd_step(q, kb, vb, (my - step) % n, my, **kw))
            if step < n - 1:
                _wait(pending)
                kb, vb = kn, vn
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse_acc)
        ctx.ring = (group, n, my, kw)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, n, my, kw = ctx.ring
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        acc = None  # the dK/dV accumulators on their way round
        for step in range(n):
            if step < n - 1:
                (kn, vn), kv_pending = _rotate((kb, vb), group, n, my)
            grads = ring_bwd_step(q, kb, vb, o, lse, do, (my - step) % n, my, **kw)
            if acc is None:
                dk_in = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
                dv_in = torch.zeros_like(dk_in)
            else:
                _wait(acc_pending)
                dk_in, dv_in = acc
            for qr, kr, gq, gk, gv in grads:
                dq[:, :, qr] += gq.float()
                dk_in[:, :, kr] += gk.float()
                dv_in[:, :, kr] += gv.float()
            if n > 1:
                # on to the next rank; after the last step it reaches the
                # shard's owner
                acc, acc_pending = _rotate((dk_in, dv_in), group, n, my)
            else:
                acc = (dk_in, dv_in)
            if step < n - 1:
                _wait(kv_pending)
                kb, vb = kn, vn
        if n > 1:
            _wait(acc_pending)
        dk, dv = acc
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def _check_group(group, *tensors) -> None:
    """A CUDA tensor needs an NCCL group and a CPU tensor a gloo one:
    nothing is staged through the host."""
    backend = dist.get_backend(group)
    route = kernel_route(*tensors)
    if route == "cuda" and backend != "nccl":
        raise ValueError(f"ring attention of CUDA tensors needs an NCCL process group, this one is {backend}")
    if route == "plain" and "gloo" not in backend:
        raise ValueError(f"ring attention of CPU tensors needs a gloo process group, this one is {backend}")


def ring_attention_local(q, k, v, group, *, causal: bool = True, zigzag: bool = False,
                         sm_scale: float | None = None, block_sizes: BlockSizes | None = None) -> torch.Tensor:
    """Ring attention of this rank's shards q [B, Hq, L/n, D], k/v [B, Hkv,
    L/n, D] over process group `group` (in zig-zag chunk order when
    zigzag); differentiable in q, k and v.  Head dims the kernels are not
    built for are zero-padded on CUDA, as `flash_attention` pads."""
    _check_group(group, q, k, v)
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    dp = padded_head_dim(d)
    if dp != d and kernel_route(q, k, v) == "cuda":
        q, k, v = (_pad_head_dim(x, dp) for x in (q, k, v))
        return _Ring.apply(q, k, v, group, causal, zigzag, float(sm_scale), block_sizes)[..., :d]
    return _Ring.apply(q, k, v, group, causal, zigzag, float(sm_scale), block_sizes)


def zigzag_indices(l: int, n: int) -> torch.Tensor:
    """Global gather indices putting a length-l sequence into zig-zag
    order for n ranks: rank d's shard = chunks (d, 2n-1-d) of size l/(2n).
    Apply before sharding; invert with `zigzag_inverse`."""
    chunk = l // (2 * n)
    order = []
    for d in range(n):
        order.extend(range(d * chunk, (d + 1) * chunk))
        j = 2 * n - 1 - d
        order.extend(range(j * chunk, (j + 1) * chunk))
    return torch.tensor(order, dtype=torch.int64)


def zigzag_inverse(l: int, n: int) -> torch.Tensor:
    inv = torch.empty(l, dtype=torch.int64)
    inv[zigzag_indices(l, n)] = torch.arange(l)
    return inv


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This rank's part of a global batch [B, T] under context parallelism:
    rows over `batch_axis` (when set) and tokens over `axis`, contiguous or
    in zig-zag chunk order.  The models take their tokens, positions and
    targets through it, attend through the ring, and sum the loss over its
    groups."""

    mesh: DeviceMesh
    axis: str
    batch_axis: str | None
    zigzag: bool
    rows: slice
    positions: torch.Tensor  # global positions of the local tokens, in order
    b: int
    t: int

    @classmethod
    def of(cls, mesh: DeviceMesh, axis: str, batch_axis: str | None, zigzag: bool, b: int, t: int, device):
        n = axis_size(mesh, axis)
        n_div = n * (2 if zigzag else 1)
        if t % n_div:
            raise ValueError(
                f"context-parallel forward needs T % {n_div} == 0 (T={t}, seq axis {n}"
                f"{', zigzag doubles the chunking' if zigzag else ''}); for incremental decoding use a cfg "
                "without seq_mesh"
            )
        rows = slice(None)
        if batch_axis is not None:
            nb = axis_size(mesh, batch_axis)
            if b % nb:
                raise ValueError(f"batch {b} not divisible by the {batch_axis} axis ({nb})")
            r = mesh.get_local_rank(batch_axis)
            rows = slice(r * b // nb, (r + 1) * b // nb)
        order = zigzag_indices(t, n) if zigzag else torch.arange(t)
        r = mesh.get_local_rank(axis)
        return cls(mesh, axis, batch_axis, zigzag, rows, order[r * t // n:(r + 1) * t // n].to(device), b, t)

    def groups(self) -> list:
        axes = [self.axis] + ([self.batch_axis] if self.batch_axis is not None else [])
        return [self.mesh.get_group(a) for a in axes]

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """The local rows and tokens of a global [B, T, ...] tensor."""
        return x[self.rows].index_select(1, self.positions)

    def attend(self, q, k, v) -> torch.Tensor:
        """Causal ring attention of the local q/k/v [B, H, T/n, D]."""
        return ring_attention_local(q, k, v, self.mesh.get_group(self.axis), causal=True, zigzag=self.zigzag)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The global [B, T, ...] tensor, in natural token order, of every
        rank's local y [B_local, T/n, ...] (differentiable)."""
        y = gather_from(y, self.mesh.get_group(self.axis), 1)
        if self.batch_axis is not None:
            y = gather_from(y, self.mesh.get_group(self.batch_axis), 0)
        if self.zigzag:
            y = y.index_select(1, zigzag_inverse(self.t, axis_size(self.mesh, self.axis)).to(y.device))
        return y

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over every rank of the batch's groups (differentiable:
        each rank's gradient flows to its own terms)."""
        for group in self.groups():
            x = reduce_from(x, group)
        return x


def seq_shard(model, idx: torch.Tensor) -> SeqShard | None:
    """This rank's SeqShard of the global batch idx [B, T] under
    model.cfg.seq_mesh, else None.  Also hooks the model's parameters so
    that their gradients are summed over the shard's ranks."""
    cfg = model.cfg
    if cfg.seq_mesh is None:
        return None
    shard = SeqShard.of(cfg.seq_mesh, cfg.seq_axis, cfg.seq_batch_axis, cfg.seq_zigzag, *idx.shape, idx.device)
    sum_grads_over(model, shard.groups())
    return shard


def _shard_dims(mesh: DeviceMesh, spec: tuple):
    """(group, tensor dim) of each mesh axis named in `spec`, batch first."""
    return [(mesh.get_group(a), i) for i, a in enumerate(spec) if a is not None]


def _to_local(xs, mesh: DeviceMesh, spec: tuple):
    """Local shards of q/k/v: a DTensor is redistributed to `spec`; a plain
    tensor is the global array, the same on every rank, and each rank
    takes its part (its gradient gathered whole)."""
    out = []
    for x in xs:
        if isinstance(x, DTensor):
            out.append(x.redistribute(mesh, placements(mesh, spec)).to_local())
            continue
        for group, dim in _shard_dims(mesh, spec):
            x = scatter_to(x, group, dim)
        out.append(x)
    return out


def _from_local(y, like, mesh: DeviceMesh, spec: tuple):
    """The output laid out as the input `like` was (the inverse of `_to_local`)."""
    if isinstance(like, DTensor):
        return DTensor.from_local(y, mesh, placements(mesh, spec)).redistribute(mesh, like.placements)
    for group, dim in reversed(_shard_dims(mesh, spec)):
        y = gather_from(y, group, dim)
    return y


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    *,
    axis_name: str = "seq",
    causal: bool = True,
    sm_scale: float | None = None,
    block_sizes: BlockSizes | None = None,
    zigzag: bool = False,
    batch_axis: str | None = None,
    preordered: bool = False,
) -> torch.Tensor:
    """Sequence-sharded attention over `mesh[axis_name]`.

    q [B, Hq, L, D], k/v [B, Hkv, L, D] with L divisible by the axis size:
    DTensors on `mesh` (redistributed to L sharded over `axis_name`, and B
    over `batch_axis` when given; the output comes back in q's placements),
    or plain tensors holding the global arrays on every rank (the output is
    then the global array on every rank).  Differentiable: the explicit
    backward ring (`_Ring`).  The KV rotation for step s+1 is posted before
    step s's kernel.

    zigzag=True (causal only) uses striped sharding for load balance: the
    sequence is re-ordered into zig-zag chunk order (rank d holds chunks
    (d, 2n-1-d) of 2n), every rank then does the same causal work per ring
    step, and the output is restored to natural order.  Requires L
    divisible by 2n.  preordered=True (with zigzag): the inputs are already
    in zig-zag order and the output is returned in that order.

    batch_axis: mesh axis the batch dim is sharded over (dp x cp training).
    """
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    n = axis_size(mesh, axis_name)
    group = mesh.get_group(axis_name)
    _check_group(group, *(x.to_local() if isinstance(x, DTensor) else x for x in (q, k, v)))
    spec = (batch_axis, None, axis_name, None)
    reorder = zigzag and not preordered
    if zigzag:
        if not causal:
            raise ValueError("zigzag sharding only applies to causal")
        if q.shape[2] % (2 * n):
            raise ValueError(f"zigzag needs L % (2*n) == 0 (L={q.shape[2]}, n={n})")
    like = q
    if reorder:
        # the reorder needs the whole sequence: DTensors are gathered first
        l = q.shape[2]
        q, k, v = (x.full_tensor() if isinstance(x, DTensor) else x for x in (q, k, v))
        idx = zigzag_indices(l, n).to(q.device)
        q, k, v = (x.index_select(2, idx) for x in (q, k, v))
    ql, kl, vl = _to_local((q, k, v), mesh, spec)
    out = ring_attention_local(ql, kl, vl, group, causal=causal, zigzag=zigzag, sm_scale=sm_scale,
                               block_sizes=block_sizes)
    if not reorder:
        return _from_local(out, like, mesh, spec)
    out = _from_local(out, q, mesh, spec).index_select(2, zigzag_inverse(l, n).to(out.device))
    if isinstance(like, DTensor):
        return DTensor.from_local(out, mesh, placements(mesh, ())).redistribute(mesh, like.placements)
    return out


def head_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    *,
    axis_name: str = MODEL_AXIS,
    causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Head-sharded attention: no communication during attention.

    KV heads shard with their GQA q-head groups co-located (both split
    into contiguous blocks over `axis_name`).  Inputs and output as in
    `ring_attention` (DTensors, or the global arrays on every rank); the
    flash kernels run on the local heads.  Differentiable."""
    from ..kernels.flash_attention import flash_attention

    tp = axis_size(mesh, axis_name)
    hkv = k.shape[1]
    if hkv % tp:
        raise ValueError(f"kv heads {hkv} not divisible by the {axis_name} axis ({tp})")
    spec = (None, axis_name, None, None)
    ql, kl, vl = _to_local((q, k, v), mesh, spec)
    out = flash_attention(ql, kl, vl, causal=causal, sm_scale=sm_scale)
    return _from_local(out, q, mesh, spec)
