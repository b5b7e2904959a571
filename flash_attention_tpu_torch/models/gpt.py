"""GPT-2-class causal transformer as a PyTorch module.

Port of `flash_attention_tpu/models/gpt.py`: the forward with dropout and
per-block rematerialisation, `loss_fn` and `generate`.  The parameter names
follow the JAX params pytree (`blocks[i].attn.wqkv`, ...), so that
`params_from_jax` is a rename and a transpose and `grads_to_jax_layout`
its inverse.

Storage dtypes (`param_dtype`): the JAX package keeps every parameter in
fp32 and casts the matmul weights to the compute dtype at each use, which
is what training needs (fp32 master weights under AdamW):
`GPT(cfg, param_dtype=torch.float32)` does the same.  By default the matmul
weights and biases are stored in the compute dtype (`cfg.dtype`) once,
which gives the same products without re-casting 124M weights on every
decode step: the serving engine's storage.  The LayerNorm parameters and
both embedding tables are fp32 either way, as the JAX forward uses them in
fp32.

Dropout draws its masks from a `torch.Generator` seeded from (the step's
seed, the site) inside each block, so a block that
`torch.utils.checkpoint` recomputes draws the same masks again.

Sharded runs (`parallel/`).  With `cfg.seq_mesh` (context parallelism)
every rank is handed the global batch, keeps its rows and tokens
(`parallel.ring_attention.SeqShard`: tokens contiguous or in zig-zag
order, positions with them), attends through the ring, and sums the loss
over the mesh; a hook on each parameter sums its gradient over the same
ranks, so `loss_fn(...).backward()` leaves the whole batch's gradients on
every rank, as jax.grad of the sharded JAX loss does.  `forward` gathers
the logits back into natural order.  Parameters placed by
`parallel.shard_params` are DTensors: each layer runs on its local shard
with the collectives of `parallel.collectives` (Megatron column/row
linears, a vocabulary-sharded embedding, the tied head's logits gathered
over the model axis), and attention on the local heads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..config import resolve_device
from ..kernels.flash_attention import flash_attention
from ..kernels.vanilla import vanilla_attention
from ..parallel.collectives import copy_to, gather_from, local, tp_embedding, tp_info, tp_linear
from ..parallel.ring_attention import seq_shard
from ..parallel.sharding import whole


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """nanoGPT-compatible configuration, as in the JAX package."""

    vocab_size: int = 50304
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    n_kv_head: int | None = None  # GQA: None means MHA
    dropout: float = 0.0
    bias: bool = True
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    use_flash: bool = True  # False = dense attention
    remat: bool = False  # recompute each block in the backward pass
    fast_ln: bool = True  # LayerNorm variance as E[x^2] - mu^2
    # Context parallelism: a DeviceMesh with `seq_axis` among its axes
    # routes every attention through ring attention; seq_batch_axis: the
    # mesh axis the batch rows are split over (dp x cp); seq_zigzag: causal
    # load balancing, tokens taken in zig-zag chunk order once at the
    # embedding (parallel/ring_attention.py).
    seq_mesh: Any = None
    seq_axis: str = "seq"
    seq_batch_axis: str | None = None
    seq_zigzag: bool = False

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head


SHAKESPEARE_CHAR = GPTConfig(
    vocab_size=65, block_size=256, n_layer=6, n_head=6, n_embd=384, dropout=0.2
)
GPT2_124M = GPTConfig()


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5, fast: bool = True):
    """LayerNorm in fp32, cast back to x's dtype.  fast=True takes the
    variance as E[x^2] - mu^2 clamped at 0 (one reduction pass), as the
    JAX package does."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    if fast:
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    else:
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g + b).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, n: int, fast: bool, device):
        super().__init__()
        self.g = nn.Parameter(torch.ones(n, device=device))
        self.b = nn.Parameter(torch.zeros(n, device=device))
        self.fast = fast

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, local(self.g), local(self.b), fast=self.fast)


def _dropout(x: torch.Tensor, rate: float, seed: int | None, shard=None) -> torch.Tensor:
    """Inverted dropout (JAX `_dropout`): keep with probability 1 - rate
    and scale kept values by 1 / (1 - rate); identity when seed is None.
    The mask comes from a generator seeded here, on x's device; under
    context parallelism (`shard`) it is drawn for the global batch and
    this rank keeps its part, so the masks are the unsharded run's."""
    if seed is None or rate == 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    shape = x.shape if shard is None else (shard.b, shard.t, *x.shape[2:])
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - rate
    if shard is not None:
        keep = shard.take(keep)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _site_seed(rng: int, site: int) -> int:
    """Seed of one dropout site (0: embedding, 1 + 2l / 2 + 2l: layer l's
    attention / MLP output) for the step seed `rng`."""
    return int(np.random.SeedSequence([rng, site]).generate_state(1, np.uint64)[0] >> 1)


class Linear(nn.Linear):
    """nn.Linear whose weight and bias are cast to the input's dtype at
    each use (no-ops when stored in it), as the JAX forward casts its fp32
    params."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.weight, DTensor):
            w = local(self.weight).to(x.dtype)
            return tp_linear(x, self.weight, self.bias, lambda x, b: F.linear(x, w, None if b is None else b.to(x.dtype)))
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(x, self.weight.to(x.dtype), bias)


def _linear(n_in: int, n_out: int, bias: bool, std: float, dtype: torch.dtype, gen, device) -> Linear:
    """Linear stored in `dtype` with N(0, std) weights drawn from `gen` on
    its own device (a CPU generator gives the same weights on every
    device)."""
    lin = Linear(n_in, n_out, bias=bias, device="meta")
    w = torch.randn(n_out, n_in, generator=gen, device=gen.device) * std
    lin.weight = nn.Parameter(w.to(device=device, dtype=dtype))
    if bias:
        lin.bias = nn.Parameter(torch.zeros(n_out, device=device, dtype=dtype))
    return lin


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, gen, device, dtype: torch.dtype | None = None):
        super().__init__()
        dtype = dtype or cfg.dtype
        self.cfg = cfg
        d = cfg.head_dim
        proj_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        self.wqkv = _linear(cfg.n_embd, (cfg.n_head + 2 * cfg.kv_heads) * d, cfg.bias, 0.02, dtype, gen, device)
        # q | k | v rows: tensor parallelism places them part-major by shard
        # (parallel/sharding.py), so a row shard is a head group
        self.wqkv.fused_parts = (cfg.n_head * d, cfg.kv_heads * d, cfg.kv_heads * d)
        self.wo = _linear(cfg.n_embd, cfg.n_embd, cfg.bias, proj_std, dtype, gen, device)

    def split_heads(self, x: torch.Tensor):
        """x [B, T, E] -> q [B, H, T, D], k/v [B, Hkv, T, D] (views of one
        fused projection).  With wqkv sharded over the model axis (rows
        part-major by shard), the local heads: H / tp and Hkv / tp."""
        cfg = self.cfg
        bsz, t, _ = x.shape
        d, h, hkv = cfg.head_dim, cfg.n_head, cfg.kv_heads
        qkv = self.wqkv(x)
        info = tp_info(getattr(self.wqkv, "weight", None))  # a QuantizedLinear has no .weight
        if info is not None:
            h, hkv = h // info[2], hkv // info[2]
        q, k, v = qkv.split([h * d, hkv * d, hkv * d], dim=-1)
        return (
            q.view(bsz, t, h, d).transpose(1, 2),
            k.view(bsz, t, hkv, d).transpose(1, 2),
            v.view(bsz, t, hkv, d).transpose(1, 2),
        )

    def merge_heads(self, y: torch.Tensor) -> torch.Tensor:
        """y [B, H, T, D] -> output projection of [B, T, H*D]."""
        bsz, h, t, d = y.shape
        return self.wo(y.transpose(1, 2).reshape(bsz, t, h * d))

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """shard: this rank's SeqShard under context parallelism (ring
        attention), else None."""
        cfg = self.cfg
        q, k, v = self.split_heads(x)
        if shard is not None:
            y = shard.attend(q, k, v)
        elif cfg.use_flash:
            y = flash_attention(q, k, v, causal=True)
        else:
            group = cfg.n_head // cfg.kv_heads
            if group > 1:
                k = k.repeat_interleave(group, dim=1)
                v = v.repeat_interleave(group, dim=1)
            y = vanilla_attention(q, k, v, causal=True, sm_scale=cfg.head_dim ** -0.5)
        return self.merge_heads(y)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, gen, device, dtype: torch.dtype | None = None):
        super().__init__()
        dtype = dtype or cfg.dtype
        proj_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        self.wfc = _linear(cfg.n_embd, 4 * cfg.n_embd, cfg.bias, 0.02, dtype, gen, device)
        self.wproj = _linear(4 * cfg.n_embd, cfg.n_embd, cfg.bias, proj_std, dtype, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu defaults to the tanh approximation; F.gelu does not.
        return self.wproj(F.gelu(self.wfc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, gen, device, dtype: torch.dtype | None = None):
        super().__init__()
        self.rate = cfg.dropout
        self.ln1 = LayerNorm(cfg.n_embd, cfg.fast_ln, device)
        self.attn = Attention(cfg, gen, device, dtype)
        self.ln2 = LayerNorm(cfg.n_embd, cfg.fast_ln, device)
        self.mlp = MLP(cfg, gen, device, dtype)

    def forward(self, x: torch.Tensor, seeds: tuple[int | None, int | None] = (None, None), shard=None) -> torch.Tensor:
        """seeds: the dropout seeds of the attention and MLP outputs;
        shard: as in `Attention.forward`."""
        x = x + _dropout(self.attn(self.ln1(x), shard), self.rate, seeds[0], shard)
        return x + _dropout(self.mlp(self.ln2(x)), self.rate, seeds[1], shard)


class GPT(nn.Module):
    """GPT-2 with GPT-2 init: N(0, 0.02), residual projections scaled by
    1/sqrt(2 n_layer), zero biases; the LM head is tied to `wte`.

    generator: the torch.Generator all weights are drawn from, on its own
    device (a CPU one gives the same weights on every device; a CUDA one
    draws a large model on the card); default a fresh CPU one seeded 0.  device: where the weights live, default
    the card ("cuda", which raises without one; "cpu" when asked for).
    param_dtype: storage of the matmul weights and biases, cast to
    cfg.dtype at each use; default cfg.dtype (serving).  Training passes
    torch.float32, as the JAX package trains fp32 params.
    """

    def __init__(
        self,
        cfg: GPTConfig,
        *,
        generator: torch.Generator | None = None,
        device=None,
        param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        dtype = param_dtype or cfg.dtype
        self.cfg = cfg
        self.blocks = nn.ModuleList(Block(cfg, gen, device, dtype) for _ in range(cfg.n_layer))
        self.wte = nn.Parameter((torch.randn(cfg.vocab_size, cfg.n_embd, generator=gen, device=gen.device) * 0.02)
                                .to(device))
        self.wpe = nn.Parameter((torch.randn(cfg.block_size, cfg.n_embd, generator=gen, device=gen.device) * 0.02)
                                .to(device))
        self.lnf = LayerNorm(cfg.n_embd, cfg.fast_ln, device)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def embed(self, idx: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token + position embeddings, summed in fp32, in the compute dtype."""
        tok = tp_embedding(idx, self.wte) if tp_info(self.wte) is not None else local(self.wte)[idx]
        return (tok + local(self.wpe)[positions]).to(self.cfg.dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm and the tied LM head, in the compute dtype.  With
        `wte` sharded over the vocabulary, each rank's logits are gathered."""
        x = self.lnf(x)
        info = tp_info(self.wte)
        if info is None:
            return F.linear(x, local(self.wte).to(x.dtype))
        return gather_from(F.linear(copy_to(x, info[0]), local(self.wte).to(x.dtype)), info[0], -1)

    def logits(self, idx: torch.Tensor, *, rng: int | None = None, deterministic: bool = True,
               shard=None) -> torch.Tensor:
        """The logits of this rank's tokens: of idx itself when shard is
        None, else of shard.take(idx) (in the shard's token order)."""
        cfg = self.cfg
        t = idx.shape[1]
        if t > cfg.block_size:
            raise ValueError(f"sequence length {t} > block_size {cfg.block_size}")
        drop = not deterministic and cfg.dropout > 0.0
        if drop and rng is None:
            raise ValueError("dropout needs a seed: pass rng= with deterministic=False")

        def seed(site: int) -> int | None:
            return _site_seed(rng, site) if drop else None

        if shard is None:
            positions = torch.arange(t, device=idx.device)
        else:
            idx, positions = shard.take(idx), shard.positions
        x = _dropout(self.embed(idx, positions), cfg.dropout, seed(0), shard)
        remat = cfg.remat and torch.is_grad_enabled()
        for li, blk in enumerate(self.blocks):
            seeds = (seed(1 + 2 * li), seed(2 + 2 * li))
            x = checkpoint(blk, x, seeds, shard, use_reentrant=False) if remat else blk(x, seeds, shard)
        return self.head(x)

    def forward(self, idx: torch.Tensor, *, rng: int | None = None, deterministic: bool = True) -> torch.Tensor:
        """Token ids [B, T] -> logits [B, T, vocab] in the compute dtype.

        Dropout applies when deterministic is False and cfg.dropout > 0;
        `rng` is then the step's seed, from which every site draws its
        mask.  With cfg.remat each block is recomputed in the backward.
        Under cfg.seq_mesh idx is the global batch (the same on every rank)
        and so are the logits, gathered from every rank's shard."""
        shard = seq_shard(self, idx)
        out = self.logits(idx, rng=rng, deterministic=deterministic, shard=shard)
        return out if shard is None else shard.gather(out)


def num_params(model: GPT) -> int:
    return sum(p.numel() for p in model.parameters())


def loss_fn(
    model: GPT,
    idx: torch.Tensor,
    targets: torch.Tensor,
    *,
    rng: int | None = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Mean next-token cross-entropy, as logsumexp(logits) - logits[target]
    (JAX `loss_fn`): the logits stay in the compute dtype and the fp32 cast
    happens inside the reductions, so bf16 training keeps bf16 logit grads
    rounded as JAX rounds them.  Under cfg.seq_mesh each rank scores its
    own tokens (targets taken as the tokens are) and the sum is reduced
    over the mesh: the loss of the whole batch, on every rank."""
    shard = seq_shard(model, idx)
    logits = model.logits(idx, rng=rng, deterministic=deterministic, shard=shard)
    return token_loss(logits, targets, shard)


def token_loss(logits: torch.Tensor, targets: torch.Tensor, shard=None) -> torch.Tensor:
    """Mean cross entropy of logits [B, T, V] against targets [B, T]; with a
    SeqShard, of this rank's logits against its part of the global targets,
    summed over the shard's ranks and divided by the global count."""
    if shard is not None:
        targets = shard.take(targets)
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0].float() + torch.log(torch.exp((logits - m).float()).sum(dim=-1))
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    per_token = lse - picked.float()
    if shard is None:
        return per_token.mean()
    return shard.sum(per_token.sum()) / (shard.b * shard.t)


@torch.no_grad()
def generate(
    model: GPT,
    idx: torch.Tensor,
    *,
    max_new_tokens: int,
    temperature: float = 1.0,
    top_k: int | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Naive full-recompute sampling (nanoGPT generate parity); the
    inference engine is the serving path with a KV cache.  `generator`
    lives on idx's device; default a fresh one seeded 0."""
    if generator is None:
        generator = torch.Generator(device=idx.device).manual_seed(0)
    for _ in range(max_new_tokens):
        ctx = idx[:, -model.cfg.block_size:]
        # unsharded even under cfg.seq_mesh: incremental contexts cannot
        # meet the ring's divisibility (the JAX generate drops seq_mesh)
        logits = model.logits(ctx)[:, -1, :].float() / max(temperature, 1e-6)
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, -math.inf, logits)
        nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)
        idx = torch.cat([idx, nxt.to(idx.dtype)], dim=1)
    return idx


# (module, JAX group, JAX weight name, JAX bias name) of each block linear
def _block_linears(blk: Block):
    return (
        (blk.attn.wqkv, "attn", "wqkv", "bqkv"),
        (blk.attn.wo, "attn", "wo", "bo"),
        (blk.mlp.wfc, "mlp", "wfc", "bfc"),
        (blk.mlp.wproj, "mlp", "wproj", "bproj"),
    )


def params_from_jax(
    tree: dict[str, Any], cfg: GPTConfig, *, param_dtype: torch.dtype | None = None, device=None
) -> GPT:
    """Build a GPT from the JAX package's params pytree, with its leaves
    already numpy arrays (`jax.tree.map(np.asarray, params)`).

    JAX stores linear weights [in, out]; nn.Linear wants [out, in].  Absent
    biases are None in the tree (cfg.bias False).  The LM head is tied to
    `wte` in both packages, so the tree has no separate head.  param_dtype
    and device as in `GPT` (torch.float32 for a trainable model; default
    the card).
    """
    model = GPT(cfg, device=resolve_device(device), param_dtype=param_dtype)

    def put(param: nn.Parameter, value, transpose: bool = False) -> None:
        arr = np.array(value, dtype=np.float32)
        t = torch.from_numpy(np.ascontiguousarray(arr.T) if transpose else arr)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"shape mismatch: {tuple(t.shape)} vs {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(t.to(device=param.device, dtype=param.dtype))

    put(model.wte, tree["wte"])
    put(model.wpe, tree["wpe"])
    put(model.lnf.g, tree["lnf"]["g"])
    put(model.lnf.b, tree["lnf"]["b"])
    if len(tree["blocks"]) != cfg.n_layer:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, cfg.n_layer is {cfg.n_layer}")
    for blk, src in zip(model.blocks, tree["blocks"]):
        for ln in ("ln1", "ln2"):
            put(getattr(blk, ln).g, src[ln]["g"])
            put(getattr(blk, ln).b, src[ln]["b"])
        for mod, group, w, bname in _block_linears(blk):
            put(mod.weight, src[group][w], transpose=True)
            if (src[group][bname] is None) != (mod.bias is None):
                raise ValueError(f"bias {group}.{bname} presence does not match cfg.bias={cfg.bias}")
            if mod.bias is not None:
                put(mod.bias, src[group][bname])
    return model


def grads_to_jax_layout(model: GPT, *, params: bool = False) -> dict[str, Any]:
    """The parameters' .grad as the JAX params pytree (numpy fp32 leaves,
    linear weights [in, out], absent biases None): the inverse of
    `params_from_jax`'s naming, for comparing with `jax.grad`.
    params=True gives the parameters themselves in that layout.  DTensor
    parameters and gradients (a sharded model) come out whole."""

    def g(param: nn.Parameter, transpose: bool = False):
        arr = whole(param, None if params else param.grad).detach().float().cpu().numpy()
        return np.ascontiguousarray(arr.T) if transpose else arr

    def ln(mod: LayerNorm):
        return {"g": g(mod.g), "b": g(mod.b)}

    blocks = []
    for blk in model.blocks:
        src = {"ln1": ln(blk.ln1), "ln2": ln(blk.ln2), "attn": {}, "mlp": {}}
        for mod, group, w, bname in _block_linears(blk):
            src[group][w] = g(mod.weight, transpose=True)
            src[group][bname] = g(mod.bias) if mod.bias is not None else None
        blocks.append(src)
    return {"wte": g(model.wte), "wpe": g(model.wpe), "blocks": blocks, "lnf": ln(model.lnf)}
