"""GPT-2-class causal transformer as a PyTorch module.

Port of `flash_attention_tpu/models/gpt.py` (forward only: training, with
its dropout and rematerialisation, comes with the training slice).  The
parameter names follow the JAX params pytree (`blocks[i].attn.wqkv`, ...),
so that `params_from_jax` is a rename and a transpose.

Storage dtypes: the JAX package keeps every parameter in fp32 and casts the
matmul weights to the compute dtype at each use.  Here the matmul weights
and biases are stored in the compute dtype (`cfg.dtype`) once, which gives
the same products without re-casting 124M weights on every decode step;
the LayerNorm parameters and both embedding tables stay fp32, as the JAX
forward uses them in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device
from ..kernels.flash_attention import flash_attention
from ..kernels.vanilla import vanilla_attention


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """nanoGPT-compatible configuration, as in the JAX package."""

    vocab_size: int = 50304
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    n_kv_head: int | None = None  # GQA: None means MHA
    dropout: float = 0.0  # used by training, which this slice does not port
    bias: bool = True
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    use_flash: bool = True  # False = dense attention
    fast_ln: bool = True  # LayerNorm variance as E[x^2] - mu^2

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
        return _layer_norm(x, self.g, self.b, fast=self.fast)


def _linear(n_in: int, n_out: int, bias: bool, std: float, cfg: GPTConfig, gen, device) -> nn.Linear:
    """nn.Linear in the compute dtype with N(0, std) weights drawn from
    `gen` on the CPU (so a seed gives the same weights on every device)."""
    lin = nn.Linear(n_in, n_out, bias=bias, device="meta")
    w = torch.randn(n_out, n_in, generator=gen) * std
    lin.weight = nn.Parameter(w.to(device=device, dtype=cfg.dtype))
    if bias:
        lin.bias = nn.Parameter(torch.zeros(n_out, device=device, dtype=cfg.dtype))
    return lin


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, gen, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.head_dim
        proj_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        self.wqkv = _linear(cfg.n_embd, (cfg.n_head + 2 * cfg.kv_heads) * d, cfg.bias, 0.02, cfg, gen, device)
        self.wo = _linear(cfg.n_embd, cfg.n_embd, cfg.bias, proj_std, cfg, gen, device)

    def split_heads(self, x: torch.Tensor):
        """x [B, T, E] -> q [B, H, T, D], k/v [B, Hkv, T, D] (views of one
        fused projection)."""
        cfg = self.cfg
        bsz, t, _ = x.shape
        d, h, hkv = cfg.head_dim, cfg.n_head, cfg.kv_heads
        q, k, v = self.wqkv(x).split([h * d, hkv * d, hkv * d], dim=-1)
        return (
            q.view(bsz, t, h, d).transpose(1, 2),
            k.view(bsz, t, hkv, d).transpose(1, 2),
            v.view(bsz, t, hkv, d).transpose(1, 2),
        )

    def merge_heads(self, y: torch.Tensor) -> torch.Tensor:
        """y [B, H, T, D] -> output projection of [B, T, H*D]."""
        bsz, h, t, d = y.shape
        return self.wo(y.transpose(1, 2).reshape(bsz, t, h * d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = self.split_heads(x)
        if cfg.use_flash:
            y = flash_attention(q, k, v, causal=True)
        else:
            group = cfg.n_head // cfg.kv_heads
            if group > 1:
                k = k.repeat_interleave(group, dim=1)
                v = v.repeat_interleave(group, dim=1)
            y = vanilla_attention(q, k, v, causal=True, sm_scale=cfg.head_dim ** -0.5)
        return self.merge_heads(y)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, gen, device):
        super().__init__()
        proj_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        self.wfc = _linear(cfg.n_embd, 4 * cfg.n_embd, cfg.bias, 0.02, cfg, gen, device)
        self.wproj = _linear(4 * cfg.n_embd, cfg.n_embd, cfg.bias, proj_std, cfg, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu defaults to the tanh approximation; F.gelu does not.
        return self.wproj(F.gelu(self.wfc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, gen, device):
        super().__init__()
        self.ln1 = LayerNorm(cfg.n_embd, cfg.fast_ln, device)
        self.attn = Attention(cfg, gen, device)
        self.ln2 = LayerNorm(cfg.n_embd, cfg.fast_ln, device)
        self.mlp = MLP(cfg, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """GPT-2 with GPT-2 init: N(0, 0.02), residual projections scaled by
    1/sqrt(2 n_layer), zero biases; the LM head is tied to `wte`.

    generator: the torch.Generator all weights are drawn from (CPU);
    default a fresh one seeded 0.  device: where the weights live.
    """

    def __init__(self, cfg: GPTConfig, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.blocks = nn.ModuleList(Block(cfg, gen, device) for _ in range(cfg.n_layer))
        self.wte = nn.Parameter((torch.randn(cfg.vocab_size, cfg.n_embd, generator=gen) * 0.02).to(device))
        self.wpe = nn.Parameter((torch.randn(cfg.block_size, cfg.n_embd, generator=gen) * 0.02).to(device))
        self.lnf = LayerNorm(cfg.n_embd, cfg.fast_ln, device)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def embed(self, idx: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token + position embeddings, summed in fp32, in the compute dtype."""
        return (self.wte[idx] + self.wpe[positions]).to(self.cfg.dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm and the tied LM head, in the compute dtype."""
        return F.linear(self.lnf(x), self.wte.to(x.dtype))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        """Token ids [B, T] -> logits [B, T, vocab] in the compute dtype."""
        t = idx.shape[1]
        if t > self.cfg.block_size:
            raise ValueError(f"sequence length {t} > block_size {self.cfg.block_size}")
        x = self.embed(idx, torch.arange(t, device=idx.device))
        for blk in self.blocks:
            x = blk(x)
        return self.head(x)


def num_params(model: GPT) -> int:
    return sum(p.numel() for p in model.parameters())


def params_from_jax(tree: dict[str, Any], cfg: GPTConfig, *, device=None) -> GPT:
    """Build a GPT from the JAX package's params pytree, with its leaves
    already numpy arrays (`jax.tree.map(np.asarray, params)`).

    JAX stores linear weights [in, out]; nn.Linear wants [out, in].  Absent
    biases are None in the tree (cfg.bias False).  The LM head is tied to
    `wte` in both packages, so the tree has no separate head.
    """
    model = GPT(cfg, device=resolve_device(device))

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
        for mod, group, w, bname in (
            (blk.attn.wqkv, "attn", "wqkv", "bqkv"),
            (blk.attn.wo, "attn", "wo", "bo"),
            (blk.mlp.wfc, "mlp", "wfc", "bfc"),
            (blk.mlp.wproj, "mlp", "wproj", "bproj"),
        ):
            put(mod.weight, src[group][w], transpose=True)
            if (src[group][bname] is None) != (mod.bias is None):
                raise ValueError(f"bias {group}.{bname} presence does not match cfg.bias={cfg.bias}")
            if mod.bias is not None:
                put(mod.bias, src[group][bname])
    return model
