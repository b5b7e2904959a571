"""Llama-family transformer (RMSNorm, RoPE, SwiGLU, GQA) as a PyTorch module.

Port of `flash_attention_tpu/models/llama.py`: the configurations, the
forward and `loss_fn`, and the serving functions `prefill`,
`prefill_chunk`, `decode_step` and `decode_loop` over the KV cache, which
take the `Llama` module where the JAX package took its params pytree and
config and update the cache in place.  Attention is `flash_attention` (K1, and K2/K3 in training) over the
prompt, the dense `model_runner._offset_attention` over a prompt's chunk
and the einsum `decode_attention` for one token per slot, as in the JAX
package, whose Llama decode takes no `attn_impl`.

What the port keeps exactly, since the results drift otherwise: RoPE in
split halves (not interleaved) with its tables computed in fp32; RMSNorm in
fp32 times the fp32 gain, cast back; each weight cast to the activation's
dtype at use (`_mm`); the logits of `forward` in the model dtype and those
of `prefill` / `decode_step` cast to fp32; K cached after RoPE.

The weights are drawn from an explicit `torch.Generator` on its own device,
matrix by matrix, so that a full-width model can be drawn on the card
(`Llama(LLAMA3_8B, generator=torch.Generator("cuda").manual_seed(s),
device="cuda")`, bf16 storage: 16 GB, where fp32 masters would be 32 GB).
Weight-only int8/int4 comes from `quant.weights.quantize_llama_params`,
which replaces the projections and the LM head by `QuantizedLinear`s.

Sharded runs as in `models/gpt.py`: under `cfg.seq_mesh` the forward and
`loss_fn` take the global batch, keep this rank's rows and tokens, apply
RoPE at their global positions (zig-zag ones too) and attend through the
ring; parameters placed by `parallel.distribute_params` (tensor-parallel
training, `parallel.shard_llama_for_inference`) run on their local shards,
attention on the local heads, the LM head's vocabulary shards gathered.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device
from ..inference import kv_cache as kvc
from ..inference.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from ..parallel.collectives import gather_from, local, tp_embedding, tp_info
from ..parallel.ring_attention import seq_shard
from ..parallel.sharding import whole
from ..quant.weights import QuantizedLinear, is_quantized_leaf, quantized_tensor_from
from .gpt import Linear, token_loss


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32
    n_embd: int = 4096
    intermediate: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Context parallelism through ring attention, as GPTConfig's fields.
    seq_mesh: Any = None
    seq_axis: str = "seq"
    seq_batch_axis: str | None = None
    seq_zigzag: bool = False

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


LLAMA2_7B = LlamaConfig()
LLAMA3_8B = LlamaConfig(
    vocab_size=128256,
    n_kv_head=8,
    intermediate=14336,
    max_seq=8192,
    rope_theta=500000.0,
)
TINY_LLAMA = LlamaConfig(
    vocab_size=64,
    n_layer=2,
    n_head=4,
    n_kv_head=2,
    n_embd=64,
    intermediate=128,
    max_seq=256,
    dtype=torch.float32,
)


def _rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, times the fp32 gain, cast back to x's dtype."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale * local(gain)).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions: [..., head_dim/2], fp32.  The
    frequencies theta^(-i/half) are taken in float64 and rounded once, which
    gives XLA's fp32 `theta ** x` bit for bit (torch's fp32 pow differs in
    the last bit for some i, and an angle multiplies that by the position)."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = (theta ** expo.double()).float()
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., seq, head_dim]; cos/sin [..., seq, head_dim/2] (split halves),
    computed in fp32 and cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _draw(gen: torch.Generator, shape: tuple[int, ...], std: float, dtype: torch.dtype, device) -> nn.Parameter:
    """N(0, std) drawn in fp32 on the generator's device, stored in `dtype`
    on `device`."""
    w = torch.randn(shape, generator=gen, device=gen.device).mul_(std)
    return nn.Parameter(w.to(device=device, dtype=dtype))


def _linear(gen, n_in: int, n_out: int, dtype, device) -> Linear:
    lin = Linear(n_in, n_out, bias=False, device="meta")
    lin.weight = _draw(gen, (n_out, n_in), 0.02, dtype, device)
    return lin


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, device, dtype: torch.dtype):
        super().__init__()
        d, e = cfg.head_dim, cfg.n_embd
        self.cfg = cfg
        self.attn_norm = nn.Parameter(torch.ones(e, device=device))
        self.wq = _linear(gen, e, cfg.n_head * d, dtype, device)
        self.wk = _linear(gen, e, cfg.n_kv_head * d, dtype, device)
        self.wv = _linear(gen, e, cfg.n_kv_head * d, dtype, device)
        self.wo = _linear(gen, cfg.n_head * d, e, dtype, device)
        self.mlp_norm = nn.Parameter(torch.ones(e, device=device))
        self.w_gate = _linear(gen, e, cfg.intermediate, dtype, device)
        self.w_up = _linear(gen, e, cfg.intermediate, dtype, device)
        self.w_down = _linear(gen, cfg.intermediate, e, dtype, device)

    def project_qkv(self, x: torch.Tensor, b: int, t: int):
        """x [b, t, E] -> q [b, H, t, D], k/v [b, Hkv, t, D] (`_project_qkv`);
        the local heads when the projections are sharded over the model axis."""
        d = self.cfg.head_dim
        q = self.wq(x).reshape(b, t, -1, d)
        k = self.wk(x).reshape(b, t, -1, d)
        v = self.wv(x).reshape(b, t, -1, d)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))

    def finish(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The residual after attention output y [b, t, H*D]: the output
        projection, then the MLP on the RMS-normed stream."""
        x = x + self.wo(y)
        return x + self.mlp(_rms_norm(x, self.mlp_norm, self.cfg.rms_eps))


class Llama(nn.Module):
    """Llama with the JAX package's init (`init_params`): N(0, 0.02)
    embeddings and linear weights, unit norm gains, an untied LM head.

    generator: the torch.Generator every weight is drawn from, on its own
    device; default a fresh one on `device` seeded 0.  device: where the
    weights live, default the card ("cuda", which raises without one;
    "cpu" when asked for).  param_dtype: storage of the embedding and the
    linear weights, cast to cfg.dtype at each use; default cfg.dtype
    (serving).  Training passes torch.float32, as the JAX package trains
    fp32 params.  The norm gains are fp32 either way.
    """

    def __init__(
        self,
        cfg: LlamaConfig,
        *,
        generator: torch.Generator | None = None,
        device=None,
        param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
        dtype = param_dtype or cfg.dtype
        self.cfg = cfg
        self.wte = _draw(gen, (cfg.vocab_size, cfg.n_embd), 0.02, dtype, device)
        self.blocks = nn.ModuleList(LlamaBlock(cfg, gen, device, dtype) for _ in range(cfg.n_layer))
        self.norm_f = nn.Parameter(torch.ones(cfg.n_embd, device=device))
        self.lm_head = _linear(gen, cfg.n_embd, cfg.vocab_size, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def embed(self, idx: torch.Tensor) -> torch.Tensor:
        if tp_info(self.wte) is not None:
            return tp_embedding(idx, self.wte).to(self.cfg.dtype)
        return local(self.wte)[idx.long()].to(self.cfg.dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final RMSNorm and the LM head, in the compute dtype; an LM head
        sharded over the vocabulary has its logits gathered."""
        y = self.lm_head(_rms_norm(x, self.norm_f, self.cfg.rms_eps))
        group = _vocab_group(self.lm_head)
        return y if group is None else gather_from(y, group, -1)

    def logits(self, idx: torch.Tensor, *, shard=None) -> torch.Tensor:
        """The logits of this rank's tokens, as `GPT.logits`: RoPE at the
        tokens' global positions, attention through the ring."""
        cfg = self.cfg
        if shard is None:
            positions = torch.arange(idx.shape[1], device=idx.device)
        else:
            idx, positions = shard.take(idx), shard.positions
        b, t = idx.shape
        x = self.embed(idx)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[None, None], sin[None, None]  # [1, 1, T, half]
        for blk in self.blocks:
            q, k, v = blk.project_qkv(_rms_norm(x, blk.attn_norm, cfg.rms_eps), b, t)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            y = shard.attend(q, k, v) if shard is not None else flash_attention(q, k, v, causal=True)
            x = blk.finish(x, y.transpose(1, 2).reshape(b, t, -1))
        return self.head(x)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        """Token ids [B, T] -> logits [B, T, vocab], in the model dtype (the
        loss casts to fp32 inside its reductions).  Under cfg.seq_mesh idx
        is the global batch and the logits are gathered, as `GPT.forward`."""
        shard = seq_shard(self, idx)
        out = self.logits(idx, shard=shard)
        return out if shard is None else shard.gather(out)


def num_params(model: Llama) -> int:
    return sum(p.numel() for p in model.parameters())


def _vocab_group(lm_head: nn.Module):
    """The model-axis group of an LM head sharded over the vocabulary
    (its outputs), else None."""
    if isinstance(lm_head, QuantizedLinear):
        info = tp_info(lm_head.values)  # [in, out]
        return info[0] if info is not None and info[3] == 1 else None
    info = tp_info(lm_head.weight)  # [out, in]
    return info[0] if info is not None and info[3] == 0 else None


def loss_fn(model: Llama, idx: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy as logsumexp - picked logit, the fp32
    cast inside the reductions (JAX `loss_fn`); under cfg.seq_mesh summed
    over the mesh as `gpt.loss_fn`."""
    shard = seq_shard(model, idx)
    return token_loss(model.logits(idx, shard=shard), targets, shard)


# ----------------------------------------------------------------- inference


@torch.no_grad()
def prefill(
    model: Llama,
    tokens: torch.Tensor,
    cache: kvc.KVCache,
    slot: int,
    length: int | None = None,
) -> tuple[kvc.KVCache, torch.Tensor]:
    """Prompt [T] -> (cache, fp32 logits [vocab] at the last real token).
    K is cached after RoPE.  `length` is the true prompt length of a
    bucket-padded prompt, as in `model_runner.prefill`."""
    cfg = model.cfg
    t = tokens.shape[0]
    x = model.embed(tokens)[None]
    cos, sin = rope_cos_sin(torch.arange(t, device=tokens.device), cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[None, None], sin[None, None]
    for li, blk in enumerate(model.blocks):
        q, k, v = blk.project_qkv(_rms_norm(x, blk.attn_norm, cfg.rms_eps), 1, t)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        kvc.prefill_write(cache, li, slot, k[0], v[0])
        y = flash_attention(q, k, v, causal=True)
        x = blk.finish(x, y.transpose(1, 2).reshape(1, t, -1))
    n = t if length is None else int(length)
    logits = model.head(x[0, n - 1]).float()
    kvc.set_length(cache, slot, n)
    return cache, logits


@torch.no_grad()
def prefill_chunk(
    model: Llama,
    tokens: torch.Tensor,
    cache: kvc.KVCache,
    slot: int,
    start: int,
    length: int | None = None,
) -> tuple[kvc.KVCache, torch.Tensor]:
    """Chunked prefill (cf. `model_runner.prefill_chunk`): tokens [C] at
    positions start .. start + C - 1, attending to the slot's cached prefix
    and themselves.  RoPE takes the absolute positions, clipped to the
    cache's capacity (GPT clips its learned positions to block_size
    instead).  Engine: `InferenceEngine(model, prefill_fn=llama.prefill,
    decode_fn=llama.decode_step, prefill_chunk_fn=llama.prefill_chunk,
    chunk_prefill=N)`."""
    from ..inference.model_runner import _chunk_attention

    cfg = model.cfg
    c = tokens.shape[0]
    x = model.embed(tokens)[None]
    positions = (int(start) + torch.arange(c, device=tokens.device)).clamp(0, cache.max_len - 1)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[None, None], sin[None, None]
    for li, blk in enumerate(model.blocks):
        q, k, v = blk.project_qkv(_rms_norm(x, blk.attn_norm, cfg.rms_eps), 1, c)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        kvc.chunk_write(cache, li, slot, k[0], v[0], start)
        y = _chunk_attention(q, cache, li, slot, start)
        x = blk.finish(x, y.transpose(1, 2).reshape(1, c, -1))
    valid = c if length is None else int(length)
    logits = model.head(x[0, valid - 1]).float()
    kvc.set_length(cache, slot, int(start) + valid)
    return cache, logits


@torch.no_grad()
def decode_step(
    model: Llama,
    tokens: torch.Tensor,
    cache: kvc.KVCache,
    active: torch.Tensor | None = None,
) -> tuple[kvc.KVCache, torch.Tensor]:
    """One token per slot: tokens [slots] -> (cache, fp32 logits [slots,
    vocab]).  Positions are lengths clipped to the capacity; lengths stop
    advancing at max_len - 1 (callers retire full sequences)."""
    cfg = model.cfg
    s, d = cache.slots, cfg.head_dim
    positions = cache.lengths.clamp(0, cache.max_len - 1)
    x = model.embed(tokens)[:, None]  # [S, 1, E]
    cos, sin = rope_cos_sin(positions[:, None], d, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]  # [S, 1, 1, half]
    for li, blk in enumerate(model.blocks):
        q, k, v = blk.project_qkv(_rms_norm(x, blk.attn_norm, cfg.rms_eps), s, 1)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        kvc.decode_write(cache, li, k[:, :, 0], v[:, :, 0], positions)
        y = decode_attention(q[:, :, 0], cache, li)
        x = blk.finish(x, y.reshape(s, 1, -1))
    logits = model.head(x[:, 0]).float()
    step = torch.ones_like(cache.lengths) if active is None else active.to(torch.int32)
    step = torch.where(cache.lengths < cache.max_len - 1, step, 0)
    kvc.advance_lengths(cache, step)
    return cache, logits


@torch.no_grad()
def decode_loop(
    model: Llama,
    cache: kvc.KVCache,
    first_tokens: torch.Tensor,
    n_steps: int,
) -> tuple[kvc.KVCache, torch.Tensor]:
    """Greedy decoding of `n_steps` chained decode steps (a Python loop in
    place of the JAX package's lax.scan).  Returns (cache, tokens [n_steps,
    slots])."""
    toks = first_tokens
    out = []
    for _ in range(n_steps):
        cache, logits = decode_step(model, toks, cache)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(toks)
    return cache, torch.stack(out)


# ---------------------------------------------------------------- JAX params

_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def params_from_jax(
    tree: dict[str, Any], cfg: LlamaConfig, *, param_dtype: torch.dtype | None = None, device=None
) -> Llama:
    """Build a Llama from the JAX package's params pytree with numpy leaves
    (`jax.tree.map(np.asarray, params)`).  JAX stores linear weights [in,
    out], nn.Linear [out, in].  A quantized leaf (the JAX QuantizedTensor,
    from `quantize_llama_params`) becomes a QuantizedLinear holding the same
    bytes: the int4 packing is the same in both packages.  param_dtype and
    device as in `Llama`."""
    device = resolve_device(device)
    model = Llama(cfg, generator=torch.Generator(device="cpu").manual_seed(0), device="cpu",
                  param_dtype=param_dtype)

    def put(param: nn.Parameter, value, transpose: bool = False) -> None:
        arr = np.array(value, dtype=np.float32)
        t = torch.from_numpy(np.ascontiguousarray(arr.T) if transpose else arr)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"shape mismatch: {tuple(t.shape)} vs {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(t.to(param.dtype))

    def put_linear(parent: nn.Module, name: str, value) -> None:
        if is_quantized_leaf(value):
            setattr(parent, name, QuantizedLinear(quantized_tensor_from(value)))
        else:
            put(getattr(parent, name).weight, value, transpose=True)

    if len(tree["blocks"]) != cfg.n_layer:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, cfg.n_layer is {cfg.n_layer}")
    put(model.wte, tree["wte"])
    put(model.norm_f, tree["norm_f"])
    put_linear(model, "lm_head", tree["lm_head"])
    for blk, src in zip(model.blocks, tree["blocks"]):
        put(blk.attn_norm, src["attn_norm"])
        put(blk.mlp_norm, src["mlp_norm"])
        for name in _LINEARS:
            put_linear(blk, name, src[name])
    return model.to(device)


def grads_to_jax_layout(model: Llama, *, params: bool = False) -> dict[str, Any]:
    """The parameters' .grad (params=True: the parameters) as the JAX
    params pytree with numpy fp32 leaves and linear weights [in, out], as
    `gpt.grads_to_jax_layout`; DTensors come out whole.  Dense linears
    only (the JAX package trains no quantized params)."""

    def g(p: torch.Tensor, transpose: bool = False):
        arr = whole(p, None if params else p.grad).detach().float().cpu().numpy()
        return np.ascontiguousarray(arr.T) if transpose else arr

    blocks = [
        {"attn_norm": g(blk.attn_norm), "mlp_norm": g(blk.mlp_norm),
         **{name: g(getattr(blk, name).weight, transpose=True) for name in _LINEARS}}
        for blk in model.blocks
    ]
    return {"wte": g(model.wte), "blocks": blocks, "norm_f": g(model.norm_f),
            "lm_head": g(model.lm_head.weight, transpose=True)}
