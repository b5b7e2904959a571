"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs as the JAX package's own tests run it on the CPU (Pallas in
interpret mode, which tests/conftest.py forces).  The model configuration
is small: 2 layers, 4 heads, width 64, vocab 64, fp32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flash_attention_tpu.models import gpt as jgpt
from flash_attention_tpu_torch.inference import kv_cache as tkv
from flash_attention_tpu_torch.models import gpt as tgpt

# The tier-1 run uses several pytest workers; keep each one's intra-op
# threads few so that they do not oversubscribe the machine.
torch.set_num_threads(2)

JAX_CFG = jgpt.GPTConfig(
    vocab_size=64, block_size=256, n_layer=2, n_head=4, n_embd=64,
    dropout=0.0, dtype=jnp.float32,
)
TORCH_CFG = tgpt.GPTConfig(
    vocab_size=64, block_size=256, n_layer=2, n_head=4, n_embd=64,
    dtype=torch.float32,
)


def numpy_params(seed: int = 0, scale: float = 1.0, cfg=JAX_CFG) -> dict:
    """The JAX package's GPT-2 init as a numpy pytree, with every matrix
    (embeddings and linear weights) multiplied by `scale`."""
    tree = jax.tree.map(np.asarray, jgpt.init_params(jax.random.PRNGKey(seed), cfg))
    return jax.tree.map(lambda a: a * scale if a.ndim == 2 else a, tree)


def jax_tree(tree: dict) -> dict:
    return jax.tree.map(jnp.asarray, tree)


def randn(seed: int, *shape: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def from_jax(a) -> torch.Tensor:
    """A JAX array as a torch tensor (a copy).  numpy has no fp8 or bf16,
    so they travel as uint8 / int16 views and are viewed back as torch's."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x) -> np.ndarray:
    """The raw bytes of a 1-byte payload (int8 or fp8, JAX or torch) as
    uint8, for bit-exact comparison."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def torch_cache(jc) -> tkv.KVCache:
    """The port's KVCache holding a JAX KVCache's contents, with separate
    k_scale and v_scale tensors."""
    scales = (from_jax(jc.k_scale), from_jax(jc.v_scale)) if jc.k_scale is not None else (None, None)
    return tkv.KVCache(from_jax(jc.k), from_jax(jc.v), *scales, from_jax(jc.lengths))
