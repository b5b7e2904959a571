"""GPT model: weights carried across from the JAX params pytree, logits
against the JAX package's forward, and the places where the two
frameworks' defaults differ (GELU, LayerNorm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import JAX_CFG, TORCH_CFG, jax_tree, n, numpy_params, randn, t
from flash_attention_tpu.models import gpt as jgpt
from flash_attention_tpu_torch.models import gpt as tgpt


@pytest.mark.parametrize("use_flash", [True, False])
def test_logits_match_jax_forward(use_flash):
    """T = 160 takes the flash kernel's path in both packages (>= MIN_BLOCK)."""
    tree = numpy_params(seed=0)
    idx = np.random.default_rng(1).integers(0, JAX_CFG.vocab_size, (2, 160)).astype(np.int32)
    want = jgpt.forward(jax_tree(tree), jnp.asarray(idx), JAX_CFG)
    cfg = tgpt.GPTConfig(**{**TORCH_CFG.__dict__, "use_flash": use_flash})
    model = tgpt.params_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        got = model(t(idx))
    assert got.shape == (2, 160, JAX_CFG.vocab_size)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4, rtol=0)


def test_params_from_jax_transposes_and_ties():
    tree = numpy_params(seed=2)
    model = tgpt.params_from_jax(tree, TORCH_CFG, device="cpu")
    w = tree["blocks"][1]["attn"]["wqkv"]  # JAX [in, out]
    np.testing.assert_array_equal(n(model.blocks[1].attn.wqkv.weight), w.T)
    np.testing.assert_array_equal(n(model.blocks[0].mlp.wproj.weight), tree["blocks"][0]["mlp"]["wproj"].T)
    np.testing.assert_array_equal(n(model.wte), tree["wte"])
    # the head is the embedding: no separate LM-head parameter
    assert not any("head" in name for name, _ in model.named_parameters())
    assert tgpt.num_params(model) == sum(x.size for x in jax.tree.leaves(tree))


def test_params_from_jax_without_biases():
    jcfg = jgpt.GPTConfig(**{**JAX_CFG.__dict__, "bias": False})
    tcfg = tgpt.GPTConfig(**{**TORCH_CFG.__dict__, "bias": False})
    tree = jax.tree.map(np.asarray, jgpt.init_params(jax.random.PRNGKey(3), jcfg))
    assert tree["blocks"][0]["attn"]["bqkv"] is None
    model = tgpt.params_from_jax(tree, tcfg, device="cpu")
    assert model.blocks[0].attn.wqkv.bias is None
    idx = np.arange(20, dtype=np.int32)[None] % 64
    with torch.no_grad():
        got = model(t(idx))
    np.testing.assert_allclose(n(got), np.asarray(jgpt.forward(jax_tree(tree), jnp.asarray(idx), jcfg)), atol=1e-4)
    with pytest.raises(ValueError, match="bias"):
        tgpt.params_from_jax(tree, TORCH_CFG, device="cpu")


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; the port's MLP must use it."""
    x = t(randn(4, 16, 64) * 4)
    mlp = tgpt.MLP(TORCH_CFG, torch.Generator().manual_seed(0), torch.device("cpu"))
    with torch.no_grad():
        h = mlp.wfc(x)
        jax_gelu = torch.from_numpy(np.asarray(jax.nn.gelu(jnp.asarray(n(h)))))
        np.testing.assert_allclose(n(mlp(x)), n(mlp.wproj(jax_gelu)), atol=1e-5, rtol=0)
        erf_gap = (torch.nn.functional.gelu(h) - jax_gelu).abs().max().item()
        assert erf_gap > 1e-4  # the erf form would not pass the check above


@pytest.mark.parametrize("fast", [True, False])
def test_layer_norm_matches_jax(fast):
    x = randn(5, 3, 64) * 3 + 2
    g, b = randn(6, 64), randn(7, 64)
    want = jgpt._layer_norm(jnp.asarray(x), {"g": jnp.asarray(g), "b": jnp.asarray(b)}, fast=fast)
    got = tgpt._layer_norm(t(x), t(g), t(b), fast=fast)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6, rtol=0)


def test_init_is_seeded_and_gpt2_scaled():
    a = tgpt.GPT(TORCH_CFG, generator=torch.Generator().manual_seed(5), device="cpu")
    b = tgpt.GPT(TORCH_CFG, generator=torch.Generator().manual_seed(5), device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    w = a.blocks[0].attn.wo.weight
    assert abs(w.std().item() - 0.02 / np.sqrt(2 * TORCH_CFG.n_layer)) < 2e-3
    assert torch.all(a.blocks[0].attn.wqkv.bias == 0)
    bf = tgpt.GPT(tgpt.GPTConfig(**{**TORCH_CFG.__dict__, "dtype": torch.bfloat16}), device="cpu")
    assert bf.blocks[0].mlp.wfc.weight.dtype == torch.bfloat16
    assert bf.wte.dtype == torch.float32 and bf.lnf.g.dtype == torch.float32
    with torch.no_grad():
        assert bf(torch.zeros(1, 8, dtype=torch.long)).dtype == torch.bfloat16


def test_configs_match_jax_presets():
    for jc, tc in ((jgpt.GPT2_124M, tgpt.GPT2_124M), (jgpt.SHAKESPEARE_CHAR, tgpt.SHAKESPEARE_CHAR)):
        for f in ("vocab_size", "block_size", "n_layer", "n_head", "n_embd", "dropout", "bias", "head_dim", "kv_heads"):
            assert getattr(jc, f) == getattr(tc, f), f
    assert tgpt.GPT2_124M.dtype == torch.bfloat16


def test_forward_rejects_too_long_sequence():
    model = tgpt.GPT(TORCH_CFG, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        model(torch.zeros(1, TORCH_CFG.block_size + 1, dtype=torch.long))
