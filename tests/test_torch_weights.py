"""Weight-only INT8/INT4: the port's quantization against the JAX package's
`quant/weights.py` on the same numpy weights (payload bytes bit-equal,
scales to 0 ulp), dequantize and quantized_matmul (fp32 1e-5, bf16 1e-2),
the layout guard, the in-place module swap, and quantized GPT serving
against the JAX package's model_runner on `quantize_gpt_params` params
(fp32, 1e-5)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import JAX_CFG, TORCH_CFG, bits, jax_tree, n, numpy_params, randn, t
from flash_attention_tpu.inference import kv_cache as jkv
from flash_attention_tpu.inference import model_runner as jmr
from flash_attention_tpu_torch.inference import kv_cache as tkv
from flash_attention_tpu_torch.inference import model_runner as tmr
from flash_attention_tpu_torch.models import gpt as tgpt

jw = importlib.import_module("flash_attention_tpu.quant.weights")
tw = importlib.import_module("flash_attention_tpu_torch.quant.weights")

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _weight(seed: int = 0, n_in: int = 48, n_out: int = 40) -> np.ndarray:
    """A weight [in, out] with one all-zero column (amax 0 -> scale 1) and
    values at exact half-steps of the int8 grid (round half to even)."""
    w = randn(seed, n_in, n_out) * 0.05
    w[:, 3] = 0.0
    w[0, 5], w[1, 5] = 127.0, 2.5  # scale 1: 2.5 rounds to 2, as jnp.round does
    return w


def _quantize(bits_: int, w: np.ndarray):
    jq = (jw.quantize_int8 if bits_ == 8 else jw.quantize_int4)(jnp.asarray(w))
    tq = (tw.quantize_int8 if bits_ == 8 else tw.quantize_int4)(t(w))
    return jq, tq


@pytest.mark.parametrize("bits_", [8, 4])
def test_quantize_bit_equal_to_jax(bits_):
    """Payload bytes bit-equal (int4: the split-halves packing, whose
    `(q & 0x0F) << 4` wraps in int8) and scales to 0 ulp."""
    jq, tq = _quantize(bits_, _weight())
    assert tq.values.dtype == torch.int8 and tq.bits == jq.bits and tq.out_features == jq.out_features
    assert tq.layout == jq.layout == tw.INT4_LAYOUT
    np.testing.assert_array_equal(bits(tq.values), bits(jq.values))
    np.testing.assert_array_equal(n(tq.scales).view(np.uint32), np.asarray(jq.scales).view(np.uint32))
    assert float(tq.scales[3]) == 1.0  # amax 0


def test_unpack_int4_matches_jax_on_every_byte():
    """Every byte value through both unpackings (the arithmetic `>>` of
    int8 and the mask after it)."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    jlo, jhi = jw._unpack_int4(jnp.asarray(packed))
    tlo, thi = tw._unpack_int4(torch.from_numpy(packed))
    np.testing.assert_array_equal(n(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(n(thi), np.asarray(jhi))
    assert n(tlo).min() == -8 and n(tlo).max() == 7


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits_", [8, 4])
def test_dequantize_and_quantized_matmul_match_jax(bits_, dtype):
    jdt, tdt = DTYPES[dtype]
    jq, tq = _quantize(bits_, _weight(1))
    np.testing.assert_allclose(n(tw.dequantize(tq, tdt).float()), np.asarray(jw.dequantize(jq, jdt), np.float32),
                               atol=TOL[dtype], rtol=0)
    x, bias = randn(2, 3, 5, 48), randn(3, 40)
    jx = jnp.asarray(x).astype(jdt)
    tx = t(x).to(tdt)
    want = jw.quantized_matmul(jx, jq, bias=jnp.asarray(bias))
    got = tw.quantized_matmul(tx, tq, bias=t(bias))
    assert got.dtype == tdt and got.shape == (3, 5, 40)
    np.testing.assert_allclose(n(got.float()), np.asarray(want, np.float32), atol=TOL[dtype], rtol=TOL[dtype])


def test_quantized_matmul_rounds_int4_per_half_with_scales_in_x_dtype():
    """int4 multiplies by the scales cast to x's dtype after each
    half-width product; in bf16 that is not the same as dequantizing first,
    and the port follows JAX's order (the results agree with JAX's to bf16
    rounding, while the dequantize-first form may not)."""
    jq, tq = _quantize(4, _weight(2))
    x = randn(4, 6, 48)
    want = np.asarray(jw.quantized_matmul(jnp.asarray(x).astype(jnp.bfloat16), jq), np.float32)
    got = n(tw.quantized_matmul(t(x).bfloat16(), tq).float())
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


def test_wrong_layout_raises():
    _, tq = _quantize(4, _weight())
    old = tw.QuantizedTensor(tq.values, tq.scales, 4, tq.out_features, "int4-adjacent-v1")
    for fn in (lambda: tw.dequantize(old), lambda: tw.quantized_matmul(torch.ones(2, 48), old)):
        with pytest.raises(ValueError, match="layout"):
            fn()
    with pytest.raises(ValueError, match="even"):
        tw.quantize_int4(torch.ones(4, 5))


def test_quantize_params_swaps_the_named_linears_in_place():
    model = tgpt.params_from_jax(numpy_params(seed=3), TORCH_CFG, device="cpu")
    wte = model.wte
    assert tw.quantize_gpt_params(model, bits=4) is model
    for blk in model.blocks:
        for mod in (blk.attn.wqkv, blk.attn.wo, blk.mlp.wfc, blk.mlp.wproj):
            assert isinstance(mod, tw.QuantizedLinear) and mod.bits == 4 and mod.bias is not None
        assert isinstance(blk.ln1, tgpt.LayerNorm)
    assert model.wte is wte  # the tied embedding / LM head stays as it is
    with pytest.raises(ValueError, match="bits"):
        tw.quantize_gpt_params(model, bits=3)


@pytest.mark.parametrize("bits_", [8, 4])
def test_gpt_forward_quantized_matches_jax(bits_):
    tree = numpy_params(seed=4)
    jparams = jw.quantize_gpt_params(jax_tree(tree), bits=bits_)
    model = tw.quantize_gpt_params(tgpt.params_from_jax(tree, TORCH_CFG, device="cpu"), bits=bits_)
    idx = np.random.default_rng(0).integers(0, JAX_CFG.vocab_size, (2, 40))
    want = jw.gpt_forward_quantized(jparams, jnp.asarray(idx), JAX_CFG)
    got = tw.gpt_forward_quantized(model, torch.from_numpy(idx))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=0)
    assert all(isinstance(blk.attn.wqkv, tw.QuantizedLinear) for blk in model.blocks)  # swapped back


@pytest.mark.parametrize("bits_", [8, 4])
def test_quantized_gpt_serving_matches_jax(bits_):
    """The port's GPT prefill and decode_step with quantized linears against
    the JAX model_runner on `quantize_gpt_params` params: logits and cache
    (fp32, 1e-5), and greedy tokens equal."""
    tree = numpy_params(seed=5, scale=4.0)
    jparams = jw.quantize_gpt_params(jax_tree(tree), bits=bits_)
    model = tw.quantize_gpt_params(tgpt.params_from_jax(tree, TORCH_CFG, device="cpu"), bits=bits_)
    args = (JAX_CFG.n_layer, 2, JAX_CFG.kv_heads, 256, JAX_CFG.head_dim)
    jc = jkv.init_cache(*args, dtype=jnp.float32)
    tc = tkv.init_cache(*args, dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(1).integers(0, JAX_CFG.vocab_size, 37)
    jc, jl = jmr.prefill(jparams, jnp.asarray(prompt), JAX_CFG, jc, jnp.int32(1))
    tc, tl = tmr.prefill(model, torch.from_numpy(prompt), tc, 1)
    np.testing.assert_allclose(n(tl), np.asarray(jl), atol=1e-5, rtol=0)
    jtok = jnp.zeros(2, jnp.int32).at[1].set(int(jnp.argmax(jl)))
    ttok = torch.zeros(2, dtype=torch.int32)
    ttok[1] = int(torch.argmax(tl))
    assert int(ttok[1]) == int(jtok[1])
    for _ in range(3):
        jc, jl = jmr.decode_step(jparams, jtok, JAX_CFG, jc)
        tc, tl = tmr.decode_step(model, ttok, tc)
        np.testing.assert_allclose(n(tl), np.asarray(jl), atol=1e-5, rtol=0)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(n(ttok), np.asarray(jtok))
    np.testing.assert_allclose(n(tc.k), np.asarray(jc.k), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(n(tc.lengths), np.asarray(jc.lengths))


def test_quantized_linear_is_quantized_matmul():
    _, tq = _quantize(4, _weight())
    bias = t(randn(6, 40))
    lin = tw.QuantizedLinear(tq, bias)
    x = t(randn(7, 3, 48))
    torch.testing.assert_close(lin(x), tw.quantized_matmul(x, tq, bias=bias), atol=0, rtol=0)
    assert set(lin.state_dict()) == {"values", "scales", "bias"}
